// The TPE step's per-column observation weights of both split sets in one
// launch: each observation's recency rank inside its set, and the linear
// forgetting weight of that rank.
//
//   m[s, l, r, c]  = set_s[l, r] & act[l, r, c]
//   n[s, l, c]     = sum_r m[s, l, r, c]
//   rank           = #{r' < r : m[s, l, r', c]}
//   w[s, l, r, c]  = m ? (rank < n_ramp ? a + ((1 - a) * rank) / denom : 1)
//                      : 0
//
// with n_ramp = max(n - lf, 0), a = 1 / max(n, 1), denom = max(n_ramp - 1,
// 1), for s = 0 (below) and 1 (above), lane l, row r (trial order), column
// c.
//
// Replaces no TPU kernel: the JAX step computes the rank with jnp.cumsum
// over the rows, which XLA fuses with the weights' arithmetic.  The port
// computed it with torch.cumsum(int64) along the outer axis of [L, N, C],
// which ATen's tensor_kernel_scan_outer_dim runs with one thread per (lane,
// column) walking all N rows in series (31 threads over 1,024 rows at the
// hosted flagship step, ~0.18 ms a call), followed by ~24 elementwise
// launches for the casts, the masks and forgetting_weights' arithmetic.
//
// Design: one block per (lane, column), both sets; the rows are swept in
// tiles of the block's threads, one row a thread.  The first sweep counts
// the set's rows (__syncthreads_count); n is needed before any weight.
// The second ranks them as a parallel prefix count: each warp's ballot of
// its 32 rows' bits gives the rank inside the warp (popc of the bits below
// the lane), the warps' totals are summed in shared memory, and a running
// count carries each tile's total to the next.  Any N works; a tile that
// runs past N reads nothing there.
//
// What bounds it on an H100: bytes, one read of act (1 byte a cell) and
// the writes of both sets' m (1 byte) and w (4 bytes), ~11 bytes a cell:
// 0.0067 ms for the fleet's 64 x 1,024 x 31 group at 3.35 TB/s.  The
// hosted step's 1 x 1,024 x 31 group is 31 blocks and bound by latency.
//
// Bits: the weights are the bits torch's composition writes
// (ops/set_weights.py, set_weights_reference), op by op: every float
// operation is an explicit round-to-nearest intrinsic, so that no multiply
// and add are contracted into an FMA (the port's nvcc flags leave --fmad
// on).  torch computes 1.0 / x as reciprocal(x) * 1.0, which is 1 / x; a
// subtraction of a scalar as x + (-1) * s, which is x - s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxThreads)
    set_weights_kernel(const unsigned char* __restrict__ below,
                       const unsigned char* __restrict__ above,
                       const unsigned char* __restrict__ act,
                       unsigned char* __restrict__ m_out,
                       float* __restrict__ w_out,
                       long long* __restrict__ n_out, int lanes, int rows,
                       int cols, float lf) {
  __shared__ int warp_total[2][kMaxThreads / 32];
  const int l = blockIdx.x / cols, c = blockIdx.x % cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long row0 = (long long)l * rows;
  const long long cells = (long long)lanes * rows * cols;

  // Sweep 1: the count of each set.
  int n_b = 0, n_a = 0;
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int r = r0 + tid;
    bool in_b = false, in_a = false;
    if (r < rows) {
      const bool on = act[(row0 + r) * cols + c] != 0;
      in_b = on && below[row0 + r] != 0;
      in_a = on && above[row0 + r] != 0;
    }
    n_b += __syncthreads_count(in_b);
    n_a += __syncthreads_count(in_a);
  }
  if (tid == 0) {
    n_out[(long long)l * cols + c] = n_b;
    n_out[((long long)lanes + l) * cols + c] = n_a;
  }

  // forgetting_weights' per-column terms, in torch's order.
  float n_ramp[2], a[2], one_minus_a[2], denom[2];
  const int n_set[2] = {n_b, n_a};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float n = __int2float_rn(n_set[s]);
    n_ramp[s] = fmaxf(__fsub_rn(n, lf), 0.0f);
    a[s] = __fdiv_rn(1.0f, fmaxf(n, 1.0f));
    denom[s] = fmaxf(__fsub_rn(n_ramp[s], 1.0f), 1.0f);
    one_minus_a[s] = __fsub_rn(1.0f, a[s]);
  }

  // Sweep 2: ranks and weights.
  const unsigned below_lane = (1u << lane) - 1u;
  int carry[2] = {0, 0};
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int r = r0 + tid;
    bool in[2] = {false, false};
    if (r < rows) {
      const bool on = act[(row0 + r) * cols + c] != 0;
      in[0] = on && below[row0 + r] != 0;
      in[1] = on && above[row0 + r] != 0;
    }
    unsigned bits[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      bits[s] = __ballot_sync(kFull, in[s]);
      if (lane == 0) warp_total[s][warp] = __popc(bits[s]);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int t = lane < n_warps ? warp_total[s][lane] : 0;
      const int before =
          (int)__reduce_add_sync(kFull, (unsigned)(lane < warp ? t : 0));
      const int rank = carry[s] + before + __popc(bits[s] & below_lane);
      carry[s] += (int)__reduce_add_sync(kFull, (unsigned)t);
      if (r < rows) {
        float w = 0.0f;
        if (in[s]) {
          const float rf = __int2float_rn(rank);
          const float ramp = __fadd_rn(
              a[s], __fdiv_rn(__fmul_rn(one_minus_a[s], rf), denom[s]));
          w = rf < n_ramp[s] ? ramp : 1.0f;
        }
        const long long at = s * cells + (row0 + r) * cols + c;
        m_out[at] = in[s];
        w_out[at] = w;
      }
    }
    __syncthreads();  // warp_total is rewritten by the next tile
  }
}

}  // namespace

// below, above: bool [lanes, rows]; act: bool [lanes, rows, cols]; m: bool
// [2, lanes, rows, cols]; w: float32 [2, lanes, rows, cols]; n_set: int64
// [2, lanes, cols]; all contiguous on the current device, set 0 below and
// set 1 above.  One block per (lane, column) of min(1024, rows rounded up to
// 32) threads, launched on `stream` without synchronising.  Returns
// cudaGetLastError(): a refused launch is an error, never a silent no-op.
extern "C" int set_weights_launch(const unsigned char* below,
                                  const unsigned char* above,
                                  const unsigned char* act, unsigned char* m,
                                  float* w, long long* n_set, int lanes,
                                  int rows, int cols, float lf,
                                  void* stream) {
  int threads = ((rows + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  set_weights_kernel<<<lanes * cols, threads, 0, (cudaStream_t)stream>>>(
      below, above, act, m, w, n_set, lanes, rows, cols, lf);
  return (int)cudaGetLastError();
}
