// Fused EI scoring with the exponent on the tensor cores.
//
// The same function as ei_scores.cu,
//
//   out[c, i] = LSE_k(term_b[c, i, k]) - LSE_k(term_a[c, i, k]),
//
// with the exponent expanded as a quadratic in the candidate:
//
//   term = cb - (z - mu)^2 / (2 sg^2) = a2 z^2 + a1 z + a0,
//   a2 = -1/(2 sg^2),  a1 = mu / sg^2,  a0 = max(cb - mu^2/(2 sg^2), -1e30),
//
// so that a [16 candidates, 8] x [8, 8 components] block of terms is one
// warp-level tensor-core product of the features [z^2, z, 1, 0, 0, 0, 0, 0]
// with the coefficients.  A dead component (logw = -inf or NaN, any mu and
// sigma) and the ragged K edge get the coefficients (0, 0, -1e30): a
// finite floor, so that the product never makes a NaN and the term still
// adds exactly 0.
//
// Replaces hyperopt_tpu/ops/pallas_gmm.py::_ei_kernel_mxu (ei_scores with
// mxu=True), which computes the [T, 3] @ [3, K] product on the TPU's
// matrix unit at Precision.HIGHEST.  That precision is load-bearing: the
// three products are O(mu^2 / sg^2) and cancel to the small true
// exponent, so one pass in a short type loses whole units of log-density.
// Here each product is mma.sync.m16n8k8 in TF32 with float32 accumulation,
// three times per tile ("3xTF32": both operands split as hi + lo in TF32,
// then hi*hi + hi*lo + lo*hi), which keeps about 22 of float32's 24 bits.
//
// What bounds it on an H100: the same exps as ei_scores.cu, one per live
// (column, candidate, component) term, ~3.2e8 at the main path's shape,
// ~0.08 ms on the special-function units.  The tensor cores take over the
// ~4 float32 operations per term around the exp, which were not the
// bound; their own work (3 passes, mostly over the zero padding of the
// contraction from 3 to 8) is ~1.6e10 flop, ~0.03 ms at the dense TF32
// rate.  One exp per term: the log-sum-exp is an online update whose
// single exp2 either rescales the running sum (new max) or adds the term.
//
// Grid: (candidate block, column); 8 warps of 16 candidates each.  The
// coefficients are folded, scaled to base 2 and split into TF32 hi/lo
// while a chunk of components is staged in shared memory, so K has no
// upper limit.  Thread (g = lane / 4, t = lane % 4) of a warp holds the
// features of candidates g and g + 8 in column t of A, the coefficient t
// of component g in B, and gets the terms of candidates g and g + 8 with
// components 2t and 2t + 1 in C; each row's max and sum are merged over
// the four lanes of the quad with shuffles at the end.
//
// Left for later: wgmma, TMA staging, and more candidates per warp (each
// B fragment now feeds one 16-row tile).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                    // candidates per warp (MMA M)
constexpr int kBlockRows = kWarps * kRows;   // candidates per block
constexpr int kChunk = 512;                  // components staged at a time
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kFloor = -1e30f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += A * B for one m16n8k8 tile.  A's columns 4..7 and B's rows 4..7
// are zero, so their fragments (a2, a3, b1) are passed as 0.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a_row_g,
                                         uint32_t a_row_g8, uint32_t b) {
  const uint32_t zero = 0u;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a_row_g), "r"(a_row_g8), "r"(zero), "r"(zero), "r"(b),
        "r"(zero));
}

// Online base-2 log-sum-exp with one exp2 per term.
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  const float d = x - m;
  const float e = exp2f(-fabsf(d));
  const bool up = d > 0.0f;
  s = up ? fmaf(s, e, 1.0f) : s + e;
  m = up ? x : m;
}

// Merge (m, s) over the four lanes of a quad; every lane ends with the
// same result.
__device__ __forceinline__ void quad_merge(float& m, float& s) {
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mm = fmaxf(m, mo);
    s = (m == mm ? s : s * exp2f(m - mm)) + (mo == mm ? so : so * exp2f(mo - mm));
    m = mm;
  }
}

// Base-2 LSEs of candidates g and g + 8 of this warp's tile over one
// mixture.  fg_* / fh_* are this thread's TF32 features of the two rows.
__device__ void mixture_lse(uint32_t fg_hi, uint32_t fg_lo, uint32_t fh_hi,
                            uint32_t fh_lo, const float* __restrict__ logw,
                            const float* __restrict__ mu,
                            const float* __restrict__ sg, int k,
                            uint32_t* stage_hi, uint32_t* stage_lo,
                            float& lse_g, float& lse_h) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, s0 = 0.0f;   // row g
  float m1 = -INFINITY, s1 = 0.0f;   // row g + 8
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    const int kn8 = (kn + 7) & ~7;
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < kn8; j += kThreads) {
      float a2 = 0.0f, a1 = 0.0f, a0 = kFloor;
      if (j < kn) {
        const float lw = logw[k0 + j];
        if (lw > -INFINITY) {
          const float s = sg[k0 + j];
          const float u = mu[k0 + j];
          const float inv2 = 1.0f / (s * s);
          a2 = -0.5f * inv2;
          a1 = u * inv2;
          a0 = fmaxf((lw - logf(s) - kHalfLog2Pi) - 0.5f * u * u * inv2,
                     kFloor);
        }
      }
      const float coef[4] = {a2 * kLog2e, a1 * kLog2e, a0 * kLog2e, 0.0f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_tf32(coef[q], stage_hi[j * 4 + q], stage_lo[j * 4 + q]);
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < kn8; j0 += 8) {
      const int idx = (j0 + g) * 4 + t;
      const uint32_t b_hi = stage_hi[idx], b_lo = stage_lo[idx];
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(c, fg_lo, fh_lo, b_hi);
      mma_tf32(c, fg_hi, fh_hi, b_lo);
      mma_tf32(c, fg_hi, fh_hi, b_hi);
      online_add(c[0], m0, s0);
      online_add(c[1], m0, s0);
      online_add(c[2], m1, s1);
      online_add(c[3], m1, s1);
    }
  }
  quad_merge(m0, s0);
  quad_merge(m1, s1);
  lse_g = __fadd_rn(m0, log2f(s0));
  lse_h = __fadd_rn(m1, log2f(s1));
}

__global__ void __launch_bounds__(kThreads)
ei_scores_mxu_kernel(const float* __restrict__ z,
                     const float* __restrict__ logw_b,
                     const float* __restrict__ mu_b,
                     const float* __restrict__ sg_b,
                     const float* __restrict__ logw_a,
                     const float* __restrict__ mu_a,
                     const float* __restrict__ sg_a,
                     float* __restrict__ out, int n, int kb, int ka) {
  __shared__ uint32_t stage_hi[kChunk * 4];
  __shared__ uint32_t stage_lo[kChunk * 4];
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockRows + (threadIdx.x >> 5) * kRows;
  const int ig = row0 + g, ih = row0 + g + 8;
  // Every thread takes part in staging, so none returns early; rows past
  // n score z = 0 and are not written.
  const float zg = ig < n ? z[(size_t)c * n + ig] : 0.0f;
  const float zh = ih < n ? z[(size_t)c * n + ih] : 0.0f;
  // Column t of A: z^2, z, 1, 0.
  const float feat_g = t == 0 ? zg * zg : (t == 1 ? zg : (t == 2 ? 1.0f : 0.0f));
  const float feat_h = t == 0 ? zh * zh : (t == 1 ? zh : (t == 2 ? 1.0f : 0.0f));
  uint32_t fg_hi, fg_lo, fh_hi, fh_lo;
  split_tf32(feat_g, fg_hi, fg_lo);
  split_tf32(feat_h, fh_hi, fh_lo);
  float lb_g, lb_h, la_g, la_h;
  mixture_lse(fg_hi, fg_lo, fh_hi, fh_lo, logw_b + (size_t)c * kb,
              mu_b + (size_t)c * kb, sg_b + (size_t)c * kb, kb, stage_hi,
              stage_lo, lb_g, lb_h);
  mixture_lse(fg_hi, fg_lo, fh_hi, fh_lo, logw_a + (size_t)c * ka,
              mu_a + (size_t)c * ka, sg_a + (size_t)c * ka, ka, stage_hi,
              stage_lo, la_g, la_h);
  // Explicitly rounded, as in ei_scores.cu: equal mixtures score exactly 0.
  if (t == 0 && ig < n) {
    out[(size_t)c * n + ig] = __fmul_rn(__fsub_rn(lb_g, la_g), kLn2);
  }
  if (t == 1 && ih < n) {
    out[(size_t)c * n + ih] = __fmul_rn(__fsub_rn(lb_h, la_h), kLn2);
  }
}

}  // namespace

// All arrays are contiguous float32 on the current device: z and out are
// [C, n], the below mixture [C, kb], the above mixture [C, ka].  Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int ei_scores_mxu_launch(const float* z, const float* logw_b,
                                    const float* mu_b, const float* sg_b,
                                    const float* logw_a, const float* mu_a,
                                    const float* sg_a, float* out, int c,
                                    int n, int kb, int ka, void* stream) {
  if (c <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, c);
  ei_scores_mxu_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, out, n, kb, ka);
  return (int)cudaGetLastError();
}
