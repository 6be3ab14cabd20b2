// Fused EI scoring of TPE candidates against two 1-D Gaussian mixtures.
//
//   out[c, i] = LSE_k(cb_b[c,k] - 0.5 * ((z[c,i] - mu_b[c,k]) / sg_b[c,k])^2)
//             - LSE_k(cb_a[c,k] - 0.5 * ((z[c,i] - mu_a[c,k]) / sg_a[c,k])^2)
//
// with cb = logw - log(sg) - 0.5 * log(2 pi), folded here while a chunk of
// components is staged in shared memory.  The truncation normalizers are
// per-column constants along the candidate axis and cancel in the argmax,
// so they are left out, as in the kernel this replaces.
//
// Replaces hyperopt_tpu/ops/pallas_gmm.py::_ei_kernel (the default f32
// path of ei_scores, one launch per TPE step).
//
// What bounds it on an H100: one exp per (column, candidate, component)
// term, C * n * (K_b + K_a) in all.  exp runs on the special-function
// units (16 results per SM per clock), so at the main path's shape
// (31 x 10,000 x (26 + 1025) ~ 3.3e8 terms) the kernel is bound near
// 0.08 ms by exp throughput; the bytes it moves (~2.5 MB) are negligible.
// The design keeps one exp per term: each chunk of components is scanned
// twice out of shared memory, first for the chunk's max and then for the
// rescaled sum, instead of an online update that costs two exps per term.
// Terms are kept in base 2 so the exp is a bare ex2.
//
// The simple design leaves for later: several candidates per thread (each
// shared-memory read is now used by one term), double-buffered staging of
// the next chunk, and a tensor-core form of the exponent (the TPU's
// _ei_kernel_mxu).
//
// Grid: (candidate block, column).  One candidate per thread; the ragged
// candidate edge is masked here.  Components are staged kChunk at a time,
// so K has no upper limit and needs no padding.  A component with
// logw = -inf (or NaN) contributes exactly 0 and never a NaN, whatever its
// mu and sigma.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

// Base-2 log-sum-exp over one mixture for this thread's candidate z.
// Staged component j holds (cb * log2e, mu, sqrt(0.5 * log2e) / sg), so
// that term_j = cb2_j - ((z - mu_j) * s_j)^2 is the natural term times
// log2e.
__device__ float mixture_lse(float z, const float* __restrict__ logw,
                             const float* __restrict__ mu,
                             const float* __restrict__ sg, int k,
                             float4* stage) {
  const float scale = sqrtf(0.5f * kLog2e);
  float m = -INFINITY;  // running max of the base-2 terms
  float s = 0.0f;       // running sum of exp2(term - m)
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      const float lw = logw[k0 + j];
      const float sj = sg[k0 + j];
      float4 v;
      if (lw > -INFINITY) {
        v.x = (lw - logf(sj) - kHalfLog2Pi) * kLog2e;
        v.y = mu[k0 + j];
        v.z = scale / sj;
      } else {
        v.x = -INFINITY;
        v.y = 0.0f;
        v.z = 0.0f;
      }
      v.w = 0.0f;
      stage[j] = v;
    }
    __syncthreads();
    float cm = -INFINITY;
    for (int j = 0; j < kn; ++j) {
      const float4 v = stage[j];
      const float t = (z - v.y) * v.z;
      cm = fmaxf(cm, fmaf(-t, t, v.x));
    }
    if (cm > m) {  // m = -inf the first time: s is 0 and stays 0
      s *= exp2f(m - cm);
      m = cm;
    }
    if (m > -INFINITY) {
      for (int j = 0; j < kn; ++j) {
        const float4 v = stage[j];
        const float t = (z - v.y) * v.z;
        s += exp2f(fmaf(-t, t, v.x) - m);
      }
    }
  }
  return __fadd_rn(m, log2f(s));
}

__global__ void __launch_bounds__(kThreads)
ei_scores_kernel(const float* __restrict__ z,
                 const float* __restrict__ logw_b,
                 const float* __restrict__ mu_b,
                 const float* __restrict__ sg_b,
                 const float* __restrict__ logw_a,
                 const float* __restrict__ mu_a,
                 const float* __restrict__ sg_a,
                 float* __restrict__ out, int n, int kb, int ka) {
  __shared__ float4 stage[kChunk];
  const int c = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  // Every thread takes part in staging, so none returns early.  lb and la
  // are base-2 LSEs.
  const float zi = live ? z[(size_t)c * n + i] : 0.0f;
  const float lb = mixture_lse(zi, logw_b + (size_t)c * kb,
                               mu_b + (size_t)c * kb, sg_b + (size_t)c * kb,
                               kb, stage);
  const float la = mixture_lse(zi, logw_a + (size_t)c * ka,
                               mu_a + (size_t)c * ka, sg_a + (size_t)c * ka,
                               ka, stage);
  // Explicitly rounded ops: a contraction of lb * ln2 - la * ln2 into one
  // fma would round the two sides differently, and equal mixtures would
  // then not score exactly 0.
  if (live) out[(size_t)c * n + i] = __fmul_rn(__fsub_rn(lb, la), kLn2);
}

}  // namespace

// All arrays are contiguous float32 on the current device: z and out are
// [C, n], the below mixture [C, kb], the above mixture [C, ka].  Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int ei_scores_launch(const float* z, const float* logw_b,
                                const float* mu_b, const float* sg_b,
                                const float* logw_a, const float* mu_a,
                                const float* sg_a, float* out, int c, int n,
                                int kb, int ka, void* stream) {
  if (c <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, c);
  ei_scores_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, out, n, kb, ka);
  return (int)cudaGetLastError();
}
