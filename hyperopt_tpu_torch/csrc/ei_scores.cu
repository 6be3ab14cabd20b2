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
// Replaces hyperopt_tpu/ops/pallas_gmm.py::_ei_kernel, in its two forms:
// - f32 (ei_scores_launch): the default path of ei_scores, one launch per
//   TPE step;
// - bf16 (ei_scores_bf16_launch, _ei_kernel with bf16=True): t =
//   (z - mu) / sg is rounded to bfloat16 after the subtraction of the
//   bf16-rounded z and mu, and again after a true division by the
//   bf16-rounded sigma; -0.5 t^2, cb and the log-sum-exp stay in float32.
//   That is what the JAX package computes for this kernel on the CPU (the
//   TPU's own lowering may round the square as well).  The division is an
//   IEEE division, not a multiply by a reciprocal, which rounds
//   differently.
//
// What bounds it on an H100: one exp per (column, candidate, component)
// term, C * n * (K_b + K_a) in all.  exp runs on the special-function
// units (16 results per SM per clock), so at the main path's shape
// (31 x 10,000 x (26 + 1025) ~ 3.3e8 terms) the kernel is bound near
// 0.08 ms by exp throughput; the bytes it moves (~2.5 MB) are negligible.
// The bf16 form removes no exp, so it has the same bound; its division
// costs several float32 operations per term on top.
// The design keeps one exp per term: each chunk of components is scanned
// twice out of shared memory, first for the chunk's max and then for the
// rescaled sum, instead of an online update that costs two exps per term.
// Terms are kept in base 2 so the exp is a bare ex2.
//
// The simple design leaves for later: several candidates per thread (each
// shared-memory read is now used by one term) and double-buffered staging
// of the next chunk.  The tensor-core form of the exponent (the TPU's
// _ei_kernel_mxu) is ei_scores_mxu.cu.
//
// Grid: (candidate block, column).  One candidate per thread; the ragged
// candidate edge is masked here.  Components are staged kChunk at a time,
// so K has no upper limit and needs no padding.  A component with
// logw = -inf (or NaN) contributes exactly 0 and never a NaN, whatever its
// mu and sigma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One staged component.  f32: (cb * log2e, mu, sqrt(0.5 * log2e) / sg),
// so that term = cb2 - ((z - mu) * s)^2 is the natural term times log2e.
// bf16: (cb * log2e, bf16(mu), bf16(sg)).  Dead components stage a -inf
// weight with finite mu and sigma.
template <bool kBf16>
__device__ __forceinline__ float4 stage_component(float lw, float mu,
                                                  float sg) {
  float4 v;
  v.w = 0.0f;
  if (lw > -INFINITY) {
    v.x = (lw - logf(sg) - kHalfLog2Pi) * kLog2e;
    if (kBf16) {
      v.y = bf16_round(mu);
      v.z = bf16_round(sg);
    } else {
      v.y = mu;
      v.z = sqrtf(0.5f * kLog2e) / sg;
    }
  } else {
    v.x = -INFINITY;
    v.y = 0.0f;
    v.z = kBf16 ? 1.0f : 0.0f;
  }
  return v;
}

// Base-2 term of one staged component at candidate z (for bf16, z is
// already rounded to bf16).
template <bool kBf16>
__device__ __forceinline__ float base2_term(float z, float4 v) {
  if (kBf16) {
    const float d = bf16_round(z - v.y);
    const float t = bf16_round(__fdiv_rn(d, v.z));
    const float u = t * sqrtf(0.5f * kLog2e);
    return fmaf(-u, u, v.x);
  }
  const float t = (z - v.y) * v.z;
  return fmaf(-t, t, v.x);
}

// Base-2 log-sum-exp over one mixture for this thread's candidate z.
template <bool kBf16>
__device__ float mixture_lse(float z, const float* __restrict__ logw,
                             const float* __restrict__ mu,
                             const float* __restrict__ sg, int k,
                             float4* stage) {
  float m = -INFINITY;  // running max of the base-2 terms
  float s = 0.0f;       // running sum of exp2(term - m)
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      stage[j] = stage_component<kBf16>(logw[k0 + j], mu[k0 + j],
                                        sg[k0 + j]);
    }
    __syncthreads();
    float cm = -INFINITY;
    for (int j = 0; j < kn; ++j) {
      cm = fmaxf(cm, base2_term<kBf16>(z, stage[j]));
    }
    if (cm > m) {  // m = -inf the first time: s is 0 and stays 0
      s *= exp2f(m - cm);
      m = cm;
    }
    if (m > -INFINITY) {
      for (int j = 0; j < kn; ++j) {
        s += exp2f(base2_term<kBf16>(z, stage[j]) - m);
      }
    }
  }
  return __fadd_rn(m, log2f(s));
}

template <bool kBf16>
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
  float zi = live ? z[(size_t)c * n + i] : 0.0f;
  if (kBf16) zi = bf16_round(zi);
  const float lb = mixture_lse<kBf16>(
      zi, logw_b + (size_t)c * kb, mu_b + (size_t)c * kb,
      sg_b + (size_t)c * kb, kb, stage);
  const float la = mixture_lse<kBf16>(
      zi, logw_a + (size_t)c * ka, mu_a + (size_t)c * ka,
      sg_a + (size_t)c * ka, ka, stage);
  // Explicitly rounded ops: a contraction of lb * ln2 - la * ln2 into one
  // fma would round the two sides differently, and equal mixtures would
  // then not score exactly 0.
  if (live) out[(size_t)c * n + i] = __fmul_rn(__fsub_rn(lb, la), kLn2);
}

template <bool kBf16>
int launch(const float* z, const float* logw_b, const float* mu_b,
           const float* sg_b, const float* logw_a, const float* mu_a,
           const float* sg_a, float* out, int c, int n, int kb, int ka,
           void* stream) {
  if (c <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, c);
  ei_scores_kernel<kBf16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, out, n, kb, ka);
  return (int)cudaGetLastError();
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
  return launch<false>(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, out, c, n,
                       kb, ka, stream);
}

// The bf16 form, same arguments.
extern "C" int ei_scores_bf16_launch(const float* z, const float* logw_b,
                                     const float* mu_b, const float* sg_b,
                                     const float* logw_a, const float* mu_a,
                                     const float* sg_a, float* out, int c,
                                     int n, int kb, int ka, void* stream) {
  return launch<true>(z, logw_b, mu_b, sg_b, logw_a, mu_a, sg_a, out, c, n,
                      kb, ka, stream);
}
