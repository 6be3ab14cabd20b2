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
// - K1, f32 (ei_scores_launch): the default path of ei_scores, one launch
//   per TPE step;
// - K2, bf16 (ei_scores_bf16_launch, _ei_kernel with bf16=True): t =
//   (z - mu) / sg is rounded to bfloat16 after the subtraction of the
//   bf16-rounded z and mu, and again after the division by the
//   bf16-rounded sigma; -0.5 t^2, cb and the log-sum-exp stay in float32.
//   That is what the JAX package computes for this kernel on the CPU.
//
// What bounds it on an H100: one exp per live (column, candidate,
// component) term.  exp runs on the special-function units, 16 results
// per SM per clock, so at the main path's shape (31 x 10,000 x (25 + 1022)
// live terms, ~3.2e8) both forms are bound at ~0.078 ms; the bytes moved
// (~2.5 MB) are negligible.  Everything else a term costs takes dispatch
// slots on the float32 and integer pipes, so the design spends as few
// instructions per term as it can (K1: 6 and the exp; K2: 10 and the
// exp) and no second special-function operation:
//
// 1. Staged reciprocal (K2).  The division is replaced by a multiply with
//    r = 1/bf16(sigma), folded once per component while staging.  For
//    bf16 d and s, bf16(RN(d * RN(1/s))) == bf16(RN(d / s)) for every
//    pair of significands (the float32 products differ from the quotients
//    in some pairs, never across a bf16 rounding boundary), so t and the
//    output keep the twin's bits.  The CPU test that sweeps every pair is
//    tests/test_torch_ei_lowerings.py::test_bf16_reciprocal_identity.
//    Pairs of candidates are rounded by one packed cvt.rn.bf16x2.f32 and
//    widened by a shift and a mask.
// 2. Each term once.  A blocked online log-sum-exp: per step of kSub
//    staged components each candidate computes its kSub terms into
//    registers with their max, rescales its running sum once (one more
//    exp per kSub terms) and adds kSub exps.  Terms are in base 2 and the
//    exp is a bare ex2.approx.ftz: its arguments are <= 0, and a flushed
//    subnormal changes a sum of order >= 1 by less than 1e-38.  The steps
//    are software-pipelined over two register sets: the exps of one step
//    are interleaved with the terms of the next, so the special-function
//    units and the float32 pipes work at the same time.
// 3. Several candidates per thread (kCands).  Each broadcast read of a
//    staged component feeds kCands terms, and the max and sum chains are
//    kCands independent chains.
// 4. Filling the card.  128 threads x 2 candidates per block, 64 / 62
//    registers (f32 / bf16): 8 resident blocks per SM, the slice shape's
//    1,240 blocks in 1.17 rounds.  The shapes that fit one round (more
//    candidates per thread, or a register cap) ran slower on the card:
//    fewer warps per SM, or spills (PERF.md).  The launch bounds' minimum
//    of one block per SM limits nothing, but without it ptxas allocates
//    48 / 55 registers and the bf16 form runs slower (PERF.md).
// 5. No dead tail.  While a chunk is staged the block votes on its last
//    live component (a warp max, then the block's warps through shared
//    memory) and scans only up to it; a chunk with none is skipped.  The
//    above mixture is sized n_cap + 1 and its live components are a
//    prefix (fit_parzen and truncate_mixture sort them first; pinned by
//    tests/test_torch_tpe.py::
//    test_fitted_mixtures_keep_live_components_first), so the 2,048
//    bucket's dead half costs only its staging.
//
// Equal mixtures score exactly 0: both go through the same code in the
// same order, and the final difference uses explicitly rounded ops.
//
// Grid: (candidate tile, column); the ragged candidate edge is masked.
// Components are staged kChunk at a time, so K has no upper limit and
// needs no padding.  A component with logw = -inf (or NaN) contributes
// exactly 0 and never a NaN, wherever it lies and whatever its mu and
// sigma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCands = 2;                   // candidates per thread
constexpr int kSub = 8;                     // components per online step
constexpr int kTile = kThreads * kCands;    // candidates per block
constexpr int kChunk = 512;                 // components staged at a time
constexpr int kWarps = kThreads / 32;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;
static_assert(kThreads % 32 == 0 && kChunk % kThreads == 0, "block shape");
static_assert(kChunk % kSub == 0, "online steps tile a chunk");
static_assert(kCands % 2 == 0, "K2 rounds candidates in pairs");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Both halves rounded to bf16 by one packed conversion, then widened by
// a shift and a mask, one integer op each.
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&h);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One staged component.  f32: (cb * log2e, mu, sqrt(0.5 * log2e) / sg),
// so that term = cb2 - ((z - mu) * s)^2 is the natural term times log2e.
// bf16: (cb * log2e, bf16(mu), 1 / bf16(sg)).  Dead components stage a
// -inf weight with finite mu and sigma.
template <bool kBf16>
__device__ __forceinline__ float4 stage_component(float lw, float mu,
                                                  float sg) {
  float4 v;
  v.w = 0.0f;
  if (lw > -INFINITY) {
    v.x = (lw - logf(sg) - kHalfLog2Pi) * kLog2e;
    if (kBf16) {
      v.y = bf16_round(mu);
      v.z = __frcp_rn(bf16_round(sg));
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

// Base-2 terms of one staged component at this thread's candidates (for
// bf16, z is already rounded to bf16).
template <bool kBf16>
__device__ __forceinline__ void base2_terms(const float (&z)[kCands],
                                            float4 v, float (&t)[kCands]) {
  if (kBf16) {
    const float scale = 0.5f * kLog2e;
#pragma unroll
    for (int p = 0; p < kCands; p += 2) {
      const float2 d = bf16_round2(z[p] - v.y, z[p + 1] - v.y);
      const float2 q = bf16_round2(__fmul_rn(d.x, v.z), __fmul_rn(d.y, v.z));
      t[p] = fmaf(q.x * -scale, q.x, v.x);
      t[p + 1] = fmaf(q.y * -scale, q.y, v.x);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kCands; ++p) {
      const float u = (z[p] - v.y) * v.z;
      t[p] = fmaf(-u, u, v.x);
    }
  }
}

// Terms t[p][j] of staged components v[0 .. kSub-1] and their max per
// candidate.
template <bool kBf16>
__device__ __forceinline__ void step_terms(const float (&z)[kCands],
                                           const float4* v,
                                           float (&t)[kCands][kSub],
                                           float (&cm)[kCands]) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    float tj[kCands];
    base2_terms<kBf16>(z, v[j], tj);
#pragma unroll
    for (int p = 0; p < kCands; ++p) {
      t[p][j] = tj[p];
      cm[p] = j ? fmaxf(cm[p], tj[p]) : tj[p];
    }
  }
}

// One online step on terms t with max cm: rescale the running sums s to
// the new max, add the exps.  With kNext, the terms tn (and max cmn) of
// the next step, staged at v, are computed in the same unrolled loop.
template <bool kBf16, bool kNext>
__device__ __forceinline__ void step_exps(
    const float (&z)[kCands], const float4* v, const float (&t)[kCands][kSub],
    const float (&cm)[kCands], float (&m)[kCands], float (&s)[kCands],
    float (&tn)[kCands][kSub], float (&cmn)[kCands]) {
#pragma unroll
  for (int p = 0; p < kCands; ++p) {
    const float nm = fmaxf(m[p], cm[p]);
    s[p] *= ex2(m[p] - nm);
    m[p] = nm;
  }
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
#pragma unroll
    for (int p = 0; p < kCands; ++p) s[p] += ex2(t[p][j] - m[p]);
    if (kNext) {
      float tj[kCands];
      base2_terms<kBf16>(z, v[j], tj);
#pragma unroll
      for (int p = 0; p < kCands; ++p) {
        tn[p][j] = tj[p];
        cmn[p] = j ? fmaxf(cmn[p], tj[p]) : tj[p];
      }
    }
  }
}

// Base-2 log-sum-exp over one mixture for this thread's candidates.
template <bool kBf16>
__device__ __forceinline__ void mixture_lse(
    const float (&z)[kCands], const float* __restrict__ logw,
    const float* __restrict__ mu, const float* __restrict__ sg, int k,
    float4* stage, int* warp_last, float (&lse)[kCands]) {
  float m[kCands], s[kCands];  // running max and sum of exp2(term - max)
#pragma unroll
  for (int p = 0; p < kCands; ++p) {
    // A finite start keeps m - max finite: ex2 of it is 1 until a live
    // term raises the max, and s stays 0 until then.
    m[p] = -FLT_MAX;
    s[p] = 0.0f;
  }
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk and its vote are no longer read
    int last = -1;    // this thread's last live staged component
#pragma unroll
    for (int r = 0; r < kChunk / kThreads; ++r) {
      const int j = r * kThreads + threadIdx.x;
      float4 v;
      if (j < kn) {
        const float lw = logw[k0 + j];
        v = stage_component<kBf16>(lw, mu[k0 + j], sg[k0 + j]);
        if (lw > -INFINITY) last = j;
      } else {
        v = stage_component<kBf16>(-INFINITY, 0.0f, 1.0f);
      }
      stage[j] = v;
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = last;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) last = max(last, warp_last[w]);
    // Block-uniform bound: no divergence.  The steps past `last` would
    // add exactly 0.
    if (last < 0) continue;
    // Two register sets of terms, a and b.  While the exps of one step
    // run on the special-function units, the terms of the next step are
    // computed on the float32 pipes.
    float ta[kCands][kSub], tb[kCands][kSub], ca[kCands], cb[kCands];
    step_terms<kBf16>(z, stage, ta, ca);
    for (int j0 = 0;; j0 += 2 * kSub) {
      if (j0 + kSub > last) {
        step_exps<kBf16, false>(z, stage, ta, ca, m, s, tb, cb);
        break;
      }
      step_exps<kBf16, true>(z, stage + j0 + kSub, ta, ca, m, s, tb, cb);
      if (j0 + 2 * kSub > last) {
        step_exps<kBf16, false>(z, stage, tb, cb, m, s, ta, ca);
        break;
      }
      step_exps<kBf16, true>(z, stage + j0 + 2 * kSub, tb, cb, m, s, ta,
                             ca);
    }
  }
#pragma unroll
  for (int p = 0; p < kCands; ++p) lse[p] = __fadd_rn(m[p], log2f(s[p]));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
ei_scores_kernel(const float* __restrict__ z,
                 const float* __restrict__ logw_b,
                 const float* __restrict__ mu_b,
                 const float* __restrict__ sg_b,
                 const float* __restrict__ logw_a,
                 const float* __restrict__ mu_a,
                 const float* __restrict__ sg_a,
                 float* __restrict__ out, int n, int kb, int ka) {
  __shared__ float4 stage[kChunk];
  __shared__ int warp_last[kWarps];
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kTile + threadIdx.x;
  // Every thread takes part in staging, so none returns early.  lb and la
  // are base-2 LSEs.  Candidate p of a thread is i0 + p * kThreads, so
  // each warp reads and writes contiguous runs.
  float zi[kCands];
#pragma unroll
  for (int p = 0; p < kCands; ++p) {
    const int i = i0 + p * kThreads;
    zi[p] = i < n ? z[(size_t)c * n + i] : 0.0f;
    if (kBf16) zi[p] = bf16_round(zi[p]);
  }
  float lb[kCands], la[kCands];
  mixture_lse<kBf16>(zi, logw_b + (size_t)c * kb, mu_b + (size_t)c * kb,
                     sg_b + (size_t)c * kb, kb, stage, warp_last, lb);
  mixture_lse<kBf16>(zi, logw_a + (size_t)c * ka, mu_a + (size_t)c * ka,
                     sg_a + (size_t)c * ka, ka, stage, warp_last, la);
  // Explicitly rounded ops: a contraction of lb * ln2 - la * ln2 into one
  // fma would round the two sides differently, and equal mixtures would
  // then not score exactly 0.
#pragma unroll
  for (int p = 0; p < kCands; ++p) {
    const int i = i0 + p * kThreads;
    if (i < n) out[(size_t)c * n + i] = __fmul_rn(__fsub_rn(lb[p], la[p]),
                                                  kLn2);
  }
}

template <bool kBf16>
int launch(const float* z, const float* logw_b, const float* mu_b,
           const float* sg_b, const float* logw_a, const float* mu_a,
           const float* sg_a, float* out, int c, int n, int kb, int ka,
           void* stream) {
  if (c <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kTile - 1) / kTile, c);
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
