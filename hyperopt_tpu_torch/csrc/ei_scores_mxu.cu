// Fused EI scoring with the exponent on the tensor cores.
//
// The same function as ei_scores.cu,
//
//   out[c, i] = LSE_k(term_b[c, i, k]) - LSE_k(term_a[c, i, k]),
//
// with the exponent expanded as a quadratic in the candidate:
//
//   term = cb - (z - mu)^2 / (2 sg^2) = a2 z^2 + a1 z + a0,
//   a2 = -1/(2 sg^2),  a1 = mu / sg^2,  a0 = max(cb - mu^2/(2 sg^2), -1e30).
//
// Replaces hyperopt_tpu/ops/pallas_gmm.py::_ei_kernel_mxu (ei_scores with
// mxu=True), which computes the [T, 3] @ [3, K] product on the TPU's
// matrix unit at Precision.HIGHEST.  That precision is load-bearing: the
// three products are O(mu^2 / sg^2) and cancel to the small true
// exponent, so one pass in a short type loses whole units of
// log-density.  Here both operands are split into TF32 hi + lo
// ("3xTF32": hi*hi + hi*lo + lo*hi, about 22 of float32's 24 bits).
//
// What bounds it on an H100: one exp per live (column, candidate,
// component) term on the special-function units, 16 results per SM per
// clock: ~3.2e8 terms at the main path's shape (31 x 10,000 x (25 +
// 1022)), ~0.078 ms.  The bytes moved (~2.5 MB) are negligible, and the
// tensor-core work is a small fraction of the exp time.  So the design
// spends as few other instructions per term as it can:
//
// 1. One packed product per tile.  3xTF32 of [z^2, z, 1] . [a2, a1, a0]
//    is eight products (the feature 1 has no low part): exactly the depth
//    of one mma.sync.m16n8k8.  A row is
//      [z^2_hi, z_hi, 1, z^2_hi, z_hi, 1, z^2_lo, z_lo]
//    and a B column (one component)
//      [a2_hi, a1_hi, a0_hi, a2_lo, a1_lo, a0_lo, a2_hi, a1_hi],
//    so a 16 x 8 tile of terms is one product with a zero accumulator.
//    Each thread builds its A fragments once per kernel.  The eight TF32
//    values of a component are folded, scaled to base 2 and split while
//    a chunk is staged, stored as four pairs (rows t, t + 4) so that lane
//    (g, t) reads its B fragment with one 8-byte shared load.  Dead
//    components (logw = -inf or NaN, any mu and sigma) and the ragged K
//    edge stage the coefficients (0, 0, -1e30), split the same way: a
//    finite floor, so that the product never makes a NaN and the term
//    adds exactly 0.  The CPU test of the packing is
//    tests/test_torch_ei_lowerings.py::test_packed_3xtf32_products.
// 2. A stepped log-sum-exp.  Per step each thread takes the terms of
//    kTilesB consecutive n8 tiles (2 kTilesB terms per row), takes their
//    max per row, rescales its running sum once and adds the exps, in
//    base 2 with the bare ex2.approx.ftz (its arguments are <= 0, and a
//    flushed subnormal changes a sum of order >= 1 by less than 1e-38):
//    a max, a subtract and an add per term beside its exp.  The steps are
//    software-pipelined over two register sets: the products of the next
//    step are issued before the exps of this one, so the tensor cores and
//    the special-function units work at the same time.  The running max
//    starts at -FLT_MAX.  A floor term may be the running max only until
//    the first live term of its row, whose rescale then flushes the
//    floor's sum to exactly 0.  Lanes of a quad hold different components
//    of the same rows; they are merged by shuffles once, at the end.
// 3. No dead tail.  While a chunk is staged the block votes on its last
//    live component (a warp max, then the block's warps through shared
//    memory) and scans only up to the step that holds it; a chunk with
//    none is skipped.  The bound is block-uniform, so every lane of a
//    warp issues the same mma.sync.  The above mixture is sized n_cap + 1
//    and its live components are a prefix (pinned by tests/
//    test_torch_tpe.py::test_fitted_mixtures_keep_live_components_first),
//    so the 2,048 bucket's dead half costs only its staging.  The step
//    that holds the last live component is scored whole: at that bucket
//    (1,030 live) 26 of the 1,088 components scored are dead.  Voting
//    before staging, so that a dead chunk is not staged, was tried and
//    ran slower at the slice (PERF.md §6).
// 4. Filling the card.  4 warps of 32 candidates (two A tiles, so each B
//    fragment feeds two products), 4 tiles per step: ptxas allocates 78
//    registers, no spills, so 6 blocks of 128 threads are resident per SM
//    and the slice shape's 2,449 blocks take 3.09 waves over 132 SMs, in
//    4 rounds whose last holds 73 blocks.  Trial builds timed in turns
//    against this shape on the card (PERF.md §6) that fill the rounds
//    better ran slower: a register cap for 8 blocks per SM (3 rounds, 64
//    registers and a spill) by 5-6%, 5 warps per block (2.96 waves) by
//    8-10%; 8 warps per block, 16 candidates per warp, and 2 or 8 tiles
//    per step were not faster either.  So the near-empty last round is
//    kept: its few blocks do not share an SM's exp units with others,
//    so it costs less than a full round.
//
// Not used: wgmma and TMA.  After item 1 the tensor work is a third of
// the parent's and below the exp bound, and the staged mixtures are a
// few kilobytes per column, so there is no copy to hide.
//
// Equal mixtures score exactly 0: both go through the same code in the
// same order, and the final difference uses explicitly rounded ops.
//
// Grid: (candidate block, column); rows past n score z = 0 and are not
// written.  Components are staged kChunk at a time, so K has no upper
// limit and needs no padding.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // warps per block
constexpr int kTilesA = 2;                   // 16-row A tiles per warp
constexpr int kTilesB = 4;                   // n8 component tiles per step
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16 * kTilesA;      // candidates per warp
constexpr int kBlockRows = kWarps * kWarpRows;
constexpr int kStep = 8 * kTilesB;           // components per step
constexpr int kChunk = 512;                  // components staged at a time
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kFloor = -1e30f;
constexpr uint32_t kOneTf32 = 0x3f800000u;   // 1.0f, exact in TF32
static_assert(kChunk % kThreads == 0 && kChunk % kStep == 0, "chunk");

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This thread's A fragment of one 16-row tile: (row g, col t), (row g+8,
// col t), (row g, col t+4), (row g+8, col t+4) of the packed rows.
struct AFrag {
  uint32_t r[4];
};

// Columns t and t + 4 of the packed row of candidate z.
__device__ __forceinline__ void packed_cols(float z, int t, uint32_t& lo_col,
                                            uint32_t& hi_col) {
  uint32_t q_hi, q_lo, z_hi, z_lo;
  split_tf32(z * z, q_hi, q_lo);
  split_tf32(z, z_hi, z_lo);
  // Row: [z^2_hi, z_hi, 1, z^2_hi, z_hi, 1, z^2_lo, z_lo].
  lo_col = t == 0 ? q_hi : (t == 1 ? z_hi : (t == 2 ? kOneTf32 : q_hi));
  hi_col = t == 0 ? z_hi : (t == 1 ? kOneTf32 : (t == 2 ? q_lo : z_lo));
}

// Stage one component as four pairs (B rows t, t + 4), t = 0..3, of the
// column [a2_hi, a1_hi, a0_hi, a2_lo, a1_lo, a0_lo, a2_hi, a1_hi], with
// the coefficients in base 2.
__device__ __forceinline__ void stage_component(float lw, float mu,
                                                float sg, uint4* dst) {
  float a2 = 0.0f, a1 = 0.0f, a0 = kFloor;
  if (lw > -INFINITY) {
    const float inv2 = 1.0f / (sg * sg);
    a2 = -0.5f * inv2;
    a1 = mu * inv2;
    a0 = fmaxf((lw - logf(sg) - kHalfLog2Pi) - 0.5f * mu * mu * inv2,
               kFloor);
  }
  uint32_t h2, l2, h1, l1, h0, l0;
  split_tf32(a2 * kLog2e, h2, l2);
  split_tf32(a1 * kLog2e, h1, l1);
  split_tf32(a0 * kLog2e, h0, l0);
  // Pairs t = 0: (a2_hi, a1_lo), 1: (a1_hi, a0_lo), 2: (a0_hi, a2_hi),
  // 3: (a2_lo, a1_hi).
  dst[0] = make_uint4(h2, l1, h1, l0);
  dst[1] = make_uint4(h0, h2, l2, h1);
}

// d = A * B for one m16n8k8 tile, zero accumulator.
__device__ __forceinline__ void mma_packed(float (&d)[4], const AFrag& a,
                                           uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.x),
        "r"(b.y), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// Terms of one step: kTilesB tiles of components at `st` (the step's first
// staged component) against this warp's kTilesA row tiles.  d[a][j] holds
// rows g (0, 1) and g + 8 (2, 3), components 2t and 2t + 1 of tile j.
__device__ __forceinline__ void step_terms(
    const uint2* st, const AFrag (&fa)[kTilesA],
    float (&d)[kTilesA][kTilesB][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kTilesB; ++j) {
    const uint2 b = st[(j * 8 + g) * 4 + t];
#pragma unroll
    for (int a = 0; a < kTilesA; ++a) mma_packed(d[a][j], fa[a], b);
  }
}

// One step of the stepped log-sum-exp: per row (a, h), the max of the
// step's terms, one rescale of the running sum, then the exps.
__device__ __forceinline__ void step_exps(
    const float (&d)[kTilesA][kTilesB][4], float (&m)[kTilesA][2],
    float (&s)[kTilesA][2]) {
#pragma unroll
  for (int a = 0; a < kTilesA; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = fmaxf(d[a][0][2 * h], d[a][0][2 * h + 1]);
#pragma unroll
      for (int j = 1; j < kTilesB; ++j) {
        cm = fmaxf(cm, fmaxf(d[a][j][2 * h], d[a][j][2 * h + 1]));
      }
      const float nm = fmaxf(m[a][h], cm);
      s[a][h] *= ex2(m[a][h] - nm);
      m[a][h] = nm;
    }
  }
#pragma unroll
  for (int j = 0; j < kTilesB; ++j) {
#pragma unroll
    for (int a = 0; a < kTilesA; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[a][h] += ex2(d[a][j][2 * h] - m[a][h]) +
                   ex2(d[a][j][2 * h + 1] - m[a][h]);
      }
    }
  }
}

// Merge (m, s) over the four lanes of a quad; every lane ends with the
// same result (the two sides are rounded alike, so no lane's fma
// contraction makes it differ).
__device__ __forceinline__ void quad_merge(float& m, float& s) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mm = fmaxf(m, mo);
    s = __fadd_rn(__fmul_rn(s, ex2(m - mm)), __fmul_rn(so, ex2(mo - mm)));
    m = mm;
  }
}

// Base-2 LSEs over one mixture of this thread's rows: lse[a][0] is row g
// of tile a, lse[a][1] row g + 8.
__device__ __forceinline__ void mixture_lse(
    const AFrag (&fa)[kTilesA], const float* __restrict__ logw,
    const float* __restrict__ mu, const float* __restrict__ sg, int k,
    uint4* stage, int* warp_last, float (&lse)[kTilesA][2]) {
  float m[kTilesA][2], s[kTilesA][2];  // running max and sum of exp2
#pragma unroll
  for (int a = 0; a < kTilesA; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // A finite start keeps m - max finite: ex2 of it is 0 once a term
      // raises the max, and s is 0 until then.
      m[a][h] = -FLT_MAX;
      s[a][h] = 0.0f;
    }
  }
  const uint2* stage2 = reinterpret_cast<const uint2*>(stage);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    // Slots past kn up to the end of its step are read; stage them dead.
    const int kpad = min(kChunk, (kn + kStep - 1) / kStep * kStep);
    __syncthreads();  // the previous chunk and its vote are no longer read
    int last = -1;    // this thread's last live staged component
#pragma unroll
    for (int r = 0; r < kChunk / kThreads; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (j < kpad) {
        float lw = -INFINITY, u = 0.0f, sd = 1.0f;
        if (j < kn) {
          lw = logw[k0 + j];
          if (lw > -INFINITY) {
            u = mu[k0 + j];
            sd = sg[k0 + j];
            last = j;
          }
        }
        stage_component(lw, u, sd, stage + 2 * j);
      }
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = last;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) last = max(last, warp_last[w]);
    // Block-uniform bound: no divergence around the mma.sync.  The steps
    // past `last` would add exactly 0.
    if (last < 0) continue;
    // Two register sets of terms, da and db: the products of one step are
    // issued before the exps of the step before it.
    float da[kTilesA][kTilesB][4], db[kTilesA][kTilesB][4];
    step_terms(stage2, fa, da);
    for (int j0 = 0;; j0 += 2 * kStep) {
      if (j0 + kStep > last) {
        step_exps(da, m, s);
        break;
      }
      step_terms(stage2 + (j0 + kStep) * 4, fa, db);
      step_exps(da, m, s);
      if (j0 + 2 * kStep > last) {
        step_exps(db, m, s);
        break;
      }
      step_terms(stage2 + (j0 + 2 * kStep) * 4, fa, da);
      step_exps(db, m, s);
    }
  }
#pragma unroll
  for (int a = 0; a < kTilesA; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      quad_merge(m[a][h], s[a][h]);
      lse[a][h] = __fadd_rn(m[a][h], log2f(s[a][h]));
    }
  }
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
  __shared__ uint4 stage[kChunk * 2];
  __shared__ int warp_last[kWarps];
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockRows + (threadIdx.x >> 5) * kWarpRows;
  // Every thread takes part in staging, so none returns early.
  AFrag fa[kTilesA];
#pragma unroll
  for (int a = 0; a < kTilesA; ++a) {
    const int ig = row0 + 16 * a + g, ih = ig + 8;
    const float zg = ig < n ? z[(size_t)c * n + ig] : 0.0f;
    const float zh = ih < n ? z[(size_t)c * n + ih] : 0.0f;
    packed_cols(zg, t, fa[a].r[0], fa[a].r[2]);
    packed_cols(zh, t, fa[a].r[1], fa[a].r[3]);
  }
  float lb[kTilesA][2], la[kTilesA][2];
  mixture_lse(fa, logw_b + (size_t)c * kb, mu_b + (size_t)c * kb,
              sg_b + (size_t)c * kb, kb, stage, warp_last, lb);
  mixture_lse(fa, logw_a + (size_t)c * ka, mu_a + (size_t)c * ka,
              sg_a + (size_t)c * ka, ka, stage, warp_last, la);
  // Every lane of a quad holds all of the quad's rows; lane t writes row
  // (a, h) with 2a + h == t.  Explicitly rounded, as in ei_scores.cu:
  // equal mixtures score exactly 0.
#pragma unroll
  for (int a = 0; a < kTilesA; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + 16 * a + 8 * h + g;
      if (t == ((2 * a + h) & 3) && i < n) {
        out[(size_t)c * n + i] = __fmul_rn(__fsub_rn(lb[a][h], la[a][h]),
                                           kLn2);
      }
    }
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
