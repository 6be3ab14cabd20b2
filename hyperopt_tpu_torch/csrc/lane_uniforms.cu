// Every lane's uniform sheets of one device-mode step in one launch, with
// the bits that torch.rand writes for each sheet on the card.
//
// Replaces no TPU kernel: the JAX package draws its lanes' uniforms with
// jax.random inside the jitted step, and XLA fuses those draws.  The port
// drew them with torch.rand, one launch per sheet and lane (9 a lane in
// the flagship space, ~575 a 64-lane replay) plus the stacks of the
// lanes' sheets, each launch a few microseconds of a card that has
// nothing else to do meanwhile.  This kernel writes every sheet of every
// lane straight into the stacked buffers the step reads.
//
// The bits are torch.rand's (ATen/native/cuda/DistributionTemplates.h):
// a sheet of numel floats is drawn by a grid-stride launch of G blocks of
// 256 threads, G = min(ceil(numel / 256), SMs * maxThreadsPerSM / 256);
// virtual thread idx < 256 G runs curand_init(seed, idx, offset) and,
// per pass p, one curand_uniform4, whose lane ii lands at element
// idx + p * 4 * 256 G + ii * 256 G when that lies below numel.  The
// generator's offset starts at 0 after manual_seed and each sheet moves
// it by ((numel - 1) / (4 * 256 G) + 1) * 4, so a sheet's Philox counter
// is (offset / 4 + p, idx) under the key (seed lo, seed hi).  A float is
// x * 2^-32 + 2^-33 (x converted to float first, as curand does), and 1
// maps to 0 (uniform_kernel's bound reversal).  The host lays out that
// arithmetic per sheet (ops/lane_uniforms.py): each (sheet, pass) is one
// unit of the table below, and the kernel walks the units by blocks.
//
// What bounds it on an H100: the instruction issue of Philox4x32-10, not
// the bytes.  A 64-lane flagship replay writes 60.8 M floats (243 MB,
// 0.073 ms at 3.35 TB/s) but runs ~56 M Philox blocks, one per virtual
// thread and pass: torch's layout uses only lane x of most of them.  Each
// costs ten rounds of two 32-bit wide multiplies, two three-way xors and
// the key bumps, ~100 instructions with the conversions and stores, so
// about 0.17 ms at the card's issue rate.  The design spends nothing
// beyond that: one table lookup per block, no division (a unit is one
// pass, so idx is the item index), the key kept in registers, stores of
// neighbouring threads to neighbouring floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // items per thread
constexpr int kChunk = kThreads * kPerThread;  // items per block
constexpr int kUnitWords = 8;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kTwoPowM32 = 2.3283064365386963e-10f;
constexpr float kTwoPowM33 = 1.1641532182693481e-10f;

// curand's Philox4x32-10 at counter (ctr, sub): ctr in words 0-1, the
// subsequence (the virtual thread) in words 2-3.
__device__ __forceinline__ uint4 philox(unsigned long long ctr,
                                        unsigned long long sub, uint32_t k0,
                                        uint32_t k1) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32);
  uint32_t c2 = (uint32_t)sub, c3 = (uint32_t)(sub >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c0, hi0 = __umulhi(kM0, c0);
    const uint32_t lo1 = kM1 * c2, hi1 = __umulhi(kM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// curand_uniform's float in (0, 1], then uniform_kernel's 1 -> 0.
__device__ __forceinline__ float to_uniform(uint32_t x) {
  const float v = __fmaf_rn(__uint2float_rn(x), kTwoPowM32, kTwoPowM33);
  return v == 1.0f ? 0.0f : v;
}

// units: int64 [U, 8] rows (out address, seed slot, Philox counter,
// numel, threads = 256 G, base = p * 4 * 256 G, items, first block);
// block_unit: int32 [blocks], the unit each block works on.
__global__ void __launch_bounds__(kThreads)
    lane_uniforms_kernel(const long long* __restrict__ units,
                         const int* __restrict__ block_unit,
                         const long long* __restrict__ seeds) {
  const long long* row = units + (size_t)block_unit[blockIdx.x] * kUnitWords;
  float* out = reinterpret_cast<float*>(row[0]);
  const unsigned long long seed = (unsigned long long)seeds[row[1]];
  const unsigned long long ctr = (unsigned long long)row[2];
  const long long numel = row[3], threads = row[4], base = row[5];
  const long long items = row[6];
  const long long i0 =
      ((long long)blockIdx.x - row[7]) * kChunk + threadIdx.x;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long idx = i0 + r * kThreads;
    if (idx >= items) break;
    const uint4 x = philox(ctr, (unsigned long long)idx, k0, k1);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    long long li = base + idx;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii, li += threads) {
      if (li < numel) out[li] = to_uniform(w[ii]);
    }
  }
}

}  // namespace

// units, block_unit and seeds are contiguous device arrays on the current
// device (see the kernel); seeds is int64 [slots].  Launches n_blocks
// blocks on `stream` without synchronising and returns
// cudaGetLastError(): a refused launch (n_blocks out of range) is an
// error, never a silent no-op.
extern "C" int lane_uniforms_launch(const long long* units,
                                    const int* block_unit,
                                    const long long* seeds, int n_blocks,
                                    void* stream) {
  lane_uniforms_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      units, block_unit, seeds);
  return (int)cudaGetLastError();
}
