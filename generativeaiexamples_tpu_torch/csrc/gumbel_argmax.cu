// Gumbel-argmax sampling with threefry2x32 draws: for each row r of
// (R, V) float32 logits and its key (k1, k2), the index of the largest
// logits[r, i] + gumbel(r, i), the first one on ties, where gumbel(r, i) is
// jax.random.gumbel's "low" mode over jax.random's partitionable bits:
//   (x0, x1) = threefry2x32((k1, k2), (0, i)),  bits = x0 ^ x1,
//   u = max(tiny, (float(bits >> 9 | 0x3F800000) - 1) * (1 - tiny) + tiny),
//   gumbel = -logf(-logf(u)).
// A -inf logit (a masked token) stays -inf and is never drawn while the
// row has a finite entry; a row of -inf gives index 0, as jnp.argmax does.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion behind
// jax.random.categorical under jax.vmap in
// generativeaiexamples_tpu/ops/sampling.py sample_logits_per_slot (one key
// per row, the serving engine's seeded draws). Its plain version is
// ops/threefry.py categorical, which it equals token for token: the integer
// work is exact, the scale and the final add use round-to-nearest
// intrinsics (no contraction into an FMA), and logf is the accurate libm
// logf (not __logf), as torch's own log kernel uses.
//
// What bounds it on the H100: 32-bit integer operations. Each entry costs
// about 90 operations (threefry's 20 rounds of add, rotate and xor and its
// 5 key injections, the uniform's shift, or, subtract and scale, two logs,
// the add and the compare) against 4 bytes read: at R = 72, V = 128,256 that
// is ~12 us of the card's 32-bit rate against ~11 us to read the logits
// once. So the design spreads every row over many blocks: the grid is
// (splits, R), block (s, r) walks one contiguous segment of row r, threads
// on neighbouring entries (coalesced 4-byte reads), each thread keeps its
// best (value, index) packed into one 64-bit word (an order-preserving
// image of the float in the high half, ~index in the low half, so the
// largest word is the largest value at the smallest index), the block
// reduces by warp shuffles, and one atomicMax per block lands in the row's
// word. A second, one-thread-per-row launch unpacks the index. Nothing is
// read twice and no partials go to device memory besides R words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: jax._src.prng._threefry2x32_lowering unrolled.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2,
                                              uint32_t c0, uint32_t c1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[(i % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// An order-preserving 32-bit image of a float (-0 taken as +0).
__device__ __forceinline__ uint32_t ordered(float f) {
  if (f == 0.f) f = 0.f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float tiny = 1.17549435e-38f;     // FLT_MIN, jnp.finfo(f32).tiny
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(THREADS)
    gumbel_argmax_kernel(const long long* __restrict__ keys,
                         const float* __restrict__ logits, int V,
                         long long row_stride, int seg,
                         unsigned long long* __restrict__ best) {
  const int r = blockIdx.y;
  const uint32_t k1 = (uint32_t)keys[2 * r], k2 = (uint32_t)keys[2 * r + 1];
  const float* row = logits + r * row_stride;
  const int lo = blockIdx.x * seg, hi = min(V, lo + seg);
  unsigned long long mine = 0ull;   // below every float's image
  for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
    const uint2 x = threefry2x32(k1, k2, 0u, (uint32_t)i);
    const float v = __fadd_rn(row[i], gumbel_of(x.x ^ x.y));
    const unsigned long long w =
        ((unsigned long long)ordered(v) << 32) | (0xFFFFFFFFu - (uint32_t)i);
    mine = w > mine ? w : mine;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, mine, off);
    mine = o > mine ? o : mine;
  }
  __shared__ unsigned long long warp_best[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w)
      mine = warp_best[w] > mine ? warp_best[w] : mine;
    atomicMax(best + r, mine);
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ best,
                              int R, int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) out[r] = (int)(0xFFFFFFFFu - (uint32_t)(best[r] & 0xFFFFFFFFull));
}

__global__ void bits_kernel(const long long* __restrict__ keys, int R, int n,
                            unsigned int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (r >= R || i >= n) return;
  const uint2 x = threefry2x32((uint32_t)keys[2 * r],
                               (uint32_t)keys[2 * r + 1], 0u, (uint32_t)i);
  out[(long long)r * n + i] = x.x ^ x.y;
}

}  // namespace

// keys: (R, 2) int64 on the device, each entry a uint32 key word; logits:
// (R, V) float32, entries contiguous, rows `row_stride` floats apart; best:
// R uint64 words of scratch (set here); out: (R,) int32. The grid is
// (splits, R), each split `seg` consecutive entries, a multiple of 256
// covering V. Returns cudaGetLastError().
extern "C" int gk_gumbel_argmax(const void* keys, const void* logits, int R,
                                int V, long long row_stride, int splits,
                                int seg, void* best, void* out,
                                void* stream) {
  if (R <= 0 || R > 65535 || V <= 0 || splits <= 0 || seg <= 0 ||
      seg % THREADS || (long long)splits * seg < V || row_stride < V) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(best, 0, sizeof(unsigned long long) * R,
                                    s);
  if (err != cudaSuccess) return (int)err;
  gumbel_argmax_kernel<<<dim3(splits, R), THREADS, 0, s>>>(
      static_cast<const long long*>(keys), static_cast<const float*>(logits),
      V, row_stride, seg, static_cast<unsigned long long*>(best));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unpack_kernel<<<(R + 127) / 128, 128, 0, s>>>(
      static_cast<const unsigned long long*>(best), R, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// The 32-bit random bits of counters 0..n-1 under each of R keys, as
// jax.random.bits gives them: out (R, n) uint32. Used to check the
// generator alone; the sampler above calls the same threefry2x32.
extern "C" int gk_threefry_bits(const void* keys, int R, int n, void* out,
                                void* stream) {
  if (R <= 0 || R > 65535 || n <= 0) return (int)cudaErrorInvalidValue;
  bits_kernel<<<dim3((n + 255) / 256, R), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), R, n,
      static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}
