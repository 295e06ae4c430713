// Ragged decode: single-token GQA attention over a dense per-slot KV cache,
// online softmax in f32.
//
// Replaces generativeaiexamples_tpu/ops/pallas/attention.py ragged_decode /
// _decode_kernel, the decode attention of the dense-cache model API
// (models/llama.py decode_step). Slot b's one query per head sees the cache
// rows t < lengths[b]; the walk is clamped to the cache's T rows, because
// decode_step passes lengths = T + 1 once a slot is full. Output is finite,
// never NaN (NEG_INF masking and the max(l, 1e-30) guard, as in the TPU
// kernel).
//
// The TPU grid (B, KV, T-blocks) carried acc/m/l in VMEM across T-blocks and
// clamped the DMA of blocks past the length. Here the grid is (B, KV, S):
// block s walks its split of the 64-token tiles of rows 0..min(lengths[b],
// T), so nothing past the length is read, and the last block of each (slot,
// head) combines the splits. The walk is attend_tiles in common.cuh, shared
// with ragged_paged.cu, as a row of one query at position len - 1; the note
// there says what bounds it (device memory bytes: G = 4 queries per KV
// head at llama3-8b, about one multiply-add per byte), its copy pipeline,
// tensor-core products for bf16 and how the splits combine. This file
// keeps only the address resolution and the launch. K and V, one layer of
// the cache as (B, T, KV, HD) with the same strides, are read in place
// through those strides, with no transposes.
//
// Split plan at the smoke shapes (T = 2048, 8 KV heads, 132 SMs): batch 8
// runs 6 splits of 6 tiles (384 blocks), batch 1 32 splits of 1 tile
// (256 blocks).
// Registers and spills: chip_smoke.py's build phase.
#include "common.cuh"

using namespace gk;

namespace {

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(Walk<T, T, HD, GB>::RT)
    ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int T_len, int H, int KV, long long sb, long long st,
                         long long sh, float scale, int tiles,
                         float* __restrict__ part, int* __restrict__ tickets) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int len = min(lengths[b], T_len);
  // token pos of slot b, head kvh: element b*sb + pos*st + kvh*sh
  const long long row0 = b * sb + kvh * sh;
  const auto locate = [=](int pos, long long&) { return row0 + pos * st; };
  // q and out are contiguous (B, 1, H, HD): one query, at position len - 1
  attend_tiles<T, T, HD, GB>(q, out, (long long)b * H * HD, k, v, nullptr,
                             nullptr, len, len - 1, 1, 1, H / KV, H, kvh,
                             scale, tiles, H / KV, part, tickets, locate);
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  int B, T_len, H, KV, tiles, splits;
  float* part;
  int* tickets;
  const long long* strides;   // k and v: b, t, kv (elements)
  cudaStream_t stream;
};

template <typename T, int HD, int GB>
cudaError_t launch_gb(const Args& a) {
  using W = Walk<T, T, HD, GB>;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_decode_kernel<T, HD, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::SMEM);
  if (err != cudaSuccess) return err;
  const long long* s = a.strides;
  dim3 grid(a.B, a.KV, a.splits);
  ragged_decode_kernel<T, HD, GB><<<grid, W::RT, W::SMEM, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out),
          a.T_len, a.H, a.KV, s[0], s[1], s[2], 1.f / sqrtf((float)HD),
          a.tiles, a.part, a.tickets);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.KV;
  if (G <= 16) return launch_gb<T, HD, 16>(a);
  if (G <= 32) return launch_gb<T, HD, 32>(a);
  if constexpr (qg_cap<HD>() == QG_MAX) {
    if (G <= QG_MAX) return launch_gb<T, HD, QG_MAX>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: contiguous (B, 1, H, HD); k, v: (B, T, KV, HD) with the head dim
// contiguous, 16-byte aligned rows and the same strides (b, t, kv) in
// elements at `strides` (3 values, host memory); lengths: (B,) int32 on the
// device. The grid is (B, KV, splits), each split `tiles` 64-token tiles;
// with splits > 1, part: f32 scratch of B*KV*splits*(H/KV)*(HD+2) values
// and tickets: B*KV int32 counters, zero (the kernel leaves them zero).
// Returns cudaGetLastError().
extern "C" int gk_ragged_decode(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* lengths, void* out, int B,
                                int T_len, int H, int KV, int tiles,
                                int splits, void* part, void* tickets,
                                const void* strides, void* stream) {
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV || tiles <= 0 ||
      splits <= 0 || splits > SPLIT_MAX ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, static_cast<const int*>(lengths), out, B, T_len, H,
               KV, tiles, splits, static_cast<float*>(part),
               static_cast<int*>(tickets),
               static_cast<const long long*>(strides),
               static_cast<cudaStream_t>(stream)};
  if (dtype == DT_BF16) return (int)dispatch_hd<__nv_bfloat16>(head_dim, a);
  if (dtype == DT_F32) return (int)dispatch_hd<float>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
