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
// clamped the DMA of blocks past the length. Here one block per (slot, KV
// head) holds that head's G query vectors in shared memory and walks
// 64-token tiles of rows 0..min(lengths[b], T) itself: nothing past the
// length is read. The walk is attend_tiles in common.cuh, shared with
// ragged_paged.cu, as a row of one query at position len - 1; this file
// keeps only the address resolution and the launch. K and V, one layer of
// the cache as (B, T, KV, HD) with the same strides, are read in place
// through those strides, with no transposes.
//
// Bound on the H100: a decode step reads every live K/V byte once for G
// queries per KV head (4 at llama3-8b), about one multiply-add per byte, so
// device memory bytes bound it. The block resolves each token's row offset
// once per tile and loads K/V with 16-byte vector loads (8 bf16 values). It
// launches only B*KV blocks (64 at batch 8 with 8 KV heads, on 132 SMs), so
// the longest slot's walk sets the time; splitting the walk across blocks
// is later work.
#include "common.cuh"

using namespace gk;

namespace {

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(GB > 8 ? 256 : 128) ragged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, int T_len, int H,
    int KV, long long sb, long long st, long long sh, float scale) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int len = min(lengths[b], T_len);
  // token pos of slot b, head kvh: element b*sb + pos*st + kvh*sh
  const long long row0 = b * sb + kvh * sh;
  const auto locate = [=](int pos, long long&) { return row0 + pos * st; };
  // q and out are contiguous (B, 1, H, HD): one query, at position len - 1
  attend_tiles<T, T, HD, GB>(q, out, (long long)b * H * HD, k, v, nullptr,
                             nullptr, len, len - 1, 1, 1, H / KV, H, kvh,
                             scale, locate);
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  int B, T_len, H, KV;
  const long long* strides;   // k and v: b, t, kv (elements)
  cudaStream_t stream;
};

template <typename T, int HD, int GB>
cudaError_t launch_gb(const Args& a) {
  const size_t smem = tile_smem_bytes<T, HD>(a.H / a.KV);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_decode_kernel<T, HD, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tile_smem_bytes<T, HD>(GB));
  if (err != cudaSuccess) return err;
  const long long* s = a.strides;
  dim3 grid(a.B, a.KV);
  ragged_decode_kernel<T, HD, GB><<<grid, tile_threads<GB>(), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out), a.T_len,
      a.H, a.KV, s[0], s[1], s[2], 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.KV;
  if (G <= 8) return launch_gb<T, HD, 8>(a);
  if (G <= QG_MAX) return launch_gb<T, HD, QG_MAX>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: contiguous (B, 1, H, HD); k, v: (B, T, KV, HD) with the head dim
// contiguous, 16-byte aligned rows and the same strides (b, t, kv) in
// elements at `strides` (3 values, host memory); lengths: (B,) int32 on the
// device. Returns cudaGetLastError().
extern "C" int gk_ragged_decode(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* lengths, void* out, int B,
                                int T_len, int H, int KV,
                                const void* strides, void* stream) {
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, static_cast<const int*>(lengths), out, B, T_len, H,
               KV, static_cast<const long long*>(strides),
               static_cast<cudaStream_t>(stream)};
  if (dtype == DT_BF16) return (int)dispatch_hd<__nv_bfloat16>(head_dim, a);
  if (dtype == DT_F32) return (int)dispatch_hd<float>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
