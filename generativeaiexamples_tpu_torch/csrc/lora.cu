// The per-row low-rank (LoRA) update of one projection, added into the
// projection's output in place:
//
//   y[t] = round(y[t] + round(round(x[t] . A[s]^T) . B[s]^T)),  s = slot(t)
//
// x (T, K) is the projection's input, y (T, O) its output, A (N, r, K)
// and B (N, O, r) the resident adapters' factors (the alpha / r scale is
// folded into A), "round" rounds to the working type (bf16 or f32), and
// every sum is taken in f32. Row t belongs to batch row t / S (S tokens a
// batch row) and takes that row's slot, slots[t / S]. A row whose slot is
// 0 is the base model: it is neither read nor written, so a batch of base
// rows costs one launch that exits at once. Without slots (a global
// adapter) every row takes A[0] and B[0].
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// generativeaiexamples_tpu/models/llama.py:271-303 (_maybe_lora: an einsum
// over all N slots, a gather by adapter_ix, a batched product with the
// gathered B[ix] and the add into the base output), which eager PyTorch
// would run as about five launches a projection. Its plain version is
// ops/lora.py lora_apply_plain. The reference adds into a new array; this
// kernel adds into y in place, the port's one in-place write of a
// projection's output (y is the fresh result of the projection's GEMM).
//
// What bounds it: at decode, bytes: the adapter rows' x, each distinct
// slot's A and B (r (K + O) values a slot), the adapter rows' y read and
// written; at prefill, the x read and the y read-modify-write, which grow
// with the rows while the factors do not. The work, 2 r (K + O) operations
// an adapter row, is small against either.
//
// Design (a first one, right and simple; no wgmma): a block owns a tile of
// ROWS rows and a tile of output columns. It loads its rows' slots,
// compacts the adapter rows into shared memory and exits at once when
// there are none. Then a warp a row computes the row's r values of z = x .
// A[s]^T in f32 (16-byte loads of x and of A[s]'s rows, r accumulators a
// lane, a warp sum), rounds them to the working type and keeps them in
// shared memory. Last, a thread an output column walks the tile's adapter
// rows: it loads the column's r values of B[s] with 16-byte loads (again
// only when the slot changes from the row before), takes the f32 sum of
// the r products, rounds it, adds it to y and rounds again. Every block
// recomputes z for its rows, K r multiply-adds a row, which is small next
// to reading A[s]; the output tiles are sized (ops/cuda/lora.py
// lora_plan) so that the grid fills the card at decode and at prefill
// each block covers a long stretch of columns.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's lora
// cases, CUDA-graph replays): 0.012 to 0.056 ms at 8 rows, 0.084 to 0.61
// ms at 4,096, against bounds (bytes) of 0.0001 to 0.0006 and 0.011 to
// 0.080 ms: at decode every block's z pass streams x and A[s] through its
// SM (up to 2.9 MB at K = 14,336), at prefill the row-by-row walk of y.
// A variant that loaded every row's y of a column first (a fully unrolled
// row loop) took 236 to 255 registers, spilled, and ran 1.5 to 3.7x
// slower at every case.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;            // rows a block's tile (lora_plan's ROWS)
constexpr unsigned int FULL = 0xFFFFFFFFu;

template <typename T> struct Vec;   // a 16-byte vector of T as floats
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  __device__ static float round(float f) { return f; }
  __device__ static float get(float t) { return t; }
  __device__ static float put(float f) { return f; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float f) {
    return __bfloat162float(__float2bfloat16(f));
  }
  __device__ static float get(__nv_bfloat16 t) { return __bfloat162float(t); }
  __device__ static __nv_bfloat16 put(float f) { return __float2bfloat16(f); }
};

struct Args {
  const void* x;
  const void* a;
  const void* b;
  void* y;
  const int* slots;   // (T / S,) or null: every row takes adapter 0
  int T, K, O, r, S, cols;   // cols: output columns a block
};

// RB: the rank rounded up to an instance (8, 16, 32, 64); r <= RB.
template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
lora_kernel(const Args p) {
  using V = Vec<T>;
  constexpr int VN = V::N;
  __shared__ int srow[ROWS];
  __shared__ int sslot[ROWS];
  __shared__ int s_n;
  __shared__ float z[ROWS][RB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  if (warp == 0) {
    const int row = row0 + lane;
    int s = 0;
    bool take = false;
    if (lane < ROWS && row < p.T) {
      s = p.slots ? p.slots[row / p.S] : 0;
      take = p.slots == nullptr || s != 0;
    }
    const unsigned int m = __ballot_sync(FULL, take);
    if (take) {
      const int pos = __popc(m & ((1u << lane) - 1u));
      srow[pos] = row;
      sslot[pos] = s;
    }
    if (lane == 0) s_n = __popc(m);
  }
  __syncthreads();
  const int n = s_n;
  if (n == 0) return;   // base rows only: nothing to read or write

  const T* x = static_cast<const T*>(p.x);
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* y = static_cast<T*>(p.y);
  const int r = p.r;

  // z = round(x . A[s]^T), a warp a row
  for (int i = warp; i < n; i += WARPS) {
    const T* xr = x + (long long)srow[i] * p.K;
    const T* ar = a + (long long)sslot[i] * r * p.K;
    float acc[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[j] = 0.f;
#pragma unroll 2
    for (int k = lane * VN; k < p.K; k += 32 * VN) {
      float xv[VN];
      V::load(xr + k, xv);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j < r) {
          float av[VN];
          V::load(ar + (long long)j * p.K + k, av);
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[j] = fmaf(xv[e], av[e], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      if (lane == 0 && j < r) z[i][j] = V::round(v);
    }
  }
  __syncthreads();

  // y += round(z . B[s]^T), a thread an output column
  const int c0 = blockIdx.y * p.cols;
  const int c1 = min(p.O, c0 + p.cols);
  for (int o = c0 + tid; o < c1; o += THREADS) {
    float bv[RB];
    int cur = -1;
    for (int i = 0; i < n; ++i) {
      const int s = sslot[i];
      if (s != cur) {
        const T* br = b + ((long long)s * p.O + o) * r;
#pragma unroll
        for (int j = 0; j < RB; j += VN) {
          if (j < r) {
            float v[VN];
            V::load(br + j, v);
#pragma unroll
            for (int e = 0; e < VN; ++e) bv[j + e] = v[e];
          }
        }
        cur = s;
      }
      float u = 0.f;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (j < r) u = fmaf(z[i][j], bv[j], u);
      }
      T* yp = y + (long long)srow[i] * p.O + o;
      *yp = V::put(V::get(*yp) + V::round(u));
    }
  }
}

template <typename T>
int launch(const Args& p, int rb, cudaStream_t stream) {
  const dim3 grid((p.T + ROWS - 1) / ROWS, (p.O + p.cols - 1) / p.cols);
  switch (rb) {
    case 8: lora_kernel<T, 8><<<grid, THREADS, 0, stream>>>(p); break;
    case 16: lora_kernel<T, 16><<<grid, THREADS, 0, stream>>>(p); break;
    case 32: lora_kernel<T, 32><<<grid, THREADS, 0, stream>>>(p); break;
    case 64: lora_kernel<T, 64><<<grid, THREADS, 0, stream>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: f32, 1: bf16. x (T, K), a (N, r, K), b (N, O, r), y (T, O),
// slots (T / S,) int32 or null; cols output columns a block. The wrapper
// (ops/cuda/lora.py) checks shapes, alignment and the rank. Returns a
// CUDA error code, 0 on success.
extern "C" int gk_lora_apply(int dtype, const void* x, const void* a,
                             const void* b, void* y, const void* slots,
                             int T, int K, int O, int r, int S, int cols,
                             void* stream) {
  const int vn = dtype == 0 ? 4 : 8;
  if (T <= 0 || K <= 0 || O <= 0 || r <= 0 || r > 64 || S <= 0
      || cols <= 0 || K % vn || r % vn) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.y = y;
  p.slots = static_cast<const int*>(slots);
  p.T = T;
  p.K = K;
  p.O = O;
  p.r = r;
  p.S = S;
  p.cols = cols;
  const int rb = r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, rb, st)
                    : launch<__nv_bfloat16>(p, rb, st);
}
