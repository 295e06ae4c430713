// W8A16 GEMM: y = (x @ q^T, rounded to x's dtype) * s, rounded again.
//
// Replaces generativeaiexamples_tpu/ops/quant.py matmul (:98-104), the
// QTensor branch `(x @ q.astype(x.dtype)) * s.astype(x.dtype)`: no Pallas
// kernel there, XLA fuses the int8 -> bf16 convert into the dot's operand
// load. x is (M, K) bf16 or f32, q the (N, K) int8 weight (the port's
// nn.Linear layout, one row per output channel), s (N,) f32 per-channel
// scales. The bf16 result is the reference's: the f32 accumulator is
// rounded to bf16 (the dot's output), multiplied by s rounded to bf16, and
// rounded again. The f32 result is acc * s.
//
// What bounds it on the H100. Decode (M = 8 to 72 rows: 8 slots, times
// the verify width) does 2M operations per weight byte, far below the ~295
// at which the tensor cores and not device memory set the limit: the
// kernel is a stream of int8 weight bytes, and int8 halves the bytes of a
// bf16 weight. A prefill group (M = 4,096) does 8,192 operations per
// weight byte: bound by the tensor cores. What the design does:
//
// * Tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulators). The int8
//   weights are staged in shared memory as int8 and become bf16 in
//   registers (exact for -127..127): each lane loads 8 consecutive bytes of
//   a weight row and converts them with the magic-number trick (byte + 128
//   as the low mantissa bits of 2^23, minus 2^23 + 128: 4 byte permutes, 4
//   adds and 2 packs per 4 bytes). ldmatrix has no int8-to-bf16 path, so
//   the contraction axis is permuted instead: within a 32-deep slab, lane t
//   of a quad owns depths 8t..8t+7 of both operands, and the two mma of
//   the slab take depths {8t..8t+3} and {8t+4..8t+7} in the places of
//   {c0, c0+1, c0+8, c0+9}. A dot product does not depend on the order of
//   its terms, so A and B permuted alike give the same sum: each lane reads
//   A with one 16-byte and B with one 8-byte shared-memory load a slab.
// * A cp.async ring (the flash_prefill ring): x rows in bf16 and weight
//   rows in int8, 16 bytes a copy, rows past M or depths past K
//   zero-filled; both tiles XOR-swizzled by 16-byte chunk, so the
//   fragment loads hit no bank twice; as many stages as 96 KB holds (3 to
//   8). One barrier a stage.
// * Two tile shapes. Decode rows (M <= 80): BM = 16 to 80 (M rounded up to
//   16) by BN = 128 columns, 128 deep a stage (each weight row segment a
//   whole 128-byte line: tiles of 64 x 64 reading 64-byte segments were
//   slower at every decode shape, PERF.md), 8 warps side by side over N,
//   each holding every row of the tile and 16 columns. Larger M: 128 x 128
//   tiles 64 deep, 4 warps of 128 x 32 (each converted weight fragment
//   feeds 8 m-tiles). Decode has few N tiles
//   (wk/wv: N = 1,024, 8 tiles of 128), so the contraction is split over a
//   third grid axis (split-K, the plan from shapes only, in
//   ops/cuda/quant.py): each split writes its f32 partial, takes a ticket
//   of its output tile, and the last to arrive adds the partials in split
//   order (deterministic; 8 elements' loads in flight a thread), rounds
//   and scales, and resets the ticket. One launch a call; launches sharing
//   the ticket buffer run in one stream's order.
// * f32 activations (the parity phase) take a scalar instance: 32 x 64
//   output tiles, 256 threads of 2 x 4 outputs each, f32 FMAs from shared
//   memory, no split. TF32 would change the parity phase's greedy streams.
//
// wgmma and TMA, a persistent schedule and a per-shape split plan are
// later work. Registers and spills: chip_smoke.py's build phase.
#include "common.cuh"

using namespace gk;

namespace {

constexpr int GEMM_SPLIT_MAX = 16;
constexpr int SMEM_BUDGET = 96 * 1024;   // ring bytes a block, at most

template <int BM_, int BN_, int WARPS_M, int WARPS_N, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_COLS = WARPS_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_ELEMS = BM * BK;     // bf16, 2*BK bytes a row
  static constexpr int B_BYTES = BN * BK;     // int8, BK bytes a row
  static constexpr int STAGE_BYTES = 2 * A_ELEMS + B_BYTES;
  // as many stages as the budget holds, 3 to 8
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE_BYTES < 3
          ? 3
          : (SMEM_BUDGET / STAGE_BYTES > 8 ? 8 : SMEM_BUDGET / STAGE_BYTES);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES;
};

// 16-byte chunk c of x row r, XOR-swizzled: in a fragment load the lanes
// of a quarter warp read chunks 4ks..4ks+3 of two adjacent rows
__device__ __forceinline__ int a_chunk(int r, int c) {
  return c ^ ((r & 1) << 2);
}
// 16-byte chunk c of weight row r: in a fragment load a half warp reads
// chunks 2ks, 2ks+1 of four adjacent rows; 64-byte rows put two rows in a
// bank line, 128-byte rows one
template <int BK>
__device__ __forceinline__ int b_chunk(int r, int c) {
  if constexpr (BK == 64) return c ^ (((r >> 1) & 1) << 1);
  return c ^ ((r & 3) << 1);
}

// four int8 (bytes 0..3 of w) as two bf16 pairs: (b0, b1) and (b2, b3)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;   // each byte + 128
  constexpr float MAGIC = 8388736.f;    // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - MAGIC;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// the reference's bf16 epilogue: the dot's output in bf16, times s in bf16
__device__ __forceinline__ __nv_bfloat16 scale_out(float acc, float s) {
  const float y = __bfloat162float(__float2bfloat16(acc));
  const float sv = __bfloat162float(__float2bfloat16(s));
  return __float2bfloat16(y * sv);
}

template <typename TL>
__global__ void __launch_bounds__(TL::THREADS)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ y, int M, int N, int K,
                     int tiles_per_split, float* __restrict__ part,
                     int* __restrict__ tickets) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, STAGES = TL::STAGES;
  constexpr int THREADS = TL::THREADS, MT = TL::MT, NT = TL::NT;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_COLS, wn = warp % TL::WARPS_COLS;
  const int gr = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int S = gridDim.z, split = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = split * tiles_per_split;
  const int n_k = min(kt0 + tiles_per_split, k_tiles) - kt0;

  const auto stage_a = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(gemm_smem +
                                            st * TL::STAGE_BYTES);
  };
  const auto stage_b = [&](int st) {
    return reinterpret_cast<int8_t*>(gemm_smem + st * TL::STAGE_BYTES +
                                     2 * TL::A_ELEMS);
  };
  // stage st <- depth tile kt: x rows m0.., weight rows n0..
  const auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = stage_a(st);
    constexpr int AC = BK / 8, BC = BK / 16;   // 16-byte chunks a row
    for (int idx = tid; idx < BM * AC; idx += THREADS) {
      const int r = idx / AC, c = idx % AC;
      const bool ok = m0 + r < M && k0 + 8 * c < K;
      const __nv_bfloat16* src =
          ok ? x + (long long)(m0 + r) * K + k0 + 8 * c : x;
      cp_async16(as + r * BK + a_chunk(r, c) * 8, src, ok);
    }
    int8_t* bs = stage_b(st);
    for (int idx = tid; idx < BN * BC; idx += THREADS) {
      const int r = idx / BC, c = idx % BC;
      const bool ok = n0 + r < N && k0 + 16 * c < K;
      const int8_t* src = ok ? q + (long long)(n0 + r) * K + k0 + 16 * c : q;
      cp_async16(bs + r * BK + b_chunk<BK>(r, c) * 16, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k) load(kt0 + st, st);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile i landed; tile i-1's stage is free
    {
      const int nx = i + STAGES - 1;
      if (nx < n_k) load(kt0 + nx, nx % STAGES);
      cp_async_commit();
    }
    const __nv_bfloat16* as = stage_a(i % STAGES);
    const int8_t* bs = stage_b(i % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // this lane's depths 32ks + 8t4 .. +7 of each weight row: two mma's
      // B fragments (b0, b1) per n-tile
      uint32_t b[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wn * TL::WN + nt * 8 + gr;
        const uint2 w = *reinterpret_cast<const uint2*>(
            bs + r * BK + b_chunk<BK>(r, 2 * ks + (t4 >> 1)) * 16 +
            (t4 & 1) * 8);
        i8x4_to_bf16(w.x, b[nt][0], b[nt][1]);
        i8x4_to_bf16(w.y, b[nt][2], b[nt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = wm * TL::WM + mt * 16 + gr;
        const uint4 lo = *reinterpret_cast<const uint4*>(
            as + r0 * BK + a_chunk(r0, 4 * ks + t4) * 8);
        const uint4 hi = *reinterpret_cast<const uint4*>(
            as + (r0 + 8) * BK + a_chunk(r0 + 8, 4 * ks + t4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, b[nt][0], b[nt][1]);
          mma_bf16(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, b[nt][2], b[nt][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // --- epilogue: the output (S == 1) or this split's f32 partial --------
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * TL::WM + mt * 16 + gr + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * TL::WN + nt * 8 + 2 * t4;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (S == 1) {
          if (col < N) y[(long long)row * N + col] = scale_out(v0, s[col]);
          if (col + 1 < N)
            y[(long long)row * N + col + 1] = scale_out(v1, s[col + 1]);
        } else {
          float* p = part + ((long long)split * M + row) * N + col;
          if (col < N) p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        }
      }
    }
  }
  if (S == 1) return;

  // --- the last split of this output tile to finish adds the partials ----
  const int cell = blockIdx.y * gridDim.x + blockIdx.x;   // output tile
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(tickets + cell, 1) == S - 1;
    if (last_s) tickets[cell] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // each thread adds E elements a pass, their loads of one split in
  // flight together
  constexpr int E = 8;
  for (int base = tid; base < BM * BN; base += E * THREADS) {
    float a[E];
    long long off[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = base + e * THREADS;
      const int row = m0 + idx / BN, col = n0 + idx % BN;
      a[e] = 0.f;
      off[e] = idx < BM * BN && row < M && col < N
                   ? (long long)row * N + col : -1;
    }
    for (int sp = 0; sp < S; ++sp) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (off[e] >= 0) a[e] += __ldcg(part + (long long)sp * M * N + off[e]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (off[e] >= 0) y[off[e]] = scale_out(a[e], s[off[e] % N]);
  }
}

// f32 activations: scalar FMAs, 32 x 64 outputs a block of 256 threads
constexpr int FBM = 32, FBN = 64, FBK = 32;

__global__ void __launch_bounds__(256)
    w8a16_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ s, float* __restrict__ y,
                     int M, int N, int K) {
  __shared__ float xs[FBK][FBM + 1];
  __shared__ float ws[FBK][FBN + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int idx = tid; idx < FBM * FBK; idx += 256) {
      const int r = idx / FBK, kk = idx % FBK;
      xs[kk][r] = m0 + r < M && k0 + kk < K
                      ? x[(long long)(m0 + r) * K + k0 + kk]
                      : 0.f;
    }
    for (int idx = tid; idx < FBN * FBK; idx += 256) {
      const int r = idx / FBK, kk = idx % FBK;
      ws[kk][r] = n0 + r < N && k0 + kk < K
                      ? (float)q[(long long)(n0 + r) * K + k0 + kk]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FBK; ++kk) {
      const float a0 = xs[kk][ty], a1 = xs[kk][ty + 16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = ws[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, w, acc[0][j]);
        acc[1][j] = fmaf(a1, w, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) y[(long long)row * N + col] = acc[i][j] * s[col];
    }
  }
}

template <typename TL>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* q,
                       const float* s, __nv_bfloat16* y, int M, int N, int K,
                       int splits, int tiles_per_split, float* part,
                       int* tickets, cudaStream_t stream) {
  const int k_tiles = (K + TL::BK - 1) / TL::BK;
  if ((long long)splits * tiles_per_split < k_tiles ||
      (long long)(splits - 1) * tiles_per_split >= k_tiles) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      w8a16_mma_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, splits);
  w8a16_mma_kernel<TL><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      x, q, s, y, M, N, K, tiles_per_split, part, tickets);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t launch_decode(const __nv_bfloat16* x, const int8_t* q,
                          const float* s, __nv_bfloat16* y, int M, int N,
                          int K, int splits, int tiles, float* part,
                          int* tickets, cudaStream_t st) {
  return launch_mma<Tile<BM, BN, 1, BN / 16, BK>>(
      x, q, s, y, M, N, K, splits, tiles, part, tickets, st);
}

cudaError_t dispatch_decode(int bm, const __nv_bfloat16* x, const int8_t* q,
                            const float* s, __nv_bfloat16* y, int M, int N,
                            int K, int splits, int tiles, float* part,
                            int* tickets, cudaStream_t st) {
  switch (bm) {
    case 16: return launch_decode<16, 128, 128>(x, q, s, y, M, N, K, splits,
                                                tiles, part, tickets, st);
    case 32: return launch_decode<32, 128, 128>(x, q, s, y, M, N, K, splits,
                                                tiles, part, tickets, st);
    case 48: return launch_decode<48, 128, 128>(x, q, s, y, M, N, K, splits,
                                                tiles, part, tickets, st);
    case 64: return launch_decode<64, 128, 128>(x, q, s, y, M, N, K, splits,
                                                tiles, part, tickets, st);
    case 80: return launch_decode<80, 128, 128>(x, q, s, y, M, N, K, splits,
                                                tiles, part, tickets, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous (M, K) of `dtype` (bf16: 16-byte aligned, K % 16 == 0);
// q: contiguous (N, K) int8, 16-byte aligned; s: (N,) f32; y: contiguous
// (M, N) of `dtype`. bf16: the tile is (bm, bn, bk): bm 16 to 80 rows by
// 128 columns (8 warps of 16 columns), 128 deep, or (128, 128, 64) for
// large M (4 warps of 128 x 32); the grid's
// third axis is `splits` of `tiles_per_split` bk-deep tiles each, and with
// splits > 1, part: f32 scratch of splits*M*N values and tickets: one zero
// int32 per output tile (the kernel leaves them zero). f32: the scalar
// instance, splits == 1. Returns cudaGetLastError().
extern "C" int gk_w8a16_gemm(int dtype, const void* x, const void* q,
                             const void* s, void* y, int M, int N, int K,
                             int bm, int bn, int bk, int splits,
                             int tiles_per_split, void* part, void* tickets,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 ||
      splits > GEMM_SPLIT_MAX || tiles_per_split <= 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  if (dtype == DT_F32) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    w8a16_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), qq,
                                           ss, static_cast<float*>(y), M, N,
                                           K);
    return (int)cudaGetLastError();
  }
  if (dtype != DT_BF16 || K % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* yy = static_cast<__nv_bfloat16*>(y);
  float* pp = static_cast<float*>(part);
  int* tt = static_cast<int*>(tickets);
  if (bm == 128 && bn == 128 && bk == 64) {
    return (int)launch_mma<Tile<128, 128, 1, 4, 64>>(
        xx, qq, ss, yy, M, N, K, splits, tiles_per_split, pp, tt, st);
  }
  if (bn == 128 && bk == 128)
    return (int)dispatch_decode(bm, xx, qq, ss, yy, M, N, K, splits,
                                tiles_per_split, pp, tt, st);
  return (int)cudaErrorInvalidValue;
}
