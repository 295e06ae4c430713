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
// What bounds it on the H100. Decode (M = 8 to 72 rows: 8 slots times the
// verify width) does 2M operations per weight byte, far below the ~295 at
// which the tensor cores and not device memory set the limit: the kernel
// is a stream of int8 weight bytes (half a bf16 weight's), and what it
// must do is keep that stream at the memory rate on every SM. A prefill
// group (M = 4,096) does 8,192 operations per weight byte: bound by the
// tensor cores, which only wgmma drives at their full rate.
//
// What the design does (bf16 activations):
//
// * wgmma with the operands swapped. A tile computes (W_tile . x_tile^T):
//   the int8 weight rows are wgmma's M (64 a consumer warpgroup) and the
//   activation rows its N (8 to 256), so a decode step of M = 8, 40 or 72
//   pads no MMA rows, and x is read from shared memory by the hardware
//   through its descriptor. An N that is not a power of two is issued as
//   a few wgmma of power-of-two widths over consecutive x rows (72 = 64 +
//   8); their accumulators concatenate in the same layout.
// * The weight as wgmma's register operand. Both tiles arrive by TMA: x in
//   bf16, K-major with the 128-byte swizzle that wgmma's B descriptor
//   reads; the weight as int8 (decode: 128-byte rows, 128-byte swizzle;
//   prefill: 64-byte rows, 64-byte swizzle). Each consumer thread loads
//   its A fragment bytes (rows g and g+8, depths 2t, 2t+1, 2t+8, 2t+9 of
//   each 16-deep step) with 2-byte shared loads, which the swizzle keeps
//   free of bank conflicts, and converts 4 bytes at a time to bf16 with
//   the 2^23 magic number (exact for -127..127), the next 64 of the depth
//   while the wgmma of these 64 runs. ldmatrix has no int8 path, and a
//   TMA-landed x tile cannot be permuted along K to suit a wider load.
// * A TMA ring with a producer. Warps 0-7 are two consumer warpgroups;
//   one lane of warp 8 keeps the ring's stages (as many as the shared
//   memory holds, 4 to 16) in flight, each stage a weight box and its x
//   boxes completing a `full` mbarrier (TMA zero-fills rows past M or N
//   and depths past K); the consumers release a stage on its `empty`
//   mbarrier once their wgmma has read it. Prefill tiles make the
//   producer a warpgroup that drops to 40 registers (setmaxnreg) so the
//   consumers get 232: their 64 x 256 f32 accumulators otherwise spill at
//   the 168 a thread that 9 warps allow, and ptxas serializes the wgmma
//   (~20% slower at M = 4,096 on the H100).
// * A persistent grid: at most one CTA (or cluster) an SM, never more
//   clusters than the card runs at once, each walking the output tiles in
//   a fixed order (grouped by 8 activation tiles, so CTAs running
//   together share x tiles and weight tiles in L2), the producer loading
//   the next tile while the consumers write this one.
// * Two tile shapes (the plan comes from shapes only, ops/cuda/quant.py
//   gemm_plan). Prefill (`wide`, M > 128): 128 weight rows x 128 or 256
//   activation rows, stages 64 deep, each consumer warpgroup 64 of the
//   weight rows against the whole shared x tile. Decode (`split`, M <=
//   128): 64 weight rows x M rounded up to 8 or 16, stages 128 deep (a
//   whole 128-byte line of each weight row), the two warpgroups taking
//   alternate stages (twice the warps converting weight bytes for a
//   tile), and the contraction split across a thread-block cluster of up
//   to 8 CTAs where the tiles alone leave SMs idle (wk/wv: 16 tiles x 4
//   ranks). The f32 partials of a decode tile (one a warpgroup) stay in
//   shared memory: after an mbarrier handshake across the cluster each
//   rank adds a share of the outputs, reading every rank's partials
//   through distributed shared memory in rank order, then warpgroup order
//   (deterministic: two calls are bit-equal), and a second handshake
//   frees the partials. No partial goes through device memory.
// * The epilogue writes rows of y: the swapped accumulator holds columns
//   of y, so results are staged in shared memory (bf16 after `scale_out`
//   for prefill tiles, the f32 partials for decode tiles) and leave as
//   16-byte stores along a row of y.
// * Host cost: the weight's tensor map is encoded once and cached by the
//   wrapper (keyed by pointer, shape, strides, dtype and box); x's is
//   encoded here on every call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint). One launch a call.
//
// What still bounds it (PERF.md §6): decode streams weights at 63 to 69%
// of the memory rate at M = 8 (TMA streaming alone, no conversion and no
// wgmma, reaches 75%); wk/wv (N = 1,024: 16 tiles) fill only 64 SMs, as
// clusters of 8 would need 16 of the card's 15 slots; prefill reloads
// each x tile from L2 for every 128 weight rows.
//
// f32 activations (the parity phase) take a scalar instance: 32 x 64
// output tiles, 256 threads of 2 x 4 outputs each, f32 FMAs from shared
// memory. TF32 would change the parity phase's greedy streams.
//
// Registers, spills and the SASS counts of HGMMA and UTMALDG per instance:
// chip_smoke.py's build phase (on the H100: decode instances 126 to 134
// registers, prefill instances 168 at launch and 232 after setmaxnreg, no
// spills).
#include <cuda.h>
#include <string.h>

#include "common.cuh"

using namespace gk;

namespace {

constexpr int BK = 64;            // depth of one x box (128 bytes a row)
constexpr int XROW = 2 * BK;      // bytes of one x row in a box
constexpr int CLUSTER_MAX = 8;
constexpr int CONSUMERS = 256;    // two consumer warpgroups
// Decode tiles: two consumer warpgroups and a producer warp (9 warps: at
// most 168 registers a thread, 3 warps sharing a quarter of the register
// file; they use ~134). Prefill tiles: a producer warpgroup that gives up
// registers (setmaxnreg) so the consumers get WIDE_REGS each.
constexpr int WIDE_REGS = 232;
template <bool SPLIT>
constexpr int threads_of() {
  return SPLIT ? CONSUMERS + 32 : CONSUMERS + 128;
}
constexpr int PSTRIDE = 68;       // f32 partial row: 64 + 4, no bank conflicts
constexpr int SMEM_LIMIT = 232448 - 1024;   // dynamic bytes, less static
constexpr int SMEM_FLOOR = 120 * 1024;      // one CTA an SM

// The static shape of an instance: BN activation rows a tile (wgmma's N);
// SPLIT: a decode tile (64 weight rows, stages 128 deep so each weight row
// segment is a whole 128-byte line, the warpgroups on alternate stages,
// f32 partials added across the cluster), else a prefill tile (128 weight
// rows, 64 a warpgroup, stages 64 deep, bf16 staged).
template <int BN, bool SPLIT>
struct Shape {
  static constexpr int ROWS = SPLIT ? 64 : 128;   // weight rows a tile
  static constexpr int KS = SPLIT ? 2 * BK : BK;  // depth a stage
  static constexpr int HALVES = KS / BK;          // x boxes a stage
  static constexpr int X_HALF = BN * XROW;        // 1,024-byte multiple
  static constexpr int X_BYTES = HALVES * X_HALF;
  static constexpr int W_BYTES = ROWS * KS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int EPI_BYTES =
      SPLIT ? 2 * BN * PSTRIDE * 4 : 2 * BN * 64 * 2;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - EPI_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 16 ? 16 : FIT;
  static constexpr int NEED = 1024 + STAGES * STAGE + EPI_BYTES;
  static constexpr int SMEM = NEED > SMEM_FLOOR ? NEED : SMEM_FLOOR;
  static_assert(STAGES >= 3, "ring too shallow");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma N");
};

struct Params {
  const float* s;
  __nv_bfloat16* y;
  int M, N, K;
  int m_tiles, n_tiles, ks_total, ks_per_rank;   // stages of the depth
};

// four int8 (bytes 0..3 of w) as two bf16 pairs: (b0, b1) and (b2, b3)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;   // each byte + 128
  constexpr float MAGIC = 8388736.f;    // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - MAGIC;
  // exact in bf16: the low halves are zero, so keep the high halves
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// the reference's bf16 epilogue: the dot's output in bf16, times s in bf16
__device__ __forceinline__ __nv_bfloat16 scale_out(float acc, float s) {
  const float y = __bfloat162float(__float2bfloat16(acc));
  const float sv = __bfloat162float(__float2bfloat16(s));
  return __float2bfloat16(y * sv);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// output tile t -> (activation tile, weight tile): groups of 8 activation
// tiles, the activation tile fastest, so CTAs running together share both
__device__ __forceinline__ void tile_of(int t, int m_tiles, int n_tiles,
                                        int& mt, int& nt) {
  constexpr int GROUP = 8;
  const int per_group = GROUP * n_tiles;
  const int g = t / per_group, first = g * GROUP;
  const int gm = min(m_tiles - first, GROUP);
  const int r = t - g * per_group;
  mt = first + r % gm;
  nt = r / gm;
}

// A fragments of 64 of a stage's depth (`half` of a 128-deep stage, or a
// 64-deep one): rows r and r + 8 of the weight tile, four 16-deep steps,
// a[j] in wgmma's register order. Decode tiles: 128-byte rows with TMA's
// 128-byte swizzle (chunk c of row r at c ^ (r & 7)); prefill tiles:
// 64-byte rows with the 64-byte swizzle (at c ^ ((r >> 1) & 3)).
template <bool SPLIT>
__device__ __forceinline__ void load_a(const uint8_t* ws, int r, int t4,
                                       int half, uint32_t (&a)[4][4]) {
  constexpr int WROW = SPLIT ? 128 : 64;
  const int sw = SPLIT ? (r & 7) : ((r >> 1) & 3);   // the same for r + 8
  const uint8_t* r0 = ws + r * WROW + 2 * t4;
  const uint8_t* r1 = r0 + 8 * WROW;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = ((4 * half + j) ^ sw) << 4;
    const uint32_t w0 = (uint32_t)*reinterpret_cast<const uint16_t*>(r0 + c) |
                        ((uint32_t)*reinterpret_cast<const uint16_t*>(
                             r0 + c + 8) << 16);
    const uint32_t w1 = (uint32_t)*reinterpret_cast<const uint16_t*>(r1 + c) |
                        ((uint32_t)*reinterpret_cast<const uint16_t*>(
                             r1 + c + 8) << 16);
    i8x4_to_bf16(w0, a[j][0], a[j][2]);
    i8x4_to_bf16(w1, a[j][1], a[j][3]);
  }
}

// registers an asynchronous wgmma reads: live until this point
__device__ __forceinline__ void keep_live(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("" ::"r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]));
}

// acc (this warpgroup's 64 x BN) += A (registers) x the BN x rows at
// `xaddr` (one 16-deep step): wgmma of power-of-two widths over
// consecutive 8-row atoms
template <int BN, int OFF = 0>
__device__ __forceinline__ void mma_rows(float* acc, const uint32_t* a,
                                         unsigned xaddr) {
  if constexpr (BN > 0) {
    constexpr int N = BN >= 256 ? 256 : BN >= 128 ? 128 : BN >= 64 ? 64
                    : BN >= 32 ? 32 : BN >= 16 ? 16 : 8;
    wgmma_rs<N>(acc + OFF / 2, a, wgmma_desc_sw128(xaddr + OFF * XROW));
    mma_rows<BN - N, OFF + N>(acc, a, xaddr);
  }
}

// eight outputs of row `row`, columns col..col+7, as 16 bytes where the row
// allows
__device__ __forceinline__ void store8(const Params& p, int row, int col,
                                       const __nv_bfloat16 (&v)[8]) {
  __nv_bfloat16* dst = p.y + (long long)row * p.N + col;
  if (col + 8 <= p.N && (p.N & 7) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < p.N) dst[e] = v[e];
  }
}

template <int BN, bool SPLIT>
__global__ void __launch_bounds__(threads_of<SPLIT>(), 1)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const Params p) {
  using S = Shape<BN, SPLIT>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t gemm_smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t red_full, red_done;
  // 1,024-byte aligned for the swizzled boxes (arithmetic on the shared
  // array, so loads stay shared-memory loads)
  uint8_t* smem =
      gemm_smem_raw + ((1024 - (smem_addr(gemm_smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int CL = (int)cluster_ctas(), rank = (int)cluster_rank();
  const int cid = blockIdx.x / CL, n_clusters = gridDim.x / CL;
  const int n_tiles = p.m_tiles * p.n_tiles;
  // this rank's stages of the depth: [ks0, ks1)
  const int ks0 = rank * p.ks_per_rank;
  const int ks1 = min(ks0 + p.ks_per_rank, p.ks_total);

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], SPLIT ? 4 : 8);   // the consumer warps
    }
    mbar_init(&red_full, CL);
    mbar_init(&red_done, CL);
    fence_mbar_init();
  }
  // every CTA's barriers exist before any rank arrives on them
  cluster_sync();

  if (warp >= CONSUMERS / 32) {
    // ---- producer: one lane keeps the ring full ------------------------
    if constexpr (!SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMERS / 32 && lane == 0) {
      tma_prefetch_map(&wmap);
      tma_prefetch_map(&xmap);
      int g = 0;
      for (int t = cid; t < n_tiles; t += n_clusters) {
        int mt, nt;
        tile_of(t, p.m_tiles, p.n_tiles, mt, nt);
        for (int ks = ks0; ks < ks1; ++ks, ++g) {
          const int st = g % STAGES;
          mbar_wait(&empty_bar[st], ((g / STAGES) & 1) ^ 1);
          uint8_t* xs = smem + st * S::STAGE;
          mbar_arrive_expect_tx(&full_bar[st], S::STAGE);
          tma_load_2d(xs + S::X_BYTES, &wmap, &full_bar[st], ks * S::KS,
                      nt * S::ROWS);
#pragma unroll
          for (int h = 0; h < S::HALVES; ++h)
            tma_load_2d(xs + h * S::X_HALF, &xmap, &full_bar[st],
                        ks * S::KS + h * BK, mt * BN);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp wq of it ---------------------------
  if constexpr (!SPLIT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WIDE_REGS)
                 : "memory");
  const int wg = warp >> 2, wq = warp & 3;
  const int gr = lane >> 2, t4 = lane & 3;
  const int arow = (SPLIT ? 0 : 64 * wg) + 16 * wq + gr;   // and arow + 8
  float acc[BN / 2];
  uint32_t a0[4][4], a1[4][4];
  // this warpgroup's work in a tile is units of 64 of the depth, u = 2 x
  // (stage - ks0) + half for decode tiles (every other stage from ks0 +
  // wg, both halves) or u = stage - ks0 for prefill tiles (all of them)
  constexpr int H = S::HALVES;
  const int n_units = (ks1 - ks0) * H;
  const auto next_unit = [&](int u) {
    return u % H < H - 1 ? u + 1 : u + 1 + (SPLIT ? H : 0);
  };
  int g0 = 0, tile_i = 0;   // the ring position of the tile's first stage
  // unit u's A fragments into `a` (first waiting for its stage to land)
  const auto fetch = [&](int u, uint32_t (&a)[4][4]) {
    const int pos = g0 + u / H;
    if (u % H == 0) mbar_wait(&full_bar[pos % STAGES], (pos / STAGES) & 1);
    load_a<SPLIT>(smem + (pos % STAGES) * S::STAGE + S::X_BYTES, arow, t4,
                  u % H, a);
  };
  const auto release = [&](int u) {   // the last unit of a stage frees it
    if (u % H == H - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[(g0 + u / H) % STAGES]);
    }
  };
  // unit u's wgmma from `cur`, the next unit's fragments loaded into `nxt`
  // while it runs; then its stage is released. Returns the next unit.
  const auto run = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4],
                       int u) {
    const unsigned xs = smem_addr(smem + ((g0 + u / H) % STAGES) * S::STAGE) +
                        (u % H) * S::X_HALF;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_rows<BN>(acc, cur[j], xs + 32 * j);
    wgmma_commit();
    const int nu = next_unit(u);
    if (nu < n_units) fetch(nu, nxt);
    wgmma_wait<0>();
    keep_live(cur);   // the wgmma read these registers until now
    release(u);
    return nu;
  };
  for (int t = cid; t < n_tiles; t += n_clusters, ++tile_i) {
    int mt, nt;
    tile_of(t, p.m_tiles, p.n_tiles, mt, nt);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int u = SPLIT ? H * wg : 0;
    if (u < n_units) fetch(u, a0);
    while (u < n_units) {
      u = run(a0, a1, u);
      if (u >= n_units) break;
      u = run(a1, a0, u);
    }
    g0 += ks1 - ks0;

    const int m0 = mt * BN;
    if constexpr (SPLIT) {
      // ---- f32 partials, added across the cluster in rank order --------
      float* part = reinterpret_cast<float*>(smem + STAGES * S::STAGE);
      // the last tile's partials may still be read by other ranks
      if (tile_i > 0) mbar_wait_cluster(&red_done, (tile_i - 1) & 1);
      float* mine = part + wg * BN * PSTRIDE;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const int m = 8 * (j >> 2) + 2 * t4 + (j & 1);
        const int r = 16 * wq + gr + 8 * ((j >> 1) & 1);
        mine[m * PSTRIDE + r] = acc[j];
      }
      fence_cluster();
      bar_sync(1, CONSUMERS);
      if (tid == 0)
        for (int q = 0; q < CL; ++q) mbar_arrive_cluster(&red_full, q);
      mbar_wait_cluster(&red_full, tile_i & 1);
      // rank `rank` adds the outputs (m, 8-column chunk c) with
      // (8m + c) % CL == rank
      const int n0 = nt * 64;
      for (int u = rank + CL * tid; u < BN * 8; u += CL * CONSUMERS) {
        const int m = u >> 3, c = u & 7;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
        for (int q = 0; q < CL; ++q) {   // ranks in order
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float* src = part + (w * BN + m) * PSTRIDE + 8 * c;
            const float4 lo = ld_cluster_f4(src, q);
            const float4 hi = ld_cluster_f4(src + 4, q);
            v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
            v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
          }
        }
        const int row = m0 + m, col = n0 + 8 * c;
        if (row < p.M && col < p.N) {
          __nv_bfloat16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = scale_out(v[e], p.s[min(col + e, p.N - 1)]);
          store8(p, row, col, o);
        }
      }
      bar_sync(1, CONSUMERS);   // this CTA has read every rank's partials
      if (tid == 0)
        for (int q = 0; q < CL; ++q) mbar_arrive_cluster(&red_done, q);
    } else {
      // ---- bf16 rows staged per warpgroup, 16-byte chunks swizzled -----
      __nv_bfloat16* stg =
          reinterpret_cast<__nv_bfloat16*>(smem + STAGES * S::STAGE) +
          wg * BN * 64;
      const int n0 = nt * S::ROWS + 64 * wg;
      const int r_lo = 16 * wq + gr;
      const float s_lo = p.s[min(n0 + r_lo, p.N - 1)];
      const float s_hi = p.s[min(n0 + r_lo + 8, p.N - 1)];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const int m = 8 * (j >> 2) + 2 * t4 + (j & 1);
        const int r = r_lo + 8 * ((j >> 1) & 1);
        stg[m * 64 + ((((r >> 3) ^ (m & 7))) << 3) + (r & 7)] =
            scale_out(acc[j], (j >> 1) & 1 ? s_hi : s_lo);
      }
      bar_sync(2 + wg, 128);
      for (int u = tid & 127; u < BN * 8; u += 128) {
        const int m = u >> 3, c = u & 7;
        const int row = m0 + m, col = n0 + 8 * c;
        if (row < p.M && col < p.N) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + m * 64 + ((c ^ (m & 7)) << 3));
          __nv_bfloat16 o[8];
          memcpy(o, &v, sizeof(v));
          store8(p, row, col, o);
        }
      }
      bar_sync(2 + wg, 128);   // the staging is free for the next tile
    }
  }
  // no rank leaves while another may still read its partials
  if (SPLIT && tile_i > 0) mbar_wait_cluster(&red_done, (tile_i - 1) & 1);
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

// cuTensorMapEncodeTiled from the driver, found once
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// a 2-D row-major map: `rows` rows of `cols` elements, `row_bytes` apart;
// boxes of box_cols x box_rows, rows and columns past the end read as zero
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int cols, int rows, long long row_bytes, int box_cols,
              int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, bool SPLIT>
int launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const Params& p,
           int cluster, int clusters, cudaStream_t stream) {
  using S = Shape<BN, SPLIT>;
  auto kern = w8a16_wgmma_kernel<BN, SPLIT>;
  static bool smem_set = false;   // the instance's dynamic-shared limit
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(threads_of<SPLIT>());
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, wmap, xmap, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the instances: decode tiles of 8 to 128 activation rows, prefill tiles of
// 128 or 256
// clusters of `cluster` CTAs of an instance that the card holds at once
template <int BN, bool SPLIT>
int max_clusters(int cluster, int* out) {
  using S = Shape<BN, SPLIT>;
  auto kern = w8a16_wgmma_kernel<BN, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads_of<SPLIT>());
  cfg.dynamicSmemBytes = S::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  return (int)err;
}

#define GK_SPLIT_ROWS(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(96) X(112) X(128)

int dispatch(bool split, int bn, const CUtensorMap& wmap,
             const CUtensorMap& xmap, const Params& p, int cluster,
             int clusters, cudaStream_t st) {
#define GK_CASE(R) \
  case R: return launch<R, true>(wmap, xmap, p, cluster, clusters, st);
  if (split) {
    switch (bn) {
      GK_SPLIT_ROWS(GK_CASE)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef GK_CASE
  switch (bn) {
    case 128: return launch<128, false>(wmap, xmap, p, cluster, clusters, st);
    case 256: return launch<256, false>(wmap, xmap, p, cluster, clusters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The weight's tensor map for the bf16 instances: q contiguous (N, K) int8,
// 16-byte aligned, K % 16 == 0; boxes of `rows` rows: 64 rows of 128 bytes
// with TMA's 128-byte swizzle (decode tiles), or 128 rows of 64 bytes with
// the 64-byte swizzle (prefill tiles). Writes the 128-byte CUtensorMap to
// `out`. Returns a CUDA error code.
extern "C" int gk_w8a16_weight_map(const void* q, int N, int K, int rows,
                                   void* out) {
  if (N <= 0 || K <= 0 || K % 16 || (rows != 64 && rows != 128) ||
      reinterpret_cast<uintptr_t>(q) % 16 || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  alignas(64) CUtensorMap map;
  const bool split = rows == 64;
  const int rc = encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, K,
                           split ? 2 * BK : BK, rows,
                           split ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0) memcpy(out, &map, sizeof(map));
  return rc;
}

// x: contiguous (M, K) of `dtype`; q: contiguous (N, K) int8; s: (N,) f32;
// y: contiguous (M, N) of `dtype`. bf16 (x 16-byte aligned, K % 16 == 0):
// `wmap` is q's map from gk_w8a16_weight_map with boxes of 64 rows when
// `split` (decode tiles of `bn` activation rows, bn a multiple of 8 up to
// 128, stages 128 deep) or 128 rows (prefill tiles, bn 128 or 256, stages
// 64 deep); the grid is `clusters` clusters of `cluster` CTAs (decode
// tiles only: up to 8), rank r of a cluster taking the stages
// [r * ks_per_rank, (r + 1) * ks_per_rank) of the contraction; x's map is
// encoded here. f32: the scalar instance
// (the plan and wmap unused). Returns a CUDA error code, 0 on success.
extern "C" int gk_w8a16_gemm(int dtype, const void* x, const void* q,
                             const void* s, void* y, int M, int N, int K,
                             const void* wmap, int split, int bn, int cluster,
                             int clusters, int ks_per_rank, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  if (dtype == DT_F32) {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    w8a16_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), qq,
                                           ss, static_cast<float*>(y), M, N,
                                           K);
    return (int)cudaGetLastError();
  }
  const int depth = split ? 2 * BK : BK;   // a stage
  const int ks_total = (K + depth - 1) / depth;
  if (dtype != DT_BF16 || K % 16 || wmap == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 || cluster < 1 ||
      cluster > CLUSTER_MAX || (!split && cluster != 1) || clusters < 1 ||
      ks_per_rank < 1 || (long long)cluster * ks_per_rank < ks_total ||
      (long long)(cluster - 1) * ks_per_rank >= ks_total) {
    return (int)cudaErrorInvalidValue;
  }
  alignas(64) CUtensorMap wm, xm;
  memcpy(&wm, wmap, sizeof(wm));
  const int rc = encode_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                           2LL * K, BK, bn, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  Params p;
  p.s = ss;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = M;
  p.N = N;
  p.K = K;
  p.m_tiles = (M + bn - 1) / bn;
  p.n_tiles = (N + (split ? 64 : 128) - 1) / (split ? 64 : 128);
  p.ks_total = ks_total;
  p.ks_per_rank = ks_per_rank;
  if (clusters > p.m_tiles * p.n_tiles) return (int)cudaErrorInvalidValue;
  return dispatch(split != 0, bn, wm, xm, p, cluster, clusters, st);
}

// How many clusters of `cluster` CTAs of a decode instance the card runs
// at once (cudaOccupancyMaxActiveClusters; every instance takes one CTA an
// SM), into *out: the plan's cluster slots.
extern "C" int gk_w8a16_max_clusters(int cluster, int* out) {
  if (cluster < 1 || cluster > CLUSTER_MAX || out == nullptr)
    return (int)cudaErrorInvalidValue;
  return max_clusters<72, true>(cluster, out);
}
