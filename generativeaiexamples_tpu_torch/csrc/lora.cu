// The per-row low-rank (LoRA) update of the projections that share one
// input, added into each projection's output in place:
//
//   y_t[i] = round(y_t[i] + round(round(x[i] . A_t[s]^T) . B_t[s]^T)),
//   s = slot(i), for each target t of the group (1 to 3)
//
// x (T, K) is the projections' input, y_t (T, O_t) target t's output, A_t
// (N, r, K) and B_t (N, O_t, r) the resident adapters' factors (the alpha
// / r scale folded into A), "round" rounds to the working type (bf16 or
// f32), and every sum is taken in f32. Row i belongs to batch row i / S
// and takes that row's slot, slots[i / S]. A row of slot 0 is the base
// model: it is neither read nor written. Without slots (a global adapter)
// every row takes A_t[0] and B_t[0]. The groups are the targets that read
// one x: wq|wk|wv, wo, w_gate|w_up, w_down (ops/lora.py).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// generativeaiexamples_tpu/models/llama.py:271-303 (_maybe_lora, once a
// target). Its plain version is ops/lora.py lora_apply_group_plain. The
// reference adds into a new array; this kernel adds into each y in place
// (y is the fresh result of the projection's GEMM).
//
// What bounds it: at decode, bytes: each distinct slot's A and B, r (K +
// O) values a slot and a target; at prefill, the x read and the y
// read-modify-write, which grow with the rows while the factors do not.
// The work, 2 r (K + O) operations a row and a target, is small beside
// either. So every byte is read once and y streams at the memory rate.
//
// Design: two kernels behind one C call, the group's targets in both.
// * Shrink, z = round(x . A_t[s]^T) once a (row, target). A CTA (4 warps)
//   takes a tile of 16 G rows (G = 1 at decode, 4 at prefill) and one of
//   P interleaved splits of K (split p takes the 128-deep chunks p, p + P,
//   ..., so neighbouring CTAs read neighbouring chunks of the same rows).
//   A ring of three cp.async stages brings each chunk's x rows (adapter
//   rows only) and, for each distinct slot of the tile and each target,
//   the r rows of A_t[s] into shared memory (256-byte rows, swizzled for
//   ldmatrix); the sources of a stage's rows are a table made once. A
//   warp multiplies 16 rows by mma.sync m16n8k16 (bf16 in, f32 sums),
//   rows of other slots entering as zeros, which add exactly nothing; at
//   prefill it loads all eight 16-deep steps' fragments of a chunk before
//   its products, at decode (G = 1) the four warps share those steps. x
//   is read once for every target and slot. The CTA adds its warps' sums
//   in a fixed order; with P > 1 it writes an f32 partial, and the last
//   CTA of the row tile to take a ticket (an integer counter it resets)
//   adds the P partials in order, all of a value's in flight, and
//   rounds: no float atomics, so two calls are bit-identical.
// * Expand, y_t += round(z . B_t[s]^T). A CTA (one warpgroup) owns 128
//   columns of one target and RT tiles of 64 rows. For each distinct slot
//   of a tile it stages the 128 columns of B_t[s] in shared memory once
//   (128-byte rows with the 128-byte swizzle, kept while the next tile
//   has the same slot, as a prefill chunk does) and runs wgmma m64n128k16
//   with z as the register operand. The staged rows are permuted so that
//   each thread's accumulators are 8 consecutive columns of a row: the
//   epilogue reads and writes y as 16-byte vectors. The C call launches
//   it with programmatic stream serialization, and the shrink lets it
//   start at once: its slots, its y loads and its B tiles overlap the
//   shrink, and it waits (griddepcontrol.wait) only before reading z.
// The f32 instance (parity checks and the dense API's f32 model) keeps
// the same grid, splits, tiles and reduction, with scalar sums in place of
// the tensor cores (a warp a row of z, a thread a column of y).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 6
// (chip_smoke.py kernel:lora and --ab, CUDA-graph replays). This design:
// 0.008 to 0.017 ms a call at 8 and 72 rows, 0.026 to 0.16 at 4,096 (43
// to 71% of the bound); a call of base rows only, two launches that
// exit, 0.0025 to 0.0049 (the engine makes no call for such a pass). The
// first design (one launch a target: every block recomputed z for its
// rows from x and A, and walked y one element a row at a time) took
// 0.012 to 0.12 ms at 8 and 72 rows and 0.08 to 0.61 ms at 4,096, 0.7 to
// 17% of its bound; a variant of it that loaded every row's y first
// spilled and was 1.5 to 3.7x slower. This design's choices, each undone
// in a copy and timed in one call (chip_smoke.py --lora-variants; ms a
// call as it is / undone): fragments loaded step by step, each mma
// waiting on its ldmatrix, 0.0740 / 0.0923 at llama3-8b's down
// projection (K = 14,336) and 4,096 rows; the expand launched only after
// the shrink, 0.0117 / 0.0157 at 8 rows; a fourth ring stage, 0.0740 /
// 0.0708 there but 0.0701 / 0.0888 for wq|wk|wv, so three stay. With no
// x read at all the shrink still took 43 us of its 55 there: the steps'
// latency, not the bytes, bounds it. A shrink that streamed x and A
// through registers (16-byte loads, a dependent L2 round trip for A
// every 32-deep step) and contiguous K slices in place of interleaved
// ones were slower and were dropped before this design.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;          // a CTA: four warps, one warpgroup
constexpr int CHUNK = 128;            // K a shrink stage (lora_plan's CHUNK)
constexpr int ROWB = CHUNK * 2;       // bytes of a staged row of a stage
constexpr int STAGES = 3;             // the shrink's cp.async ring
constexpr int TILE_ROWS = 64;         // expand rows a tile (wgmma's M)
constexpr int TILE_COLS = 128;        // expand columns a tile (wgmma's N)
constexpr int MAX_TARGETS = 3;
constexpr int MAX_STAGED = 4;         // slots a call stages at once (SB)
constexpr int BUF_BYTES = TILE_COLS * 128;   // one slot's staged B tile
// the dynamic shared memory a shrink CTA may take: the H100's 232,448
// bytes a block less room for the kernel's static arrays
constexpr int MAX_SMEM = 232448 - 10240;
constexpr unsigned FULL = 0xFFFFFFFFu;

// A resident group: mirrors ops/cuda/lora.py _Desc, built once when the
// adapters become resident.
struct Group {
  int dtype, nt, K, r;
  int O[MAX_TARGETS];
  const void* a[MAX_TARGETS];
  const void* b[MAX_TARGETS];
};

struct Args {
  const void* x;
  const int* slots;                   // (T / S,) or null: a global adapter
  void* y[MAX_TARGETS];
  const void* a[MAX_TARGETS];
  const void* b[MAX_TARGETS];
  int O[MAX_TARGETS];
  int tile0[MAX_TARGETS + 1];         // each target's first column tile
  int nt, T, K, S, r, RB, ZW;         // RB: r rounded up to 16; ZW = nt RB
  int P, G, RT, SB;                   // lora_plan
  void* z;                            // (T, ZW) in the working type
  float* part;                        // (P, T, ZW) f32 when P > 1
  int* counters;                      // a shrink row tile's tickets
};

// The slot a row takes, or -1: past the rows, or the base model.
__device__ __forceinline__ int row_slot(const Args& p, int row) {
  if (row >= p.T) return -1;
  if (p.slots == nullptr) return 0;
  const int s = p.slots[row / p.S];
  return s != 0 ? s : -1;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the kernel launched before this one (programmatic stream
// serialization) has completed and its writes are visible
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- shrink ------------------------------------------------------------------

// The distinct adapter slots of `n` (<= 64) rows whose slots are in
// r_slot, first row first, with each one's row mask; by warp 0. Returns
// their count in *d_n.
__device__ __forceinline__ void distinct_slots(const int* r_slot, int n,
                                               int* d_slot,
                                               unsigned long long* d_mask,
                                               int* d_n) {
  const int lane = threadIdx.x & 31;
  const int s0 = lane < n ? r_slot[lane] : -1;
  const int s1 = lane + 32 < n ? r_slot[lane + 32] : -1;
  unsigned p0 = __ballot_sync(FULL, s0 >= 0);
  unsigned p1 = __ballot_sync(FULL, s1 >= 0);
  int k = 0;
  while (p0 | p1) {
    const int s = p0 ? __shfl_sync(FULL, s0, __ffs(p0) - 1)
                     : __shfl_sync(FULL, s1, __ffs(p1) - 1);
    const unsigned m0 = __ballot_sync(FULL, s0 == s);
    const unsigned m1 = __ballot_sync(FULL, s1 == s);
    if (lane == 0) {
      d_slot[k] = s;
      d_mask[k] = m0 | ((unsigned long long)m1 << 32);
    }
    p0 &= ~m0;
    p1 &= ~m1;
    ++k;
  }
  if (lane == 0) *d_n = k;
}

// byte offset of 16-byte chunk c of row r in a stage of ROWB-byte rows,
// swizzled so that the 8 rows an ldmatrix reads hit 8 distinct bank groups
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

// bf16: the CTA's tile of x and its slots' A rows, chunk by chunk through
// a ring of STAGES cp.async stages; warp w multiplies its 16 rows (group
// w % G) over the 16-deep steps w / G, w / G + 4 / G, ... of each chunk.
// out: the warp's [16][ZW] f32 sums.
template <int RB, int NT>
__device__ __forceinline__ void cta_shrink(const Args& p, const bf16*,
                                           uint8_t* ring, float* out,
                                           const bf16** row_src, int rows0,
                                           const int* r_slot,
                                           const int* c_slot,
                                           const unsigned long long* c_mask,
                                           int nd, int ps, int nst) {
  constexpr int NJ = RB / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.G, WK = 4 / G, rows = 16 * G;
  const int rg = warp % G, kw = warp / G;
  const int g = lane >> 2, q = lane & 3;
  const int lr = rg * 16 + g;          // the thread's rows: lr, lr + 8
  const int stage_bytes = (rows + p.SB * NT * RB) * ROWB;
  const bf16* x = static_cast<const bf16*>(p.x);
  float acc[NT][NJ][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  constexpr int CH = CHUNK / 8;        // 16-byte chunks a staged row
  static_assert(THREADS % CH == 0, "a thread stages one chunk column");
  const int ch = tid % CH;             // the thread's chunk of every row
  for (int i0 = 0; i0 < nd; i0 += p.SB) {
    const int nb = min(p.SB, nd - i0);
    // the staged rows' sources, once a batch (null: zeros): the tile's
    // adapter rows of x, then for each slot of the batch and each target
    // the rank rows of A
    const int nrows = rows + nb * NT * RB;
    for (int i = tid; i < nrows; i += THREADS) {
      const bf16* src = nullptr;
      if (i < rows) {
        if (r_slot[i] >= 0) src = x + (size_t)(rows0 + i) * p.K;
      } else {
        const int row = i - rows, j = row % RB, bt = row / RB;
        if (j < p.r) {
          src = static_cast<const bf16*>(p.a[bt % NT])
                + ((size_t)c_slot[i0 + bt / NT] * p.r + j) * p.K;
        }
      }
      row_src[i] = src;
    }
    __syncthreads();
    // chunk c into stage buffer `buf`
    auto load = [&](int c, int buf) {
      uint8_t* st = ring + buf * stage_bytes;
      const int k = c * CHUNK + ch * 8;
      const bool kin = k < p.K;
      for (int r = tid / CH; r < nrows; r += THREADS / CH) {
        const bf16* src = row_src[r];
        const bool ok = kin && src != nullptr;
        gk::cp_async16(st + swz(r, ch), ok ? src + k : x, ok);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) load(ps + s * p.P, s);
      gk::cp_async_commit();
    }
    for (int i = 0; i < nst; ++i) {
      gk::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (i + STAGES - 1 < nst) {
        load(ps + (i + STAGES - 1) * p.P, (i + STAGES - 1) % STAGES);
      }
      gk::cp_async_commit();
      const uint8_t* st = ring + (i % STAGES) * stage_bytes;
      const uint8_t* sa = st + rows * ROWB;
      if (WK == 1) {
        // a warp a row group (prefill): the chunk's eight 16-deep steps
        // unrolled, every fragment loaded before the products, so that the
        // warp waits on its mma chains only, not on a load a step
        uint32_t xf[CHUNK / 16][4];
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
          gk::ldmatrix_x4(st + swz(rg * 16 + (lane & 15), 2 * kk + (lane >> 4)),
                          xf[kk][0], xf[kk][1], xf[kk][2], xf[kk][3]);
        }
        for (int b = 0; b < nb; ++b) {
          const unsigned long long m = c_mask[i0 + b];
          const bool il = (m >> lr) & 1, ih = (m >> (lr + 8)) & 1;
          if (!__any_sync(FULL, il || ih)) continue;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
              if (jp * 16 < p.r) {
                const int row = (b * NT + t) * RB + jp * 16 + (lane & 7)
                                + ((lane >> 4) << 3);
                uint32_t bf[CHUNK / 16][4];
#pragma unroll
                for (int kk = 0; kk < CHUNK / 16; ++kk) {
                  gk::ldmatrix_x4(sa + swz(row, 2 * kk + ((lane >> 3) & 1)),
                                  bf[kk][0], bf[kk][1], bf[kk][2], bf[kk][3]);
                }
#pragma unroll
                for (int kk = 0; kk < CHUNK / 16; ++kk) {
                  const uint32_t x0 = il ? xf[kk][0] : 0u;
                  const uint32_t x1 = ih ? xf[kk][1] : 0u;
                  const uint32_t x2 = il ? xf[kk][2] : 0u;
                  const uint32_t x3 = ih ? xf[kk][3] : 0u;
                  gk::mma_bf16(acc[t][2 * jp], x0, x1, x2, x3, bf[kk][0],
                               bf[kk][1]);
                  if (jp * 16 + 8 < p.r) {
                    gk::mma_bf16(acc[t][2 * jp + 1], x0, x1, x2, x3,
                                 bf[kk][2], bf[kk][3]);
                  }
                }
              }
            }
          }
        }
        continue;
      }
      for (int kk = kw; kk < CHUNK / 16; kk += WK) {
        uint32_t a0, a1, a2, a3;
        gk::ldmatrix_x4(st + swz(rg * 16 + (lane & 15), 2 * kk + (lane >> 4)),
                        a0, a1, a2, a3);
        for (int b = 0; b < nb; ++b) {
          // rows of other slots enter as zeros, which add exactly nothing
          const unsigned long long m = c_mask[i0 + b];
          const bool il = (m >> lr) & 1, ih = (m >> (lr + 8)) & 1;
          if (!__any_sync(FULL, il || ih)) continue;
          const uint32_t x0 = il ? a0 : 0u, x1 = ih ? a1 : 0u;
          const uint32_t x2 = il ? a2 : 0u, x3 = ih ? a3 : 0u;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
              if (jp * 16 < p.r) {
                const int row = (b * NT + t) * RB + jp * 16 + (lane & 7)
                                + ((lane >> 4) << 3);
                uint32_t b0, b1, b2, b3;
                gk::ldmatrix_x4(sa + swz(row, 2 * kk + ((lane >> 3) & 1)),
                                b0, b1, b2, b3);
                gk::mma_bf16(acc[t][2 * jp], x0, x1, x2, x3, b0, b1);
                if (jp * 16 + 8 < p.r) {
                  gk::mma_bf16(acc[t][2 * jp + 1], x0, x1, x2, x3, b2, b3);
                }
              }
            }
          }
        }
      }
    }
    gk::cp_async_wait<0>();
    __syncthreads();          // the ring is reloaded for the next batch
  }
  // d0, d1: row g, ranks 2q, 2q + 1 of the n8 tile; d2, d3: row g + 8
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = t * RB + j * 8 + 2 * q;
      *reinterpret_cast<float2*>(out + g * p.ZW + col) =
          make_float2(acc[t][j][0], acc[t][j][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * p.ZW + col) =
          make_float2(acc[t][j][2], acc[t][j][3]);
    }
}

// f32: a warp a row of z at a time (its group's rows, slot by slot), lanes
// over the warp's share of the CTA's chunks (every WK-th), a warp sum.
template <int RB, int NT>
__device__ __forceinline__ void cta_shrink(const Args& p, const float*,
                                           uint8_t*, float* out,
                                           const float**, int rows0,
                                           const int*, const int* c_slot,
                                           const unsigned long long* c_mask,
                                           int nd, int ps, int nst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = p.G, WK = 4 / G;
  const int rg = warp % G, kw = warp / G;
  const float* x = static_cast<const float*>(p.x);
  for (int i = 0; i < nd; ++i) {
    const int s = c_slot[i];
    for (unsigned m = (unsigned)(c_mask[i] >> (rg * 16)) & 0xFFFFu; m;
         m &= m - 1) {
      const int rr = __ffs(m) - 1;
      const float* xr = x + (size_t)(rows0 + rg * 16 + rr) * p.K;
#pragma unroll 1
      for (int t = 0; t < NT; ++t) {
        const float* a = static_cast<const float*>(p.a[t])
                         + (size_t)s * p.r * p.K;
        float acc[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) acc[j] = 0.f;
        for (int i = kw; i < nst; i += WK) {
          static_assert(CHUNK == 4 * 32, "a chunk is a float4 a lane");
          const int k = (ps + i * p.P) * CHUNK + lane * 4;
          if (k >= p.K) continue;
          const float4 xv = *reinterpret_cast<const float4*>(xr + k);
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            if (j < p.r) {
              const float4 av =
                  *reinterpret_cast<const float4*>(a + (size_t)j * p.K + k);
              acc[j] = fmaf(xv.x, av.x, acc[j]);
              acc[j] = fmaf(xv.y, av.y, acc[j]);
              acc[j] = fmaf(xv.z, av.z, acc[j]);
              acc[j] = fmaf(xv.w, av.w, acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          float v = acc[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(FULL, v, off);
          if (lane == 0) out[rr * p.ZW + t * RB + j] = v;
        }
      }
    }
  }
}

// Shared memory of a shrink CTA: the warps' [4][16][ZW] f32 sums, then
// (bf16) the ring of STAGES stages of x rows and A rows.
__host__ __device__ __forceinline__ size_t shrink_smem(bool ring, int G,
                                                       int SB, int NT, int RB) {
  const size_t red = sizeof(float) * 4 * 16 * NT * RB;
  return red + (ring ? (size_t)STAGES * (16 * G + SB * NT * RB) * ROWB : 0);
}

template <typename T, int RB, int NT>
__global__ void __launch_bounds__(THREADS) lora_shrink(const Args p) {
  extern __shared__ __align__(128) uint8_t sh_smem[];
  float* red = reinterpret_cast<float*>(sh_smem);
  uint8_t* ring = sh_smem + sizeof(float) * 4 * 16 * p.ZW;
  __shared__ int r_slot[64];
  __shared__ int c_slot[64];
  __shared__ unsigned long long c_mask[64];
  __shared__ const T* row_src[64 + MAX_STAGED * MAX_TARGETS * 64];
  __shared__ int c_n, s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.G, rows = 16 * G;
  // blockIdx.x: the split (neighbouring CTAs read neighbouring chunks of
  // the same rows), blockIdx.y: the row tile
  const int ps = blockIdx.x, tile = blockIdx.y;
  const int rows0 = tile * rows;
  // the expand may start now: its slots, y and B need nothing of this
  // kernel, and it waits for z (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the tile's rows' slots; a tile of base rows reads and writes nothing
  const int own = tid < rows ? row_slot(p, rows0 + tid) : -1;
  if (tid < rows) r_slot[tid] = own;
  if (!__syncthreads_or(own >= 0)) return;
  if (warp == 0) distinct_slots(r_slot, rows, c_slot, c_mask, &c_n);
  __syncthreads();
  const int nd = c_n;

  // the CTA's chunks of K: ps, ps + P, ps + 2P, ...
  const int C = (p.K + CHUNK - 1) / CHUNK;
  cta_shrink<RB, NT>(p, static_cast<const T*>(nullptr), ring,
                     red + (size_t)warp * 16 * p.ZW, row_src, rows0, r_slot,
                     c_slot, c_mask, nd, ps, (C - ps + p.P - 1) / p.P);
  __syncthreads();

  // the CTA's sum over its warps along K, in order; a warp a row at a
  // time, lanes over the row's columns
  T* z = static_cast<T*>(p.z);
  const int WK = 4 / G;
  for (int lr = warp; lr < rows; lr += 4) {
    if (r_slot[lr] < 0) continue;
    const int g = lr >> 4, rr = lr & 15;
    const size_t row = rows0 + lr;
    for (int col = lane; col < p.ZW; col += 32) {
      float v = 0.f;
      for (int k = 0; k < WK; ++k) {
        v += red[((k * G + g) * 16 + rr) * p.ZW + col];
      }
      if (p.P == 1) {
        z[row * p.ZW + col] = gk::from_f<T>(v);
      } else {
        p.part[((size_t)ps * p.T + row) * p.ZW + col] = v;
      }
    }
  }
  if (p.P == 1) return;

  // the last CTA of the row tile adds the P partials in order and rounds,
  // every partial of a value (decode), or of four (prefill), in flight
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.counters + tile, 1) == p.P - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t stride = (size_t)p.T * p.ZW;
  const int nk = p.P;                  // the partials, added in order
  const float* part = p.part + (size_t)rows0 * p.ZW;
  z += (size_t)rows0 * p.ZW;
  if (nk > 16) {
    for (int lr = warp; lr < rows; lr += 4) {
      if (r_slot[lr] < 0) continue;
      for (int col = lane; col < p.ZW; col += 32) {
        const float* src = part + lr * p.ZW + col;
        float t[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) {
          t[k] = k < nk ? __ldcg(src + k * stride) : 0.f;
        }
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < 64; ++k) {
          if (k < nk) v += t[k];
        }
        z[lr * p.ZW + col] = gk::from_f<T>(v);
      }
    }
  } else {
    for (int lr0 = warp; lr0 < rows; lr0 += 16) {
      for (int col = lane; col < p.ZW; col += 32) {
        float t[4][16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int lr = lr0 + 4 * u;
          const bool on = lr < rows && r_slot[lr] >= 0;
          const float* src = part + (on ? lr * p.ZW + col : 0);
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            t[u][k] = on && k < nk ? __ldcg(src + k * stride) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int lr = lr0 + 4 * u;
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            if (k < nk) v += t[u][k];
          }
          if (lr < rows && r_slot[lr] >= 0) {
            z[lr * p.ZW + col] = gk::from_f<T>(v);
          }
        }
      }
    }
  }
  if (tid == 0) p.counters[tile] = 0;
}

// --- expand ------------------------------------------------------------------

struct Tile {                 // what an expand CTA updates
  int t, c0;                  // target, first column
  const void* b;
  int O;                      // B_t's rows
  void* y;
  int Oy;                     // y's width (its row stride)
};

__device__ __forceinline__ Tile column_tile(const Args& p) {
  int t = 0;
  while (t + 1 < p.nt && (int)blockIdx.x >= p.tile0[t + 1]) ++t;
  Tile c;
  c.t = t;
  c.c0 = ((int)blockIdx.x - p.tile0[t]) * TILE_COLS;
  c.b = p.b[t];
  c.O = p.O[t];
  const int yt = t;           // the target whose y the tile updates
  c.y = p.y[yt];
  c.Oy = p.O[yt];
  return c;
}

// 8 consecutive bf16 of y plus the rounded updates u[0..8), rounded
__device__ __forceinline__ uint4 add8(uint4 yv, const float* u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&yv);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[i] = __floats2bfloat162_rn(
        f.x + __bfloat162float(__float2bfloat16(u[2 * i])),
        f.y + __bfloat162float(__float2bfloat16(u[2 * i + 1])));
  }
  return out;
}

// bf16: wgmma over the staged B tiles; KS = RB / 16 steps of 16 ranks
template <int KS>
__device__ __forceinline__ void expand_tile(
    const Args& p, const Tile& c, int row0, const int* r_slot,
    const int* d_slot, const unsigned long long* d_mask, int nd,
    uint8_t* bufs, int* staged, int& n_staged) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int lr = warp * 16 + g, hr = lr + 8;
  const bool tl = r_slot[lr] >= 0, th = r_slot[hr] >= 0;
  bf16* y = static_cast<bf16*>(c.y);
  const bf16* z = static_cast<const bf16*>(p.z) + c.t * p.RB;
  const bool vec = (c.Oy & 7) == 0;
  bf16* yl = y + (size_t)(row0 + lr) * c.Oy;
  bf16* yh = y + (size_t)(row0 + hr) * c.Oy;
  // y in flight while B is staged and the products run
  uint4 vl[4], vh[4];
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const int col = c.c0 + gi * 32 + 8 * q;
    const bool in = vec && col < c.Oy;
    vl[gi] = tl && in ? *reinterpret_cast<const uint4*>(yl + col)
                      : make_uint4(0, 0, 0, 0);
    vh[gi] = th && in ? *reinterpret_cast<const uint4*>(yh + col)
                      : make_uint4(0, 0, 0, 0);
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const bf16* B = static_cast<const bf16*>(c.b);
  for (int i0 = 0; i0 < nd; i0 += p.SB) {
    const int nb = min(p.SB, nd - i0);
    bool same = nb == n_staged;
    for (int b = 0; b < nb && same; ++b) same = staged[b] == d_slot[i0 + b];
    if (!same) {
      __syncthreads();        // every wgmma on the old tiles has completed
      constexpr int CH = 2 * KS;    // 16-byte chunks of a staged row
      for (int i = tid; i < nb * TILE_COLS * CH; i += THREADS) {
        const int b = i / (TILE_COLS * CH);
        const int rem = i - b * TILE_COLS * CH;
        const int n = rem / CH, ch = rem - n * CH;
        // staged row n holds column c0 + perm(n): thread q's accumulators
        // of n8 tiles 4gi..4gi+3 are then columns 32gi + 8q .. 8q + 7
        const int tt = n >> 3, w = n & 7;
        const int col = c.c0 + (tt >> 2) * 32 + (w >> 1) * 8 + (tt & 3) * 2
                        + (w & 1);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (col < c.O && ch * 8 < p.r) {
          v = ldg16(B + ((size_t)d_slot[i0 + b] * c.O + col) * p.r + ch * 8);
        }
        *reinterpret_cast<uint4*>(bufs + b * BUF_BYTES + n * 128
                                  + ((ch ^ (n & 7)) << 4)) = v;
      }
      fence_proxy_async();
      __syncthreads();
      for (int b = 0; b < nb; ++b) staged[b] = d_slot[i0 + b];
      n_staged = nb;
    }
    // the shrink has finished and its z is visible: the C call launches
    // this kernel while the shrink runs (programmatic stream
    // serialization), so y and B above are in flight meanwhile
    grid_dependency_wait();
    for (int b = 0; b < nb; ++b) {
      const unsigned long long m = d_mask[i0 + b];
      const bool il = (m >> lr) & 1, ih = (m >> hr) & 1;
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int col = kk * 16 + 2 * q;
        const bf16* zl = z + (size_t)(row0 + lr) * p.ZW + col;
        const bf16* zh = z + (size_t)(row0 + hr) * p.ZW + col;
        a[kk][0] = il ? *reinterpret_cast<const uint32_t*>(zl) : 0u;
        a[kk][1] = ih ? *reinterpret_cast<const uint32_t*>(zh) : 0u;
        a[kk][2] = il ? *reinterpret_cast<const uint32_t*>(zl + 8) : 0u;
        a[kk][3] = ih ? *reinterpret_cast<const uint32_t*>(zh + 8) : 0u;
      }
      const unsigned base = gk::smem_addr(bufs + b * BUF_BYTES);
      gk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        gk::wgmma_rs<TILE_COLS>(d, a[kk], gk::wgmma_desc_sw128(base + kk * 32));
      }
      gk::wgmma_commit();
      gk::wgmma_wait<0>();
    }
  }
  // the epilogue: 8 columns of each of the thread's two rows a group
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const int col = c.c0 + gi * 32 + 8 * q;
    float ul[8], uh[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ul[e] = d[16 * gi + 4 * (e >> 1) + (e & 1)];
      uh[e] = d[16 * gi + 4 * (e >> 1) + 2 + (e & 1)];
    }
    if (vec) {
      if (col < c.Oy) {
        if (tl) *reinterpret_cast<uint4*>(yl + col) = add8(vl[gi], ul);
        if (th) *reinterpret_cast<uint4*>(yh + col) = add8(vh[gi], uh);
      }
    } else {   // a width of partial vectors: element by element
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (col + e < c.Oy) {
          const float rl = __bfloat162float(__float2bfloat16(ul[e]));
          const float rh = __bfloat162float(__float2bfloat16(uh[e]));
          if (tl) yl[col + e] = __float2bfloat16(__bfloat162float(yl[col + e]) + rl);
          if (th) yh[col + e] = __float2bfloat16(__bfloat162float(yh[col + e]) + rh);
        }
      }
    }
  }
}

// f32: a thread a column, the tile's adapter rows in order
template <int RB>
__device__ __forceinline__ void expand_tile_f32(const Args& p, const Tile& c,
                                                int row0, const int* r_slot) {
  const int col = c.c0 + threadIdx.x;
  if (col >= c.O || col >= c.Oy) return;
  const float* B = static_cast<const float*>(c.b);
  const float* z = static_cast<const float*>(p.z) + c.t * p.RB;
  float* y = static_cast<float*>(c.y);
  grid_dependency_wait();     // the shrink's z (as in the bf16 tile)
  float bv[RB];
  int cur = -1;
  for (int i = 0; i < TILE_ROWS; ++i) {
    const int s = r_slot[i];
    if (s < 0) continue;
    if (s != cur) {
      const float* br = B + ((size_t)s * c.O + col) * p.r;
#pragma unroll
      for (int j = 0; j < RB; ++j) bv[j] = j < p.r ? br[j] : 0.f;
      cur = s;
    }
    const float* zr = z + (size_t)(row0 + i) * p.ZW;
    float u = 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (j < p.r) u = fmaf(zr[j], bv[j], u);
    }
    y[(size_t)(row0 + i) * c.Oy + col] += u;
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(THREADS) lora_expand(const Args p) {
  extern __shared__ uint8_t ex_smem[];
  __shared__ int r_slot[TILE_ROWS];
  __shared__ int d_slot[TILE_ROWS];
  __shared__ unsigned long long d_mask[TILE_ROWS];
  __shared__ int d_n;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Tile c = column_tile(p);
  // staged tiles start on a 1,024-byte boundary (the swizzle's atom)
  uint8_t* bufs = ex_smem + ((1024 - (gk::smem_addr(ex_smem) & 1023)) & 1023);
  int staged[4] = {-1, -1, -1, -1};
  int n_staged = 0;
  const int tiles = (p.T + TILE_ROWS - 1) / TILE_ROWS;
  const int tb = blockIdx.y * p.RT, te = min(tiles, tb + p.RT);
  // a CTA whose rows are all base rows leaves at once
  bool any = false;
  for (int row = tb * TILE_ROWS + tid; row < min(p.T, te * TILE_ROWS);
       row += THREADS) {
    any |= row_slot(p, row) >= 0;
  }
  if (!__syncthreads_or(any)) return;
  for (int tile = tb; tile < te; ++tile) {
    const int row0 = tile * TILE_ROWS;
    if (tid < TILE_ROWS) r_slot[tid] = row_slot(p, row0 + tid);
    __syncthreads();
    if (warp == 0) distinct_slots(r_slot, TILE_ROWS, d_slot, d_mask, &d_n);
    __syncthreads();
    const int nd = d_n;
    if (nd > 0) {
      if constexpr (std::is_same<T, bf16>::value) {
        expand_tile<RB / 16>(p, c, row0, r_slot, d_slot, d_mask, nd, bufs,
                             staged, n_staged);
      } else {
        expand_tile_f32<RB>(p, c, row0, r_slot);
      }
    }
    __syncthreads();          // r_slot and d_* are rewritten next tile
  }
}

bool g_smem_set[2][2][4][3];  // [kernel][dtype][RB / 16 - 1][nt - 1]

template <typename T, int RB, int NT>
int launch(const Args& p, cudaStream_t st) {
  const int dt = std::is_same<T, bf16>::value;
  const int shrink_rows = 16 * p.G;
  const dim3 g1(p.P, (p.T + shrink_rows - 1) / shrink_rows);
  const size_t smem1 = shrink_smem(dt, p.G, p.SB, NT, RB);
  const dim3 g2(p.tile0[p.nt],
                ((p.T + TILE_ROWS - 1) / TILE_ROWS + p.RT - 1) / p.RT);
  const size_t smem2 = dt ? (size_t)p.SB * BUF_BYTES + 1024 : 0;
  if (!g_smem_set[0][dt][RB / 16 - 1][NT - 1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_shrink<T, RB, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[0][dt][RB / 16 - 1][NT - 1] = true;
  }
  if (!g_smem_set[1][dt][RB / 16 - 1][0]) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_expand<T, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * BUF_BYTES + 1024);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[1][dt][RB / 16 - 1][0] = true;
  }
  lora_shrink<T, RB, NT><<<g1, THREADS, smem1, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the expand launches while the shrink runs and waits for its z
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = g2;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lora_expand<T, RB>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int RB>
int launch_nt(const Args& p, cudaStream_t st) {
  switch (p.nt) {
    case 1: return launch<T, RB, 1>(p, st);
    case 2: return launch<T, RB, 2>(p, st);
    case 3: return launch<T, RB, 3>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_rb(const Args& p, cudaStream_t st) {
  switch (p.RB) {
    case 16: return launch_nt<T, 16>(p, st);
    case 32: return launch_nt<T, 32>(p, st);
    case 48: return launch_nt<T, 48>(p, st);
    case 64: return launch_nt<T, 64>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of the scratch a call needs (ws; ops/cuda/lora.py scratch_bytes):
// z (T, ZW) of the working type, then, when P > 1, the (P, T, ZW) f32
// partials, 256-byte aligned.
static size_t scratch_bytes(int dtype, int nt, int r, int T, int P,
                            size_t* part_off) {
  const size_t zw = (size_t)nt * ((r + 15) / 16 * 16);
  const size_t zb = ((size_t)T * zw * (dtype == 0 ? 4 : 2) + 255) / 256 * 256;
  *part_off = zb;
  return zb + (P > 1 ? (size_t)P * T * zw * 4 : 0);
}

// One call a group: g the resident group, x (T, K), slots (T / S,) int32
// or null, y0..y2 the targets' outputs (nt of them), ws the scratch
// (scratch_bytes), counters ceil(T / 16G) int32 zeros (left zero),
// P, G, RT, SB the plan (ops/cuda/lora.py lora_plan). The wrapper checks
// shapes, types and alignment. Returns a CUDA error code, 0 on success.
extern "C" int gk_lora_group(const void* group, const void* x,
                             const void* slots, void* y0, void* y1, void* y2,
                             int T, int S, void* ws, void* counters, int P,
                             int G, int RT, int SB, void* stream) {
  const Group& g = *static_cast<const Group*>(group);
  const int vn = g.dtype == 0 ? 4 : 8;
  if (T <= 0 || S <= 0 || g.nt < 1 || g.nt > MAX_TARGETS || g.r <= 0
      || g.r > 64 || g.r % vn || g.K <= 0 || g.K % vn || P < 1 || RT < 1
      || SB < 1 || SB > MAX_STAGED || (G != 1 && G != 2 && G != 4)
      || shrink_smem(g.dtype == 1, G, SB, g.nt, (g.r + 15) / 16 * 16)
             > (size_t)MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  Args p;
  p.x = x;
  p.slots = static_cast<const int*>(slots);
  void* ys[MAX_TARGETS] = {y0, y1, y2};
  p.tile0[0] = 0;
  for (int t = 0; t < MAX_TARGETS; ++t) {
    const bool on = t < g.nt;
    p.y[t] = on ? ys[t] : nullptr;
    p.a[t] = on ? g.a[t] : nullptr;
    p.b[t] = on ? g.b[t] : nullptr;
    p.O[t] = on ? g.O[t] : 0;
    if (on && (g.O[t] <= 0 || ys[t] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    p.tile0[t + 1] = p.tile0[t] + (p.O[t] + TILE_COLS - 1) / TILE_COLS;
  }
  p.nt = g.nt;
  p.T = T;
  p.K = g.K;
  p.S = S;
  p.r = g.r;
  p.RB = (g.r + 15) / 16 * 16;
  p.ZW = g.nt * p.RB;
  p.P = P;
  p.G = G;
  p.RT = RT;
  p.SB = SB;
  size_t part_off;
  scratch_bytes(g.dtype, g.nt, g.r, T, P, &part_off);
  p.z = ws;
  p.part = reinterpret_cast<float*>(static_cast<char*>(ws) + part_off);
  p.counters = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g.dtype == 0 ? launch_rb<float>(p, st) : launch_rb<bf16>(p, st);
}
