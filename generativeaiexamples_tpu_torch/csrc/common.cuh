// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel loads its operands in the storage type (bf16 or f32, or
// int8 for a quantized KV pool), computes in f32 and stores in the
// activation type. The C entry points take a dtype code and the head dim
// at run time and dispatch to one template instance each; anything else
// returns cudaErrorInvalidValue, which the Python wrapper turns into an
// exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gk {

constexpr float NEG_INF = -1e30f;   // the JAX kernels' finite mask value

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// The split-KV walk of the two decode-side kernels (ragged_paged.cu over
// the paged pool, ragged_decode.cu over the dense cache); each .cu keeps
// only its address resolution (`locate`) and its launch.
//
// What bounds it on the H100: decode does about one multiply-add per K/V
// byte, far below the ~295 operations per byte at which the tensor cores
// and not device memory become the limit, so the aim is to keep enough
// bytes in flight on every SM:
//
// * Split the walk (flash-decoding). The grid is (rows, KV heads, S); block
//   s walks tiles [s*tiles, (s+1)*tiles) of its row, clamped to the row's
//   length. The wrapper picks S and `tiles` from shapes only (split_plan in
//   ops/cuda/attention.py: at least 2 x 132 blocks, at most SPLIT_MAX splits,
//   S = 1 where one tile covers the capacity), so a launch never reads a
//   length back to the host. With S > 1 each block writes its unnormalised
//   partial (m, l, acc) to the wrapper's scratch, takes a ticket from a
//   per-(row, head) counter, and the last block to arrive combines the S
//   partials and resets the counter to 0: one launch per call. A split that
//   saw no live key for a query (it lies past the row's length, or past
//   that query's causal limit) contributes exactly nothing: only partials
//   whose m is above NEG_INF/2 are rescaled and summed, and a query no
//   split saw comes out 0, finite.
// * Async-copy the tiles. K/V tiles of BT tokens are staged in shared
//   memory in the pool's storage type (bf16, f32, or int8, half the
//   bytes) by 16-byte cp.async copies into a ring of NS stages (3, or 2
//   for f32), so the next tiles are in flight while one is scored. Each
//   token's row offset (and int8 scale slot) is resolved once per tile, one
//   tile ahead of its copy, into a two-slot table. One barrier per tile.
// * Tensor cores for bf16 activations (both pools): mma.sync m16n8k16,
//   bf16 inputs, f32 accumulation. Warp w takes 16-row m-tile w % MT of the
//   QG = Qb*G query vectors (padded to QGB = 16*MT) and 16-token group
//   w / MT of every tile, and keeps its own m/l/acc in registers: the
//   softmax runs in f32 with quad shuffles and needs no barrier; the 4
//   token groups merge through shared memory at the end of the split. Q
//   and K are exact in bf16 (int8 K/V elements become bf16 in registers,
//   exact for -127..127). P enters P.V as two bf16 terms, its nearest bf16
//   value and the remainder, so it carries 16 significant bits: with P
//   rounded once to bf16, as flash kernels do, chip_smoke.py's kernel
//   phases read 0.93 to 1.0 of their one-ulp limit on the H100, and the
//   second product costs 16 mma.sync per warp and tile on a walk bound by
//   bytes.
//   wgmma is not used: decode has QG <= 64 rows and is bound by bytes, not
//   by the tensor-core rate.
// * f32 activations keep f32 FMAs for both products (the card's parity
//   phase runs f32, and TF32 would change its greedy streams) with the
//   same split and copy pipeline: one thread per (query, token) scores,
//   one warp per query row runs the softmax, one thread per (query, dim)
//   accumulates P.V.
//
// Registers and spills per instance (`-Xptxas -v`, in the build log beside
// each library and in chip_smoke.py's build phase): at HD = 128, 125 to 128
// registers for bf16 activations and 96 to 123 for f32, no spills; spills
// only at HD <= 64 (76 bytes at most), off the serving shapes.
//
// HD = 256 (the Gemma family): a bf16 warp's output rows are 16 x 256 f32,
// 128 registers, so a block holds at most 32 query vectors (qg_cap: the
// 16- and 32-row buckets, 128 and 256 threads, up to 255 registers a
// thread), and rows of more are cut into query tiles by the wrapper
// (query_tile in ops/cuda/attention.py). The bf16 ring of 3 stages of 64
// tokens is 202,752 bytes, one block an SM. Two stages of 64 f32 K/V rows
// would take 266,240 bytes, so the f32 walk stages 32 tokens a step (ST):
// a split's 64-token tiles are walked as two steps each.
//
// The int8 elements are never dequantized, as in the TPU kernel: scores are
// (q.k)*scale*k_s, probabilities are multiplied by v_s before P.V, and the
// denominator sums the unscaled probabilities.
// ---------------------------------------------------------------------------

constexpr int BT = 64;          // tokens per tile of the split plan
constexpr int QG_MAX = 64;      // query vectors (G * Qb) per block, at most
constexpr int SPLIT_MAX = 32;   // splits per (row, KV head), at most
constexpr size_t SMEM_OPTIN = 232448;   // the H100's per-block opt-in limit

// query vectors a block holds at head dim HD (QG_MAX, or 32 at HD = 256,
// where a bf16 warp's output rows take 128 registers)
template <int HD>
__host__ __device__ constexpr int qg_cap() {
  return HD <= 128 ? QG_MAX : 32;
}

template <typename KT>
__host__ __device__ constexpr bool is_quant() {
  return sizeof(KT) == 1;
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// The static shape of one instance: activation type T, pool type KT, head
// dim HD, query-row bucket QGB (16, 32 or 64 rows).
template <typename T, typename KT, int HD, int QGB>
struct Walk {
  static constexpr bool QUANT = is_quant<KT>();
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr int MT = QGB / 16;           // 16-row m-tiles
  static constexpr int RT = 128 * MT;           // threads
  static constexpr int NTG = MMA ? 4 : 1;       // token groups, merged at end
  static constexpr int NS = sizeof(KT) == 4 ? 2 : 3;   // ring stages
  // tokens staged a step: the split tile, or half of it for f32 rows at
  // HD = 256 (two stages of 64 would not fit)
  static constexpr int ST = sizeof(KT) == 4 && HD > 128 ? BT / 2 : BT;
  static_assert(!MMA || ST == BT, "the tensor-core walk takes 64 tokens");
  static constexpr int VEC = 16 / sizeof(KT);   // elements per 16-byte copy
  static constexpr int CPR = HD / VEC;          // 16-byte copies per token row
  static constexpr int LDK = HD + VEC;          // staged row: 16 bytes of pad
  static constexpr int LDQ = MMA ? HD + 8 : HD + 1;
  static constexpr int LDA = HD + 4;            // merge rows (f32)
  // shared memory: [query block][offset tables][ring | merge | combine]
  static constexpr size_t Q_BYTES =
      MMA ? round16(sizeof(__nv_bfloat16) * QGB * LDQ)
          : round16(sizeof(float) * (QGB * LDQ + QGB * ST + 3 * QGB));
  static constexpr size_t OFF_BYTES = sizeof(long long) * 4 * ST;
  static constexpr size_t STAGE_ELEMS = 2 * ST * LDK;  // K then V
  static constexpr size_t RING_BYTES =
      round16(sizeof(KT) * NS * STAGE_ELEMS) +
      (QUANT ? sizeof(float) * NS * 2 * ST : 0);
  static constexpr size_t MERGE_BYTES =
      sizeof(float) * NTG * QGB * (LDA + 2);
  static constexpr size_t COMBINE_BYTES = sizeof(float) * 3 * SPLIT_MAX * QGB;
  static constexpr size_t SMEM =
      Q_BYTES + OFF_BYTES +
      cmax(RING_BYTES, cmax(MERGE_BYTES, COMBINE_BYTES));
  static_assert(QGB <= qg_cap<HD>() && SMEM + 16 <= SMEM_OPTIN,
                "an instance past the head dim's bucket or the card's "
                "shared memory");
};

// --- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; copies nothing and zero-fills when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// four 8x8 bf16 matrices, transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) as two bf16 pairs whose sum carries 16 significant bits: the
// nearest bf16 pair and the bf16 pair of the remainder
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& head,
                                           uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(h);
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = pack_bf16(lo - f.x, hi - f.y);
}

// two consecutive staged elements of a row as a bf16 pair (k, k+1)
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  return pack_bf16((float)p[0], (float)p[1]);
}

// Fold a partial (m, l, a) into a running one. A partial whose m is at
// NEG_INF saw no live key and contributes nothing.
__device__ __forceinline__ void merge_partial(float& M, float& L, float& A,
                                              float m, float l, float a) {
  if (m <= 0.5f * NEG_INF) return;
  const float mn = fmaxf(M, m);
  const float x = expf(M - mn), y = expf(m - mn);
  M = mn;
  L = L * x + l * y;
  A = A * x + a * y;
}

// q, out: this block's (row, KV head) slice of a contiguous (rows, Qb, H,
// HD) tensor starting at element `base`; block row j = qi*G + g is head
// kvh*G + g of query qi. Query qi sees tokens pos < len with pos <= pos0 +
// qi, and only while qi < n_q (slots past n_q come out finite garbage).
// `locate(pos, sc)` returns the element offset of token pos's K/V row of
// this head from k and v and, for an int8 pool, sets its scale slot `sc`
// in k_scales/v_scales. Grid (rows, cells, S), a cell one KV head or, for
// the ragged kernel's rows of more than QG_MAX query vectors, one (KV head,
// query tile): blockIdx (x, y) names the cell, and a tile is a row of its
// own here (its q/out slice at `base`, its Qb, pos0 and n_q). With S > 1,
// `part` holds (m, l, acc) of every (cell, split), `qgs` query vectors a
// (cell, split) apart (a full tile's), so a combine never mixes two cells,
// and `tickets` one counter per cell, zero between launches.
template <typename T, typename KT, int HD, int QGB, typename Locate>
__device__ __forceinline__ void attend_tiles(
    const T* __restrict__ q, T* __restrict__ out, long long base,
    const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    int len, int pos0, int n_q, int Qb, int G, int H, int kvh, float scale,
    int tiles, int qgs, float* __restrict__ part, int* __restrict__ tickets,
    const Locate& locate) {
  using W = Walk<T, KT, HD, QGB>;
  constexpr bool QUANT = W::QUANT;
  constexpr int RT = W::RT, NS = W::NS, NTG = W::NTG;
  constexpr int LDK = W::LDK, LDQ = W::LDQ, LDA = W::LDA;
  constexpr int ST = W::ST;   // tokens a step
  extern __shared__ __align__(16) unsigned char walk_smem[];
  __shared__ int last_s;
  long long* off_s = reinterpret_cast<long long*>(walk_smem + W::Q_BYTES);
  long long* sc_s = off_s + 2 * ST;
  unsigned char* uni = walk_smem + W::Q_BYTES + W::OFF_BYTES;
  KT* ring = reinterpret_cast<KT*>(uni);
  float* kscale_s = reinterpret_cast<float*>(
      uni + round16(sizeof(KT) * NS * W::STAGE_ELEMS));
  // after the walk the union holds the token groups' partials
  float* acc_w = reinterpret_cast<float*>(uni);
  float* m_w = acc_w + NTG * QGB * LDA;
  float* l_w = m_w + NTG * QGB;

  const int QG = Qb * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.z, split = blockIdx.z;
  const long long cell = (long long)blockIdx.x * gridDim.y + blockIdx.y;
  // `tiles` counts the plan's BT-token tiles; the walk steps ST tokens
  const int steps = tiles * (BT / ST);
  const int tb = split * steps;
  const int te = min(tb + steps, (len + ST - 1) / ST);
  const int n_t = te - tb;   // <= 0: the split lies past the row's length

  // --- the copy pipeline ---------------------------------------------------
  // tile x (x = 0..n_t-1 within the split) is resolved into slot x % 2 of
  // off_s/sc_s one step before its copies are issued into stage x % NS
  const auto resolve = [&](int x) {
    const int t0 = (tb + x) * ST;
    long long* off = off_s + (x & 1) * ST;
    long long* scs = sc_s + (x & 1) * ST;
    for (int t = tid; t < ST; t += RT) {
      const int pos = t0 + t;
      long long sc = 0;
      off[t] = pos < len ? locate(pos, sc) : -1;
      scs[t] = sc;
    }
  };
  const auto issue = [&](int x) {
    const long long* off = off_s + (x & 1) * ST;
    KT* kd = ring + (x % NS) * W::STAGE_ELEMS;
    KT* vd = kd + ST * LDK;
    for (int c = tid; c < ST * W::CPR; c += RT) {
      const int t = c / W::CPR, e = (c % W::CPR) * W::VEC;
      const long long o = off[t];
      const bool ok = o >= 0;
      cp_async16(kd + t * LDK + e, k + (ok ? o : 0) + e, ok);
      cp_async16(vd + t * LDK + e, v + (ok ? o : 0) + e, ok);
    }
    if constexpr (QUANT) {
      const long long* scs = sc_s + (x & 1) * ST;
      float* ks = kscale_s + (x % NS) * 2 * ST;
      for (int t = tid; t < ST; t += RT) {
        const bool ok = off[t] >= 0;
        cp_async4(ks + t, k_scales + (ok ? scs[t] : 0), ok);
        cp_async4(ks + ST + t, v_scales + (ok ? scs[t] : 0), ok);
      }
    }
  };

  // per-warp state of the tensor-core walk: m-tile mt, token group tg;
  // this lane holds rows jr0 = mt*16 + lane/4 and jr0 + 8
  const int mt = warp % W::MT, tg = warp / W::MT;
  const int gr = lane >> 2, c0 = (lane & 3) * 2;
  const int jr0 = mt * 16 + gr;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float acc[W::MMA ? HD / 8 : 1][4];
  // the f32 walk: one (query, dim) pair per thread and step of RT
  constexpr int NACC = W::MMA ? 1 : QGB * HD / RT;
  float facc[NACC];
  if constexpr (W::MMA) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < NACC; ++e) facc[e] = 0.f;
  }
  // last position each of this lane's rows may see (-1: none)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = (jr0 + 8 * h) / G;
    lim[h] = qi < n_q ? min(pos0 + qi, len - 1) : -1;
  }

  if (n_t > 0) {
    resolve(0);
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      __syncthreads();
      if (st < n_t) issue(st);
      if (st + 1 < n_t) resolve(st + 1);
      cp_async_commit();
    }
  }
  // --- this block's query vectors, while the first tiles are in flight --
  if constexpr (W::MMA) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(walk_smem);
    for (int idx = tid; idx < QGB * HD; idx += RT) {
      const int j = idx / HD, d = idx % HD;
      const int qi = j / G, g = j % G;
      q_s[j * LDQ + d] =
          j < QG ? q[base + ((long long)qi * H + kvh * G + g) * HD + d]
                 : __float2bfloat16(0.f);
    }
  } else {
    float* q_s = reinterpret_cast<float*>(walk_smem);
    float* m_s = q_s + QGB * LDQ + QGB * ST;
    float* l_s = m_s + QGB;
    for (int idx = tid; idx < QG * HD; idx += RT) {
      const int j = idx / HD, d = idx % HD;
      const int qi = j / G, g = j % G;
      q_s[j * LDQ + d] =
          to_f(q[base + ((long long)qi * H + kvh * G + g) * HD + d]);
    }
    for (int j = tid; j < QG; j += RT) {
      m_s[j] = NEG_INF;
      l_s[j] = 0.f;
    }
  }

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // tile i landed; tile i-1's stage is free
    {
      const int nx = i + NS - 1;
      if (nx < n_t) issue(nx);
      if (nx + 1 < n_t) resolve(nx + 1);
      cp_async_commit();
    }
    const int tile = tb + i;
    const int t0 = tile * ST;
    const KT* ks = ring + (i % NS) * W::STAGE_ELEMS;
    const KT* vs = ks + ST * LDK;
    const float* ksc = kscale_s + (i % NS) * 2 * ST;   // int8 pool only
    const float* vsc = ksc + ST;

    if constexpr (W::MMA) {
      // scores of 16 rows x 16 tokens: two n-tiles of 8 tokens
      const __nv_bfloat16* q_s =
          reinterpret_cast<const __nv_bfloat16*>(walk_smem);
      const int tok0 = tg * 16;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* qa = q_s + jr0 * LDQ + kk * 16 + c0;
        const uint32_t a0 = pair_bf16(qa), a1 = pair_bf16(qa + 8 * LDQ);
        const uint32_t a2 = pair_bf16(qa + 8), a3 = pair_bf16(qa + 8 * LDQ + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const KT* kb = ks + (tok0 + nt * 8 + gr) * LDK + kk * 16 + c0;
          mma_bf16(sc[nt], a0, a1, a2, a3, pair_bf16(kb), pair_bf16(kb + 8));
        }
      }
      // mask, scale and the online softmax, in registers; a quad of lanes
      // shares a row
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tok0 + nt * 8 + c0 + (e & 1);
          float s = sc[nt][e] * scale;
          if constexpr (QUANT) s *= ksc[t];   // q.(k*k_s) = (q.k)*k_s
          s = t0 + t <= lim[e >> 1] ? s : NEG_INF;
          sc[nt][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        alpha[h] = expf(m_r[h] - m_new);
        m_r[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
      uint32_t pa[4], pl[4];   // P = pa + pl, two bf16 terms
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(sc[nt][e] - m_r[e >> 1]);
          sum[e >> 1] += p[e];
          // sum_t p_t (v_t*v_s_t) = (p*v_s) @ v: row-scale p, not V
          if constexpr (QUANT) p[e] *= vsc[tok0 + nt * 8 + c0 + (e & 1)];
        }
        split_bf16(p[0], p[1], pa[2 * nt], pl[2 * nt]);           // row gr
        split_bf16(p[2], p[3], pa[2 * nt + 1], pl[2 * nt + 1]);   // gr + 8
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_r[h] = alpha[h] * l_r[h] + sum[h];
      }
      // P.V: A = P (16 rows x 16 tokens), B = V (16 tokens x 8 dims), as
      // two products, P's leading bf16 term and its remainder
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t b[4];
        if constexpr (QUANT) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int8_t* vb = reinterpret_cast<const int8_t*>(vs) +
                               (tok0 + c0) * LDK + (n + h) * 8 + gr;
            b[2 * h] = pack_bf16((float)vb[0], (float)vb[LDK]);
            b[2 * h + 1] = pack_bf16((float)vb[8 * LDK], (float)vb[9 * LDK]);
          }
        } else {
          const KT* vb =
              vs + (tok0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK +
              n * 8 + (lane >> 4) * 8;
          ldmatrix_x4_trans(vb, b[0], b[1], b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* c = acc[n + h];
          c[0] *= alpha[0];
          c[1] *= alpha[0];
          c[2] *= alpha[1];
          c[3] *= alpha[1];
          mma_bf16(c, pa[0], pa[1], pa[2], pa[3], b[2 * h], b[2 * h + 1]);
          mma_bf16(c, pl[0], pl[1], pl[2], pl[3], b[2 * h], b[2 * h + 1]);
        }
      }
    } else {
      float* q_s = reinterpret_cast<float*>(walk_smem);
      float* s_s = q_s + QGB * LDQ;   // QG x ST scores, then probabilities
      float* m_s = s_s + QGB * ST;
      float* l_s = m_s + QGB;
      float* a_s = l_s + QGB;         // this tile's rescale factor per row
      for (int idx = tid; idx < QG * ST; idx += RT) {
        const int j = idx / ST, t = idx % ST;
        const float* qr = q_s + j * LDQ;
        const KT* kr = ks + t * LDK;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], to_f(kr[d]), dot);
        const int qi = j / G;
        const int pos = t0 + t;
        const bool ok = pos < len && pos <= pos0 + qi && qi < n_q;
        float s = dot * scale;
        if constexpr (QUANT) s *= ksc[t];
        s_s[j * ST + t] = ok ? s : NEG_INF;
      }
      __syncthreads();
      // online softmax, one warp per query row, ST / 32 tokens per lane
      constexpr int TPL = ST / 32;
      for (int j = warp; j < QG; j += RT / 32) {
        float* sr = s_s + j * ST;
        float sv[TPL];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < TPL; ++u) {
          sv[u] = sr[lane + 32 * u];
          mx = fmaxf(mx, sv[u]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[j];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < TPL; ++u) {
          const float p = expf(sv[u] - m_new);
          if constexpr (QUANT) {
            sr[lane + 32 * u] = p * vsc[lane + 32 * u];
          } else {
            sr[lane + 32 * u] = p;
          }
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          l_s[j] = alpha * l_s[j] + sum;
          m_s[j] = m_new;
          a_s[j] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        const int idx = tid + e * RT;
        if (idx < QG * HD) {
          const int j = idx / HD, d = idx % HD;
          const float* pr = s_s + j * ST;
          float sum = 0.f;
#pragma unroll 8
          for (int t = 0; t < ST; ++t)
            sum = fmaf(pr[t], to_f(vs[t * LDK + d]), sum);
          facc[e] = facc[e] * a_s[j] + sum;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the union takes the partials

  // --- this block's partial per token group, into shared memory ----------
  if (n_t <= 0) {
    for (int j = tid; j < NTG * QGB; j += RT) {
      m_w[j] = NEG_INF;
      l_w[j] = 0.f;
    }
  } else if constexpr (W::MMA) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tg * QGB + jr0 + 8 * h;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc_w[row * LDA + n * 8 + c0] = acc[n][2 * h];
        acc_w[row * LDA + n * 8 + c0 + 1] = acc[n][2 * h + 1];
      }
      if ((lane & 3) == 0) {
        m_w[row] = m_r[h];
        l_w[row] = l_r[h];
      }
    }
  } else {
    const float* m_s =
        reinterpret_cast<const float*>(walk_smem) + QGB * LDQ + QGB * ST;
    const float* l_s = m_s + QGB;
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      const int idx = tid + e * RT;
      if (idx < QG * HD) acc_w[(idx / HD) * LDA + idx % HD] = facc[e];
    }
    for (int j = tid; j < QG; j += RT) {
      m_w[j] = m_s[j];
      l_w[j] = l_s[j];
    }
  }
  __syncthreads();

  // --- merge the token groups: the output (S == 1) or this split's partial
  const long long n_part = (long long)gridDim.x * gridDim.y * S * qgs;
  float* part_m = part;
  float* part_l = part + n_part;
  float* part_acc = part + 2 * n_part;
  const long long pbase = (cell * S + split) * qgs;
  for (int idx = tid; idx < QG * HD; idx += RT) {
    const int j = idx / HD, d = idx % HD;
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int g = 0; g < NTG; ++g)
      merge_partial(M, L, A, m_w[g * QGB + j], l_w[g * QGB + j],
                    acc_w[(g * QGB + j) * LDA + d]);
    if (S == 1) {
      const int qi = j / G, g = j % G;
      out[base + ((long long)qi * H + kvh * G + g) * HD + d] =
          from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(pbase + j) * HD + d] = A;
      if (d == 0) {
        part_m[pbase + j] = M;
        part_l[pbase + j] = L;
      }
    }
  }
  if (S == 1) return;

  // --- the last block of this (row, head) to finish combines the splits --
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(tickets + cell, 1) == S - 1;
    if (last_s) tickets[cell] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int n_split = S;   // the combine reads every split
  const long long cbase = cell * S * qgs;
  float* ms_s = reinterpret_cast<float*>(uni);   // split x row: m, l, weight
  float* ls_s = ms_s + SPLIT_MAX * QGB;
  float* ws_s = ls_s + SPLIT_MAX * QGB;
  for (int i = tid; i < n_split * QG; i += RT) {
    const int sp = i / QG, j = i % QG;
    ms_s[sp * QGB + j] = __ldcg(part_m + cbase + (long long)sp * qgs + j);
    ls_s[sp * QGB + j] = __ldcg(part_l + cbase + (long long)sp * qgs + j);
  }
  __syncthreads();
  for (int j = tid; j < QG; j += RT) {
    float M = NEG_INF, L = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = ms_s[sp * QGB + j];
      if (ms <= 0.5f * NEG_INF) continue;
      const float mn = fmaxf(M, ms);
      L = L * expf(M - mn) + ls_s[sp * QGB + j] * expf(ms - mn);
      M = mn;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = ms_s[sp * QGB + j];
      ws_s[sp * QGB + j] = ms > 0.5f * NEG_INF ? expf(ms - M) * inv : 0.f;
    }
  }
  __syncthreads();
  // every split wrote its acc (0 where it saw no live key): the loads are
  // independent of the weights and stay in flight together
  for (int idx = tid; idx < QG * HD; idx += RT) {
    const int j = idx / HD, d = idx % HD;
    const float* pa = part_acc + (cbase + j) * HD + d;
    float A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp)
      A = fmaf(ws_s[sp * QGB + j], __ldcg(pa + (long long)sp * qgs * HD), A);
    const int qi = j / G, g = j % G;
    out[base + ((long long)qi * H + kvh * G + g) * HD + d] = from_f<T>(A);
  }
}


// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA, clusters and wgmma (the W8A16 GEMM's ring)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the cluster and the async
// proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// arrive, with release at cluster scope, on the barrier at the same offset
// in the shared memory of cluster rank `rank`
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    unsigned rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// the same, acquiring at cluster scope what other CTAs released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at (c0, c1) (innermost first) into `dst`,
// completing `bytes` on `bar`; `map` is a __grid_constant__ CUtensorMap
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster (also a barrier of the CTA)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// 16 bytes at the same offset as `p` in the shared memory of cluster rank
// `rank` (distributed shared memory)
__device__ __forceinline__ float4 ld_cluster_f4(const void* p, unsigned rank) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [ra];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(smem_addr(p)), "r"(rank)
      : "memory");
  return v;
}

// named barrier `id` over `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 tile landed by TMA with
// the 128-byte swizzle: rows of 128 bytes, 8-row atoms 1,024 bytes apart
// (the stride byte offset), layout type 1 (128-byte swizzle); the leading
// byte offset is unused for this layout. `saddr` is a shared address; a
// 16-deep step inside the atom adds 32 bytes.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(unsigned saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N, f32, the warpgroup's accumulator fragment) += A (64 x 16 bf16,
// from registers: a[0..3] of this thread, the mma.sync m16n8k16 A layout
// per warp, warp w of the warpgroup holding rows 16w..16w+15) x B (16 x N
// bf16 from the shared-memory descriptor, K-major). Asynchronous: fence
// before, commit and wait after.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace gk
