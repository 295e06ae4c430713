// One sampling call of the serving engine in one launch: for row (b, w) of
// (B * W, V) logits (float32 or bfloat16, upcast in registers as .float()
// does), slot b's live settings, the row's threefry key, the top-k / top-p
// cutoffs, the draw and the chosen token's logprob.
//
//   key      fold_in(keys[b], counter0[b] + w): threefry2x32 of the slot's
//            raw key over the counter (0, (counter0[b] + w) mod 2**32);
//   settings an inactive slot reads as greedy (temperature 0, no filters),
//            as the reference's live_* selects do;
//   scaled   s = lf / t (an IEEE division) for a sampled row (t > 0);
//   cutoffs  the reference's _mask_dynamic step for step: m = max s,
//            lo0 = max(min s, m - 100) - 1; top-k: 26 bisection rounds of
//            the count of s >= mid against k; e = exp(s - m) where
//            s >= thr_k (else 0), z = sum e, target = clip(top_p) * z;
//            top-p: 26 rounds of the mass of e where s >= mid against the
//            target; cut = min(max(thr_k, thr_p), m); a row with neither
//            filter keeps every entry. mid = 0.5 * (lo + hi) in round-to-
//            nearest intrinsics, so nothing is contracted into an FMA;
//   draw     the first-index argmax of s + gumbel over the surviving
//            entries, gumbel as jax.random.gumbel's "low" mode over the
//            row key's partitionable bits (x0, x1) = threefry2x32(key,
//            (0, i)), bits = x0 ^ x1, u = max(tiny, (float(bits >> 9 |
//            0x3F800000) - 1) * (1 - tiny) + tiny), g = -logf(-logf(u));
//            a greedy row takes the first-index argmax of lf; a row of
//            -inf gives index 0;
//   logprob lf[token] - logsumexp(lf), the raw logits' log-probability.
//
// Three options, each off (a null pointer) on the common path, where the
// launch is the instance without them:
//   allowed  an (R, ceil(V / 32)) bitmask (grammar_mask.cu): an entry
//            whose bit is 0 reads as s = -inf in every pass of the draw
//            (the greedy argmax, min and max of s, both bisections and the
//            Gumbel draw), exactly as the reference's grammar_mask sets
//            its logit to -inf before the sampler; the logsumexp of the
//            logprob and the top rows still read the raw row. With the
//            rows' grammar states beside it (mask_states), a row whose
//            state is <= 0 is unconstrained: it skips the mask test (a
//            branch uniform over its blocks) and never reads its words,
//            which grammar_mask.cu leaves unwritten;
//   advance  the reference's grammar_advance as an epilogue: the thread
//            that writes a slot's token at w = 0 walks that token's bytes
//            (tok_bytes, tok_lens) through the flat DFA table from the
//            slot's state and writes the next state, for an active slot
//            whose state is > 0; every other slot keeps its state;
//   top      the TOP largest raw entries of each row and value - lse, the
//            reference's jax.lax.top_k(raw, 5) rows (ties to the lower
//            index): each thread keeps the top TOP of its entries as
//            packed words in registers, the block's top TOP is taken in
//            TOP rounds of a block-wide max, and rank 0 merges the
//            cluster's blocks over distributed shared memory.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// generativeaiexamples_tpu/ops/sampling.py sample_logits_per_slot (full
// path: _mask_dynamic and jax.random.categorical under jax.vmap) plus
// token_logprob, with the engine's vmap(fold_in) of the slot keys. Its
// plain version is ops/sampling.py sample_slots_plain.
//
// What bounds it on the H100: reading the logits once (R x V x 4 or 2
// bytes: 37 MB at R = 72 f32, ~11 us) against the 32-bit work on chip: 26
// count levels and 26 mass levels over every entry of a filtered row, and
// ~88 operations of threefry and Gumbel for each entry that can still win
// the draw. Entries below the cut are masked, and so are entries more than
// 21 nats (plus a relative margin) below the row maximum: a Gumbel term
// lies in [-4.47, 15.95], so such an entry never beats the maximum. A top-p
// 0.7 row of a language model then hashes a few hundred entries, not
// 128,256. In practice neither bound is reached: each bisection round ends
// in a cluster barrier, and the rounds' latency sets the time.
//
// Design: one thread-block cluster of CL = 8 blocks per row. Each block
// loads its slice of the row once, with 16-byte loads, into shared memory
// as the scaled float32 row; every later pass reads shared memory (a
// top-p row's e = exp(s - max) is recomputed from s in each round, the
// same expf of the same value each time). A pass leaves each block with
// partials (int32 counts, float32 masses, a 64-bit packed argmax),
// reduced over the block's warps by shuffles; they go to double-buffered slots in the
// block's shared memory, one cluster barrier follows, and every thread of
// every block adds the CL slots over distributed shared memory in rank
// order. So every block takes the same bisection decision, with no global
// scratch, no atomics and no second launch. A round decides LEVELS = 2
// levels of the bisection: it tests the next midpoint and both midpoints
// that could follow it in one pass and one barrier, then takes the path
// the sequential bisection takes, so the cutoffs are the sequential ones
// bit for bit with 13 barriers a filter instead of 26. A thread adds its
// entries in one order whatever the midpoint, so a mass depends only on
// the set of entries it takes, and a cutoff moves only where a round's
// mass lies within rounding of the target. Greedy rows, and the passes a
// row's settings skip, cost nothing beyond the load pass.
//
// Choices, measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
// sampler inputs, bf16, V = 128,256, ms a call): 1 / 2 / 3 levels a round
// at R = 8 rows 0.108 / 0.0866 / 0.1007 (CL = 8); CL = 8 against 16 with 2
// levels at R = 8, 40, 72, 136: 0.0866 / 0.0974, 0.1388 / 0.1492, 0.2478
// / 0.2404, 0.5106 / 0.5042 (those with e stored beside s). Shared
// memory a block: 4 x ceil(V / 8) bytes, 64,128 for V = 128,256 and
// 128,000 for Gemma's V = 256,000. e stored beside s (8 bytes an entry,
// one block an SM at V = 128,256, and past the opt-in limit at 256,000)
// against e recomputed, at R = 72 / 8 / 40 of V = 128,256: 0.2475 /
// 0.0873 / 0.1389 against 0.1920 / 0.0971 / 0.1302. Registers: 64 a
// thread, no spills (-Xptxas -v; chip_smoke.py's build phase reports
// them).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CL = 8;          // blocks a row's cluster holds
constexpr int WARPS = THREADS / 32;
constexpr int N_BISECT = 26;
constexpr int LEVELS = 2;      // bisection levels one round decides
constexpr int MAX_MIDS = (1 << LEVELS) - 1;
constexpr int UNROLL = 4;      // 16-byte loads in flight a thread
constexpr int TOP = 5;         // top-logprob entries a row (TOP_LP)
constexpr size_t SMEM_OPTIN = 232448;    // the H100's per-block limit
constexpr size_t STATIC_SMEM = 1024;     // the kernel's own, rounded up
// a top word's index field: the complement, so that of two equal values
// the lower index is the larger word (jax.lax.top_k's order of ties)
constexpr bool kTopLowFirst = true;

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

// (value, index) packed so that the larger word is the larger value at the
// smaller index; 0 lies below every float's word.
__device__ __forceinline__ unsigned long long pack(float v, int i) {
  return ((unsigned long long)ordered(v) << 32) | (0xFFFFFFFFu - (uint32_t)i);
}

__device__ __forceinline__ int unpack(unsigned long long w) {
  return (int)(0xFFFFFFFFu - (uint32_t)(w & 0xFFFFFFFFull));
}

// the words of the top rows: (value, index) as pack, ties by kTopLowFirst
__device__ __forceinline__ unsigned long long top_word(float v, int i) {
  const uint32_t ix = kTopLowFirst ? 0xFFFFFFFFu - (uint32_t)i : (uint32_t)i;
  return ((unsigned long long)ordered(v) << 32) | ix;
}

__device__ __forceinline__ int top_index(unsigned long long w) {
  const uint32_t ix = (uint32_t)(w & 0xFFFFFFFFull);
  return (int)(kTopLowFirst ? 0xFFFFFFFFu - ix : ix);
}

// a word into a thread's descending top list
__device__ __forceinline__ void top_insert(unsigned long long (&t)[TOP],
                                           unsigned long long w) {
  if (w <= t[TOP - 1]) return;
  t[TOP - 1] = w;
#pragma unroll
  for (int q = TOP - 1; q > 0; --q) {
    if (t[q] > t[q - 1]) {
      const unsigned long long x = t[q];
      t[q] = t[q - 1];
      t[q - 1] = x;
    }
  }
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float tiny = 1.17549435e-38f;     // FLT_MIN, jnp.finfo(f32).tiny
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
  return -logf(-logf(u));
}

// one logit as float32: T is float, or uint16_t holding bfloat16 bits
template <typename T>
__device__ __forceinline__ float load1(const T* p, long long j) {
  if constexpr (sizeof(T) == 2) {
    return __uint_as_float((uint32_t)p[j] << 16);
  } else {
    return p[j];
  }
}

// a running logsumexp (max, sum of exp(x - max)) absorbing another
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
  } else if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

struct Args {
  const void* logits;
  long long row_stride;         // elements between rows
  int R, V, W, n;               // rows, vocabulary, rows a slot, slice
  const long long* keys;        // (B, 2) uint32 words
  const void* counter0;         // (B,) int32, or int64 when ctr64
  int ctr64;
  const float* temperature;     // (B,)
  const int* top_k;             // (B,)
  const float* top_p;           // (B,)
  const unsigned char* active;  // (B,) bool
  int* tokens;                  // (R,)
  float* logprobs;              // (R,)
  float* cutoffs;               // (R, 3) thr_k, thr_p, cut, or null
  const unsigned int* allowed;  // (R, words) bitmask, or null
  const int* mask_states;       // (R,) with allowed: rows <= 0 skip it
  int words;
  const int* gram_state;        // (B,) flat DFA state, or null (no advance)
  int* next_state;              // (B,)
  const int* table;             // (S, 256)
  const int* tok_bytes;         // (V, L)
  const int* tok_lens;          // (V,)
  int L;
  int* top_ids;                 // (R, TOP), or null
  float* top_lps;               // (R, TOP)
};

// a block's partial of the load pass
struct Stats {
  unsigned long long best;      // packed argmax of s
  float smax, smin, rmax, rsum; // max / min of s, logsumexp of lf
};

__device__ __forceinline__ void stats_merge(Stats& a, const Stats& o) {
  a.best = o.best > a.best ? o.best : a.best;
  a.smax = fmaxf(a.smax, o.smax);
  a.smin = fminf(a.smin, o.smin);
  lse_merge(a.rmax, a.rsum, o.rmax, o.rsum);
}

// The cluster-wide reductions: N block partials -> warp shuffles -> N
// threads -> N slots of this block's shared memory (double-buffered by
// exchange parity) -> one cluster barrier -> every thread adds each
// value's CL slots in rank order, so every block holds the same totals.
struct Exchange {
  cg::cluster_group cluster;
  uint32_t* wpart;              // [WARPS * MAX_MIDS]
  uint32_t* slot;               // [2 * MAX_MIDS]
  int parity;

  template <typename V, int N>
  __device__ void sum(V (&v)[N]) {
    static_assert(sizeof(V) == 4 && N <= MAX_MIDS, "32-bit partials");
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[i] += __shfl_xor_sync(0xFFFFFFFFu, v[i], off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) wpart[warp * N + i] = bits(v[i]);
    }
    __syncthreads();
    if (threadIdx.x < N) {
      const int i = threadIdx.x;
      V s = of<V>(wpart[i]);
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += of<V>(wpart[w * N + i]);
      slot[parity * MAX_MIDS + i] = bits(s);
    }
    cluster.sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t* mine = &slot[parity * MAX_MIDS + i];
      V tot = of<V>(*cluster.map_shared_rank(mine, 0));
#pragma unroll
      for (int q = 1; q < CL; ++q)
        tot += of<V>(*cluster.map_shared_rank(mine, q));
      v[i] = tot;
    }
    parity ^= 1;
  }

  template <typename V>
  __device__ V sum1(V v) {
    V a[1] = {v};
    sum(a);
    return a[0];
  }

  __device__ static uint32_t bits(int v) { return (uint32_t)v; }
  __device__ static uint32_t bits(float v) { return __float_as_uint(v); }
  template <typename V>
  __device__ static V of(uint32_t u) {
    if constexpr (std::is_same<V, float>::value) {
      return __uint_as_float(u);
    } else {
      return (V)(int)u;
    }
  }
};

// LV levels of the bisection in one pass and one exchange: the 2**LV - 1
// midpoints the sequential bisection may test next (node n's children are
// 2n + 1 when its test fails and 2n + 2 when it holds, each midpoint
// 0.5 * (lo + hi) of its own interval), every one's partial taken by
// part(mids, acc), then the path through them taken as the sequential
// bisection takes it. So lo and hi end bit for bit where LV sequential
// rounds would leave them.
template <int LV, typename V, typename Part, typename Ok>
__device__ __forceinline__ void bisect_round(Exchange& ex, float& lo,
                                             float& hi, Part part, Ok ok) {
  constexpr int NM = (1 << LV) - 1;
  float mids[NM], l[NM], h[NM];
  l[0] = lo;
  h[0] = hi;
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    mids[n] = __fmul_rn(0.5f, __fadd_rn(l[n], h[n]));
    if (2 * n + 2 < NM) {
      l[2 * n + 1] = l[n];
      h[2 * n + 1] = mids[n];
      l[2 * n + 2] = mids[n];
      h[2 * n + 2] = h[n];
    }
  }
  V acc[NM];
#pragma unroll
  for (int n = 0; n < NM; ++n) acc[n] = V(0);
  part(mids, acc);
  ex.sum(acc);
  int node = 0;
#pragma unroll
  for (int lev = 0; lev < LV; ++lev) {
    V total = acc[0];
    float mid = mids[0];
#pragma unroll
    for (int n = 1; n < NM; ++n) {
      total = n == node ? acc[n] : total;
      mid = n == node ? mids[n] : mid;
    }
    const bool holds = ok(total);
    lo = holds ? mid : lo;
    hi = holds ? hi : mid;
    node = 2 * node + (holds ? 2 : 1);
  }
}

// N_BISECT rounds of the bisection, LEVELS at a time
template <typename V, typename Part, typename Ok>
__device__ __forceinline__ float bisect(Exchange& ex, float lo, float hi,
                                        Part part, Ok ok) {
  for (int done = 0; done + LEVELS <= N_BISECT; done += LEVELS)
    bisect_round<LEVELS, V>(ex, lo, hi, part, ok);
  constexpr int rest = N_BISECT % LEVELS;
  if constexpr (rest > 0) bisect_round<rest, V>(ex, lo, hi, part, ok);
  return lo;
}

template <typename T, bool MASK, bool TOPS>
__global__ void __launch_bounds__(THREADS)
    sample_slots_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sbuf = reinterpret_cast<float*>(smem4);    // [n] scaled row slice
  __shared__ uint32_t wpart[WARPS * MAX_MIDS];
  __shared__ uint32_t slot[2 * MAX_MIDS];
  __shared__ Stats wstats[WARPS];
  __shared__ Stats xstats;
  __shared__ unsigned long long wbest[WARPS];
  __shared__ unsigned long long xbest;
  __shared__ unsigned long long xtop[TOP];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = r / a.W, w = r - b * a.W;
  const bool act = a.active[b] != 0;
  const float t = act ? a.temperature[b] : 0.f;
  const bool sampled = t > 0.f;
  const int k = act ? a.top_k[b] : 0;
  const float p = act ? a.top_p[b] : 1.f;
  const float safe_t = sampled ? t : 1.f;
  const bool need_k = sampled && k > 0, need_p = sampled && p < 1.f;

  const int lo_i = rank * a.n;
  const int len = max(0, min(a.n, a.V - lo_i));
  const T* row = static_cast<const T*>(a.logits) + (long long)r * a.row_stride;
  const T* seg = row + lo_i;
  // a row is masked unless its grammar state says it is unconstrained
  const bool masked = MASK && a.mask_states[r] > 0;
  const unsigned int* arow = masked ? a.allowed + (long long)r * a.words
                                    : nullptr;

  // ---- the load pass: s into shared memory, the row's max / min / argmax
  // of s and the logsumexp of lf (and, with TOPS, each thread's top words
  // of lf)
  Stats st{0ull, -INFINITY, INFINITY, -INFINITY, 0.f};
  unsigned long long tk[TOP];
#pragma unroll
  for (int q = 0; q < TOP; ++q) tk[q] = 0ull;
  auto take = [&](int j, float x) -> float {
    float s = x / safe_t;
    if constexpr (MASK) {
      const int i = lo_i + j;
      if (masked && !((arow[i >> 5] >> (i & 31)) & 1u)) s = -INFINITY;
    }
    if constexpr (TOPS) top_insert(tk, top_word(x, lo_i + j));
    st.smax = fmaxf(st.smax, s);
    st.smin = fminf(st.smin, s);
    const unsigned long long wd = pack(s, lo_i + j);
    st.best = wd > st.best ? wd : st.best;
    if (x > st.rmax) {
      st.rsum = st.rsum * expf(st.rmax - x) + 1.f;
      st.rmax = x;
    } else if (x != -INFINITY) {
      st.rsum += expf(x - st.rmax);
    }
    return s;
  };
  constexpr int VE = 16 / sizeof(T);       // logits a 16-byte load
  const int nv = (reinterpret_cast<uintptr_t>(seg) & 15) ? 0 : len / VE;
  const uint4* src = reinterpret_cast<const uint4*>(seg);
  for (int v0 = tid; v0 < nv; v0 += THREADS * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < nv) buf[u] = __ldg(src + v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v >= nv) continue;
      const uint32_t word[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
      float s[VE];
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const float x = sizeof(T) == 2
            ? __uint_as_float(q & 1 ? word[q >> 1] & 0xFFFF0000u
                                    : word[q >> 1] << 16)
            : __uint_as_float(word[q]);
        s[q] = take(v * VE + q, x);
      }
      float4* dst = smem4 + v * (VE / 4);
#pragma unroll
      for (int h = 0; h < VE / 4; ++h)
        dst[h] = make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2],
                             s[4 * h + 3]);
    }
  }
  for (int j = nv * VE + tid; j < len; j += THREADS)
    sbuf[j] = take(j, load1(seg, j));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.best = __shfl_xor_sync(0xFFFFFFFFu, st.best, off);
    o.smax = __shfl_xor_sync(0xFFFFFFFFu, st.smax, off);
    o.smin = __shfl_xor_sync(0xFFFFFFFFu, st.smin, off);
    o.rmax = __shfl_xor_sync(0xFFFFFFFFu, st.rmax, off);
    o.rsum = __shfl_xor_sync(0xFFFFFFFFu, st.rsum, off);
    stats_merge(st, o);
  }
  if constexpr (TOPS) {
    // the block's top TOP words: TOP rounds of a block-wide max, the
    // thread holding each winner dropping it from its list
#pragma unroll 1
    for (int q = 0; q < TOP; ++q) {
      unsigned long long w = tk[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, w, off);
        w = o > w ? o : w;
      }
      if (lane == 0) wbest[warp] = w;
      __syncthreads();
      if (tid == 0) {
        unsigned long long b = wbest[0];
#pragma unroll
        for (int u = 1; u < WARPS; ++u) b = wbest[u] > b ? wbest[u] : b;
        xtop[q] = b;
      }
      __syncthreads();
      if (tk[0] == xtop[q] && tk[0] != 0ull) {
#pragma unroll
        for (int u = 0; u + 1 < TOP; ++u) tk[u] = tk[u + 1];
        tk[TOP - 1] = 0ull;
      }
    }
  }
  if (lane == 0) wstats[warp] = st;
  __syncthreads();       // also publishes sbuf to the whole block
  if (tid == 0) {
    Stats s = wstats[0];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) stats_merge(s, wstats[q]);
    xstats = s;
  }
  cluster.sync();
  Stats tot = *cluster.map_shared_rank(&xstats, 0);
#pragma unroll
  for (int q = 1; q < CL; ++q)
    stats_merge(tot, *cluster.map_shared_rank(&xstats, q));

  Exchange ex{cluster, wpart, slot, 0};
  const float m = tot.smax;
  const float nan = __int_as_float(0x7FC00000);
  float thr_k = nan, thr_p = nan, cut = nan;
  int tok = unpack(tot.best);
  if (sampled) {
    // ---- the cutoffs (the reference's _mask_dynamic)
    const float lo0 = fmaxf(tot.smin, m - 100.f) - 1.f;
    const float hi0 = __fadd_rn(m, 1.f);
    thr_k = thr_p = lo0;
    if (need_k) {
      // count(s >= t) >= k: the largest such t is the top-k cutoff
      thr_k = bisect<int>(
          ex, lo0, hi0,
          [&](const auto& mids, auto& acc) {
            constexpr int NM = sizeof(mids) / sizeof(float);
            for (int j = tid; j < len; j += THREADS) {
              const float s = sbuf[j];
#pragma unroll
              for (int n = 0; n < NM; ++n) acc[n] += s >= mids[n];
            }
          },
          [&](int count) { return count >= k; });
    }
    if (need_p) {
      float zpart = 0.f;
      for (int j = tid; j < len; j += THREADS) {
        const float s = sbuf[j];
        zpart += s >= thr_k ? expf(s - m) : 0.f;
      }
      const float z = ex.sum1(zpart);
      const float target = __fmul_rn(fminf(fmaxf(p, 0.f), 1.f), z);
      // mass(s >= t) >= target: the largest such t is the top-p cutoff.
      // Each thread adds its entries in one order whatever the midpoint,
      // so a mass depends only on the set of entries it takes
      thr_p = bisect<float>(
          ex, lo0, hi0,
          [&](const auto& mids, auto& acc) {
            constexpr int NM = sizeof(mids) / sizeof(float);
            for (int j = tid; j < len; j += THREADS) {
              const float s = sbuf[j];
              const float e = s >= thr_k ? expf(s - m) : 0.f;
#pragma unroll
              for (int n = 0; n < NM; ++n) acc[n] += s >= mids[n] ? e : 0.f;
            }
          },
          [&](float mass) { return mass >= target; });
    }
    cut = fminf(fmaxf(thr_k, thr_p), m);

    // ---- the draw over the entries that can win
    if (m == -INFINITY) {
      tok = 0;
    } else {
      const float keep = need_k || need_p ? cut : -INFINITY;
      const float floor_ = fmaxf(keep, m - (21.f + fabsf(m) * 0x1p-20f));
      const long long c0 = a.ctr64
          ? static_cast<const long long*>(a.counter0)[b]
          : (long long)static_cast<const int*>(a.counter0)[b];
      const uint2 key = threefry2x32((uint32_t)a.keys[2 * b],
                                     (uint32_t)a.keys[2 * b + 1], 0u,
                                     (uint32_t)(c0 + w));
      unsigned long long bd = 0ull;
      for (int j = tid; j < len; j += THREADS) {
        const float s = sbuf[j];
        if (!(s >= floor_)) continue;
        const int i = lo_i + j;
        const uint2 x = threefry2x32(key.x, key.y, 0u, (uint32_t)i);
        const unsigned long long wd =
            pack(__fadd_rn(s, gumbel_of(x.x ^ x.y)), i);
        bd = wd > bd ? wd : bd;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, bd, off);
        bd = o > bd ? o : bd;
      }
      if (lane == 0) wbest[warp] = bd;
      __syncthreads();
      if (tid == 0) {
#pragma unroll
        for (int q = 0; q < WARPS; ++q) bd = wbest[q] > bd ? wbest[q] : bd;
        xbest = bd;
      }
      cluster.sync();
      bd = 0ull;
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        const unsigned long long o = *cluster.map_shared_rank(&xbest, q);
        bd = o > bd ? o : bd;
      }
      tok = unpack(bd);
    }
  }

  if (rank == 0 && tid == 0) {
    const float lse = tot.rmax == -INFINITY ? -INFINITY
                                            : tot.rmax + logf(tot.rsum);
    a.tokens[r] = tok;
    a.logprobs[r] = load1(row, tok) - lse;
    if (a.cutoffs != nullptr) {
      a.cutoffs[3 * r] = thr_k;
      a.cutoffs[3 * r + 1] = thr_p;
      a.cutoffs[3 * r + 2] = cut;
    }
    if (a.next_state != nullptr && w == 0) {
      // grammar_advance: the drawn token's bytes from the slot's state
      int gs = a.gram_state[b];
      if (act && gs > 0) {
        const int n = min(a.tok_lens[tok], a.L);
        const int* tb = a.tok_bytes + (long long)tok * a.L;
        for (int l = 0; l < n; ++l) gs = a.table[(long long)gs * 256 + tb[l]];
      }
      a.next_state[b] = gs;
    }
    if constexpr (TOPS) {
      // the cluster's top TOP: the largest of its blocks' words, in turn
      unsigned long long cand[CL * TOP];
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        const unsigned long long* src = cluster.map_shared_rank(xtop, q);
#pragma unroll
        for (int u = 0; u < TOP; ++u) cand[q * TOP + u] = src[u];
      }
      const float lse = tot.rmax == -INFINITY ? -INFINITY
                                              : tot.rmax + logf(tot.rsum);
      for (int u = 0; u < TOP; ++u) {
        int at = 0;
        for (int c = 1; c < CL * TOP; ++c) at = cand[c] > cand[at] ? c : at;
        const int id = top_index(cand[at]);
        cand[at] = 0ull;
        a.top_ids[TOP * r + u] = id;
        a.top_lps[TOP * r + u] = load1(row, id) - lse;
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
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

// the slice of a row each block holds: a multiple of 8 entries (16-byte
// loads of bf16), together covering the row
int slice_of(int V) { return ((V + CL - 1) / CL + 7) / 8 * 8; }

template <typename T, bool MASK, bool TOPS>
int launch(const Args& a, cudaStream_t s) {
  auto kern = sample_slots_kernel<T, MASK, TOPS>;
  const size_t smem = sizeof(float) * (size_t)a.n;   // s
  static size_t smem_set = 0;     // the instance's dynamic-shared limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.R * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch_options(const Args& a, cudaStream_t s) {
  if (a.allowed != nullptr) {
    return a.top_ids != nullptr ? launch<T, true, true>(a, s)
                                : launch<T, true, false>(a, s);
  }
  return a.top_ids != nullptr ? launch<T, false, true>(a, s)
                              : launch<T, false, false>(a, s);
}

}  // namespace

// One sampling call: logits (R, V) float32 (dtype 0) or bfloat16 (dtype 1),
// entries contiguous, rows row_stride elements apart; R = B * W rows, row
// (b, w) of slot b. keys (B, 2) int64; counter0 (B,) int32 (ctr64 0) or
// int64; temperature, top_p (B,) float32; top_k (B,) int32; active (B,)
// bool. Writes tokens (R,) int32, logprobs (R,) float32 and, when cutoffs
// is not null, (R, 3) float32 thr_k, thr_p, cut (NaN on greedy rows).
// The options, each null on the common path: allowed (R, ceil(V / 32))
// uint32 with mask_states (R,) int32 (rows <= 0 skip the mask);
// gram_state (B,) int32, next_state (B,) int32, table (S, 256) int32,
// tok_bytes (V, L) int32, tok_lens (V,) int32 (the advance, read only
// when gram_state is not null); top_ids (R, 5) int32 and top_lps (R, 5)
// float32. Returns a CUDA error code, 0 on success.
extern "C" int gk_sample_slots(
    int dtype, const void* logits, long long row_stride, int R, int V, int W,
    const void* keys, const void* counter0, int ctr64,
    const void* temperature, const void* top_k, const void* top_p,
    const void* active, void* tokens, void* logprobs, void* cutoffs,
    const void* allowed, const void* mask_states, const void* gram_state,
    void* next_state, const void* table, const void* tok_bytes,
    const void* tok_lens, int L, void* top_ids, void* top_lps, void* stream) {
  if (R <= 0 || V <= 0 || W <= 0 || R % W || row_stride < V ||
      (dtype != 0 && dtype != 1) ||
      ((allowed == nullptr) != (mask_states == nullptr)) ||
      (gram_state != nullptr && (next_state == nullptr || table == nullptr
                                 || tok_bytes == nullptr
                                 || tok_lens == nullptr || L <= 0)) ||
      ((top_ids == nullptr) != (top_lps == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.logits = logits;
  a.row_stride = row_stride;
  a.R = R;
  a.V = V;
  a.W = W;
  a.n = slice_of(V);
  a.keys = static_cast<const long long*>(keys);
  a.counter0 = counter0;
  a.ctr64 = ctr64;
  a.temperature = static_cast<const float*>(temperature);
  a.top_k = static_cast<const int*>(top_k);
  a.top_p = static_cast<const float*>(top_p);
  a.active = static_cast<const unsigned char*>(active);
  a.tokens = static_cast<int*>(tokens);
  a.logprobs = static_cast<float*>(logprobs);
  a.cutoffs = static_cast<float*>(cutoffs);
  a.allowed = static_cast<const unsigned int*>(allowed);
  a.mask_states = static_cast<const int*>(mask_states);
  a.words = (V + 31) / 32;
  a.gram_state = static_cast<const int*>(gram_state);
  a.next_state = gram_state != nullptr ? static_cast<int*>(next_state)
                                       : nullptr;
  a.table = static_cast<const int*>(table);
  a.tok_bytes = static_cast<const int*>(tok_bytes);
  a.tok_lens = static_cast<const int*>(tok_lens);
  a.L = L;
  a.top_ids = static_cast<int*>(top_ids);
  a.top_lps = static_cast<float*>(top_lps);
  if (sizeof(float) * (size_t)a.n + STATIC_SMEM > SMEM_OPTIN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_options<float>(a, s)
                    : launch_options<uint16_t>(a, s);
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
