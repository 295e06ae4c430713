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
// The tile walk of the two decode-side kernels (ragged_paged.cu over the
// paged pool, ragged_decode.cu over the dense cache). One block serves one
// (row, KV head): the row's QG = Qb*G query vectors sit in shared memory
// and the block walks its live tokens in BT-token tiles. Per tile it
// resolves each token's K/V row (and, for an int8 pool, its scale slot)
// once into shared memory, loads K/V with 16-byte vector loads (8 bf16 or
// 16 int8 values), scores with one thread per (query, token), runs the
// online softmax one warp per query row, and accumulates P.V with one
// thread per (query, dim) pair in registers, sized by a query-count bucket
// QGB: 8 rows on 128 threads, 64 rows on 256, so the accumulators stay at
// QGB*HD/threads <= 32 registers. The kernels differ only in where a
// token's row lives, which `locate` answers.
// ---------------------------------------------------------------------------

constexpr int BT = 64;       // tokens per tile
constexpr int QG_MAX = 64;   // query vectors (G * Qb) per block, at most

template <typename KT>
__host__ __device__ constexpr bool is_quant() {
  return sizeof(KT) == 1;
}

template <int QGB>
__host__ __device__ constexpr int tile_threads() {
  return QGB > 8 ? 256 : 128;
}

template <typename KT, int HD>
size_t tile_smem_bytes(int QG) {
  return sizeof(float) * (size_t)(QG * (HD + 1) + BT * (HD + 1) + BT * HD +
                                  QG * BT + 3 * QG +
                                  (is_quant<KT>() ? 2 * BT : 0)) +
         sizeof(long long) * BT;
}

// q, out: this block's (row, KV head) slice of a contiguous (rows, Qb, H,
// HD) tensor starting at element `base`; block row j = qi*G + g is head
// kvh*G + g of query qi. Query qi sees tokens pos < len with pos <= pos0 +
// qi, and only while qi < n_q (slots past n_q come out finite garbage).
// `locate(pos, sc)` returns the element offset of token pos's K/V row of
// this head from k and v and, for an int8 pool, sets its scale slot `sc`
// in k_scales/v_scales. The elements are never dequantized: the scores are
// row-scaled by the token's K scale, (q.k)*scale*k_s, and the probabilities
// by its V scale before P.V; the denominator sums the unscaled ones.
template <typename T, typename KT, int HD, int QGB, typename Locate>
__device__ __forceinline__ void attend_tiles(
    const T* __restrict__ q, T* __restrict__ out, long long base,
    const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    int len, int pos0, int n_q, int Qb, int G, int H, int kvh, float scale,
    const Locate& locate) {
  constexpr bool QUANT = is_quant<KT>();
  constexpr int RT = tile_threads<QGB>();
  constexpr int LD = HD + 1;           // padded rows: conflict-free k_s reads
  constexpr int NACC = QGB * HD / RT;  // (query, dim) accumulators per thread
  constexpr int VEC = 16 / sizeof(KT); // elements per 16-byte load
  constexpr int CPT = HD / VEC;        // 16-byte chunks per token row
  extern __shared__ float smem[];
  const int QG = Qb * G;
  float* q_s = smem;            // QG x LD
  float* k_s = q_s + QG * LD;   // BT x LD
  float* v_s = k_s + BT * LD;   // BT x HD
  float* s_s = v_s + BT * HD;   // QG x BT scores, then probabilities
  float* a_s = s_s + QG * BT;   // QG: this tile's rescale factor
  float* m_s = a_s + QG;        // QG: running max
  float* l_s = m_s + QG;        // QG: running denominator
  long long* off_s = reinterpret_cast<long long*>(l_s + QG);  // BT rows
  float* ks_s = reinterpret_cast<float*>(off_s + BT);  // BT (int8 pool only)
  float* vs_s = ks_s + BT;                             // BT (int8 pool only)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int idx = tid; idx < QG * HD; idx += RT) {
    const int j = idx / HD, d = idx % HD;
    const int qi = j / G, g = j % G;
    q_s[j * LD + d] = to_f(q[base + ((long long)qi * H + kvh * G + g) * HD + d]);
  }
  for (int j = tid; j < QG; j += RT) {
    m_s[j] = NEG_INF;
    l_s[j] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;

  const int n_tiles = max(1, (len + BT - 1) / BT);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * BT;
    __syncthreads();   // previous tile consumed; q_s/m_s/l_s ready
    for (int t = tid; t < BT; t += RT) {
      const int pos = t0 + t;
      if (pos < len) {
        long long sc = 0;
        off_s[t] = locate(pos, sc);
        if constexpr (QUANT) {
          ks_s[t] = k_scales[sc];
          vs_s[t] = v_scales[sc];
        }
      } else {
        off_s[t] = -1;
        if constexpr (QUANT) {
          ks_s[t] = 0.f;
          vs_s[t] = 0.f;
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < BT * CPT; c += RT) {
      const int t = c / CPT, d0 = (c % CPT) * VEC;
      const long long off = off_s[t];
      float* kd = k_s + t * LD + d0;
      float* vd = v_s + t * HD + d0;
      if (off >= 0) {
        const uint4 kr = *reinterpret_cast<const uint4*>(k + off + d0);
        const uint4 vr = *reinterpret_cast<const uint4*>(v + off + d0);
        const KT* ke = reinterpret_cast<const KT*>(&kr);
        const KT* ve = reinterpret_cast<const KT*>(&vr);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kd[i] = to_f(ke[i]);
          vd[i] = to_f(ve[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kd[i] = 0.f;
          vd[i] = 0.f;
        }
      }
    }
    __syncthreads();

    for (int idx = tid; idx < QG * BT; idx += RT) {
      const int j = idx / BT, t = idx % BT;
      const float* qr = q_s + j * LD;
      const float* kr = k_s + t * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int qi = j / G;
      const int pos = t0 + t;
      const bool ok = pos < len && pos <= pos0 + qi && qi < n_q;
      float s = dot * scale;
      if constexpr (QUANT) s *= ks_s[t];   // q.(k*k_s) = (q.k)*k_s
      s_s[j * BT + t] = ok ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per query row, two tokens per lane
    for (int j = warp; j < QG; j += RT / 32) {
      float* sr = s_s + j * BT;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      if constexpr (QUANT) {
        // sum_t p_t (v_t*v_s_t) = (p*v_s) @ v: row-scale p, not V
        sr[lane] = p0 * vs_s[lane];
        sr[lane + 32] = p1 * vs_s[lane + 32];
      } else {
        sr[lane] = p0;
        sr[lane + 32] = p1;
      }
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
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
        const float* pr = s_s + j * BT;
        float sum = 0.f;
#pragma unroll 8
        for (int t = 0; t < BT; ++t) sum = fmaf(pr[t], v_s[t * HD + d], sum);
        acc[e] = acc[e] * a_s[j] + sum;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int idx = tid + e * RT;
    if (idx < QG * HD) {
      const int j = idx / HD, d = idx % HD;
      const int qi = j / G, g = j % G;
      out[base + ((long long)qi * H + kvh * G + g) * HD + d] =
          from_f<T>(acc[e] / fmaxf(l_s[j], 1e-30f));
    }
  }
}

}  // namespace gk
