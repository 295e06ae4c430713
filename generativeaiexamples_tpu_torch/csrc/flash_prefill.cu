// Flash prefill: causal GQA attention of a prefill chunk against a dense
// KV view, online softmax in f32.
//
// Replaces generativeaiexamples_tpu/ops/pallas/attention.py flash_prefill /
// _flash_kernel. Query i of batch row b sits at start_pos[b] + i; keys are
// masked to < kv_valid_through[b] and to causal order; query slots past the
// chunk come out finite.
//
// The TPU kernel walks a sequential (b, h, q-block, kv-block) grid and
// carries acc/m/l in VMEM between grid steps. Blocks on the card run in
// parallel, so the kv axis is a loop inside one block here: one block per
// (64-query tile, head, batch row) walks KV tiles 0..limit, where limit is
// the TPU kernel's _kv_block_limit (causally dead tiles and tiles past the
// valid length are neither loaded nor computed).
//
// What bounds it on the H100: a 64-query tile reads each 64-token K/V tile
// once and does 64 x 64 x HD x 2 multiply-adds on it, about 64 operations
// per byte at HD = 128 (P as two bf16 terms: ~96), below the ~295 at which
// the tensor cores and not device memory set the limit, but K/V tiles are
// re-read by every query tile and every head of a group, so they come from
// L2 and the walk is bound by the tensor cores' issue rate and by latency
// on the short walks. The bf16 instance does about that:
//
// * Tensor cores for both products: mma.sync m16n8k16, bf16 in, f32
//   accumulators. 4 warps per block, each owning 16 query rows of the
//   64-query tile (FA2 layout); Q is copied once and held in registers as
//   A fragments (ldmatrix) for the whole walk, K fragments come by
//   ldmatrix, V fragments by ldmatrix.trans.
// * An asynchronous copy ring: K/V tiles of 64 tokens are staged in bf16
//   by 16-byte cp.async copies into 3 stages of rows padded by 8 elements
//   (conflict-free ldmatrix), so two tiles are in flight while one is
//   scored; one barrier per tile. Q's staging aliases the last stage,
//   which the walk first writes after every warp holds Q in registers.
//   104,448 bytes of shared memory at HD = 128 and at most 256 registers
//   a thread (128 threads, __launch_bounds__(128, 2)): two blocks, 8 warps,
//   per SM. Rows past the valid length are zero-filled, not read.
// * Softmax in registers: scale (folded with log2 e into exp2) and mask on
//   the score accumulators, the mask only on tiles that hold the diagonal
//   or the valid-length edge; row max by quad shuffles; the accumulators
//   are repacked straight into P's A fragments (the m16n8 C layout pairs
//   into the m16n8k16 A layout), so P never touches shared memory.
// * P enters P.V as two bf16 terms, its nearest bf16 value and the
//   remainder (split_bf16), as in attend_tiles: 16 significant bits for
//   1.5x the tensor-core work of one term.
// * Longest walk first: a 1-D grid ordered by descending query tile (the
//   last tiles of a causal chunk walk the most KV tiles), rows and heads
//   interleaved below it, the G heads of one KV head on adjacent blocks so
//   their K/V tiles are served from L2.
//
// HD = 256 (the Gemma family): a warp's 16 x 256 f32 output is 128
// registers, and Q held as A fragments would add 64 more (with the 32 of
// the scores, 224 before any address: it would spill). So at HD = 256 Q
// stays in shared memory beside the ring, and each k-step of Q.K^T loads
// its A fragment by ldmatrix (QREG false); the ring drops to 2 stages of
// 64 tokens, 2 x 67,584 bytes, plus Q's 33,792: 168,960 bytes, one block
// (4 warps) an SM, __launch_bounds__(128, 1). Correct first; a wgmma
// walk with the output split over more warps is later work.
//
// The f32 instance (the parity phase and the f32 card tests) keeps scalar
// f32 FMAs from shared memory: 16 x 16 threads, each owning a 4 x 4 score
// tile and a 4 x HD/16 output tile (213,760 bytes of shared memory at HD =
// 256). wgmma and TMA tiles are later work.
#include "common.cuh"

using namespace gk;

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BK = 64;    // keys per KV tile

// Block x of the 1-D grid: query tiles in descending order, then rows, then
// heads (fastest), so the heads of one KV head run side by side.
struct TileCoord {
  int qt, h, b;
};
__device__ __forceinline__ TileCoord tile_of(int x, int n_qt, int H, int B) {
  const int per_qt = H * B;
  const int r = x % per_qt;
  return {n_qt - 1 - x / per_qt, r % H, r / H};
}

// _kv_block_limit with `through` already clamped to the KV view: the last
// KV tile any query of the tile at q0 can see
__device__ __forceinline__ int kv_tile_limit(int start, int through, int q0) {
  return min((max(through, 1) - 1) / BK, (start + q0 + BQ - 1) / BK);
}

// --- bf16: tensor cores over a cp.async ring --------------------------------

template <int HD>
struct MmaTile {
  static constexpr int NW = 4;                 // warps, 16 query rows each
  static constexpr int NT = 32 * NW;
  // Q held in registers for the whole walk (HD <= 128), else read from
  // shared memory at each k-step
  static constexpr bool QREG = HD <= 128;
  static constexpr int NS = QREG ? 3 : 2;      // ring stages
  static constexpr int MIN_BLOCKS = QREG ? 2 : 1;   // blocks an SM
  static constexpr int LD = HD + 8;            // staged row: 16 bytes of pad
  static constexpr int CPR = HD / 8;           // 16-byte copies per row
  static constexpr int STAGE = 2 * BK * LD;    // K then V, elements
  // Q's staging aliases the last stage when Q moves to registers, else it
  // has its own rows after the ring
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (NS * STAGE + (QREG ? 0 : BQ * LD));
  static_assert(BQ * LD <= BK * LD, "Q's staging fits in one stage");
  static_assert(SMEM <= 232448, "the card's shared memory a block");
};

template <int HD>
__global__ void __launch_bounds__(MmaTile<HD>::NT, MmaTile<HD>::MIN_BLOCKS)
    flash_prefill_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ start_pos, const int* __restrict__ valid_through,
    int B, int S, int T_len, int H, int KV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, float scale_log2) {
  using F = MmaTile<HD>;
  constexpr int LD = F::LD, NS = F::NS, NT = F::NT, CPR = F::CPR;
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int NN = HD / 8;    // 8-wide output column tiles
  constexpr int NJ = BK / 8;    // 8-token score tiles
  extern __shared__ __align__(16) unsigned char fp_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(fp_smem);
  __nv_bfloat16* q_s = ring + (F::QREG ? NS - 1 : NS) * F::STAGE;

  const TileCoord tc = tile_of(blockIdx.x, (S + BQ - 1) / BQ, H, B);
  const int b = tc.b, h = tc.h, q0 = tc.qt * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = start_pos[b];
  const int through = min(valid_through[b], T_len);
  const int n_t = kv_tile_limit(start, through, q0) + 1;

  // --- Q, then the first NS-1 K/V tiles, in flight together --------------
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, e = (c % CPR) * 8;
    const bool ok = q0 + r < S;
    cp_async16(q_s + r * LD + e, qb + (ok ? q0 + r : 0) * qss + e, ok);
  }
  cp_async_commit();
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  const auto issue = [&](int kt) {
    __nv_bfloat16* kd = ring + (kt % NS) * F::STAGE;
    __nv_bfloat16* vd = kd + BK * LD;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, e = (c % CPR) * 8;
      const int t = kt * BK + r;
      const bool ok = t < through;
      const long long row = ok ? t : 0;
      cp_async16(kd + r * LD + e, kb + row * kst + e, ok);
      cp_async16(vd + r * LD + e, vb + row * vst + e, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_t) issue(st);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();   // Q's group has landed
  __syncthreads();

  // this warp's 16 query rows as A fragments: held for the whole walk
  // (QREG), else loaded from q_s at each k-step
  const __nv_bfloat16* qa = q_s +
      (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
      (lane >> 4) * 8;
  uint32_t qf[F::QREG ? KS : 1][4];
  if constexpr (F::QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qa + kk * 16, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }

  // this lane holds rows gr and gr + 8 of the warp's 16, columns c0, c0+1
  // of every 8-wide tile
  const int gr = lane >> 2, c0 = (lane & 3) * 2;
  const int pos0 = start + q0 + warp * 16 + gr;   // position of row gr
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};   // this lane's share; the quad sums at the end

  for (int kt = 0; kt < n_t; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // tile kt landed; tile kt-1's stage is free (and
                       // Q's staging, where it aliases the last stage)
    if (kt + NS - 1 < n_t) issue(kt + NS - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = ring + (kt % NS) * F::STAGE;
    const __nv_bfloat16* vs = ks + BK * LD;
    const int k0 = kt * BK;

    // S = Q.K^T: 16 rows x 64 tokens per warp, 8 n-tiles of 8 tokens
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* kf =
        ks + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (F::QREG) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(qa + kk * 16, a[0], a[1], a[2], a[3]);
      }
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(kf + np * 16 * LD + kk * 16, b0, b1, b2, b3);
        mma_bf16(s[2 * np], a[0], a[1], a[2], a[3], b0, b1);
        mma_bf16(s[2 * np + 1], a[0], a[1], a[2], a[3], b2, b3);
      }
    }

    // scale into the exp2 domain; mask only where the tile holds the
    // diagonal or the valid-length edge
    const bool edge = k0 + BK - 1 > start + q0 || k0 + BK > through;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + c0 + (e & 1);
          const int pos = pos0 + 8 * (e >> 1);
          x = key < through && key <= pos ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V, 16 tokens per k-step: P's A fragments straight from the
    // score accumulators of n-tiles 2*kk and 2*kk+1, as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = 2 * kk + t;
        const float p0 = exp2f(s[j][0] - m_r[0]);
        const float p1 = exp2f(s[j][1] - m_r[0]);
        const float p2 = exp2f(s[j][2] - m_r[1]);
        const float p3 = exp2f(s[j][3] - m_r[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        split_bf16(p0, p1, pa[2 * t], pl[2 * t]);           // row gr
        split_bf16(p2, p3, pa[2 * t + 1], pl[2 * t + 1]);   // row gr + 8
      }
      const __nv_bfloat16* vf =
          vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NN; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(vf + n * 8, b0, b1, b2, b3);
        mma_bf16(o[n], pa[0], pa[1], pa[2], pa[3], b0, b1);
        mma_bf16(o[n], pl[0], pl[1], pl[2], pl[3], b0, b1);
        mma_bf16(o[n + 1], pa[0], pa[1], pa[2], pa[3], b2, b3);
        mma_bf16(o[n + 1], pl[0], pl[1], pl[2], pl[3], b2, b3);
      }
    }
  }
  cp_async_wait<0>();

  // out is contiguous (B, S, H, HD)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int qi = q0 + warp * 16 + gr + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow = out + (((long long)b * S + qi) * H + h) * HD + c0;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// --- f32: scalar FMAs from shared memory ------------------------------------

constexpr int NT_F32 = 256;   // 16 x 16 threads

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}
static_assert(f32_smem_bytes<256>() <= 232448, "the card's shared memory");

template <int HD>
__global__ void __launch_bounds__(NT_F32) flash_prefill_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    const int* __restrict__ start_pos, const int* __restrict__ valid_through,
    int B, int S, int T_len, int H, int KV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, float scale) {
  constexpr int LD = HD + 1;   // padded rows: no bank conflicts on k_s reads
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;            // BQ x LD
  float* k_s = q_s + BQ * LD;   // BK x LD
  float* v_s = k_s + BK * LD;   // BK x HD
  float* p_s = v_s + BK * HD;   // BQ x (BK + 1)

  const TileCoord tc = tile_of(blockIdx.x, (S + BQ - 1) / BQ, H, B);
  const int b = tc.b, h = tc.h, q0 = tc.qt * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int start = start_pos[b];
  const int through = min(valid_through[b], T_len);

  const float* qb = q + b * qsb + h * qsh;
  for (int idx = tid; idx < BQ * HD; idx += NT_F32) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    q_s[r * LD + d] = qi < S ? qb[(long long)qi * qss + d] : 0.f;
  }
  const int last = kv_tile_limit(start, through, q0);

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous tile's k_s/v_s/p_s are consumed
    for (int idx = tid; idx < BK * HD; idx += NT_F32) {
      const int r = idx / HD, d = idx % HD;
      const int t = k0 + r;
      const bool ok = t < through;
      k_s[r * LD + d] = ok ? kb[(long long)t * kst + d] : 0.f;
      v_s[r * HD + d] = ok ? vb[(long long)t * vst + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = start + q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < through && kpos <= qpos;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  // out is contiguous (B, S, H, HD)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* start_pos, const int* valid_through, int B,
                   int S, int T_len, int H, int KV, const long long* st,
                   cudaStream_t stream) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  const void* kernel = MMA ? (const void*)flash_prefill_mma<HD>
                           : (const void*)flash_prefill_f32<HD>;
  const size_t smem = MMA ? MmaTile<HD>::SMEM : f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((S + BQ - 1) / BQ) * H * B;
  const float scale = 1.f / sqrtf((float)HD);
  if constexpr (MMA) {
    flash_prefill_mma<HD><<<grid, MmaTile<HD>::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), start_pos,
        valid_through, B, S, T_len, H, KV, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale * 1.4426950408889634f);
  } else {
    flash_prefill_f32<HD><<<grid, NT_F32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), start_pos,
        valid_through, B, S, T_len, H, KV, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, const int* sp, const int* vt, int B, int S,
                        int T_len, int H, int KV, const long long* st,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, sp, vt, B, S, T_len, H, KV, st, stream);
    case 32: return launch<T, 32>(q, k, v, out, sp, vt, B, S, T_len, H, KV, st, stream);
    case 64: return launch<T, 64>(q, k, v, out, sp, vt, B, S, T_len, H, KV, st, stream);
    case 128: return launch<T, 128>(q, k, v, out, sp, vt, B, S, T_len, H, KV, st, stream);
    case 256: return launch<T, 256>(q, k, v, out, sp, vt, B, S, T_len, H, KV, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides (in elements): q (b, s, h), k (b, t, kv), v (b, t, kv); the head
// dim of every operand is contiguous, and every row starts on 16 bytes (the
// bf16 instance copies 16 bytes at a time). out is a fresh contiguous
// (B, S, H, HD) buffer. Returns cudaGetLastError() after the launch.
extern "C" int gk_flash_prefill(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, void* out,
                                const void* start_pos,
                                const void* valid_through, int B, int S,
                                int T_len, int H, int KV,
                                const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  const int* sp = static_cast<const int*>(start_pos);
  const int* vt = static_cast<const int*>(valid_through);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || H % KV) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == DT_BF16) {
    return (int)dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, out, sp, vt, B,
                                           S, T_len, H, KV, st, s);
  }
  if (dtype == DT_F32) {
    return (int)dispatch_hd<float>(head_dim, q, k, v, out, sp, vt, B, S,
                                   T_len, H, KV, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
