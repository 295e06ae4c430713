// Ragged paged attention over the flat KV pool (bf16/f32 or int8 pool).
//
// Replaces generativeaiexamples_tpu/ops/pallas/attention.py
// ragged_paged_attention / _ragged_paged_kernel, both of its variants (the
// paged_decode wrapper stays a Python wrapper over this kernel). R
// independent rows of up to Qb queries each read K/V straight from the pool
// (L*P, page, KV*HD): the physical row of a row's logical page p is
// layer*P + table[r, p], and head kv lives in column band [kv*HD,
// (kv+1)*HD). Query j of row r sits at q_pos0[r] + j and sees keys at
// positions <= that and < kv_len[r]; rows with q_num == 0 are skipped
// (zeros written), and query slots >= q_num come out finite, never NaN
// (NEG_INF masking plus the max(l, 1e-30) guard, as in the TPU kernel).
//
// int8 pool: the same kernel with the pool type KT = int8_t and two f32
// scale pools (L*P, KV, page), one scale per token and KV head. As in the
// TPU kernel the elements are never dequantized (see attend_tiles).
//
// The TPU grid (R, pages) carried acc/m/l in VMEM across pages. Here the
// grid is (R, KV, S): block s walks its split of the row's 64-token tiles
// (the walk in common.cuh, attend_tiles, shared with ragged_decode.cu,
// which also says what bounds it, its pipeline and how the splits
// combine), clamped to min(kv_len, maxp*page), so pages past the length
// are never read (decode_step_wide passes kv_len unclamped). Any page size
// works: each token's physical row is resolved once per tile. This file
// keeps only the page-table address resolution, the query tiles and the
// launch.
//
// Query tiles: a block holds at most QG_MAX = 64 query vectors (Qb * G),
// 32 at HD = 256 (qg_cap). A row with more (llama3-70b, G = 8: a verify
// step of width 9 has 72, a mixed dispatch's q_block of 16 has 128;
// gemma-2b, G = 8 at HD = 256: a verify step of width 5 has 40) is cut
// into tiles of tq = cap / G queries (the wrapper's choice), each a cell
// of its own: grid
// axis y is (query tile, KV head), every tile walks the same KV split,
// and its partials and ticket are its own, so a combine never mixes two
// tiles. Each tile re-reads its split's K/V (from L2 when the tiles of a
// row run together).
//
// Split plan at the smoke shapes (2048-token capacity, 8 KV heads, 132
// SMs): batch-8 decode 6 splits of 6 tiles (384 blocks), the Qb = 8 mixed
// rows (R = 4) 11 of 3 (352), batch 1 32 of 1 (256). Dynamic shared
// memory per block at HD = 128 (Walk<>::SMEM): 110,848 bytes for a bf16
// pool in the 16-row bucket (two blocks an SM), 63,232 for an int8 pool,
// 187,392 for f32 in the 64-row bucket; at HD = 256, 213,248 and 221,696
// for a bf16 pool in the 16- and 32-row buckets (one block an SM),
// 153,088 for an int8 pool and 171,520 for f32 (32 rows). Registers and
// spills: chip_smoke.py's build phase.
#include "common.cuh"

using namespace gk;

namespace {

template <typename T, typename KT, int HD, int QGB>
__global__ void __launch_bounds__(Walk<T, KT, HD, QGB>::RT)
    ragged_paged_kernel(const T* __restrict__ q, const KT* __restrict__ k_pages,
                        const KT* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ tables,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ q_pos0,
                        const int* __restrict__ q_num,
                        const int* __restrict__ layer_ptr, T* __restrict__ out,
                        int Qb, int tq, int H, int KV, int ps, int maxp, int P,
                        float scale, int tiles, float* __restrict__ part,
                        int* __restrict__ tickets) {
  const int r = blockIdx.x;
  const int kvh = blockIdx.y % KV, qt = blockIdx.y / KV;
  const int G = H / KV;
  // this block's query tile: queries q0 .. q0 + qb - 1 of the row, of
  // which the first n_q are live
  const int q0 = qt * tq;
  const int qb = min(tq, Qb - q0);
  const int n_q = min(q_num[r] - q0, qb);
  // q and out are contiguous (R, Qb, H, HD)
  const long long base = ((long long)r * Qb + q0) * H * HD;
  if (n_q <= 0) {   // every split of the tile returns here; split 0 writes
    if (blockIdx.z == 0) {
      for (int idx = threadIdx.x; idx < qb * G * HD; idx += blockDim.x) {
        const int j = idx / HD, d = idx % HD;
        const int qi = j / G, g = j % G;
        out[base + ((long long)qi * H + kvh * G + g) * HD + d] = from_f<T>(0.f);
      }
    }
    return;
  }
  const long long layer_row = (long long)layer_ptr[0] * P;
  const long long page_stride = (long long)ps * KV * HD;
  const int* table = tables + (long long)r * maxp;
  // a token's physical row is layer*P + table[pos / ps]; its scale slot in
  // the (L*P, KV, page) scale pools is (row*KV + kvh)*ps + pos % ps
  const auto locate = [=](int pos, long long& sc) {
    const long long row = layer_row + table[pos / ps];
    sc = (row * KV + kvh) * ps + pos % ps;
    return row * page_stride + (long long)(pos % ps) * KV * HD +
           (long long)kvh * HD;
  };
  attend_tiles<T, KT, HD, QGB>(q, out, base, k_pages, v_pages, k_scales,
                               v_scales, min(kv_lens[r], maxp * ps),
                               q_pos0[r] + q0, n_q, qb, G, H, kvh, scale,
                               tiles, tq * G, part, tickets, locate);
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *lens, *pos0, *qnum, *layer;
  void* out;
  int R, Qb, tq, H, KV, ps, maxp, P, tiles, splits;
  float* part;
  int* tickets;
  cudaStream_t stream;
};

template <typename T, typename KT, int HD, int QGB>
cudaError_t launch_qgb(const Args& a) {
  using W = Walk<T, KT, HD, QGB>;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_kernel<T, KT, HD, QGB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(a.R, a.KV * ((a.Qb + a.tq - 1) / a.tq), a.splits);
  ragged_paged_kernel<T, KT, HD, QGB><<<grid, W::RT, W::SMEM, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
          static_cast<const KT*>(a.vp), a.ks, a.vs, a.tables, a.lens, a.pos0,
          a.qnum, a.layer, static_cast<T*>(a.out), a.Qb, a.tq, a.H, a.KV, a.ps,
          a.maxp, a.P, 1.f / sqrtf((float)HD), a.tiles, a.part, a.tickets);
  return cudaGetLastError();
}

template <typename T, typename KT, int HD>
cudaError_t launch(const Args& a) {
  const int QG = a.tq * (a.H / a.KV);
  if (QG <= 16) return launch_qgb<T, KT, HD, 16>(a);
  if (QG <= 32) return launch_qgb<T, KT, HD, 32>(a);
  if constexpr (qg_cap<HD>() == QG_MAX) {
    if (QG <= QG_MAX) return launch_qgb<T, KT, HD, QG_MAX>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename KT>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, KT, 16>(a);
    case 32: return launch<T, KT, 32>(a);
    case 64: return launch<T, KT, 64>(a);
    case 128: return launch<T, KT, 128>(a);
    case 256: return launch<T, KT, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: contiguous (R, Qb, H, HD) of `dtype`; k_pages, v_pages:
// contiguous (L*P, ps, KV*HD), 16-byte aligned, of `dtype` when k_scales
// and v_scales are null, int8 when they are given (contiguous f32 (L*P,
// KV, ps)); tables: (R, maxp) int32; kv_lens, q_pos0, q_num: (R,) int32;
// layer: (1,) int32 on the device. A row's queries are cut into tiles of
// tq (tq * H/KV <= QG_MAX query vectors a block); the grid is (R, KV *
// tiles of a row, splits), each split `tiles` 64-token tiles; with splits
// > 1, part: f32 scratch of R*KV*ceil(Qb/tq)*splits*tq*(H/KV)*(HD+2)
// values and tickets: R*KV*ceil(Qb/tq) int32 counters, zero (the kernel
// leaves them zero). Returns cudaGetLastError().
extern "C" int gk_ragged_paged_attention(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales,
    const void* tables, const void* kv_lens, const void* q_pos0,
    const void* q_num, const void* layer, void* out, int R, int Qb, int tq,
    int H, int KV, int ps, int maxp, int P, int tiles, int splits, void* part,
    void* tickets, void* stream) {
  if (R <= 0 || Qb <= 0 || tq <= 0 || tq > Qb || KV <= 0 || H % KV ||
      ps <= 0 || maxp <= 0 ||
      tiles <= 0 || splits <= 0 || splits > SPLIT_MAX ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      (k_scales == nullptr) != (v_scales == nullptr) ||
      (reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(
                                                  v_pages)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(tables),
               static_cast<const int*>(kv_lens),
               static_cast<const int*>(q_pos0),
               static_cast<const int*>(q_num),
               static_cast<const int*>(layer),
               out, R, Qb, tq, H, KV, ps, maxp, P, tiles, splits,
               static_cast<float*>(part), static_cast<int*>(tickets),
               static_cast<cudaStream_t>(stream)};
  const bool quant = k_scales != nullptr;
  if (dtype == DT_BF16) {
    return (int)(quant ? dispatch_hd<__nv_bfloat16, int8_t>(head_dim, a)
                       : dispatch_hd<__nv_bfloat16, __nv_bfloat16>(head_dim, a));
  }
  if (dtype == DT_F32) {
    return (int)(quant ? dispatch_hd<float, int8_t>(head_dim, a)
                       : dispatch_hd<float, float>(head_dim, a));
  }
  return (int)cudaErrorInvalidValue;
}
