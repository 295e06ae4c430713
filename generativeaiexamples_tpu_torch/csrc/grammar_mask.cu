// The allowed set of one grammared sampling call: for each of R rows and
// each of V vocabulary entries, whether the entry may be drawn under the
// row's byte-level DFA state, written as an (R, ceil(V / 32)) uint32
// bitmask (bit j of word w is entry 32 w + j; bits past V are 0).
//
//   walk     token v's bytes tok_bytes[v, :tok_lens[v]] through the flat
//            (S, 256) int32 table from the row's state; the reject state 0
//            is absorbing (its row is all zeros), so the walk stops there;
//   allowed  the walk ends off state 0, tok_lens[v] > 0 (a length of -1
//            marks a token that is never allowed under a grammar: specials,
//            partial UTF-8, entries past the tokenizer's vocabulary) and
//            dist[end] <= budget[row] (the state can still accept within
//            the tokens the request has left);
//   EOS      allowed exactly when the row's state accepts, or when no
//            entry of the row is allowed (the fail-safe), the EOS entry's
//            own walk included in that test;
//   rows     a row whose state is <= 0 is unconstrained: every entry
//            allowed, EOS too.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// generativeaiexamples_tpu/ops/sampling.py grammar_mask (L chained gathers
// over (B, V)), whose -inf logits become the bits sample_slots.cu reads.
// Its plain version is ops/sampling.py grammar_mask_plain (packed by
// pack_mask).
//
// What bounds it: the bytes of tok_bytes ((V, 16) int32, 8.2 MB at V =
// 128,256) and tok_lens, one 4-byte table entry a byte walked, and the
// bitmask written; the flat table of 4 slots x 4,096 states (16 MiB) and
// tok_bytes stay in the H100's 50 MB L2 across rows.
//
// Design: one thread a (row, entry), blocks of 256 entries of one row, so
// each warp holds 32 consecutive entries and its ballot is one word of the
// bitmask. A block of an unconstrained row writes ones. A block of a
// constrained row also ORs whether any of its entries is allowed into the
// row's flag (one atomic a block), and the last block of the row to finish
// (a counter, after a memory fence) sets the EOS bit from the state's
// accept flag and that row-wide flag. The caller zeroes the flags and
// counters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BYTES = 16;   // tok_bytes' columns (MAX_TOKEN_BYTES)

struct Args {
  const int* state;             // (R,) flat DFA state, <= 0 unconstrained
  const int* budget;            // (R,) tokens left after this one
  const int* table;             // (S, 256)
  const unsigned char* accept;  // (S,) bool
  const int* dist;              // (S,)
  const int* tok_bytes;         // (V, MAX_BYTES)
  const int* tok_lens;          // (V,)
  int R, V, words, eos;
  unsigned int* out;            // (R, words)
  int* any_ok;                  // (R,) zeroed by the caller
  unsigned int* done;           // (R,) zeroed by the caller
};

__global__ void __launch_bounds__(THREADS)
    grammar_mask_kernel(const Args a) {
  const int r = blockIdx.y;
  const int s0 = a.state[r];
  const int v = blockIdx.x * THREADS + threadIdx.x;
  const int word = v >> 5;
  bool ok = false;
  if (s0 <= 0) {
    ok = v < a.V;
  } else if (v < a.V) {
    const int n = a.tok_lens[v];
    if (n > 0) {
      int st = s0;
      const int4* tb =
          reinterpret_cast<const int4*>(a.tok_bytes + (long long)v * MAX_BYTES);
      const int lim = min(n, MAX_BYTES);
      for (int q = 0; q * 4 < lim && st != 0; ++q) {
        const int4 c = __ldg(tb + q);
        const int b4[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q * 4 + k < lim && st != 0)
            st = __ldg(a.table + (long long)st * 256 + b4[k]);
        }
      }
      ok = st != 0 && __ldg(a.dist + st) <= a.budget[r];
    }
  }
  const unsigned int bits = __ballot_sync(0xFFFFFFFFu, ok);
  if ((threadIdx.x & 31) == 0 && word < a.words)
    a.out[(long long)r * a.words + word] = bits;
  if (s0 <= 0) return;
  // the row-wide "any entry allowed" flag and the EOS bit, set by the last
  // block of the row once every block's words are written
  const int block_any = __syncthreads_or(ok);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (block_any) atomicOr(a.any_ok + r, 1);
    __threadfence();
    last = atomicAdd(a.done + r, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const bool any = atomicOr(a.any_ok + r, 0) != 0;
  const bool ok_eos = a.accept[s0] != 0 || !any;
  unsigned int* w = a.out + (long long)r * a.words + (a.eos >> 5);
  const unsigned int bit = 1u << (a.eos & 31);
  if (ok_eos) {
    atomicOr(w, bit);
  } else {
    atomicAnd(w, ~bit);
  }
}

}  // namespace

// The allowed set of R rows over V entries: state, budget (R,) int32;
// table (S, 256) int32; accept (S,) bool; dist (S,) int32; tok_bytes
// (V, 16) int32, 16-byte aligned; tok_lens (V,) int32; eos the EOS id
// (< V). Writes out (R, ceil(V / 32)) uint32. scratch: 2 R int32, zeroed.
// Returns a CUDA error code, 0 on success.
extern "C" int gk_grammar_mask(const void* state, const void* budget,
                               const void* table, const void* accept,
                               const void* dist, const void* tok_bytes,
                               const void* tok_lens, int R, int V, int eos,
                               void* out, void* scratch, void* stream) {
  if (R <= 0 || R > 65535 || V <= 0 || eos < 0 || eos >= V) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.state = static_cast<const int*>(state);
  a.budget = static_cast<const int*>(budget);
  a.table = static_cast<const int*>(table);
  a.accept = static_cast<const unsigned char*>(accept);
  a.dist = static_cast<const int*>(dist);
  a.tok_bytes = static_cast<const int*>(tok_bytes);
  a.tok_lens = static_cast<const int*>(tok_lens);
  a.R = R;
  a.V = V;
  a.words = (V + 31) / 32;
  a.eos = eos;
  a.out = static_cast<unsigned int*>(out);
  a.any_ok = static_cast<int*>(scratch);
  a.done = static_cast<unsigned int*>(scratch) + R;
  grammar_mask_kernel<<<dim3((V + THREADS - 1) / THREADS, R), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
