// The allowed set of one grammared sampling call: for each constrained row
// of R rows and each of V vocabulary entries, whether the entry may be
// drawn under the row's byte-level DFA state, written into an
// (R, ceil(V / 32)) uint32 bitmask (bit j of word w is entry 32 w + j;
// bits past V are 0).
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
//   rows     a row whose state is <= 0 is unconstrained: every entry is
//            allowed, and its words are NOT written. sample_slots.cu takes
//            the row states beside the mask and skips the mask test on
//            such a row (ops/sampling.py sample_slots_plain does the same).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// generativeaiexamples_tpu/ops/sampling.py grammar_mask (L chained gathers
// over (B, V)), whose -inf logits become the bits sample_slots.cu reads.
// Its plain version is ops/sampling.py grammar_mask_plain (packed by
// pack_mask).
//
// What bounds it: the bytes that must leave memory are the vocabulary's
// byte table, read once for the whole call (tok_bytes as uint8, V x 16 =
// 2.05 MB at V = 128,256, and tok_lens as int8, 0.13 MB), each distinct
// table and dist entry the walks reach (a few thousand), the rows' states
// and budgets, and C x ceil(V / 32) x 4 bytes of mask for the C
// constrained rows: about 0.7 us at R = 8 on the H100, well under the
// fixed cost of one launch. The work is 4 operations a walked byte plus 3
// an (entry, constrained row). In practice the time is latency: a walk is
// a chain of dependent table loads (one a byte, up to 16), served from L2
// or L1, since the walks of one call touch few table entries.
//
// Design: entry-major. A block owns a tile of THREADS consecutive entries,
// one a thread, and loads each entry's 16 bytes once as one 16-byte vector
// and its length once, into registers. The block then stages the call's
// constrained rows (row, state, budget), CHUNK rows at a time, in shared
// memory (a ballot compaction in row order) and walks every one of them
// over its tile, G rows at once a thread: the G walks of one entry share
// its bytes, and their dependent table loads are independent of each
// other, so they overlap. The vocabulary is therefore read once per call
// whatever R is, and an unconstrained row costs its state's load only: no
// walk and no write. Each warp's ballot over 32 consecutive entries is one
// word of a row's mask, written by lane 0. The row's "any entry allowed"
// flag is set by one atomic a block with an allowed entry (the warps'
// findings are ORed in shared memory), unless a read of the flag, issued
// before the walk so that it overlaps it, found it set. Every row's test
// (its dist load) is taken before any store, so the loads of a group
// overlap too. A launch-wide counter, taken
// after a memory fence, marks the last block to finish; that block sets
// or clears the EOS bit of every constrained row from accept[state] and
// the row's flag, and resets the flags and the counter, so the scratch is
// zero again between calls and no call has to clear it.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's grammar
// cases, CUDA-graph replays): 0.0104 to 0.0197 ms a call against 0.0129 to
// 0.0376 for one thread a (row, entry) over every row; an empty launch on
// this grid takes 0.00115. Keeping each row's state and accept flag in
// registers for the EOS pass changed nothing, and the first byte of every
// walk from a shared-memory copy of the start states' rows was 8% slower:
// the time is the walk's chain of dependent loads (up to 16) and the
// launch's own chain (loads, two barriers, the fence, the counter, the
// last block), not the bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // entries a block's tile, one a thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BYTES = 16;   // tok_bytes' columns (MAX_TOKEN_BYTES)
constexpr int G = 8;            // constrained rows a thread walks at once
constexpr int CHUNK = THREADS;  // rows staged in shared memory at a time
constexpr unsigned int FULL = 0xFFFFFFFFu;

struct Args {
  const int* state;             // (R,) flat DFA state, <= 0 unconstrained
  const int* budget;            // (R,) tokens left after this one
  const int* table;             // (S, 256)
  const unsigned char* accept;  // (S,) bool
  const int* dist;              // (S,)
  const uint4* tok_bytes;       // (V,) 16 bytes an entry (uint8 (V, 16))
  const signed char* tok_lens;  // (V,) int8, -1 never allowed
  int R, V, words, eos;
  unsigned int* out;            // (R, words); unconstrained rows untouched
  unsigned int* done;           // (1,) 0 between launches
  int* any_ok;                  // (R,) 0 between launches
};

// byte k (0..15, a constant after unrolling) of an entry's 16 bytes
__device__ __forceinline__ unsigned int byte_of(const uint4& b, int k) {
  const unsigned int w = k < 4 ? b.x : k < 8 ? b.y : k < 12 ? b.z : b.w;
  return (w >> (8 * (k & 3))) & 0xFFu;
}

__global__ void __launch_bounds__(THREADS)
    grammar_mask_kernel(const Args a) {
  __shared__ int srow[CHUNK], sstate[CHUNK], sbudget[CHUNK];
  __shared__ int wcount[WARPS];
  // each warp's rows of a group with an allowed entry, double-buffered by
  // group parity
  __shared__ unsigned int wany[2][WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v = blockIdx.x * THREADS + tid;
  const int word = v >> 5;      // one value across a warp
  uint4 bytes = make_uint4(0u, 0u, 0u, 0u);
  int n = -1;
  if (v < a.V) {
    bytes = __ldg(a.tok_bytes + v);
    n = min((int)a.tok_lens[v], MAX_BYTES);
  }

  for (int c0 = 0; c0 < a.R; c0 += CHUNK) {
    // this chunk's constrained rows, compacted in row order
    const int r = c0 + tid;
    const int s = r < a.R ? a.state[r] : 0;
    const int bud = r < a.R ? a.budget[r] : 0;
    const unsigned int bal = __ballot_sync(FULL, s > 0);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (s > 0) {
      const int at = before + __popc(bal & ((1u << lane) - 1u));
      srow[at] = r;
      sstate[at] = s;
      sbudget[at] = bud;
    }
    __syncthreads();

    for (int j = 0; j < total; j += G) {
      const int m = min(G, total - j);     // rows of this group
      const int par = (j / G) & 1;
      // thread g reads row j + g's flag now, so that the read overlaps the
      // walk (a flag another block sets meanwhile costs one more atomic)
      const int seen = tid < m ? __ldcg(a.any_ok + srow[j + tid]) : 0;
      int st[G];
#pragma unroll
      for (int g = 0; g < G; ++g) st[g] = g < m ? sstate[j + g] : 0;
      // the G walks of this entry, one byte at a time, their loads
      // independent of each other
#pragma unroll
      for (int k = 0; k < MAX_BYTES; ++k) {
        bool live = false;
#pragma unroll
        for (int g = 0; g < G; ++g) live |= st[g] != 0;
        if (k >= n || !live) break;
        const unsigned int b = byte_of(bytes, k);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (st[g] != 0)
            st[g] = __ldg(a.table + (unsigned int)st[g] * 256u + b);
        }
      }
      // every row's test before any store, so the dist loads overlap
      bool ok[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ok[g] = g < m && n > 0 && st[g] != 0
                && __ldg(a.dist + st[g]) <= sbudget[j + g];
      }
      unsigned int rows_any = 0u;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= m) break;                 // m is one value a block
        const unsigned int bits = __ballot_sync(FULL, ok[g]);
        if (lane == 0 && word < a.words)
          a.out[(long long)srow[j + g] * a.words + word] = bits;
        rows_any |= (bits != 0u ? 1u : 0u) << g;
      }
      // one atomic a (block, row) at most: the rows some warp allowed an
      // entry of, unless the flag was seen set
      if (lane == 0) wany[par][warp] = rows_any;
      __syncthreads();
      if (tid < m) {
        unsigned int any = 0u;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) any |= wany[par][w];
        if (((any >> tid) & 1u) && seen == 0)
          atomicOr(a.any_ok + srow[j + tid], 1);
      }
    }
    __syncthreads();            // the staging is rewritten next chunk
  }

  // the writers (lane 0s: the words; warp 0: the flags) fence their
  // writes; then the last block, once every block's words and flags are
  // out, sets each constrained row's EOS bit and resets the scratch for the
  // next call
  if (lane == 0 || warp == 0) __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned int bit = 1u << (a.eos & 31);
  for (int r = tid; r < a.R; r += THREADS) {
    const int s = a.state[r];
    if (s <= 0) continue;
    const bool any = atomicExch(a.any_ok + r, 0) != 0;
    const bool ok_eos = a.accept[s] != 0 || !any;
    unsigned int* w = a.out + (long long)r * a.words + (a.eos >> 5);
    if (ok_eos) {
      atomicOr(w, bit);
    } else {
      atomicAnd(w, ~bit);
    }
  }
  if (tid == 0) *a.done = 0u;
}

__global__ void empty_kernel() {}

}  // namespace

// The allowed set of R rows over V entries: state, budget (R,) int32;
// table (S, 256) int32; accept (S,) bool; dist (S,) int32; tok_bytes
// (V, 16) uint8, 16-byte aligned; tok_lens (V,) int8; eos the EOS id
// (< V). Writes the constrained rows of out (R, ceil(V / 32)) uint32 and
// leaves the others as they are. scratch: 1 + R int32 (the counter, then
// the rows' flags), zero before the first call; every call leaves it
// zero, so one buffer serves calls of any R up to its size. Returns a
// CUDA error code, 0 on success.
extern "C" int gk_grammar_mask(const void* state, const void* budget,
                               const void* table, const void* accept,
                               const void* dist, const void* tok_bytes,
                               const void* tok_lens, int R, int V, int eos,
                               void* out, void* scratch, void* stream) {
  if (R <= 0 || V <= 0 || eos < 0 || eos >= V) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.state = static_cast<const int*>(state);
  a.budget = static_cast<const int*>(budget);
  a.table = static_cast<const int*>(table);
  a.accept = static_cast<const unsigned char*>(accept);
  a.dist = static_cast<const int*>(dist);
  a.tok_bytes = static_cast<const uint4*>(tok_bytes);
  a.tok_lens = static_cast<const signed char*>(tok_lens);
  a.R = R;
  a.V = V;
  a.words = (V + 31) / 32;
  a.eos = eos;
  a.out = static_cast<unsigned int*>(out);
  a.done = static_cast<unsigned int*>(scratch);
  a.any_ok = static_cast<int*>(scratch) + 1;
  grammar_mask_kernel<<<(V + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// An empty kernel on grammar_mask's grid for V entries: the fixed cost of
// one launch of that shape. Returns a CUDA error code, 0 on success.
extern "C" int gk_empty_launch(int V, void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<(V + THREADS - 1) / THREADS, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
