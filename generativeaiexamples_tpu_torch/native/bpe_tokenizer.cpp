// Byte-level BPE tokenizer core of the PyTorch port, built with the host
// C++ compiler at first use (engine/native_tokenizer.py) and bound with
// ctypes. A copy of the reference's native/bpe_tokenizer.cpp with one
// addition: ``ignore_merges`` (tokenizer.json's model.ignore_merges, set by
// Llama-3): a pre-token that is itself a vocabulary entry is emitted whole
// and the merge loop is skipped for it, as HF tokenizers does.
//
// Split of labor (see engine/native_tokenizer.py):
//   * Python (cold path): parses tokenizer.json, inverts the GPT-2
//     byte<->unicode table so every vocab entry arrives here as RAW BYTES,
//     resolves each merge rule to ids — (left_id, right_id) -> merged_id —
//     detects the pre-tokenization pattern, and builds Unicode letter/number
//     bitsets from unicodedata.
//   * C++ (hot path): UTF-8 scan, pre-tokenization, the whole-piece vocab
//     lookup under ignore_merges, and the BPE merge loop over int32 id
//     sequences (merges are id-pair lookups in one flat hash map).
//
// Two pre-tokenization modes, selected at create time:
//   mode 0 — GPT-2:
//     's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+
//     |\s+(?!\S)|\s+
//   mode 1 — Llama-3:
//     (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}
//     | ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+
// with \p{L}/\p{N} answered by caller-supplied bitsets, so the scanner has
// no Unicode tables of its own.
//
// The merge loop is the heap + doubly-linked-list algorithm (O(n log n) per
// piece): pieces are not bounded, and a long '=====' divider forms one.
//
// Thread-safety: a handle is immutable after bpe_create; encode/decode may
// run concurrently from any number of threads.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  // id -> raw bytes (already unmapped from the GPT-2 unicode alphabet)
  std::vector<std::string> tokens;
  // (left_id << 32 | right_id) -> (rank << 32 | merged_id)
  std::unordered_map<uint64_t, uint64_t> merges;
  // raw bytes -> id of every vocab entry; filled only under ignore_merges
  std::unordered_map<std::string, int32_t> whole;
  bool ignore_merges = false;
  int32_t byte_init[256];      // byte value -> initial token id
  std::vector<uint8_t> letter_bits, number_bits;  // 1 bit per codepoint
  uint32_t max_cp = 0;
  int mode = 0;                // 0 = gpt2, 1 = llama3

  bool is_class(const std::vector<uint8_t>& bits, uint32_t cp) const {
    return cp < max_cp && (bits[cp >> 3] >> (cp & 7)) & 1;
  }
  bool is_letter(uint32_t cp) const { return is_class(letter_bits, cp); }
  bool is_number(uint32_t cp) const { return is_class(number_bits, cp); }
};

// Decode one UTF-8 codepoint at s[i]; advances i. Invalid bytes decode as
// themselves (latin-1 style) so the scanner never stalls on binary input —
// the byte-level alphabet can represent anything.
inline uint32_t next_cp(const uint8_t* s, int len, int& i) {
  uint8_t b = s[i];
  if (b < 0x80) { i += 1; return b; }
  int n = (b >= 0xF0) ? 4 : (b >= 0xE0) ? 3 : (b >= 0xC0) ? 2 : 1;
  if (n == 1 || i + n > len) { i += 1; return b; }
  uint32_t cp = b & (0xFF >> (n + 1));
  for (int k = 1; k < n; ++k) {
    uint8_t c = s[i + k];
    if ((c & 0xC0) != 0x80) { i += 1; return b; }
    cp = (cp << 6) | (c & 0x3F);
  }
  i += n;
  return cp;
}

inline bool is_ws(uint32_t cp) {
  // Rust char::is_whitespace / \s in the tokenizers regex crates:
  // Unicode White_Space property.
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
    case 0x85: case 0xA0: case 0x1680: case 0x2028: case 0x2029: case 0x202F:
    case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

inline bool is_crlf(uint32_t cp) { return cp == '\r' || cp == '\n'; }

struct Piece { int start, end; };  // byte offsets [start, end)

// Try a contraction at s[i] ('s 't 're 've 'm 'll 'd); case-insensitive in
// llama3 mode. Returns byte length (0 = no match).
inline int match_contraction(const uint8_t* s, int len, int i, bool ci) {
  if (s[i] != '\'' || i + 1 >= len) return 0;
  uint8_t a = s[i + 1], b = (i + 2 < len) ? s[i + 2] : 0;
  if (ci) { a |= 0x20; b |= 0x20; }   // ASCII lowercase
  if (a == 's' || a == 't' || a == 'm' || a == 'd') return 2;
  if ((a == 'r' && b == 'e') || (a == 'v' && b == 'e') ||
      (a == 'l' && b == 'l'))
    return 3;
  return 0;
}

// Pre-tokenization over raw bytes. Mirrors the regex alternation order of
// the selected mode; produces byte-offset pieces BPE merges never cross.
void pre_tokenize(const Bpe& bpe, const uint8_t* s, int len,
                  std::vector<Piece>& out) {
  const bool llama = bpe.mode == 1;
  int i = 0;
  while (i < len) {
    int start = i;
    int n = match_contraction(s, len, i, /*ci=*/llama);
    if (n) { out.push_back({start, start + n}); i = start + n; continue; }

    int j = i;
    uint32_t cp = next_cp(s, len, j);

    if (llama) {
      // --- "[^\r\n\p{L}\p{N}]?\p{L}+" --------------------------------
      // optional single leading char that is not CR/LF/letter/number
      {
        int jl = j;
        uint32_t head = cp;
        bool consumed_head = false;
        if (!is_crlf(head) && !bpe.is_letter(head) && !bpe.is_number(head) &&
            jl < len) {
          int k = jl;
          uint32_t c2 = next_cp(s, len, k);
          if (bpe.is_letter(c2)) { consumed_head = true; jl = k; }
        }
        if (bpe.is_letter(head) || consumed_head) {
          while (jl < len) {
            int k = jl;
            uint32_t c = next_cp(s, len, k);
            if (!bpe.is_letter(c)) break;
            jl = k;
          }
          out.push_back({start, jl}); i = jl; continue;
        }
      }
      // --- "\p{N}{1,3}" ----------------------------------------------
      if (bpe.is_number(cp)) {
        int cnt = 1, jn = j;
        while (jn < len && cnt < 3) {
          int k = jn;
          uint32_t c = next_cp(s, len, k);
          if (!bpe.is_number(c)) break;
          jn = k; ++cnt;
        }
        out.push_back({start, jn}); i = jn; continue;
      }
      // --- " ?[^\s\p{L}\p{N}]+[\r\n]*" -------------------------------
      {
        int jp = j;
        uint32_t c0 = cp;
        if (c0 == ' ' && jp < len) {
          int k = jp;
          uint32_t c2 = next_cp(s, len, k);
          if (!is_ws(c2) && !bpe.is_letter(c2) && !bpe.is_number(c2)) {
            c0 = c2; jp = k;
          }
        }
        if (!is_ws(c0) && !bpe.is_letter(c0) && !bpe.is_number(c0)) {
          while (jp < len) {
            int k = jp;
            uint32_t c = next_cp(s, len, k);
            if (is_ws(c) || bpe.is_letter(c) || bpe.is_number(c)) break;
            jp = k;
          }
          while (jp < len && is_crlf(s[jp])) ++jp;   // trailing newlines
          out.push_back({start, jp}); i = jp; continue;
        }
      }
      // --- "\s*[\r\n]+" ----------------------------------------------
      if (is_ws(cp)) {
        // greedy \s* then require >=1 CR/LF, with backtracking: find the
        // last CR/LF inside the maximal \s run reachable from here.
        int run_end = j, last_nl_end = is_crlf(cp) ? j : -1;
        while (run_end < len) {
          int k = run_end;
          uint32_t c = next_cp(s, len, k);
          if (!is_ws(c)) break;
          run_end = k;
          if (is_crlf(c)) last_nl_end = k;
        }
        if (last_nl_end > 0) {
          // trailing [\r\n]+ extends to the last newline in the run; any
          // ws after it belongs to the next alternative's turn
          out.push_back({start, last_nl_end}); i = last_nl_end; continue;
        }
        // fall through to the shared \s+(?!\S)|\s+ handling below, reusing
        // the scan: no newline in the run
        int end = run_end;
        if (run_end < len) {
          // non-space follows: back off one codepoint (the (?!\S))
          // find start of the run's final codepoint
          int prev = start, scan = start;
          while (scan < run_end) { prev = scan; next_cp(s, len, scan); }
          if (prev > start) end = prev;
        }
        out.push_back({start, end});
        i = end;
        continue;
      }
      // unreachable: every codepoint class is covered above
      out.push_back({start, j}); i = j; continue;
    }

    // ------------------------- GPT-2 mode ------------------------------
    // optional single leading space for letter/number/punct alternatives
    if (cp == ' ' && j < len) {
      int j2 = j;
      uint32_t cp2 = next_cp(s, len, j2);
      if (!is_ws(cp2)) { cp = cp2; i = j; j = j2; }
    }
    if (bpe.is_letter(cp)) {                       // " ?\p{L}+"
      while (j < len) {
        int k = j;
        uint32_t c = next_cp(s, len, k);
        if (!bpe.is_letter(c)) break;
        j = k;
      }
      out.push_back({start, j}); i = j; continue;
    }
    if (bpe.is_number(cp)) {                       // " ?\p{N}+"
      while (j < len) {
        int k = j;
        uint32_t c = next_cp(s, len, k);
        if (!bpe.is_number(c)) break;
        j = k;
      }
      out.push_back({start, j}); i = j; continue;
    }
    if (!is_ws(cp)) {                              // " ?[^\s\p{L}\p{N}]+"
      while (j < len) {
        int k = j;
        uint32_t c = next_cp(s, len, k);
        if (is_ws(c) || bpe.is_letter(c) || bpe.is_number(c)) break;
        j = k;
      }
      out.push_back({start, j}); i = j; continue;
    }
    // --- whitespace: "\s+(?!\S)" then "\s+" -----------------------------
    // Greedy run with lookahead backoff: if a non-space follows the run,
    // the (?!\S) lookahead forces backing off exactly one codepoint, which
    // then either prefixes the next piece (a plain space feeds the " ?X"
    // alternatives) or, for any other whitespace char, matches "\s+" alone
    // on the next scanner iteration. A single ' ' before a non-space never
    // reaches here — the " ?X" alternatives above are exhaustive over
    // non-space codepoints and have already absorbed it.
    int run_end = j;        // end of the ws run (j is past the first ws cp)
    int last_ws = start;    // start offset of the run's final ws codepoint
    while (run_end < len) {
      int k = run_end;
      uint32_t c = next_cp(s, len, k);
      if (!is_ws(c)) break;
      last_ws = run_end;
      run_end = k;
    }
    int end = run_end;
    if (run_end < len && last_ws > start)
      end = last_ws;        // non-space follows: back off one codepoint
    out.push_back({start, end});
    i = end;
  }
}

// BPE merge loop for one piece: heap + doubly-linked list, O(n log n).
// Heap entries are validated lazily (stale pairs — whose endpoints were
// consumed by an earlier merge — are skipped on pop).
struct HeapEntry {
  uint32_t rank;
  int32_t pos;               // left index of the pair
  int32_t left_id, right_id; // ids at push time (staleness check)
  bool operator>(const HeapEntry& o) const {
    return rank != o.rank ? rank > o.rank : pos > o.pos;
  }
};

void merge_piece(const Bpe& bpe, std::vector<int32_t>& ids) {
  const int n = (int)ids.size();
  if (n < 2) return;
  std::vector<int32_t> prev(n), next(n);
  for (int k = 0; k < n; ++k) { prev[k] = k - 1; next[k] = k + 1; }
  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>> heap;
  auto push_pair = [&](int l, int r) {
    uint64_t key = (uint64_t)(uint32_t)ids[l] << 32 | (uint32_t)ids[r];
    auto it = bpe.merges.find(key);
    if (it != bpe.merges.end())
      heap.push({(uint32_t)(it->second >> 32), l, ids[l], ids[r]});
  };
  for (int k = 0; k + 1 < n; ++k) push_pair(k, k + 1);

  std::vector<uint8_t> dead(n, 0);
  while (!heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    int l = e.pos;
    if (dead[l] || ids[l] != e.left_id) continue;
    int r = next[l];
    if (r >= n || ids[r] != e.right_id) continue;
    uint64_t key = (uint64_t)(uint32_t)ids[l] << 32 | (uint32_t)ids[r];
    auto it = bpe.merges.find(key);
    if (it == bpe.merges.end() || (uint32_t)(it->second >> 32) != e.rank)
      continue;
    // merge r into l
    ids[l] = (int32_t)(it->second & 0xFFFFFFFFu);
    dead[r] = 1;
    next[l] = next[r];
    if (next[r] < n) prev[next[r]] = l;
    if (prev[l] >= 0) push_pair(prev[l], l);
    if (next[l] < n) push_pair(l, next[l]);
  }
  int out = 0;
  for (int k = 0; k < n; k = next[k]) ids[out++] = ids[k];
  ids.resize(out);
}

}  // namespace

extern "C" {

void* bpe_create(int32_t n_tokens, const int32_t* tok_lens,
                 const uint8_t* tok_bytes, int32_t n_merges,
                 const uint64_t* merge_keys, const int32_t* merge_merged,
                 const int32_t* byte_init, const uint8_t* letter_bits,
                 const uint8_t* number_bits, int32_t bits_len,
                 int32_t mode, int32_t ignore_merges) {
  Bpe* b = new Bpe();
  b->tokens.reserve(n_tokens);
  const uint8_t* p = tok_bytes;
  for (int32_t t = 0; t < n_tokens; ++t) {
    b->tokens.emplace_back(reinterpret_cast<const char*>(p), tok_lens[t]);
    p += tok_lens[t];
  }
  b->merges.reserve((size_t)n_merges * 2);
  for (int32_t m = 0; m < n_merges; ++m)
    b->merges[merge_keys[m]] =
        (uint64_t)(uint32_t)m << 32 | (uint32_t)merge_merged[m];
  std::memcpy(b->byte_init, byte_init, 256 * sizeof(int32_t));
  b->letter_bits.assign(letter_bits, letter_bits + bits_len);
  b->number_bits.assign(number_bits, number_bits + bits_len);
  b->max_cp = (uint32_t)bits_len * 8;
  b->mode = mode;
  b->ignore_merges = ignore_merges != 0;
  if (b->ignore_merges) {
    b->whole.reserve((size_t)n_tokens * 2);
    for (int32_t t = 0; t < n_tokens; ++t)
      if (!b->tokens[t].empty()) b->whole.emplace(b->tokens[t], t);
  }
  return b;
}

void bpe_free(void* h) { delete static_cast<Bpe*>(h); }

// Encode utf8[0..len) -> out (capacity out_cap). Returns the number of ids
// produced; if it exceeds out_cap, nothing past out_cap is written and the
// required count is returned (caller re-calls with a bigger buffer).
int32_t bpe_encode(const void* h, const uint8_t* utf8, int32_t len,
                   int32_t* out, int32_t out_cap) {
  const Bpe& bpe = *static_cast<const Bpe*>(h);
  std::vector<Piece> pieces;
  pieces.reserve(len / 4 + 4);
  pre_tokenize(bpe, utf8, len, pieces);
  int32_t n = 0;
  std::vector<int32_t> ids;
  for (const Piece& pc : pieces) {
    ids.clear();
    if (bpe.ignore_merges) {
      auto it = bpe.whole.find(std::string(
          reinterpret_cast<const char*>(utf8 + pc.start), pc.end - pc.start));
      if (it != bpe.whole.end()) {
        if (n < out_cap) out[n] = it->second;
        ++n;
        continue;
      }
    }
    for (int k = pc.start; k < pc.end; ++k)
      ids.push_back(bpe.byte_init[utf8[k]]);
    merge_piece(bpe, ids);
    for (int32_t id : ids) {
      if (n < out_cap) out[n] = id;
      ++n;
    }
  }
  return n;
}

// Decode ids -> raw bytes. Returns byte count (same overflow contract).
int32_t bpe_decode(const void* h, const int32_t* ids, int32_t n_ids,
                   uint8_t* out, int32_t out_cap) {
  const Bpe& bpe = *static_cast<const Bpe*>(h);
  int32_t n = 0;
  for (int32_t k = 0; k < n_ids; ++k) {
    int32_t id = ids[k];
    if (id < 0 || (size_t)id >= bpe.tokens.size()) continue;
    const std::string& t = bpe.tokens[id];
    for (char c : t) {
      if (n < out_cap) out[n] = (uint8_t)c;
      ++n;
    }
  }
  return n;
}

}  // extern "C"
