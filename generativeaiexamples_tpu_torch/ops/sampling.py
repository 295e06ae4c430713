"""Per-slot token sampling: greedy, temperature, top-k, top-p.

Port of the per-slot sampler of ``generativeaiexamples_tpu/ops/sampling.py``
(``_mask_dynamic``, ``sample_logits_per_slot``, ``token_logprob``). The
top-k/top-p cutoffs are found by the same bisection with the same
thresholds and tie rules, so the masks equal the TPU package's, and each
sampled row draws ``jax.random.categorical`` with its own raw threefry
key (``ops/threefry.py``), so a seeded request's tokens are the JAX
engine's. Greedy rows are an argmax.

:func:`sample_slots` is what the engine calls, once a sampling call: the
keys folded from each slot's key and counter, every row's live settings,
the cutoffs, the draw and the logprob. On CUDA tensors it is one launch of
the hand-written kernel (``ops/cuda/sampling.py``), on CPU tensors its
plain version :func:`sample_slots_plain`, composed of ``fold_in``,
:func:`_mask_dynamic`, ``categorical``, the greedy select and
:func:`token_logprob`, which computes every row's full path.

Nothing here reads a device value back to the host: which filters any row
uses and whether any row samples are the caller's Python booleans in
:func:`sample_logits_per_slot` (the reference branches with ``lax.cond``
on the device), and each row's own settings in :func:`sample_slots`.

Constrained decoding and top logprobs (the reference's ``grammar_mask``,
``grammar_advance`` and the engine's ``want_top`` rows): a grammared call
first computes each row's allowed set as an ``(R, ceil(V / 32))`` int32
bitmask (:func:`grammar_mask`: the ``grammar_mask`` kernel on the card,
:func:`grammar_mask_plain` packed by :func:`pack_mask` on the CPU), and
:func:`sample_slots` takes it with ``allowed`` and the rows' states with
``mask_states``: masked entries leave the greedy argmax, the cutoffs and
the draw exactly as the reference's ``-inf`` logits do, while the logprob
and the top-K rows (:func:`top_logprobs_plain`) read the raw row. A row
whose state is <= 0 is unconstrained: the sampler ignores its words,
which the kernel leaves unwritten and the plain version fills with ones.
``grammar`` advances each active, constrained slot's DFA state over the
token it drew at w = 0 (:func:`grammar_advance_plain`), in the same
launch on the card.

:func:`stop_suspect_mask` is the multi-step decode's host table of tokens
that may contribute to a stop-string match (numpy, one per stop set).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.ops import threefry
from generativeaiexamples_tpu_torch.ops.cuda import grammar as grammar_kernels
from generativeaiexamples_tpu_torch.ops.cuda import sampling as kernels

N_BISECT = 26   # bisection depth of the top-k/top-p cutoff search
# top-logprob alternatives a row returns (the reference engine's TOP_LP)
TOP_LP = kernels.TOP_LP


def _bisect(pred, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = pred(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def mask_cutoffs(scaled: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, *, any_top_k: bool = True,
                 any_top_p: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's (thr_k, thr_p, cut) of the scaled (B, V) float32 rows:
    the bisected top-k and top-p cutoffs (``lo0`` where a row has no such
    filter) and ``min(max(thr_k, thr_p), m)``, which keeps the row
    maximum (top_p = 0 degrades to greedy). ``any_top_k``/``any_top_p``
    False skips that search (the reference's ``lax.cond``)."""
    need_k = top_k > 0
    need_p = top_p < 1.0
    m = scaled.amax(dim=-1)
    # finite lower bound even with -inf entries (masked tokens)
    lo0 = torch.maximum(scaled.amin(dim=-1), m - 100.0) - 1.0
    k_eff = torch.where(need_k, top_k, torch.ones_like(top_k)).to(torch.int32)

    def k_pred(t):
        return (scaled >= t[:, None]).to(torch.int32).sum(dim=-1) >= k_eff

    thr_k = lo0
    if any_top_k:
        thr_k = torch.where(need_k, _bisect(k_pred, lo0, m + 1.0), lo0)

    e = torch.exp(scaled - m[:, None])
    kmask = scaled >= thr_k[:, None]
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    z = torch.where(kmask, e, zero).sum(dim=-1)
    target = top_p.clamp(0.0, 1.0) * z

    def p_pred(t):
        mass = torch.where(kmask & (scaled >= t[:, None]), e, zero).sum(dim=-1)
        return mass >= target

    thr_p = lo0
    if any_top_p:
        thr_p = torch.where(need_p, _bisect(p_pred, lo0, m + 1.0), lo0)
    return thr_k, thr_p, torch.minimum(torch.maximum(thr_k, thr_p), m)


def _mask_dynamic(lf: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor, *,
                  any_top_k: bool = True,
                  any_top_p: bool = True) -> torch.Tensor:
    """Per-row temperature scaling and top-k/top-p masking by bisected
    cutoff values (no vocab sort). lf: (B, V) float32. Rows with neither
    filter pass through exactly. ``any_top_k``/``any_top_p`` say whether
    some row has ``top_k > 0``/``top_p < 1``; False skips that search (the
    reference's ``lax.cond``), True is always correct."""
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))[:, None]
    scaled = lf / safe_t
    if not (any_top_k or any_top_p):
        return scaled
    _, _, cut = mask_cutoffs(scaled, top_k, top_p, any_top_k=any_top_k,
                             any_top_p=any_top_p)
    out = torch.where(scaled >= cut[:, None], scaled,
                      scaled.new_full((), -torch.inf))
    return torch.where(((top_k > 0) | (top_p < 1.0))[:, None], out, scaled)


def token_logprob(logits: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """Log-probability of each sampled token under the raw logits.
    logits: (B, V); sampled: (B,) → (B,) float32."""
    lf = logits.float()
    picked = lf.gather(-1, sampled.long()[:, None])[:, 0]
    return picked - torch.logsumexp(lf, dim=-1)


def sample_logits_per_slot(keys: torch.Tensor, logits: torch.Tensor,
                           temperature: torch.Tensor, top_k: torch.Tensor,
                           top_p: torch.Tensor, *, any_sampled: bool = True,
                           any_top_k: bool = True,
                           any_top_p: bool = True) -> torch.Tensor:
    """Per-slot sampling with per-slot threefry keys, the ``seed`` surface
    of the serving API: row b draws ``categorical(keys[b], masked row)``
    when ``temperature[b] > 0``, else its argmax.

    keys: (B, 2) int64 raw keys, already folded with the token index by
    the caller; logits: (B, V); temperature/top_k/top_p: (B,).
    ``any_sampled=False`` (no row samples) costs one argmax;
    ``any_top_k``/``any_top_p`` as in :func:`_mask_dynamic`. Returns (B,)
    int32."""
    lf = logits.float()
    greedy = lf.argmax(dim=-1).to(torch.int32)
    if not any_sampled:
        return greedy
    scaled = _mask_dynamic(lf, temperature, top_k, top_p,
                           any_top_k=any_top_k, any_top_p=any_top_p)
    sampled = threefry.categorical(keys, scaled)
    return torch.where(temperature > 0, sampled, greedy)


def _live_rows(W: int, temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, active: torch.Tensor):
    """Each of the B * W rows' settings, slot b's for its W rows, an
    inactive slot's read as greedy with no filter (the reference's
    ``live_*``: a stale setting must not send a dead slot down the
    sampling path)."""
    rep = lambda x: x.repeat_interleave(W)
    return (rep(torch.where(active, temperature,
                            torch.zeros_like(temperature))),
            rep(torch.where(active, top_k, torch.zeros_like(top_k))),
            rep(torch.where(active, top_p, torch.ones_like(top_p))))


def _walk(state: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
          tok_bytes: torch.Tensor, tok_lens: torch.Tensor) -> torch.Tensor:
    """The DFA state each of ``state``'s entries reaches after the bytes of
    token ``ids`` (broadcast together): the reference's chained gathers,
    a byte past a token's length leaving the state as it is."""
    flat = table.reshape(-1)
    st, ids = torch.broadcast_tensors(state.to(torch.int64), ids)
    lens = tok_lens[ids]
    for l in range(tok_bytes.shape[1]):
        nxt = flat[st * table.shape[1] + tok_bytes[ids, l].to(torch.int64)]
        st = torch.where(lens > l, nxt.to(torch.int64), st)
    return st


def grammar_mask_plain(gram_state: torch.Tensor, budget_left: torch.Tensor,
                       eos_id: int, table: torch.Tensor, accept: torch.Tensor,
                       dist: torch.Tensor, tok_bytes: torch.Tensor,
                       tok_lens: torch.Tensor) -> torch.Tensor:
    """Each row's allowed tokens, (R, V) bool, V = ``tok_bytes.shape[0]``:
    the reference's ``grammar_mask`` as a set. A token is allowed when its
    byte walk from the row's state avoids the reject state 0, its length is
    positive and the state it reaches can accept within ``budget_left``
    (``dist``); EOS exactly at accepting states, and also where no token is
    allowed (the fail-safe); a row whose state is <= 0 allows every
    token. gram_state, budget_left (R,) int32; table (S, 256) int32;
    accept (S,) bool; dist (S,) int32; tok_bytes (V, L) int32; tok_lens
    (V,) int32 (-1: never allowed under a grammar)."""
    V = tok_bytes.shape[0]
    state = gram_state.to(torch.int64).clamp_min(0)
    ids = torch.arange(V, device=tok_bytes.device)
    st = _walk(state[:, None], ids[None, :], table, tok_bytes, tok_lens)
    ok = (st != 0) & (tok_lens[None, :] > 0)
    ok &= dist[st] <= budget_left.to(dist.dtype)[:, None]
    ok[:, eos_id] = accept[state] | ~ok.any(dim=-1)
    return ok | (gram_state <= 0)[:, None]


def grammar_advance_plain(gram_state: torch.Tensor, sampled: torch.Tensor,
                          table: torch.Tensor, tok_bytes: torch.Tensor,
                          tok_lens: torch.Tensor) -> torch.Tensor:
    """Each slot's next DFA state after emitting ``sampled`` (B,): the walk
    of that token's bytes; a slot whose state is <= 0 keeps it (the
    reference's ``grammar_advance``). Returns (B,) int32."""
    st = _walk(gram_state.to(torch.int64).clamp_min(0), sampled.long(),
               table, tok_bytes, tok_lens)
    return torch.where(gram_state > 0, st.to(torch.int32), gram_state)


def pack_mask(allowed: torch.Tensor) -> torch.Tensor:
    """(R, V) bool -> the (R, ceil(V / 32)) int32 bitmask the kernels
    take: bit j of word w is entry 32 w + j; bits past V are 0."""
    R, V = allowed.shape
    words = -(-V // 32)
    pad = torch.zeros((R, words * 32), dtype=torch.int64,
                      device=allowed.device)
    pad[:, :V] = allowed.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=allowed.device)
    w = (pad.reshape(R, words, 32) << shifts).sum(dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_mask(bits: torch.Tensor, V: int) -> torch.Tensor:
    """The (R, V) bool set of a :func:`pack_mask` bitmask."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    b = (bits.to(torch.int64)[:, :, None] >> shifts) & 1
    return b.reshape(bits.shape[0], -1)[:, :V].to(torch.bool)


def mask_byte_table(tok_bytes, tok_lens) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The vocabulary's byte table as the ``grammar_mask`` kernel reads
    it: (V, L) uint8 bytes and (V,) int8 lengths, entry for entry the
    int32 table's (``engine/grammar.py`` ``token_byte_table``: bytes
    0..255, lengths -1..L). Raises on a value that does not fit."""
    tb, tl = torch.as_tensor(tok_bytes), torch.as_tensor(tok_lens)
    if tb.numel() and not (0 <= int(tb.min()) and int(tb.max()) <= 255):
        raise ValueError("mask_byte_table: a byte outside 0..255")
    if tl.numel() and not (-1 <= int(tl.min())
                           and int(tl.max()) <= tb.shape[1]):
        raise ValueError(f"mask_byte_table: a length outside -1.."
                         f"{tb.shape[1]}")
    return (tb.to(torch.uint8).contiguous(), tl.to(torch.int8).contiguous())


def stop_suspect_mask(tok_bytes, tok_lens, stop_bytes) -> np.ndarray:
    """(V,) bool host table of the multi-step decode's on-device stop
    maybe-match (the reference's ``stop_suspect_mask``): token ``t`` is
    suspect iff one of its bytes is a byte value of some active stop
    string. Any token that contributes a byte to a match shares that byte,
    so the first contributing token of every possible match is flagged;
    a token that shares a byte without matching only pauses its slot
    early. ``tok_bytes``/``tok_lens`` are the engine's (V, L)/(V,) byte
    table (``EngineCore.ensure_token_bytes``), ``stop_bytes`` a set of
    byte values 0..255. Numpy only."""
    tb = np.asarray(tok_bytes)
    tl = np.asarray(tok_lens)
    if not stop_bytes:
        return np.zeros((tb.shape[0],), np.bool_)
    member = np.isin(tb, np.fromiter(stop_bytes, np.int32, len(stop_bytes)))
    valid = np.arange(tb.shape[1])[None, :] < tl[:, None]
    return np.asarray((member & valid).any(axis=1), np.bool_)


def grammar_mask(gram_state: torch.Tensor, budget_left: torch.Tensor,
                 eos_id: int, table: torch.Tensor, accept: torch.Tensor,
                 dist: torch.Tensor, tok_bytes: torch.Tensor,
                 tok_lens: torch.Tensor) -> torch.Tensor:
    """The allowed set of :func:`grammar_mask_plain` as the (R, ceil(V /
    32)) int32 bitmask :func:`sample_slots` takes with ``mask_states =
    gram_state``: on CUDA tensors one launch of the ``grammar_mask``
    kernel (tok_bytes uint8, tok_lens int8; the words of a row whose
    state is <= 0 are not written, and the result is the wrapper's buffer,
    valid until its next call), on CPU tensors the plain version packed
    (any integer byte table; ones on such a row)."""
    if tok_bytes.is_cuda:
        return grammar_kernels.grammar_mask(gram_state, budget_left, eos_id,
                                            table, accept, dist, tok_bytes,
                                            tok_lens)
    return pack_mask(grammar_mask_plain(gram_state, budget_left, eos_id,
                                        table, accept, dist, tok_bytes,
                                        tok_lens))


def top_logprobs_plain(raw: torch.Tensor, k: int = TOP_LP
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each raw row, (R, k) int32 ids (ties to
    the lower index, as ``jax.lax.top_k``: a stable descending sort) and
    their (R, k) float32 logprobs, value - logsumexp(row)."""
    lf = raw.float()
    vals, ids = torch.sort(lf, dim=-1, descending=True, stable=True)
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    return ids[:, :k].to(torch.int32), vals[:, :k] - lse


def sample_slots_plain(keys: torch.Tensor, counter0: torch.Tensor, W: int,
                       logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       active: torch.Tensor, allowed: Optional[torch.Tensor]
                       = None, grammar: Optional[Sequence[torch.Tensor]]
                       = None, want_top: bool = False, *,
                       mask_states: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The plain version of :func:`sample_slots`: row (b, w) draws under
    ``fold_in(keys[b], counter0[b] + w)`` with slot b's live settings
    through :func:`sample_logits_per_slot` (every row's full path) over
    its ``allowed`` entries (masked ones read as ``-inf``; every entry of
    a row whose ``mask_states`` is <= 0, whatever its words hold: the
    two come together), and
    its token's :func:`token_logprob` under the raw row; with ``grammar``
    the advanced states, with ``want_top`` :func:`top_logprobs_plain` of
    the raw rows."""
    R, V = logits.shape
    pos = torch.arange(W, dtype=torch.int64, device=keys.device)
    row_keys = threefry.fold_in(keys[:, None, :],
                                counter0.to(torch.int64)[:, None]
                                + pos[None]).reshape(R, 2)
    drawn = logits
    if (allowed is None) != (mask_states is None):
        raise ValueError("sample_slots: allowed and mask_states come "
                         "together")
    if allowed is not None:
        keep = unpack_mask(allowed, V) | (mask_states <= 0)[:, None]
        drawn = torch.where(keep, logits.float(),
                            torch.full((), -torch.inf, device=logits.device))
    tokens = sample_logits_per_slot(
        row_keys, drawn, *_live_rows(W, temperature, top_k, top_p, active))
    extra = {}
    if grammar is not None:
        state, table, tok_bytes, tok_lens = grammar
        first = tokens.reshape(-1, W)[:, 0]
        adv = grammar_advance_plain(state, first, table, tok_bytes, tok_lens)
        extra["next_state"] = torch.where(active, adv, state)
    if want_top:
        extra["top_ids"], extra["top_lps"] = top_logprobs_plain(logits)
    return tokens, token_logprob(logits, tokens), extra


def sample_cutoffs_plain(W: int, logits: torch.Tensor,
                         temperature: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """Each row's (thr_k, thr_p, cut) as the plain version finds them,
    (R, 3) float32, NaN on greedy rows: what the kernel's
    ``sample_cutoffs`` is held to."""
    t, k, p = _live_rows(W, temperature, top_k, top_p, active)
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    cuts = torch.stack(mask_cutoffs(logits.float() / safe_t, k, p), dim=1)
    return torch.where((t > 0)[:, None], cuts, cuts.new_full((), torch.nan))


def sample_slots(keys: torch.Tensor, counter0: torch.Tensor, W: int,
                 logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 active: torch.Tensor, allowed: Optional[torch.Tensor] = None,
                 grammar: Optional[Sequence[torch.Tensor]] = None,
                 want_top: bool = False, *,
                 mask_states: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One sampling call of the engine: (R,) int32 tokens, (R,) float32
    logprobs and the options' outputs of the (R = B * W, V) logits, row (b, w) drawn under
    ``fold_in(keys[b], counter0[b] + w)`` with slot b's temperature, top-k
    and top-p (an inactive slot greedy), the reference's
    ``sample_logits_per_slot`` and ``token_logprob``. keys (B, 2) int64;
    counter0 (B,) int32 or int64; temperature, top_p (B,) float32; top_k
    (B,) int32; active (B,) bool. CUDA logits take the kernel (one
    launch), CPU logits the plain version.

    ``allowed``: an (R, ceil(V / 32)) int32 bitmask of :func:`grammar_mask`;
    the draw, the greedy argmax and the cutoffs see only allowed entries.
    ``mask_states``: (R,) int32, the states the mask was made from, given
    with ``allowed``; a row whose state is <= 0 ignores its words.
    ``grammar``: ``(state (B,) int32, table, tok_bytes, tok_lens)``; each
    active slot with a state > 0 walks the token it drew at w = 0.
    ``want_top``: the TOP_LP largest raw entries of each row. The third
    item is a dict of what the options give: ``next_state`` (B,) int32
    with ``grammar``, ``top_ids`` (R, TOP_LP) int32 and ``top_lps``
    (R, TOP_LP) float32 with ``want_top``; empty without either."""
    if not logits.is_cuda:
        return sample_slots_plain(keys, counter0, W, logits, temperature,
                                  top_k, top_p, active, allowed, grammar,
                                  want_top, mask_states=mask_states)
    return kernels.sample_slots(keys, counter0, W, logits, temperature,
                                top_k, top_p, active, allowed, grammar,
                                want_top, mask_states=mask_states)
