"""Prompt-lookup speculative decoding: n-gram drafting and acceptance.

Port of ``generativeaiexamples_tpu/ops/speculative.py``. The draft model is
the request's own token history: find the latest earlier occurrence of the
current suffix n-gram and propose the tokens that followed it. Both
functions are a handful of (B, S) tensor ops on the device and read
nothing back to the host.

Acceptance is exact-match against the per-position seeded samples of the
verify step (position w of a slot draws with the request's seed folded
with token index ``generated + w``), so the emitted stream is the one
sequential decoding gives; capping a slot's draft length only changes how
many positions are verified, never which token a position resolves to.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draft_lookup(history: torch.Tensor, lengths: torch.Tensor,
                 n_draft: int, ngram: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft up to ``n_draft`` tokens per slot from the slot's own history.

    history: (B, S) int32, valid through index ``lengths[b]`` inclusive
    (``history[b, lengths[b]]`` is the token fed this step). Returns
    (draft (B, n_draft) int32, draft_len (B,) int32): the tokens that
    followed the latest earlier occurrence of the trailing ``ngram``
    (the occurrence ending at the current position is excluded), clipped
    to the known region; draft_len is 0 where the n-gram occurs nowhere
    earlier or the sequence is shorter than it.
    """
    B, S = history.shape
    dev = history.device
    L = lengths.to(torch.int64)
    g_idx = L[:, None] - (ngram - 1) + torch.arange(ngram, device=dev)[None]
    gram = history.gather(1, g_idx.clamp(0, S - 1))
    # candidate start p matches iff history[p + i] == gram[i] for every i
    m = torch.ones((B, S), dtype=torch.bool, device=dev)
    for i in range(ngram):
        m &= torch.roll(history, -i, dims=1) == gram[:, i:i + 1]
    pos = torch.arange(S, device=dev)[None]
    # the occurrence lies wholly before the current suffix, which also
    # rules out the roll's wrap-around
    cand = m & (pos + ngram - 1 <= L[:, None] - 1)
    best = torch.where(cand, pos, torch.full_like(pos, -1)).amax(dim=1)
    found = (best >= 0) & (L >= ngram - 1)
    d_idx = best[:, None] + ngram + torch.arange(n_draft, device=dev)[None]
    draft = history.gather(1, d_idx.clamp(0, S - 1))
    # known continuation: positions best + ngram .. L
    avail = L + 1 - (best + ngram)
    draft_len = torch.where(found, avail.clamp(0, n_draft),
                            torch.zeros_like(avail))
    return draft.to(torch.int32), draft_len.to(torch.int32)


def acceptance(sampled: torch.Tensor, draft: torch.Tensor,
               draft_len: torch.Tensor) -> torch.Tensor:
    """Tokens each slot emits from a W-wide verify step: one plus the
    number of leading drafts (within ``draft_len``) that equal the sample
    at the position before them. sampled: (B, W); draft: (B, W - 1);
    draft_len: (B,). Returns (B,) int32 in 1..W."""
    B, W = sampled.shape
    if W == 1:
        return torch.ones((B,), dtype=torch.int32, device=sampled.device)
    i = torch.arange(W - 1, device=sampled.device)[None]
    ok = (sampled[:, :-1] == draft) & (i < draft_len[:, None])
    k = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return (k + 1).to(torch.int32)
