"""Per-slot token sampling: greedy, temperature, top-k, top-p.

Port of the per-slot sampler of ``generativeaiexamples_tpu/ops/sampling.py``
(``_mask_dynamic``, ``sample_logits_per_slot``, ``token_logprob``). The
top-k/top-p cutoffs are found by the same bisection with the same
thresholds and tie rules, so the masks equal the TPU package's, and each
sampled row draws ``jax.random.categorical`` with its own raw threefry
key (``ops/threefry.py``), so a seeded request's tokens are the JAX
engine's. On CUDA the draw is the hand-written Gumbel-argmax kernel
(``ops/cuda/sampling.py``), on the CPU its plain version. Greedy rows are
an argmax.

Nothing here reads a device value back to the host: which filters any row
uses and whether any row samples are the caller's Python booleans (the
engine knows them from the requests), where the reference branches with
``lax.cond`` on the device.
"""

from __future__ import annotations

import torch

from generativeaiexamples_tpu_torch.ops.cuda.sampling import gumbel_argmax

N_BISECT = 26   # bisection depth of the top-k/top-p cutoff search


def _bisect(pred, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = pred(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


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
    # the row maximum always survives (top_p = 0 degrades to greedy)
    cut = torch.minimum(torch.maximum(thr_k, thr_p), m)[:, None]
    out = torch.where(scaled >= cut, scaled, scaled.new_full((), -torch.inf))
    return torch.where((need_k | need_p)[:, None], out, scaled)


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
    sampled = gumbel_argmax(keys, scaled)
    return torch.where(temperature > 0, sampled, greedy)
