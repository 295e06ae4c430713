"""Port's sampler against the JAX package's on the CPU.

``_mask_dynamic`` runs the same bisection (same depth, thresholds and tie
rules), so the set of surviving tokens must be EQUAL, row by row, for rows
mixing temperature, top-k and top-p, including rows that carry ``-inf``
entries; the scaled values agree to 1e-6 (one f32 division). Greedy picks
are equal. Draws use the same raw threefry keys on both sides, so the
sampled tokens are equal too: the uniforms are bit-equal
(``tests/test_torch_threefry.py``) and only the two float32 logs of the
Gumbel term may differ by ulps, which moves a token only at a near-tie of
a row's top two ``logit + gumbel`` (none at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import sampling as js
from generativeaiexamples_tpu_torch.ops import sampling as ts


def _case():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    logits[2, :40] = -np.inf                    # masked tokens in a row
    temperature = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 50, 1, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.5, 1.0, 0.0], np.float32)
    return logits, temperature, top_k, top_p


def test_mask_dynamic_matches_jax():
    logits, temperature, top_k, top_p = _case()
    want = np.asarray(js._mask_dynamic(
        jnp.asarray(logits), jnp.asarray(temperature), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = ts._mask_dynamic(torch.from_numpy(logits),
                           torch.from_numpy(temperature),
                           torch.from_numpy(top_k),
                           torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    assert np.isfinite(got[1]).sum() == 5       # top-k 5
    assert np.isfinite(got[4]).sum() == 1       # top-k 1
    assert np.isfinite(got[5]).sum() == 1       # top-p 0 degrades to greedy


def test_mask_dynamic_without_filters_passes_through():
    logits, temperature, _, _ = _case()
    got = ts._mask_dynamic(torch.from_numpy(logits),
                           torch.from_numpy(temperature),
                           torch.zeros(6, dtype=torch.int32),
                           torch.ones(6)).numpy()
    want = np.asarray(js._mask_dynamic(
        jnp.asarray(logits), jnp.asarray(temperature),
        jnp.zeros(6, jnp.int32), jnp.ones(6)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _keys(n, seed=0):
    """(n, 2) raw threefry keys, as uint32 for JAX and int64 for the port."""
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(
        jnp.arange(seed, seed + n, dtype=jnp.int32)))
    return keys, torch.from_numpy(keys.astype(np.int64))


def test_greedy_and_logprob_match_jax():
    logits, _, _, _ = _case()
    zeros = np.zeros(6, np.float32)
    jkeys, tkeys = _keys(6)
    want = np.asarray(js.sample_logits_per_slot(
        jnp.asarray(jkeys), jnp.asarray(logits),
        jnp.asarray(zeros), jnp.zeros(6, jnp.int32), jnp.ones(6)))
    for any_sampled in (False, True):
        got = ts.sample_logits_per_slot(
            tkeys, torch.from_numpy(logits), torch.from_numpy(zeros),
            torch.zeros(6, dtype=torch.int32), torch.ones(6),
            any_sampled=any_sampled)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        ts.token_logprob(torch.from_numpy(logits), got).numpy(),
        np.asarray(js.token_logprob(jnp.asarray(logits), jnp.asarray(want))),
        atol=1e-5)


def test_seeded_draw_is_reproducible_and_respects_masks():
    logits, temperature, top_k, top_p = _case()
    args = [torch.from_numpy(a) for a in (logits, temperature, top_k, top_p)]

    def draw(seed):
        return ts.sample_logits_per_slot(_keys(6, seed)[1], *args).numpy()

    a, b = draw(11), draw(11)
    np.testing.assert_array_equal(a, b)
    allowed = np.isfinite(ts._mask_dynamic(*args).numpy())
    assert all(allowed[r, a[r]] for r in range(1, 6))
    assert a[0] == logits[0].argmax()
    draws = np.stack([draw(s) for s in range(40)])
    assert len(set(draws[:, 2].tolist())) > 1     # other keys, other tokens


# (temperature, top_k, top_p) rows: greedy, pure temperature, top-k,
# top-p, both, top-p 0 (greedy by mask), a hot row
MIXES = {
    "mixed_rows": ([0.0, 0.7, 1.0, 0.7, 1.3, 0.9, 2.0],
                   [0, 0, 50, 0, 20, 0, 0],
                   [1.0, 1.0, 1.0, 0.9, 0.8, 0.0, 1.0]),
    "temperature_only": ([0.7] * 7, [0] * 7, [1.0] * 7),
    "top_k_only": ([1.0] * 7, [1, 2, 5, 50, 100, 299, 300], [1.0] * 7),
    "top_p_only": ([0.7] * 7, [0] * 7, [0.1, 0.3, 0.5, 0.7, 0.9, 0.95, 0.99]),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sample_logits_per_slot_matches_jax_with_the_same_keys(mix):
    """Every row's token equals the reference's over 40 key sets (280
    draws a mix): the masks are equal and the draws threefry's. The flags
    the engine passes (any row sampled, top-k, top-p) are taken from the
    rows, and True for every flag gives the same tokens."""
    temperature, top_k, top_p = (np.array(x, dt) for x, dt in zip(
        MIXES[mix], (np.float32, np.int32, np.float32)))
    rng = np.random.default_rng(3)
    for trial in range(40):
        logits = (rng.standard_normal((7, 300)) * 2.5).astype(np.float32)
        logits[trial % 7, :30] = -np.inf
        jkeys, tkeys = _keys(7, 1000 * trial)
        want = np.asarray(js.sample_logits_per_slot(
            jnp.asarray(jkeys), jnp.asarray(logits), jnp.asarray(temperature),
            jnp.asarray(top_k), jnp.asarray(top_p)))
        sampled = temperature > 0
        flags = dict(any_sampled=bool(sampled.any()),
                     any_top_k=bool((sampled & (top_k > 0)).any()),
                     any_top_p=bool((sampled & (top_p < 1)).any()))
        for kw in (flags, {}):
            got = ts.sample_logits_per_slot(
                tkeys, torch.from_numpy(logits), torch.from_numpy(temperature),
                torch.from_numpy(top_k), torch.from_numpy(top_p), **kw)
            np.testing.assert_array_equal(got.numpy(), want)


# the chain server's defaults (server/api.py, chains/basic_rag.py)
SLOT_MIXES = {**MIXES, "chain": ([0.2] * 7, [0] * 7, [0.7] * 7)}
COUNTERS = np.array([0, 1, 17, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 2, 999],
                    np.int64)


def _jax_sample_slots(keys, counter0, W, logits, temperature, top_k, top_p,
                      active):
    """The reference's per-row keys (fold_in of each slot's key by
    counter0 + w, mod 2**32), live settings, sample and logprob."""
    ctr = ((counter0[:, None] + np.arange(W)[None]) % 2 ** 32).reshape(-1)
    row_keys = jax.vmap(jax.random.fold_in)(
        jnp.repeat(jnp.asarray(keys), W, axis=0),
        jnp.asarray(ctr.astype(np.uint32)))

    def live(x, off, dt):
        return jnp.asarray(np.repeat(np.where(active, x, off), W).astype(dt))

    lf = jnp.asarray(logits)
    tokens = js.sample_logits_per_slot(
        row_keys, lf, live(temperature, 0, np.float32),
        live(top_k, 0, np.int32), live(top_p, 1, np.float32))
    return np.asarray(tokens), np.asarray(js.token_logprob(lf, tokens))


@pytest.mark.parametrize("W", [1, 3, 9])
@pytest.mark.parametrize("mix", sorted(SLOT_MIXES))
def test_sample_slots_matches_jax(mix, W):
    temperature, top_k, top_p = (np.array(x, dt) for x, dt in zip(
        SLOT_MIXES[mix], (np.float32, np.int32, np.float32)))
    B = len(temperature)
    rng = np.random.default_rng(W)
    for trial in range(6):
        logits = (rng.standard_normal((B * W, 300)) * 2.5).astype(np.float32)
        logits[(trial * 5) % (B * W), :30] = -np.inf
        # a row spanning more than 100 nats: its lowest entries fall
        # below lo0 and out of every top-p mass
        logits[(trial * 5 + 2) % (B * W), :25] -= 130.0
        active = np.ones(B, bool)
        active[trial % B] = False
        keys = np.asarray(jax.vmap(jax.random.PRNGKey)(
            jnp.arange(B, dtype=jnp.int32) + 100 * trial))
        counter0 = np.roll(COUNTERS, trial)[:B]
        want_tok, want_lp = _jax_sample_slots(
            keys, counter0, W, logits, temperature, top_k, top_p, active)
        got_tok, got_lp, _ = ts.sample_slots(
            torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(counter0), W, torch.from_numpy(logits),
            torch.from_numpy(temperature), torch.from_numpy(top_k),
            torch.from_numpy(top_p), torch.from_numpy(active))
        assert got_tok.dtype == torch.int32 and got_lp.dtype == torch.float32
        np.testing.assert_array_equal(got_tok.numpy(), want_tok)
        np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=1e-5)
        # an inactive slot's rows are greedy whatever its settings
        dead = np.repeat(~active, W)
        np.testing.assert_array_equal(got_tok.numpy()[dead],
                                      logits[dead].argmax(axis=1))


def test_sample_cutoffs_plain_are_the_masks_cutoffs():
    """The cutoffs the kernel is held to on the card are the ones
    ``_mask_dynamic`` cuts at: the surviving set of every filtered row is
    the entries at or above ``cut``, and greedy rows read NaN."""
    logits, temperature, top_k, top_p = _case()
    args = [torch.from_numpy(a) for a in (logits, temperature, top_k, top_p)]
    cuts = ts.sample_cutoffs_plain(1, *args, torch.ones(6, dtype=torch.bool))
    assert torch.isnan(cuts[0]).all()                # greedy row
    masked = ts._mask_dynamic(*args)
    safe_t = torch.where(args[1] > 0, args[1], torch.ones(6))[:, None]
    scaled = args[0] / safe_t
    for r in range(1, 6):
        np.testing.assert_array_equal(
            torch.isfinite(masked[r]).numpy(),
            (scaled[r] >= cuts[r, 2]).numpy())


# ---------------------------------------------------------------- Gemma's V

def test_kernel_size_check_takes_gemmas_vocabulary():
    """The kernel takes Gemma's 256,000 entries and llama3's 128,256 (s
    alone in shared memory, e recomputed), and refuses a vocabulary past
    its limit or rows past its grid."""
    from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
    assert ks.MAX_VOCAB == 256_000
    for R, V, W in ((1, 256_000, 1), (136, 256_000, 8), (72, 128_256, 9)):
        ks.check_size(R, V, W)
    for R, V, W in ((8, 256_001, 1), (137, 1_000, 1), (9, 1_000, 2)):
        with pytest.raises(ValueError, match="the kernel takes"):
            ks.check_size(R, V, W)
    # a block holds its slice's s as f32 (csrc smem), beside the kernel's
    # own 1,024 bytes, within the H100's 232,448 bytes
    shared = lambda V: 4 * ks.slice_entries(V)
    assert shared(128_256) == 4 * 16_032 == 64_128
    assert shared(256_000) == 4 * 32_000 == 128_000
    for V in (1_000, 128_256, 232_000, 256_000):
        assert shared(V) + 1_024 <= 232_448


@pytest.mark.parametrize("mix", ["chain", "mixed_rows"])
def test_sample_slots_matches_jax_at_gemmas_vocabulary(mix):
    """The plain sampler at V = 256,000 against the reference's on the
    same keys and settings: tokens equal, logprobs within 1e-5."""
    temperature, top_k, top_p = (np.array(x, dt) for x, dt in zip(
        SLOT_MIXES[mix], (np.float32, np.int32, np.float32)))
    B, W, V = len(temperature), 1, 256_000
    rng = np.random.default_rng(17)
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    logits[1, :V // 3] = -np.inf
    logits[3, :V // 4] -= 130.0
    active = np.ones(B, bool)
    active[5] = False
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(
        jnp.arange(B, dtype=jnp.int32) + 700))
    counter0 = COUNTERS[:B]
    want_tok, want_lp = _jax_sample_slots(
        keys, counter0, W, logits, temperature, top_k, top_p, active)
    got_tok, got_lp, _ = ts.sample_slots(
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(counter0),
        W, torch.from_numpy(logits), torch.from_numpy(temperature),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(active))
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=1e-5)
    assert (got_tok.numpy() < V).all()
