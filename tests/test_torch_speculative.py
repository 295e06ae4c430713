"""The port's prompt-lookup drafting against the JAX package's, on the CPU.

``draft_lookup`` and ``acceptance`` take the same int32 inputs, made from
numpy seeds, and must give exactly the JAX functions' outputs: random
histories over small alphabets (plenty of repeated n-grams) for ``ngram``
1 to 3 and ``n_draft`` 1 to 8, and the edge cases of
``tests/test_spec_decode.py``: no match, a history shorter than the
n-gram, a match at position 0, a draft cut by the known region.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import speculative as jspec
from generativeaiexamples_tpu_torch.ops import speculative as tspec


def _both_drafts(hist, lengths, n_draft, ngram):
    h = np.asarray(hist, np.int32)
    n = np.asarray(lengths, np.int32)
    jd, jn = jspec.draft_lookup(jnp.asarray(h), jnp.asarray(n), n_draft,
                                ngram)
    td, tn = tspec.draft_lookup(torch.from_numpy(h), torch.from_numpy(n),
                                n_draft, ngram)
    assert td.dtype == tn.dtype == torch.int32
    return (np.asarray(jd), np.asarray(jn)), (td.numpy(), tn.numpy())


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("n_draft", [1, 4, 8])
def test_draft_lookup_equals_jax(ngram, n_draft):
    rng = np.random.default_rng(100 * ngram + n_draft)
    B, S = 64, 48                # one shape: one JAX compile per case
    hist = rng.integers(0, 5, size=(B, S))
    lengths = rng.integers(0, S, size=B)
    want, got = _both_drafts(hist, lengths, n_draft, ngram)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].max() > 0 and (got[1] == 0).any()


def test_draft_lookup_edge_cases_equal_jax():
    # all 2-grams unique: no match; L = 0 < ngram - 1: too short
    hist = [[5, 6, 7, 8, 9, 0, 0, 0]] * 2
    want, got = _both_drafts(hist, [4, 0], 3, 2)
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[1]) == [0, 0]
    # suffix (1, 2) matches at position 0 only; the draft reads on from 2
    hist = [[1, 2, 3, 4, 1, 2, 0, 0, 0, 0]]
    want, got = _both_drafts(hist, [5], 4, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0] == 4 and list(got[0][0]) == [3, 4, 1, 2]
    # the continuation runs into the current position: the draft is cut
    # to the known region (positions best + ngram .. L)
    hist = [[7, 8, 7, 8, 7, 0, 0, 0]]
    want, got = _both_drafts(hist, [4], 6, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0] == 2 and list(got[0][0][:2]) == [8, 7]   # not 6


def test_acceptance_equals_jax():
    rng = np.random.default_rng(7)
    for W in (1, 2, 3, 5, 9):
        sampled = rng.integers(0, 3, size=(16, W)).astype(np.int32)
        draft = rng.integers(0, 3, size=(16, W - 1)).astype(np.int32)
        dlen = rng.integers(0, W, size=16).astype(np.int32)
        want = jspec.acceptance(jnp.asarray(sampled), jnp.asarray(draft),
                                jnp.asarray(dlen))
        got = tspec.acceptance(torch.from_numpy(sampled),
                               torch.from_numpy(draft), torch.from_numpy(dlen))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the reference's own prefix cases
    sampled = np.array([[2, 3, 9, 8, 7], [9, 3, 4, 5, 6], [2, 3, 9, 8, 7]],
                       np.int32)
    draft = np.array([[2, 3, 4, 5]] * 3, np.int32)
    got = tspec.acceptance(torch.from_numpy(sampled), torch.from_numpy(draft),
                           torch.tensor([4, 4, 2], dtype=torch.int32))
    assert got.tolist() == [3, 1, 3]
