"""The port's threefry (``ops/threefry.py``) against ``jax.random`` on the
CPU, with keys and data made from a numpy seed.

* ``prng_key``, ``fold_in``, ``random_bits`` and ``uniform`` are bit-exact
  (integer-equal keys and bits, equal float32 bit patterns), JAX in its
  default partitionable mode, which the tests assert so that a change of
  JAX's mode fails here instead of silently changing the streams.
* ``gumbel`` takes two float32 logs, which XLA and torch round apart by
  up to an ulp each: every Gumbel term is within 4 ulps of the larger of
  its magnitude and 1 (near 0 the inner log's rounding sets its absolute
  error).
* ``categorical`` gives JAX's token in 2,400 draws over rows without and
  with ``-inf`` entries.
* ``sample_slots`` takes its plain version for CPU tensors and counts no
  launch; a row's cluster of blocks covers it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.ops import sampling as ts
from generativeaiexamples_tpu_torch.ops import threefry as tf
from generativeaiexamples_tpu_torch.ops.cuda import sampling as ks
from generativeaiexamples_tpu_torch.ops.cuda.build import launch_counts

SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1, -1, -5, -(2 ** 31)]


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


def _jkey(key):
    return jnp.asarray(np.asarray(key, np.uint32))


def _tkey(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(tf.prng_key(seed).numpy(), want)


def test_prng_key_of_an_int32_array_equals_vmapped_jax():
    seeds = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31, size=64,
                                              dtype=np.int64)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(
        jnp.asarray(seeds.astype(np.int32)))).astype(np.int64)
    np.testing.assert_array_equal(tf.prng_key(torch.from_numpy(seeds)).numpy(),
                                  want)
    with pytest.raises(ValueError, match="int32"):
        tf.prng_key(2 ** 31)
    with pytest.raises(TypeError):
        tf.prng_key(1.5)


def test_fold_in_equals_jax():
    rng = np.random.default_rng(1)
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(
        rng.integers(0, 2 ** 31, size=32).astype(np.int32))))
    data = rng.integers(0, 2 ** 32, size=32, dtype=np.uint64).astype(np.uint32)
    data[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    want = np.asarray(jax.vmap(jax.random.fold_in)(
        jnp.asarray(keys), jnp.asarray(data))).astype(np.int64)
    got = tf.fold_in(_tkey(keys), torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's shapes: (B, 1, 2) keys against (B, W) token indices
    gen = torch.from_numpy(rng.integers(0, 5000, size=(32, 9)))
    wide = tf.fold_in(_tkey(keys)[:, None, :], gen)
    assert wide.shape == (32, 9, 2)
    want = np.asarray(jax.vmap(jax.vmap(jax.random.fold_in, (None, 0)))(
        jnp.asarray(keys), jnp.asarray(gen.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(wide.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_random_bits_equal_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(int(rng.integers(2 ** 31))),
                                 int(rng.integers(10 ** 6)))
        want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        got = tf.random_bits(_tkey(key), n).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (float(np.finfo(np.float32)
                                                         .tiny), 1.0)])
def test_uniform_bit_equal_to_jax(lo, hi):
    rng = np.random.default_rng(2)
    for _ in range(4):
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31)))
        want = np.asarray(jax.random.uniform(key, (5000,), jnp.float32,
                                             lo, hi))
        got = tf.uniform(_tkey(key), 5000, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_within_4_ulp_of_jax():
    rng = np.random.default_rng(3)
    worst = 0.0
    for _ in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(int(rng.integers(2 ** 31))),
                                 int(rng.integers(100)))
        want = np.asarray(jax.random.gumbel(key, (100_000,), jnp.float32))
        got = tf.gumbel(_tkey(key), 100_000).numpy()
        assert np.isfinite(got).all()
        scale = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        worst = max(worst, float((np.abs(got.astype(np.float64) - want)
                                  / scale).max()))
    assert worst <= 4.0


def _categorical_case(trial, masked):
    rng = np.random.default_rng(100 + trial)
    logits = (rng.standard_normal((40, 512)) * 3).astype(np.float32)
    if masked:
        # top-k style masks of 1 to 64 survivors, one all-but-one row
        for r in range(40):
            keep = rng.choice(512, size=1 + (r * 13) % 64, replace=False)
            row = np.full(512, -np.inf, np.float32)
            row[keep] = logits[r, keep]
            logits[r] = row
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(
        rng.integers(0, 2 ** 31, size=40).astype(np.int32))))
    keys = np.asarray(jax.vmap(jax.random.fold_in)(
        jnp.asarray(keys), jnp.asarray(rng.integers(0, 4096, size=40)
                                       .astype(np.uint32))))
    return keys, logits


@pytest.mark.parametrize("masked", [False, True])
def test_categorical_draws_equal_jax(masked):
    """30 trials of 40 rows: 1,200 draws each way, 2,400 over both."""
    for trial in range(30):
        keys, logits = _categorical_case(trial, masked)
        want = np.asarray(jax.vmap(
            lambda k, row: jax.random.categorical(k, row))(
                jnp.asarray(keys), jnp.asarray(logits)))
        got = tf.categorical(_tkey(keys), torch.from_numpy(logits))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if masked:
            assert np.isfinite(logits[np.arange(40), got.numpy()]).all()


def test_categorical_of_an_all_masked_row_is_index_0():
    keys = tf.prng_key(torch.arange(3))
    logits = torch.full((3, 16), -torch.inf)
    assert tf.categorical(keys, logits).tolist() == [0, 0, 0]
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(1),
                                             jnp.full((16,), -jnp.inf)))
    assert int(want) == 0


def test_wrapper_takes_the_plain_version_on_cpu():
    """``ops.sampling.sample_slots`` on CPU tensors is its plain version:
    rows at temperature 1 with no filter (some with -inf entries) draw
    threefry's categorical under their folded keys, and no launch is
    counted. The kernel wrapper refuses CPU tensors."""
    _, logits = _categorical_case(0, True)
    lf = torch.from_numpy(logits)
    base = tf.prng_key(torch.arange(40))
    ctr = torch.arange(40, dtype=torch.int32) * 7
    ones = torch.ones(40)
    args = (base, ctr, 1, lf, ones, torch.zeros(40, dtype=torch.int32),
            ones, torch.ones(40, dtype=torch.bool))
    before = launch_counts()["sample_slots"]
    got, _, _ = ts.sample_slots(*args)
    np.testing.assert_array_equal(
        got.numpy(), tf.categorical(tf.fold_in(base, ctr), lf).numpy())
    assert launch_counts()["sample_slots"] == before
    with pytest.raises(ValueError, match="CUDA"):
        ks.sample_slots(*args)
    with pytest.raises(ValueError):
        tf.categorical(base[:3], lf)
    with pytest.raises(ValueError, match="CUDA"):
        ks.threefry_bits(base, 8)


@pytest.mark.parametrize("rows, vocab", [(1, 300), (8, 128_256),
                                         (72, 128_256), (136, 1000)])
def test_cluster_slices_cover_the_row(rows, vocab):
    n = ks.slice_entries(vocab)
    assert n % 8 == 0 and ks.CLUSTER * n >= vocab > ks.CLUSTER * (n - 8)
    assert 8 * n <= 232_448                    # s and e in shared memory
    assert rows <= ks.MAX_ROWS and vocab <= ks.MAX_VOCAB
