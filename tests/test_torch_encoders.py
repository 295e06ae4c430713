"""The port's BERT encoder, embedder, reranker and micro-batcher against the
JAX package's on the CPU.

Weights come from the JAX package's ``init_params`` (``PRNGKey`` seeds)
and are carried over by ``bert.params_from_jax``; inputs are drawn from a
numpy seed. f32 on both sides, so only the summation order of the
matmuls differs: ``encode``, ``embed`` and ``rank_score`` agree within
1e-5 absolute at the tiny config and at e5-base's width with 2 layers,
the Embedder's and Reranker's outputs too; the reranker's packed arrays
are bit-equal. The HF import is held to ``transformers``' ``BertModel``
as the reference's ``test_bert_hf_parity`` holds its own (2e-4 absolute,
2e-3 relative, on the valid positions).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.encoders import Embedder as JEmbedder
from generativeaiexamples_tpu.encoders import Reranker as JReranker
from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.encoders import (Embedder, MicroBatcher,
                                                     Reranker)
from generativeaiexamples_tpu_torch.models import bert as tb

ATOL = 1e-5


def _cfgs(name):
    if name == "tiny":
        return jb.BertConfig.tiny(), tb.BertConfig.tiny()
    # e5-base's width (768, 12 heads, F 3,072, 512 positions), 2 layers
    return jb.BertConfig(n_layers=2), tb.BertConfig(n_layers=2)


_PARAMS = {}


def _params(name, rank_head=True):
    """(JAX params, the port's) of config ``name``, drawn once."""
    if name not in _PARAMS:
        jcfg, tcfg = _cfgs(name)
        pj = jb.init_params(jax.random.PRNGKey(0), jcfg,
                            with_rank_head=rank_head)
        _PARAMS[name] = (pj, tb.params_from_jax(
            jax.tree_util.tree_map(np.asarray, pj), tcfg))
    return _PARAMS[name]


def _inputs(vocab, B=3, S=19, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 11:] = False
    mask[2, 4:] = False
    types = np.zeros((B, S), np.int32)
    types[:, 7:] = 1
    return tokens, mask, types


# ----------------------------------------------------------------- models/bert

@pytest.mark.parametrize("fn", ["encode", "embed_mean", "embed_cls",
                                "rank_score"])
@pytest.mark.parametrize("name", ["tiny", "e5_width_2_layers"])
def test_bert_matches_jax(name, fn):
    jcfg, tcfg = _cfgs(name)
    pj, pt = _params(name)
    tokens, mask, types = _inputs(jcfg.vocab_size)
    jt, jm, jy = (jnp.asarray(a) for a in (tokens, mask, types))
    tt, tm, ty = (torch.from_numpy(a) for a in (tokens, mask, types))
    if fn == "encode":
        want = np.asarray(jb.encode(pj, jcfg, jt, jm, jy))[mask]
        got = tb.encode(pt, tcfg, tt, tm, ty).numpy()[mask]
    elif fn == "rank_score":
        want = np.asarray(jb.rank_score(pj, jcfg, jt, jm, jy))
        got = tb.rank_score(pt, tcfg, tt, tm, ty).numpy()
    else:
        pooling = fn.split("_")[1]
        jcfg = dataclasses.replace(jcfg, pooling=pooling)
        tcfg = dataclasses.replace(tcfg, pooling=pooling)
        want = np.asarray(jb.embed(pj, jcfg, jt, jm))
        got = tb.embed(pt, tcfg, tt, tm).numpy()
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bert_params_layout_and_init():
    cfg = tb.BertConfig.tiny()
    p = tb.init_params(torch.Generator().manual_seed(0), cfg,
                       with_rank_head=True)
    layer = p["layers"][0]
    assert layer["w_up"].shape == (cfg.hidden_dim, cfg.dim)
    assert layer["w_down"].shape == (cfg.dim, cfg.hidden_dim)
    assert p["rank_head"]["w"].shape == (1, cfg.dim)
    assert len(p["layers"]) == cfg.n_layers
    again = tb.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["layers"][1]["wo"], p["layers"][1]["wo"])
    assert "rank_head" not in again
    assert tb.BertConfig.e5_base() == tb.BertConfig(
        vocab_size=30522, dim=768, n_layers=12, n_heads=12, hidden_dim=3072,
        max_positions=512)


def test_bert_params_from_hf_matches_transformers():
    """Mirror of the reference's ``test_bert_hf_parity``, and the import
    equal to the JAX package's ``params_from_hf``."""
    pytest.importorskip("transformers")
    from transformers import BertConfig as HFConfig, BertModel

    hf_cfg = HFConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, type_vocab_size=2,
                      layer_norm_eps=1e-12, hidden_act="gelu")
    torch.manual_seed(0)
    hf = BertModel(hf_cfg).eval()
    kw = dict(vocab_size=120, dim=32, n_layers=2, n_heads=2, hidden_dim=64,
              max_positions=64)
    cfg = tb.BertConfig(**kw)
    params = tb.params_from_hf(hf.state_dict(), cfg)
    ids = np.array([[2, 5, 9, 14, 77, 3]], dtype=np.int64)
    mask = np.array([[1, 1, 1, 1, 0, 0]], dtype=np.int64)
    with torch.no_grad():
        hf_out = hf(torch.tensor(ids),
                    attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    ours = tb.encode(params, cfg, torch.tensor(ids),
                     torch.tensor(mask).bool()).numpy()
    # HF computes positions for padded slots too; compare valid positions
    np.testing.assert_allclose(ours[:, :4], hf_out[:, :4], atol=2e-4,
                               rtol=2e-3)
    jcfg = jb.BertConfig(**kw)
    jparams = jb.params_from_hf(hf.state_dict(), jcfg)
    want = np.asarray(jb.encode(jparams, jcfg, jnp.asarray(ids, jnp.int32),
                                jnp.asarray(mask, bool)))
    np.testing.assert_allclose(ours[:, :4], want[:, :4], atol=ATOL)


# -------------------------------------------------------------------- encoders

def _embedders(max_batch, max_len=512):
    je = JEmbedder(max_batch=max_batch, max_len=max_len)
    te = Embedder(cfg=tb.BertConfig.tiny(), params=tb.params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params), tb.BertConfig.tiny()),
        max_batch=max_batch, max_len=max_len, device="cpu")
    return je, te


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = ["tensor", "page", "cache", "query", "token", "kernel", "store",
             "vector", "rank", "passage", "é", "ü"]
    return [" ".join(rng.choice(words, int(rng.integers(1, 30))))
            for _ in range(n)]


@pytest.mark.parametrize("max_batch,n,max_len", [(32, 3, 512), (4, 11, 512),
                                                 (2, 5, 16)])
def test_embedder_matches_jax(max_batch, n, max_len):
    """Across batch buckets (8 capped at max_batch), length buckets (8 to
    max_len, texts cut at max_len) and more texts than one batch."""
    je, te = _embedders(max_batch, max_len)
    texts = _texts(n)
    for fn in ("embed_documents", "embed_queries"):
        want = getattr(je, fn)(texts)
        got = getattr(te, fn)(texts)
        assert got.shape == (n, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)
    for t in texts[:2]:
        np.testing.assert_array_equal(te._batchify([t])[0],
                                      je._batchify([t])[0])
        np.testing.assert_array_equal(te._batchify([t])[1],
                                      je._batchify([t])[1])


def test_embedder_shapes_and_normalization():
    """Mirror of the reference's case of the same name."""
    e = Embedder(cfg=tb.BertConfig.tiny(), device="cpu")
    vecs = e.embed_documents(["short", "a slightly longer passage of text",
                              "third"])
    assert vecs.shape == (3, e.dim)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    # query/passage prefixes must differ
    q = e.embed_queries(["short"])
    assert not np.allclose(q[0], vecs[0])
    assert e.embed_documents([]).shape == (0, e.dim)


def test_embedder_batching_consistency():
    """Mirror of the reference's case of the same name."""
    e = Embedder(cfg=tb.BertConfig.tiny(), max_batch=2, device="cpu")
    texts = [f"text number {i}" for i in range(5)]
    batched = e.embed_documents(texts)
    single = np.concatenate([e.embed_documents([t]) for t in texts])
    np.testing.assert_allclose(batched, single, atol=1e-4)


def test_embedder_counts_after_the_fetch(monkeypatch):
    e = Embedder(cfg=tb.BertConfig.tiny(), max_batch=2, device="cpu")
    counter = REGISTRY.counter("embeddings_computed")
    before = counter.value
    e.embed_documents(["a", "b", "c"])
    assert counter.value == before + 3

    def broken(*args, **kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tb, "embed", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        e.embed_documents(["a", "b", "c"])
    assert counter.value == before + 3


def _rerankers(max_batch, max_len=512):
    jr = JReranker(max_batch=max_batch, max_len=max_len)
    tr = Reranker(cfg=tb.BertConfig.tiny(), params=tb.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jr.params), tb.BertConfig.tiny()),
        max_batch=max_batch, max_len=max_len, device="cpu")
    return jr, tr


def _pairs():
    texts = _texts(12, seed=3)
    long_q = "why " * 40                          # past max_len // 2
    return ([("what is a page", t) for t in texts[:5]]
            + [(long_q, t) for t in texts[5:9]]
            + [("q", "passage " * 30), ("ü?", texts[9])])


@pytest.mark.parametrize("max_batch,max_len", [(64, 512), (4, 64)])
def test_reranker_matches_jax(max_batch, max_len):
    jr, tr = _rerankers(max_batch, max_len)
    pairs = _pairs()
    for i in range(0, len(pairs), max_batch):
        chunk = pairs[i:i + max_batch]
        for a, b in zip(tr._pack_pairs(chunk), jr._pack_pairs(chunk)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    want = jr._score_pairs(pairs)
    got = tr._score_pairs(pairs)
    assert got.shape == (len(pairs),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    passages = [p for _, p in pairs]
    assert ([i for i, _ in tr.rerank("what is a page", passages, top_n=5)]
            == [i for i, _ in jr.rerank("what is a page", passages,
                                        top_n=5)])


def test_reranker_orders_and_scores():
    """Mirror of the reference's case of the same name."""
    r = Reranker(cfg=tb.BertConfig.tiny(), device="cpu")
    passages = [f"passage {i} about topic {i % 3}" for i in range(10)]
    ranked = r.rerank("what is topic 1", passages, top_n=4)
    assert len(ranked) == 4
    scores = [s for _, s in ranked]
    assert scores == sorted(scores, reverse=True)
    # scoring must be batch-size invariant
    s_all = r.score("q", passages)
    s_two = np.concatenate([r.score("q", passages[:6]),
                            r.score("q", passages[6:])])
    np.testing.assert_allclose(s_all, s_two, atol=1e-4)
    assert r.rerank("q", [], top_n=4) == []


@pytest.mark.parametrize("cls", [Embedder, Reranker])
def test_micro_batched_encoder_matches_plain(cls):
    """With the window on, concurrent callers coalesce into shared
    dispatches and each gets its own rows back."""
    enc = cls(cfg=tb.BertConfig.tiny(), device="cpu", micro_window_s=0.2)
    plain = cls(cfg=tb.BertConfig.tiny(), params=enc.params, device="cpu")
    name = "embed" if cls is Embedder else "rerank"
    texts = _texts(8, seed=5)

    def call(e, t):
        return (e.embed_documents([t]) if cls is Embedder
                else e.score("which page", [t, t + " again"]))

    dispatches = REGISTRY.counter(f"{name}_dispatches")
    before = dispatches.value
    out = [None] * len(texts)
    barrier = threading.Barrier(len(texts))

    def worker(i):
        barrier.wait()
        out[i] = call(enc, texts[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(texts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert dispatches.value - before < len(texts)
        for i, t in enumerate(texts):
            np.testing.assert_allclose(out[i], call(plain, t), atol=1e-4)
    finally:
        enc.close()


# ------------------------------------------------------------------ microbatch

class _Gate:
    """A dispatch that records its batches and can be held or made to
    fail."""

    def __init__(self):
        self.batches = []
        self.hold = threading.Event()
        self.hold.set()
        self.started = threading.Event()
        self.fail = None

    def __call__(self, items):
        self.started.set()
        assert self.hold.wait(timeout=30)
        self.batches.append(list(items))
        if self.fail is not None and self.fail in items:
            raise ValueError(f"bad item {self.fail}")
        return [x * 10 for x in items]


def _submit_all(mb, subs):
    out = [None] * len(subs)

    def run(i):
        try:
            out[i] = mb.submit(subs[i])
        except Exception as exc:   # the test reads it
            out[i] = exc

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(subs))]
    for t in threads:
        t.start()
    return threads, out


def _join(threads):
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_microbatcher_coalesces_and_routes_back():
    gate = _Gate()
    mb = MicroBatcher(gate, max_items=64, window_s=0.2, name="mbtest")
    try:
        subs = [[i, i + 100] for i in range(6)] + [[7]]
        threads, out = _submit_all(mb, subs)
        _join(threads)
        assert len(gate.batches) < len(subs)
        for s, got in zip(subs, out):
            assert list(got) == [x * 10 for x in s]
        hist = REGISTRY.histogram("mbtest_batch_requests")
        assert hist.count == len(gate.batches)
        assert mb.submit([]) == []
    finally:
        mb.close()


def test_microbatcher_closes_early_and_never_splits():
    """The window closes as soon as max_items fill; a submission larger
    than the rest of the batch waits for the next dispatch whole."""
    gate = _Gate()
    mb = MicroBatcher(gate, max_items=4, window_s=5.0, name="mbsplit")
    try:
        t0 = time.perf_counter()
        assert list(mb.submit([1, 2, 3, 4])) == [10, 20, 30, 40]
        assert time.perf_counter() - t0 < 2.0      # not the 5 s window
        assert list(mb.submit([1, 2, 3, 4, 5, 6])) == [10, 20, 30, 40, 50,
                                                       60]
        assert gate.batches[-1] == [1, 2, 3, 4, 5, 6]
    finally:
        mb.close()


def test_microbatcher_failure_reaches_the_batch_and_worker_serves_on():
    gate = _Gate()
    gate.fail = 13
    mb = MicroBatcher(gate, max_items=64, window_s=0.2, name="mbfail")
    try:
        threads, out = _submit_all(mb, [[1], [13], [2]])
        _join(threads)
        assert len(gate.batches) == 1
        assert all(isinstance(o, ValueError) for o in out)
        gate.fail = None
        assert list(mb.submit([5])) == [50]
    finally:
        mb.close()


def test_microbatcher_wrong_result_count_is_an_error():
    mb = MicroBatcher(lambda items: [0], max_items=8, window_s=0.0,
                      name="mbcount")
    try:
        with pytest.raises(RuntimeError, match="returned 1 results for 2"):
            mb.submit([1, 2])
    finally:
        mb.close()


def test_microbatcher_close_drains_the_queue():
    gate = _Gate()
    gate.hold.clear()
    mb = MicroBatcher(gate, max_items=1, window_s=0.0, name="mbclose")
    threads, out = _submit_all(mb, [[1]])
    assert gate.started.wait(timeout=10)        # [1] is in flight
    more, more_out = _submit_all(mb, [[2], [3]])
    deadline = time.time() + 10
    while len(mb._queue) < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert len(mb._queue) == 2
    closer = threading.Thread(target=mb.close)
    closer.start()
    _join(more)
    assert all(isinstance(o, RuntimeError) and "closed" in str(o)
               for o in more_out)
    gate.hold.set()                             # the in-flight batch ends
    _join(threads + [closer])
    assert list(out[0]) == [10]
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([4])


def test_microbatcher_pushes_back_at_max_queue():
    gate = _Gate()
    gate.hold.clear()
    mb = MicroBatcher(gate, max_items=1, window_s=0.0, max_queue=2,
                      name="mbqueue")
    try:
        first, _ = _submit_all(mb, [[0]])
        assert gate.started.wait(timeout=10)    # the worker holds [0]
        threads, out = _submit_all(mb, [[1], [2], [3], [4]])
        deadline = time.time() + 10
        while len(mb._queue) < 2 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert len(mb._queue) == 2              # two callers wait outside
        assert sum(o is None for o in out) == 4
        gate.hold.set()
        _join(first + threads)
        assert sorted(list(o)[0] for o in out) == [10, 20, 30, 40]
    finally:
        mb.close()


# --------------------------------------------------------------------- devices

@pytest.mark.parametrize("cls", [Embedder, Reranker])
def test_encoders_refuse_cpu_fallback(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(cfg=tb.BertConfig.tiny())
    enc = cls(cfg=tb.BertConfig.tiny(), device="cpu")
    assert enc.device.type == "cpu" and enc.cfg.dtype == "float32"
    bf = cls(cfg=tb.BertConfig.tiny(), device="cpu", dtype=torch.bfloat16)
    assert bf.params["layers"][0]["wq"].dtype == torch.bfloat16
