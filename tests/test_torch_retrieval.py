"""The port's retrieval core against the JAX package's on the CPU: the
vector store (exact and IVF), BM25 with reciprocal-rank fusion, the token
splitter, the IVF microbenchmark and the retrieval config sections.

Inputs come from numpy seeds and go through both packages. Store results
match as (content, score) lists: the same documents in the same order,
scores within 1e-6 (f32 dot products of unit vectors, another summation
order). On well-separated data the IVF build assigns every row to the
same cell as the reference's and its centroids agree within 1e-6. BM25,
fusion and the splitter are pure Python copies: their outputs are equal.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core import config as jconfig
from generativeaiexamples_tpu.retrieval import bench_ivf as jbench
from generativeaiexamples_tpu.retrieval import (BM25Index as JBM25,
                                                Document as JDocument,
                                                TokenTextSplitter as JSplitter,
                                                VectorStore as JStore)
from generativeaiexamples_tpu.retrieval.bm25 import \
    reciprocal_rank_fusion as j_rrf
from generativeaiexamples_tpu_torch.core import config as tconfig
from generativeaiexamples_tpu_torch.retrieval import (BM25Index, Document,
                                                      TokenTextSplitter,
                                                      VectorStore)
from generativeaiexamples_tpu_torch.retrieval import bench_ivf
from generativeaiexamples_tpu_torch.retrieval.bm25 import \
    reciprocal_rank_fusion

SCORE_ATOL = 1e-6


def _random_embeddings(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(dim, **kw):
    return JStore(dim=dim, **kw), VectorStore(dim=dim, device="cpu", **kw)


def _add_both(stores, contents, emb, sources=None):
    j, t = stores
    meta = [{"source": s} for s in sources] if sources else [{}] * len(contents)
    j.add([JDocument(content=c, metadata=dict(m))
           for c, m in zip(contents, meta)], emb)
    t.add([Document(content=c, metadata=dict(m))
           for c, m in zip(contents, meta)], emb)


def _same_hits(stores, q, **kw):
    j, t = stores
    want = [(d.content, s) for d, s in j.search(q, **kw)]
    got = [(d.content, s) for d, s in t.search(q, **kw)]
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=SCORE_ATOL)
    return got


# ------------------------------------------------------------------- store

def test_vector_store_exact_search_and_threshold():
    """Mirror of the reference's case of the same name."""
    dim = 16
    stores = _pair(dim)
    emb = _random_embeddings(50, dim)
    _add_both(stores, [f"doc{i}" for i in range(50)], emb,
              [f"f{i % 5}.txt" for i in range(50)])
    hits = _same_hits(stores, emb[7], top_k=3)
    assert hits[0][0] == "doc7"
    assert hits[0][1] > 0.99  # self-match relevance ~ 1
    # threshold filters
    assert stores[1].search(emb[7], top_k=3, score_threshold=1.1) == []
    _same_hits(stores, emb[9], top_k=10, score_threshold=0.55)
    assert stores[1].search(emb[0], top_k=1000)     # k capped at capacity
    _same_hits(stores, emb[0], top_k=1000)


def test_vector_store_delete_and_sources():
    """Mirror of the reference's case of the same name."""
    dim = 8
    stores = _pair(dim)
    emb = _random_embeddings(20, dim)
    _add_both(stores, [f"d{i}" for i in range(20)], emb,
              [f"s{i % 2}.pdf" for i in range(20)])
    store = stores[1]
    assert sorted(store.list_sources()) == ["s0.pdf", "s1.pdf"]
    assert store.list_sources() == stores[0].list_sources()
    assert store.delete_by_source(["s0.pdf"]) == 10
    stores[0].delete_by_source(["s0.pdf"])
    assert len(store) == 10
    hits = store.search(emb[0], top_k=20)
    assert all(int(c[1:]) % 2 == 1 for c in (d.content for d, _ in hits))
    _same_hits(stores, emb[0], top_k=20)


def test_vector_store_growth_past_capacity():
    """Mirror of the reference's case of the same name: the growth keeps
    the rows on the device."""
    dim = 8
    stores = _pair(dim)
    emb = _random_embeddings(600, dim)  # > initial 256 capacity
    _add_both(stores, [f"d{i}" for i in range(100)], emb[:100])
    assert stores[1]._capacity == 256
    _add_both(stores, [f"d{i}" for i in range(100, 600)], emb[100:])
    assert stores[1]._capacity == 1024
    hits = _same_hits(stores, emb[450], top_k=1)
    assert hits[0][0] == "d450"
    _same_hits(stores, emb[30], top_k=7)
    assert stores[1].nbytes == 1024 * dim * 4


def test_ivf_matches_exact_for_easy_queries():
    """Mirror of the reference's case of the same name, each store's hits
    equal to the JAX store's."""
    dim, n = 32, 1024
    emb = _random_embeddings(n, dim, seed=3)
    exact = _pair(dim, index_type="exact")
    ivf = _pair(dim, index_type="ivf", nlist=16, nprobe=8)
    names = [f"d{i}" for i in range(n)]
    _add_both(exact, names, emb)
    _add_both(ivf, names, emb)
    agree = 0
    for q in range(0, 100, 10):
        e_top = _same_hits(exact, emb[q], top_k=1)[0][0]
        i_top = _same_hits(ivf, emb[q], top_k=5)
        if i_top and i_top[0][0] == e_top:
            agree += 1
    assert agree >= 8  # self-queries: probed cell contains the vector


def test_ivf_incremental_add_and_delete_mask():
    """Mirror of the reference's case of the same name: adds after the
    first build assign to existing centroids (no retrain below the 2x
    threshold) and are findable; deleted rows never surface."""
    dim = 32
    stores = _pair(dim, index_type="ivf", nlist=8, nprobe=8)
    ivf = stores[1]
    emb = _random_embeddings(512, dim, seed=5)
    _add_both(stores, [f"a{i}" for i in range(512)], emb, ["a.txt"] * 512)
    _same_hits(stores, emb[0], top_k=1)          # triggers training build
    trained_n = ivf._ivf_trained_n
    extra = _random_embeddings(100, dim, seed=6)
    _add_both(stores, [f"b{i}" for i in range(100)], extra, ["b.txt"] * 100)
    hits = _same_hits(stores, extra[42], top_k=1)
    assert hits and hits[0][0] == "b42"
    assert ivf._ivf_trained_n == trained_n  # assign-only, no retrain
    np.testing.assert_array_equal(ivf._cell_fill, stores[0]._cell_fill)
    for s in stores:
        s.delete_by_source(["b.txt"])
    hits = _same_hits(stores, extra[42], top_k=5)
    assert all(c.startswith("a") for c, _ in hits)


def test_ivf_build_equals_the_reference_on_separated_data():
    """Well-separated clusters: the same k-means seeds (default_rng(0)),
    every row in the reference's cell at the reference's slot, centroids
    within 1e-6; the retrain at 2x gives the same again."""
    dim, nlist, per = 24, 8, 40
    rng = np.random.default_rng(7)
    modes = np.eye(dim, dtype=np.float32)[:nlist] * 5.0
    emb = np.concatenate([modes[c] + 0.05 * rng.standard_normal(
        (per, dim)).astype(np.float32) for c in range(nlist)])
    emb = emb[rng.permutation(len(emb))]
    stores = _pair(dim, index_type="ivf", nlist=nlist, nprobe=2)
    _add_both(stores, [f"r{i}" for i in range(len(emb))], emb)
    for step in range(2):
        _same_hits(stores, emb[3], top_k=4)
        j, t = stores
        np.testing.assert_allclose(t._centroids.numpy(),
                                   np.asarray(j._centroids), atol=1e-6)
        np.testing.assert_array_equal(t._grouped_ids.numpy(),
                                      np.asarray(j._grouped_ids))
        np.testing.assert_allclose(t._grouped.numpy(),
                                   np.asarray(j._grouped), atol=0)
        assert t._ivf_trained_n == j._ivf_trained_n
        more = emb + 0.01 * rng.standard_normal(emb.shape).astype(np.float32)
        _add_both(stores, [f"m{step}_{i}" for i in range(len(more))], more)


def test_store_snapshot_holds_under_concurrent_adds():
    """Searches racing adds (exact and IVF) each see a consistent state:
    every hit is a live document whose score is its vector's cosine with
    the query, and a query for a row present before the race always finds
    it first. Adds write new tensors; a search's snapshot is never
    written."""
    import sys
    dim = 16
    emb = _random_embeddings(2000, dim, seed=11)
    by_name = {f"d{i}": emb[i] for i in range(len(emb))}
    for index_type in ("exact", "ivf"):
        store = VectorStore(dim, index_type=index_type, nlist=4, nprobe=4,
                            device="cpu")
        store.add([Document(content=f"d{i}") for i in range(300)], emb[:300])
        errors = []
        stop = threading.Event()

        def search_loop():
            rng = np.random.default_rng(threading.get_ident() % 1000)
            while not stop.is_set():
                i = int(rng.integers(0, 300))
                hits = store.search(emb[i], top_k=5)
                if not hits or hits[0][0].content != f"d{i}":
                    errors.append(("self", i, hits[:1]))
                for d, s in hits:
                    want = (float(by_name[d.content] @ emb[i]) + 1) / 2
                    if abs(s - want) > 1e-5:
                        errors.append(("score", d.content, s, want))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=search_loop) for _ in range(4)]
        try:
            for t in threads:
                t.start()
            for s in range(300, 2000, 100):
                store.add([Document(content=f"d{i}")
                           for i in range(s, s + 100)], emb[s:s + 100])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:5]
        assert len(store) == 2000
        assert store.search(emb[1999], top_k=1)[0][0].content == "d1999"


def test_vector_store_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorStore(dim=8)
    assert VectorStore(dim=8, device="cpu").search(np.ones(8)) == []


# ----------------------------------------------------------- bm25/splitter

def test_bm25_ranks_matching_docs():
    """Mirror of the reference's case of the same name, and every search
    equal to the reference's."""
    texts = ["the cat sat on the mat", "dogs chase cats in the yard",
             "quantum computing with superconducting qubits",
             "the quantum cat", "Cats, dogs; and the MAT."]
    idx, ref = BM25Index(), JBM25()
    idx.add(texts[:3])
    ref.add(texts[:3])
    hits = idx.search("quantum qubits", top_k=2)
    assert hits and hits[0][0] == 2
    idx.add(texts[3:])
    ref.add(texts[3:])
    for q in ("quantum qubits", "the cat", "mat dogs", "nothing here", ""):
        for k in (1, 3, 10):
            assert idx.search(q, top_k=k) == ref.search(q, top_k=k)
    assert BM25Index().search("cat") == []


def test_rrf_fuses_rankings():
    """Mirror of the reference's case of the same name."""
    fused = reciprocal_rank_fusion([[1, 2, 3], [3, 1, 9]], top_k=2)
    assert fused[0] == 1 or fused[0] == 3
    assert len(fused) == 2
    rng = np.random.default_rng(2)
    rankings = [list(rng.permutation(20)[:8]) for _ in range(3)]
    for k in (1, 5, 30):
        assert reciprocal_rank_fusion(rankings, top_k=k) == j_rrf(rankings,
                                                                  top_k=k)


def test_splitter_chunk_and_overlap():
    """Mirror of the reference's case of the same name, and the chunks
    equal to the reference's."""
    sp = TokenTextSplitter(chunk_size=50, chunk_overlap=10)
    text = " ".join(f"word{i}" for i in range(100)) + ".\n\n" + \
        " ".join(f"tail{i}" for i in range(50)) + "."
    chunks = sp.split(text)
    assert len(chunks) >= 2
    for c in chunks:
        assert len(sp.tokenizer.encode(c)) <= 60  # size + boundary slack
    assert sp.split("") == []
    assert sp.split("tiny") == ["tiny"]
    with pytest.raises(ValueError):
        TokenTextSplitter(chunk_size=10, chunk_overlap=10)
    ref = JSplitter(chunk_size=50, chunk_overlap=10)
    assert chunks == ref.split(text)
    prose = ("One sentence here. Another follows! A third? " * 30
             + "\n\n" + "x" * 300 + "\n\nüñí " * 40)
    for size, overlap in ((50, 10), (510, 200), (64, 0)):
        assert (TokenTextSplitter(size, overlap).split(prose)
                == JSplitter(size, overlap).split(prose))


# ------------------------------------------------------------- bench, config

def test_bench_ivf_matches_the_reference():
    """The microbenchmark at a small size: the same corpus and queries, so
    the same recall and rows scanned as the reference's."""
    kw = dict(n=6000, dim=32, nlist=32, nprobe=4, queries=8, top_k=10)
    got = bench_ivf.run(device="cpu", **kw)
    import contextlib
    import io
    import json
    import sys
    argv = sys.argv
    sys.argv = ["bench_ivf", "--n", "6000", "--dim", "32", "--nlist", "32",
                "--nprobe", "4", "--queries", "8"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jbench.main()
    finally:
        sys.argv = argv
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("n", "dim", "nlist", "nprobe", "recall_at_10_vs_exact",
                "rows_scanned_ivf", "rows_scanned_exact"):
        assert got[key] == want[key], key
    assert set(want) <= set(got)
    assert got["device"] == "cpu"
    assert got["exact_store_bytes"] == 8192 * 32 * 4
    assert got["ivf_store_bytes"] > got["exact_store_bytes"]


SECTIONS = (("vector_store", "VectorStoreConfig"),
            ("text_splitter", "TextSplitterConfig"),
            ("embeddings", "EmbeddingConfig"), ("ranking", "RankingConfig"),
            ("retriever", "RetrieverConfig"))


@pytest.mark.parametrize("section,cls", SECTIONS)
def test_retrieval_config_sections_match_the_reference(section, cls,
                                                       monkeypatch):
    """The reference's fields, defaults and APP_<SECTION>_<FIELD> names."""
    want = getattr(jconfig, cls)()
    got = getattr(tconfig.load_config(env={}), section)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    field = next(f.name for f in dataclasses.fields(got)
                 if f.name != "name" and isinstance(getattr(got, f.name),
                                                     (int, float)))
    env = {f"APP_{section.upper()}_{field.upper()}": "7"}
    assert getattr(getattr(tconfig.load_config(env=env), section),
                   field) == 7
    monkeypatch.setenv(f"APP_{section.upper()}_{field.upper()}", "7")
    assert getattr(getattr(jconfig.load_config(cls=jconfig.AppConfig),
                           section), field) == 7


def test_remote_vector_stores_are_refused():
    """The remote stores are served since their adapters were ported
    (``retrieval/adapters.py``): the configuration takes them, and
    ``make_store`` refuses only a backend it does not know."""
    from generativeaiexamples_tpu_torch.retrieval.adapters import make_store
    assert tconfig.load_config(env={"APP_VECTOR_STORE_NAME": "milvus"}
                               ).vector_store.name == "milvus"
    assert tconfig.VectorStoreConfig(name="pgvector").name == "pgvector"
    with pytest.raises(ValueError, match="unknown vector store backend"):
        make_store(4, tconfig.VectorStoreConfig(name="chroma"))
    assert tconfig.load_config(
        env={"APP_VECTOR_STORE_NAME": "tpu"}).vector_store.name == "tpu"
