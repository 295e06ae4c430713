"""The port's vector-DB adapters, mirroring ``tests/test_adapters.py``.

The same in-memory fakes of the Milvus, psycopg2 and Elasticsearch wire
surfaces (imported from the reference's test) drive the port's
``MilvusStore``, ``PgVectorStore`` and ``ElasticsearchStore``; each must
behave as the in-process store does, and as the reference's adapter does
on the same calls (hits, scores within 1e-6: both compute them in numpy).
``make_store`` dispatches on ``VectorStoreConfig.name``, builds the
in-process store on the device it is given, and refuses an unknown
backend with ``ValueError``.
"""

import numpy as np
import pytest

from generativeaiexamples_tpu.retrieval import adapters as jadapters
from generativeaiexamples_tpu.retrieval.store import Document as JDocument
from generativeaiexamples_tpu_torch.core.config import (VectorStoreConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.retrieval.adapters import (
    ElasticsearchStore, MilvusStore, PgVectorStore, make_store)
from generativeaiexamples_tpu_torch.retrieval.store import (Document,
                                                            VectorStore)
from test_adapters import FakeEsClient, FakeMilvusClient, FakePgConn

TEXTS = [("red apples", "fruit.txt"), ("green pears", "fruit.txt"),
         ("blue whales", "sea.txt")]


def _docs(cls=Document):
    return [cls(content=c, metadata={"source": s}) for c, s in TEXTS]


def _vecs():
    v = np.eye(3, 4, dtype=np.float32) + 0.1
    return v / np.linalg.norm(v, axis=1, keepdims=True)


FACTORIES = {
    "milvus": (lambda m: m.MilvusStore(dim=4, name="t",
                                       client=FakeMilvusClient())),
    "pgvector": (lambda m: m.PgVectorStore(dim=4, name="t",
                                           conn=FakePgConn())),
    "elasticsearch": (lambda m: m.ElasticsearchStore(
        dim=4, name="t", client=FakeEsClient())),
}


@pytest.mark.parametrize("backend", sorted(FACTORIES))
def test_adapter_contract(backend):
    """add/search/list/delete/len behave like the in-proc store."""
    from generativeaiexamples_tpu_torch.retrieval import adapters
    store = FACTORIES[backend](adapters)
    store.add(_docs(), _vecs())
    assert len(store) == 3
    assert store.list_sources() == ["fruit.txt", "sea.txt"]
    hits = store.search(_vecs()[0], top_k=2)
    assert len(hits) == 2
    assert hits[0][0].content == "red apples"
    assert hits[0][1] >= hits[1][1]
    assert hits[0][0].metadata["source"] == "fruit.txt"
    strict = store.search(_vecs()[0], top_k=3, score_threshold=0.99)
    assert all(s >= 0.99 for _, s in strict)
    assert store.delete_by_source(["fruit.txt"]) == 2
    assert len(store) == 1
    assert store.list_sources() == ["sea.txt"]


@pytest.mark.parametrize("backend", sorted(FACTORIES))
def test_adapter_matches_the_reference(backend):
    from generativeaiexamples_tpu_torch.retrieval import adapters
    ours, theirs = FACTORIES[backend](adapters), FACTORIES[backend](
        jadapters)
    ours.add(_docs(), _vecs())
    theirs.add(_docs(JDocument), _vecs())
    for q in _vecs():
        got, want = ours.search(q, top_k=3), theirs.search(q, top_k=3)
        assert [(d.content, d.metadata) for d, _ in got] == \
            [(d.content, d.metadata) for d, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], atol=1e-6)
    assert ours.list_sources() == theirs.list_sources()
    assert (ours.delete_by_source(["sea.txt"])
            == theirs.delete_by_source(["sea.txt"]))
    assert len(ours) == len(theirs)


def test_make_store_dispatch():
    inproc = make_store(4, VectorStoreConfig(), name="x", device="cpu")
    assert isinstance(inproc, VectorStore) and inproc.device.type == "cpu"
    assert isinstance(make_store(4, VectorStoreConfig(name="milvus"),
                                 name="x", client=FakeMilvusClient()),
                      MilvusStore)
    assert isinstance(make_store(4, VectorStoreConfig(name="pgvector"),
                                 name="x", client=FakePgConn()),
                      PgVectorStore)
    es = make_store(4, VectorStoreConfig(name="elasticsearch"), name="x",
                    client=FakeEsClient())
    assert isinstance(es, ElasticsearchStore)
    # reconnecting to an existing index is idempotent, not a crash
    assert isinstance(ElasticsearchStore(dim=4, name="x", client=es.client),
                      ElasticsearchStore)
    with pytest.raises(ValueError):
        make_store(4, VectorStoreConfig(name="chroma"))


def test_make_store_inproc_keeps_the_ivf_knobs():
    store = make_store(4, VectorStoreConfig(index_type="ivf", nlist=8,
                                            nprobe=4), name="x",
                       device="cpu")
    assert (store.index_type, store.nlist, store.nprobe) == ("ivf", 8, 4)


def test_remote_backends_load_from_the_environment():
    cfg = load_config(env={"APP_VECTOR_STORE_NAME": "milvus",
                           "APP_VECTOR_STORE_URL": "http://db:19530"})
    assert (cfg.vector_store.name, cfg.vector_store.url) == (
        "milvus", "http://db:19530")


def test_missing_driver_names_its_package(monkeypatch):
    """Without an injected client the adapter imports its driver, and a
    missing one raises with the package's name (``pymilvus`` is refused
    here, as the card's machine lacks it)."""
    import builtins
    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name.split(".")[0] == "pymilvus":
            raise ImportError("No module named 'pymilvus'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    with pytest.raises(ImportError, match="pymilvus"):
        MilvusStore(dim=4)
