"""The port's encoder HTTP server on the CPU, against the JAX package's
encoders on the same weights.

Its four routes in the reference's shapes: ``/v1/embeddings`` (OpenAI
shape, NIM ``input_type``), ``/v1/ranking``, ``/health`` and
``/metrics`` (JSON, or Prometheus text by ``Accept`` or ``?format=``);
the 400s of an empty or malformed request; and concurrent POSTs reaching
the micro-batcher together (fewer dispatches than requests). Embeddings
and logits agree with the JAX encoders' within 1e-5 (f32 both sides).
"""

import concurrent.futures
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.encoders import Embedder as JEmbedder
from generativeaiexamples_tpu.encoders import Reranker as JReranker
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
from generativeaiexamples_tpu_torch.encoders import server as srv
from generativeaiexamples_tpu_torch.models import bert as tb

ATOL = 1e-5


def _port_of(jenc, cls, **kw):
    return cls(cfg=tb.BertConfig.tiny(), params=tb.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jenc.params),
        tb.BertConfig.tiny()), device="cpu", **kw)


@pytest.fixture(scope="module")
def served():
    """A server over micro-batched encoders (a 50 ms window), with the
    JAX encoders of the same weights."""
    je, jr = JEmbedder(), JReranker()
    emb = _port_of(je, Embedder, micro_window_s=0.05)
    rer = _port_of(jr, Reranker, micro_window_s=0.05)
    server, httpd, thread = srv.serve_in_thread(emb, rer)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, je, jr
    httpd.shutdown()
    httpd.server_close()
    server.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _call(base, path, body=None, headers=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def test_health(served):
    base, _, _ = served
    status, ctype, body = _call(base, "/health")
    assert status == 200 and ctype == "application/json"
    # the reference's health body, slo_pressure included since the SLO
    # plane's port (server/common.health)
    assert json.loads(body) == {"message": "Service is up.",
                                "slo_pressure": "ok"}
    assert _call(base, "/nowhere")[0] == 404
    assert _call(base, "/v1/nowhere", {"input": "x"})[0] == 404


@pytest.mark.parametrize("input_type", ["passage", "query", None])
def test_embeddings_route_matches_jax(served, input_type):
    base, je, _ = served
    texts = ["paged attention keeps pages", "a vector store", "ü"]
    body = {"input": texts, "model": "any"}
    if input_type:
        body["input_type"] = input_type
    status, _, raw = _call(base, "/v1/embeddings", body)
    assert status == 200
    out = json.loads(raw)
    assert out["object"] == "list" and out["model"] == "e5-base-tpu"
    assert [d["index"] for d in out["data"]] == [0, 1, 2]
    assert all(d["object"] == "embedding" for d in out["data"])
    got = np.array([d["embedding"] for d in out["data"]], np.float32)
    want = (je.embed_queries(texts) if input_type == "query"
            else je.embed_documents(texts))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a lone string is one input
    status, _, raw = _call(base, "/v1/embeddings", {"input": texts[0]})
    assert status == 200 and len(json.loads(raw)["data"]) == 1


def test_ranking_route_matches_jax(served):
    base, _, jr = served
    passages = [f"passage {i} about topic {i % 3}" for i in range(10)]
    body = {"query": {"text": "what is topic 1"},
            "passages": [{"text": p} for p in passages], "top_n": 4}
    status, _, raw = _call(base, "/v1/ranking", body)
    assert status == 200
    out = json.loads(raw)
    assert out["model"] == "rerank-tpu"
    want = jr.rerank("what is topic 1", passages, top_n=4)
    assert [r["index"] for r in out["rankings"]] == [i for i, _ in want]
    np.testing.assert_allclose([r["logit"] for r in out["rankings"]],
                               [s for _, s in want], atol=ATOL)
    del body["top_n"]
    status, _, raw = _call(base, "/v1/ranking", body)
    assert len(json.loads(raw)["rankings"]) == 10


@pytest.mark.parametrize("path,body,raw", [
    ("/v1/embeddings", {"input": []}, None),
    ("/v1/embeddings", {}, None),
    ("/v1/embeddings", None, b"[1, 2]"),
    ("/v1/embeddings", None, b"{not json"),
    ("/v1/ranking", {"query": {"text": ""}, "passages": [{"text": "a"}]},
     None),
    ("/v1/ranking", {"query": {"text": "q"}, "passages": []}, None),
    ("/v1/ranking", {"query": "q", "passages": [{"text": "a"}]}, None),
])
def test_bad_requests_answer_400(served, path, body, raw):
    base, _, _ = served
    status, ctype, out = _call(base, path, body, raw=raw)
    assert status == 400 and ctype == "application/json"
    assert json.loads(out)["error"]


@pytest.mark.parametrize("how,prometheus", [
    ({}, False),
    ({"headers": {"Accept": "application/json, text/plain, */*"}}, False),
    ({"headers": {"Accept": "text/plain"}}, True),
    ({"headers": {"Accept": "application/openmetrics-text"}}, True),
    ({"query": "?format=prometheus"}, True),
    ({"query": "?format=openmetrics"}, True),
])
def test_metrics_negotiates_json_or_prometheus(served, how, prometheus):
    base, _, _ = served
    _call(base, "/v1/embeddings", {"input": ["count me"]})
    status, ctype, body = _call(base, "/metrics" + how.get("query", ""),
                                headers=how.get("headers"))
    assert status == 200
    text = body.decode()
    if prometheus:
        assert ctype.startswith(("text/plain", "application/openmetrics"))
        assert "# TYPE embeddings_computed counter" in text
        assert "embed_batch_fill_count" in text
        assert text.rstrip().endswith("# EOF") == (
            how.get("query") == "?format=openmetrics")
    else:
        assert ctype == "application/json"
        snap = json.loads(text)
        assert snap["embeddings_computed"] >= 1
        assert snap["embed_batch_fill"]["count"] >= 1


def test_concurrent_embeddings_coalesce(served):
    """24 concurrent POSTs reach the micro-batcher together: fewer
    dispatches than requests, each reply its own text's embedding."""
    base, je, _ = served
    texts = [f"request {i} about pages" for i in range(24)]
    dispatches = REGISTRY.counter("embed_dispatches")
    before = dispatches.value
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        replies = list(pool.map(lambda t: _call(
            base, "/v1/embeddings", {"input": [t]}), texts))
    assert all(status == 200 for status, _, _ in replies)
    assert dispatches.value - before < len(texts)
    got = np.array([json.loads(raw)["data"][0]["embedding"]
                    for _, _, raw in replies], np.float32)
    np.testing.assert_allclose(got, je.embed_documents(texts), atol=1e-4)


def test_server_without_a_reranker_has_no_ranking_route():
    emb = Embedder(cfg=tb.BertConfig.tiny(), device="cpu")
    server, httpd, thread = srv.serve_in_thread(emb, None)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _call(base, "/v1/ranking", {"query": {"text": "q"},
                                           "passages": [{"text": "a"}]})[0] \
            == 404
        assert _call(base, "/v1/embeddings", {"input": "a"})[0] == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)


def test_run_server_refuses_cpu_fallback(monkeypatch):
    """Without encoders ``run_server`` builds e5-base ones on ``device``:
    with no GPU and no device it raises before it binds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.run_server(port=0)
