"""The port's chain server against the reference's, over local sockets.

Both servers run ``basic_rag`` over contexts with the same weights
(``tests/test_torch_chains.py``'s ``pair``: the tiny llama and tiny BERT,
f32, greedy): the reference's ``ChainServer`` on aiohttp in a thread, the
port's on ``ThreadingHTTPServer``. The same requests, with a fixed
``X-Request-Id``, must give byte-equal ``/generate`` SSE bodies (with and
without the knowledge base, with history, with a stop string that
straddles two deltas, with a chain that raises), ``/search`` JSON with
equal hits and scores within 1e-5, the same upload/list/delete answers,
and the same 422 and 501 answers.

Also here: the port's sanitizer against ``bleach.clean(text, strip=True)``
(a fixed corpus and a hypothesis search over a small HTML alphabet), the
prompt-file reader against ``yaml.safe_load``, ``RemoteLLM`` against the
port's engine server, and the limits the port states loudly.
"""

import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import requests
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.chains import basic_rag as jbasic
from generativeaiexamples_tpu.chains.llm_client import RemoteLLM as JRemote
from generativeaiexamples_tpu.core import prompts as jprompts
from generativeaiexamples_tpu.server import api as japi
from generativeaiexamples_tpu.server.api import ChainServer as JChainServer
from generativeaiexamples_tpu.server.base import BaseExample as JBase
from generativeaiexamples_tpu_torch.chains import basic_rag as tbasic
from generativeaiexamples_tpu_torch.chains import llm_client
from generativeaiexamples_tpu_torch.chains.llm_client import (LocalLLM,
                                                              RemoteLLM)
from generativeaiexamples_tpu_torch.core import prompts as tprompts
from generativeaiexamples_tpu_torch.core.config import load_config
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.engine import server as tengine_server
from generativeaiexamples_tpu_torch.server import api as tapi
from generativeaiexamples_tpu_torch.server import registry, sanitize
from generativeaiexamples_tpu_torch.server.base import BaseExample
from test_chain_server import _free_port, _ServerThread
from test_torch_chains import DOCS, QUERIES, pair  # noqa: F401

RID = "chain-req-0001"
# the port's upload folder as the module set it, before the servers fixture
# points it at a temporary folder of the test run
UPLOAD_DIR_AT_IMPORT = tapi.UPLOAD_DIR


@pytest.fixture(scope="module")
def servers(pair, tmp_path_factory):  # noqa: F811
    jctx, tctx = pair
    jex, tex = jbasic.BasicRAG(context=jctx), tbasic.BasicRAG(context=tctx)
    # each server keeps its uploads in a folder of its own inside the test's
    # temporary directory (both modules read UPLOAD_DIR at each upload)
    patch = pytest.MonkeyPatch()
    patch.setattr(japi, "UPLOAD_DIR", str(tmp_path_factory.mktemp("jup")))
    patch.setattr(tapi, "UPLOAD_DIR", str(tmp_path_factory.mktemp("tup")))
    port = _free_port()
    jserver = _ServerThread(JChainServer(jex).app, port)
    jserver.start()
    _, httpd, thread = tapi.serve_in_thread(tex)
    urls = (f"http://127.0.0.1:{port}",
            f"http://127.0.0.1:{httpd.server_address[1]}")
    folder = tmp_path_factory.mktemp("docs")
    for name, text in DOCS.items():
        (folder / name).write_text(text)
        for url in urls:
            with open(folder / name, "rb") as fh:
                resp = requests.post(f"{url}/documents",
                                     files={"file": (name, fh)}, timeout=60)
            assert resp.status_code == 200, resp.text
    try:
        yield urls, (jex, tex)
    finally:
        jserver.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        patch.undo()


def _both(urls, method, path, **kw):
    return [requests.request(method, url + path, timeout=120, **kw)
            for url in urls]


def _frames(body: bytes):
    return [f[len("data: "):] for f in body.decode().split("\n\n") if f]


# ------------------------------------------------------------------ routes

def test_upload_list_search_delete_match(servers, tmp_path):
    urls, _ = servers
    assert japi.UPLOAD_DIR != tapi.UPLOAD_DIR
    assert all(d.startswith(str(tmp_path.parent))
               for d in (japi.UPLOAD_DIR, tapi.UPLOAD_DIR))
    extra = tmp_path / "extra.txt"
    extra.write_text("Zebras have black and white stripes.")
    answers = []
    for url in urls:
        with open(extra, "rb") as fh:
            answers.append(requests.post(f"{url}/documents", files={
                "file": ("extra.txt", fh)}, timeout=60))
    assert [r.status_code for r in answers] == [200, 200]
    assert answers[0].json() == answers[1].json() == {
        "message": "File uploaded successfully"}
    want, got = (r.json() for r in _both(urls, "GET", "/documents"))
    assert got == want and sorted(got["documents"]) == sorted(
        list(DOCS) + ["extra.txt"])
    for query in QUERIES + ("zebra stripes",):
        want, got = (r.json() for r in _both(
            urls, "POST", "/search", json={"query": query, "top_k": 3}))
        assert ([(c["filename"], c["content"]) for c in got["chunks"]]
                == [(c["filename"], c["content"]) for c in want["chunks"]])
        np.testing.assert_allclose([c["score"] for c in got["chunks"]],
                                   [c["score"] for c in want["chunks"]],
                                   atol=1e-5)
        assert got["chunks"]
    for name, deleted in (("extra.txt", True), ("absent.txt", False)):
        want, got = _both(urls, "DELETE", "/documents",
                          params={"filename": name})
        assert got.status_code == want.status_code == 200
        assert got.json() == want.json() == {"deleted": deleted}
    want, got = (r.json() for r in _both(urls, "GET", "/documents"))
    assert got == want and sorted(got["documents"]) == sorted(DOCS)


def _generate(urls, body):
    replies = _both(urls, "POST", "/generate", json=body,
                    headers={"X-Request-Id": RID})
    for r in replies:
        assert r.status_code == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        assert r.headers["X-Request-Id"] == RID
    return replies[0].content, replies[1].content


@pytest.mark.parametrize("case", ["no_kb", "kb", "history", "stop",
                                  "raises"])
def test_generate_sse_bodies_equal(servers, case, monkeypatch):
    urls, (jex, tex) = servers
    body = {"messages": [{"role": "user", "content": QUERIES[0]}],
            "use_knowledge_base": case != "no_kb",
            "max_tokens": 12, "temperature": 0.0}
    if case == "history":
        body["messages"] = [
            {"role": "user", "content": "<b>tell</b> me about llamas"},
            {"role": "assistant", "content": "they are camelids & more"},
            {"role": "user", "content": QUERIES[0]}]
    if case == "stop":
        # a stop string made of the end of one delta and the start of the
        # next, so the server holds the first part back
        _, plain = _generate(urls, body)
        deltas = [json.loads(f)["choices"][0]["message"]["content"]
                  for f in _frames(plain)[:-2]]
        k = next(i for i in range(len(deltas) - 1)
                 if deltas[i] and deltas[i + 1])
        body["stop"] = deltas[k][-1] + deltas[k + 1][0]
    if case == "raises":
        def broken(*args, **kwargs):
            raise RuntimeError("retrieval failed")
            yield ""
        monkeypatch.setattr(jex, "rag_chain", broken)
        monkeypatch.setattr(tex, "rag_chain", broken)
    want, got = _generate(urls, body)
    assert got == want
    frames = _frames(got)
    assert frames[-1] == "[DONE]"
    finish = json.loads(frames[-2])
    assert finish["id"] == RID
    assert finish["choices"][0]["finish_reason"] == "stop"
    text = "".join(json.loads(f)["choices"][0]["message"]["content"]
                   for f in frames[:-2])
    if case == "raises":
        assert text == tapi.ERROR_MESSAGE
    if case == "stop":
        assert body["stop"] not in text


def test_validation_errors_match(servers):
    urls, _ = servers
    for method, path, kw in (
            ("POST", "/generate", {"json": {"messages": []}}),
            ("POST", "/generate", {"json": {"messages": "hi"}}),
            ("POST", "/search", {"json": {"query": ""}}),
            ("POST", "/search", {"json": {"query": "<script></script>"}}),
            ("DELETE", "/documents", {}),
            ("POST", "/documents", {"files": {"other": ("a.txt", b"x")}})):
        want, got = _both(urls, method, path, **kw)
        assert got.status_code == want.status_code == 422, (method, path)
        assert got.text == want.text


def _no_search_example(base):
    class NoSearch(base):
        def llm_chain(self, query, chat_history, **settings):
            yield "x"

        def rag_chain(self, query, chat_history, **settings):
            yield "x"

        def ingest_docs(self, filepath, filename):
            pass
    return NoSearch()


def test_example_without_search_answers_501():
    port = _free_port()
    jserver = _ServerThread(JChainServer(_no_search_example(JBase)).app, port)
    jserver.start()
    _, httpd, thread = tapi.serve_in_thread(_no_search_example(BaseExample))
    urls = (f"http://127.0.0.1:{port}",
            f"http://127.0.0.1:{httpd.server_address[1]}")
    try:
        want, got = _both(urls, "POST", "/search", json={"query": "q"})
        assert got.status_code == want.status_code == 501
        assert got.text == want.text
        want, got = _both(urls, "GET", "/documents")
        assert got.json() == want.json() == {"documents": []}
        want, got = _both(urls, "DELETE", "/documents",
                          params={"filename": "a"})
        assert got.json() == want.json() == {"deleted": False}
        want, got = _both(urls, "POST", "/generate", json={
            "messages": [{"role": "user", "content": "q"}]},
            headers={"X-Request-Id": RID})
        assert got.content == want.content
    finally:
        jserver.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("header", list(tapi.SLO_HEADERS) + ["slo_class"])
def test_slo_and_tenant_requests_are_refused(servers, header):
    urls, _ = servers
    body = {"messages": [{"role": "user", "content": "q"}]}
    headers = {}
    if header == "slo_class":
        body["slo_class"] = "interactive"
    else:
        headers[header] = "100"
    resp = requests.post(urls[1] + "/generate", json=body, headers=headers,
                         timeout=60)
    assert resp.status_code == 422
    assert "A.10" in resp.json()["error"]


def test_health_and_metrics(servers):
    urls, _ = servers
    want, got = _both(urls, "GET", "/health")
    assert got.status_code == want.status_code == 200
    assert got.json()["message"] == want.json()["message"]
    _generate(urls, {"messages": [{"role": "user", "content": "hi"}],
                     "use_knowledge_base": False, "max_tokens": 4,
                     "temperature": 0.0})
    snap = requests.get(urls[1] + "/metrics", timeout=10).json()
    for key in ("e2e_ttft_s", "e2e_latency_s", "generate_requests",
                "documents_uploaded"):
        assert any(k.startswith(key) for k in snap), key
    text = requests.get(urls[1] + "/metrics", headers={
        "Accept": "text/plain"}, timeout=10)
    assert text.headers["Content-Type"].startswith("text/plain")
    assert "e2e_latency_s" in text.text
    assert REGISTRY.counter("generate_requests").value >= 1


# --------------------------------------------------------------- sanitizer

CORPUS = [
    "<script>alert(1)</script>hello", "a & b < c", "a &amp; b &lt; c > d",
    '<a href="javascript:x">y</a>', '<a href="http://e.com" title="t" '
    'onclick="z">link</a>', "<a href=\"mailto:a@b.c\">m</a>",
    "<a href='#top'>t</a>", '<a href="//[bad">x</a>', "<b>bold <i>both</b> i",
    "<ul><li>one<li>two</ul>", "<p>para</p><div>block</div>text",
    "<!-- comment -->visible", "<!DOCTYPE html><b>x</b>", "</ b>and</3>",
    "<?php echo 1 ?>", "unclosed <b>bold", "<b><b><b><b>deep</b></b>",
    "&notin; &#39; &#0; &#x110000; &#; &foo; &#1z;", "<abbr title=\"a&b\">A</abbr>",
    "<blockquote>q<ol><li>a</ol></blockquote>", "tab\there\x0cform\x01ctl",
    "<a title='\"'>q</a>", "<B>UPPER</B>", "<b/>self", "line\r\nbreak\rcr",
    "<a x x>dup", "<em>e</em><strong>s</strong><code>c</code>",
    "<table><tr><td>cell</td></tr></table>", "<a", "<a href", "text </",
    "<span style=\"x\">s</span>", "x" * 300 + "<b>" + "\x01" * 3,
    "caf\u00e9 \u00e0 \u00fc \u4e2d\u6587 <b>\u00e9</b>", "\ufffe and \uffff",
    "\U0001ffff<i>\U0010fffe</i>", "lone \ud800 surrogate", "\udc00<b>x</b>",
    "\U0001F600<b>\U0001F600</b>", "\ufdd0\ufdef", "\x7f\x80\x9f\x85",
]


@pytest.mark.parametrize("text", CORPUS)
def test_sanitizer_matches_bleach_corpus(text):
    bleach = pytest.importorskip("bleach")
    assert sanitize.clean(text) == bleach.clean(text, strip=True)


# html5lib reads its input in chunks of 10,240 characters: a CR/LF pair, a
# control character, an entity, a tag or a character outside the BMP that
# straddles a chunk's end takes the sanitizer's chunk-held paths
CHUNK_TAILS = ["\r\n", "\x01", "&amp;", "&notin;", "<b>x</b>",
               "<a href='javascript:x'>y</a>", "\U0001F600", "\ufffe",
               "\ud800"]


@pytest.mark.parametrize("before", [0, 1, 2, 3])
@pytest.mark.parametrize("tail", CHUNK_TAILS)
def test_sanitizer_matches_bleach_at_chunk_edges(tail, before):
    bleach = pytest.importorskip("bleach")
    text = "x" * (10240 - before) + tail + "y" * 3
    assert sanitize.clean(text) == bleach.clean(text, strip=True)


def test_sanitizer_matches_bleach_on_a_full_message():
    """A message at the 131,072-character cap, through many chunk edges."""
    bleach = pytest.importorskip("bleach")
    unit = ("lorem <b>ipsum</b> & dolor\r\n\x01 &amp; caf\u00e9\U0001F600 "
            "<a href='javascript:x'>y</a> <!-- c --> \ufffe ")
    text = (unit * (131072 // len(unit) + 1))[:131072]
    assert sanitize.clean(text) == bleach.clean(text, strip=True)


FRAGMENTS = ["<a>", "</a>", "<b>", "</b>", "<i>", "</i>", "<li>", "</li>",
             "<ul>", "</ul>", "<ol>", "<blockquote>", "</blockquote>",
             "<abbr>", "</abbr>", "<p>", "</p>", "<div>", "<script>",
             "<!--", "-->", "&amp;", "&lt;", "&", "<", ">", "x", " ", "\n",
             "=", '"', "'", "/", "!", '<a href="javascript:x">',
             '<a href="http://x" title="t">', "&#39;", "&notin;", "</ b>",
             "<?x>", "<b/>", "<B>", "\x0c", "\x01", "\x00", "\r\n",
             "\U0001F600", "\ud800"]


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.one_of(st.sampled_from(FRAGMENTS),
                          st.text(alphabet="<>/!-=\"'&;# abliu\u00e9\ufffe",
                                  max_size=4)), max_size=20))
def test_sanitizer_matches_bleach_search(parts):
    bleach = pytest.importorskip("bleach")
    text = "".join(parts)
    assert sanitize.clean(text) == bleach.clean(text, strip=True)


# ------------------------------------------------------------ prompt files

PROMPT_FILES = [
    "", "# a comment only\n", "---\nchat_template: hello world\n",
    'chat_template: "a \\"q\\" \\n and \\t tab \\u00e9"\n'
    "rag_template: 'it''s # not a comment'\n",
    "rag_template: |\n  line one\n    indented\n\n  line three\n\nnext: x y\n",
    "rag_template: |-\n  a\n  b\n\n\n", "rag_template: |+\n  a\n\n\nk: v\n",
    "rag_template: >\n  folded one\n  folded two\n\n  new para\nk: v\n",
    "rag_template: >-\n  a\n  b\n",
    "nested:\n  inner: value # comment\n  deeper:\n    x: 'y'\ntop: z\n",
    "chat_template: You are {name}. Answer in {lang}!\n",
    "k: a#b\n", "k: |\n\n  leading blank\n", "k: |\n  trailing  \n",
]
BAD_PROMPT_FILES = ["- a\n- b\n", "k: [a, b]\n", "k: 3\n", "k: yes\n",
                    "k:\n", "k: &a x\n", 'k: "a\n  b"\n', "k: a\n  b\n",
                    "k: x\nk: y\n", "k: a: b\n", "'q': v\n", "k: |2\n   x\n",
                    "k: >\n  a\n    b\n", "\tk: v\n", "k: !!str x\n",
                    "k: null\n", "k: 1.5\n", "just text\n"]


@pytest.mark.parametrize("text", PROMPT_FILES)
def test_prompt_reader_matches_yaml(text):
    yaml = pytest.importorskip("yaml")
    assert tprompts.read_prompt_file(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("text", BAD_PROMPT_FILES)
def test_prompt_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(tprompts.PromptFileError):
        tprompts.read_prompt_file(text)


def test_prompt_override_merges_as_the_reference(tmp_path):
    assert tprompts.DEFAULT_PROMPTS == jprompts.DEFAULT_PROMPTS
    path = tmp_path / "prompt.yaml"
    path.write_text("rag_template: |\n  Context:\n  {context}\n"
                    "extra:\n  deep: 'v'\nchat_template: short\n")
    assert (tprompts.get_prompts(str(path))
            == jprompts.get_prompts(str(path)))


# ---------------------------------------------------------------- RemoteLLM

MESSAGES = [{"role": "user", "content": "say something"}]


def test_remote_llm_matches_local_and_reference(pair):  # noqa: F811
    _, tctx = pair
    sched = tctx.llm.scheduler
    httpd, thread = tengine_server.serve_in_thread(sched, "tiny")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        sampling = dict(max_tokens=10, temperature=0.0)
        local = "".join(LocalLLM(sched).chat(MESSAGES, **sampling))
        remote = "".join(RemoteLLM(base, "tiny").chat(MESSAGES, **sampling))
        reference = "".join(JRemote(base, "tiny").chat(MESSAGES, **sampling))
        assert remote == local == reference and local
        stopped = "".join(RemoteLLM(base, "tiny").chat(
            MESSAGES, stop=[local[2:4]], **sampling))
        assert stopped == local[:local.index(local[2:4])]
        got = RemoteLLM(base, "tiny").chat_tools(MESSAGES, [], **sampling)
        want = JRemote(base, "tiny").chat_tools(MESSAGES, [], **sampling)
        assert got == want and got["content"] == local
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


class _ErrorStream(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        chunk = {"choices": [{"delta": {"content": "part"},
                              "finish_reason": None}]}
        self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
        error = {"error": "engine fault",
                 "choices": [{"delta": {}, "finish_reason": "error"}]}
        self.wfile.write(f"data: {json.dumps(error)}\n\n".encode())


def test_remote_llm_raises_on_an_error_chunk():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _ErrorStream)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for cls in (RemoteLLM, JRemote):
            got = []
            with pytest.raises(RuntimeError, match="engine fault"):
                for delta in cls(base, "m").chat(MESSAGES):
                    got.append(delta)
            assert got == ["part"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


# ------------------------------------------------------------- loud limits

def test_failover_pool_is_refused(monkeypatch):
    monkeypatch.setenv("APP_LLM_SERVER_URL", "http://a:1, http://b:2")
    with pytest.raises(NotImplementedError, match=r"A\.17"):
        llm_client.get_llm()
    monkeypatch.setenv("APP_LLM_SERVER_URL", "http://a:1/")
    llm = llm_client.get_llm()
    assert isinstance(llm, RemoteLLM) and llm.base_url == "http://a:1"


def test_model_engine_other_than_the_default_is_refused():
    assert load_config(env={}).llm.model_engine == "tpu"
    assert load_config(env={"APP_LLM_MODEL_ENGINE": "tpu"}).llm
    with pytest.raises(ValueError, match="llm.server_url"):
        load_config(env={"APP_LLM_MODEL_ENGINE": "openai-compat"})


@pytest.mark.parametrize("name", sorted(registry.NOT_PORTED))
def test_unported_examples_name_their_roadmap_item(name):
    with pytest.raises(KeyError, match=registry.NOT_PORTED[name]):
        registry.get_example(name)


# the chains of A.13's part 3a: served by name from the port
AGENT_CHAINS = ("agentic_rag", "query_decomposition_rag", "router_rag",
                "text_to_sql")


def _fresh(ctx, cls):
    """``ctx``'s engine and encoders with stores of their own."""
    return cls(config=ctx.config, llm=ctx.llm, embedder=ctx.embedder,
               reranker=ctx.reranker)


@pytest.mark.parametrize("name", AGENT_CHAINS)
def test_agent_chains_serve_health_and_documents(name, pair,  # noqa: F811
                                                 tmp_path, monkeypatch):
    from generativeaiexamples_tpu_torch.chains.context import ChainContext

    assert name not in registry.NOT_PORTED
    monkeypatch.setattr(tapi, "UPLOAD_DIR", str(tmp_path / "up"))
    example = registry.get_example(name, context=_fresh(pair[1],
                                                        ChainContext))
    assert type(example).__module__ == registry._KNOWN[name]
    _, httpd, thread = tapi.serve_in_thread(example)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    (tmp_path / "kb.txt").write_text(DOCS["llamas.txt"])
    try:
        health = requests.get(url + "/health", timeout=60)
        with open(tmp_path / "kb.txt", "rb") as fh:
            upload = requests.post(url + "/documents",
                                   files={"file": ("kb.txt", fh)}, timeout=60)
        listed = requests.get(url + "/documents", timeout=60)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert health.status_code == 200
    assert upload.status_code == 200 and upload.json() == {
        "message": "File uploaded successfully"}
    # text_to_sql keeps an upload as documentation, under its collection
    assert listed.status_code == 200 and listed.json()["documents"] == (
        ["sql_docs"] if name == "text_to_sql" else ["kb.txt"])


@pytest.mark.parametrize("name", ["router_rag", "text_to_sql"])
def test_c9_delete_answers(name, pair, tmp_path, monkeypatch):  # noqa: F811
    """ROADMAP C9: the reference's ``router_rag`` and ``text_to_sql`` return
    None from ``delete_documents``, so its chain server answers
    ``{"deleted": false}`` after a real delete; the port's answer whether
    anything went, and a second delete of the same name is false on both."""
    from generativeaiexamples_tpu.chains.context import (ChainContext as
                                                         JContext)
    from generativeaiexamples_tpu.server import registry as jregistry
    from generativeaiexamples_tpu_torch.chains.context import ChainContext

    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "UPLOAD_DIR", str(tmp_path / mod.__name__))
    jex = jregistry.get_example(name, context=_fresh(pair[0], JContext))
    tex = registry.get_example(name, context=_fresh(pair[1], ChainContext))
    port = _free_port()
    jserver = _ServerThread(JChainServer(jex).app, port)
    jserver.start()
    _, httpd, thread = tapi.serve_in_thread(tex)
    urls = (f"http://127.0.0.1:{port}",
            f"http://127.0.0.1:{httpd.server_address[1]}")
    (tmp_path / "kb.txt").write_text(DOCS["kernels.txt"])
    try:
        for url in urls:
            with open(tmp_path / "kb.txt", "rb") as fh:
                assert requests.post(url + "/documents", files={
                    "file": ("kb.txt", fh)}, timeout=60).status_code == 200
        listed = [r.json()["documents"] for r in _both(urls, "GET",
                                                       "/documents")]
        assert listed[0] == listed[1] and len(listed[0]) == 1
        target = f"/documents?filename={listed[0][0]}"
        first = [r.json() for r in _both(urls, "DELETE", target)]
        after = [r.json()["documents"] for r in _both(urls, "GET",
                                                      "/documents")]
        again = [r.json() for r in _both(urls, "DELETE", target)]
    finally:
        jserver.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert after == [[], []]          # both removed the documents
    assert first == [{"deleted": False}, {"deleted": True}]
    assert again == [{"deleted": False}, {"deleted": False}]
    assert jex.delete_documents(["kb.txt"]) is None
    assert tex.delete_documents(["kb.txt"]) is False


def _held_ingest(base):
    """An example whose first ``ingest_docs`` waits, before it reads its
    file, until a second upload has entered ``ingest_docs``; records the
    text each call read."""
    class Held(base):
        def __init__(self):
            self.read, self.lock = {}, threading.Lock()
            self.first_in, self.second_in = (threading.Event(),
                                             threading.Event())

        def ingest_docs(self, filepath, filename):
            with self.lock:
                n = len(self.read) + 1
                self.read[n] = None
            if n == 1:
                self.first_in.set()
                assert self.second_in.wait(60)
            else:
                self.second_in.set()
            with open(filepath, encoding="utf-8") as fh:
                self.read[n] = fh.read()

        def llm_chain(self, query, chat_history, **settings):
            yield ""

        rag_chain = llm_chain
    return Held()


def test_c10_uploads_of_one_name_at_once(tmp_path, monkeypatch):
    """ROADMAP C10: the reference writes every upload to
    ``UPLOAD_DIR/<name>``, so the first of two uploads of one name at
    once reads the second's bytes; the port gives each upload a folder of
    its own (and removes it after ingesting)."""
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "UPLOAD_DIR", str(tmp_path / mod.__name__))
    jex, tex = _held_ingest(JBase), _held_ingest(BaseExample)
    port = _free_port()
    jserver = _ServerThread(JChainServer(jex).app, port)
    jserver.start()
    _, httpd, thread = tapi.serve_in_thread(tex)
    try:
        for url, ex in ((f"http://127.0.0.1:{port}", jex),
                        (f"http://127.0.0.1:{httpd.server_address[1]}",
                         tex)):
            def upload(text):
                return requests.post(url + "/documents", files={
                    "file": ("kb.txt", text.encode())}, timeout=60)

            first = threading.Thread(target=upload, args=("alpha",))
            first.start()
            assert ex.first_in.wait(60)
            assert upload("beta").status_code == 200
            first.join(timeout=60)
            assert not first.is_alive()
    finally:
        jserver.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert jex.read == {1: "beta", 2: "beta"}
    assert tex.read == {1: "alpha", 2: "beta"}
    assert os.listdir(tapi.UPLOAD_DIR) == []


def test_unknown_example_is_refused():
    with pytest.raises(KeyError, match="unknown example"):
        registry.get_example("no_such_chain")


def test_upload_dir_follows_the_temporary_directory():
    assert UPLOAD_DIR_AT_IMPORT == os.environ.get("UPLOAD_DIR", os.path.join(
        __import__("tempfile").gettempdir(), "gaie-tpu-uploads"))


def test_multipart_parser_keeps_bytes():
    raw = (b"--XyZ\r\nContent-Disposition: form-data; name=\"meta\"\r\n\r\n"
           b"m\r\n--XyZ\r\nContent-Disposition: form-data; name=\"file\"; "
           b"filename=\"a b.txt\"\r\nContent-Type: text/plain\r\n\r\n"
           b"line\r\n\r\nbin\x00\xff\r\n--XyZ--\r\n")
    assert tapi._multipart_file("multipart/form-data; boundary=XyZ",
                                raw) == ("a b.txt", b"line\r\n\r\nbin\x00\xff")
    assert tapi._multipart_file("application/json", raw) is None


def test_urlopen_reads_the_port_server(servers):
    """The standard library's client reads the port's SSE stream (as
    ``chip_smoke.py`` does)."""
    urls, _ = servers
    req = urllib.request.Request(
        urls[1] + "/generate", data=json.dumps({
            "messages": [{"role": "user", "content": "hi"}],
            "use_knowledge_base": False, "max_tokens": 3,
            "temperature": 0.0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        frames = _frames(resp.read())
    assert frames[-1] == "[DONE]"


# ---------------------------------------------------------------- rails

class _FakeLLM:
    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def chat(self, messages, **settings):
        self.calls.append(messages)
        yield self.responses.pop(0) if self.responses else "default"


FLOWS_CO = '''
define user greet
  "Hello"
  "Hi there"

define bot greet
  "Hello. I'm the Guardrails Bot. How can I help you?"

define flow
  user greet
  bot greet
'''


def _rails_generate(example, rails, content):
    server = tapi.ChainServer(example, guardrails=rails)
    httpd = server.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        resp = requests.post(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            json={"messages": [{"role": "user", "content": content}]},
            timeout=60)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    return "".join(json.loads(f)["choices"][0]["message"]["content"]
                   for f in _frames(resp.content)[:-1])


def _flow_key(flow):
    return flow.intent, tuple(flow.examples), flow.response


def test_rails_parse_as_the_reference():
    from generativeaiexamples_tpu.server import guardrails as jgr
    from generativeaiexamples_tpu_torch.server import guardrails as gr
    assert ([_flow_key(f) for f in gr.parse_colang(FLOWS_CO)]
            == [_flow_key(f) for f in jgr.parse_colang(FLOWS_CO)])


def test_server_input_rail_blocks_generation(pair):  # noqa: F811
    from generativeaiexamples_tpu_torch.server import guardrails as gr

    class Boom(BaseExample):
        def rag_chain(self, query, history, **kw):
            raise AssertionError("the chain must not run when a rail fires")
        llm_chain = rag_chain

        def ingest_docs(self, filepath, filename):
            pass

    rails = gr.Guardrails(input_rails=[gr.IntentRail(
        gr.parse_colang(FLOWS_CO), pair[1].embedder, threshold=0.995)])
    assert "Guardrails Bot" in _rails_generate(Boom(), rails, "Hello")


def test_server_output_rails_buffer_and_apply():
    from generativeaiexamples_tpu_torch.server import guardrails as gr

    class Example(BaseExample):
        def rag_chain(self, query, history, **kw):
            yield "The pump uses 48V; "
            yield "serial 123-45-6789."
        llm_chain = rag_chain

        def ingest_docs(self, filepath, filename):
            pass

        def document_search(self, query, num_docs=4):
            return [{"content": "The pump operates on 24V DC."}]

    judge = _FakeLLM(["FALSE — context says 24V."])
    rails = gr.Guardrails(output_scrub=gr.RegexRail([r"\b\d{3}-\d{2}-\d{4}\b"]),
                          fact_check=gr.FactCheckRail(judge))
    text = _rails_generate(Example(), rails, "What voltage?")
    assert "fact-check could not verify" in text
    assert "[redacted]" in text and "123-45-6789" not in text
    assert "24V DC" in judge.calls[0][-1]["content"]


def test_server_output_rails_use_recorded_context():
    from generativeaiexamples_tpu_torch.server import guardrails as gr

    class Example(BaseExample):
        def rag_chain(self, query, history, **kw):
            gr.record_context("The pump operates on 48V AC.")
            yield "The pump uses 48V."
        llm_chain = rag_chain

        def ingest_docs(self, filepath, filename):
            pass

        def document_search(self, query, num_docs=4):
            raise AssertionError("the rails must reuse the chain's context")

    judge = _FakeLLM(["TRUE"])
    rails = gr.Guardrails(fact_check=gr.FactCheckRail(judge))
    assert _rails_generate(Example(), rails, "What voltage?") == \
        "The pump uses 48V."
    assert "48V AC" in judge.calls[0][-1]["content"]


def test_server_rails_failure_yields_canned_error():
    from generativeaiexamples_tpu_torch.server import guardrails as gr

    class BoomRail:
        def check(self, query):
            raise RuntimeError("device exploded")

    rails = gr.Guardrails(input_rails=[BoomRail()])
    assert _rails_generate(_no_search_example(BaseExample), rails,
                           "anything") == tapi.ERROR_MESSAGE
