"""The port's data chains against the JAX package's on the CPU.

``structured_data_rag`` and ``knowledge_graph_rag`` run over both packages
with the same inputs: a scripted LLM (the reference's own cases, from
``tests/test_advanced_chains.py`` and ``tests/test_breadth_chains.py``)
over ``test_torch_chains.py``'s ``pair`` encoders (tiny BERT, f32, the
port's carried across by ``bert.params_from_jax``). Each case runs on both
packages; the answers, the generated code's results, the messages each LLM
received, the retrieved context and the graph's edges must be equal, and
the reference's own assertions hold on both.

Also here: ``validate_code``'s verdict on an accept/deny table (imports,
dunders, ``open``/``exec``/``eval``, denied attributes, pandas IO and
submodules, allowed pandas calls), equal in both packages; both chains
served by name through both chain servers; and ROADMAP C11, shown over
HTTP: the reference's ``knowledge_graph_rag`` answers a real delete with
``{"deleted": false}``, the port's with ``true``, then ``false`` on a
second delete.
"""

import json

import numpy as np
import pandas as pd
import pytest
import requests

from generativeaiexamples_tpu.chains import knowledge_graph_rag as jkg
from generativeaiexamples_tpu.chains import structured_data as jsd
from generativeaiexamples_tpu.server import api as japi
from generativeaiexamples_tpu.server import guardrails as jguardrails
from generativeaiexamples_tpu.server import registry as jregistry
from generativeaiexamples_tpu.server.api import ChainServer as JChainServer
from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.chains import knowledge_graph_rag as tkg
from generativeaiexamples_tpu_torch.chains import structured_data as tsd
from generativeaiexamples_tpu_torch.server import api as tapi
from generativeaiexamples_tpu_torch.server import guardrails as tguardrails
from generativeaiexamples_tpu_torch.server import registry
from test_chain_server import _free_port, _ServerThread
from test_torch_agents import _scripted, _write
from test_torch_chains import pair  # noqa: F401

ATOL = 1e-5
PACKAGES = {"jax": dict(sd=jsd, kg=jkg, guardrails=jguardrails,
                        registry=jregistry),
            "torch": dict(sd=tsd, kg=tkg, guardrails=tguardrails,
                          registry=registry)}
RID = "data-chains-0001"


def _both(run):
    """``run(package)`` on both packages: their results equal."""
    got = {package: run(package) for package in PACKAGES}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ------------------------------------------------------- structured data

MACHINES = "machine,age\nm1,7\nm2,14\nm3,3\n"


def _sd_chain(pair, package, tmp_path, responses):  # noqa: F811
    ctx = _scripted(pair, package, responses)
    chain = PACKAGES[package]["sd"].StructuredDataRAG(
        context=ctx, state_dir=str(tmp_path / package / "state"))
    return ctx, chain


def test_structured_data_pandas_agent(pair, tmp_path):  # noqa: F811
    csv1 = _write(tmp_path, "machines.csv", MACHINES)
    responses = ["result = df['age'].max()",
                 "The oldest machine is 14 months old."]

    def run(package):
        ctx, chain = _sd_chain(pair, package, tmp_path, responses)
        chain.ingest_docs(csv1, "machines.csv")
        out = "".join(chain.rag_chain("oldest machine age?", []))
        return out, ctx.llm.calls, chain.get_documents()

    out, calls, docs = _both(run)
    assert out == "The oldest machine is 14 months old."
    assert docs == ["machines.csv"]
    # the paraphrase carries the data point
    assert "14" in calls[-1][0]["content"]


def test_structured_data_retry_on_bad_code(pair, tmp_path):  # noqa: F811
    csv1 = _write(tmp_path, "t.csv", "x\n1\n2\n")
    responses = ["import os\nresult = os.getcwd()",      # refused
                 "```python\nresult = df['x'].sum()\n```",  # fenced retry
                 "The sum is 3."]

    def run(package):
        ctx, chain = _sd_chain(pair, package, tmp_path, responses)
        chain.ingest_docs(csv1, "t.csv")
        return "".join(chain.rag_chain("sum of x?", [])), ctx.llm.calls

    out, calls = _both(run)
    assert out == "The sum is 3."
    # the retry carried the refusal back to the model
    assert "disallowed syntax: Import" in calls[1][1]["content"]


def test_structured_data_gives_up_after_max_retries(pair,  # noqa: F811
                                                    tmp_path):
    csv1 = _write(tmp_path, "t.csv", "x\n1\n2\n")
    responses = ["df.to_csv('leak.csv')"] * tsd.MAX_RETRIES

    def run(package):
        ctx, chain = _sd_chain(pair, package, tmp_path, responses)
        chain.ingest_docs(csv1, "t.csv")
        out = "".join(chain.rag_chain("leak it", []))
        return out, len(ctx.llm.calls), ctx.llm.calls[-1]

    out, n_calls, _ = _both(run)
    assert out == NO_CONTEXT_MSG and n_calls == tsd.MAX_RETRIES == 6


def test_structured_data_documents_and_columns(pair, tmp_path):  # noqa: F811
    a = _write(tmp_path, "a.csv", "x,y\n1,2\n")
    b = _write(tmp_path, "b.csv", "p,q\n1,2\n")
    c = _write(tmp_path, "c.csv", "x,y\n3,4\n")

    def run(package):
        ctx, chain = _sd_chain(pair, package, tmp_path,
                               ["result = df['y'].sum()", "six"])
        empty = "".join(chain.rag_chain("anything?", []))
        chain.ingest_docs(a, "a.csv")
        with pytest.raises(ValueError, match="do not match"):
            chain.ingest_docs(b, "b.csv")
        with pytest.raises(ValueError, match="not a valid CSV"):
            chain.ingest_docs(a, "a.txt")
        chain.ingest_docs(c, "c.csv")
        chain.ingest_docs(c, "c.csv")          # re-upload: no duplicate
        listed = chain.get_documents()
        out = "".join(chain.rag_chain("sum of y?", []))
        data = ctx.llm.calls[-1][0]["content"]
        deleted = (chain.delete_documents(["c.csv"]),
                   chain.delete_documents(["c.csv"]))
        return empty, listed, out, data, deleted, chain.get_documents()

    empty, listed, out, data, deleted, after = _both(run)
    assert empty == "No CSV file ingested"
    assert listed == ["a.csv", "c.csv"] and out == "six"
    assert "6" in data                        # rows of both files summed
    assert deleted == (True, False) and after == ["a.csv"]


def test_structured_data_reads_its_own_copy(pair, tmp_path):  # noqa: F811
    """The port keeps a copy of each CSV under ``state_dir``, since its
    chain server removes an upload once ingested (ROADMAP C10): a question
    after the upload is gone still reads the table."""
    csv1 = tmp_path / "up" / "machines.csv"
    csv1.parent.mkdir()
    csv1.write_text(MACHINES)
    ctx, chain = _sd_chain(pair, "torch", tmp_path,
                           ["result = df['age'].min()", "three"])
    chain.ingest_docs(str(csv1), "machines.csv")
    csv1.unlink()
    assert "".join(chain.rag_chain("youngest?", [])) == "three"
    assert "3" in ctx.llm.calls[-1][0]["content"]
    assert chain.get_documents() == ["machines.csv"]


# the accept/deny table: every verdict equal in both packages
ACCEPT = [
    "result = df['x'].sum()",
    "df['x'].mean()",
    "result = df.groupby('x').size()",
    "result = pd.to_numeric(df['x']).max()",
    "result = pd.concat([df, df]).shape[0]",
    "result = len([v for v in df['x'] if v > 1])",
    "result = sorted(df['x'].tolist(), reverse=True)[0]",
    "result = pd.DataFrame({'a': [1]}).iloc[0, 0]",
    "result = f\"{df['x'].sum()} rows\"",
    "t = df['x']\nt += 1\nresult = t.max()",
]
DENY = [
    "import os",
    "from os import path",
    "__import__('os')",
    "df.__class__",
    "result = df._data",
    "open('/etc/passwd')",
    "exec('x=1')",
    "eval('1')",
    "result = getattr(df, 'x')",
    "result = pd.io.common.os.getcwd()",
    "result = pd.read_csv('/etc/passwd')",
    "result = pd.eval('1 + 1')",
    "df.to_csv('leak.csv')",
    "df.to_pickle('leak.pkl')",
    "df.eval('x + 1')",
    "df.query('x > 0')",
    "df.pipe(print)",
    "df.plot()",
    "def f():\n    return 1",
    "for v in df['x']:\n    pass",
    "with open('f') as fh:\n    pass",
    "del df",
    "global df",
    "try:\n    result = 1\nexcept Exception:\n    pass",
]


def _verdict(mod, code):
    """The validator's verdict, then the sandbox's: the result's text, or
    the error that refused the code."""
    try:
        mod.validate_code(code)
        checked = "ok"
    except (ValueError, SyntaxError) as exc:
        checked = f"{type(exc).__name__}: {exc}"
    try:
        ran = str(mod.run_pandas_code(code, pd.DataFrame({"x": [1, 2, 3]})))
    except Exception as exc:
        ran = f"{type(exc).__name__}: {exc}"
    return checked, ran


@pytest.mark.parametrize("code", ACCEPT + DENY)
def test_validate_code_verdicts_equal_the_reference(code):
    got = _verdict(tsd, code)
    assert got == _verdict(jsd, code)
    checked, ran = got
    if code in ACCEPT:
        assert checked == "ok" and "Error" not in ran
    else:
        # refused by the allowlist, or by the sandbox's builtins
        assert checked != "ok" or ran.startswith("NameError")


def test_allowlists_equal_the_reference():
    assert tsd._ALLOWED_NODES == jsd._ALLOWED_NODES
    assert tsd._PD_ALLOWED == jsd._PD_ALLOWED
    assert tsd._DENIED_ATTRS == jsd._DENIED_ATTRS
    assert tsd._SAFE_BUILTINS == jsd._SAFE_BUILTINS
    df = pd.DataFrame({"machine": ["m1", "m2", "m3", "m4"],
                       "age": [7, 14, 3, 1]})
    assert tsd.extract_df_desc(df) == jsd.extract_df_desc(df)
    for text in ("```python\nresult = 1\n```", "```\nx\n```", "  plain  "):
        assert tsd.strip_code_fences(text) == jsd.strip_code_fences(text)
    for value in (None, "", 0, "x", pd.DataFrame(), df, pd.Series([]),
                  df["age"]):
        assert tsd.is_result_valid(value) == jsd.is_result_valid(value)


# ------------------------------------------------------- knowledge graph

TRIPLES_REPLY = ("[('Nvidia', 'Company', 'Introduce', 'H100', 'Product'), "
                 "('Nvidia', 'Company', 'Operate_In', 'Santa Clara', "
                 "'Place'), ('BadRel', 'X', 'NotARelation', 'Y', 'Z')]")


def _edges(graph):
    return sorted((h, o, tuple(sorted(d.items())))
                  for h, o, d in graph.edges(data=True))


@pytest.mark.parametrize("text", [
    TRIPLES_REPLY, "no list here", "[1, 2", "{'a': 1}",
    "Sure: [('A', 'T', 'Has', 'B', 'T'), ('A', 'T', 'Has', 'B')] done",
    "[['A ', 'T', 'Invests_In', ' B', 'T'], ('C', 'T', 'has', 'D', 'T')]"])
def test_parse_triples_equals_the_reference(text):
    assert tkg.parse_triples(text) == jkg.parse_triples(text)
    assert tkg.RELATIONS == jkg.RELATIONS
    assert tkg.EXTRACT_PROMPT == jkg.EXTRACT_PROMPT
    assert tkg.ANSWER_PROMPT == jkg.ANSWER_PROMPT


def test_kg_ingest_builds_graph_and_answers(pair, tmp_path):  # noqa: F811
    doc = _write(tmp_path, "news.txt",
                 "Nvidia introduced the H100 GPU in Santa Clara.")

    def run(package):
        mods = PACKAGES[package]
        gpath = str(tmp_path / f"{package}.graphml")
        ctx = _scripted(pair, package,
                        [TRIPLES_REPLY, "Nvidia introduced the H100."])
        kg = mods["kg"].KnowledgeGraphRAG(context=ctx, graph_path=gpath)
        kg.ingest_docs(doc, "news.txt")
        edges = _edges(kg.graph)
        lines = kg.graph_context("What did Nvidia introduce?")
        mods["guardrails"].take_context()
        answer = "".join(kg.rag_chain("What did Nvidia introduce?", []))
        recorded = mods["guardrails"].take_context()
        found = kg.document_search("H100 GPU", top_k=2)
        reloaded = _edges(mods["kg"].KnowledgeGraphRAG(
            context=_scripted(pair, package, []), graph_path=gpath).graph)
        # a second relation between the same pair keeps its own source
        kg.graph.add_edge("Nvidia", "H100", relation="Produce",
                          source="b.txt")
        kg.delete_documents(["b.txt"])
        kept = _edges(kg.graph)
        kg.delete_documents(["news.txt"])
        return (edges, lines, answer, ctx.llm.calls, recorded, reloaded,
                kept, kg.graph.number_of_edges(), kg.graph.number_of_nodes(),
                kg.get_documents(),
                [(f["content"], f["source"]) for f in found],
                [f["score"] for f in found])

    got = {package: run(package) for package in PACKAGES}
    *same, scores = got["torch"]
    assert same == list(got["jax"][:-1])
    np.testing.assert_allclose(scores, got["jax"][-1], atol=ATOL)
    (edges, lines, answer, calls, recorded, reloaded, kept, n_edges, n_nodes,
     docs, found) = same
    assert len(edges) == 2 and reloaded == edges and kept == edges
    assert any("Introduce" in line and "H100" in line for line in lines)
    assert answer == "Nvidia introduced the H100."
    assert "H100" in calls[-1][0]["content"]
    assert "H100" in recorded
    assert (n_edges, n_nodes, docs) == (0, 0, [])
    assert found and found[0][1] == "news.txt"


def test_kg_entity_linking_falls_back_to_the_llm(pair,  # noqa: F811
                                                 tmp_path):
    doc = _write(tmp_path, "news.txt", "Acme makes widgets in Springfield.")
    reply = ("[('Acme', 'Company', 'Produce', 'Widgets', 'Product'), "
             "('Acme', 'Company', 'Operate_In', 'Springfield', 'Place'), "
             "('Springfield', 'Place', 'Has', 'Acme', 'Company')]")

    def run(package):
        ctx = _scripted(pair, package, [reply, "acme, Unknown Corp",
                                        "nothing", "The answer."])
        kg = PACKAGES[package]["kg"].KnowledgeGraphRAG(context=ctx)
        kg.ingest_docs(doc, "news.txt")
        # no node name in the question: the LLM names the entities
        lines = kg.graph_context("Who builds gadgets?", hops=1)
        none = kg.graph_context("What about nobody?")
        two = kg.graph_context("Tell me about Widgets", hops=2, limit=2)
        return lines, none, two, ctx.llm.calls

    lines, none, two, calls = _both(run)
    assert len(lines) == 3 and none == [] and len(two) == 2
    assert "named entities" in calls[1][0]["content"]


# ------------------------------------------------- served by name, and C11

def _servers(jex, tex):
    port = _free_port()
    jserver = _ServerThread(JChainServer(jex).app, port)
    jserver.start()
    _, httpd, thread = tapi.serve_in_thread(tex)
    urls = (f"http://127.0.0.1:{port}",
            f"http://127.0.0.1:{httpd.server_address[1]}")

    def stop():
        jserver.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    return urls, stop


def _both_http(urls, method, path, **kw):
    return [requests.request(method, url + path, timeout=120, **kw)
            for url in urls]


def _upload(urls, path, name):
    for url in urls:
        with open(path, "rb") as fh:
            resp = requests.post(url + "/documents",
                                 files={"file": (name, fh)}, timeout=60)
        assert resp.status_code == 200, resp.text


@pytest.mark.parametrize("name", ["structured_data_rag",
                                  "knowledge_graph_rag"])
def test_data_chains_served_by_name(name, pair, tmp_path,  # noqa: F811
                                    monkeypatch):
    """Both chains by name from both registries behind both chain
    servers: the same uploads, the same listing, byte-equal ``/generate``
    bodies (the structured chain reads its CSV after the port's server
    removed the upload)."""
    assert name in registry._KNOWN and name not in registry.NOT_PORTED
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "UPLOAD_DIR", str(tmp_path / mod.__name__))
    if name == "structured_data_rag":
        replies = ["result = df['age'].max()", "Fourteen months."]
        kw = lambda package: {"state_dir": str(tmp_path / package)}
        upload = _write(tmp_path, "machines.csv", MACHINES)
    else:
        replies = [TRIPLES_REPLY, "Nvidia introduced the H100."]
        kw = lambda package: {}
        upload = _write(tmp_path, "news.txt", "Nvidia introduced the H100 "
                        "GPU in Santa Clara.")
    examples = [PACKAGES[package]["registry"].get_example(
        name, context=_scripted(pair, package, list(replies)),
        **kw(package)) for package in PACKAGES]
    assert type(examples[1]).__module__ == registry._KNOWN[name]
    urls, stop = _servers(*examples)
    try:
        _upload(urls, upload, upload.rsplit("/", 1)[-1])
        listed = [r.json() for r in _both_http(urls, "GET", "/documents")]
        body = {"messages": [{"role": "user", "content": "What did Nvidia "
                              "introduce, and how old is the oldest "
                              "machine?"}],
                "use_knowledge_base": True, "max_tokens": 16}
        want, got = _both_http(urls, "POST", "/generate", json=body,
                               headers={"X-Request-Id": RID})
    finally:
        stop()
    assert listed[0] == listed[1] and len(listed[1]["documents"]) == 1
    assert got.status_code == want.status_code == 200
    assert got.content == want.content
    text = "".join(json.loads(f[len("data: "):])["choices"][0]["message"]
                   ["content"] for f in got.content.decode().split("\n\n")
                   if f and f != "data: [DONE]")
    assert text == replies[-1]


def test_c11_delete_answers(pair, tmp_path, monkeypatch):  # noqa: F811
    """ROADMAP C11: the reference's ``KnowledgeGraphRAG.delete_documents``
    returns None, so its chain server answers ``{"deleted": false}`` after
    a real delete; the port's answers ``true``, and a second delete of the
    same name is false on both."""
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "UPLOAD_DIR", str(tmp_path / mod.__name__))
    jex = jregistry.get_example(
        "knowledge_graph_rag", context=_scripted(pair, "jax",
                                                 [TRIPLES_REPLY]))
    tex = registry.get_example(
        "knowledge_graph_rag", context=_scripted(pair, "torch",
                                                 [TRIPLES_REPLY]))
    doc = _write(tmp_path, "news.txt", "Nvidia introduced the H100 GPU in "
                 "Santa Clara.")
    urls, stop = _servers(jex, tex)
    try:
        _upload(urls, doc, "news.txt")
        edges = [jex.graph.number_of_edges(), tex.graph.number_of_edges()]
        target = "/documents?filename=news.txt"
        first = [r.json() for r in _both_http(urls, "DELETE", target)]
        after = [r.json()["documents"]
                 for r in _both_http(urls, "GET", "/documents")]
        again = [r.json() for r in _both_http(urls, "DELETE", target)]
    finally:
        stop()
    assert edges == [2, 2]
    assert after == [[], []]          # both removed the passages and edges
    assert jex.graph.number_of_edges() == tex.graph.number_of_edges() == 0
    assert first == [{"deleted": False}, {"deleted": True}]
    assert again == [{"deleted": False}, {"deleted": False}]
    assert jex.delete_documents(["news.txt"]) is None
    assert tex.delete_documents(["news.txt"]) is False


def test_kg_delete_of_edges_alone_answers_true(pair):  # noqa: F811
    """Edges with no passage in the store (added by hand) still count as
    removed."""
    kg = tkg.KnowledgeGraphRAG(context=_scripted(pair, "torch", []))
    kg.graph.add_edge("A", "B", relation="Has", source="hand.txt")
    assert kg.delete_documents(["hand.txt"]) is True
    assert kg.graph.number_of_nodes() == 0
    assert kg.delete_documents(["hand.txt"]) is False


def test_modules_import_without_pandas_or_networkx():
    """The data chains import pandas and networkx only inside the
    functions that use them, as the reference does."""
    import ast
    for mod in (tsd, tkg):
        tree = ast.parse(open(mod.__file__).read())
        top = [node for node in tree.body
               if isinstance(node, (ast.Import, ast.ImportFrom))]
        names = {alias.name.split(".")[0] for node in top
                 for alias in node.names}
        names |= {node.module.split(".")[0] for node in top
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert not names & {"pandas", "networkx"}, mod.__name__
