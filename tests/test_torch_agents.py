"""The port's agentic chains against the JAX package's on the CPU.

``query_decomposition``, ``agentic_rag``, ``router_rag`` and ``text_to_sql``
run over both packages with the same inputs:

  * **a scripted LLM** (the reference's own cases, from
    ``tests/test_advanced_chains.py`` and ``tests/test_breadth_chains.py``):
    the same replies in the same order, over ``test_torch_chains.py``'s
    ``pair`` encoders (tiny BERT, f32, the port's carried across by
    ``bert.params_from_jax``). Each case runs on both packages; their
    outputs, the messages their LLM received and the guardrail context
    they recorded must be equal, and the reference's own assertions hold
    on both;
  * **the same tiny weights** (``pair``: the tiny llama of
    ``jax.random.PRNGKey(99)``, f32, greedy): ``AgenticRAG.rag_chain``'s
    fused pools (documents equal, query vectors within 1e-5), grades,
    rewrites, prompt ids, lookahead counters and streamed text, and
    ``RouterRAG.rag_chain``'s route, prompt ids and text, all equal.

Also here: ``extract_json`` of both packages on a corpus of model-shaped
replies, and ``document_search`` / ``delete_documents`` of ``agentic_rag``
after interleaved uploads (its BM25 index is the instance's).
"""

import dataclasses
import json
import sqlite3

import numpy as np
import pytest

from generativeaiexamples_tpu.chains import agentic_rag as jagentic
from generativeaiexamples_tpu.chains import query_decomposition as jqd
from generativeaiexamples_tpu.chains import router_rag as jrouter
from generativeaiexamples_tpu.chains import text_to_sql as jsql
from generativeaiexamples_tpu.chains.context import ChainContext as JContext
from generativeaiexamples_tpu.core.metrics import REGISTRY as JREGISTRY
from generativeaiexamples_tpu.server import guardrails as jguardrails
from generativeaiexamples_tpu_torch.chains import agentic_rag as tagentic
from generativeaiexamples_tpu_torch.chains import query_decomposition as tqd
from generativeaiexamples_tpu_torch.chains import router_rag as trouter
from generativeaiexamples_tpu_torch.chains import text_to_sql as tsql
from generativeaiexamples_tpu_torch.chains.context import ChainContext
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.server import guardrails as tguardrails
from test_torch_chains import DOCS, _spy, pair  # noqa: F401

ATOL = 1e-5
PACKAGES = {
    "jax": dict(ctx=JContext, qd=jqd, agentic=jagentic, router=jrouter,
                sql=jsql, guardrails=jguardrails, registry=JREGISTRY),
    "torch": dict(ctx=ChainContext, qd=tqd, agentic=tagentic,
                  router=trouter, sql=tsql, guardrails=tguardrails,
                  registry=REGISTRY),
}


class FakeLLM:
    """Yields scripted replies in order, each in two chunks; records the
    messages of every call."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def chat(self, messages, **settings):
        self.calls.append([dict(m) for m in messages])
        text = self.responses.pop(0) if self.responses else "default answer"
        mid = max(1, len(text) // 2)
        yield text[:mid]
        yield text[mid:]


def _scripted(pair, package, responses):  # noqa: F811
    """A context of ``package`` over ``pair``'s encoders, its LLM scripted
    with ``responses``."""
    base = pair[0] if package == "jax" else pair[1]
    return PACKAGES[package]["ctx"](
        config=base.config, llm=FakeLLM(responses), embedder=base.embedder,
        reranker=base.reranker)


def _both(run, close=()):
    """``run(package)`` on both packages: their results equal, but for the
    items at the indices ``close``, which agree within ATOL."""
    got = {package: run(package) for package in PACKAGES}
    for i, (g, w) in enumerate(zip(got["torch"], got["jax"])):
        if i in close:
            np.testing.assert_allclose(g, w, atol=ATOL)
        else:
            assert g == w, i
    return got["torch"]


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ------------------------------------------------- query decomposition agent

def test_query_decomposition_search_then_final(pair, tmp_path):  # noqa: F811
    responses = [
        json.dumps({"Tool_Request": "Search",
                    "Generated Sub Questions": ["height of Everest?"]}),
        "8849 meters",
        json.dumps({"Tool_Request": "Nil",
                    "Generated Sub Questions": ["Nil"]}),
        "Everest is 8849 meters tall.",
    ]
    doc = _write(tmp_path, "mountains.txt",
                 "Mount Everest is 8849 meters tall. K2 is 8611 meters.")

    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, responses)
        chain = mods["qd"].QueryDecompositionRAG(context=ctx)
        chain.ingest_docs(doc, "mountains.txt")
        mods["guardrails"].take_context()
        out = "".join(chain.rag_chain("how tall is Everest?", []))
        return out, ctx.llm.calls, mods["guardrails"].take_context()

    out, calls, recorded = _both(run)
    assert out == "Everest is 8849 meters tall."
    final_prompt = calls[-1][0]["content"]
    assert "Sub Question: height of Everest?" in final_prompt
    assert "Sub Answer: 8849 meters" in final_prompt
    # the fact-check rail judges against the sub-Q/A lines
    assert recorded == ("Sub Question: height of Everest?\n"
                        "Sub Answer: 8849 meters")


@pytest.mark.parametrize("reply, expect", [
    (json.dumps({"IsPossible": "Possible", "variable1": 6, "variable2": 7,
                 "operation": "*"}), "6.0*7.0=42.0"),
    (json.dumps({"variable1": ["1,200 m"], "variable2": "300",
                 "operation": ["-"]}), "1200.0-300.0=900.0"),
    # an unknown operator falls back to the LLM's own answer
    (json.dumps({"variable1": 2, "variable2": 3, "operation": "**"}),
     "Sub Answer: The result is 42."),
])
def test_query_decomposition_math_tool(pair, reply, expect):  # noqa: F811
    responses = [
        json.dumps({"Tool_Request": "Math",
                    "Generated Sub Questions": ["what is 6 times 7?"]}),
        reply,
        "The result is 42.",
    ]

    def run(package):
        ctx = _scripted(pair, package, responses)
        chain = PACKAGES[package]["qd"].QueryDecompositionRAG(context=ctx)
        return "".join(chain.rag_chain("what is 6*7?", [])), ctx.llm.calls

    out, calls = _both(run)
    assert expect in calls[-1][0]["content"]


@pytest.mark.parametrize("selector", [
    "no json at all",
    json.dumps({"Tool_Request": "Teleport",
                "Generated Sub Questions": ["x"]}),
    json.dumps({"Tool_Request": "Search", "Generated Sub Questions": []}),
])
def test_query_decomposition_stops_without_evidence(pair, selector):  # noqa: F811
    """A selector reply with no JSON, an unknown tool or no sub-question
    ends the loop with no ledger: the no-context message, no final call."""
    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, [selector])
        chain = mods["qd"].QueryDecompositionRAG(context=ctx)
        return "".join(chain.rag_chain("anything?", [])), ctx.llm.calls

    out, calls = _both(run)
    assert out.startswith("No response generated from LLM")
    assert len(calls) == 1


def test_query_decomposition_trace_limit(pair, tmp_path):  # noqa: F811
    """Search rounds stop past MAX_TRACE, and a repeated sub-question stops
    the loop at once."""
    doc = _write(tmp_path, "kb.txt", "Facts about mountains and rivers.")
    rounds = []
    for i in range(5):
        rounds += [json.dumps({"Tool_Request": "Search",
                               "Generated Sub Questions": [f"q{i}?"]}),
                   f"a{i}"]

    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, rounds)
        chain = mods["qd"].QueryDecompositionRAG(context=ctx)
        chain.ingest_docs(doc, "kb.txt")
        out = "".join(chain.rag_chain("many hops?", []))
        calls = ctx.llm.calls
        ctx.llm = FakeLLM([
            json.dumps({"Tool_Request": "Search",
                        "Generated Sub Questions": ["same?"]}), "x",
            json.dumps({"Tool_Request": "Search",
                        "Generated Sub Questions": ["same?"]}), "final"])
        again = "".join(chain.rag_chain("loop?", []))
        return out, calls, again, ctx.llm.calls

    out, calls, again, repeat_calls = _both(run)
    # four rounds of search (the trace passes MAX_TRACE after the fourth),
    # the fifth selector's reply read, then the final answer
    assert calls[-1][0]["content"].count("Sub Question:") == (
        tqd.MAX_TRACE + 1)
    assert len(calls) == 2 * (tqd.MAX_TRACE + 1) + 2 and out == "a4"
    assert again == "final" and len(repeat_calls) == 4


# ------------------------------------------------------------- extract_json

EXTRACT_CORPUS = [
    'noise {"a": 1} trailing',
    "no json here",
    '{"bad": } {"good": [1, 2]}',
    '[{"score": 5}]',
    '[1, 2] then {"a": 3}',
    '{"cmd": "grep \'}\' src.c"}',
    '[[{"deep": {"x": [1, {"y": 2}]}}]]',
    'Sure! ```json\n{"score": "yes"}\n``` hope that helps',
    '{"text": "a \\"quoted\\" {brace"} and {"b": 2}',
    '{"truncated": [1, 2',
    '{"a": 1',
    '[{"a": 1}, {"b": 2}]',
    '"just a string" {"k": null}',
    '{} then {"x": 1}',
    "{'single': 'quotes'} {\"double\": true}",
    'été {"café": "crème"}',
    "",
    "}{",
    '[1, 2, 3]',
    '{"nested": {"inner": {"deep": "}"}}}',
]


@pytest.mark.parametrize("text", EXTRACT_CORPUS)
def test_extract_json_matches_jax(text):
    assert tqd.extract_json(text) == jqd.extract_json(text)


def test_extract_json_robust():
    """The reference's own cases, on the port."""
    extract_json = tqd.extract_json
    assert extract_json('noise {"a": 1} trailing') == {"a": 1}
    assert extract_json("no json here") is None
    assert extract_json('{"bad": } {"good": [1, 2]}') == {"good": [1, 2]}
    assert extract_json('[{"score": 5}]') == {"score": 5}
    assert extract_json('[1, 2] then {"a": 3}') == {"a": 3}
    assert extract_json('{"cmd": "grep \'}\' src.c"}') == {
        "cmd": "grep '}' src.c"}


@pytest.mark.parametrize("value", [
    3, 2.5, "42", "-1,500.25 units", ["7"], (8,), "no digits"])
def test_scalar_matches_jax(value):
    def call(mod):
        try:
            return mod._scalar(value)
        except ValueError as exc:
            return f"ValueError: {exc}"
    assert call(tqd) == call(jqd)


# ------------------------------------------------------------- agentic rag

def test_agentic_rag_accepts_grounded_answer(pair, tmp_path):  # noqa: F811
    doc = _write(tmp_path, "kb.txt",
                 "Ring attention passes KV blocks around the ICI ring. "
                 "It enables long-context prefill on TPU pods.")
    yes = json.dumps({"score": "yes"})
    responses = [yes, "Ring attention enables long context.", yes, yes]

    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, [])
        chain = mods["agentic"].AgenticRAG(context=ctx)
        chain.ingest_docs(doc, "kb.txt")
        ctx.llm.responses = list(responses)
        mods["guardrails"].take_context()
        out = "".join(chain.rag_chain("what does ring attention do?", []))
        return out, ctx.llm.calls, mods["guardrails"].take_context()

    out, calls, recorded = _both(run)
    assert out == "Ring attention enables long context."
    assert len(calls) == 4 and "Ring attention passes" in recorded


def test_agentic_rag_rewrites_on_irrelevant_docs(pair, tmp_path):  # noqa: F811
    doc = _write(tmp_path, "kb.txt",
                 "Bananas are yellow fruit rich in potassium.")
    yes, no = json.dumps({"score": "yes"}), json.dumps({"score": "no"})
    responses = [no, "what color are bananas?", yes, "Bananas are yellow.",
                 yes, yes]

    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, [])
        chain = mods["agentic"].AgenticRAG(context=ctx)
        chain.ingest_docs(doc, "kb.txt")
        ctx.llm.responses = list(responses)
        out = "".join(chain.rag_chain("hue of the fruit?", []))
        return out, ctx.llm.calls

    out, calls = _both(run)
    assert out == "Bananas are yellow."
    assert "hue of the fruit?" in calls[1][0]["content"]     # the rewriter
    assert "what color are bananas?" in calls[2][0]["content"]


@pytest.mark.parametrize("script, expect", [
    # not grounded, twice, then grounded and useful: regenerated in place
    (["yes", "g1", "no", "yes", "g2", "no", "yes", "g3", "yes", "yes"],
     "g3"),
    # grounded but not useful: rewrite with the held docs, then accept
    (["yes", "g1", "yes", "no", "better question", "yes", "g2", "yes",
      "yes"], "g2"),
    # every pass rejected: the last generation stands
    (["yes", "g1", "no", "yes", "g2", "no", "yes", "g3", "no"], "g3"),
    # the graders reject the documents on every pass
    (["no", "r1", "no", "r2", "no"], "No response generated from LLM, make "
     "sure your query is relevant to the ingested document."),
])
def test_agentic_rag_retry_paths(pair, tmp_path, script, expect):  # noqa: F811
    doc = _write(tmp_path, "kb.txt", "Bananas are yellow fruit.")
    replies = [json.dumps({"score": s}) if s in ("yes", "no") else s
               for s in script]

    def run(package):
        mods = PACKAGES[package]
        registry = mods["registry"]
        ctx = _scripted(pair, package, [])
        chain = mods["agentic"].AgenticRAG(context=ctx)
        chain.ingest_docs(doc, "kb.txt")
        ctx.llm.responses = list(replies)
        before = [registry.counter(name).value
                  for name in ("lookahead_reuse", "lookahead_requery")]
        out = "".join(chain.rag_chain("banana colour?", []))
        after = [registry.counter(name).value
                 for name in ("lookahead_reuse", "lookahead_requery")]
        return out, ctx.llm.calls, [a - b for a, b in zip(after, before)]

    out, calls, _ = _both(run)
    assert out == expect and len(calls) == len(replies)


def test_agentic_rag_search_and_delete_after_interleaved_uploads(
        pair, tmp_path):  # noqa: F811
    texts = {"a.txt": "Llamas live in the Andes and eat grass.",
             "b.txt": "Paged attention shares the pages of a prefix.",
             "c.txt": "Llamas and alpacas are camelids of the Andes."}

    def run(package):
        mods = PACKAGES[package]
        chain = mods["agentic"].AgenticRAG(context=_scripted(pair, package,
                                                             []))
        seen = []
        for name, text in texts.items():
            chain.ingest_docs(_write(tmp_path, name, text), name)
            seen.append(chain.document_search("llamas in the Andes", 4))
        deleted = chain.delete_documents(["a.txt"])
        seen.append(chain.document_search("llamas in the Andes", 4))
        seen.append(chain.document_search("paged attention shares pages", 1))
        missing = chain.delete_documents(["nope.txt"])
        return seen, deleted, missing, chain.get_documents(), len(
            chain._bm25_docs)

    seen, deleted, missing, listed, kept = _both(run)
    assert deleted is True and missing is False and kept == 2
    assert sorted(listed) == ["b.txt", "c.txt"]
    assert all(h["source"] != "a.txt" for h in seen[3])
    assert seen[4][0]["source"] == "b.txt"


# --------------------------------------------------------------- router rag

class FakeWeb:
    def search(self, query, max_results=3):
        return [{"snippet": "TPU v5e has 197 TFLOP/s bf16 peak.",
                 "url": "https://example.com/tpu"},
                {"content": "no url here"}]


def test_router_routes_and_synthesizes(pair, tmp_path):  # noqa: F811
    doc = _write(tmp_path, "notes.txt",
                 "Our cluster uses TPU v5e accelerators for serving.")
    responses = ['{"sources": ["kb", "web"], "rewritten": "tpu v5e peak"}',
                 "Per [web], the v5e peaks at 197 TFLOP/s."]

    def run(package):
        mods = PACKAGES[package]
        ctx = _scripted(pair, package, responses)
        router = mods["router"].RouterRAG(context=ctx, web_client=FakeWeb())
        router.ingest_docs(doc, "notes.txt")
        answer = "".join(router.rag_chain("What is the v5e peak?", []))
        hits = router.document_search("v5e", 2)
        return (answer, ctx.llm.calls, [(h["source"], h["content"])
                                        for h in hits],
                [h["score"] for h in hits])

    answer, calls, hits, _ = _both(run, close=(3,))
    assert "197" in answer
    system = calls[-1][0]["content"]
    assert "[web]" in system and "[kb]" in system
    assert hits and hits[0][0] == "notes.txt"


def test_router_direct_route_skips_retrieval(pair):  # noqa: F811
    def run(package):
        ctx = _scripted(pair, package, [
            '{"sources": ["direct"], "rewritten": ""}', "Hello to you too!"])
        router = PACKAGES[package]["router"].RouterRAG(context=ctx)
        return "".join(router.rag_chain("hi there", [])), ctx.llm.calls

    answer, calls = _both(run)
    assert answer == "Hello to you too!"
    assert all(m.get("role") != "system" for m in calls[-1])


@pytest.mark.parametrize("reply", [
    "garbage", '{"sources": ["direct"], "rewritten": "x"}',
    '{"sources": "kb"}', '{"sources": 5}', '{"sources": ["web", "moon"]}',
    '[{"sources": ["kb"], "rewritten": "  padded  "}]',
    '{"sources": [], "rewritten": "x"}'])
def test_parse_route_matches_jax(reply):
    assert trouter.parse_route(reply) == jrouter.parse_route(reply)


# -------------------------------------------------------------- text to sql

@pytest.fixture()
def sql_db(tmp_path):
    path = str(tmp_path / "shop.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE orders (id INTEGER PRIMARY KEY, "
                 "customer TEXT, total REAL)")
    conn.executemany("INSERT INTO orders (customer, total) VALUES (?, ?)",
                     [("ada", 10.0), ("bob", 32.5), ("ada", 7.5)])
    conn.commit()
    conn.close()
    return path


def test_text_to_sql_generates_and_runs(pair, sql_db):  # noqa: F811
    sql = "SELECT customer, SUM(total) AS spend FROM orders GROUP BY customer"

    def run(package):
        ctx = _scripted(pair, package, [sql, sql, "Ada spent 17.5 in total."])
        t2s = PACKAGES[package]["sql"].TextToSQL(context=ctx, db_path=sql_db)
        trained = t2s.auto_train_schema()
        t2s.train(question="total per customer",
                  sql="SELECT customer, SUM(total) FROM orders GROUP BY "
                      "customer")
        t2s.train(documentation="The orders table records each purchase.")
        result = t2s.ask("How much did each customer spend?")
        answer = "".join(t2s.rag_chain("How much did each customer spend?",
                                       []))
        return trained, result, answer, ctx.llm.calls

    trained, result, answer, calls = _both(run)
    assert trained >= 1
    assert result["columns"] == ["customer", "spend"]
    assert ("ada", 17.5) in result["rows"]
    assert "CREATE TABLE orders" in calls[0][0]["content"]
    assert "17.5" in answer


def test_text_to_sql_blocks_writes(pair, sql_db):  # noqa: F811
    for package, mods in PACKAGES.items():
        t2s = mods["sql"].TextToSQL(context=_scripted(pair, package, []),
                                    db_path=sql_db)
        with pytest.raises(sqlite3.Error):
            t2s.run_sql("DROP TABLE orders")
        with pytest.raises(sqlite3.Error):
            t2s.run_sql("INSERT INTO orders (customer, total) "
                        "VALUES ('x', 1)")
        with pytest.raises(ValueError):
            t2s.run_sql("")
        assert t2s.run_sql("SELECT COUNT(*) AS n FROM orders")[1] == [(3,)]
    # the in-memory database keeps the authorizer on its shared connection
    t2s = tsql.TextToSQL(context=_scripted(pair, "torch", []))
    t2s.conn.execute("CREATE TABLE t (a INTEGER)")
    t2s.run_sql("SELECT * FROM t")
    with pytest.raises(sqlite3.Error):
        t2s.run_sql("DELETE FROM t")


@pytest.mark.parametrize("reply", [
    "```sql\nSELECT 1;\n```", "Here you go: SELECT a FROM b; -- done",
    "I cannot write that query",
    "SELECT * FROM t WHERE c = 'a;b';",
    "with x as (select 1) select * from x; drop table y",
    "```\nSELECT \"semi;colon\" FROM t\n```",
])
def test_extract_sql_matches_jax(reply):
    assert tsql.extract_sql(reply) == jsql.extract_sql(reply)


def test_extract_sql_cases():
    extract_sql = tsql.extract_sql
    assert extract_sql("```sql\nSELECT 1;\n```") == "SELECT 1"
    assert extract_sql("Here you go: SELECT a FROM b; -- done") == \
        "SELECT a FROM b"
    assert extract_sql("I cannot write that query") == ""
    assert extract_sql("SELECT * FROM t WHERE c = 'a;b';") == \
        "SELECT * FROM t WHERE c = 'a;b'"


def test_text_to_sql_error_surfaces_politely(pair, sql_db):  # noqa: F811
    def run(package):
        ctx = _scripted(pair, package, ["DELETE FROM orders"])
        t2s = PACKAGES[package]["sql"].TextToSQL(context=ctx, db_path=sql_db)
        return "".join(t2s.rag_chain("wipe it", [])), ctx.llm.calls

    answer, _ = _both(run)
    assert "could not answer" in answer


# ---------------------------------------------- the same tiny weights

def _with_top_k(ctx, cls, top_k):
    """``ctx``'s engine and encoders, a retriever of ``top_k``, new stores."""
    config = dataclasses.replace(ctx.config, retriever=dataclasses.replace(
        ctx.config.retriever, top_k=top_k))
    return cls(config=config, llm=ctx.llm, embedder=ctx.embedder,
               reranker=ctx.reranker)


def _agentic_spy(chain):
    """Record the chain's fused pools, grades and rewrites."""
    log = {"pools": [], "grades": [], "rewrites": []}
    hybrid, grade, rewrite = (chain._hybrid_with_vec, chain._grade,
                              chain._rewrite_question)

    def spy_hybrid(query, top_k, qvec=None):
        out = hybrid(query, top_k, qvec)
        log["pools"].append((query, np.asarray(out[0], np.float32),
                             [d.content for d in out[1]]))
        return out

    def spy_grade(prompt, **settings):
        out = grade(prompt, **settings)
        log["grades"].append(out)
        return out

    def spy_rewrite(question, **settings):
        out = rewrite(question, **settings)
        log["rewrites"].append(out)
        return out

    chain._hybrid_with_vec = spy_hybrid
    chain._grade = spy_grade
    chain._rewrite_question = spy_rewrite
    return log


def test_agentic_rag_matches_jax_on_tiny_weights(pair, tmp_path):  # noqa: F811
    """One retrieved document a pass (top_k 1) to bound the graders'
    calls; the random model's grades decide the path, the same on both."""
    jctx, tctx = (_with_top_k(pair[0], JContext, 1),
                  _with_top_k(pair[1], ChainContext, 1))
    jchain, tchain = (jagentic.AgenticRAG(context=jctx),
                      tagentic.AgenticRAG(context=tctx))
    for name, text in DOCS.items():
        path = _write(tmp_path, name, text)
        jchain.ingest_docs(path, name)
        tchain.ingest_docs(path, name)
    logs = {}
    counters = {}
    for package, chain in (("jax", jchain), ("torch", tchain)):
        registry = PACKAGES[package]["registry"]
        before = [registry.counter(n).value
                  for n in ("lookahead_reuse", "lookahead_requery")]
        log = _agentic_spy(chain)
        prompts, undo = _spy(chain)
        try:
            log["text"] = "".join(chain.rag_chain(
                "where do llamas live?", [], max_tokens=8, temperature=0.0))
        finally:
            undo()
        log["prompts"] = prompts["prompts"]
        logs[package] = log
        counters[package] = [registry.counter(n).value - b for n, b in zip(
            ("lookahead_reuse", "lookahead_requery"), before)]
    want, got = logs["jax"], logs["torch"]
    assert len(got["pools"]) == len(want["pools"]) >= 1
    for (tq, tvec, tdocs), (jq, jvec, jdocs) in zip(got["pools"],
                                                    want["pools"]):
        assert tq == jq and tdocs == jdocs
        np.testing.assert_allclose(tvec, jvec, atol=ATOL)
    for key in ("grades", "rewrites", "prompts", "text"):
        assert got[key] == want[key], key
    assert counters["torch"] == counters["jax"]
    assert got["grades"] and got["text"]


def test_router_rag_matches_jax_on_tiny_weights(pair, tmp_path):  # noqa: F811
    jctx, tctx = pair
    jrouter_, trouter_ = (jrouter.RouterRAG(context=jctx),
                          trouter.RouterRAG(context=tctx))
    for name, text in DOCS.items():
        path = _write(tmp_path, name, text)
        jrouter_.ingest_docs(path, name)
        trouter_.ingest_docs(path, name)
    out = {}
    for package, chain in (("jax", jrouter_), ("torch", trouter_)):
        routes = []
        route = chain.route

        def spy_route(query, route=route, routes=routes):
            decision = route(query)
            routes.append(decision)
            return decision

        chain.route = spy_route
        prompts, undo = _spy(chain)
        try:
            text = "".join(chain.rag_chain("how are pages shared?", [],
                                           max_tokens=8, temperature=0.0))
        finally:
            undo()
        out[package] = (routes, prompts["prompts"], text)
    assert out["torch"] == out["jax"]
    routes, prompts, text = out["torch"]
    assert len(routes) == 1 and len(prompts) == 2
