"""The port's chains against the JAX package's on the CPU.

``basic_rag`` and ``multi_turn_rag`` run over both packages with the same
weights: the tiny llama (``jax.random.PRNGKey(99)``) carried across by
``llama.params_from_jax``, tiny BERT encoders carried across by
``bert.params_from_jax``, f32, greedy, the same configuration (chunks of
120 tokens with 40 of overlap and a context budget of 400 tokens, so the
prompts stay short). Compared:

  * the stores after ingestion and after each conversation turn: chunks
    and sources equal, embeddings within 1e-5 (the encoders agree within
    1e-5 in f32, ``tests/test_torch_encoders.py``);
  * ``document_search``: the same hits in the same order, scores within
    1e-5;
  * for each turn (the second with history, so it condenses and takes the
    lookahead path): the condensed query, both pools, the reranked order
    and the prompt ids the engine received, all equal, and the streamed
    text equal.

The lookahead cases mirror the reference's (``tests/test_rag_pipeline.py``),
run on both packages' ``LookaheadRetrieval``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.chains import basic_rag as jbasic
from generativeaiexamples_tpu.chains import lookahead as jlook
from generativeaiexamples_tpu.chains import multi_turn_rag as jmulti
from generativeaiexamples_tpu.chains.context import ChainContext as JContext
from generativeaiexamples_tpu.chains.llm_client import LocalLLM as JLocalLLM
from generativeaiexamples_tpu.core import config as jconfig
from generativeaiexamples_tpu.core.metrics import REGISTRY as JREGISTRY
from generativeaiexamples_tpu.encoders import Embedder as JEmbedder
from generativeaiexamples_tpu.encoders import Reranker as JReranker
from generativeaiexamples_tpu.engine.engine import EngineCore as JCore
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JByte
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.chains import basic_rag as tbasic
from generativeaiexamples_tpu_torch.chains import lookahead as tlook
from generativeaiexamples_tpu_torch.chains import multi_turn_rag as tmulti
from generativeaiexamples_tpu_torch.chains.context import ChainContext
from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
from generativeaiexamples_tpu_torch.core import config as tconfig
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import bert, llama

ATOL = 1e-5
GEOMETRY = dict(max_batch_size=4, max_seq_len=1024, prefill_chunk=64,
                page_size=16)
DOCS = {
    "llamas.txt": ("Llamas are domesticated camelids from South America. "
                   "They live in the Andes mountains, carry loads and give "
                   "wool. A group of llamas is called a herd.\n\n"
                   "Alpacas are smaller than llamas and are bred for their "
                   "fibre. Both graze on grass in the high plains."),
    "kernels.txt": ("Paged attention keeps the key and value cache in fixed "
                    "pages, so requests share the pages of a common prefix."
                    "\n\nThe scheduler admits requests into free slots and "
                    "batches their decode steps together on the card. "
                    "Flash prefill computes causal attention in tiles."),
}
QUERIES = ("where do llamas live?", "how does paged attention share pages?")


def _configs():
    def cut(cfg, mod):
        return dataclasses.replace(
            cfg, text_splitter=mod.TextSplitterConfig(chunk_size=120,
                                                      chunk_overlap=40),
            retriever=dataclasses.replace(cfg.retriever,
                                          max_context_tokens=400))
    return cut(jconfig.AppConfig(), jconfig), cut(tconfig.AppConfig(),
                                                  tconfig)


@pytest.fixture(scope="module")
def pair():
    """(JAX context, the port's) over the same weights, engines started."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(99), jcfg)
    jcore = JCore(jcfg, jconfig.EngineConfig(**GEOMETRY), jparams,
                  eos_id=JByte().eos_id)
    tcore = EngineCore(llama.LlamaConfig.tiny(vocab_size=300),
                       tconfig.EngineConfig(**GEOMETRY),
                       llama.params_from_jax(jax.tree.map(np.asarray,
                                                          jparams),
                                             llama.LlamaConfig.tiny(
                                                 vocab_size=300)),
                       eos_id=ByteTokenizer().eos_id, device="cpu")
    jsched, tsched = JScheduler(jcore, JByte()), Scheduler(tcore,
                                                           ByteTokenizer())
    je, jr = JEmbedder(), JReranker()
    te = Embedder(cfg=bert.BertConfig.tiny(), device="cpu",
                  params=bert.params_from_jax(
                      jax.tree.map(np.asarray, je.params),
                      bert.BertConfig.tiny()))
    tr = Reranker(cfg=bert.BertConfig.tiny(), device="cpu",
                  params=bert.params_from_jax(
                      jax.tree.map(np.asarray, jr.params),
                      bert.BertConfig.tiny()))
    jcfg_app, tcfg_app = _configs()
    jsched.start()
    tsched.start()
    try:
        yield (JContext(config=jcfg_app, llm=JLocalLLM(jsched), embedder=je,
                        reranker=jr),
               ChainContext(config=tcfg_app, llm=LocalLLM(tsched),
                            embedder=te, reranker=tr))
    finally:
        jsched.stop()
        tsched.stop()


def _rows(store):
    live = [i for i, d in enumerate(store._docs) if d is not None]
    matrix = store._matrix
    matrix = (matrix.cpu().numpy() if hasattr(matrix, "cpu")
              else np.asarray(matrix))
    return ([(store._docs[i].content, store._docs[i].metadata["source"])
             for i in live], matrix[live])


def _assert_stores_equal(jstore, tstore):
    jdocs, jvecs = _rows(jstore)
    tdocs, tvecs = _rows(tstore)
    assert tdocs == jdocs
    np.testing.assert_allclose(tvecs, jvecs, atol=ATOL)


def _ingest(tmp_path, jchain, tchain):
    for name, text in DOCS.items():
        path = tmp_path / name
        path.write_text(text)
        jchain.ingest_docs(str(path), name)
        tchain.ingest_docs(str(path), name)


def _spy(chain):
    """Record the chain's engine prompts (and, for multi_turn_rag, its
    condensed queries, pools and reranked funnels)."""
    log = {"prompts": [], "condensed": [], "pools": [], "funnels": {}}
    sched = chain.ctx.llm.scheduler
    submit = sched.submit

    def spy_submit(req):
        log["prompts"].append(list(req.prompt_ids))
        return submit(req)

    sched.submit = spy_submit
    if hasattr(chain, "_condense"):
        condense, pool, funnel = (chain._condense, chain._retrieve_pool,
                                  chain._funnel)

        def spy_condense(*args, **kwargs):
            out = condense(*args, **kwargs)
            log["condensed"].append(out)
            return out

        def spy_pool(collection, qvec, wide):
            out = pool(collection, qvec, wide)
            log["pools"].append((collection, list(out)))
            return out

        def spy_funnel(query, passages):
            out = funnel(query, passages)
            log["funnels"][(query, tuple(passages))] = list(out)
            return out

        chain._condense = spy_condense
        chain._retrieve_pool = spy_pool
        chain._funnel = spy_funnel
    return log, lambda: setattr(sched, "submit", submit)


def _search_equal(jchain, tchain, query):
    want = jchain.document_search(query, 4)
    got = tchain.document_search(query, 4)
    assert [(h["source"], h["content"]) for h in got] == \
        [(h["source"], h["content"]) for h in want]
    np.testing.assert_allclose([h["score"] for h in got],
                               [h["score"] for h in want], atol=ATOL)
    return got


def test_basic_rag_matches_jax(pair, tmp_path):
    jctx, tctx = pair
    jchain, tchain = jbasic.BasicRAG(context=jctx), tbasic.BasicRAG(
        context=tctx)
    _ingest(tmp_path, jchain, tchain)
    _assert_stores_equal(jctx.store(jbasic.COLLECTION),
                         tctx.store(tbasic.COLLECTION))
    assert tchain.get_documents() == jchain.get_documents()
    for query in QUERIES:
        assert _search_equal(jchain, tchain, query)
    jlog, jundo = _spy(jchain)
    tlog, tundo = _spy(tchain)
    try:
        settings = dict(max_tokens=12, temperature=0.0)
        for query in QUERIES:
            want = "".join(jchain.rag_chain(query, [], **settings))
            got = "".join(tchain.rag_chain(query, [], **settings))
            assert got == want
        history = [{"role": "user", "content": QUERIES[0]},
                   {"role": "assistant", "content": "in the Andes"}]
        assert ("".join(tchain.llm_chain("and alpacas?", history,
                                         **settings))
                == "".join(jchain.llm_chain("and alpacas?", history,
                                            **settings)))
    finally:
        jundo()
        tundo()
    assert len(tlog["prompts"]) == 3 and tlog["prompts"] == jlog["prompts"]
    # the top passage of each query is in its prompt
    top = tchain.document_search(QUERIES[0], 1)[0]["content"]
    assert top[:60] in ByteTokenizer().decode(tlog["prompts"][0])
    assert tchain.delete_documents(["kernels.txt"]) is True
    assert jchain.delete_documents(["kernels.txt"]) is True
    assert tchain.get_documents() == jchain.get_documents() == ["llamas.txt"]


def test_multi_turn_rag_matches_jax(pair, tmp_path):
    jctx, tctx = pair
    jchain, tchain = jmulti.MultiTurnRAG(context=jctx), tmulti.MultiTurnRAG(
        context=tctx)
    _ingest(tmp_path, jchain, tchain)
    _assert_stores_equal(jctx.store(jmulti.DOCS), tctx.store(tmulti.DOCS))
    _search_equal(jchain, tchain, QUERIES[0])
    settings = dict(max_tokens=10, temperature=0.0)
    history = []
    for turn, query in enumerate((QUERIES[0], "and what do they eat?")):
        jlog, jundo = _spy(jchain)
        tlog, tundo = _spy(tchain)
        try:
            want = "".join(jchain.rag_chain(query, history, **settings))
            got = "".join(tchain.rag_chain(query, history, **settings))
        finally:
            jundo()
            tundo()
        assert got == want
        for key in ("prompts", "condensed", "pools", "funnels"):
            assert tlog[key] == jlog[key], (turn, key)
        # a follow-up with history condenses first (two prompts)
        assert len(tlog["prompts"]) == (2 if history else 1)
        assert len(tlog["condensed"]) == (1 if history else 0)
        assert tlog["funnels"], "the reranker narrowed no pool"
        _assert_stores_equal(jctx.store(jmulti.CONV),
                             tctx.store(tmulti.CONV))
        history = [{"role": "user", "content": query},
                   {"role": "assistant", "content": got}]
    # two turns, two memory rows each
    assert len(_rows(tctx.store(tmulti.CONV))[0]) == 4


# ---------------------------------------------------------------- lookahead

PACKAGES = {"jax": (jlook, JREGISTRY), "torch": (tlook, REGISTRY)}


def _retrieve(calls, fail_first=False):
    state = {"first": fail_first}

    def retrieve(q, qvec=None):
        if state["first"]:
            state["first"] = False
            raise RuntimeError("poisoned dispatch")
        calls.append(q)
        return np.array([1.0, 0.0]), f"hits:{q}"
    return retrieve


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lookahead_exact_match_reuses_without_embed(package):
    mod, registry = PACKAGES[package]
    calls = []
    reuse = registry.counter("lookahead_reuse").value
    look = mod.LookaheadRetrieval(_retrieve(calls)).start("raw query")
    _, payload = look.reconcile("raw query")
    assert payload == "hits:raw query" and calls == ["raw query"]
    assert registry.counter("lookahead_reuse").value == reuse + 1


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lookahead_similar_rewrite_reuses_hits(package):
    mod, _ = PACKAGES[package]
    calls = []
    look = mod.LookaheadRetrieval(_retrieve(calls),
                                  sim_threshold=0.85).start("raw")
    qvec, payload = look.reconcile(
        "rephrased", embed=lambda q: np.array([0.9, np.sqrt(1 - 0.81)]))
    assert payload == "hits:raw" and calls == ["raw"]
    np.testing.assert_allclose(qvec, [0.9, np.sqrt(1 - 0.81)])


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lookahead_divergent_rewrite_requeries(package):
    mod, registry = PACKAGES[package]
    calls = []
    requery = registry.counter("lookahead_requery").value
    look = mod.LookaheadRetrieval(_retrieve(calls),
                                  sim_threshold=0.85).start("raw")
    _, payload = look.reconcile("totally different",
                                embed=lambda q: np.array([0.0, 1.0]))
    assert payload == "hits:totally different"
    assert calls == ["raw", "totally different"]
    assert registry.counter("lookahead_requery").value == requery + 1


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lookahead_speculation_failure_falls_back_to_requery(package):
    mod, _ = PACKAGES[package]
    calls = []
    look = mod.LookaheadRetrieval(_retrieve(calls, fail_first=True)).start(
        "raw")
    _, payload = look.reconcile("raw")
    assert payload == "hits:raw" and calls == ["raw"]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lookahead_unsatisfiable_threshold_never_embeds(package):
    mod, _ = PACKAGES[package]
    calls, embeds = [], []
    look = mod.LookaheadRetrieval(_retrieve(calls),
                                  sim_threshold=1.5).start("raw")
    _, payload = look.reconcile("other", embed=lambda q: embeds.append(q))
    assert payload == "hits:other" and embeds == []


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_submit_concurrently_joins_in_order_and_reraises(package):
    mod, _ = PACKAGES[package]
    assert mod.submit_concurrently(lambda: 1, lambda: 2) == [1, 2]

    def boom():
        raise ValueError("sibling failed")

    with pytest.raises(ValueError, match="sibling failed"):
        mod.submit_concurrently(lambda: 1, boom)


class FakeLLM:
    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def chat(self, messages, **settings):
        self.calls.append(messages)
        yield self.responses.pop(0)


def test_multi_turn_condense_overlaps_lookahead(tmp_path):
    """Mirror of the reference's case of the same name: with history the
    chain condenses through an LLM call overlapped with speculative
    retrieval on the raw query, and answers with the condensed query's
    context; without history there is no condense call."""
    llm = FakeLLM(["where do llamas live", "in the Andes"])
    ctx = ChainContext(config=tconfig.AppConfig(), llm=llm,
                       embedder=Embedder(cfg=bert.BertConfig.tiny(),
                                         device="cpu"),
                       reranker=Reranker(cfg=bert.BertConfig.tiny(),
                                         device="cpu"))
    chain = tmulti.MultiTurnRAG(context=ctx)
    doc = tmp_path / "kb.txt"
    doc.write_text("Llamas live in the Andes mountains of South America.")
    chain.ingest_docs(str(doc), "kb.txt")
    history = [{"role": "user", "content": "tell me about llamas"},
               {"role": "assistant", "content": "they are camelids"}]
    out = "".join(chain.rag_chain("where do they live?", history))
    assert out == "in the Andes"
    condense_prompt = llm.calls[0][-1]["content"]
    assert "tell me about llamas" in condense_prompt
    assert "where do they live?" in condense_prompt
    llm.responses = ["just the answer"]
    assert "".join(chain.rag_chain("where do llamas live?", [])) == \
        "just the answer"
    assert len(llm.calls) == 3
    # the turns went into the conversation store
    assert len(ctx.store(tmulti.CONV)) == 4
