"""The port's prefix cache and skip-ahead admission against the reference,
on the CPU with the tiny model.

* ``chain_hashes`` is byte-equal to the JAX package's, and the two
  ``CachingAllocator``s give the same pages, headroom, matches and raises
  over the reference's own allocator scenarios and a seeded random one.
* ``Scheduler._cap_shared`` equals the JAX ``Scheduler``'s over a grid of
  prompt lengths and raw coverages under three geometries.
* Through the ``Scheduler`` with ``prefix_cache="on"``: greedy streams and
  each request's ``prefix_hit_tokens`` equal the JAX ``Scheduler``'s over
  shared-prefix traffic (divergent suffixes arriving while a slot decodes,
  a repeat, a follow-up turn embedding a finished answer), a tight pool
  that evicts, and a preemption mid-prefill whose resume re-admits against
  its own pages; on both pools, with speculation and the mixed dispatch
  off and on. The streams also equal the port's own cache-off streams.
* A cache-hit admission leaves the drafting history a cold prefill writes.
* Geometry: a cache hit that starts within a chunk of the block-table
  row's end never yields a grouped or mixed chunk whose page span passes
  the row (the engine refuses one), and its stream equals the cache-off
  stream. The reference clamps such a chunk back over an earlier, shared
  page; a test shows it.
* Skip-ahead admission: the admission order and the blocked head's
  ``bypass_count`` equal the JAX ``Scheduler``'s; past ``_BYPASS_MAX`` it
  is strict FIFO, and a bypass never takes the last free slot.
* A slot that ended on the device draws no more samples.
"""

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.core.metrics import REGISTRY
from generativeaiexamples_tpu.engine import prefix_cache as jpc
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import (EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine import prefix_cache as tpc
from generativeaiexamples_tpu_torch.engine.engine import (EngineCore,
                                                          PrefillItem)
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import sampling as ts

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
# both packages' scheduling defaults pinned off on both sides (no prefill
# hold, no dispatch pipelining, no batch-width ladder): with them the
# reference resolves results when its fetcher threads happen to finish, so
# hits under page pressure could depend on timing. Parity at the defaults
# is tests/test_torch_pipeline.py's.
PINNED = dict(prefill_hold_chunks=0, pipeline_depth=1,
              decode_width_ladder="off")
CONTEXT = ("context: the paged cache keeps keys and values in pages; "
           "shared prompt pages are hashed and reused by later requests. ")
QUESTIONS = ["q: what is kept?", "q: and what is reused here?",
             "q: why hash?"]
FILLERS = [("filler one: " + "abcdefghij" * 20)[:180],
           ("filler two: " + "klmnopqrst" * 20)[:150]]
LONG = "a long prompt that is preempted while it prefills; " * 4
TIGHT_PAGES = 34
SPEC_MIXED = {"narrow": dict(spec_decode="off", mixed_phase_dispatch="off"),
              "spec_mixed": dict(mixed_phase_dispatch="on")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny-model passes run faster on one thread than on threads that
    contend with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(5), cfg)
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tparams = llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return cfg, jparams, tcfg, tparams


def _core(tiny, **kw):
    _, _, tcfg, tparams = tiny
    return EngineCore(tcfg, EngineConfig(**{**GEOMETRY, **PINNED, **kw}),
                      tparams, eos_id=ByteTokenizer().eos_id, device="cpu")


def _jax_core(tiny, **kw):
    cfg, jparams, _, _ = tiny
    return JaxCore(cfg, JaxEngineConfig(**{**GEOMETRY, **PINNED, **kw}),
                   jparams, eos_id=ByteTokenizer().eos_id)


def _ids(text):
    return ByteTokenizer().encode(text, add_bos=True)


# --------------------------------------------------------------- hashes

@pytest.mark.parametrize("page_size", [1, 8, 16, 128])
@pytest.mark.parametrize("seed", [0, 7, "0|", "3|lora-a"])
def test_chain_hashes_byte_equal_to_reference(page_size, seed):
    rng = np.random.default_rng(page_size)
    ids = rng.integers(0, 128256, size=5 * page_size + 3).tolist()
    got = tpc.chain_hashes(ids, page_size, seed=seed)
    assert got == jpc.chain_hashes(ids, page_size, seed=seed)
    assert len(got) == len(ids) // page_size and all(len(h) == 16 for h in got)


# ------------------------------------------------------------ allocator

def _random_ops(seed, n_ops=300):
    """A seeded op sequence over a small pool: allocations that evict,
    inserts, matches, acquires and frees of owned and unowned pages."""
    rng = np.random.default_rng(seed)
    ops, names = [], []
    for i in range(n_ops):
        kind = rng.choice(["alloc", "insert", "free", "match", "acquire",
                           "can_serve"], p=[.25, .2, .2, .15, .1, .1])
        if kind == "alloc" or not names:
            name = f"p{i}"
            ops.append(("alloc", int(rng.integers(1, 5)), name))
            names.append(name)
            continue
        name = names[int(rng.integers(len(names)))]
        chain = [int(h) for h in rng.integers(0, 12, size=3)]
        if kind == "insert":
            ops.append(("insert", chain, (name, 0, 3)))
        elif kind == "free":
            ops.append(("free", (name, 0, int(rng.integers(1, 4)))))
        elif kind == "match":
            ops.append(("match", chain))
        elif kind == "acquire":
            ops.append(("acquire", (name, 0, 2)))
        else:
            ops.append(("can_serve", int(rng.integers(0, 6)), (name, 0, 2)))
    return 9, ops


# the reference's allocator scenarios (tests/test_prefix_cache.py) as op
# sequences: (num_pages, [(op, args...)]); ("p", a, b) names p[a:b] of an
# earlier alloc's pages, ("lit", [..]) literal page ids
ALLOC_CASES = {
    "refcount_and_lru_eviction": (6, [
        ("alloc", 3, "p"), ("insert", [101, 102, 103], ("p", 0, 3)),
        ("free", ("p", 0, 3)), ("match", [101, 102, 103]),
        ("match", [101, 999]), ("acquire", ("p", 0, 2)),
        ("alloc", 3, "q"), ("free", ("q", 0, 3)), ("free", ("p", 0, 2))]),
    "can_serve_counts_acquired_lru_pages": (4, [
        ("alloc", 3, "p"), ("insert", [1, 2, 3], ("p", 0, 3)),
        ("free", ("p", 0, 3)), ("can_serve", 1, ("p", 0, 2)),
        ("can_serve", 2, ("p", 0, 2)), ("acquire", ("p", 0, 2)),
        ("alloc", 2, "r"), ("alloc", 1, "got"), ("free", ("got", 0, 1)),
        ("free", ("p", 0, 2))]),
    "insert_idempotent_and_rebind": (5, [
        ("alloc", 2, "p"), ("insert", [7], ("p", 0, 1)),
        ("insert", [7], ("p", 1, 2)), ("match", [7]),
        ("insert", [8], ("p", 0, 1)), ("match", [7]), ("match", [8]),
        ("free", ("p", 0, 2))]),
    "guards": (4, [
        ("alloc", 1, "p"), ("free", ("p", 0, 1)), ("free", ("p", 0, 1)),
        ("acquire", ("lit", [3])), ("insert", [5], ("lit", [2]))]),
    "random_seed_0": _random_ops(0),
    "random_seed_1": _random_ops(1),
}


def _replay(alloc, ops):
    """Run ``ops`` on ``alloc``; each op's result (or exception type) and
    the allocator's headroom, cache size and owners after it."""
    named, trace = {}, []

    def pages(ref):
        if ref[0] == "lit":
            return list(ref[1])
        got = named.get(ref[0]) or []
        return got[ref[1]:ref[2]]

    for op, *args in ops:
        try:
            if op == "alloc":
                out = alloc.alloc(args[0])
                named[args[1]] = out
            elif op == "insert":
                out = alloc.insert(args[0], pages(args[1]))
            elif op == "free":
                out = alloc.free(pages(args[0]))
            elif op == "acquire":
                out = alloc.acquire(pages(args[0]))
            elif op == "match":
                out = alloc.match(args[0])
            else:
                out = alloc.can_serve(args[0], pages(args[1]))
        except ValueError as exc:
            out = ("raised", type(exc).__name__)
        trace.append((op, out, alloc.available, alloc.cached_pages,
                      alloc.live_refs()))
    return trace


@pytest.mark.parametrize("case", sorted(ALLOC_CASES))
def test_allocator_op_sequences_match_reference(case):
    num_pages, ops = ALLOC_CASES[case]
    got = tpc.CachingAllocator(num_pages, 8)
    want = jpc.CachingAllocator(num_pages, 8)
    ev0 = REGISTRY.counter("prefix_evictions").value
    in0 = REGISTRY.counter("prefix_inserted_pages").value
    assert _replay(got, ops) == _replay(want, ops)
    assert got.evictions == REGISTRY.counter("prefix_evictions").value - ev0
    assert got.inserted_pages == (REGISTRY.counter("prefix_inserted_pages")
                                  .value - in0)
    with pytest.raises(ValueError):
        tpc.CachingAllocator(1, 8)


# ------------------------------------------------------------ _cap_shared

@pytest.mark.parametrize("geometry", [
    dict(page_size=8, prefill_chunk=16, max_seq_len=128),
    dict(page_size=16, prefill_chunk=64, max_seq_len=256),
    dict(page_size=8, prefill_chunk=32, max_seq_len=96)])
def test_cap_shared_matches_reference(tiny, geometry):
    got = Scheduler(_core(tiny, **geometry), ByteTokenizer())
    want = JaxScheduler(_jax_core(tiny, **geometry), ByteTokenizer())
    assert got.core.buckets == want.core.buckets
    ps, n_max = geometry["page_size"], geometry["max_seq_len"] - 1
    grid = [(n, raw) for n in range(1, n_max)
            for raw in range(0, n + 2 * ps, ps)]
    assert [got._cap_shared(n, raw) for n, raw in grid] == \
        [want._cap_shared(n, raw) for n, raw in grid]


# ------------------------------------------------- streams vs the reference

def _tick_until_idle(sched):
    for _ in range(2000):
        if not sched._tick():
            return
    raise AssertionError("scheduler did not go idle")


def _sharing_traffic(sched, make, out_of):
    """A alone; once it has its first token (and one more tick), two
    questions over A's context and a repeat of A; after all finish, a
    follow-up turn embedding A's prompt and answer."""
    a = sched.submit(make(prompt_ids=_ids(CONTEXT + QUESTIONS[0]),
                          max_tokens=80, temperature=0.0))
    for _ in range(100):
        sched._tick()
        if a.first_token_at:
            break
    sched._tick()
    wave = [sched.submit(make(prompt_ids=_ids(CONTEXT + q), max_tokens=16,
                              temperature=0.0)) for q in QUESTIONS[1:]]
    wave.append(sched.submit(make(prompt_ids=_ids(CONTEXT + QUESTIONS[0]),
                                  max_tokens=16, temperature=0.0)))
    _tick_until_idle(sched)
    follow = sched.submit(make(
        prompt_ids=list(a.prompt_ids) + out_of(a)
        + ByteTokenizer().encode(" q: tell me more?"),
        max_tokens=16, temperature=0.0))
    _tick_until_idle(sched)
    return [a] + wave + [follow]


def _tight_traffic(sched, make, out_of):
    """One request at a time in a small pool: two fillers (the second
    evicts the first's pages), a repeat of the second (hits its pages),
    then a long prompt preempted after its first prefill dispatch, whose
    resume re-admits against the chunks it had written."""
    reqs = []
    for text in FILLERS + FILLERS[1:]:
        reqs.append(sched.submit(make(prompt_ids=_ids(text), max_tokens=8,
                                      temperature=0.0)))
        _tick_until_idle(sched)
    long = sched.submit(make(prompt_ids=_ids(LONG), max_tokens=8,
                             temperature=0.0))
    sched._tick()
    job = sched._prefilling[0]
    assert job.request is long and 0 < job.prefilled < len(job.ids)
    sched._preempt(job)
    _tick_until_idle(sched)
    return reqs + [long]


def _jax_run(tiny, traffic, **kw):
    sched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    reqs = traffic(sched, lambda **k: JaxRequest(logprobs=True, **k),
                   lambda r: [t for t, _lp, _top in r.logprob_data])
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return ([[t for t, _lp, _top in r.logprob_data] for r in reqs],
            [r.prefix_hit_tokens for r in reqs])


def _torch_run(tiny, traffic, **kw):
    sched = Scheduler(_core(tiny, **kw), ByteTokenizer())
    reqs = traffic(sched, Request, lambda r: list(r.output_ids))
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return ([list(r.output_ids) for r in reqs],
            [r.prefix_hit_tokens for r in reqs], sched)


@pytest.mark.parametrize("path", sorted(SPEC_MIXED))
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sharing_traffic_matches_jax_scheduler(tiny, kv_quant, path):
    kw = dict(kv_quant=kv_quant, **SPEC_MIXED[path])
    want, want_hits = _jax_run(tiny, _sharing_traffic, prefix_cache="on", **kw)
    got, hits, sched = _torch_run(tiny, _sharing_traffic, prefix_cache="on",
                                  **kw)
    off, off_hits, _ = _torch_run(tiny, _sharing_traffic, prefix_cache="off",
                                  **kw)
    assert got == want == off
    assert hits == want_hits and off_hits == [0] * len(off)
    # the wave hits A's prompt pages, the follow-up the pages A decoded
    assert hits[0] == 0 and min(hits[1:]) > 0
    assert hits[-1] > len(_ids(CONTEXT + QUESTIONS[0]))
    stats = sched.load_stats()
    assert stats["prefix_hit_tokens"] == sum(hits)
    assert 0 < stats["prefix_hit_frac"] < 1 and stats["prefix_cache"]
    if path == "spec_mixed":
        assert stats["mixed_dispatches"] > 0 and stats["spec_steps"] > 0


@pytest.mark.parametrize("path", sorted(SPEC_MIXED))
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tight_pool_traffic_matches_jax_scheduler(tiny, kv_quant, path):
    kw = dict(kv_quant=kv_quant, num_pages=TIGHT_PAGES, **SPEC_MIXED[path])
    want, want_hits = _jax_run(tiny, _tight_traffic, prefix_cache="on", **kw)
    got, hits, sched = _torch_run(tiny, _tight_traffic, prefix_cache="on",
                                  **kw)
    off, _, _ = _torch_run(tiny, _tight_traffic, prefix_cache="off", **kw)
    assert got == want == off
    assert hits == want_hits
    assert sched.stats["prefix_evictions"] > 0
    assert sched.stats["preemptions"] == 1
    # the repeat hits the second filler's pages; the resume its own chunks
    assert hits[2] > 0 and hits[3] >= sched.core.chunk


def test_cache_hit_admission_seeds_the_drafting_history(tiny):
    """A repeat admitted into a fresh slot while the first request decodes:
    its history row over the prompt, the first token and every generated
    token equals the cold row of the first request."""
    core = _core(tiny, prefix_cache="on")
    sched = Scheduler(core, ByteTokenizer())
    prompt = _ids(CONTEXT + QUESTIONS[0])
    a = sched.submit(Request(prompt_ids=prompt, max_tokens=40,
                             temperature=0.0))
    for _ in range(100):
        sched._tick()
        if a.first_token_at:
            break
    b = sched.submit(Request(prompt_ids=prompt, max_tokens=16,
                             temperature=0.0))
    _tick_until_idle(sched)
    assert b.prefix_hit_tokens > core.chunk
    n = len(prompt) + len(b.output_ids)
    hist = sched._state.history.numpy()
    assert a.output_ids[:16] == b.output_ids
    np.testing.assert_array_equal(hist[1, :n], hist[0, :n])
    assert hist[1, :len(prompt)].tolist() == prompt


def test_seed_history_writes_the_row_and_keeps_the_sink(tiny):
    core = _core(tiny)
    state = core.init_state()
    state.history[2] = 7
    ids = list(range(1, 300))
    core.seed_history(state, 2, ids)
    row = state.history[2].numpy()
    assert row[:core.max_seq].tolist() == ids[:core.max_seq]
    assert row[core.max_seq] == 7                  # the sink column
    core.seed_history(state, 2, [5, 6])
    assert state.history[2, :4].tolist() == [5, 6, 0, 0]


# ------------------------------------------------------------- geometry

def _near_row_end_traffic(sched, make, out_of):
    """A 253-token prompt, then, while a short request decodes, its repeat
    (a cache hit at 248 = 31 pages, 5 tokens left) beside a fresh prompt
    whose first chunk is a full one."""
    tail = "the end of a long prompt. " * 10
    prompt = _ids(("x" * 252 + tail)[:252])
    assert len(prompt) == 253
    first = sched.submit(make(prompt_ids=prompt, max_tokens=2,
                              temperature=0.0))
    _tick_until_idle(sched)
    live = sched.submit(make(prompt_ids=_ids("decoding"), max_tokens=64,
                             temperature=0.0))
    for _ in range(100):
        sched._tick()
        if live.first_token_at:
            break
    rest = [sched.submit(make(prompt_ids=p, max_tokens=2, temperature=0.0))
            for p in (prompt, _ids(CONTEXT))]
    _tick_until_idle(sched)
    return [first, live] + rest


@pytest.mark.parametrize("mixed", ["off", "on"])
def test_hit_near_row_end_never_passes_the_row(tiny, mixed):
    spans = []

    def spy(fn, fixed_c=None):
        def wrapped(state, *args, **kw):
            items = args[-1] if fixed_c is None else args[2]
            ps = sched.core.page_size
            C = fixed_c or max(ps, -(-max(len(it.chunk_ids)
                                          for it in items) // ps) * ps)
            spans.extend(it.start_pos + C for it in items)
            return fn(state, *args, **kw)
        return wrapped

    def run(prefix_cache):
        nonlocal sched
        sched = Scheduler(_core(tiny, prefix_cache=prefix_cache,
                                mixed_phase_dispatch=mixed),
                          ByteTokenizer())
        core = sched.core
        core.prefill_group = spy(core.prefill_group)
        core.decode_mixed = spy(core.decode_mixed, fixed_c=core.chunk)
        reqs = _near_row_end_traffic(sched, Request,
                                     lambda r: list(r.output_ids))
        assert all(r.error is None for r in reqs)
        return [r.output_ids for r in reqs], [r.prefix_hit_tokens
                                              for r in reqs], sched.stats

    sched = None
    off, _, _ = run("off")
    spans.clear()
    got, hits, stats = run("on")
    assert got == off
    assert hits[2] == 248                      # page 31 of a 32-page row
    assert max(spans) <= sched.core.row_tokens
    if mixed == "on":
        assert stats["mixed_dispatches"] > 0


def test_engine_refuses_a_chunk_past_its_row(tiny):
    core = _core(tiny, mixed_phase_dispatch="on")
    state = core.init_state()
    row = np.arange(1, core.max_pages_per_slot + 1, dtype=np.int32)
    near_end = PrefillItem(chunk_ids=[1] * 5, page_row=row, slot=0,
                           start_pos=248)
    full = PrefillItem(chunk_ids=[1] * 16, page_row=row, slot=1,
                       start_pos=0)
    with pytest.raises(ValueError, match="passes its block-table row"):
        core.prefill_group(state, [near_end, full])
    with pytest.raises(ValueError, match="passes its block-table row"):
        core.decode_mixed(state, core.put_table(np.stack([row] * 4)), 1,
                          [near_end])
    core.prefill_group(state, [near_end])      # alone it pads to one page


def test_reference_writes_a_near_end_hit_over_a_shared_page(tiny):
    """The reference pads a grouped chunk to ``prefill_chunk`` and clamps
    its page slice to the row (``jax.lax.dynamic_slice``): a hit at 248 of
    a 256-token row writes positions 248..263 into pages 30 and 31, over
    the cached page 30 (positions 240..247) that the prompt shares."""
    sched = JaxScheduler(_jax_core(tiny, prefix_cache="on",
                                   spec_decode="off"), ByteTokenizer())
    prompt = _ids(("x" * 252 + "the end of a long prompt. " * 10)[:252])
    first = sched.submit(JaxRequest(prompt_ids=prompt, max_tokens=2,
                                    temperature=0.0))
    _tick_until_idle(sched)
    assert first.error is None
    hashes = jpc.chain_hashes(prompt, 8, seed="0|")
    page = sched._alloc.match(hashes)[30]
    P, L = sched.core.num_pages, sched.core.model_cfg.n_layers
    rows = [layer * P + page for layer in range(L)]
    before = np.asarray(sched._state.cache.k)[rows]
    again = sched.submit(JaxRequest(prompt_ids=prompt, max_tokens=2,
                                    temperature=0.0))
    _tick_until_idle(sched)
    assert again.error is None and again.prefix_hit_tokens == 248
    after = np.asarray(sched._state.cache.k)[rows]
    assert not np.array_equal(before, after)


# ------------------------------------------------------ skip-ahead admission

def _admission(sched, make, head_len, n_small):
    """X holds pages; a head H that needs more than are free, then
    ``n_small`` one-page prompts; one admission pass. Returns the admitted
    requests in order, H's bypass count and H."""
    x = sched.submit(make(prompt_ids=[1] * 60, max_tokens=4))
    sched._admit()
    head = sched.submit(make(prompt_ids=[2] * head_len, max_tokens=4))
    smalls = [sched.submit(make(prompt_ids=[3, 4 + i], max_tokens=4))
              for i in range(n_small)]
    sched._admit()
    order = [j.request for j in sched._prefilling]
    named = {id(x): "x", id(head): "head"}
    named.update({id(s): f"s{i}" for i, s in enumerate(smalls)})
    job = next(j for j in sched._pending if j.request is head)
    return [named[id(r)] for r in order], job.bypass_count


@pytest.mark.parametrize("batch, n_small, want_order", [
    # up to _BYPASS_MAX bypasses, then strict FIFO though s8 would fit
    (16, 10, ["x"] + [f"s{i}" for i in range(8)]),
    # a bypass never takes the last free slot
    (4, 3, ["x", "s0", "s1"])])
def test_skip_ahead_admission_matches_jax(tiny, batch, n_small, want_order):
    kw = dict(max_batch_size=batch, max_seq_len=128, num_pages=21,
              prefix_cache="on")
    skips0 = REGISTRY.counter("admission_skips").value
    want = _admission(JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer()),
                      lambda **k: JaxRequest(temperature=0.0, **k), 100,
                      n_small)
    jax_skips = REGISTRY.counter("admission_skips").value - skips0
    sched = Scheduler(_core(tiny, **kw), ByteTokenizer())
    got = _admission(sched, lambda **k: Request(temperature=0.0, **k), 100,
                     n_small)
    assert got == want
    assert got[0] == want_order
    assert got[1] == len(want_order) - 1 == sched.stats["admission_skips"] \
        == jax_skips
    assert Scheduler._BYPASS_MAX == JaxScheduler._BYPASS_MAX == 8
    assert Scheduler._ADMIT_SCAN == JaxScheduler._ADMIT_SCAN


# ------------------------------------------------------- dead slots (C1)

@pytest.mark.parametrize("spec", ["off", "on"])
def test_dead_sampled_slot_draws_no_samples(tiny, spec, monkeypatch):
    """A greedy request of 200 tokens beside a temperature-0.7 request of
    2: once the sampled one ends by length, no sampling call has a live
    sampled row (its stale temperature does not send the slot down the
    sampling path: no key is folded and nothing drawn for it), and the
    greedy stream is the one it gives alone."""
    counts = {"draws": 0, "calls": 0}
    sample = ts.sample_slots

    def counting_sample(keys, counter0, W, logits, temperature, top_k, top_p,
                        active):
        counts["calls"] += 1
        counts["draws"] += int((active & (temperature > 0)).sum())
        return sample(keys, counter0, W, logits, temperature, top_k, top_p,
                      active)

    monkeypatch.setattr(ts, "sample_slots", counting_sample)
    kw = dict(spec_decode=spec, mixed_phase_dispatch="off",
              prefix_cache="off")
    greedy_ids = _ids("a greedy request that decodes for a long while")

    def run(with_sampled):
        sched = Scheduler(_core(tiny, **kw), ByteTokenizer())
        greedy = sched.submit(Request(prompt_ids=greedy_ids, max_tokens=200,
                                      temperature=0.0))
        sampled = sched.submit(Request(
            prompt_ids=_ids("sampled"), max_tokens=2, temperature=0.7,
            seed=1)) if with_sampled else None
        for _ in range(200):
            if sampled is None or sampled.finished_at:
                break
            sched._tick()
        drawn = dict(counts)
        counts.update(draws=0, calls=0)
        _tick_until_idle(sched)
        assert greedy.error is None
        return greedy, sampled, drawn

    greedy, sampled, drawn = run(True)
    assert sampled.finish_reason == "length"
    assert len(sampled.output_ids) == 2 and drawn["draws"] > 0
    assert counts["draws"] == 0 and counts["calls"] > 0
    assert len(greedy.output_ids) == 200
    alone, _, _ = run(False)
    assert greedy.output_ids == alone.output_ids


# --------------------------------------------------------------- config

def test_prefix_cache_config(tiny, monkeypatch):
    assert EngineConfig().prefix_cache == "on"
    assert _core(tiny).prefix_caching
    assert type(_core(tiny).new_allocator()).__name__ == "CachingAllocator"
    off = _core(tiny, prefix_cache="off")
    assert type(off.new_allocator()).__name__ == "PageAllocator"
    assert Scheduler(off, ByteTokenizer()).load_stats()["prefix_cache"] is False
    with pytest.raises(ValueError, match="prefix_cache"):
        _core(tiny, prefix_cache="maybe")
    monkeypatch.setenv("APP_ENGINE_PREFIX_CACHE", "off")
    assert load_config().engine.prefix_cache == "off"
