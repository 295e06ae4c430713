"""The reference's default dispatch loop in the port, on the CPU with the
tiny model.

* End to end against the JAX ``Scheduler`` with both packages at their
  defaults (two decode dispatches in flight, the prefill hold of 16
  chunks, the batch-width ladder, speculation, the mixed dispatch and the
  prefix cache on), over both KV pools: greedy and seeded temperature-0.7
  streams (with top-k and top-p rows, and a seed past 31 bits) are equal
  token for token.
* Within the port: ``pipeline_depth`` 1 and 2 give equal streams, with
  results landing at once (the CPU) and with a device that lags (each
  result lands only when the backpressure point waits for it).
* Under page pressure with dispatches in flight, a preemption comes only
  after they drained, and no page is ever owned twice.
* A slot that finished inside one dispatch keeps its pages untouched by
  the next one, which was issued before the host saw it finish.
* The hold's held ticks equal the reference's on a ramp (both at
  ``pipeline_depth=1``), and its streams.
* ``decode(width=4)`` equals the full-width dispatch on the live rows;
  ``decode_widths`` and ``_decode_width`` equal the reference's.
* ``warmup()`` leaves the first request's stream unchanged.
* The knobs' defaults and validation; ``/health``'s in-flight count; the
  step code reads nothing back from the device.
* A fused first token whose batched fetch has landed streams between the
  steps of the dispatch being issued (``first_mid_dispatch``), once; a
  first token that ends its request (EOS, ``max_tokens`` 1) finishes
  after the dispatch is issued, with its reason, and frees its slot.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core.config import (NOT_PORTED,
                                                        EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine import engine as tengine
from generativeaiexamples_tpu_torch.engine.engine import (
    EngineCore, HostCopy, PrefillItem, unpack_decode_out)
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama

GEOMETRY = dict(max_batch_size=4, max_seq_len=256, page_size=8,
                prefill_chunk=16)
QUOTE = ("the retrieved context says: alpha beta gamma delta. "
         "the retrieved context says: alpha beta gamma delta. "
         "question: repeat the context. answer: the retrieved")
PORT_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "generativeaiexamples_tpu_torch")


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
    return EngineCore(tcfg, EngineConfig(**{**GEOMETRY, **kw}), tparams,
                      eos_id=ByteTokenizer().eos_id, device="cpu")


def _jax_core(tiny, **kw):
    cfg, jparams, _, _ = tiny
    return JaxCore(cfg, JaxEngineConfig(**{**GEOMETRY, **kw}), jparams,
                   eos_id=ByteTokenizer().eos_id)


def _ids(text):
    return ByteTokenizer().encode(text, add_bos=True)


@pytest.fixture
def lagging(monkeypatch):
    """A device that lags: no result lands before the host waits for it,
    so dispatches stay in flight up to the backpressure point."""
    monkeypatch.setattr(HostCopy, "done", lambda self: False)


def _run(sched, waves, cap=3000):
    """Submit ``waves`` of requests: the first at once, each later one
    once every request of the wave before has its first token; tick until
    all finish."""
    reqs = []
    for i, wave in enumerate(waves):
        if i:
            for _ in range(cap):
                if all(r.first_token_at or r.finished_at for r in reqs):
                    break
                sched._tick()
        reqs += [sched.submit(r) for r in wave]
    for _ in range(cap):
        if all(r.finished_at for r in reqs):
            break
        sched._tick()
    assert all(r.finished_at and r.error is None for r in reqs), \
        [r.error for r in reqs]
    return reqs


def _default_waves(make):
    """A greedy and a seeded decoder, the second's prompt longer than a
    group of chunks (a ramp that holds decode); then, while both decode, a
    top-k / top-p sampled prompt of several chunks, a greedy one sharing
    its pages, a sampled one whose seed passes 31 bits and one at the
    chain server's temperature 0.2 / top-p 0.7 (the last two wait for a
    slot)."""
    return [
        [make(prompt_ids=_ids("hello there"), max_tokens=64,
              temperature=0.0),
         make(prompt_ids=_ids((QUOTE * 2)[:200]), max_tokens=48,
              temperature=0.7, seed=11)],
        [make(prompt_ids=_ids(QUOTE[:110]), max_tokens=24, temperature=0.7,
              top_k=20, top_p=0.9, seed=12),
         make(prompt_ids=_ids(QUOTE[:100]), max_tokens=24, temperature=0.0),
         make(prompt_ids=_ids("abc"), max_tokens=16, temperature=0.7,
              seed=2 ** 40 + 3),
         make(prompt_ids=_ids("what does the context say?"), max_tokens=20,
              temperature=0.2, top_p=0.7, seed=4)]]


def _jax_tokens(reqs):
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs]


# ------------------------------------------------- the reference's defaults

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_default_streams_match_jax_scheduler(tiny, kv_quant):
    kw = dict(kv_quant=kv_quant, mixed_phase_dispatch="on")
    jsched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    want = _jax_tokens(_run(jsched, _default_waves(
        lambda **k: JaxRequest(logprobs=True, **k))))
    sched = Scheduler(_core(tiny, **kw), ByteTokenizer())
    cfg = sched.core.cfg
    assert (cfg.pipeline_depth, cfg.prefill_hold_chunks,
            cfg.decode_width_ladder, cfg.prefix_cache) == (2, 16, "on", "on")
    got = [r.output_ids for r in _run(sched, _default_waves(Request))]
    assert got == want
    assert [len(g) for g in got] == [64, 48, 24, 24, 16, 20]
    st = sched.stats
    assert st["held_ticks"] > 0 and st["mixed_dispatches"] > 0
    assert st["spec_steps"] > 0 and st["decode_width_2"] > 0
    assert st["prefix_hit_tokens"] > 0


# ------------------------------------------------------ pipeline depth

def _depth_streams(tiny, depth, **kw):
    sched = Scheduler(_core(tiny, pipeline_depth=depth,
                            mixed_phase_dispatch="on", **kw),
                      ByteTokenizer())
    reqs = _run(sched, _default_waves(Request))
    return [r.output_ids for r in reqs], sched


@pytest.mark.parametrize("spec", ["on", "off"])
def test_pipeline_depth_1_and_2_give_equal_streams(tiny, spec, monkeypatch):
    base, _ = _depth_streams(tiny, 1, spec_decode=spec)
    got, sched = _depth_streams(tiny, 2, spec_decode=spec)
    assert got == base
    monkeypatch.setattr(HostCopy, "done", lambda self: False)
    for depth in (1, 2, 3):
        lagged, sched = _depth_streams(tiny, depth, spec_decode=spec)
        assert lagged == base
        st = sched.stats
        # with a lagging device the dispatches overlap, and up to the depth
        # stay in flight between ticks
        assert st["overlapped_dispatches"] > 0
        assert st["inflight_peak"] == depth
        assert not sched._inflight and sched._pending_steps == 0


def test_load_stats_reports_dispatches_in_flight(tiny, lagging):
    sched = Scheduler(_core(tiny), ByteTokenizer())
    stats = sched.load_stats()
    assert (stats["inflight_dispatches"], stats["pipeline_depth"],
            stats["decode_widths"]) == (0, 2, [2, 4])
    sched.submit(Request(prompt_ids=_ids("hello"), max_tokens=64,
                         temperature=0.0))
    seen = set()
    for _ in range(6):
        sched._tick()
        seen.add(sched.load_stats()["inflight_dispatches"])
    assert seen == {1, 2}


# ----------------------------------------- first tokens mid-dispatch (C5)

class _Watch:
    """Counts decode forwards and records, for every token the Scheduler
    emits and every request it finishes, how many forwards the dispatch
    being issued had run (None outside ``_dispatch_decode``) and whether
    the engine's ``decode`` was still running."""

    def __init__(self, monkeypatch):
        self.forwards, self.base = 0, None
        self.in_decode = False
        self.emitted, self.finished = [], {}
        step = tengine.kv_cache.decode_step

        def counting(*a, **k):
            self.forwards += 1
            return step(*a, **k)

        dispatch = Scheduler._dispatch_decode

        def dispatching(sched, *a, **k):
            self.base = self.forwards
            try:
                return dispatch(sched, *a, **k)
            finally:
                self.base = None

        decode = EngineCore.decode

        def decoding(core, *a, **k):
            self.in_decode = True
            try:
                return decode(core, *a, **k)
            finally:
                self.in_decode = False

        emit = Scheduler._emit_token

        def emitting(sched, job, tok, *logprob):
            self.emitted.append((job.request.request_id, tok, self.at()))
            return emit(sched, job, tok, *logprob)

        finish = Scheduler._finish

        def finishing(sched, job):
            self.finished[job.request.request_id] = (self.at(),
                                                     self.in_decode)
            return finish(sched, job)

        monkeypatch.setattr(tengine.kv_cache, "decode_step", counting)
        monkeypatch.setattr(Scheduler, "_dispatch_decode", dispatching)
        monkeypatch.setattr(EngineCore, "decode", decoding)
        monkeypatch.setattr(Scheduler, "_emit_token", emitting)
        monkeypatch.setattr(Scheduler, "_finish", finishing)

    def at(self):
        return None if self.base is None else self.forwards - self.base

    def tokens(self, req):
        return [t for rid, t, _ in self.emitted if rid == req.request_id]


_C5 = dict(spec_decode="off", mixed_phase_dispatch="off",
           prefill_hold_chunks=0, prefix_cache="off")


def _decoding(sched, max_tokens=60):
    """A greedy request decoding, with a dispatch issued."""
    req = sched.submit(Request(prompt_ids=_ids("a decoder that runs on"),
                               max_tokens=max_tokens, temperature=0.0))
    for _ in range(50):
        if sched.stats["decode_dispatches"]:
            return req
        sched._tick()
    raise AssertionError("no decode dispatch")


def _until_done(sched, reqs, cap=3000):
    for _ in range(cap):
        if all(r.finished_at for r in reqs):
            break
        sched._tick()
    assert all(r.finished_at and r.error is None for r in reqs)


def test_first_token_streams_between_a_dispatchs_steps(tiny, monkeypatch):
    watch = _Watch(monkeypatch)
    sched = Scheduler(_core(tiny, **_C5), ByteTokenizer())
    steps = sched.core.cfg.decode_steps_per_dispatch
    first = _decoding(sched)
    late = sched.submit(Request(prompt_ids=_ids("a late prompt"),
                                max_tokens=12, temperature=0.2, top_p=0.7,
                                seed=3))
    _until_done(sched, [first, late])
    # the late prompt's first token streamed after the first forward of
    # the dispatch issued beside its fetch, before the dispatch's last one
    rid, tok, at = next(e for e in watch.emitted
                        if e[0] == late.request_id)
    assert at is not None and 1 <= at < steps
    assert sched.stats["first_mid_dispatch"] >= 1
    assert sched.load_stats()["first_mid_dispatch"] >= 1
    # each token once: the dispatch's own step-0 copy of it emits nothing
    assert watch.tokens(late) == late.output_ids
    assert len(late.output_ids) == late.completion_tokens == 12
    # and the stream is the one a device that never lands early gives
    monkeypatch.setattr(HostCopy, "done", lambda self: False)
    sched = Scheduler(_core(tiny, **_C5), ByteTokenizer())
    _decoding(sched)
    lagged = sched.submit(Request(prompt_ids=_ids("a late prompt"),
                                  max_tokens=12, temperature=0.2, top_p=0.7,
                                  seed=3))
    _until_done(sched, [lagged])
    assert sched.stats["first_mid_dispatch"] == 0
    assert lagged.output_ids == late.output_ids


def test_first_token_that_ends_its_request_finishes_after_the_dispatch(
        tiny, monkeypatch):
    """An EOS first token (forced for seed 77) and a max_tokens=1 request
    resolve between the steps of a dispatch, and finish after it was
    issued: outside the engine's decode, with their reasons, their slots
    and pages freed."""
    watch = _Watch(monkeypatch)
    activate = EngineCore._activate_rows

    def eos_for_seed_77(core, state, logits, items):
        forced = [i for i, it in enumerate(items)
                  if it.is_last and it.seed == 77]
        sample = core._sample_slots

        def sampled(*args):
            toks, lps, extra = sample(*args)
            toks[forced] = core.eos_id
            return toks, lps, extra

        core._sample_slots = sampled
        try:
            return activate(core, state, logits, items)
        finally:
            del core._sample_slots

    monkeypatch.setattr(EngineCore, "_activate_rows", eos_for_seed_77)
    sched = Scheduler(_core(tiny, **_C5), ByteTokenizer())
    pages = sched._alloc.available
    first = _decoding(sched, max_tokens=40)
    eos = sched.submit(Request(prompt_ids=_ids("ends at once"),
                               max_tokens=30, temperature=0.7, seed=77))
    one = sched.submit(Request(prompt_ids=_ids("one token"), max_tokens=1,
                               temperature=0.0))
    for _ in range(20):
        sched._tick()
        if eos.finished_at and one.finished_at:
            break
    assert (eos.finish_reason, eos.output_ids) == ("eos", [])
    assert one.finish_reason == "length" and len(one.output_ids) == 1
    assert watch.tokens(one) == one.output_ids
    assert sched.stats["first_mid_dispatch"] >= 2
    for req in (eos, one):
        at, in_decode = watch.finished[req.request_id]
        assert at is not None and not in_decode
        assert req.first_token_at <= req.finished_at
    assert len(sched._slots) == 1 and sched.core.batch - len(sched._free) == 1
    _until_done(sched, [first])
    assert len(first.output_ids) == 40
    assert sorted(sched._free) == list(range(sched.core.batch))
    assert sched._alloc.available == pages


# ------------------------------------------------------- page pressure

def _pages_owned_once(sched):
    owned = [p for j in list(sched._slots.values()) + list(sched._prefilling)
             for p in j.pages]
    free = set(sched._alloc._free)
    assert len(owned) == len(set(owned)) and not free & set(owned)


@pytest.mark.parametrize("depth", [1, 2])
def test_preemption_drains_in_flight_dispatches_first(tiny, lagging, depth):
    kw = dict(prefix_cache="off", pipeline_depth=depth)
    prompts = [_ids("first request with a fairly long prompt here ok"),
               _ids("second one"), _ids(QUOTE[:40])]

    def run(**extra):
        sched = Scheduler(_core(tiny, **kw, **extra), ByteTokenizer())
        in_flight_at_preempt = []
        preempt = sched._preempt

        def watched(job):
            in_flight_at_preempt.append(len(sched._inflight))
            preempt(job)

        sched._preempt = watched
        reqs = [sched.submit(Request(prompt_ids=p, max_tokens=32,
                                     temperature=0.7 if i == 1 else 0.0,
                                     seed=5)) for i, p in enumerate(prompts)]
        for _ in range(3000):
            if all(r.finished_at for r in reqs):
                break
            sched._tick()
            _pages_owned_once(sched)
        assert all(r.error is None for r in reqs)
        return [r.output_ids for r in reqs], sched, in_flight_at_preempt

    roomy, _, _ = run()
    tight, sched, at_preempt = run(num_pages=12)
    assert sched.stats["preemptions"] > 0 and at_preempt
    assert set(at_preempt) == {0}
    assert tight == roomy


# ------------------------------------------- a finished slot's pages

@pytest.mark.parametrize("spec", ["off", "on"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_finished_slot_pages_untouched_by_the_next_dispatch(tiny, spec,
                                                            kv_quant):
    """Slot 0 ends (budget 3) inside dispatch N; dispatch N+1 was issued
    with the same page table before the host knew: slot 0's pages read the
    same after N+1, while slot 1 goes on writing its own."""
    core = _core(tiny, spec_decode=spec, kv_quant=kv_quant,
                 prefix_cache="off")
    state = core.init_state()
    table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
    ids = _ids(QUOTE[:40])
    for s, budget in ((0, 3), (1, 200)):
        pages = list(range(1 + 10 * s, 11 + 10 * s))
        table[s, :10] = pages
        items = [PrefillItem(chunk_ids=ids[i:i + core.chunk],
                             page_row=table[s], slot=s, start_pos=i,
                             is_last=i + core.chunk >= len(ids), generated=1,
                             max_gen=budget, temperature=0.0)
                 for i in range(0, len(ids), core.chunk)]
        state, _ = core.prefill_group(state, items)
    dev_table = core.put_table(table)
    state, out = core.decode(state, dev_table, 4)
    host = unpack_decode_out(out["packed"].numpy())
    assert host["done"][:, 0].any() and not host["done"][:, 1].any()
    L, P = core.model_cfg.n_layers, core.num_pages
    rows0 = [layer * P + p for layer in range(L) for p in table[0, :10]]
    rows1 = [layer * P + p for layer in range(L) for p in table[1, :10]]
    pools = lambda: [t.clone() for t in (state.cache.k, state.cache.v,
                                         state.cache.k_s, state.cache.v_s)
                     if t is not None]
    before = pools()
    state, _ = core.decode(state, dev_table, 4)
    after = pools()
    for b, a in zip(before, after):
        assert torch.equal(b[rows0], a[rows0])
        assert not torch.equal(b[rows1], a[rows1])


# ------------------------------------------------------------- the hold

def _ramp_waves(make):
    """A short prompt and three of seven chunks at once, grouped two
    chunks a dispatch: the short one decodes while the others prefill
    into a batch under half full."""
    return [[make(prompt_ids=_ids("short"), max_tokens=24, temperature=0.0)]
            + [make(prompt_ids=_ids(QUOTE[:110 - 3 * i]), max_tokens=12,
                    temperature=0.7, seed=i) for i in range(3)]]


def test_held_ticks_equal_the_reference_on_a_ramp(tiny):
    kw = dict(max_batch_size=8, prefill_group=2, pipeline_depth=1,
              mixed_phase_dispatch="on")
    jsched = JaxScheduler(_jax_core(tiny, **kw), ByteTokenizer())
    dispatch = jsched._dispatch_decode
    ticks = {"dispatched": False, "held": 0}

    def counted(*args, **k):
        ticks["dispatched"] = True
        return dispatch(*args, **k)

    jsched._dispatch_decode = counted
    tick = jsched._tick

    def counting_tick():
        ticks["dispatched"] = False
        worked = tick()
        # decode is skipped only by the hold while slots are live
        if jsched._slots and not ticks["dispatched"]:
            ticks["held"] += 1
        return worked

    jsched._tick = counting_tick
    want = _jax_tokens(_run(jsched, _ramp_waves(
        lambda **k: JaxRequest(logprobs=True, **k))))
    sched = Scheduler(_core(tiny, **kw), ByteTokenizer())
    got = [r.output_ids for r in _run(sched, _ramp_waves(Request))]
    assert got == want
    assert sched.stats["held_ticks"] == ticks["held"] > 0
    # the budget is 16 chunks an episode, two a dispatch
    assert sched.stats["held_ticks"] <= 16 // 2


def test_no_hold_without_a_budget(tiny):
    sched = Scheduler(_core(tiny, max_batch_size=8, prefill_group=2,
                            prefill_hold_chunks=0), ByteTokenizer())
    _run(sched, _ramp_waves(Request))
    assert sched.stats["held_ticks"] == 0


# ------------------------------------------------------ the width ladder

@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("ladder", ["on", "off"])
def test_decode_widths_equal_the_reference(tiny, batch, ladder):
    kw = dict(max_batch_size=batch, decode_width_ladder=ladder)
    want = _jax_core(tiny, **kw)
    got = _core(tiny, **kw)
    assert got.decode_widths == want.decode_widths
    jsched = JaxScheduler(want, ByteTokenizer())
    sched = Scheduler(got, ByteTokenizer())
    rng = np.random.default_rng(batch)
    for _ in range(12):
        live = sorted(set(rng.integers(0, batch, size=rng.integers(
            1, batch + 1)).tolist()))
        jsched._slots = {s: None for s in live}
        sched._slots = {s: None for s in live}
        assert sched._decode_width() == jsched._decode_width()


def _prefilled(core, n_live, spec_width=None):
    state = core.init_state()
    table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
    items = []
    for s in range(n_live):
        ids = _ids(QUOTE[:30 + 17 * s])
        table[s, :8] = range(1 + 8 * s, 9 + 8 * s)
        items += [PrefillItem(chunk_ids=ids[i:i + core.chunk],
                              page_row=table[s], slot=s, start_pos=i,
                              is_last=i + core.chunk >= len(ids),
                              generated=1, max_gen=40,
                              temperature=0.7 if s % 2 else 0.0,
                              top_k=10 * s, seed=s)
                  for i in range(0, len(ids), core.chunk)]
    for g in range(0, len(items), core.prefill_group_max):
        state, _ = core.prefill_group(state,
                                      items[g:g + core.prefill_group_max])
    return state, core.put_table(table)


@pytest.mark.parametrize("spec_width", [2, 9])
def test_narrow_rung_equals_the_full_width_on_live_rows(tiny, spec_width):
    core = _core(tiny, max_batch_size=8)
    assert core.decode_widths == (4, 8)
    full, table = _prefilled(core, 3)
    narrow, _ = _prefilled(core, 3)
    for _ in range(2):
        full, out_f = core.decode(full, table, 4, spec_width=spec_width)
        narrow, out_n = core.decode(narrow, table, 4, spec_width=spec_width,
                                    width=4)
        pf, pn = out_f["packed"].numpy(), out_n["packed"].numpy()
        assert pn.shape[-1] == 4 and pf.shape[-1] == 8
        np.testing.assert_array_equal(pn[:, :, :3], pf[:, :, :3])
    for name in ("tokens", "active", "generated", "last_logprob", "rngs"):
        assert torch.equal(getattr(narrow, name), getattr(full, name)), name
    # the history's sink column and the null page take the full width's
    # idle rows' writes, which the narrow rung does not make; neither is
    # ever read
    assert torch.equal(narrow.history[:, :core.max_seq],
                       full.history[:, :core.max_seq])
    assert torch.equal(narrow.cache.lengths, full.cache.lengths)
    real = torch.ones(narrow.cache.k.shape[0], dtype=torch.bool)
    real[::core.num_pages] = False
    assert torch.equal(narrow.cache.k[real], full.cache.k[real])
    assert torch.equal(narrow.cache.v[real], full.cache.v[real])
    with pytest.raises(ValueError, match="ladder rung"):
        core.decode(full, table, 1, width=3)


# ------------------------------------------------------------- warmup

def test_warmup_leaves_the_first_request_stream_unchanged(tiny):
    def run(warm):
        core = _core(tiny, mixed_phase_dispatch="on", max_batch_size=8)
        seconds = core.warmup() if warm else None
        sched = Scheduler(core, ByteTokenizer())
        reqs = _run(sched, _default_waves(Request))
        return [r.output_ids for r in reqs], seconds

    cold, _ = run(False)
    warm, seconds = run(True)
    assert warm == cold and seconds > 0


# ------------------------------------------------------------- config

def test_pipelining_knobs_default_validate_and_load(monkeypatch):
    ref = JaxEngineConfig()
    cfg = EngineConfig()
    assert (cfg.pipeline_depth, cfg.prefill_hold_chunks,
            cfg.decode_width_ladder) == (ref.pipeline_depth,
                                         ref.prefill_hold_chunks,
                                         ref.decode_width_ladder) == (
        2, 16, "on")
    for key in ("pipeline_depth", "prefill_hold_chunks",
                "decode_width_ladder"):
        assert key not in NOT_PORTED
    for bad in (dict(pipeline_depth=0), dict(prefill_hold_chunks=-1),
                dict(decode_width_ladder="maybe")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            EngineConfig(**bad)
    monkeypatch.setenv("APP_ENGINE_PIPELINE_DEPTH", "1")
    monkeypatch.setenv("APP_ENGINE_PREFILL_HOLD_CHUNKS", "0")
    monkeypatch.setenv("APP_ENGINE_DECODE_WIDTH_LADDER", "off")
    eng = load_config().engine
    assert (eng.pipeline_depth, eng.prefill_hold_chunks,
            eng.decode_width_ladder) == (1, 0, "off")


def test_step_code_reads_nothing_back_from_the_device():
    """No generator, no tensor truth test in the sampler, and no read-back
    inside EngineCore (results reach the host only through HostCopy)."""
    with open(os.path.join(PORT_SRC, "ops", "sampling.py")) as fh:
        sampling = fh.read()
    with open(os.path.join(PORT_SRC, "engine", "engine.py")) as fh:
        engine = fh.read()
    core = engine[engine.index("class EngineCore"):]
    for src in (sampling, core):
        assert "Generator" not in src and "multinomial" not in src
        assert not re.search(r"\.(cpu|item|tolist)\(\)", src)
    assert "bool(" not in sampling
    assert not hasattr(tengine, "fold_seed")
