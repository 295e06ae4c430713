"""Disaggregated prefill/decode in the PyTorch port, against the JAX
package on the CPU (the tiny model, ``PRNGKey(5)`` weights through
``params_from_jax``, each package's byte tokenizer).

Every case of ``tests/test_disagg.py`` has its counterpart here:

* ``export_pages`` then ``import_pages`` into other pages of a second pool
  reproduce the slot's KV: the next decode step's logits are bit-equal,
  over both pools; and both functions equal the reference's on the same
  pool contents, bit for bit (the int8 pool's values and scales too);
* a prefill-role export, through the JSON wire, imported by a decode-role
  scheduler streams the unified stream's tokens, greedy and seeded, over
  both pools (speculation on over the model-dtype pool), and those equal
  the JAX ``Scheduler``'s unified streams; the prefill worker makes no
  decode dispatch and streams no text, the decode worker no prefill
  dispatch for the handed-off request;
* a payload whose geometry or dtype the pool cannot host is refused with
  ``ValueError``; an unknown role is refused at engine init, naming
  ``APP_ENGINE_ROLE``;

and across the packages:

* a JAX prefill-role export, as host arrays (its ``fetch=True`` form), imported by
  the port's decode-role scheduler, and the port's export through its
  frame imported by the JAX decode-role scheduler, both stream the JAX
  unified stream, over both pools;
* the reference's ``/v1/kv/prefill`` hands a request naming a LoRA
  adapter off on the base weights (ROADMAP C8); the port refuses it.

Streams are compared token for token; pages bit for bit.
"""

import asyncio
import concurrent.futures
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core import kv_wire as jwire
from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import kv_cache as jkv
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from generativeaiexamples_tpu.models import llama as jllama

from generativeaiexamples_tpu_torch.core import kv_wire
from generativeaiexamples_tpu_torch.core.config import (NOT_PORTED,
                                                        EngineConfig,
                                                        load_config)
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine import server as tserver
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama

pytestmark = pytest.mark.filterwarnings("ignore")

# the reference test's geometry: 4 slots of 128, pages of 16, chunks of 16
GEOMETRY = dict(max_batch_size=4, max_seq_len=128, prefill_chunk=16,
                page_size=16, spec_draft=2, decode_steps_per_dispatch=2,
                prefill_hold_chunks=0)
TOK, JTOK = ByteTokenizer(), JaxByteTokenizer()
PROMPT = "the quick brown fox jumps over the lazy dog"


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
    return cfg, jparams, tcfg, jax.tree.map(np.asarray, jparams)


def _mk_sched(tiny, role="unified", kv_quant="none", spec="off", **kw):
    _, _, tcfg, np_params = tiny
    ecfg = EngineConfig(role=role, kv_quant=kv_quant, spec_decode=spec,
                        **{**GEOMETRY, **kw})
    return Scheduler(EngineCore(tcfg, ecfg,
                                llama.params_from_jax(np_params, tcfg),
                                eos_id=TOK.eos_id, device="cpu"), TOK)


class _SyncFetcher:
    """The JAX ``Scheduler``'s fetcher run in the calling thread."""

    def submit(self, fn, *args, **kw):
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args, **kw))
        return fut

    def shutdown(self, wait=True):
        pass


def _jax_sched(tiny, role="unified", kv_quant="none", spec="off"):
    cfg, jparams, _, _ = tiny
    ecfg = JaxEngineConfig(role=role, kv_quant=kv_quant, spec_decode=spec,
                           attention="xla", **GEOMETRY)
    sched = JaxScheduler(JaxCore(cfg, ecfg, jparams, eos_id=JTOK.eos_id),
                         JTOK)
    sched._fetcher = _SyncFetcher()
    return sched


def _drive(sched, reqs, submit=True, ticks=4000):
    """Tick ``sched`` by hand until every request finished."""
    if submit:
        for r in reqs:
            sched.submit(r)
    for _ in range(ticks):
        sched._tick()
        if all(r.finished_at is not None for r in reqs):
            return reqs
    raise AssertionError("requests did not finish within the tick budget")


def _text(req) -> str:
    parts = []
    while not req.out_queue.empty():
        item = req.out_queue.get()
        if isinstance(item, str):
            parts.append(item)
    return "".join(parts)


# greedy and seeded, as the reference test's seeded request
SAMPLINGS = (dict(max_tokens=12, temperature=0.0, seed=1),
             dict(max_tokens=12, temperature=0.7, seed=123))


def _jax_unified(tiny, kv_quant, spec="off"):
    """The JAX ``Scheduler``'s unified streams of ``PROMPT`` under
    ``SAMPLINGS`` (token ids from ``logprob_data``)."""
    reqs = [JaxRequest(prompt_ids=JTOK.encode(PROMPT), logprobs=True, **kw)
            for kw in SAMPLINGS]
    _drive(_jax_sched(tiny, "decode", kv_quant, spec), reqs)
    assert [r.error for r in reqs] == [None, None]
    return [[t for t, _lp, _top in r.logprob_data] for r in reqs]


# ----------------------------------------------------- export/import (pure)

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_export_import_roundtrip_pure(tiny, kv_quant):
    """export_pages -> import_pages into other physical pages of a second
    pool: the next decode step over the whole context gives bit-equal
    logits (int8 pools move int8 values and scales)."""
    _, _, tcfg, np_params = tiny
    params = llama.params_from_jax(np_params, tcfg)
    B, ps, P = 2, 16, 16
    a = kv_cache.PagedKVCache.create(tcfg, B, P, ps, kv_quant=kv_quant)
    ids = np.random.default_rng(1).integers(1, 60, 20)
    row_a = np.zeros((4,), np.int32)
    row_a[:2] = [3, 7]
    tokens = torch.from_numpy(np.pad(ids, (0, 12))[None].astype(np.int32))
    kv_cache.prefill_chunk(params, tcfg, tokens, a, torch.from_numpy(row_a),
                           0, 0, 20, P)
    bufs = kv_cache.export_pages(a, torch.tensor([3, 7]), P)
    if kv_quant == "int8":
        assert bufs[0].dtype == torch.int8 and bufs[2].dtype == torch.float32
    else:
        assert bufs[2] is None
    b = kv_cache.PagedKVCache.create(tcfg, B, P, ps, kv_quant=kv_quant)
    row_b = np.zeros((4,), np.int32)
    row_b[:2] = [9, 2]
    kv_cache.import_pages(b, torch.tensor([9, 2]), P, 0, 20, *bufs)
    assert int(b.lengths[0]) == 20
    nxt = torch.from_numpy(np.random.default_rng(2).integers(
        1, 60, (B,)).astype(np.int32))
    on = torch.tensor([True, False])
    lg_a = kv_cache.decode_step(params, tcfg, nxt, a, torch.from_numpy(
        np.repeat(row_a[None], B, 0)), on, P)
    lg_b = kv_cache.decode_step(params, tcfg, nxt, b, torch.from_numpy(
        np.repeat(row_b[None], B, 0)), on, P)
    assert torch.equal(lg_a[0], lg_b[0])


def _random_pools(cfg, P, ps, kv_quant, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers * P, ps, cfg.n_kv_heads * cfg.head_dim)
    sc = (cfg.n_layers * P, cfg.n_kv_heads, ps)
    if kv_quant == "int8":
        arrs = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        arrs += [rng.random(sc).astype(np.float32) for _ in range(2)]
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)] + [None, None]
    return arrs


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_export_import_equal_the_reference(tiny, kv_quant):
    """On the same pool contents, the port's export equals the reference's
    bit for bit, and so do the pools after the same import."""
    cfg = tiny[0]
    P, ps, B = 12, 16, 4
    k, v, k_s, v_s = _random_pools(cfg, P, ps, kv_quant, 0)
    lengths = np.zeros((B,), np.int32)
    jc = jkv.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths),
        **({} if k_s is None else dict(k_s=jnp.asarray(k_s),
                                       v_s=jnp.asarray(v_s))))
    t = lambda a: None if a is None else torch.from_numpy(a.copy())
    tc = kv_cache.PagedKVCache(k=t(k), v=t(v), lengths=t(lengths),
                               k_s=t(k_s), v_s=t(v_s))
    pages = np.array([5, 2, 9], np.int32)
    want = jkv.export_pages(jc, jnp.asarray(pages), P)
    got = kv_cache.export_pages(tc, torch.from_numpy(pages), P)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bk, bv, bks, bvs = _random_pools(cfg, 3, ps, kv_quant, 1)
    dst = np.array([4, 1, 6], np.int32)
    jc = jkv.import_pages(jc, jnp.asarray(dst), P, jnp.int32(2),
                          jnp.int32(40), jnp.asarray(bk), jnp.asarray(bv),
                          None if bks is None else jnp.asarray(bks),
                          None if bvs is None else jnp.asarray(bvs))
    kv_cache.import_pages(tc, torch.from_numpy(dst), P, 2, 40, t(bk), t(bv),
                          t(bks), t(bvs))
    for name in ("k", "v", "lengths") + (("k_s", "v_s")
                                         if kv_quant == "int8" else ()):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


# ------------------------------------------------- handoff token identity

@pytest.mark.parametrize("kv_quant,spec", [("none", "on"), ("int8", "off")])
def test_handoff_stream_token_identical_to_unified(tiny, kv_quant, spec):
    """Prefill-role export -> JSON wire -> decode-role import streams the
    decode worker's own unified stream and the JAX ``Scheduler``'s, greedy
    and seeded; the prefill worker decodes nothing and streams no text,
    the decode worker prefills nothing for the handed-off requests."""
    prompt = TOK.encode(PROMPT)
    jax_streams = _jax_unified(tiny, kv_quant, spec)
    dec = _mk_sched(tiny, "decode", kv_quant, spec)
    refs = _drive(dec, [Request(prompt_ids=list(prompt), **kw)
                        for kw in SAMPLINGS])
    assert [r.output_ids for r in refs] == jax_streams
    ref_texts = [_text(r) for r in refs]
    assert all(ref_texts)

    pre = _mk_sched(tiny, "prefill", kv_quant, spec)
    rps = _drive(pre, [Request(prompt_ids=list(prompt), prefill_only=True,
                               **kw) for kw in SAMPLINGS])
    assert pre.stats["decode_dispatches"] == 0
    for rp in rps:
        assert rp.error is None, rp.error
        assert _text(rp) == ""
        assert rp.finish_reason == "handoff"
        assert rp.handoff["kv_dtype"] == ("int8" if kv_quant == "int8"
                                          else "float32")
        assert rp.admitted_at is not None and rp.first_token_at is not None
    assert pre.stats["kv_handoff_exports"] == 2

    prefills = dec.stats["prefill_dispatches"]
    rds = []
    for rp, kw in zip(rps, SAMPLINGS):
        wire = json.loads(json.dumps(kv_wire.encode_kv_payload(rp.handoff)))
        payload = kv_wire.decode_kv_payload(wire)
        rd = Request(prompt_ids=list(payload["prompt_ids"]), **kw)
        dec.submit_prefilled(rd, payload)
        rds.append(rd)
    _drive(dec, rds, submit=False)
    assert [r.error for r in rds] == [None, None]
    assert [_text(r) for r in rds] == ref_texts
    assert [r.output_ids for r in rds] == jax_streams
    assert dec.stats["prefill_dispatches"] == prefills
    assert dec.stats["kv_handoff_imports"] == 2
    for rd in rds:
        assert rd.prefill_start_at is not None
        assert rd.first_token_at >= rd.admitted_at


def test_handoff_pool_mismatch_refused(tiny):
    """A payload this pool cannot host is refused at submit time (a loud
    ValueError, HTTP 409), never scattered."""
    cfg = tiny[0]
    dec = _mk_sched(tiny, "decode")
    good = {"page_size": 16, "n_layers": cfg.n_layers,
            "kv_dim": cfg.n_kv_heads * cfg.head_dim, "kv_dtype": "float32",
            "length": 20, "n_pages": 2}
    for key, bad in (("page_size", 32), ("kv_dtype", "int8"),
                     ("n_layers", 5), ("length", 4096), ("n_pages", 3),
                     ("kv_dim", 8)):
        with pytest.raises(ValueError):
            dec.core.validate_handoff(dict(good, **{key: bad}))
    with pytest.raises(ValueError, match="missing 'k'"):
        dec.core.validate_handoff(good)
    k = torch.zeros((cfg.n_layers, 2, 16, cfg.n_kv_heads * cfg.head_dim))
    dec.core.validate_handoff(dict(good, k=k, v=k))
    with pytest.raises(ValueError, match="buffer shape"):
        dec.core.validate_handoff(dict(good, k=k[:, :1], v=k))
    with pytest.raises(ValueError, match="prompt_ids"):
        dec.core.validate_handoff(dict(good, k=k, v=k, prompt_ids=[1, 2]))
    with pytest.raises(ValueError):
        dec.submit_prefilled(Request(prompt_ids=[1, 2]),
                             dict(good, page_size=32))
    assert dec.stats["kv_handoff_submitted"] == 0
    q8 = _mk_sched(tiny, "decode", "int8")
    with pytest.raises(ValueError, match="missing 'k_s'"):
        q8.core.validate_handoff(dict(good, kv_dtype="int8",
                                      k=k.to(torch.int8),
                                      v=k.to(torch.int8)))


def test_engine_role_validated(tiny, monkeypatch):
    _, _, tcfg, np_params = tiny
    with pytest.raises(ValueError, match="APP_ENGINE_ROLE"):
        EngineCore(tcfg, EngineConfig(role="turbo", **GEOMETRY),
                   llama.params_from_jax(np_params, tcfg),
                   eos_id=TOK.eos_id, device="cpu")
    monkeypatch.setenv("APP_ENGINE_ROLE", "prefill")
    monkeypatch.setenv("APP_ENGINE_KV_SPILL_MB", "64")
    cfg = load_config().engine
    assert (cfg.role, cfg.kv_spill_mb) == ("prefill", 64)
    for knob in ("role", "kv_spill_mb", "kv_tier", "kv_tier_disk_mb"):
        assert knob not in NOT_PORTED


def test_prefill_role_warmup_runs_no_decode(tiny, monkeypatch):
    """A prefill worker's warmup runs the grouped prefill only, as the
    reference's skips its decode grid."""
    calls = []
    sched = _mk_sched(tiny, "prefill")
    for name in ("decode", "decode_multi", "decode_mixed"):
        fn = getattr(sched.core, name)
        monkeypatch.setattr(sched.core, name,
                            lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    sched.core.warmup(TOK)
    assert calls == []


def test_unified_worker_serves_prefill_only_beside_decoding(tiny):
    """A unified worker serves a prefill_only request while another slot
    decodes: its first token resolves from a decode dispatch, its export
    imports into a decode worker and streams the unified stream, and the
    decoding request's stream is unchanged."""
    prompt = TOK.encode(PROMPT)
    kw = SAMPLINGS[1]
    other = TOK.encode("pack my box with five dozen liquor jugs")
    dec = _mk_sched(tiny, "decode")
    ref, ref_other = _drive(dec, [
        Request(prompt_ids=list(prompt), **kw),
        Request(prompt_ids=list(other), max_tokens=24, temperature=0.0)])
    uni = _mk_sched(tiny, "unified")
    run = Request(prompt_ids=list(other), max_tokens=24, temperature=0.0)
    uni.submit(run)
    for _ in range(200):
        uni._tick()
        if run.completion_tokens >= 2:
            break
    rp = Request(prompt_ids=list(prompt), prefill_only=True, **kw)
    uni.submit(rp)
    _drive(uni, [rp, run], submit=False)
    assert rp.finish_reason == "handoff" and run.error is None
    assert run.output_ids == ref_other.output_ids
    rd = Request(prompt_ids=list(rp.handoff["prompt_ids"]), **kw)
    dec.submit_prefilled(rd, rp.handoff)
    _drive(dec, [rd], submit=False)
    assert rd.output_ids == ref.output_ids


# ------------------------------------------------- across the two packages

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_jax_export_imports_into_the_port(tiny, kv_quant):
    """The reference's prefill-role export, as host numpy arrays, imported
    by the port's decode-role scheduler: the JAX unified streams."""
    jax_streams = _jax_unified(tiny, kv_quant)
    pre = _jax_sched(tiny, "prefill", kv_quant)
    rps = _drive(pre, [JaxRequest(prompt_ids=JTOK.encode(PROMPT),
                                  prefill_only=True, **kw)
                       for kw in SAMPLINGS])
    dec = _mk_sched(tiny, "decode", kv_quant)
    rds = []
    for rp, kw in zip(rps, SAMPLINGS):
        assert rp.error is None and rp.finish_reason == "handoff"
        payload = {key: (np.asarray(val) if key in kv_wire.PAYLOAD_ARRAYS
                         and val is not None else val)
                   for key, val in rp.handoff.items()}
        rd = Request(prompt_ids=list(payload["prompt_ids"]), **kw)
        dec.submit_prefilled(rd, payload)
        rds.append(rd)
    _drive(dec, rds, submit=False)
    assert [r.error for r in rds] == [None, None]
    assert [r.output_ids for r in rds] == jax_streams
    assert dec.stats["prefill_dispatches"] == 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_port_export_imports_into_jax(tiny, kv_quant):
    """The port's prefill-role export, through its frame decoded by the
    reference's codec, imported by the JAX decode-role scheduler: the JAX
    unified streams."""
    jax_streams = _jax_unified(tiny, kv_quant)
    pre = _mk_sched(tiny, "prefill", kv_quant)
    rps = _drive(pre, [Request(prompt_ids=TOK.encode(PROMPT),
                               prefill_only=True, **kw)
                       for kw in SAMPLINGS])
    dec = _jax_sched(tiny, "decode", kv_quant)
    rds = []
    for rp, kw in zip(rps, SAMPLINGS):
        payload = jwire.decode_kv_frames(kv_wire.encode_kv_frames(rp.handoff))
        rd = JaxRequest(prompt_ids=list(payload["prompt_ids"]),
                        logprobs=True, **kw)
        dec.submit_prefilled(rd, payload)
        rds.append(rd)
    _drive(dec, rds, submit=False)
    assert [r.error for r in rds] == [None, None]
    assert [[t for t, _lp, _top in r.logprob_data]
            for r in rds] == jax_streams


# ----------------------------------------------- adapters across a handoff

class _AdapterScheduler:
    """A scheduler whose core has one adapter registered, recording the
    requests it is given; a prefill_only one ends at once with a payload
    of scalars."""

    def __init__(self):
        from types import SimpleNamespace
        self.tokenizer = JaxByteTokenizer()
        self.core = SimpleNamespace(adapter_names=["ad-1"], role="unified")
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)
        req.handoff = {"version": 1, "length": len(req.prompt_ids)}
        req.finish_reason = "handoff"
        return req

    def iter_text(self, req):
        return iter(())

    def load_stats(self):
        return {}


def test_reference_hands_an_adapter_request_off_on_base_weights():
    """ROADMAP C8: the reference's /v1/kv/prefill never reads ``model``, so
    a request naming a registered adapter is prefilled (and its first
    token sampled) under the base weights, and nothing in its payload
    names the adapter for the decode worker."""
    from aiohttp.test_utils import TestClient, TestServer

    from generativeaiexamples_tpu.engine.server import ModelServer
    sched = _AdapterScheduler()
    server = ModelServer(sched, "base")

    async def drive():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            chat = {"messages": [{"role": "user", "content": "hi"}],
                    "model": "ad-1", "max_tokens": 4}
            resp = await client.post("/v1/kv/prefill", json=chat)
            return resp.status, await resp.json()
        finally:
            await client.close()

    status, payload = asyncio.run(drive())
    assert status == 200
    (req,) = sched.submitted
    assert req.prefill_only and req.adapter == ""
    assert "ad-1" not in json.dumps(payload)


def test_port_refuses_an_adapter_handoff():
    """The port answers 400 on both handoff routes for an adapter's
    request, naming the limit, and serves nothing."""
    sched = _AdapterScheduler()
    sched.tokenizer = ByteTokenizer()
    httpd = tserver.make_server(sched, "base", "127.0.0.1", 0)
    import threading
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for path, body in (
                ("/v1/kv/prefill", {"messages": [{"role": "user",
                                                  "content": "hi"}],
                                    "model": "ad-1"}),
                ("/v1/kv/handoff", {"model": "ad-1", "length": 2,
                                    "prompt_ids": [1, 2]})):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 400
            assert b"adapter requests cannot be handed off" in \
                err.value.read()
        assert sched.submitted == []
    finally:
        httpd.shutdown()
        httpd.server_close()
