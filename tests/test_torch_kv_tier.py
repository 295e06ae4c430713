"""The prefix-addressed host KV tier in the PyTorch port, against the JAX
package on the CPU (the tiny model, ``PRNGKey(5)`` weights through
``params_from_jax``).

Every case of ``tests/test_kv_tier.py`` has its counterpart here
(``test_timeline_carries_tier_hit_tokens``'s in
``tests/test_torch_plane_scheduler.py``):

* the returning prefix, on the model-dtype pool and the int8 pool: a tight
  pool with ``APP_KV_TIER=prefix`` spills a stream into the tier, the
  stream finishes, and a second request with the victim's prompt promotes
  the covered span. Its stream equals the roomy tier-off oracle's and the
  JAX ``Scheduler``'s (tier on, run as the reference's own test runs it);
  the prefill dispatched for it is exactly the tail, ``n - covered``
  tokens (``stats["prefill_tokens"]``: the port has no device-time
  ledger), and ``kv_tier_hit_tokens`` is ``covered``;
* off by default; the hot-set advert and ``prefix_key_hex`` (and the
  ``X-KV-Prefix`` header); a pinned entry is never evicted; the deepest
  prefix wins; a disk demotion promotes back bit for bit; a corrupt disk
  file is a loud error, never served; ``payload_nbytes``;
* with the QoS plane's tenant bias and each contributor's slack in the
  price, the eviction order equals the reference's ``PrefixKVTier``'s on
  seeded sequences of two tenants' dated and undated spills; with
  ``APP_QOS=fair`` the scheduler sets the policy's lock-free hint as the
  bias and a spill's entry carries its tenant and remaining deadline, with
  no ``kv_tier._lock -> qos._lock`` edge under the armed lock watch;
* ``kv_cache.import_pages_partial`` scatters the pages as the reference's
  does and leaves ``lengths`` alone, on both pools; the engine refuses a
  payload of another geometry.
"""

import json
import time
import urllib.request
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import kv_cache as jkv
from generativeaiexamples_tpu.engine.engine import EngineCore as JaxCore
from generativeaiexamples_tpu.engine.kv_tier import (
    PrefixKVTier as JaxPrefixKVTier)
from generativeaiexamples_tpu.engine.kv_tier import (
    payload_nbytes as jax_payload_nbytes)
from generativeaiexamples_tpu.engine.scheduler import Request as JaxRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JaxScheduler
from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine import kv_tier
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.kv_tier import (
    KVSpillPool, PrefixKVTier, payload_nbytes)
from generativeaiexamples_tpu_torch.engine.prefix_cache import chain_hashes
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from generativeaiexamples_tpu_torch.models import llama
from tests.test_torch_kv_handoff import (JTOK, TOK, _drive, _random_pools,
                                         _SyncFetcher, one_thread,
                                         tiny)  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore")

PA = "the quick brown fox jumps over the lazy"
PB = "pack my box with five dozen liquor ju"
KWA = dict(max_tokens=60, temperature=0.7, seed=11)
KWB = dict(max_tokens=60, temperature=0.7, seed=22)

# the reference test's engine: 2 slots of 128, pages and chunks of 16
TIER_GEOMETRY = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=16,
                     page_size=16, spec_decode="off",
                     decode_steps_per_dispatch=2, prefill_hold_chunks=0,
                     prefix_cache="off")


def _env(monkeypatch, spill_mb, tier):
    if spill_mb is None:
        monkeypatch.delenv("APP_KV_SPILL_MB", raising=False)
    else:
        monkeypatch.setenv("APP_KV_SPILL_MB", str(spill_mb))
    if tier is None:
        monkeypatch.delenv("APP_KV_TIER", raising=False)
    else:
        monkeypatch.setenv("APP_KV_TIER", tier)


def _mk_tier(tiny, num_pages, monkeypatch, spill_mb=64, tier="prefix",
             kv_quant="none"):
    _, _, tcfg, np_params = tiny
    _env(monkeypatch, spill_mb, tier)
    ecfg = EngineConfig(kv_quant=kv_quant, num_pages=num_pages,
                        **TIER_GEOMETRY)
    return Scheduler(EngineCore(tcfg, ecfg,
                                llama.params_from_jax(np_params, tcfg),
                                eos_id=TOK.eos_id, device="cpu"), TOK)


def _mk_jax_tier(tiny, num_pages, monkeypatch, kv_quant="none"):
    """The JAX ``Scheduler`` as ``tests/test_kv_tier.py`` builds it (xla
    attention over the model-dtype pool, pallas over the int8 pool)."""
    cfg, jparams, _, _ = tiny
    _env(monkeypatch, 64, "prefix")
    attn = "pallas" if kv_quant == "int8" else "xla"
    ecfg = JaxEngineConfig(attention=attn, kv_quant=kv_quant,
                           num_pages=num_pages, **TIER_GEOMETRY)
    sched = JaxScheduler(JaxCore(cfg, ecfg, jparams, eos_id=JTOK.eos_id),
                         JTOK)
    sched._fetcher = _SyncFetcher()
    return sched


def _spill_then_return(sched, make_req, prompts, kws):
    """Phase 1 (tight pool: a victim spills into the tier and both finish)
    and phase 2 (the victim's prompt returns). Returns (the first pair,
    the victim's index, the returning request, the prefill tokens
    dispatched for it or None)."""
    rs = [make_req(p, kw) for p, kw in zip(prompts, kws)]
    for r in rs:
        sched.submit(r)
    for _ in range(6000):
        sched._tick()
        if sum(r.spill_resumes for r in rs) >= 1:
            break
    else:
        raise AssertionError("no spill resume under page pressure")
    _drive(sched, rs, submit=False, ticks=6000)
    assert [r.error for r in rs] == [None, None]
    victim = 0 if rs[0].spill_resumes else 1
    before = getattr(sched, "stats", {}).get("prefill_tokens")
    r3 = make_req(prompts[victim], kws[victim])
    _drive(sched, [r3], ticks=6000)
    assert r3.error is None, r3.error
    after = getattr(sched, "stats", {}).get("prefill_tokens")
    tail = None if before is None else after - before
    return rs, victim, r3, tail


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_returning_prefix_promotes_the_tail_only_token_identical(
        tiny, monkeypatch, kv_quant):
    prompts = [TOK.encode(PA), TOK.encode(PB)]
    kws = [KWA, KWB]
    # the oracle: a roomy pool, tier off
    big = _mk_tier(tiny, 0, monkeypatch, spill_mb=None, tier=None,
                   kv_quant=kv_quant)
    oracles = _drive(big, [Request(prompt_ids=list(p), **kw)
                           for p, kw in zip(prompts, kws)])
    assert type(big._spill) is not PrefixKVTier and big._tier is None

    sched = _mk_tier(tiny, 8, monkeypatch, kv_quant=kv_quant)
    assert isinstance(sched._spill, PrefixKVTier)
    assert sched._tier is sched._spill
    rs, victim, r3, tail = _spill_then_return(
        sched, lambda p, kw: Request(prompt_ids=list(p), **kw), prompts, kws)
    for r, o in zip(rs, oracles):
        assert r.output_ids == o.output_ids
    # the spills released; their prefix runs stayed behind as cache
    assert len(sched._spill) == 0
    assert sched._tier.entries() >= 1
    covered = r3.tier_hit_tokens
    n = len(prompts[victim])
    assert covered > 0 and covered % 16 == 0
    assert r3.prefix_hit_tokens >= covered
    # no prefill over the covered span: exactly the tail was dispatched
    assert tail == n - covered
    assert sched.stats["kv_tier_hit_tokens"] == covered
    assert sched.stats["kv_tier_promoted"] == 1
    assert r3.kv_import_s is not None and r3.kv_import_s > 0
    assert r3.output_ids == oracles[victim].output_ids
    assert sched._tier.live_refs() == 0

    # the JAX Scheduler, tier on, on the same weights: the same victim,
    # the same coverage, the same streams
    jsched = _mk_jax_tier(tiny, 8, monkeypatch, kv_quant)
    jrs, jvictim, jr3, _ = _spill_then_return(
        jsched, lambda p, kw: JaxRequest(prompt_ids=list(p), logprobs=True,
                                         **kw), prompts, kws)
    assert jvictim == victim
    assert jr3.tier_hit_tokens == covered
    ids = lambda r: [t for t, _lp, _top in r.logprob_data]
    for jr, r in zip(jrs, rs):
        assert ids(jr) == r.output_ids
    assert ids(jr3) == r3.output_ids


# ------------------------------------------------------------ off means off

def test_tier_off_by_default_keeps_plain_spill_pool(tiny, monkeypatch):
    sched = _mk_tier(tiny, 8, monkeypatch, tier=None)
    assert sched._tier is None
    assert type(sched._spill) is KVSpillPool
    assert kv_tier.current_pool() is sched._spill
    assert kv_tier.occupancy_payload()["kind"] == "spill"
    assert sched.prefix_key_hex(TOK.encode("x" * 40)) == ""
    stats = sched.load_stats()
    assert stats["kv_spill_used_bytes"] == 0
    assert stats["kv_spill_budget_bytes"] == 64 * (1 << 20)
    assert "kv_tier_hot" not in stats
    # a value other than off|prefix is read as off, as the reference does
    monkeypatch.setenv("APP_KV_TIER", "bogus")
    assert kv_tier.tier_mode() == "off"


def test_tier_on_advertises_hotset_and_prefix_key(tiny, monkeypatch):
    sched = _mk_tier(tiny, 8, monkeypatch)
    assert isinstance(sched._tier, PrefixKVTier)
    assert kv_tier.occupancy_payload()["kind"] == "prefix"
    stats = sched.load_stats()
    assert stats["kv_tier_entries"] == 0
    assert stats["kv_tier_bytes"] == 0
    assert stats["kv_tier_hot"] == []
    prompt = TOK.encode(PA)
    want = chain_hashes([int(t) for t in prompt[:16]], 16,
                        seed="0|")[0].hex()
    assert sched.prefix_key_hex(prompt) == want
    # the reference's scheduler computes the same key
    jsched = _mk_jax_tier(tiny, 8, monkeypatch)
    assert jsched.prefix_key_hex(list(prompt)) == want
    # sub-page prompts have no full-page hash to advertise
    assert sched.prefix_key_hex(prompt[:5]) == ""


def test_every_completion_carries_the_prefix_header(tiny, monkeypatch):
    """``X-KV-Prefix`` beside ``X-Request-Id`` on chat and completion
    responses, streamed or not: the prompt's h0 with the tier on, ""
    with it off."""
    for tier in ("prefix", None):
        sched = _mk_tier(tiny, 0, monkeypatch, tier=tier)
        httpd, thread = serve_in_thread(sched, "tiny")
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            for path, body in (
                    ("/v1/completions", {"prompt": PA}),
                    ("/v1/chat/completions",
                     {"messages": [{"role": "user", "content": PA}]}),
                    ("/v1/chat/completions",
                     {"messages": [{"role": "user", "content": PA}],
                      "stream": True})):
                body.update(max_tokens=4, temperature=0.0)
                req = urllib.request.Request(
                    url + path, data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
                    got = resp.headers.get("X-KV-Prefix")
                    assert resp.headers.get("X-Request-Id")
                if path == "/v1/completions":
                    ids = TOK.encode(PA, add_bos=True)
                else:
                    ids = TOK.apply_chat_template(body["messages"])
                assert got == sched.prefix_key_hex(ids)
                assert (got != "") == (tier == "prefix")
            with urllib.request.urlopen(url + "/health", timeout=30) as resp:
                health = json.loads(resp.read())
            assert ("kv_tier_hot" in health) == (tier == "prefix")
        finally:
            httpd.shutdown()
            httpd.server_close()
            sched.stop()
            thread.join(timeout=10)


# ------------------------------------------------------- pins are inviolable

def _payload(fill: float, pages: int = 2, ps: int = 16) -> dict:
    return {"length": pages * ps, "n_pages": pages, "page_size": ps,
            "k": np.full((pages, ps, 4), fill, np.float32),
            "v": np.full((pages, ps, 4), -fill, np.float32),
            "prompt_ids": list(range(pages * ps))}


def _hashes(tag: bytes, depth: int) -> list:
    return [bytes([i]) * 15 + tag for i in range(depth)]


def test_refcounted_entry_never_evicted():
    """Eviction never drops an entry with a checkout ref or a live rid
    link: admission goes over budget instead; the pin released, the same
    admission evicts it and fits. The reference's tier answers alike."""
    stats = {}
    p1, p2 = _payload(1.0), _payload(2.0)
    n1 = payload_nbytes(p1)
    tier = PrefixKVTier(int(n1 * 1.5), stats=stats)
    jtier = JaxPrefixKVTier(int(n1 * 1.5))
    for t in (tier, jtier):
        assert t.admit("r1", p1)
        assert t.contribute("r1", _hashes(b"a", 2), p1, tokens=32)
        # rid-linked: the budget cannot evict it to fit a second spill
        assert not t.admit("r2", p2)
        assert t.entries() == 1
        # release retains: bytes move to the cached plane, entry unpinned
        t.release("r1", outcome="promoted")
        assert len(t) == 0 and t.cached_bytes == n1
        hit = t.probe(_hashes(b"a", 2))
        assert hit is not None and hit[1] == 2
        key = hit[0]
        assert t.checkout(key) is p1 and t.live_refs() == 1
        assert not t.admit("r2", p2)
        assert t.entries() == 1
        t.checkin(key)
        assert t.live_refs() == 0
        assert t.admit("r2", p2)
        assert t.entries() == 0 and t.cached_bytes == 0
        assert t.probe(_hashes(b"a", 2)) is None
        t.release("r2", outcome="dropped")
        assert t.used_bytes == 0
    assert stats["kv_tier_evicted"] == 1
    assert stats["kv_tier_contributed"] == stats["kv_tier_retained"] == 1
    assert stats["kv_spill_over_budget"] == 2
    assert stats["kv_tier_probe_hit"] == 1
    assert stats["kv_tier_probe_miss"] == 1


def _eviction_order(tier_cls, qos_mod, clock_mod, seed):
    """A seeded sequence on one package's tier on a virtual clock: two
    tenants weighted 4:1 (``gold``, ``bulk``) whose QoS policy has charged
    bulk ahead of its share, spills dated (a remaining budget) and undated,
    each contributed, used and retained at its own time; then spills that
    need the room, so the retained entries evict. Returns the keys in the
    order evicted, and the policy's overuse of each tenant."""
    rng = np.random.default_rng(seed)
    clk = clock_mod.VirtualClock(start=50.0)
    clock_mod.install(clk)
    try:
        policy = qos_mod.QosPolicy(weights={"gold": 4.0, "bulk": 1.0})
        for i in range(6):
            policy.charge_admission(SimpleNamespace(
                tenant=("bulk", "gold")[i % 3 == 0], request_id=f"c{i}",
                prompt_ids=[1] * int(rng.integers(10, 60)),
                max_tokens=int(rng.integers(10, 60))))
        one = payload_nbytes(_payload(0.0, pages=2))
        tier = tier_cls(one * 6)
        tier.set_victim_bias(policy.tenant_overuse_hint)
        evicted = []
        drop = tier._drop_entry_locked

        def record(e, outcome):
            evicted.append((e.key[-2:].decode(), outcome))
            drop(e, outcome)

        tier._drop_entry_locked = record
        for i in range(6):
            clk.advance(float(rng.uniform(1.0, 40.0)))
            tenant = ("gold", "bulk")[int(rng.integers(0, 2))]
            slack = (None if rng.random() < 0.4
                     else float(rng.uniform(-5.0, 900.0)))
            pay = _payload(float(i), pages=2)
            assert tier.admit(f"s{i}", pay)
            assert tier.contribute(f"s{i}", _hashes(b"k%d" % i, 2), pay,
                                   tokens=32, tenant=tenant, slack_s=slack)
            tier.release(f"s{i}", outcome="promoted")
            for _ in range(int(rng.integers(0, 3))):
                clk.advance(float(rng.uniform(0.5, 5.0)))
                hit = tier.probe(_hashes(b"k%d" % i, 2))
                tier.checkout(hit[0])
                tier.checkin(hit[0])
        for i in range(6):
            clk.advance(2.0)
            assert tier.admit(f"n{i}", _payload(10.0 + i, pages=2))
        return evicted, {t: policy.tenant_overuse_hint(t)
                         for t in ("gold", "bulk")}
    finally:
        clock_mod.reset()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eviction_order_with_qos_bias_and_slack_matches_the_reference(
        seed):
    """With the QoS plane's tenant bias and each contributor's slack in
    the price, the port's tier evicts the reference's ``PrefixKVTier``'s
    entries in its order on the same seeded sequence."""
    from generativeaiexamples_tpu.core import clock as jclock
    from generativeaiexamples_tpu.engine import qos as jqos
    from generativeaiexamples_tpu_torch.core import clock as tclock
    from generativeaiexamples_tpu_torch.engine import qos as tqos
    want = _eviction_order(JaxPrefixKVTier, jqos, jclock, seed)
    got = _eviction_order(PrefixKVTier, tqos, tclock, seed)
    assert got == want
    assert len(got[0]) == 6 and got[1]["bulk"] > got[1]["gold"]


def test_scheduler_prices_a_spill_by_its_tenant_and_slack(monkeypatch):
    """``APP_QOS=fair`` with the tier on: the scheduler sets the policy's
    lock-free hint as the tier's bias, and a spill's entry carries its
    request's tenant and remaining deadline. Under the armed lock watch no
    ``kv_tier._lock -> qos._lock`` edge is witnessed."""
    from generativeaiexamples_tpu_torch.engine import qos as tqos
    from generativeaiexamples_tpu_torch.engine.fakecore import FakeCore
    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.observability import lockwatch
    monkeypatch.setenv("APP_LOCKWATCH", "on")
    lockwatch.WATCH.reset()
    _env(monkeypatch, 1, "prefix")
    monkeypatch.setenv(tqos.MODE_ENV, "fair")
    try:
        core = FakeCore(batch=2, max_seq=64, page_size=8, chunk=16, steps=2,
                        num_pages=9)
        core.import_pages_kv = lambda *a, **k: None
        sched = Scheduler(core, ByteTokenizer())
        assert sched._tier is not None and sched._qos is not None
        assert sched._tier._victim_bias == sched._qos.tenant_overuse_hint
        req = Request(prompt_ids=[40] * 20, max_tokens=4, temperature=0.0,
                      tenant="acme", deadline_s=30.0)
        job = SimpleNamespace(request=req)
        pay = _payload(1.0, pages=2, ps=8)
        assert sched._tier.admit(req.request_id, pay)
        sched._tier_contribute(job, pay)
        entry = next(iter(sched._tier._entries.values()))
        assert entry.tenant == "acme"
        assert 0.0 < entry.slack_s <= 30.0
        sched._tier.release(req.request_id)
        sched._tier.admit("big", _payload(2.0, pages=40, ps=8))
        body = lockwatch.WATCH.payload()
        edges = {(e["held"], e["acquired"]) for e in body["edges"]}
        assert "kv_tier._lock" in body["locks"]
        assert ("kv_tier._lock", "qos._lock") not in edges
        assert lockwatch.WATCH.inversions == []
    finally:
        tqos.register_policy(None)
        lockwatch.WATCH.reset()


def test_probe_prefers_deepest_cached_prefix():
    tier = PrefixKVTier(1 << 20)
    shallow, deep = _payload(1.0, pages=1), _payload(2.0, pages=3)
    hs = _hashes(b"z", 3)
    assert tier.admit("r1", shallow)
    assert tier.contribute("r1", hs[:1], shallow, tokens=16)
    tier.release("r1")
    assert tier.admit("r2", deep)
    assert tier.contribute("r2", hs, deep, tokens=48)
    tier.release("r2")
    key, depth = tier.probe(hs)
    assert depth == 3
    assert tier.checkout(key) is deep
    tier.checkin(key)
    # a prompt covering only the opening page still hits, shallower
    assert tier.probe(hs[:1]) is not None
    assert tier.probe(_hashes(b"q", 2)) is None
    hot = tier.hot_stats(k=4)
    assert hot["kv_tier_entries"] == 2
    assert hot["kv_tier_hot"] == [hs[0].hex()]


# ------------------------------------------------------------- disk tier

def _wait(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw words, so equality is bit for bit."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _torch_payload(fill: float, pages: int = 2, ps: int = 16) -> dict:
    """A payload as the port's spill makes it: host tensors (bf16 K/V)."""
    p = _payload(fill, pages, ps)
    p["k"] = torch.from_numpy(p["k"]).to(torch.bfloat16)
    p["v"] = torch.from_numpy(p["v"]).to(torch.bfloat16)
    p["kv_dtype"] = "bfloat16"
    return p


@pytest.mark.parametrize("make", [_payload, _torch_payload],
                         ids=["numpy", "torch_bf16"])
def test_disk_tier_demotes_and_promotes_bit_exact(tmp_path, make):
    stats = {}
    p1, p2 = make(3.5), make(4.5)
    n1 = payload_nbytes(p1)
    tier = PrefixKVTier(int(n1 * 1.5), disk_budget_bytes=1 << 20,
                        disk_dir=str(tmp_path), stats=stats)
    assert tier.admit("r1", p1)
    assert tier.contribute("r1", _hashes(b"d", 2), p1, tokens=32)
    tier.release("r1")
    # write-behind runs at retention: wait for the published disk copy
    assert _wait(lambda: tier.disk_used_bytes > 0), \
        "write-behind never published the disk copy"
    # force the RAM eviction: the entry demotes instead of dying
    assert tier.admit("r2", p2)
    assert stats["kv_tier_demoted"] == 1
    assert tier.cached_bytes == 0 and tier.entries() == 1
    hit = tier.probe(_hashes(b"d", 2))
    assert hit is not None and hit[1] == 2
    loaded = tier.checkout(hit[0])
    assert loaded is not None and loaded is not p1
    for key in ("k", "v"):
        got, want = torch.as_tensor(loaded[key]), torch.as_tensor(p1[key])
        assert got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want))
    assert [int(t) for t in loaded["prompt_ids"]] == p1["prompt_ids"]
    tier.checkin(hit[0])
    assert stats["kv_tier_disk_load"] == 1 and stats["kv_tier_disk_write"] == 1
    tier.close()


def test_disk_tier_corruption_is_loud_not_served(tmp_path):
    stats = {}
    p1, p2 = _payload(5.5), _payload(6.5)
    n1 = payload_nbytes(p1)
    tier = PrefixKVTier(int(n1 * 1.5), disk_budget_bytes=1 << 20,
                        disk_dir=str(tmp_path), stats=stats)
    assert tier.admit("r1", p1)
    assert tier.contribute("r1", _hashes(b"c", 2), p1, tokens=32)
    tier.release("r1")
    assert _wait(lambda: tier.disk_used_bytes > 0)
    assert tier.admit("r2", p2)          # demote the entry to disk-only
    files = list(tmp_path.glob("*.kvw"))
    assert len(files) == 1
    files[0].write_bytes(b"garbage" + files[0].read_bytes()[7:])
    hit = tier.probe(_hashes(b"c", 2))
    assert hit is not None
    assert tier.checkout(hit[0]) is None
    assert stats["kv_tier_disk_corrupt"] == 1
    # the entry died with its corrupt copy: later probes miss cleanly
    assert tier.probe(_hashes(b"c", 2)) is None
    assert tier.live_refs() == 0
    tier.close()


# ------------------------------------------------------------- accounting

def test_payload_nbytes_charges_every_segment():
    k = np.zeros((2, 16, 4), np.float32)
    base = {"length": 32, "n_pages": 2, "page_size": 16,
            "k": k, "v": k.copy(), "temperature": 0.7, "seed": 11}
    n0 = payload_nbytes(base)
    assert n0 == 2 * k.nbytes
    base["k_s"] = np.zeros((2, 16), np.float32)
    assert payload_nbytes(base) == n0 + base["k_s"].nbytes
    base["draft_cache"] = np.zeros((8,), np.int8)   # a new segment
    assert payload_nbytes(base) == n0 + base["k_s"].nbytes + 8
    base["prompt_ids"] = list(range(32))
    assert payload_nbytes(base) \
        == n0 + base["k_s"].nbytes + 8 + 4 * 32
    assert payload_nbytes(base) == jax_payload_nbytes(base)
    # a torch tensor is charged its bytes too
    before = payload_nbytes(base)
    base["k"] = torch.zeros((2, 16, 4), dtype=torch.bfloat16)
    assert payload_nbytes(base) == jax_payload_nbytes(base) \
        == before - k.nbytes // 2


# ------------------------------------------------ the partial page import

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_import_pages_partial_leaves_lengths_alone(tiny, kv_quant):
    """The port's partial import scatters the pages (and the int8 pool's
    scales) exactly as the reference's and writes no slot's length."""
    cfg = tiny[0]
    P, ps, B = 12, 16, 4
    k, v, k_s, v_s = _random_pools(cfg, P, ps, kv_quant, 0)
    lengths = np.array([5, 17, 0, 33], np.int32)
    jc = jkv.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths),
        **({} if k_s is None else dict(k_s=jnp.asarray(k_s),
                                       v_s=jnp.asarray(v_s))))
    t = lambda a: None if a is None else torch.from_numpy(a.copy())
    tc = kv_cache.PagedKVCache(k=t(k), v=t(v), lengths=t(lengths),
                               k_s=t(k_s), v_s=t(v_s))
    bk, bv, bks, bvs = _random_pools(cfg, 2, ps, kv_quant, 1)
    dst = np.array([7, 3], np.int32)
    jc = jkv.import_pages_partial(
        jc, jnp.asarray(dst), P, jnp.asarray(bk), jnp.asarray(bv),
        None if bks is None else jnp.asarray(bks),
        None if bvs is None else jnp.asarray(bvs))
    kv_cache.import_pages_partial(tc, torch.from_numpy(dst), P, t(bk),
                                  t(bv), t(bks), t(bvs))
    np.testing.assert_array_equal(tc.lengths.numpy(), lengths)
    for name in ("k", "v", "lengths") + (("k_s", "v_s")
                                         if kv_quant == "int8" else ()):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    if kv_quant == "int8":
        with pytest.raises(ValueError, match="scales"):
            kv_cache.import_pages_partial(tc, torch.from_numpy(dst), P,
                                          t(bk), t(bv))


def test_engine_refuses_a_tier_payload_of_another_geometry(tiny):
    _, _, tcfg, np_params = tiny
    core = EngineCore(tcfg, EngineConfig(**TIER_GEOMETRY),
                      llama.params_from_jax(np_params, tcfg),
                      eos_id=TOK.eos_id, device="cpu")
    state = core.init_state()
    payload = core.export_slot_kv(state, [1, 2], 32)
    core.validate_pages_payload(payload, 2)
    for n in (0, 3):
        with pytest.raises(ValueError, match="pages"):
            core.validate_pages_payload(payload, n)
    for key, bad in (("page_size", 8), ("kv_dtype", "int8"),
                     ("n_layers", 7)):
        with pytest.raises(ValueError, match=key):
            core.validate_pages_payload({**payload, key: bad}, 1)
    with pytest.raises(ValueError, match="shape"):
        core.validate_pages_payload({**payload, "k": payload["k"][:1]}, 1)
    with pytest.raises(ValueError, match="allocated pages"):
        core.import_pages_kv(state, [5], payload, n_pages=2)
    # one page of two, into other pages: equal K/V, untouched lengths
    before = state.cache.lengths.clone()
    core.import_pages_kv(state, [9], payload, n_pages=1)
    rows = kv_cache._layer_rows(torch.tensor([9]), tcfg.n_layers,
                                core.num_pages)
    src = kv_cache._layer_rows(torch.tensor([1]), tcfg.n_layers,
                               core.num_pages)
    assert torch.equal(state.cache.k[rows], state.cache.k[src])
    assert torch.equal(state.cache.lengths, before)
