"""The host planes on the port's stdlib servers, against the reference's
aiohttp servers on the CPU (the tiny model, ``PRNGKey(5)`` weights through
``params_from_jax``).

* ``POST /debug/drain?evacuate=1`` ends a live stream "evacuated", its
  snapshot parks at ``/v1/kv/evacuation/<rid>`` (served once), a peer
  resumes it and the joined text equals the unevacuated oracle and the
  JAX ``Scheduler``'s stream; ``/health`` answers 503 while draining and
  200 after ``?off=1``; without a watchdog the drain is 409; SIGTERM's
  handler drains and evacuates; a tripped watchdog answers 503
  (``tests/test_live_migration.py`` and ``tests/test_chaos.py``'s cases);
* ``/metrics`` in JSON, Prometheus and OpenMetrics form, every debug route
  of ``server/common.DEBUG_ROUTES`` and its refusals (404, 400);
* the same request (an SLO class, a tenant, a caller's request id) through
  the reference's aiohttp engine server and the port's: ``/health``,
  ``/debug/requests/<rid>``, ``/debug/slo``, ``/debug/usage``,
  ``/debug/chaos``, ``/debug/trace``, ``/debug/locks``, ``/debug/fleet``,
  ``/debug/deadletter``, ``/debug/compiles`` and ``/debug/devtime``
  compared field for field (times and the servers' own hint texts
  excepted);
* an unknown SLO class is a 400 on both; the chaos plane's server fault
  answers 503; the chain and encoder servers carry the debug surface and
  the drain switch (``?evacuate=1`` is 409 there).
"""

import asyncio
import json
from collections import deque
import signal
import time
import urllib.error
import urllib.request

import pytest

from generativeaiexamples_tpu.chains import event_agent as jevent_agent
from generativeaiexamples_tpu.engine.server import ModelServer as JModelServer
from generativeaiexamples_tpu.observability import chaos as jchaos
from generativeaiexamples_tpu.observability import devtime as jdevtime
from generativeaiexamples_tpu.observability import flight as jflight
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu.observability import trace as jtrace
from generativeaiexamples_tpu.observability import usage as jusage
from generativeaiexamples_tpu_torch.chains import event_agent as tevent_agent
from generativeaiexamples_tpu_torch.core import kv_wire
from generativeaiexamples_tpu_torch.engine.server import (
    install_sigterm_drain, serve_in_thread)
from generativeaiexamples_tpu_torch.engine.watchdog import EngineWatchdog
from generativeaiexamples_tpu_torch.observability import chaos as tchaos
from generativeaiexamples_tpu_torch.observability import devtime as tdevtime
from generativeaiexamples_tpu_torch.observability import flight as tflight
from generativeaiexamples_tpu_torch.observability import slo as tslo
from generativeaiexamples_tpu_torch.observability import trace as ttrace
from generativeaiexamples_tpu_torch.observability import usage as tusage
from generativeaiexamples_tpu_torch.server import common
from tests.test_torch_kv_handoff import (_jax_sched, _mk_sched, one_thread,
                                         tiny)  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore")

BODY = {"messages": [{"role": "user", "content": "list the pump voltages"}],
        "max_tokens": 40, "temperature": 0.0, "seed": 5}


def reset_planes():
    """Both packages' process-global planes back to a clean slate."""
    for slo, usage, flight, devtime, chaos, trace in (
            (jslo, jusage, jflight, jdevtime, jchaos, jtrace),
            (tslo, tusage, tflight, tdevtime, tchaos, ttrace)):
        slo.SLO.reset()
        usage.USAGE.reset()
        flight.FLIGHT.clear()
        flight.REQUEST_LOG.clear()
        devtime.DEVTIME.reset()
        devtime.DEVTIME.configure(mode="off")
        chaos.CHAOS.reset()
        trace.TRACE.configure(mode="off")
        trace.TRACE.reset()


@pytest.fixture(autouse=True)
def clean_planes():
    reset_planes()
    yield
    reset_planes()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _post(url, body=b"", headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _chat(url, body, headers=None):
    status, hdrs, raw = _post(url + "/v1/chat/completions",
                              json.dumps(body).encode(),
                              {"Content-Type": "application/json",
                               **(headers or {})})
    return status, hdrs, json.loads(raw)


def _server(tiny, watchdog=False, role="decode"):  # noqa: F811
    sched = _mk_sched(tiny, role)
    wd = EngineWatchdog(sched) if watchdog else None
    httpd, thread = serve_in_thread(sched, "tiny", watchdog=wd)
    return f"http://127.0.0.1:{httpd.server_address[1]}", sched, httpd, wd


def _close(*servers):
    for _, sched, httpd, _wd in servers:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()


def _sse_content(raw: str):
    text, finish = [], None
    for line in raw.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        choice = json.loads(line[6:])["choices"][0]
        content = choice.get("delta", {}).get("content")
        if content:
            text.append(content)
        finish = choice.get("finish_reason") or finish
    return "".join(text), finish


# --------------------------------------------------------------- drain


def test_drain_evacuate_http_surface(tiny):  # noqa: F811
    """A live stream + ``POST /debug/drain?evacuate=1``: the stream ends
    "evacuated", the drain's summary names it, ``/health`` is 503, the
    snapshot is served once, the peer's resume joins to the oracle (which
    equals the JAX ``Scheduler``'s stream) and ``?off=1`` serves again."""
    src = _server(tiny, watchdog=True)
    peer = _server(tiny)
    (src_url, src_sched, _, wd), (peer_url, peer_sched, _, _) = src, peer
    dispatch = src_sched._dispatch_decode

    def slow_dispatch(*a, **k):
        time.sleep(0.05)    # the client reads a token while decode runs
        return dispatch(*a, **k)

    src_sched._dispatch_decode = slow_dispatch
    try:
        status, _, got = _chat(peer_url, BODY)
        assert status == 200
        oracle = got["choices"][0]["message"]["content"]
        jsched = _jax_sched(tiny, "decode")
        from tests.test_torch_kv_handoff import JTOK, _drive, _text
        from generativeaiexamples_tpu.engine.scheduler import (
            Request as JaxRequest)
        jreq = JaxRequest(prompt_ids=JTOK.apply_chat_template(
            BODY["messages"]), max_tokens=40, temperature=0.0, seed=5)
        _drive(jsched, [jreq])
        assert _text(jreq) == oracle
        req = urllib.request.Request(
            src_url + "/v1/chat/completions",
            data=json.dumps(dict(BODY, stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        delivered, finish, drained = [], None, None
        with urllib.request.urlopen(req, timeout=120) as resp:
            rid = resp.headers["X-Request-Id"]
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                content = choice["delta"].get("content")
                if content:
                    delivered.append(content)
                finish = choice.get("finish_reason") or finish
                if drained is None and content:
                    status, _, raw = _post(src_url + "/debug/drain"
                                           "?evacuate=1")
                    drained = (status, json.loads(raw))
        assert finish == "evacuated"
        status, body = drained
        assert status == 200 and body["draining"] is True
        assert rid in body["evacuation"]["snapshot"]
        assert _get(src_url + "/health")[0] == 503
        assert json.loads(_get(src_url + "/health")[2])["watchdog"][
            "draining"] is True
        status, hdrs, frame = _get(
            src_url + f"/v1/kv/evacuation/{rid}",
            {"Accept": kv_wire.KV_FRAMES_CONTENT_TYPE})
        assert status == 200 and kv_wire.is_kv_frames(frame)
        assert _get(src_url + f"/v1/kv/evacuation/{rid}")[0] == 404
        pre = "".join(delivered)
        assert oracle.startswith(pre) and pre != oracle
        status, _, raw = _post(
            peer_url + "/v1/kv/handoff", frame,
            {"Content-Type": kv_wire.KV_FRAMES_CONTENT_TYPE,
             "X-Resume-Chars": str(len(pre))})
        assert status == 200
        rest, fin2 = _sse_content(raw.decode())
        assert pre + rest == oracle
        assert fin2 in ("stop", "length")
        assert peer_sched.stats["snapshot_resumes"] == 1
        status, _, raw = _post(src_url + "/debug/drain?off=1")
        assert status == 200 and json.loads(raw)["draining"] is False
        assert _get(src_url + "/health")[0] == 200
        # the evacuation's flight event and the timeline's finish
        assert any(e["event"] == "evacuation"
                   for e in tflight.FLIGHT.events())
        assert tflight.REQUEST_LOG.get(rid)["finish"] == "evacuated"
    finally:
        _close(src, peer)


def test_drain_without_watchdog_is_409(tiny):  # noqa: F811
    srv = _server(tiny)
    try:
        status, _, raw = _post(srv[0] + "/debug/drain")
        assert status == 409 and "watchdog" in json.loads(raw)["error"]
        assert _get(srv[0] + "/health")[0] == 200
    finally:
        _close(srv)


def test_sigterm_handler_drains_and_evacuates(tiny):  # noqa: F811
    """The SIGTERM handler (called directly: the test runs off the main
    thread's signal handlers) drains, queues a non-blocking evacuation of
    every live stream, and exits after the grace; a second call is a
    no-op. Off the main thread nothing is installed."""
    sched = _mk_sched(tiny, "decode")
    wd = EngineWatchdog(sched)
    exits = []
    before = signal.getsignal(signal.SIGTERM)
    handler = install_sigterm_drain(sched, wd, grace_s=0.05,
                                    exit_fn=lambda: exits.append(1))
    import threading
    if threading.current_thread() is threading.main_thread():
        assert signal.getsignal(signal.SIGTERM) is handler
        signal.signal(signal.SIGTERM, before)
    try:
        from generativeaiexamples_tpu_torch.engine.scheduler import Request
        from tests.test_torch_kv_handoff import TOK
        req = Request(prompt_ids=TOK.encode("write about pumps and valves"),
                      max_tokens=60, temperature=0.0, seed=3)
        sched.submit(req)
        for _ in range(400):
            sched._tick()
            if req.completion_tokens >= 3:
                break
        handler(signal.SIGTERM, None)
        handler(signal.SIGTERM, None)
        assert wd.draining and not wd.serving_ok()
        for _ in range(50):
            sched._tick()
            if req.finished_at is not None:
                break
        assert req.finish_reason == "evacuated"
        assert sched.take_evacuated(req.request_id) is not None
        for _ in range(100):
            if exits:
                break
            time.sleep(0.02)
        assert exits == [1]
    finally:
        sched.stop()


def test_health_answers_503_while_tripped_or_draining(tiny):  # noqa: F811
    """A tick stall past the bound trips the watchdog (on an injected
    clock): ``/health`` answers 503 with the trip named; the heartbeat
    clears it; a drain answers 503 too, ``?off=1`` lifts it."""
    now = [100.0]
    sched = _mk_sched(tiny, "decode")
    wd = EngineWatchdog(sched, tick_stall_s=5.0, clock=lambda: now[0])
    wd.evacuate_on_trip = False
    httpd, _ = serve_in_thread(sched, "tiny", watchdog=wd)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        sched._running_saved = sched._running
        sched.last_tick_mono = 90.0
        sched._running = True
        assert wd.check() is False
        status, _, raw = _get(url + "/health")
        body = json.loads(raw)
        assert status == 503 and body["watchdog"]["tripped"] == [
            "tick_stall"]
        assert "watchdog tripped" in body["message"]
        sched.last_tick_mono = now[0]
        assert wd.check() is True
        assert _get(url + "/health")[0] == 200
        assert _post(url + "/debug/drain")[0] == 200
        status, _, raw = _get(url + "/health")
        assert status == 503 and json.loads(raw)["message"] == \
            "Service is draining."
        assert _post(url + "/debug/drain?off=1")[0] == 200
        assert _get(url + "/health")[0] == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()


# ------------------------------------------------------ metrics and debug


def test_metrics_and_debug_routes_over_http(tiny):  # noqa: F811
    srv = _server(tiny)
    url, sched = srv[0], srv[1]
    try:
        status, hdrs, got = _chat(url, BODY, {"X-Request-Id": "probe-1"})
        assert status == 200 and hdrs["X-Request-Id"] == "probe-1"
        status, hdrs, raw = _get(url + "/metrics")
        snap = json.loads(raw)
        assert hdrs["Content-Type"] == "application/json"
        assert snap["requests_submitted"] >= 1
        assert snap["decode_steps"] >= sched.stats["decode_steps"]
        status, hdrs, raw = _get(url + "/metrics",
                                 {"Accept": "text/plain"})
        assert hdrs["Content-Type"].startswith("text/plain")
        assert "# TYPE prefill_chunks counter" in raw.decode()
        status, hdrs, raw = _get(url + "/metrics?format=openmetrics")
        assert hdrs["Content-Type"].startswith(
            "application/openmetrics-text")
        assert raw.decode().rstrip().endswith("# EOF")
        for path in common.DEBUG_ROUTES:
            status, _, raw = _get(url + path)
            assert status == 200, (path, raw)
            assert isinstance(json.loads(raw), dict)
        rec = json.loads(_get(url + "/debug/requests/probe-1")[2])
        assert list(rec["phases"]) == list(tflight._PHASES)
        assert rec["completion_tokens"] == got["usage"]["completion_tokens"]
        assert _get(url + "/debug/requests/absent")[0] == 404
        assert _get(url + "/debug/flight?window=soon")[0] == 400
        assert json.loads(_get(url + "/debug/requests?n=1")[2])["limit"] == 1
        assert _get(url + "/debug/nothing")[0] == 404
        assert _post(url + "/debug/nothing")[0] == 404
        assert json.loads(_get(url + "/debug/flight?limit=99999")[2])[
            "limit"] == common.FLIGHT_LIMIT_MAX
    finally:
        _close(srv)


def test_unknown_slo_class_is_a_400_and_deadline_is_stamped(tiny):  # noqa: F811
    srv = _server(tiny)
    url, sched = srv[0], srv[1]
    seen = []
    submit = sched.submit

    def recording(req):
        seen.append(req)
        return submit(req)

    sched.submit = recording
    try:
        status, _, body = _chat(url, BODY, {"X-Request-Class": "platinum"})
        assert status == 400 and "platinum" in body["error"]
        status, _, _ = _chat(url, BODY, {"X-Slo-Class": "batch",
                                         "X-Deadline-Ms": "45000",
                                         "X-Tenant-Id": "acme"})
        assert status == 200
        req = seen[-1]
        assert (req.slo_class, req.deadline_s, req.tenant) == (
            "batch", 45.0, "acme")
        assert req.slo["outcome"] == "attained"
    finally:
        _close(srv)


def test_chaos_server_fault_answers_503(tiny):  # noqa: F811
    srv = _server(tiny)
    try:
        tchaos.CHAOS.configure(mode="on", seed=1, spec="http.error=1/0/1")
        status, _, body = _chat(srv[0], BODY)
        assert status == 503 and "chaos" in body["error"]
        status, _, _ = _chat(srv[0], BODY)     # the cap recovers
        assert status == 200
        snap = json.loads(_get(srv[0] + "/debug/chaos")[2])
        assert snap["faults"]["http.error"]["injected"] == 1
    finally:
        tchaos.CHAOS.reset()
        _close(srv)


def _jax_bodies(tiny, headers):  # noqa: F811
    """The reference's aiohttp engine server on the JAX ``Scheduler``:
    one chat under ``headers``, then the plane bodies."""
    from aiohttp.test_utils import TestClient, TestServer

    jsched = _jax_sched(tiny, "decode")
    jsched.start()
    srv = JModelServer(jsched, "tiny")

    async def drive():
        client = TestClient(TestServer(srv.app))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json=BODY,
                                     headers=headers)
            chat = await resp.json()
            out = {"chat": (resp.status, chat)}
            for path in ("/health", "/debug/requests/same-rid",
                         "/debug/slo", "/debug/usage", "/debug/chaos",
                         "/debug/trace", "/debug/locks", "/debug/fleet",
                         "/debug/deadletter", "/debug/compiles",
                         "/debug/devtime"):
                r = await client.get(path)
                out[path] = (r.status, await r.json())
            return out
        finally:
            await client.close()

    try:
        return asyncio.run(drive())
    finally:
        jsched.stop()


def _keys(d):
    return sorted(d) if isinstance(d, dict) else d


def test_plane_bodies_match_the_reference_server(tiny,  # noqa: F811
                                                  monkeypatch):
    # the reference's router is process-global too: another test of this
    # process may have left one current, whose fleet view /debug/fleet
    # would answer; a lone worker has none
    from generativeaiexamples_tpu.server import failover
    monkeypatch.setattr(failover, "_ROUTER", None)
    # so are both dead-letter rings and their counters: start each ring
    # empty and compare the counters' change over this test
    dead_before = {}
    for name, mod in (("jax", jevent_agent), ("torch", tevent_agent)):
        monkeypatch.setattr(mod, "DEAD_LETTERS",
                            deque(maxlen=mod.DEAD_LETTERS.maxlen))
        dead_before[name] = mod.dead_letter_payload()["total"]
    headers = {"X-Request-Id": "same-rid", "X-Slo-Class": "batch",
               "X-Tenant-Id": "acme"}
    want = _jax_bodies(tiny, headers)
    reset_usage = tusage.USAGE.snapshot()["tenants"]
    assert reset_usage == {}
    srv = _server(tiny)
    try:
        status, _, chat = _chat(srv[0], BODY, headers)
        got = {"chat": (status, chat)}
        for path in want:
            if path != "chat":
                status, _, raw = _get(srv[0] + path)
                got[path] = (status, json.loads(raw))
    finally:
        _close(srv)
    assert got["chat"][0] == want["chat"][0] == 200
    assert (got["chat"][1]["choices"][0]["message"]
            == want["chat"][1]["choices"][0]["message"])
    for path in want:
        assert got[path][0] == want[path][0], path
    # /health: the reference's plane fields, same keys and values
    jh, th = want["/health"][1], got["/health"][1]
    assert th["slo_pressure"] == jh["slo_pressure"] == "ok"
    assert _keys(th["perf"]) == _keys(jh["perf"])
    assert th["perf"]["mfu"] is None and jh["perf"]["mfu"] is None
    assert {t: {k: v for k, v in row.items() if "_s" not in k}
            for t, row in th["usage_by_tenant"].items()} == \
        {t: {k: v for k, v in row.items() if "_s" not in k}
         for t, row in jh["usage_by_tenant"].items()}
    assert "acme" in th["usage_by_tenant"]
    # the timeline: every field but the clock readings
    jr, tr = want["/debug/requests/same-rid"][1], \
        got["/debug/requests/same-rid"][1]
    assert _keys(tr) == _keys(jr)
    assert list(tr["phases"]) == list(jr["phases"])
    assert _keys(tr["durations_s"]) == _keys(jr["durations_s"])
    for key in ("request_id", "preemptions", "spill_resumes",
                "snapshot_resumes", "prefix_hit_tokens", "tier_hit_tokens",
                "completion_tokens", "prompt_tokens", "finish", "error",
                "tenant", "slo_class"):
        assert tr[key] == jr[key], key
    assert tr["slo"]["outcome"] == jr["slo"]["outcome"] == "attained"
    assert tr["slo"]["class"] == jr["slo"]["class"] == "batch"
    # /debug/slo: the same classes, budgets, counts and pressure
    js, ts = want["/debug/slo"][1], got["/debug/slo"][1]
    assert _keys(ts) == _keys(js)
    for key in ("pressure", "target", "windows_s", "thresholds",
                "default_class"):
        assert ts[key] == js[key], key
    # one judged request each (its outcome is timing: the reference's first
    # call compiles; attainment is compared on an injected clock in
    # tests/test_torch_plane_scheduler.py); lifetimes are process-wide
    for cls in js["classes"]:
        for key in ("budgets", "sheddable", "window_events"):
            assert ts["classes"][cls][key] == js["classes"][cls][key]
        for key in ("burn_rate", "lifetime"):
            assert _keys(ts["classes"][cls][key]) == _keys(
                js["classes"][cls][key])
    # /debug/usage: the tenant vectors' counts
    ju, tu = want["/debug/usage"][1], got["/debug/usage"][1]
    assert _keys(tu) == _keys(ju)
    assert tu["basis"] == ju["basis"] == "tokens"
    for key in ("requests", "errors", "tokens_in", "tokens_out",
                "prefix_hit_tokens", "retries", "hedges", "handoffs"):
        assert tu["tenants"]["acme"][key] == ju["tenants"]["acme"][key]
    assert _keys(tu["tenants"]["acme"]) == _keys(ju["tenants"]["acme"])
    # the other planes' bodies, field for field (hint texts name each
    # package's own documents)
    assert got["/debug/chaos"][1] == want["/debug/chaos"][1]
    jdl, tdl = dict(want["/debug/deadletter"][1]), \
        dict(got["/debug/deadletter"][1])
    jdl["total"] -= dead_before["jax"]
    tdl["total"] -= dead_before["torch"]
    assert tdl == jdl
    for path in ("/debug/trace", "/debug/locks"):
        tb = {k: v for k, v in got[path][1].items() if k != "hint"}
        jb = {k: v for k, v in want[path][1].items() if k != "hint"}
        assert tb == jb, path
    jf, tf = want["/debug/fleet"][1], got["/debug/fleet"][1]
    assert _keys(tf) == _keys(jf) and tf["workers"] == jf["workers"] == {}
    assert _keys(tf["local_perf"]) == _keys(jf["local_perf"])
    jc, tc = want["/debug/compiles"][1], got["/debug/compiles"][1]
    assert _keys(tc) == _keys(jc)
    # the same program shapes first seen mid-serving (no warmup here)
    assert sorted((e["program"], e["bucket"], e["during_serving"])
                  for e in tc["events"]) == sorted(
        (e["program"], e["bucket"], e["during_serving"])
        for e in jc["events"])
    jd, td = want["/debug/devtime"][1], got["/debug/devtime"][1]
    assert _keys(td) == _keys(jd)
    assert td["mode"] == jd["mode"] == "off"
    assert td["totals"]["timed"] == jd["totals"]["timed"] == 0


# ------------------------------------------------- chain and encoder servers


class _Example:
    """A chain-server example with nothing behind it (the drain and debug
    routes need none)."""

    ctx = None

    def llm_chain(self, query, chat_history, **kw):
        yield "ok"

    rag_chain = llm_chain

    def ingest_docs(self, path, name):
        pass


@pytest.mark.parametrize("kind", ["chain", "encoder"])
def test_chain_and_encoder_servers_drain_switch_and_debug(kind):
    """The servers without an engine: ``POST /debug/drain`` flips
    ``/health`` to 503 (``?evacuate=1`` is a 409: no KV state to move),
    ``?off=1`` serves again; the debug routes answer."""
    if kind == "chain":
        from generativeaiexamples_tpu_torch.server.api import serve_in_thread \
            as serve
        _, httpd, _ = serve(_Example())
    else:
        from generativeaiexamples_tpu_torch.encoders.server import (
            serve_in_thread as serve)
        _, httpd, _ = serve()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, _, raw = _get(url + "/health")
        assert status == 200 and json.loads(raw)["slo_pressure"] == "ok"
        assert _post(url + "/debug/drain?evacuate=1")[0] == 409
        status, _, raw = _post(url + "/debug/drain")
        assert status == 200 and json.loads(raw) == {"draining": True}
        status, _, raw = _get(url + "/health")
        assert status == 503 and json.loads(raw)["message"] == \
            "Service is draining."
        assert json.loads(_post(url + "/debug/drain?off=1")[2]) == {
            "draining": False}
        assert _get(url + "/health")[0] == 200
        for path in ("/debug/slo", "/debug/devtime", "/debug/usage",
                     "/debug/requests", "/debug/flight"):
            assert _get(url + path)[0] == 200, path
    finally:
        common.DRAIN.undrain()
        httpd.shutdown()
        httpd.server_close()
