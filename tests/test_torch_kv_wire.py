"""The KV wire of the PyTorch port against the JAX package's, on the CPU.

Every engine, scheduler and server case of ``tests/test_kv_wire.py`` has
its counterpart here (the router, affinity, role-planning and chaos cases
wait for their modules: ROADMAP A.10, A.17):

* the binary frame round-trips a payload bit for bit (float32, bfloat16
  and int8 with f32 scales), its arrays read-only views into the body;
  truncated, garbled and misframed bodies raise; transcoding a frame to
  JSON equals encoding the payload directly;
* across the packages: the port's frames and JSON bodies are byte-equal to
  the reference's for the same payload (numpy arrays, torch tensors, a
  ``ml_dtypes`` bf16 array), and each package decodes the other's bit for
  bit, bf16 without ``ml_dtypes`` in the port;
* the encoder waits on a device-native payload's ready event and never
  ships a process-local key;
* a handoff through the frame streams the unified stream's tokens over
  both pools; the in-process payload needs no wire; a grammar rides the
  handoff as scalars and the stream equals the unified grammared one;
* the stdlib server answers frames only to an ``Accept`` that names them,
  JSON otherwise, both streaming the same text through
  ``/v1/kv/handoff``, and refuses truncated and garbled frames with 400, a
  payload its pool cannot host with 409, generation on a prefill worker
  with 409, and an adapter's request on either route with 400.

Streams and arrays are compared exactly (token ids, text, bytes).
"""

import json
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core import kv_wire as jwire
from generativeaiexamples_tpu_torch.core import kv_wire
from generativeaiexamples_tpu_torch.engine import grammar as grammar_mod
from generativeaiexamples_tpu_torch.engine.scheduler import Request
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from tests.test_constrained import validates
from tests.test_torch_kv_handoff import (TOK, _drive, _mk_sched, _text,
                                         one_thread, tiny)  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore")


def _np_payload(dtype="float32"):
    """The reference test's payload, numpy arrays (bf16 via ml_dtypes)."""
    rng = np.random.default_rng(3)
    if dtype == "int8":
        k = rng.integers(-127, 127, (4, 16, 32)).astype(np.int8)
        extra = {"k_s": rng.random((4, 8, 16)).astype(np.float32),
                 "v_s": rng.random((4, 8, 16)).astype(np.float32)}
    else:
        k = rng.random((4, 16, 32)).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
        extra = {"k_s": None, "v_s": None}
    return {"version": 1, "length": 20, "n_pages": 2, "page_size": 16,
            "kv_dtype": dtype, "tenant": "t_acme", "seed": 41,
            "stop": ["\n\n"], "prompt_ids": [1, 2, 3],
            "k": k, "v": k.copy(), **extra}


def _as_torch(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_payload(dtype="float32"):
    p = _np_payload(dtype)
    return {k: (_as_torch(v) if k in kv_wire.PAYLOAD_ARRAYS else v)
            for k, v in p.items()}


def _bits(a) -> np.ndarray:
    """An array's raw bytes as uint8, whatever package made it."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


# ------------------------------------------------------------- frame codec

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frames_roundtrip_bit_exact(dtype):
    payload = _torch_payload(dtype)
    body = kv_wire.encode_kv_frames(payload)
    out = kv_wire.decode_kv_frames(body)
    for key in ("version", "length", "n_pages", "page_size", "kv_dtype",
                "tenant", "seed", "stop", "prompt_ids"):
        assert out[key] == payload[key]
    for key in kv_wire.PAYLOAD_ARRAYS:
        if payload.get(key) is None:
            assert out.get(key) is None
            continue
        assert out[key].dtype == payload[key].dtype
        assert out[key].shape == payload[key].shape
        np.testing.assert_array_equal(_bits(out[key]), _bits(payload[key]))
    # a bf16 segment read back as its 16-bit words, as a host caller reads it
    if dtype == "bfloat16":
        words = out["k"].view(torch.int16).numpy()
        np.testing.assert_array_equal(
            words, payload["k"].view(torch.int16).numpy())
    json_bytes = len(json.dumps(kv_wire.encode_kv_payload(payload)).encode())
    assert len(body) < json_bytes
    meta = kv_wire.peek_kv_frames_meta(body)
    assert meta["tenant"] == "t_acme" and "k" not in meta
    # the JSON wire round-trips too
    back = kv_wire.decode_kv_payload(json.loads(json.dumps(
        kv_wire.encode_kv_payload(payload))))
    np.testing.assert_array_equal(_bits(back["v"]), _bits(payload["v"]))
    assert back["v"].dtype == payload["v"].dtype


def test_frames_integrity_is_loud():
    body = kv_wire.encode_kv_frames(_torch_payload())
    for cut in (3, 7, len(body) // 2, len(body) - 1):
        with pytest.raises(kv_wire.KVWireError):
            kv_wire.decode_kv_frames(body[:cut])
    garbled = bytearray(body)
    garbled[-9] ^= 0x40
    with pytest.raises(kv_wire.KVWireError, match="crc32"):
        kv_wire.decode_kv_frames(bytes(garbled))
    assert not kv_wire.is_kv_frames(b'{"k": 1}')
    with pytest.raises(kv_wire.KVWireError):
        kv_wire.decode_kv_frames(b"NOPE" + body[4:])
    assert kv_wire.is_kv_frames(body)
    assert kv_wire.is_kv_frames(b"", kv_wire.KV_FRAMES_CONTENT_TYPE)
    assert issubclass(kv_wire.KVWireError, ValueError)


def test_transcode_to_json_matches_direct_encode():
    payload = _torch_payload("int8")
    via_frames = kv_wire.transcode_to_json(kv_wire.encode_kv_frames(payload))
    direct = kv_wire.encode_kv_payload(payload)
    assert json.dumps(via_frames, sort_keys=True) == \
        json.dumps(direct, sort_keys=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frames_byte_equal_to_the_reference(dtype):
    """The same payload gives the same bytes in both packages, from numpy
    arrays and from torch tensors, and each decodes the other's bit for
    bit: the reference into ml_dtypes bf16, the port into torch bf16."""
    ref_payload = _np_payload(dtype)
    ref = jwire.encode_kv_frames(ref_payload)
    assert kv_wire.encode_kv_frames(ref_payload) == ref
    assert kv_wire.encode_kv_frames(_torch_payload(dtype)) == ref
    assert json.dumps(kv_wire.encode_kv_payload(_torch_payload(dtype))) == \
        json.dumps(jwire.encode_kv_payload(ref_payload))
    port_side = kv_wire.decode_kv_frames(ref)
    ref_side = jwire.decode_kv_frames(kv_wire.encode_kv_frames(
        _torch_payload(dtype)))
    for key in kv_wire.PAYLOAD_ARRAYS:
        if ref_payload[key] is None:
            assert port_side.get(key) is None and ref_side.get(key) is None
            continue
        np.testing.assert_array_equal(_bits(port_side[key]),
                                      _bits(ref_payload[key]))
        np.testing.assert_array_equal(_bits(ref_side[key]),
                                      _bits(ref_payload[key]))
        assert str(ref_side[key].dtype) == str(ref_payload[key].dtype)
    assert port_side["prompt_ids"] == ref_side["prompt_ids"] == [1, 2, 3]


def test_encoder_waits_for_the_gather_and_ships_no_local_key():
    """A device-native payload's ready event is waited on before any byte
    is read, and ``_``-keys stay in the process: the frame equals the one
    of the payload without them."""
    waited = []

    class Event:
        def synchronize(self):
            waited.append(True)

    payload = _torch_payload()
    local = dict(payload, **{kv_wire.READY_KEY: Event()})
    assert kv_wire.encode_kv_frames(local) == \
        kv_wire.encode_kv_frames(payload)
    assert json.dumps(kv_wire.encode_kv_payload(local)) == \
        json.dumps(kv_wire.encode_kv_payload(payload))
    assert waited == [True, True]


# ------------------------------------- engine: binary wire token identity

@pytest.mark.parametrize("kv_quant,spec", [("none", "on"), ("int8", "off")])
def test_handoff_binary_wire_token_identical(tiny, kv_quant, spec):
    """Prefill-role export -> frame -> decode-role import streams the
    unified stream's tokens; the export stays on the engine's device (a
    torch tensor, no host copy on the driver thread) and the decoded
    frame's read-only views feed the import as they are."""
    prompt = TOK.encode("the quick brown fox jumps over the lazy dog")
    kw = dict(max_tokens=12, temperature=0.7, seed=123)
    dec = _mk_sched(tiny, "decode", kv_quant, spec)
    ref = Request(prompt_ids=list(prompt), **kw)
    _drive(dec, [ref])
    ref_text = _text(ref)
    assert ref_text

    pre = _mk_sched(tiny, "prefill", kv_quant, spec)
    rp = Request(prompt_ids=list(prompt), prefill_only=True, **kw)
    _drive(pre, [rp])
    assert rp.error is None, rp.error
    assert isinstance(rp.handoff["k"], torch.Tensor)
    if kv_quant == "int8":
        assert rp.handoff["k"].dtype == torch.int8
        assert rp.handoff["k_s"].dtype == torch.float32

    body = kv_wire.encode_kv_frames(rp.handoff)
    json_bytes = len(json.dumps(kv_wire.encode_kv_payload(rp.handoff))
                     .encode())
    assert len(body) <= 0.75 * json_bytes + 2048, (len(body), json_bytes)
    payload = kv_wire.decode_kv_frames(body)
    rd = Request(prompt_ids=list(payload["prompt_ids"]), **kw)
    dec.submit_prefilled(rd, payload)
    _drive(dec, [rd], submit=False)
    assert rd.error is None, rd.error
    assert _text(rd) == ref_text
    assert rd.output_ids == ref.output_ids


def test_inprocess_device_native_handoff_skips_host(tiny):
    """Prefill and decode schedulers in one process hand the payload over
    without a wire: its tensors go straight into the import."""
    prompt = TOK.encode("voltage report for pump four")
    kw = dict(max_tokens=10, temperature=0.0, seed=9)
    dec = _mk_sched(tiny, "decode")
    ref = Request(prompt_ids=list(prompt), **kw)
    _drive(dec, [ref])
    pre = _mk_sched(tiny, "prefill")
    rp = Request(prompt_ids=list(prompt), prefill_only=True, **kw)
    _drive(pre, [rp])
    assert isinstance(rp.handoff["k"], torch.Tensor)
    assert kv_wire.READY_KEY not in rp.handoff     # no event on the CPU
    rd = Request(prompt_ids=list(rp.handoff["prompt_ids"]), **kw)
    dec.submit_prefilled(rd, rp.handoff)
    _drive(dec, [rd], submit=False)
    assert rd.error is None and rd.output_ids == ref.output_ids


def test_grammar_rides_the_handoff(tiny):
    """The grammar's spec and prefix ride as scalars, the decode side walks
    the DFA over the remotely sampled first token, and the stream equals
    the unified grammared one and validates."""
    schema = {"type": "array", "items": {"type": "integer"}, "minItems": 1}
    spec = ("schema", json.dumps(schema))
    prompt = TOK.encode("reply with a JSON array of integers")
    kw = dict(max_tokens=24, temperature=1.0, seed=77)
    dec = _mk_sched(tiny, "decode")
    ref = Request(prompt_ids=list(prompt),
                  grammar=grammar_mod.Grammar.from_schema(schema), **kw)
    _drive(dec, [ref])
    assert ref.error is None and ref.grammar_attached is True
    ref_text = _text(ref)
    assert validates(json.loads(ref_text), schema), ref_text

    pre = _mk_sched(tiny, "prefill")
    rp = Request(prompt_ids=list(prompt), prefill_only=True,
                 grammar=grammar_mod.Grammar.from_schema(schema),
                 grammar_spec=spec, **kw)
    _drive(pre, [rp])
    assert rp.error is None, rp.error
    assert rp.handoff["grammar_kind"] == "schema"
    assert rp.handoff["grammar_attached"] is True
    payload = kv_wire.decode_kv_frames(kv_wire.encode_kv_frames(rp.handoff))
    rd = Request(prompt_ids=list(payload["prompt_ids"]),
                 grammar=grammar_mod.Grammar.from_schema(
                     json.loads(payload["grammar_payload"])), **kw)
    dec.submit_prefilled(rd, payload)
    _drive(dec, [rd], submit=False)
    assert rd.error is None, rd.error
    assert rd.grammar_attached is True
    rd_text = _text(rd)
    assert rd_text == ref_text
    assert validates(json.loads(rd_text), schema), rd_text


# ------------------------------------------------- server HTTP negotiation

def _post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def _sse_text(raw: bytes) -> str:
    parts = []
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            chunk = json.loads(line[6:])
            assert not chunk.get("error"), chunk
            delta = chunk["choices"][0].get("delta", {}).get("content")
            if delta:
                parts.append(delta)
    return "".join(parts)


@pytest.fixture
def servers(tiny):
    """A prefill and a decode worker behind the port's HTTP server."""
    out = []
    for role in ("prefill", "decode"):
        sched = _mk_sched(tiny, role)
        httpd, thread = serve_in_thread(sched, "tiny")
        out.append((f"http://127.0.0.1:{httpd.server_address[1]}", sched,
                    httpd))
    yield out
    for _, sched, httpd in out:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()


def test_server_negotiates_wire_and_rejects_corrupt_frames(servers):
    """/v1/kv/prefill answers a frame to a frames Accept and JSON to any
    other; /v1/kv/handoff takes both and streams the same text; truncated
    and garbled frames are 400 before any import; a pool mismatch is 409;
    a prefill worker answers 409 on generation."""
    (pre_url, pre, _), (dec_url, dec, _) = servers
    body = json.dumps({"messages": [{"role": "user",
                                     "content": "list the pump voltages"}],
                       "max_tokens": 10, "temperature": 0.0,
                       "seed": 5}).encode()
    with urllib.request.urlopen(pre_url + "/health") as resp:
        health = json.loads(resp.read())
    assert "binary" in health["kv_wire"]
    assert health["engine_role"] == "prefill"
    status, ctype, frame = _post(pre_url + "/v1/kv/prefill", body, {
        "Content-Type": "application/json",
        "Accept": kv_wire.KV_FRAMES_CONTENT_TYPE})
    assert status == 200, frame
    assert ctype == kv_wire.KV_FRAMES_CONTENT_TYPE
    assert kv_wire.is_kv_frames(frame)
    status, ctype, legacy = _post(pre_url + "/v1/kv/prefill", body,
                                  {"Content-Type": "application/json"})
    assert status == 200 and ctype == "application/json"
    assert "b64" in json.loads(legacy)["k"]
    assert len(frame) < len(legacy)
    assert pre.stats["decode_dispatches"] == 0

    frames_ct = {"Content-Type": kv_wire.KV_FRAMES_CONTENT_TYPE}
    status, _, text = _post(dec_url + "/v1/kv/handoff",
                            frame[:len(frame) // 2], frames_ct)
    assert status == 400 and b"frame" in text
    garbled = bytearray(frame)
    garbled[-17] ^= 0x01
    status, _, _ = _post(dec_url + "/v1/kv/handoff", bytes(garbled),
                         frames_ct)
    assert status == 400
    status, _, _ = _post(dec_url + "/v1/kv/handoff", b"{not json",
                         {"Content-Type": "application/json"})
    assert status == 400
    # geometry this pool cannot host: 409, loud
    bad = kv_wire.decode_kv_frames(frame)
    bad["page_size"] = 32
    status, _, text = _post(dec_url + "/v1/kv/handoff",
                            kv_wire.encode_kv_frames(bad), frames_ct)
    assert status == 409 and b"page_size" in text
    assert dec.stats["kv_handoff_submitted"] == 0

    status, _, raw_bin = _post(dec_url + "/v1/kv/handoff", frame, frames_ct)
    assert status == 200, raw_bin
    status, _, raw_json = _post(dec_url + "/v1/kv/handoff", legacy,
                                {"Content-Type": "application/json"})
    assert status == 200
    t_bin, t_json = _sse_text(raw_bin), _sse_text(raw_json)
    assert t_bin and t_bin == t_json
    assert dec.stats["kv_handoff_imports"] == 2
    assert dec.stats["prefill_dispatches"] == 0

    # generation on a prefill worker: 409
    status, _, text = _post(pre_url + "/v1/chat/completions", body,
                            {"Content-Type": "application/json"})
    assert status == 409 and b"APP_ENGINE_ROLE=prefill" in text
    # the handed-off text equals the decode worker's own answer
    status, _, full = _post(dec_url + "/v1/chat/completions", body,
                            {"Content-Type": "application/json"})
    assert status == 200
    assert json.loads(full)["choices"][0]["message"]["content"] == t_bin
