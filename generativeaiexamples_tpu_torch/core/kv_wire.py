"""KV-handoff wire codecs: the binary frame and the JSON-base64 compat form.

Port of ``generativeaiexamples_tpu/core/kv_wire.py``. A prefilled or
mid-decode slot's KV pages travel between engine workers either as JSON
(each array a ``{b64, dtype, shape}`` triple, the compat wire) or as one
framed octet-stream body whose arrays are written and read as raw bytes:

    ``KVW1`` magic | u32 header length | JSON header | aligned segments

The header holds every non-array key of the payload verbatim (geometry,
sampling state, grammar spec) and one descriptor per segment: dtype, shape,
byte offset and length in the segment area, and a crc32. Decoding checks
every segment's bounds and crc32 before anything is returned: a truncated
or garbled body raises :class:`KVWireError` (HTTP 400 at the server),
never reaches a pool. The frames are byte-identical to the reference's for
the same payload (the same header JSON, key order, 64-byte alignment and
crc32), so a frame from either package decodes in the other.

bfloat16 without ``ml_dtypes``: a bf16 array rides as its raw 2-byte words
under the header dtype ``"bfloat16"``. Encoding takes torch tensors (CPU or
CUDA) and numpy arrays, among them a numpy array whose dtype is named
``bfloat16`` (the reference's host export), read as ``uint16``. Decoding
gives read-only torch tensors over the body (``torch.frombuffer``; a bf16
segment is viewed as ``torch.bfloat16``).

A CUDA tensor is copied to the host here, at encode time, on the thread
that encodes. A device-native export payload carries, under
:data:`READY_KEY`, the CUDA event recorded on the serving stream behind its
gather; the encoder waits on it before the copy. Keys that start with
``"_"`` are process-local and never ride the wire.
"""

from __future__ import annotations

import base64
import json
import struct
import warnings
import zlib
from typing import Any, Dict

import numpy as np
import torch

# array-valued keys of a handoff payload; everything else is scalar
# passthrough
PAYLOAD_ARRAYS = ("k", "v", "k_s", "v_s")

# int-list keys the binary frame packs as narrow integer segments instead of
# JSON text, decoded back to plain Python lists; the JSON wire keeps them as
# scalar passthrough
_PACKED_INT_LISTS = ("prompt_ids",)

# the binary frame's content type: /v1/kv/prefill serves it when the
# client's Accept names it; /v1/kv/handoff accepts it as a request body
KV_FRAMES_CONTENT_TYPE = "application/x-kv-frames"

# the CUDA event a device-native export recorded behind its gather
READY_KEY = "_ready"

_MAGIC = b"KVW1"
_PREFIX = struct.Struct("<4sI")     # magic, header byte length
_ALIGN = 64                         # segment alignment (dtype-safe views)
_MAX_HEADER = 16 * 1024 * 1024      # a header is metadata, never bulk data

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8,
                 "uint8": torch.uint8, "int16": torch.int16,
                 "uint16": torch.uint16, "int32": torch.int32,
                 "int64": torch.int64}


class KVWireError(ValueError):
    """A wire body that cannot be decoded safely: truncated, misframed, or
    failing its crc32. The serving layer answers 400, before any byte
    reaches the pool."""


def _dtype_name(value) -> str:
    """The payload's dtype string of an array: numpy's name (``"float32"``,
    ``"int8"``, ``"bfloat16"`` for an ``ml_dtypes`` array) or a torch
    dtype's without its ``torch.`` prefix."""
    if isinstance(value, torch.Tensor):
        return str(value.dtype).removeprefix("torch.")
    return str(np.asarray(value).dtype)


def _host_array(value) -> np.ndarray:
    """A contiguous numpy array of ``value``'s bytes: a CUDA tensor is
    copied to the host, a bf16 tensor or ``ml_dtypes`` array viewed as
    ``uint16``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.is_cuda:
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.numpy().view(np.uint16)
        return t.numpy()
    arr = np.ascontiguousarray(value)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def _wait_ready(payload: Dict[str, Any]) -> None:
    event = payload.get(READY_KEY)
    if event is not None:
        event.synchronize()


def _meta_items(payload: Dict[str, Any]):
    return ((key, value) for key, value in payload.items()
            if not key.startswith("_"))


def _from_bytes(buf, name: str, shape):
    """A read-only torch tensor of ``shape`` over ``buf`` (bf16 as
    ``torch.bfloat16``)."""
    shape = tuple(int(s) for s in shape)
    dt = _TORCH_DTYPES.get(name)
    if dt is None:
        raise KVWireError(f"kv payload dtype {name!r} is not one the port "
                          f"reads")
    if len(buf) == 0:
        return torch.empty(shape, dtype=dt)
    with warnings.catch_warnings():
        # the body is read-only; nothing writes through these views
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(buf, dtype=torch.uint8)
    return raw.view(dt).reshape(shape)


def _itemsize(name: str) -> int:
    dt = _TORCH_DTYPES.get(name)
    return dt.itemsize if dt is not None else np.dtype(name).itemsize


# --------------------------------------------------------------- JSON form

def encode_kv_payload(payload: dict) -> dict:
    """Handoff payload -> JSON-safe dict: arrays become {b64, dtype, shape}
    triples, every other key passes through (the compat wire)."""
    _wait_ready(payload)
    out = {}
    for key, value in _meta_items(payload):
        if key in PAYLOAD_ARRAYS and value is not None:
            arr = _host_array(value)
            out[key] = {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
                        "dtype": _dtype_name(value),
                        "shape": list(arr.shape)}
        else:
            out[key] = value
    return out


def decode_kv_payload(wire: dict) -> dict:
    """Inverse of :func:`encode_kv_payload`."""
    out = {}
    for key, value in wire.items():
        if (key in PAYLOAD_ARRAYS and isinstance(value, dict)
                and "b64" in value):
            buf = base64.b64decode(value["b64"])
            out[key] = _from_bytes(buf, str(value["dtype"]), value["shape"])
        else:
            out[key] = value
    return out


# ------------------------------------------------------------- binary form

def encode_kv_frames(payload: Dict[str, Any]) -> bytes:
    """Handoff payload -> one framed octet-stream body. Array values may be
    torch tensors (CPU or CUDA) or numpy arrays; each is copied to the host
    once and its bytes written raw into the segment area. Non-array keys
    must be JSON-serializable."""
    _wait_ready(payload)
    metas = []
    segments = []
    offset = 0
    values = {key: payload.get(key) for key in PAYLOAD_ARRAYS}
    for key in _PACKED_INT_LISTS:
        ids = payload.get(key)
        if ids is None:
            continue
        arr = np.asarray(ids)
        # narrowest lossless integer dtype: token ids are non-negative and
        # bounded by the vocabulary, so uint16 covers most models
        values[key] = arr.astype(
            np.uint16 if arr.size == 0 or (arr.min() >= 0
                                           and arr.max() < 1 << 16)
            else np.int32)
    for key in (*PAYLOAD_ARRAYS, *_PACKED_INT_LISTS):
        value = values.get(key)
        if value is None:
            continue
        arr = _host_array(value)
        data = arr.tobytes()
        pad = (-offset) % _ALIGN
        offset += pad
        metas.append({"key": key, "dtype": _dtype_name(value),
                      "shape": list(arr.shape), "off": offset,
                      "nbytes": len(data),
                      "crc32": zlib.crc32(data) & 0xFFFFFFFF})
        segments.append((pad, data))
        offset += len(data)
    header = json.dumps({
        "v": 1,
        "meta": {key: value for key, value in _meta_items(payload)
                 if key not in PAYLOAD_ARRAYS
                 and not (key in _PACKED_INT_LISTS
                          and values.get(key) is not None)},
        "arrays": metas,
        "data_bytes": offset,
    }).encode("utf-8")
    parts = [_PREFIX.pack(_MAGIC, len(header)), header]
    for pad, data in segments:
        if pad:
            parts.append(b"\x00" * pad)
        parts.append(data)
    return b"".join(parts)


def is_kv_frames(body: bytes, content_type: str = "") -> bool:
    """Does ``body`` carry the binary frame? The content type wins when
    present; the magic covers clients that did not set it."""
    if content_type and content_type.split(";")[0].strip().lower() \
            == KV_FRAMES_CONTENT_TYPE:
        return True
    return bytes(body[:4]) == _MAGIC


def _read_header(body) -> tuple:
    view = memoryview(body)
    if len(view) < _PREFIX.size:
        raise KVWireError(
            f"kv frame truncated: {len(view)} bytes is shorter than the "
            f"{_PREFIX.size}-byte frame prefix")
    magic, hlen = _PREFIX.unpack_from(view, 0)
    if magic != _MAGIC:
        raise KVWireError(f"kv frame magic mismatch: {bytes(magic)!r}")
    if not 0 < hlen <= _MAX_HEADER:
        raise KVWireError(f"kv frame header length {hlen} outside bounds")
    if len(view) < _PREFIX.size + hlen:
        raise KVWireError(
            f"kv frame truncated inside the header: body holds "
            f"{len(view)} bytes, header claims {hlen}")
    try:
        header = json.loads(bytes(view[_PREFIX.size:_PREFIX.size + hlen]))
    except ValueError as exc:
        raise KVWireError(f"kv frame header is not JSON: {exc}")
    if not isinstance(header, dict) or "arrays" not in header:
        raise KVWireError("kv frame header missing its array table")
    return header, view, _PREFIX.size + hlen


def peek_kv_frames_meta(body) -> Dict[str, Any]:
    """The frame's scalar passthrough without touching (or checking) the
    segment area."""
    header, _, _ = _read_header(body)
    meta = header.get("meta")
    return dict(meta) if isinstance(meta, dict) else {}


def decode_kv_frames(body) -> Dict[str, Any]:
    """Framed body -> handoff payload dict. Array values are read-only
    torch tensors over ``body``; every segment is bounds-checked against
    the body and crc32-checked before anything is returned."""
    header, view, data_start = _read_header(body)
    data = view[data_start:]
    claimed = int(header.get("data_bytes", -1))
    if claimed != len(data):
        raise KVWireError(
            f"kv frame truncated: segment area holds {len(data)} bytes, "
            f"header claims {claimed}")
    out: Dict[str, Any] = dict(header.get("meta") or {})
    for desc in header["arrays"]:
        key = desc.get("key")
        if key not in PAYLOAD_ARRAYS and key not in _PACKED_INT_LISTS:
            raise KVWireError(f"kv frame names unknown array {key!r}")
        off, nbytes = int(desc["off"]), int(desc["nbytes"])
        if off < 0 or nbytes < 0 or off + nbytes > len(data):
            raise KVWireError(
                f"kv frame segment {key!r} [{off}:{off + nbytes}] falls "
                f"outside the {len(data)}-byte segment area")
        seg = data[off:off + nbytes]
        crc = zlib.crc32(seg) & 0xFFFFFFFF
        if crc != int(desc.get("crc32", -1)):
            raise KVWireError(
                f"kv frame segment {key!r} failed its crc32 "
                f"({crc:#010x} != {int(desc.get('crc32', -1)):#010x}) "
                f"— corrupted in transit")
        name = str(desc["dtype"])
        shape = tuple(int(s) for s in desc["shape"])
        try:
            itemsize = _itemsize(name)
        except TypeError as exc:
            raise KVWireError(f"kv frame segment {key!r}: unknown dtype "
                              f"{name!r}") from exc
        want = (int(np.prod(shape)) if shape else 1) * itemsize
        if want != nbytes:
            raise KVWireError(
                f"kv frame segment {key!r}: {nbytes} bytes cannot hold "
                f"shape {shape} of {name}")
        if key in _PACKED_INT_LISTS:
            out[key] = np.frombuffer(seg, dtype=np.dtype(name)).reshape(
                shape).tolist()
        else:
            out[key] = _from_bytes(seg, name, shape)
    return out


def transcode_to_json(body) -> dict:
    """Binary frame -> the JSON-base64 wire dict (checking the frame on the
    way: a corrupt frame is never laundered into a valid JSON body)."""
    return encode_kv_payload(decode_kv_frames(body))


def encode_for_wire(payload: Dict[str, Any], binary: bool):
    """``(body_bytes, content_type)`` in the negotiated form."""
    if binary:
        return encode_kv_frames(payload), KV_FRAMES_CONTENT_TYPE
    return (json.dumps(encode_kv_payload(payload)).encode("utf-8"),
            "application/json")
