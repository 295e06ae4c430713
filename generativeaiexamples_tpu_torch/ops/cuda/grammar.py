"""The port's constrained-decoding kernel: the allowed set of a sampling
call.

``grammar_mask(state, budget, eos_id, table, accept, dist, tok_bytes,
tok_lens)`` writes, for each constrained row of the call's R rows (state
> 0), which of the V vocabulary entries the row's byte-level DFA state
allows, into an (R, ceil(V / 32)) int32 bitmask that
``ops/cuda/sampling.py``'s ``sample_slots`` takes as ``allowed``, with the
same ``state`` as ``mask_states``. The words of an unconstrained row
(state <= 0) are not written: the sampler skips the mask on such a row.
It is the counterpart of the XLA program of the reference's
``grammar_mask`` (``generativeaiexamples_tpu/ops/sampling.py``), not of a
Pallas kernel. The kernel is CUDA C++ for ``sm_90a``
(``csrc/grammar_mask.cu``: one pass over the vocabulary for every
constrained row), built by :mod:`.build` and bound with ``ctypes``.

Its plain version is ``ops/sampling.py`` ``grammar_mask_plain`` (packed
by ``pack_mask``), which ``ops.sampling.grammar_mask`` takes for CPU
tensors; this wrapper takes CUDA tensors only, launches the kernel or
raises, and adds one to ``launch_counts()["grammar_mask"]`` a launch.

No allocation and no fill per call: the wrapper keeps, per device, one
output buffer and one scratch buffer (a launch-wide counter and a flag a
row, which every launch leaves zero), each sized for the largest call
seen, and returns a view of the output buffer. The view stays valid until
the next ``grammar_mask`` call on that device. This relies on the port's
one serving stream (ROADMAP §C "One stream"): a mask is read by the
sampler launched after it on the same stream before the next mask launch
writes the buffer. A second stream would need buffers of its own.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

TOKEN_BYTES = 16        # tok_bytes' columns (grammar.MAX_TOKEN_BYTES)

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
         + [ctypes.c_void_p] * 3)
# device -> (flat int32 output, int32 scratch of 1 + rows), grown on demand
_BUFFERS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    from generativeaiexamples_tpu_torch.ops.cuda import build
    lib = build.load("grammar_mask")
    lib.gk_grammar_mask.argtypes = _ARGS
    lib.gk_grammar_mask.restype = ctypes.c_int
    lib.gk_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.gk_empty_launch.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(state, budget, eos_id, table, accept, dist, tok_bytes, tok_lens):
    """Raise unless the arguments are what the kernel takes."""
    dev = tok_bytes.device
    if not tok_bytes.is_cuda:
        raise ValueError(f"grammar_mask takes CUDA tensors, got {dev}")
    V = tok_bytes.shape[0]
    R = state.shape[0]
    S = table.shape[0]
    want = ((state, (R,), torch.int32), (budget, (R,), torch.int32),
            (table, (S, 256), torch.int32), (accept, (S,), torch.bool),
            (dist, (S,), torch.int32),
            (tok_bytes, (V, TOKEN_BYTES), torch.uint8),
            (tok_lens, (V,), torch.int8))
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"grammar_mask: an argument of shape "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"where {shape} {dtype} contiguous on {dev} "
                             f"was expected")
    if not (R >= 1 and 0 <= eos_id < V and S * 256 < 2 ** 31
            and tok_bytes.data_ptr() % 16 == 0):
        raise ValueError(f"grammar_mask: {R} rows, EOS {eos_id} of {V} "
                         f"entries, {S} states; the kernel takes a row at "
                         f"least, an EOS id below V, fewer than 2**23 "
                         f"states and 16-byte aligned tok_bytes")


def buffers(dev: torch.device, R: int, V: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, ceil(V / 32)) int32 output view and the int32 scratch the
    next launch on ``dev`` writes, grown (the scratch zeroed) only when a
    call is larger than any before."""
    words = -(-V // 32)
    if dev.type == "cuda" and dev.index is None:   # "cuda" is "cuda:0"
        dev = torch.device(dev.type, torch.cuda.current_device())
    out, scratch = _BUFFERS.get(dev, (None, None))
    if out is None or out.numel() < R * words:
        out = torch.empty((R * words,), dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < 1 + R:
        scratch = torch.zeros((1 + R,), dtype=torch.int32, device=dev)
    _BUFFERS[dev] = (out, scratch)
    return out[:R * words].view(R, words), scratch


def grammar_mask(state: torch.Tensor, budget: torch.Tensor, eos_id: int,
                 table: torch.Tensor, accept: torch.Tensor,
                 dist: torch.Tensor, tok_bytes: torch.Tensor,
                 tok_lens: torch.Tensor) -> torch.Tensor:
    """One launch: the (R, ceil(V / 32)) int32 bitmask of the entries each
    constrained row's state allows, ``ops.sampling.grammar_mask_plain``'s
    set on those rows; an unconstrained row's words hold whatever the
    buffer held. state, budget (R,) int32; table (S, 256) int32; accept
    (S,) bool; dist (S,) int32; tok_bytes (V, 16) uint8; tok_lens (V,)
    int8, all on the card. Returns the wrapper's buffer, valid until the
    next call on the device. Raises on anything else, and on a failed
    launch."""
    _check(state, budget, eos_id, table, accept, dist, tok_bytes, tok_lens)
    R, V = state.shape[0], tok_bytes.shape[0]
    dev = tok_bytes.device
    out, scratch = buffers(dev, R, V)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = _lib().gk_grammar_mask(
        ptr(state), ptr(budget), ptr(table), ptr(accept), ptr(dist),
        ptr(tok_bytes), ptr(tok_lens), R, V, int(eos_id), ptr(out),
        ptr(scratch), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"grammar_mask kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["grammar_mask"] += 1
    return out


def empty_launch(dev: torch.device, V: int) -> None:
    """An empty kernel on ``grammar_mask``'s grid for V entries: the
    launch's fixed cost, the yardstick beside its time. Not counted."""
    rc = _lib().gk_empty_launch(V, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {rc}")
