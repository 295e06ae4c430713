"""The port's constrained-decoding kernel: the allowed set of a sampling
call.

``grammar_mask(state, budget, eos_id, table, accept, dist, tok_bytes,
tok_lens)`` writes, for each of the call's R rows, which of the V
vocabulary entries the row's byte-level DFA state allows, as an (R,
ceil(V / 32)) int32 bitmask that ``ops/cuda/sampling.py``'s
``sample_slots`` takes as ``allowed``. It is the counterpart of the XLA
program of the reference's ``grammar_mask``
(``generativeaiexamples_tpu/ops/sampling.py``), not of a Pallas kernel.
The kernel is CUDA C++ for ``sm_90a`` (``csrc/grammar_mask.cu``), built
by :mod:`.build` and bound with ``ctypes``.

Its plain version is ``ops/sampling.py`` ``grammar_mask_plain`` (packed
by ``pack_mask``), which ``ops.sampling.grammar_mask`` takes for CPU
tensors; this wrapper takes CUDA tensors only, launches the kernel or
raises, and adds one to ``launch_counts()["grammar_mask"]`` a launch.
"""

from __future__ import annotations

import ctypes

import torch

from generativeaiexamples_tpu_torch.ops.cuda.build import LAUNCHES

TOKEN_BYTES = 16        # tok_bytes' columns (grammar.MAX_TOKEN_BYTES)

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
         + [ctypes.c_void_p] * 3)


def _fn():
    from generativeaiexamples_tpu_torch.ops.cuda import build
    f = build.load("grammar_mask").gk_grammar_mask
    f.argtypes = _ARGS
    f.restype = ctypes.c_int
    return f


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
            (tok_bytes, (V, TOKEN_BYTES), torch.int32),
            (tok_lens, (V,), torch.int32))
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"grammar_mask: an argument of shape "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"where {shape} {dtype} contiguous on {dev} "
                             f"was expected")
    if not (1 <= R <= 65535 and 0 <= eos_id < V
            and tok_bytes.data_ptr() % 16 == 0):
        raise ValueError(f"grammar_mask: {R} rows, EOS {eos_id} of {V} "
                         f"entries; the kernel takes 1..65535 rows, an EOS "
                         f"id below V and 16-byte aligned tok_bytes")


def grammar_mask(state: torch.Tensor, budget: torch.Tensor, eos_id: int,
                 table: torch.Tensor, accept: torch.Tensor,
                 dist: torch.Tensor, tok_bytes: torch.Tensor,
                 tok_lens: torch.Tensor) -> torch.Tensor:
    """One launch: the (R, ceil(V / 32)) int32 bitmask of the entries each
    row's state allows, ``ops.sampling.grammar_mask_plain``'s set. state,
    budget (R,) int32; table (S, 256) int32; accept (S,) bool; dist (S,)
    int32; tok_bytes (V, 16) int32; tok_lens (V,) int32, all on the card.
    Raises on anything else, and on a failed launch."""
    _check(state, budget, eos_id, table, accept, dist, tok_bytes, tok_lens)
    R, V = state.shape[0], tok_bytes.shape[0]
    dev = tok_bytes.device
    out = torch.empty((R, -(-V // 32)), dtype=torch.int32, device=dev)
    scratch = torch.zeros((2 * R,), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = _fn()(ptr(state), ptr(budget), ptr(table), ptr(accept), ptr(dist),
               ptr(tok_bytes), ptr(tok_lens), R, V, int(eos_id), ptr(out),
               ptr(scratch),
               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grammar_mask kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["grammar_mask"] += 1
    return out
