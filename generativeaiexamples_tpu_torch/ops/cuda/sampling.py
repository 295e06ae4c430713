"""The port's sampling kernel: one launch a sampling call.

``sample_slots(keys, counter0, W, logits, temperature, top_k, top_p,
active)`` computes, for every row (b, w) of a step's (B * W, V) logits,
the token the reference's ``sample_logits_per_slot`` draws under the key
``fold_in(keys[b], counter0[b] + w)`` with slot b's live settings
(temperature, top-k and top-p by bisected cutoffs; an inactive slot
greedy), and that token's ``token_logprob``. It is the counterpart of the
XLA program of the reference's sampler
(``generativeaiexamples_tpu/ops/sampling.py``), not of a Pallas kernel.
The kernel is CUDA C++ for ``sm_90a`` (``csrc/sample_slots.cu``: what
bounds it and what its design does about that are written there), built
by :mod:`.build` and bound with ``ctypes``.

Its plain version is ``ops/sampling.py`` ``sample_slots_plain``, which
``ops.sampling.sample_slots`` takes for CPU tensors; this wrapper takes
CUDA tensors only, launches the kernel or raises, and adds one to
``launch_counts()["sample_slots"]`` a launch. ``sample_cutoffs`` is the
same kernel with each row's ``(thr_k, thr_p, cut)`` written out: the check
of the bisection, not a serving path, and not counted.

Three options ride the same launch, each off (a null pointer) on the
common path: ``allowed``, the
``grammar_mask`` bitmask (masked entries leave the draw, the greedy
argmax and the cutoffs), with ``mask_states``, the rows' grammar states
the mask was made from: a row whose state is <= 0 skips the mask and
never reads its words, which ``grammar_mask`` leaves unwritten;
``grammar``, the DFA advance of each active, constrained slot over the
token it drew at w = 0; ``want_top``, the
``TOP_LP`` largest raw entries of each row and their logprobs. Launches by
variant are counted in ``build.sampler_launches_by_variant()``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from generativeaiexamples_tpu_torch.ops import threefry
from generativeaiexamples_tpu_torch.ops.cuda.build import (LAUNCHES,
                                                           SAMPLER_VARIANTS)

MAX_ROWS = 136          # 8 slots x W = 9 (72), or the mixed dispatch's 136
MAX_VOCAB = 256_000     # Gemma's vocabulary (llama3's is 128,256)
CLUSTER = 8             # blocks a row's cluster holds (csrc CL)
TOP_LP = 5              # top-logprob entries a row (csrc TOP)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
         + [ctypes.c_void_p] * 14 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
_BITS_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 2)


def slice_entries(vocab: int) -> int:
    """Entries of a row each block of its cluster holds (the source's
    ``slice_of``): a multiple of 8 (16-byte loads of bf16), together
    covering the row."""
    return (-(-vocab // CLUSTER) + 7) // 8 * 8


def _fn(name: str, argtypes):
    from generativeaiexamples_tpu_torch.ops.cuda import build
    f = getattr(build.load("sample_slots"), name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_size(R: int, V: int, W: int) -> None:
    """Raise unless ``R`` rows of ``V`` entries in slots of ``W`` rows are
    a call the kernel takes."""
    if not (W >= 1 and R % W == 0 and 1 <= R <= MAX_ROWS
            and 1 <= V <= MAX_VOCAB):
        raise ValueError(f"sample_slots: {R} rows of {V} in slots of {W} "
                         f"rows; the kernel takes 1..{MAX_ROWS} rows of at "
                         f"most {MAX_VOCAB}")


def _check(keys, counter0, W, logits, temperature, top_k, top_p, active):
    """Raise unless the arguments are what the kernel takes."""
    if logits.dim() != 2 or not logits.is_cuda:
        raise ValueError(f"sample_slots takes (R, V) CUDA logits, got "
                         f"{tuple(logits.shape)} on {logits.device}")
    R, V = logits.shape
    if (logits.dtype not in _DTYPES or logits.stride(1) != 1
            or logits.stride(0) < V):
        raise ValueError(f"sample_slots takes float32 or bfloat16 logits "
                         f"with contiguous entries, got {logits.dtype} "
                         f"strides {logits.stride()}")
    check_size(R, V, W)
    B = R // W
    want = ((keys, (B, 2), (torch.int64,)),
            (counter0, (B,), (torch.int32, torch.int64)),
            (temperature, (B,), (torch.float32,)),
            (top_k, (B,), (torch.int32,)),
            (top_p, (B,), (torch.float32,)),
            (active, (B,), (torch.bool,)))
    for t, shape, dtypes in want:
        if (tuple(t.shape) != shape or t.dtype not in dtypes
                or t.device != logits.device or not t.is_contiguous()):
            raise ValueError(f"sample_slots: an argument of shape "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"where {shape} {dtypes} contiguous on "
                             f"{logits.device} was expected")


def _check_options(logits, B, allowed, grammar, mask_states):
    """Raise unless the options are what the kernel takes."""
    R, V = logits.shape
    dev = logits.device
    want = []
    if allowed is not None:
        want.append((allowed, (R, -(-V // 32)), torch.int32))
    if (allowed is None) != (mask_states is None):
        raise ValueError("sample_slots: allowed and mask_states come "
                         "together")
    if mask_states is not None:
        want.append((mask_states, (R,), torch.int32))
    if grammar is not None:
        state, table, tok_bytes, tok_lens = grammar
        want += [(state, (B,), torch.int32),
                 (table, (table.shape[0], 256), torch.int32),
                 (tok_bytes, (tok_bytes.shape[0], tok_bytes.shape[1]),
                  torch.int32), (tok_lens, (tok_bytes.shape[0],),
                                 torch.int32)]
        if tok_bytes.shape[0] < V:
            raise ValueError(f"sample_slots: tok_bytes covers "
                             f"{tok_bytes.shape[0]} entries of {V}")
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"sample_slots: an option of shape "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"where {shape} {dtype} contiguous on {dev} "
                             f"was expected")


def _launch(keys, counter0, W, logits, temperature, top_k, top_p, active,
            cutoffs=None, allowed=None, grammar=None, want_top=False,
            mask_states=None):
    _check(keys, counter0, W, logits, temperature, top_k, top_p, active)
    R, V = logits.shape
    dev = logits.device
    tokens = torch.empty((R,), dtype=torch.int32, device=dev)
    logprobs = torch.empty((R,), dtype=torch.float32, device=dev)
    args = [_DTYPES[logits.dtype], _ptr(logits),
            logits.stride(0), R, V, W, _ptr(keys), _ptr(counter0),
            int(counter0.dtype == torch.int64), _ptr(temperature),
            _ptr(top_k), _ptr(top_p), _ptr(active), _ptr(tokens),
            _ptr(logprobs),
            ctypes.c_void_p(None if cutoffs is None else cutoffs.data_ptr())]
    _check_options(logits, R // W, allowed, grammar, mask_states)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    extra = {}
    null = ctypes.c_void_p(None)
    opt = [_ptr(t) if t is not None else null
           for t in (allowed, mask_states)]
    if grammar is not None:
        state, table, tok_bytes, tok_lens = grammar
        extra["next_state"] = torch.empty_like(state)
        opt += [_ptr(state), _ptr(extra["next_state"]), _ptr(table),
                _ptr(tok_bytes), _ptr(tok_lens), tok_bytes.shape[1]]
    else:
        opt += [null] * 5 + [0]
    if want_top:
        extra["top_ids"] = torch.empty((R, TOP_LP), dtype=torch.int32,
                                       device=dev)
        extra["top_lps"] = torch.empty((R, TOP_LP), dtype=torch.float32,
                                       device=dev)
        opt += [_ptr(extra["top_ids"]), _ptr(extra["top_lps"])]
    else:
        opt += [null, null]
    rc = _fn("gk_sample_slots", _ARGS)(*args, *opt, stream)
    if rc != 0:
        raise RuntimeError(f"sample_slots kernel launch failed: CUDA error "
                           f"{rc}")
    return tokens, logprobs, extra


def variant(allowed, grammar, want_top: bool) -> str:
    """The name a launch's options count under: "mask", "advance" and
    "top" joined by "+", or "plain"."""
    parts = [name for name, on in (("mask", allowed is not None),
                                   ("advance", grammar is not None),
                                   ("top", want_top)) if on]
    return "+".join(parts) or "plain"


def sample_slots(keys: torch.Tensor, counter0: torch.Tensor, W: int,
                 logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 active: torch.Tensor, allowed: Optional[torch.Tensor] = None,
                 grammar: Optional[Sequence[torch.Tensor]] = None,
                 want_top: bool = False, *,
                 mask_states: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One launch: (R,) int32 tokens, (R,) float32 logprobs of the
    (R = B * W, V) float32 or bfloat16 ``logits`` on the card, and the
    options' outputs. keys (B, 2) int64 raw threefry keys; counter0 (B,)
    int32 or int64; temperature, top_p (B,) float32; top_k (B,) int32;
    active (B,) bool. The options and the dict of their outputs are
    ``ops.sampling.sample_slots``'s. Raises on anything else, and on a
    failed launch."""
    tokens, logprobs, extra = _launch(keys, counter0, W, logits,
                                      temperature, top_k, top_p, active,
                                      allowed=allowed, grammar=grammar,
                                      want_top=want_top,
                                      mask_states=mask_states)
    LAUNCHES["sample_slots"] += 1
    name = variant(allowed, grammar, want_top)
    SAMPLER_VARIANTS[name] = SAMPLER_VARIANTS.get(name, 0) + 1
    return tokens, logprobs, extra


def sample_cutoffs(keys, counter0, W, logits, temperature, top_k, top_p,
                   active, allowed=None, grammar=None, want_top=False, *,
                   mask_states=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sample_slots` (with its options) plus each row's (thr_k,
    thr_p, cut) as (R, 3) float32 (NaN on greedy rows): the check of the
    kernel's bisection against ``ops.sampling.sample_cutoffs_plain``. Not
    counted."""
    cut = torch.empty((logits.shape[0], 3), dtype=torch.float32,
                      device=logits.device)
    tokens, logprobs, _ = _launch(keys, counter0, W, logits, temperature,
                                  top_k, top_p, active, cut, allowed,
                                  grammar, want_top, mask_states)
    return tokens, logprobs, cut


def threefry_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel library's threefry bits of counters 0..n-1 under each
    (R, 2) key on the card, as (R, n) int64 (uint32 values): the check of
    the generator alone against :func:`threefry.random_bits`. Not a
    serving path, and not counted."""
    if not keys.is_cuda:
        raise ValueError("threefry_bits runs the kernel library: CUDA keys")
    keys = keys.to(torch.int64).contiguous()
    R = keys.shape[0]
    out = torch.empty((R, n), dtype=torch.int32, device=keys.device)
    rc = _fn("gk_threefry_bits", _BITS_ARGS)(
        _ptr(keys), R, n, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"threefry_bits launch failed: CUDA error {rc}")
    return out.to(torch.int64) & threefry.MASK
