"""Weight-only int8 quantization for serving (``EngineConfig.quant``).

Port of ``generativeaiexamples_tpu/ops/quant.py``. The scheme is the
reference's: per-channel symmetric int8 over each matmul's contraction
axis, ``s = max(max|w|, 1e-8) / 127`` per output channel (as XLA computes
it, times the f32 reciprocal of 127) and ``q =
clip(round(w / s), -127, 127)`` (round half to even, as ``jnp.round``), so
the same weights quantize to the same bits in both packages. Decode reads
every weight once a step, so int8 halves the bytes a step streams and
lets llama3-70b fit one 80 GB card.

:class:`QTensor` holds ``q`` in the port's (out, in) layout (``nn.Linear``'s)
and ``s`` as one f32 per output row; the contraction axis is the last one
for every matrix the port quantizes (the seven layer matrices, the
embedding, whose rows are gathered, and ``lm_head``). A tied unembedding
uses the embedding's QTensor as it is: its per-row scales are the head's
per-output scales, which the reference gets from ``QTensor.T``.

:func:`matmul` is the model's one matmul seam: plain tensors go through
``F.linear``, a QTensor through the W8A16 kernel
(``ops/cuda/quant.py``), which takes its plain version,
``(x @ q.to(x.dtype).T) * s.to(x.dtype)``, only for CPU tensors.
:func:`take` gathers embedding rows (a row gather, not a kernel).

Only 2-D dense matrices are quantized: an MoE block's router and expert
stacks (``ops/moe.py``), biases, norms and LoRA adapters stay in the
model dtype, as the reference keeps them; :func:`weight_bytes` counts the
kept MoE leaves at the dtype's size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops.cuda import quant as kernels

Params = Dict[str, Any]

# the seven layer matrices the reference quantizes (its _LAYER_AXES)
LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# rows of f32 a quantization step holds at once (bounds its temporaries)
_CHUNK_ELEMS = 1 << 26
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


@dataclasses.dataclass
class QTensor:
    """int8 weights ``q`` (out, in) and f32 scales ``s`` (out,)."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def numel(self) -> int:
        return self.q.numel()


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric int8 quantization of a 2-D ``w`` over its last axis (the
    contraction axis of ``F.linear``), bit-equal to the reference's
    ``quantize`` over the same axis. ``w`` is left as it was; rows are
    quantized in blocks, so the f32 temporaries stay at most
    ``_CHUNK_ELEMS`` values."""
    if w.dim() != 2:
        raise ValueError(f"quantize takes a 2-D (out, in) matrix, got "
                         f"{tuple(w.shape)}")
    out_f, in_f = w.shape
    q = torch.empty((out_f, in_f), dtype=torch.int8, device=w.device)
    s = torch.empty((out_f,), dtype=torch.float32, device=w.device)
    step = max(1, _CHUNK_ELEMS // max(1, in_f))
    for r in range(0, out_f, step):
        wf = w[r:r + step].float()
        # max|w| as max(max w, -min w): no full-size |w| temporary
        amax = torch.maximum(wf.amax(dim=1, keepdim=True),
                             wf.amin(dim=1, keepdim=True).neg())
        # XLA folds the reference's division by the constant 127 into a
        # product with its f32 reciprocal: the same here, bit for bit
        sc = amax.clamp_min(1e-8) * _INV_127.to(wf.device)
        q[r:r + step] = (wf / sc).round_().clamp_(-127, 127).to(torch.int8)
        s[r:r + step] = sc[:, 0]
    return QTensor(q=q, s=s)


def dequantize(w: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (w.q.float() * w.s[:, None]).to(dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``F.linear(x, w)`` for plain (out, in) weights and QTensors alike.
    A QTensor goes through the W8A16 kernel on CUDA tensors and its plain
    version on CPU tensors."""
    if isinstance(w, QTensor):
        return kernels.w8a16_gemm(x, w.q, w.s)
    return F.linear(x, w)


def take(w, indices: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding rows ``indices`` of a plain table or a QTensor (its per-row
    scales gathered beside the rows), in ``dtype``."""
    idx = indices.long()
    if isinstance(w, QTensor):
        return w.q[idx].to(dtype) * w.s[idx].to(dtype)[..., None]
    return w[idx].to(dtype)


def quantize_params(params: Params, donate: bool = False) -> Params:
    """Quantize a llama parameter dict's matrices: the seven layer matrices
    of every layer, ``embed`` (per row) and ``lm_head`` (per output
    channel); norms stay in the model dtype, and a leaf that is already a
    QTensor, or not a 2-D tensor, is left as it is. One leaf is quantized
    at a time. ``donate=True`` (the engine's load path) writes each QTensor
    into the given dicts in place of its source, so the source is freed as
    its int8 copy lands and the caller's dict is the quantized one; else
    the result is a new dict and ``params`` is untouched."""
    def q(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
            return quantize(leaf)
        return leaf

    out = params if donate else dict(params)
    layers = out["layers"] if donate else [dict(l) for l in params["layers"]]
    for layer in layers:
        for name in LAYER_MATRICES:
            if name in layer:
                layer[name] = q(layer[name])
    out["layers"] = layers
    out["embed"] = q(out["embed"])
    if "lm_head" in out:
        out["lm_head"] = q(out["lm_head"])
    return out


def n_params(params: Params) -> int:
    """Parameters of the model, each int8 weight counted once (its scales
    are not parameters): the count before quantization."""
    def count(leaf) -> int:
        if isinstance(leaf, (QTensor, torch.Tensor)):
            return leaf.numel()
        if isinstance(leaf, dict):
            return sum(count(v) for v in leaf.values())
        if isinstance(leaf, (list, tuple)):
            return sum(count(v) for v in leaf)
        return 0
    return count(params)


MOE_LEAVES = ("w_router", "w_gate", "w_up", "w_down")


def n_kept(params: Params) -> int:
    """Parameters int8 serving keeps in the model dtype among the
    matrices: an MoE block's router and expert stacks (0 for a dense
    model)."""
    return sum(layer[n].numel() for layer in params["layers"]
               for n in MOE_LEAVES
               if isinstance(layer.get(n), torch.Tensor)
               and (n == "w_router" or layer[n].dim() == 3))


def weight_bytes(n_params: int, quant: str, dtype_itemsize: int,
                 kept: int = 0) -> float:
    """Resident weight bytes, what one full weight read (one decode step)
    streams: one byte a parameter at int8 (the per-channel scales are
    excluded, as in the reference's ``core/perfmodel.weight_bytes``) but
    the dtype's size for the ``kept`` parameters int8 leaves alone
    (:func:`n_kept`), else the dtype's size."""
    if quant != "int8":
        return float(n_params) * int(dtype_itemsize)
    return float(n_params - kept) + float(kept) * int(dtype_itemsize)


def weights(params: Params):
    """Every matrix of the dict (QTensor or plain), layers first."""
    for layer in params["layers"]:
        for name in LAYER_MATRICES:
            if name in layer:
                yield layer[name]
    yield params["embed"]
    if "lm_head" in params:
        yield params["lm_head"]
