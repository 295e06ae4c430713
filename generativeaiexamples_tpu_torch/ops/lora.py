"""The LoRA update of a projection: the model's ``_maybe_lora`` seam.

Port of ``_maybe_lora`` (``generativeaiexamples_tpu/models/llama.py:
271-303``). A projection's output ``y = x @ W`` gains the low-rank update
``x @ a @ b`` (the ``alpha / r`` scale already folded into ``a`` by
``train/lora.py``), in the port's (out, in) orientation: ``a`` is (r, in)
and ``b`` (out, r), so both products read contiguous rows.

Two layouts, as there:

* a **global** adapter (one tree for every row): ``a`` (r, in), ``b``
  (out, r);
* the engine's **stacked** slots: ``a`` (N, r, in), ``b`` (N, out, r), and
  ``slots`` (B,) picks each batch row's slot; slot 0 is the base model
  (all zeros in the engine), and its rows come out bit-equal to ``y``.

Rounding is the reference's: ``z = x . a^T`` and the update ``z . b^T``
are each rounded to x's dtype (sums in f32), then added to ``y`` in that
dtype. :func:`lora_apply` takes the hand-written kernel
(``ops/cuda/lora.py``, one launch, the update added into ``y`` in place)
for CUDA tensors, and :func:`lora_apply_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch.ops.cuda import lora as kernels


def lora_apply_plain(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor,
                     slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y + round(round(x . a^T) . b^T)`` for x (B, S, in) and y (B, S,
    out): every row with a global (r, in) / (out, r) adapter, or row (i,
    j) under slot ``slots[i]`` of stacked (N, r, in) / (N, out, r)
    factors, rows of slot 0 returned as ``y`` itself. A new tensor; ``y``
    is left as it was."""
    dt = x.dtype
    if a.dim() == 2:
        z = torch.matmul(x, a.to(dt).t())
        return y + torch.matmul(z, b.to(dt).t())
    ix = slots.long()
    z = torch.matmul(x, a.to(dt)[ix].transpose(1, 2))           # (B, S, r)
    u = torch.matmul(z, b.to(dt)[ix].transpose(1, 2))           # (B, S, out)
    return torch.where((ix != 0)[:, None, None], y + u, y)


def lora_apply(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor,
               slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`lora_apply_plain`'s result: on CUDA tensors one launch of the
    kernel, which adds into ``y`` in place and returns it; on CPU tensors
    the plain version."""
    if not y.is_cuda:
        return lora_apply_plain(y, x, a, b, slots)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return kernels.lora_apply(y, x, a, b, slots)
