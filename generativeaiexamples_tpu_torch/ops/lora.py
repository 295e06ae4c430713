"""The LoRA update of the projections: the model's ``_maybe_lora`` seam.

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
dtype.

The targets that read one input share a call (:data:`LORA_GROUPS`:
wq|wk|wv, wo, w_gate|w_up, w_down). :func:`prepare` turns a resident tree
into :class:`LoraLayers`, each layer's :class:`LoraGroup` s, once (on the
card it checks the factors for the kernel then); :func:`lora_apply_group`
takes the hand-written kernel (``ops/cuda/lora.py``: one call a group, the
updates added into the ys in place) for CUDA tensors, and
:func:`lora_apply_group_plain` for CPU tensors. :func:`lora_apply` is one
target's update (the same kernel, factors checked on the spot).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from generativeaiexamples_tpu_torch.ops.cuda import lora as kernels

# the targets that read one input, in the block's order: the attention's
# input, its output projection's, the MLP's input, its down projection's
LORA_GROUPS = (("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"), ("w_down",))


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


def lora_apply_group_plain(ys: Sequence[torch.Tensor], x: torch.Tensor,
                           a_group: Sequence[torch.Tensor],
                           b_group: Sequence[torch.Tensor],
                           slots: Optional[torch.Tensor] = None
                           ) -> List[torch.Tensor]:
    """:func:`lora_apply_plain` target by target over one input x: new
    tensors, the ys left as they were."""
    return [lora_apply_plain(y, x, a, b, slots)
            for y, a, b in zip(ys, a_group, b_group)]


class LoraGroup(NamedTuple):
    """One layer's factors of the targets of a group (one rank), and their
    kernel-side form when they lie on the card (checked once)."""

    targets: Tuple[str, ...]
    a: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    kernel: Optional[kernels.ResidentGroup]


class LoraLayers(tuple):
    """A resident adapter tree layer by layer: each entry the layer's
    ``{input: [LoraGroup, ...]}``, keyed by the group's first target."""


def lora_group(targets: Sequence[str], a: Sequence[torch.Tensor],
               b: Sequence[torch.Tensor]) -> LoraGroup:
    """A group of ``targets`` with factors ``a`` and ``b`` (one each a
    target); on the card checked for the kernel here (ValueError)."""
    a, b = tuple(a), tuple(b)
    return LoraGroup(tuple(targets), a, b,
                     kernels.ResidentGroup(a, b) if a[0].is_cuda else None)


def prepare(tree: Dict[str, Dict[str, torch.Tensor]],
            n_layers: int) -> LoraLayers:
    """A tree's groups, layer by layer: leaves (L, r, in) / (L, out, r) of a
    global adapter or (L, N, r, in) / (L, N, out, r) of stacked slots. The
    targets of a group that the tree holds share a call when their rank
    is one; targets of other ranks take calls of their own."""
    layers = []
    for i in range(n_layers):
        layer: Dict[str, List[LoraGroup]] = {}
        for names in LORA_GROUPS:
            by_rank: Dict[int, List[str]] = {}
            for n in names:
                if n in tree:
                    by_rank.setdefault(tree[n]["a"].shape[-2], []).append(n)
            if by_rank:
                # keyed by the group's first target the tree holds: a
                # plain MLP's group is (w_up,), which ``llama._projs``
                # looks up by its own names
                layer[next(n for n in names if n in tree)] = [
                    lora_group(ns, [tree[n]["a"][i] for n in ns],
                               [tree[n]["b"][i] for n in ns])
                    for ns in by_rank.values()]
        layers.append(layer)
    return LoraLayers(layers)


def group_count(layers: LoraLayers) -> int:
    """Calls a layer makes (the first layer's groups)."""
    return sum(len(gs) for gs in layers[0].values()) if layers else 0


def lora_apply_group(ys: Sequence[torch.Tensor], x: torch.Tensor,
                     group: LoraGroup,
                     slots: Optional[torch.Tensor] = None
                     ) -> Sequence[torch.Tensor]:
    """:func:`lora_apply_group_plain`'s results: on CUDA tensors one call of
    the kernel, which adds into the ys in place and returns them; on CPU
    tensors the plain version."""
    if not ys[0].is_cuda:
        return lora_apply_group_plain(ys, x, group.a, group.b, slots)
    if group.kernel is None:
        raise ValueError("lora_apply_group: CUDA outputs with factors that "
                         "are not on the card")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return kernels.lora_apply_group(ys, x, group.kernel, slots)


def lora_apply(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor,
               slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`lora_apply_plain`'s result for one target: on CUDA tensors one
    call of the kernel, which adds into ``y`` in place and returns it; on
    CPU tensors the plain version."""
    if not y.is_cuda:
        return lora_apply_plain(y, x, a, b, slots)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return kernels.lora_apply(y, x, a, b, slots)
