"""Top-k mixture-of-experts MLP with per-expert capacity (plain PyTorch).

Port of ``generativeaiexamples_tpu/ops/moe.py`` (GShard/Switch routing).
Shapes: N = tokens, E experts, k choices a token, C slots an expert, D
model width, F expert hidden width.

* Routing in f32: logits ``x @ w_router`` (N, E), a softmax, the top k
  (a stable descending sort, so that on ties the lower expert comes first,
  as ``jax.lax.top_k`` gives it; ``torch.topk`` promises no order on
  CUDA), the k gates renormalized by ``max(sum, 1e-9)``.
* Priority: expert slots go in rank-major order (every token's first
  choice, then every token's second choice, ...) and, within a rank, in
  token order. A choice whose slot is ``>= C`` is dropped: its gate is
  zero and the residual carries the token.
* The expert products run in the activation dtype, the combine in f32,
  cast to the activation dtype at the end.
* ``aux`` is the Switch load-balance loss ``E * sum_i f_i * P_i`` over
  first choices.

The reference expresses dispatch and combine as one-hot einsums, (N, E,
C) tensors; here they are an index copy into the (E, C, D) expert inputs
(:func:`dispatch`) and a gather of each choice's output row
(:func:`combine`), which give the same numbers
(``tests/test_torch_moe.py``). The expert products (:func:`experts`) are
``torch.bmm``: there they are einsums outside any Pallas kernel. The four
stages are module functions, so a profile can name each.

The port adds one rule the reference lacks: ``valid`` (N,) marks the
tokens a pass really computes for. A token outside it (a chunk's padding,
a padding row, a dead decode slot) takes no expert slot, so padding never
displaces a real token; C stays ``capacity(N)`` over all N rows, as
there. Without drops the rule changes nothing.

Layout (the port's (out, in), as ``nn.Linear`` stores a matrix):
``w_router`` (E, D), ``w_gate`` and ``w_up`` (E, F, D), ``w_down`` (E,
D, F). ``init_moe_params`` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops.layers import glu

Params = Dict[str, Any]


def init_moe_params(generator: torch.Generator, dim: int, hidden_dim: int,
                    n_experts: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Params:
    """Router and per-expert GLU weights, each drawn normal / sqrt(fan_in)
    in f32 and cast to ``dtype``, on ``device`` (the generator's by
    default)."""
    device = torch.device(device or generator.device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    E, D, F_ = n_experts, dim, hidden_dim
    return {"w_router": normal((E, D), D),
            "w_gate": normal((E, F_, D), D),
            "w_up": normal((E, F_, D), D),
            "w_down": normal((E, D, F_), F_)}


def capacity(n_tokens: int, n_experts: int, k: int,
             capacity_factor: float) -> int:
    """Slots an expert: ``capacity_factor * k * n_tokens / n_experts``,
    plus one, rounded up to a multiple of 8, at least 8."""
    c = int(capacity_factor * k * n_tokens / n_experts) + 1
    return max(8, -(-c // 8) * 8)


@dataclass
class Routing:
    """One pass's routing: ``expert_ix``, ``slot`` (N, k) int64, ``keep``
    (N, k) bool, ``gates`` (N, k) f32 (renormalized, zero where dropped),
    ``probs`` (N, E) f32, ``capacity`` C and ``aux`` (a 0-d f32
    tensor)."""

    expert_ix: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    probs: torch.Tensor
    capacity: int
    aux: torch.Tensor


def route(x: torch.Tensor, w_router: torch.Tensor, k: int, C: int,
          valid: Optional[torch.Tensor] = None) -> Routing:
    """Route tokens x (N, D) over the experts of ``w_router`` (E, D) with
    C slots each. ``valid`` (N,) bool: tokens outside it take no slot and
    keep nothing; the aux loss is then taken over the valid tokens."""
    N = x.shape[0]
    E = w_router.shape[0]
    logits = F.linear(x.float(), w_router.float())                # (N, E)
    probs = torch.softmax(logits, dim=-1)
    vals, expert_ix = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    vals, expert_ix = vals[:, :k], expert_ix[:, :k]                # (N, k)
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    first = F.one_hot(expert_ix[:, 0], E).float()                  # (N, E)
    if valid is None:
        aux = E * (first.mean(0) * probs.mean(0)).sum()
    else:
        w = valid.float()[:, None]
        n = w.sum().clamp_min(1.0)
        aux = E * ((first * w).sum(0) / n * (probs * w).sum(0) / n).sum()
    # rank-major choices: an expert's slot counts the choices before it
    flat = expert_ix.t().reshape(-1)                               # (kN,)
    onehot = F.one_hot(flat, E)                                    # (kN, E)
    if valid is not None:
        onehot = onehot * valid.repeat(k).to(onehot.dtype)[:, None]
    before = onehot.cumsum(0) - onehot
    slot = before.gather(1, flat[:, None])[:, 0].reshape(k, N).t()
    keep = slot < C
    if valid is not None:
        keep = keep & valid[:, None]
    return Routing(expert_ix=expert_ix, slot=slot, keep=keep,
                   gates=gates * keep, probs=probs, capacity=C, aux=aux)


def dispatch(x: torch.Tensor, r: Routing
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy each kept choice's token x (N, D) into its row of the experts'
    inputs: ((E, C, D) in x's dtype, each choice's row ``dest`` (N, k)).
    A dropped choice goes to a spare row past them, which nothing reads."""
    N, D = x.shape
    k, C = r.expert_ix.shape[1], r.capacity
    E = r.probs.shape[1]
    dest = torch.where(r.keep, r.expert_ix * C + r.slot,
                       torch.full_like(r.slot, E * C))
    rows = x.new_zeros((E * C + 1, D))
    rows.index_copy_(0, dest.reshape(-1),
                     x[:, None].expand(N, k, D).reshape(N * k, D))
    return rows[:E * C].view(E, C, D), dest


def experts(params: Params, expert_in: torch.Tensor,
            hidden_act: str = "silu") -> torch.Tensor:
    """Every expert's GLU over its C rows, (E, C, D) -> (E, C, D), in the
    activation dtype."""
    dt = expert_in.dtype
    gate_h = torch.bmm(expert_in, params["w_gate"].to(dt).transpose(1, 2))
    up_h = torch.bmm(expert_in, params["w_up"].to(dt).transpose(1, 2))
    return torch.bmm(glu(gate_h, up_h, hidden_act),
                     params["w_down"].to(dt).transpose(1, 2))


def combine(expert_out: torch.Tensor, dest: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """Each token's gated sum of its choices' output rows, in f32: (N,
    D)."""
    E, C, D = expert_out.shape
    picked = torch.cat([expert_out.reshape(E * C, D),
                        expert_out.new_zeros((1, D))])[dest]      # (N, k, D)
    return (picked.float() * gates[..., None]).sum(1)


def moe_mlp(params: Params, x: torch.Tensor, k: int = 2,
            capacity_factor: float = 1.25, hidden_act: str = "silu",
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE GLU MLP over tokens x (..., D): (out (..., D) in x's dtype,
    aux). ``valid`` (...,) bool marks the tokens that take expert slots
    (all when None)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    E = params["w_router"].shape[0]
    C = capacity(xf.shape[0], E, k, capacity_factor)
    r = route(xf, params["w_router"], k, C,
              None if valid is None else valid.reshape(-1))
    expert_in, dest = dispatch(xf, r)
    out = combine(experts(params, expert_in, hidden_act), dest, r.gates)
    return out.reshape(shape).to(x.dtype), r.aux
