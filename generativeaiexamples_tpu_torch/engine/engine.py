"""Serving core: paged chunked prefill -> slot activation -> batched decode.

Port of ``EngineCore`` from ``generativeaiexamples_tpu/engine/engine.py``
for the single-card two-dispatch path: grouped chunked prefill with a fused
first-token sample and slot activation (``prefill_group``), and K decode
steps per dispatch (``decode``). PyTorch runs eagerly, so a Python loop
takes the place of ``lax.scan`` and the state is updated in place rather
than donated (CUDA graphs are later work).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request it raises. ``attention="auto"``
resolves to the hand-written kernels on CUDA and to the plain PyTorch
path on the CPU; ``"kernel"`` on the CPU raises.

``kv_quant="int8"`` serves from an int8 KV pool with per-token-per-head
scales (half the pool's bytes, so more slots fit on a card); its decode
attention is the int8 instance of the ragged paged kernel.

Not ported here: speculative decoding and the spec/width ladders, the
mixed-phase program, ``decode_multi``, grammar, LoRA, int8 weights, KV
handoff, the prefix cache, tensor parallelism (ROADMAP A1, A2, A5, A6,
A11). Their config knobs are refused in ``core/config.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine.kv_cache import PagedKVCache
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops.cuda import attention as kernels
from generativeaiexamples_tpu_torch.ops.sampling import (
    fold_seed, sample_logits_per_slot, token_logprob)

# rows of the (fields, steps, B) int32 "packed" decode output; logprob rows
# carry float32 bits (bitcast) and unpack_decode_out restores them
_PACKED_FIELDS = ("sampled", "emitted", "done", "hit_eos", "input_tokens",
                  "sampled_lp", "input_lp")
_LP_FIELDS = frozenset({"sampled_lp", "input_lp"})


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent
    CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the PyTorch engine serves on the GPU; pass "
                "device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class PrefillItem:
    """One prompt's next chunk, for a grouped prefill dispatch. ``is_last``
    items also get the fused first-token sample and slot activation."""

    chunk_ids: Any                # sequence of token ids (<= prefill_chunk)
    page_row: Any                 # (max_pages_per_slot,) int32
    slot: int
    start_pos: int
    is_last: bool = False
    generated: int = 0            # tokens produced incl. the fused one
    max_gen: int = 0
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0                 # per-request sampling seed


def unpack_decode_out(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """Split a host copy of ``out["packed"]`` back into named arrays."""
    out = {k: packed[i] for i, k in enumerate(_PACKED_FIELDS)}
    for k in _LP_FIELDS:
        out[k] = np.ascontiguousarray(out[k]).view(np.float32)
    return out


@dataclasses.dataclass
class DecodeState:
    """Fixed-capacity slot batch for continuous decoding; device tensors
    are (B,) and updated in place by the engine. The ``host_*`` arrays
    mirror what the host set at activation (which slots sample and from
    which seed), so the decode loop picks its sampling rows without a
    device sync. The TPU package's drafting ``history``, grammar state and
    adapter index are not ported (spec decoding, grammar and LoRA are
    ROADMAP A2/A5)."""

    cache: PagedKVCache
    tokens: torch.Tensor        # (B,) i32 last token per slot
    active: torch.Tensor        # (B,) bool
    generated: torch.Tensor     # (B,) i32 tokens generated so far
    max_gen: torch.Tensor       # (B,) i32 generation budget
    temperature: torch.Tensor   # (B,) f32
    top_k: torch.Tensor         # (B,) i32
    top_p: torch.Tensor         # (B,) f32
    last_logprob: torch.Tensor  # (B,) f32 model logprob of tokens[b]
    host_live: np.ndarray       # (B,) bool: activated, not yet released
    host_temperature: np.ndarray
    host_seed: np.ndarray       # (B,) int64 request seeds
    host_generated: np.ndarray  # (B,) int64, advanced once per decode step
    generators: List[Optional[torch.Generator]]


class EngineCore:
    """Owns the weights and runs the serving passes. Call from one driver
    thread (the scheduler)."""

    def __init__(self, model_cfg: llama.LlamaConfig, engine_cfg: EngineConfig,
                 params: llama.Params, eos_id: int, device=None) -> None:
        self.device = resolve_device(device)
        attn = engine_cfg.attention
        if attn == "auto":
            attn = "kernel" if self.device.type == "cuda" else "plain"
        if attn not in ("kernel", "plain"):
            raise ValueError(f"engine.attention must be auto|kernel|plain, "
                             f"got {engine_cfg.attention!r}")
        if attn == "kernel" and self.device.type != "cuda":
            raise ValueError("attention='kernel' needs a CUDA device: the "
                             "hand-written kernels have no CPU build")
        self.model_cfg = dataclasses.replace(model_cfg, attn_impl=attn)
        self.cfg = engine_cfg
        self.eos_id = eos_id
        self.batch = engine_cfg.max_batch_size
        self.max_seq = engine_cfg.max_seq_len
        self.page_size = engine_cfg.page_size
        self.chunk = engine_cfg.prefill_chunk
        if self.chunk % self.page_size:
            raise ValueError(f"prefill_chunk ({self.chunk}) must be a "
                             f"multiple of page_size ({self.page_size})")
        if self.max_seq % self.chunk:
            raise ValueError(f"max_seq_len ({self.max_seq}) must be a "
                             f"multiple of prefill_chunk ({self.chunk})")
        self.kv_dtype = str(kv_cache.pool_dtype(
            self.model_cfg, engine_cfg.kv_quant)).removeprefix("torch.")
        k = engine_cfg.decode_steps_per_dispatch
        if k < 1 or k & (k - 1):
            raise ValueError(
                f"decode_steps_per_dispatch ({k}) must be a power of two")
        self.max_pages_per_slot = -(-self.max_seq // self.page_size)
        self.num_pages = (engine_cfg.num_pages
                          or self.batch * self.max_pages_per_slot + 1)
        self.prefill_group_max = max(1, engine_cfg.prefill_group)

        # ---- kernel-support gate: a config the kernels refuse must fail
        # here, never at the first dispatch
        HD = self.model_cfg.head_dim
        if attn == "kernel":
            T = self.max_pages_per_slot * self.page_size
            if not kernels.prefill_supported(self.chunk, T, HD):
                raise ValueError(f"flash_prefill kernel does not take "
                                 f"head_dim={HD}")
            if not kernels.paged_decode_supported(self.page_size, HD):
                raise ValueError(f"ragged_paged_attention kernel does not "
                                 f"take page_size={self.page_size}, "
                                 f"head_dim={HD}")
            if (kernels.paged_decode_supported(self.page_size, HD)
                    != kernels.ragged_paged_supported(self.page_size, HD, 8)):
                raise ValueError(
                    "paged_decode_supported and ragged_paged_supported "
                    f"disagree for page_size={self.page_size}, head_dim={HD}"
                    " — kernel-support predicates have drifted")
            G = self.model_cfg.n_heads // self.model_cfg.n_kv_heads
            if G > kernels.QG_MAX:
                raise ValueError(f"GQA group {G} exceeds the ragged "
                                 f"kernel's {kernels.QG_MAX} query rows")
        self.params = params

    # ------------------------------------------------------------------ state

    @torch.no_grad()
    def init_state(self) -> DecodeState:
        B, dev = self.batch, self.device
        cache = PagedKVCache.create(self.model_cfg, B, self.num_pages,
                                    self.page_size, device=dev,
                                    kv_quant=self.cfg.kv_quant)
        z = lambda dt: torch.zeros((B,), dtype=dt, device=dev)
        return DecodeState(
            cache=cache, tokens=z(torch.int32), active=z(torch.bool),
            generated=z(torch.int32), max_gen=z(torch.int32),
            temperature=torch.ones((B,), dtype=torch.float32, device=dev),
            top_k=z(torch.int32),
            top_p=torch.ones((B,), dtype=torch.float32, device=dev),
            last_logprob=z(torch.float32),
            host_live=np.zeros((B,), np.bool_),
            host_temperature=np.zeros((B,), np.float32),
            host_seed=np.zeros((B,), np.int64),
            host_generated=np.zeros((B,), np.int64),
            generators=[None] * B)

    def new_allocator(self) -> kv_cache.PageAllocator:
        return kv_cache.PageAllocator(self.num_pages)

    def pages_for(self, n_tokens: int) -> int:
        """Pages so positions 0..n_tokens (inclusive next write) fit."""
        return n_tokens // self.page_size + 1

    def put_table(self, table: np.ndarray) -> torch.Tensor:
        """Host block table -> device."""
        return torch.as_tensor(np.asarray(table, np.int32), device=self.device)

    def _generator(self, state: DecodeState, slot: int,
                   index: int) -> torch.Generator:
        g = state.generators[slot]
        if g is None:
            g = torch.Generator(device=self.device)
            state.generators[slot] = g
        g.manual_seed(fold_seed(int(state.host_seed[slot]), index))
        return g

    # ---------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill_group(self, state: DecodeState, items: Sequence[PrefillItem]
                      ) -> Tuple[DecodeState, torch.Tensor]:
        """Up to ``prefill_group`` chunks in one pass, across distinct slots
        and/or consecutive chunks of one prompt (rows of one slot in
        ascending start_pos order). ``is_last`` rows sample their first
        token and activate their slot in the same pass. Chunks pad to a
        whole number of pages. Returns (state, (G,) sampled tokens, valid
        for is_last rows only)."""
        G = len(items)
        if not 1 <= G <= self.prefill_group_max:
            raise ValueError(f"group of {G} chunks; limit is "
                             f"{self.prefill_group_max}")
        ps = self.page_size
        longest = max(len(it.chunk_ids) for it in items)
        if longest > self.chunk:
            raise ValueError(f"chunk of {longest} tokens exceeds "
                             f"prefill_chunk ({self.chunk})")
        C = max(ps, -(-longest // ps) * ps)
        tokens = np.zeros((G, C), np.int32)
        page_rows = np.zeros((G, self.max_pages_per_slot), np.int32)
        slots = np.full((G,), self.batch, np.int32)
        start_pos = np.zeros((G,), np.int32)
        chunk_len = np.zeros((G,), np.int32)
        for i, it in enumerate(items):
            n = len(it.chunk_ids)
            tokens[i, :n] = it.chunk_ids
            page_rows[i] = it.page_row
            start_pos[i] = it.start_pos
            chunk_len[i] = n
        # lengths dedup: only a slot's newest row keeps its true id
        newest = {it.slot: i for i, it in enumerate(items)}
        for slot, i in newest.items():
            slots[i] = slot
        dev = self.device
        t = lambda a: torch.as_tensor(a, device=dev)
        logits = kv_cache.prefill_chunks(
            self.params, self.model_cfg, t(tokens), state.cache,
            t(page_rows), t(slots), t(start_pos), t(chunk_len),
            self.num_pages)
        temperature = t(np.array([it.temperature for it in items], np.float32))
        top_k = t(np.array([it.top_k for it in items], np.int32))
        top_p = t(np.array([it.top_p for it in items], np.float32))
        gens: List[Optional[torch.Generator]] = [None] * G
        for i, it in enumerate(items):
            if it.is_last:
                state.host_live[it.slot] = True
                state.host_temperature[it.slot] = it.temperature
                state.host_seed[it.slot] = it.seed
                state.host_generated[it.slot] = it.generated
                if it.temperature > 0:
                    gens[i] = self._generator(state, it.slot,
                                              it.generated - 1)
        toks = sample_logits_per_slot(gens, logits, temperature, top_k, top_p)
        lps = token_logprob(logits, toks)
        rows = [i for i, it in enumerate(items) if it.is_last]
        if rows:
            ix = t(np.array(rows, np.int64))
            sl = t(np.array([items[i].slot for i in rows], np.int64))
            gen = t(np.array([items[i].generated for i in rows], np.int32))
            mx = t(np.array([items[i].max_gen for i in rows], np.int32))
            state.tokens[sl] = toks[ix]
            state.active[sl] = (toks[ix] != self.eos_id) & (gen < mx)
            state.generated[sl] = gen
            state.max_gen[sl] = mx
            state.temperature[sl] = temperature[ix]
            state.top_k[sl] = top_k[ix]
            state.top_p[sl] = top_p[ix]
            state.last_logprob[sl] = lps[ix]
        return state, toks

    # ----------------------------------------------------------------- decode

    def _step(self, state: DecodeState, page_table: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """One decode step over every slot (``step_narrow`` there)."""
        cache = state.cache
        prev_len = cache.lengths.clone()
        logits = kv_cache.decode_step(self.params, self.model_cfg,
                                      state.tokens, cache, page_table,
                                      state.active, self.num_pages)
        active = state.active
        zero = torch.zeros((), device=self.device)
        live_temp = torch.where(active, state.temperature, zero)
        live_topk = torch.where(active, state.top_k,
                                torch.zeros_like(state.top_k))
        live_topp = torch.where(active, state.top_p, zero + 1.0)
        gens = [self._generator(state, b, int(state.host_generated[b]))
                if state.host_live[b] and state.host_temperature[b] > 0
                else None for b in range(self.batch)]
        sampled = sample_logits_per_slot(gens, logits, live_temp, live_topk,
                                         live_topp)
        lp = token_logprob(logits, sampled)
        generated = state.generated + active.to(torch.int32)
        hit_eos = sampled == self.eos_id
        done = active & (hit_eos | (generated >= state.max_gen)
                         | (cache.lengths >= self.max_seq - 1))
        # inactive slots keep their lengths, so their positions stay put
        cache.lengths.copy_(torch.where(active, cache.lengths, prev_len))
        # state.tokens/active/last_logprob are rebound below, never written
        # in place, so the step's inputs can ride out without copies
        out = {"sampled": sampled, "emitted": active, "done": done,
               "hit_eos": hit_eos, "input_tokens": state.tokens,
               "sampled_lp": lp, "input_lp": state.last_logprob}
        state.tokens = torch.where(active, sampled, state.tokens)
        state.last_logprob = torch.where(active, lp, state.last_logprob)
        state.generated = generated
        state.active = active & ~done
        state.host_generated += state.host_live
        return out

    @torch.no_grad()
    def decode(self, state: DecodeState, page_table: torch.Tensor,
               steps: int = 1) -> Tuple[DecodeState, Dict[str, Any]]:
        """Run ``steps`` decode steps over all slots; ``page_table`` from
        :meth:`put_table`. Out arrays are (steps, B); ``input_tokens``
        carries each step's input, and ``out["packed"]`` stacks every field
        as int32 (logprobs bitcast) for one device-to-host copy."""
        outs = [self._step(state, page_table) for _ in range(steps)]
        res: Dict[str, Any] = {k: torch.stack([o[k] for o in outs])
                               for k in _PACKED_FIELDS}
        res["packed"] = torch.stack([
            res[k].view(torch.int32) if k in _LP_FIELDS
            else res[k].to(torch.int32) for k in _PACKED_FIELDS])
        return state, res

    @torch.no_grad()
    def activate(self, state: DecodeState, slot: int, token: int,
                 generated: int, max_gen: int, temperature: float, top_k: int,
                 top_p: float, seed: int = 0) -> DecodeState:
        """Start decoding a prefilled slot (lengths set by its last chunk;
        ``generated`` counts tokens already produced, >= 1)."""
        state.tokens[slot] = token
        state.active[slot] = True
        state.generated[slot] = generated
        state.max_gen[slot] = max_gen
        state.temperature[slot] = temperature
        state.top_k[slot] = top_k
        state.top_p[slot] = top_p
        state.last_logprob[slot] = 0.0
        state.host_live[slot] = True
        state.host_temperature[slot] = temperature
        state.host_seed[slot] = seed
        state.host_generated[slot] = generated
        return state

    @torch.no_grad()
    def release(self, state: DecodeState, slot: int) -> DecodeState:
        """Deactivate a slot; its pages may be reused at once (its later
        decode writes go to the null page)."""
        state.active[slot] = False
        state.host_live[slot] = False
        return state

