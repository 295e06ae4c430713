"""Deterministic fake paged core — the EngineCore stand-in the CPU tests
of the port's planes drive.

Port of ``generativeaiexamples_tpu/engine/fakecore.py`` over the port's
``PageAllocator`` and ``CachingAllocator``: the same paged semantics and
the same token function, so one seeded traffic stream through the
reference's Scheduler and the port's yields the same streams, counters,
timelines, trace records and ledger keys. The port's Scheduler reads a
few more fields of a core than the reference's (``spec_width``,
``multi_ms``, ``decode_depths``, ``row_tokens``...): they are set here to
the values that turn those features off.

Promoted out of the fuzz file verbatim (ROADMAP item 4 named it "80% of
the fleet simulator already"): a pure-numpy core with REAL paged
semantics — prefill writes token values into physical pages through the
block-table row, decode reads each slot's full context back THROUGH the
page table and emits ``f(context)``. Any scheduler bookkeeping bug (a page
freed early and reused, a stale table row, a length desync, a cross-slot
leak) corrupts a context sum and the emitted stream diverges from the
solo :func:`oracle`.

What the promotion adds — and the fuzz deliberately ignores — is
**perfmodel-costed virtual time**: every ``prefill_group``/``decode``
dispatch accrues estimated device seconds (core/perfmodel.py when a
:class:`~generativeaiexamples_tpu_torch.core.perfmodel.PerfModel` is supplied;
calibrated fallback constants otherwise) into :attr:`consumed_s`. The
simulator drains that accumulator each tick to advance its virtual clock,
so a 1000-replica what-if sweep runs in wall-seconds while the simulated
timeline carries realistic device costs. Default construction changes
NOTHING for the fuzz: costs accrue into an attribute nobody reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.engine import HostCopy
from generativeaiexamples_tpu_torch.engine.kv_cache import PageAllocator

EOS = 3
VOCAB = 260

# virtual-time fallbacks when no PerfModel is supplied (no chip peaks on
# CPU): 20 µs/prefill token,
# 4 ms per fused decode step (one full weight read). The absolute values
# only scale the simulated timeline; determinism never depends on them.
FALLBACK_PREFILL_S_PER_TOKEN = 2e-5
FALLBACK_DECODE_S_PER_STEP = 4e-3


def _next_token(context: List[int]) -> int:
    """Deterministic 'model': next token from the FULL context. EOS appears
    on a deterministic schedule so budget-exhaustion and eos paths both get
    exercised."""
    s = (sum(context) * 31 + len(context) * 7) & 0xFFFF
    if s % 13 == 0:
        return EOS
    return 32 + s % (VOCAB - 64)


def oracle(prompt: List[int], max_tokens: int, max_seq: int) -> List[int]:
    """Solo-run reference: what a correct engine must stream for a prompt.
    Generation ends at eos, the token budget, or cache capacity (the engine
    retires a slot when its context reaches max_seq - 1; the capacity-step
    token itself is still emitted, the eos token never is)."""
    ctx = list(prompt)
    out: List[int] = []
    cap = max(0, max_seq - len(prompt))          # 1 fused + (max_seq-1-n) decode
    while len(out) < min(max_tokens, cap):
        t = _next_token(ctx)
        if t == EOS:
            break
        out.append(t)
        ctx.append(t)
    return out


@dataclass
class _FakeState:
    pool: np.ndarray              # (num_pages, page_size) written token values
    lengths: np.ndarray           # (B,)
    tokens: np.ndarray            # (B,) last sampled token
    active: np.ndarray            # (B,) bool
    generated: np.ndarray         # (B,)
    max_gen: np.ndarray           # (B,)
    last_logprob: np.ndarray = None  # (B,) f32 (scheduler snapshot shape)

    @property
    def cache(self) -> SimpleNamespace:
        """The pool's footprint, as the scheduler's load surface reads a
        real state's ``cache.nbytes``."""
        return SimpleNamespace(nbytes=int(self.pool.nbytes))


class FakeCore:
    """Pure-numpy stand-in for EngineCore with REAL paged-read semantics."""

    def __init__(self, batch=4, max_seq=64, page_size=8, num_pages=0,
                 chunk=16, steps=4, steps_max=0, group=4, prefix_cache=False,
                 width_ladder=False, perf_model=None, multistep=0):
        self.batch, self.max_seq = batch, max_seq
        self.page_size, self.chunk = page_size, chunk
        self.max_pages_per_slot = -(-max_seq // page_size)
        self.num_pages = num_pages or batch * self.max_pages_per_slot + 1
        self.eos_id = EOS
        self.donates_state = False
        self.supports_long_prefill = False
        self.prefix_cache = prefix_cache
        if width_ladder and batch > 2:
            # decode batch-width ladder (engine.decode_widths): the
            # scheduler dispatches at the narrowest rung covering the
            # highest live slot, and rung transitions happen mid-stream as
            # slots fill and drain — the fuzz menu exercises exactly that
            self.decode_widths = (2, batch)
        # multi-step decode ladder (engine.multi_ms): eligible steady-state
        # dispatches run K·M steps with one deferred fetch — the fuzz menu
        # exercises mid-block finish/preempt/evacuate against the oracle
        if multistep >= 2:
            rungs, r = [], 2
            while r <= multistep:
                rungs.append(r)
                r *= 2
            self.multi_ms = tuple(rungs)
        else:
            self.multi_ms = ()
        self.cfg = SimpleNamespace(
            decode_steps_per_dispatch=steps, decode_steps_max=steps_max,
            prefill_group=group, long_prefill="off", prefill_hold_chunks=8,
            pipeline_depth=2, spec_draft=0)
        self.group_buckets = (1, 2, 4)
        # what the port's Scheduler reads beside the reference's fields:
        # speculation, mixed dispatches and adapters off, the depth ladder
        # from the base K to decode_steps_max
        self.role = "unified"
        self.kv_dtype = "int32"
        self.spec_width, self.spec_widths = 1, (1,)
        self.mixed_supported = False
        self.prefill_group_max = group
        if not hasattr(self, "decode_widths"):
            self.decode_widths = (batch,)
        depths, k = [steps], steps
        while steps_max and k * 2 <= steps_max:
            k *= 2
            depths.append(k)
        self.decode_depths = tuple(depths)
        self.adapter_names: List[str] = []
        # final-chunk bucket ladder (the prefix-cache coverage cap reads it)
        buckets, b = [], page_size
        while b < chunk:
            buckets.append(b)
            b *= 2
        buckets.append(chunk)
        self.buckets = tuple(buckets)
        # perfmodel-costed virtual time (ops/simulate.py): estimated
        # device seconds accrued by dispatches since the last take
        self.perf_model = perf_model
        self.consumed_s = 0.0
        self.dispatches = 0

    # -- virtual-time accounting (additive; the fuzz never reads it) ------

    def take_consumed(self) -> float:
        """Drain the accrued virtual device seconds (the simulator's tick
        loop advances its clock by this)."""
        s, self.consumed_s = self.consumed_s, 0.0
        return s

    def _charge_prefill(self, tokens: int) -> None:
        cost = None
        if self.perf_model is not None:
            cost = self.perf_model.prefill_seconds(tokens)
        if cost is None:
            cost = tokens * FALLBACK_PREFILL_S_PER_TOKEN
        self.consumed_s += cost
        self.dispatches += 1

    def _charge_decode(self, steps: int) -> None:
        cost = None
        pm = self.perf_model
        if pm is not None and pm.peak_bw:
            # decode is weight-read-bound: one full weight read per step
            cost = pm.weight_read_bytes(steps) / pm.peak_bw
        if cost is None:
            cost = steps * FALLBACK_DECODE_S_PER_STEP
        self.consumed_s += cost
        self.dispatches += 1

    def init_state(self) -> _FakeState:
        B = self.batch
        return _FakeState(
            pool=np.zeros((self.num_pages, self.page_size), np.int32),
            lengths=np.zeros((B,), np.int32), tokens=np.zeros((B,), np.int32),
            active=np.zeros((B,), bool), generated=np.zeros((B,), np.int32),
            max_gen=np.zeros((B,), np.int32),
            last_logprob=np.zeros((B,), np.float32))

    def new_allocator(self):
        """Caching episodes run the REAL CachingAllocator against the fake
        paged pool: a page shared wrongly (content not actually the matched
        prefix) or evicted while referenced corrupts a stream's context sum
        and diverges from the solo oracle."""
        if self.prefix_cache:
            from generativeaiexamples_tpu_torch.engine.prefix_cache import (
                CachingAllocator)
            return CachingAllocator(self.num_pages, self.page_size)
        return PageAllocator(self.num_pages)

    def pages_for(self, n: int) -> int:
        return n // self.page_size + 1

    @property
    def row_tokens(self) -> int:
        return self.max_pages_per_slot * self.page_size

    # -- the port's Scheduler surface with no fake semantics --------------

    def adapter_index(self, name: str) -> int:
        raise KeyError(name)

    def ensure_token_bytes(self, tokenizer) -> None:
        pass

    def seed_history(self, st: _FakeState, slot: int, ids) -> _FakeState:
        return st

    def snapshot_tokens(self, st: _FakeState) -> HostCopy:
        """The batched first-token fetch: (2, B) tokens and logprob bits."""
        return HostCopy(torch.from_numpy(np.stack([
            st.tokens.astype(np.int32),
            st.last_logprob.astype(np.float32).view(np.int32)])))

    def decode_bucket(self, steps: int, spec_width=None, width=None) -> str:
        """The ledger key of a decode shape, as the engine names it."""
        parts = [f"s{steps}"]
        if len(self.decode_widths) > 1:
            parts.append(f"b{width or self.batch}")
        return "".join(parts)

    def mixed_bucket(self, group: int, steps: int) -> str:
        return f"g{group}s{steps}"

    def decode_multi_bucket(self, steps: int, m: int) -> str:
        return f"s{steps}m{m}"

    def put_table(self, table: np.ndarray) -> np.ndarray:
        return np.array(table, np.int32)      # snapshot, like a device copy

    def _read_context(self, st: _FakeState, row: np.ndarray, n: int) -> List[int]:
        ps = self.page_size
        out = []
        for i in range(n):
            out.append(int(st.pool[row[i // ps], i % ps]))
        return out

    @staticmethod
    def _clone(st: _FakeState) -> _FakeState:
        """Functional update: handles the
        scheduler kept into an OLD state (the batched first-token fetch of
        state.tokens) must stay stable snapshots."""
        return _FakeState(*(a.copy() for a in (
            st.pool, st.lengths, st.tokens, st.active, st.generated,
            st.max_gen, st.last_logprob)))

    def release(self, st: _FakeState, slot: int) -> _FakeState:
        st = self._clone(st)
        st.active[slot] = False
        return st

    # -- live-migration surface (export_live_slot / spill / resume) -------
    # Mirrors EngineCore's handoff trio with REAL paged semantics: export
    # reads the slot's written token values back THROUGH its page list,
    # import scatters them into different physical pages. Any length or
    # page-math slip in the scheduler's snapshot/spill paths corrupts the
    # resumed context sum and the stream diverges from the solo oracle.

    def export_slot_kv(self, st: _FakeState, pages, length,
                       fetch: bool = False) -> dict:
        n = max(1, -(-int(length) // self.page_size))
        rows = np.zeros((n, self.page_size), np.int32)
        for i, p in enumerate(list(pages)[:n]):
            rows[i] = st.pool[p]
        return {"length": int(length), "n_pages": n,
                "page_size": self.page_size, "k": rows}

    def validate_handoff(self, payload: dict) -> None:
        if payload.get("page_size") != self.page_size:
            raise ValueError("page_size mismatch")
        n = int(payload.get("length", 0))
        if n < 1 or n + 1 >= self.max_seq:
            raise ValueError("length outside serving range")
        if "prompt_ids" in payload and len(payload["prompt_ids"]) != n:
            raise ValueError("prompt_ids/length mismatch")

    def import_slot_kv(self, st: _FakeState, slot: int, pages,
                       payload: dict) -> _FakeState:
        self.validate_handoff(payload)
        st = self._clone(st)
        n = int(payload["n_pages"])
        for i, p in enumerate(list(pages)[:n]):
            st.pool[p] = payload["k"][i]
        st.lengths[slot] = int(payload["length"])
        return st

    def import_pages_kv(self, st: _FakeState, pages, payload: dict,
                        n_pages: Optional[int] = None) -> _FakeState:
        """Partial page import — the prefix-tier promote surface
        (engine/kv_tier.py): scatter the payload's first ``n_pages`` page
        rows into freshly allocated physical pages, touching NO slot
        state. The promoted job's chunk walk starts at the covered
        boundary; any coverage/page-math slip here corrupts the read-back
        context sum and the stream diverges from the solo oracle."""
        if payload.get("page_size") != self.page_size:
            raise ValueError("page_size mismatch")
        n = int(n_pages if n_pages is not None else payload["n_pages"])
        if n < 1 or n > int(payload["n_pages"]):
            raise ValueError("n_pages outside payload coverage")
        st = self._clone(st)
        for i, p in enumerate(list(pages)[:n]):
            st.pool[p] = payload["k"][i]
        return st

    def activate(self, st: _FakeState, slot: int, token: int,
                 generated: int, max_gen: int, temperature: float,
                 top_k: int, top_p: float, seed: int = 0,
                 gram_state: int = 0) -> _FakeState:
        st = self._clone(st)
        st.tokens[slot] = int(token)
        st.active[slot] = True
        st.generated[slot] = int(generated)
        st.max_gen[slot] = int(max_gen)
        return st

    def prefill_group(self, st: _FakeState, items) -> tuple:
        self._charge_prefill(sum(len(it.chunk_ids) for it in items))
        st = self._clone(st)
        toks = np.zeros((len(items),), np.int32)
        for i, it in enumerate(items):
            ps = self.page_size
            row = np.asarray(it.page_row)
            for j, t in enumerate(it.chunk_ids):
                pos = it.start_pos + j
                st.pool[row[pos // ps], pos % ps] = t
            n = it.start_pos + len(it.chunk_ids)
            st.lengths[it.slot] = n
            if it.is_last:
                ctx = self._read_context(st, row, n)
                tok = _next_token(ctx)
                toks[i] = tok
                alive = (tok != EOS) and (it.generated < it.max_gen)
                st.tokens[it.slot] = tok
                st.active[it.slot] = alive
                st.generated[it.slot] = it.generated
                st.max_gen[it.slot] = it.max_gen
        return st, toks

    def decode(self, st: _FakeState, table: np.ndarray, steps: int = 1,
               use_grammar: bool = False, want_top: bool = False,
               width: int = 0, spec_width=None, draft_cap=None,
               between_steps=None) -> tuple:
        self._charge_decode(steps)
        st = self._clone(st)
        B, ps = (width or self.batch), self.page_size
        # a narrow batch-width rung must cover every live slot — the
        # scheduler's lowest-id-first allocation guarantees it; a slot at
        # or past the rung would silently stall here, which the episode
        # invariants catch as a livelock/diverged stream
        # 7 rows: the scheduler's unpack expects the logprob rows too
        # (they carry 0.0 bits here — the fake model has no distribution)
        out = np.zeros((7, steps, B), np.int32)
        for k in range(steps):
            for b in range(B):
                out[4, k, b] = st.tokens[b]              # input_tokens
                if not st.active[b]:
                    continue
                out[1, k, b] = 1                          # emitted
                n = int(st.lengths[b])
                # write the input token at position n (through the table,
                # like the real engine), then read the WHOLE context back
                st.pool[table[b, n // ps], n % ps] = st.tokens[b]
                st.lengths[b] = n + 1
                ctx = self._read_context(st, table[b], n + 1)
                tok = _next_token(ctx)
                out[0, k, b] = tok                        # sampled
                st.generated[b] += 1
                hit_eos = tok == EOS
                done = (hit_eos or st.generated[b] >= st.max_gen[b]
                        or st.lengths[b] >= self.max_seq - 1)
                out[2, k, b] = int(done)
                out[3, k, b] = int(hit_eos)
                if done:
                    st.active[b] = False
                else:
                    st.tokens[b] = tok
            if between_steps is not None:
                between_steps()
        # the port's Scheduler copies the packed block to the host
        # (engine.HostCopy): on the CPU a tensor, ready at once
        packed = torch.from_numpy(out.reshape(7, steps, B))
        return st, {"packed": packed, "emitted": out[1]}

    def decode_multi(self, st: _FakeState, table: np.ndarray,
                     steps: int = 1, m: int = 2, *, stops=(),
                     has_stop=None, between_steps=None) -> tuple:
        """Multi-step decode: K·M plain steps as one dispatch / one packed
        block. The fake skips the on-device stop *maybe-match* pause (no
        vocab byte table) — that flag only bounds overshoot on the real
        engine; the scheduler's host replay is the stop truth either way,
        so the emitted stream is token-identical to M per-step dispatches
        by construction (exactly what the fuzz oracle asserts)."""
        if m not in self.multi_ms:
            raise ValueError(f"multistep m {m} is not a ladder rung "
                             f"{self.multi_ms}")
        return self.decode(st, table, steps * m,
                           between_steps=between_steps)
