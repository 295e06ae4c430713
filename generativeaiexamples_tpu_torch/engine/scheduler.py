"""Continuous-batching scheduler: requests -> pages/slots -> token streams.

Port of the single-card path of ``generativeaiexamples_tpu/engine/
scheduler.py``. One driver thread owns the device; each tick it

  1. resolves every in-flight decode dispatch whose result has landed on
     the host, and every landed batched first-token fetch;
  2. admits pending requests while a slot and the prompt's KV pages are
     free: FIFO with bounded-bypass skip-ahead (while the head waits for
     pages, up to ``_BYPASS_MAX`` later jobs that fit may pass it, never
     taking the last free slot), each admission sharing the longest cached
     chain of its prompt's full pages when the prefix cache is on (a
     prompt that can never fit fails loudly);
  3. runs one grouped prefill dispatch: up to ``prefill_group`` chunks,
     oldest admission first, final chunks sampling their first token and
     activating their slot in the same pass -- unless the prompts may ride
     the decode dispatch instead (mixed-phase dispatch: while slots decode
     and at most ``prefill_group`` prompts prefill, each one's next chunk
     joins the decode forward as ragged rows). While admissions prefill
     into a batch under half full (a ramp), decode dispatches are held
     for up to ``prefill_hold_chunks`` prefill chunks per episode;
  4. issues one K-step decode dispatch over the active slots without
     waiting for it, each step W tokens wide under speculative decoding (W
     the smallest rung of the width ladder covering every slot's
     acceptance-tuned draft cap) over the smallest batch-width rung
     covering the highest live slot; its packed result copies to the host
     behind a CUDA event. At most ``pipeline_depth`` dispatches stay in
     flight; the oldest is resolved first, its accepted tokens fanned out
     to per-request queues, with stop strings matched on the host over
     the detokenized stream.

A fused first token is not read back at its prefill: it resolves from the
next decode dispatch's step-0 inputs or from a batched ``(2, B)`` snapshot
of the state's tokens and logprobs, whichever lands first.

Pages grow as decode crosses page boundaries, past the positions still in
flight; when the pool is exhausted the in-flight dispatches drain, then
the youngest request is preempted and re-queued as prompt + generated
tokens (recompute preemption), as there. With the prefix cache, a
prompt's full pages are published once the dispatch writing them was
issued (its final chunk), and a finished or preempted request's
decode-written pages too, so a resume or a follow-up turn re-admits
against them.

Logprobs and constrained decoding, as there: a request with ``logprobs``
gets ``(token, logprob, top)`` per token in ``logprob_data`` (``top``, the
``top_logprobs`` alternatives, from a dispatch that ran with the top rows;
the fused first token has none); a request with a ``grammar`` registers it
at its final chunk (``_gram_state_for``: a resume re-walks what it
emitted; requests in flight pin their grammars; a failed registration
degrades the request to unconstrained and sets ``grammar_attached``
False). A dispatch with a grammared slot or a top-logprob request runs at
the ceiling width and the full batch.

Per-request LoRA, as there: a request names a registered adapter in
``Request.adapter``; admission resolves it to its resident slot
(``EngineCore.adapter_index``) and fails an unknown name loudly, the
prefix cache's chain seed ``"{epoch}|{adapter}"`` keeps each adapter's
pages apart, and an adapter'd job never rides a mixed dispatch (the
engine turns that dispatch off while adapters are resident).

The dispatch depth and the multi-step plan, as there: with
``decode_steps_max`` a pure decode dispatch deepens past
``decode_steps_per_dispatch`` while the batch is at least half full and
every slot's remaining budget covers the deeper depth (``_steps``). With
``decode_multistep`` an eligible fleet (``_multi_plan``: no grammar, no
top logprobs, no held-back stop text, no speculative widening pending)
runs K·M steps in one ``decode_multi`` dispatch, M the largest rung whose
K·M fits every slot's remaining budget, halved under page pressure; the
host fetches its block once and replays it through the same path, where
the stop strings stay the truth. With the ladder on, no dispatch is
issued once the steps in flight cover every slot's remaining budget.

Not ported (their Request fields raise): KV handoff (ROADMAP A7); nor
spill/tier, QoS, SLO, metrics and flight planes (A6). Dispatch,
speculation, prefix-cache, admission, pipelining and fetch counters live
in ``Scheduler.stats``.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import math
import queue
import random
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.engine.engine import (
    EngineCore, HostCopy, PrefillItem, bits_to_f32, unpack_decode_out)
from generativeaiexamples_tpu_torch.engine.prefix_cache import chain_hashes
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    IncrementalDetokenizer, Tokenizer)

logger = logging.getLogger(__name__)

_STOP = object()


def _stop_scan(stops, buf: str):
    """Incremental stop-sequence matching over the detokenized stream.
    Returns (emit, hold, stopped): ``emit`` is safe to stream now, ``hold``
    a trailing fragment that could still start a stop match, ``stopped``
    whether a stop string matched (``emit`` then ends just before it)."""
    idxs = [i for i in (buf.find(s) for s in stops) if i >= 0]
    if idxs:
        return buf[:min(idxs)], "", True
    hold = 0
    for s in stops:
        for L in range(min(len(buf), len(s) - 1), 0, -1):
            if buf.endswith(s[:L]):
                hold = max(hold, L)
                break
    return buf[:len(buf) - hold], buf[len(buf) - hold:] if hold else "", False


@dataclass
class Request:
    prompt_ids: List[int]
    max_tokens: int = 128
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 1.0
    stop: List[str] = field(default_factory=list)
    seed: Optional[int] = None
    # `logprobs`/`top_logprobs` fill `logprob_data` with (token_id,
    # logprob, [(alt_id, alt_logprob)] | None) per token
    logprobs: bool = False
    top_logprobs: int = 0
    logprob_data: List[tuple] = field(default_factory=list)
    # a compiled grammar (engine/grammar.py Grammar) or None; without a
    # free grammar slot the request degrades to unconstrained.
    # grammar_prefix: output text already emitted for this generation
    # elsewhere, walked before the first constrained token;
    # grammar_spec: the (kind, payload) the grammar was built from;
    # grammar_attached: True once token-level enforcement is on, False
    # when it degraded, None before the final chunk decides
    grammar: Optional[object] = None
    grammar_prefix: str = ""
    grammar_spec: Optional[tuple] = None
    grammar_attached: Optional[bool] = None
    # a registered LoRA adapter's name ("" = the base model)
    adapter: str = ""
    # not ported yet; setting it raises
    prefill_only: bool = False
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    submitted_at: float = field(default_factory=time.perf_counter)
    admitted_at: Optional[float] = None
    prefill_start_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    prefix_hit_tokens: int = 0    # prompt tokens served from the prefix cache
    completion_tokens: int = 0
    output_ids: List[int] = field(default_factory=list)   # generated ids
    error: Optional[str] = None
    # "eos" | "stop" | "length"; None = not finished or failed
    finish_reason: Optional[str] = None

    def __post_init__(self) -> None:
        if self.prefill_only:
            raise NotImplementedError(
                "Request.prefill_only is not served by the PyTorch port yet "
                "(ROADMAP A7 (KV handoff))")


@dataclass
class _Job:
    """A request's journey: prefilling, then decoding. ``ids`` is what is
    prefilled: the prompt, plus the generated tokens after a preemption."""

    request: Request
    detok: IncrementalDetokenizer
    ids: List[int]
    slot: int = -1
    pages: List[int] = field(default_factory=list)
    prefilled: int = 0            # tokens of ids already chunked in
    total_len: int = 0            # host mirror of cache lengths[slot]
    gen_ids: List[int] = field(default_factory=list)
    admit_seq: int = 0            # admission order (preemption picks max)
    stop_buf: str = ""            # held-back text (possible stop prefix)
    stopped: bool = False
    spec_ema: float = -1.0        # trailing accepted drafts; < 0 = unset
    bypass_count: int = 0         # times passed over while heading the queue
    shared: int = 0               # tokens of ids served from the prefix cache
    page_hashes: List[bytes] = field(default_factory=list)  # chain/full page
    hashed_len: int = -1          # len(ids) the hashes were computed for
    # set when the fused final chunk has sampled this job's first token on
    # the device; resolved (and cleared) by whichever lands first, a
    # batched state.tokens fetch or the next decode dispatch's step-0
    # input_tokens
    first_pending: bool = False
    first_batched: bool = False   # included in an in-flight batched fetch
    first_inflight: bool = False  # already snapshotted into a decode dispatch
    first_epoch: int = 0          # bumps per (re-)prefill: a stale fetch of
                                  # a preempted, re-admitted job is dropped
    gram_on: bool = False         # its grammar is attached on the device
    adapter_ix: int = 0           # resident LoRA slot (0 = base model)


@dataclass
class _Dispatch:
    """A decode dispatch in flight: its result on the way to the host, the
    jobs whose first token its step-0 inputs carry, the slot map when it
    was issued (a slot freed and reused meanwhile must not get the old
    job's tokens), its positions (steps x W) and its speculative width."""

    result: HostCopy
    fresh: List[tuple]
    active_map: Dict[int, _Job]
    positions: int
    w_disp: int


class Scheduler:
    """Drives an :class:`EngineCore` from one background thread."""

    def __init__(self, core: EngineCore, tokenizer: Tokenizer) -> None:
        self.core = core
        self.tokenizer = tokenizer
        self._lock = threading.Lock()
        self._pending: Deque[_Job] = deque()
        self._prefilling: Deque[_Job] = deque()
        self._slots: Dict[int, _Job] = {}
        self._free: List[int] = list(range(core.batch))
        self._alloc = core.new_allocator()
        # prefix caching (engine/prefix_cache.py): on iff the allocator
        # shares pages; the chain seed "{epoch}|{adapter}" is the
        # reference's, so both packages hash a prompt alike
        self._caching = hasattr(self._alloc, "match")
        self._cache_seed = 0
        self._table = np.zeros((core.batch, core.max_pages_per_slot), np.int32)
        self._table_dev = None
        self._admit_counter = 0
        self._state = core.init_state()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        # speculative decoding widens each decode step to W positions per
        # slot (page growth is in positions); _spec_w is the ceiling, and
        # with an adaptive ladder each dispatch picks the smallest rung
        # covering every slot's draft cap
        self._spec_w = core.spec_width
        self._spec_widths = tuple(core.spec_widths)
        # global acceptance EMA seeding fresh slots' controllers, at
        # spec_draft / 2 so a fresh slot's cap (ceil(2 x ema)) is the
        # configured draft; wider rungs are earned by measured acceptance
        self._spec_ema_global = min(core.cfg.spec_draft,
                                    self._spec_w - 1) / 2.0
        self._decode_widths = tuple(core.decode_widths)
        # decode dispatches issued and not yet resolved, oldest first, and
        # the positions (steps x W) they will write: page growth covers
        # them. A result resolves when its copy has landed (on the CPU at
        # once), or at the backpressure point once more than
        # pipeline_depth are in flight.
        self._inflight: Deque[_Dispatch] = deque()
        self._pending_steps = 0
        self._pipeline_depth = core.cfg.pipeline_depth
        # batched first-token fetches in flight: [(HostCopy, pairs)]
        self._first_fetches: List[tuple] = []
        self._first_fetch_depth = 4
        self._holding = False      # inside a prefill-priority ramp episode
        self._hold_left = 0        # chunk budget remaining in the episode
        # counts read by chip_smoke.py and /health: dispatches, mixed
        # dispatches, widened decode steps (W > 1), accepted drafts
        # (spec_bonus_tokens) over slot-steps that emitted (spec_base_steps),
        # prompt tokens served from the prefix cache over prompt tokens
        # admitted, admissions past a page-blocked head, cached pages
        # reclaimed by allocation
        self.stats = {"prefill_dispatches": 0, "prefill_chunks": 0,
                      "decode_dispatches": 0, "decode_steps": 0,
                      "mixed_dispatches": 0, "spec_steps": 0,
                      "spec_bonus_tokens": 0, "spec_base_steps": 0,
                      "preemptions": 0, "prefix_hit_tokens": 0,
                      "prefix_prompt_tokens": 0, "admission_skips": 0,
                      "prefix_evictions": 0,
                      # ticks whose decode dispatch the ramp hold skipped;
                      # decode dispatches issued while another was in
                      # flight, and the most left in flight at the end of
                      # a tick (what /health's inflight_dispatches reads);
                      # pure decode dispatches per batch-width rung
                      "held_ticks": 0, "overlapped_dispatches": 0,
                      "inflight_peak": 0,
                      # first tokens streamed between a dispatch's steps
                      "first_mid_dispatch": 0,
                      # results copied to the host (decode blocks and
                      # first-token snapshots: the reference's
                      # engine_host_fetches_total), multi-step dispatches
                      # in all and per M rung, per-step dispatches per
                      # depth rung
                      "host_fetches": 0, "multi_dispatches": 0,
                      **{f"multi_m_{m}": 0 for m in core.multi_ms},
                      **{f"decode_depth_{k}": 0 for k in core.decode_depths},
                      **{f"decode_width_{w}": 0
                         for w in self._decode_widths}}

    # ------------------------------------------------------------------ API

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="engine-driver",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                logger.warning("driver thread still busy at stop()")
                return
        self._fail_all("scheduler stopped")

    def submit(self, request: Request) -> Request:
        """Enqueue; stream text deltas with :meth:`iter_text`."""
        if not request.prompt_ids:
            raise ValueError("empty prompt: a request needs at least one "
                             "token")
        if request.seed is None:
            request.seed = random.getrandbits(31)
        else:
            request.seed = int(request.seed) & 0x7FFFFFFF
        job = _Job(request=request,
                   detok=IncrementalDetokenizer(self.tokenizer),
                   ids=list(request.prompt_ids))
        with self._lock:
            self._pending.append(job)
        self._wake.set()
        return request

    def iter_text(self, request: Request) -> Iterator[str]:
        """Blocking iterator over the request's text deltas."""
        while True:
            item = request.out_queue.get()
            if item is _STOP:
                return
            yield item

    def generate(self, prompt_ids: Sequence[int], **kw) -> str:
        """Submit and join the full text; raises if the request failed."""
        req = Request(prompt_ids=list(prompt_ids), **kw)
        self.submit(req)
        text = "".join(self.iter_text(req))
        if req.error:
            raise RuntimeError(f"request {req.request_id} failed: {req.error}")
        return text

    def load_stats(self) -> Dict[str, object]:
        """The ``/health`` load surface: queue depths, the engine's serving
        config, the pool, and every counter of ``stats`` with the prefix
        cache's hit fraction and cached pages."""
        with self._lock:
            waiting = len(self._pending)
        prompted = self.stats["prefix_prompt_tokens"]
        return {"running": len(self._slots),
                "prefilling": len(self._prefilling), "waiting": waiting,
                "batch": self.core.batch, "kv_dtype": self.core.kv_dtype,
                "spec_widths": list(self._spec_widths),
                "decode_widths": list(self._decode_widths),
                "pipeline_depth": self._pipeline_depth,
                "inflight_dispatches": len(self._inflight),
                "mixed": self.core.mixed_supported,
                "prefix_cache": self._caching,
                "kv_pool_bytes": self._state.cache.nbytes,
                "kv_pages_free": self._alloc.available,
                "prefix_hit_frac": (round(self.stats["prefix_hit_tokens"]
                                          / prompted, 4) if prompted else 0.0),
                "prefix_cached_pages": getattr(self._alloc, "cached_pages", 0),
                **self.stats}

    # ------------------------------------------------------------- internals

    def _fail_all(self, reason: str) -> None:
        """Unblock every queued and in-flight consumer (shutdown/crash)."""
        with self._lock:
            jobs = list(self._pending)
            self._pending.clear()
        jobs += list(self._prefilling) + list(self._slots.values())
        self._prefilling.clear()
        self._slots.clear()
        self._inflight.clear()
        self._pending_steps = 0
        self._first_fetches = []
        self._holding = False
        for job in jobs:
            job.request.error = reason
            job.request.finished_at = time.perf_counter()
            job.request.out_queue.put(_STOP)
        self._alloc = self.core.new_allocator()
        self._free = list(range(self.core.batch))
        self._table[:] = 0
        self._table_dev = None

    def _release(self, job: _Job) -> None:
        """Return the job's slot and pages to the pools (its device row is
        already inactive)."""
        if job.slot >= 0:
            heapq.heappush(self._free, job.slot)
            self._table[job.slot, :] = 0
            self._table_dev = None
            job.slot = -1
        if job.pages:
            self._alloc.free(job.pages)
            job.pages = []

    def _finish(self, job: _Job) -> None:
        tail = job.detok.flush()
        req = job.request
        if job.stopped:
            pass          # text at/after the stop match is never emitted
        elif req.stop:
            emit, hold, hit = _stop_scan(req.stop, job.stop_buf + tail)
            if hit:
                req.finish_reason = "stop"
            else:
                emit += hold
            if emit:
                req.out_queue.put(emit)
        elif tail:
            req.out_queue.put(tail)
        job.stop_buf = ""
        req.finished_at = time.perf_counter()
        req.out_queue.put(_STOP)
        # decode-written pages join the prefix cache before release: a
        # follow-up turn whose prompt embeds this one re-admits against them
        self._cache_insert(job, with_generated=True)
        self._release(job)

    def _fail(self, job: _Job, reason: str) -> None:
        job.request.error = reason
        job.request.finished_at = time.perf_counter()
        job.request.out_queue.put(_STOP)

    def _table_device(self):
        if self._table_dev is None:
            self._table_dev = self.core.put_table(self._table)
        return self._table_dev

    # -- admission ----------------------------------------------------------

    _ADMIT_SCAN = 32     # pending jobs considered per admission pass
    _BYPASS_MAX = 8      # admissions allowed past a page-blocked head

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """The one page allocation of admission and decode growth; folds
        the cached pages it reclaimed into ``stats``."""
        before = getattr(self._alloc, "evictions", 0)
        pages = self._alloc.alloc(n)
        self.stats["prefix_evictions"] += (getattr(self._alloc, "evictions", 0)
                                           - before)
        return pages

    def _cap_shared(self, n: int, shared: int) -> int:
        """Largest usable prefix-cache coverage for an n-token prompt.

        Two geometry rules cap a raw match: (a) at least the final token is
        recomputed (its logits seed the first sample), so coverage stops at
        the last full page before position n - 1; (b) the chunk walk from
        ``shared`` keeps its final chunk, padded to its bucket, inside the
        block-table row. (b) is re-established by stepping coverage down a
        page at a time; at a chunk multiple it holds because max_seq is a
        multiple of the chunk."""
        ps = self.core.page_size
        chunk = self.core.chunk
        row_tokens = self.core.row_tokens
        shared = min(shared, ((n - 1) // ps) * ps)
        while shared > 0:
            start = shared
            while n - start > chunk:
                start += chunk
            bucket = next(b for b in self.core.buckets if (n - start) <= b)
            if start + bucket <= row_tokens:
                break
            shared -= ps
        return max(shared, 0)

    def _plan_admission(self, job: _Job):
        """(fresh pages needed, shared tokens, hit pages) for admitting the
        job now."""
        n = len(job.ids)
        if not self._caching:
            return self.core.pages_for(n), 0, []
        if job.hashed_len != n:
            job.page_hashes = chain_hashes(
                job.ids, self.core.page_size,
                seed=f"{self._cache_seed}|{job.request.adapter}")
            job.hashed_len = n
        hits = self._alloc.match(job.page_hashes)
        shared = self._cap_shared(n, len(hits) * self.core.page_size)
        hits = hits[: shared // self.core.page_size]
        return self.core.pages_for(n) - len(hits), shared, hits

    def _can_alloc(self, need: int, hits) -> bool:
        if self._caching:
            return self._alloc.can_serve(need, hits)
        return self._alloc.available >= need

    def _cache_insert(self, job: _Job, with_generated: bool = False) -> None:
        """Publish the job's fully written pages to the prefix cache. Call
        only once the writing dispatches were issued: at final-chunk
        dispatch for prompt pages; at finish or preemption also the
        decode-written pages (minus the last generated token, whose KV was
        never fed back)."""
        if not self._caching or job.slot < 0 or not job.pages:
            return
        ids = job.ids
        if with_generated:
            if job.prefilled < len(job.ids):
                # preempted mid-prefill: only the dispatched chunks have
                # content; pages past them are garbage
                ids = job.ids[:job.prefilled]
            else:
                ids = list(job.request.prompt_ids) + list(job.gen_ids)
                if job.gen_ids:
                    ids = ids[:-1]
                if (len(ids) // self.core.page_size
                        > len(job.ids) // self.core.page_size):
                    job.page_hashes = chain_hashes(
                        ids, self.core.page_size,
                        seed=f"{self._cache_seed}|{job.request.adapter}")
                    job.hashed_len = -1   # differs from ids: recompute later
        n_full = min(len(ids) // self.core.page_size, len(job.pages),
                     len(job.page_hashes))
        if n_full > 0:
            self._alloc.insert(job.page_hashes[:n_full], job.pages[:n_full])

    def _admit(self) -> None:
        """Move pending jobs into the prefilling set while slots and pages
        last.

        FIFO with bounded-bypass skip-ahead: the queue head is admitted the
        moment its pages are free, always first. While its pages are not
        free, a later pending job that fits may be admitted out of order
        (never taking the last free slot), so small prompts stop convoying
        behind a big one. Each bypass counts against the blocked head; past
        ``_BYPASS_MAX`` admission is strict FIFO until the head admits, so
        small prompts cannot starve a big one. A prompt that can never be
        served fails at once; a preempted resume that outgrew the cache
        ends at its current length."""
        while self._free:
            with self._lock:
                cands = list(itertools.islice(self._pending,
                                              self._ADMIT_SCAN))
            if not cands:
                return
            chosen: Optional[_Job] = None
            oversized: Optional[_Job] = None
            bad_adapter: Optional[_Job] = None
            plan = None
            head = cands[0]
            for pos, job in enumerate(cands):
                if job.request.adapter:
                    try:
                        job.adapter_ix = self.core.adapter_index(
                            job.request.adapter)
                    except KeyError:
                        bad_adapter = job
                        break
                n = len(job.ids)
                need = self.core.pages_for(n)
                # a fresh prompt's first decode writes at n (peak n + 1); a
                # resume re-feeds its last generated token (peak n)
                peak = n if job.gen_ids else n + 1
                if peak >= self.core.max_seq or need > self.core.num_pages - 1:
                    oversized = job
                    break
                need, shared, hits = self._plan_admission(job)
                if pos == 0:
                    if self._can_alloc(need, hits):
                        chosen, plan = job, (need, shared, hits)
                        break
                    if head.bypass_count >= self._BYPASS_MAX:
                        return   # the head's turn is overdue: strict FIFO
                elif len(self._free) >= 2 and self._can_alloc(need, hits):
                    chosen, plan = job, (need, shared, hits)
                    head.bypass_count += 1
                    self.stats["admission_skips"] += 1
                    break
            if bad_adapter is not None:
                # never serve base weights under a fine-tune's name
                with self._lock:
                    self._pending.remove(bad_adapter)
                self._fail(bad_adapter,
                           f"unknown adapter {bad_adapter.request.adapter!r}"
                           f"; registered: {self.core.adapter_names}")
                continue
            if oversized is not None:
                job = oversized
                with self._lock:
                    self._pending.remove(job)
                n = len(job.ids)
                if job.gen_ids:
                    job.request.finish_reason = "length"
                    self._finish(job)
                else:
                    self._fail(job, f"prompt of {n} tokens needs "
                                    f"{self.core.pages_for(n)} KV pages and "
                                    f"{n + 1} cache positions; capacity is "
                                    f"{self.core.num_pages - 1} pages / "
                                    f"{self.core.max_seq - 1} positions")
                continue
            if chosen is None:
                return   # the head waits for pages; no job behind it fits
            job = chosen
            need, shared, hits = plan
            # only this thread allocates, so the pages planned above
            # are still there: acquire the hits, then the fresh pages
            if hits:
                self._alloc.acquire(hits)
            pages = list(hits) + self._alloc_pages(need)
            with self._lock:
                self._pending.remove(job)
            slot = heapq.heappop(self._free)   # lowest id first
            job.slot, job.pages = slot, pages
            job.prefilled = job.total_len = job.shared = shared
            if job.request.admitted_at is None:
                job.request.admitted_at = time.perf_counter()
            if self._caching:
                if shared:
                    job.request.prefix_hit_tokens += shared
                    self.stats["prefix_hit_tokens"] += shared
                    if self._spec_w > 1:
                        # cache-hit chunks skip prefill, so the drafting
                        # history row is seeded here
                        self._state = self.core.seed_history(
                            self._state, slot, job.ids)
                self.stats["prefix_prompt_tokens"] += len(job.ids)
            if job.admit_seq == 0:
                # resumes keep their admission age, so youngest-first
                # preemption cannot thrash an old request
                self._admit_counter += 1
                job.admit_seq = self._admit_counter
            self._table[slot, :] = 0
            self._table[slot, :len(pages)] = pages
            self._table_dev = None
            self._prefilling.append(job)

    # -- prefill ------------------------------------------------------------

    def _prefill_step(self) -> int:
        """One grouped prefill dispatch, head job first; consecutive chunks
        of one prompt may share it. Final chunks sample their first token
        on the device; it is not read back here (``_enter_decode``).
        Returns the chunks consumed, the hold budget's unit."""
        budget = self.core.prefill_group_max
        ps, row = self.core.page_size, self.core.row_tokens
        items: List[PrefillItem] = []
        finals: List[_Job] = []
        span = top = 0    # the group's padded chunk length and latest start
        full = False
        for job in list(self._prefilling):
            if len(items) >= budget or full:
                break
            req = job.request
            start = job.prefilled
            while len(items) < budget and start < len(job.ids):
                chunk_ids = job.ids[start:start + self.core.chunk]
                # every chunk pads to the group's longest, in pages: a chunk
                # that would carry some row's span past its end (a cache-hit
                # start near the row's end beside a long chunk) waits for
                # the next dispatch
                pad = -(-len(chunk_ids) // ps) * ps
                if items and max(top, start) + max(span, pad) > row:
                    full = True
                    break
                span, top = max(span, pad), max(top, start)
                if req.prefill_start_at is None:
                    req.prefill_start_at = time.perf_counter()
                last = start + len(chunk_ids) >= len(job.ids)
                items.append(PrefillItem(
                    chunk_ids=chunk_ids, page_row=self._table[job.slot],
                    slot=job.slot, start_pos=start, is_last=last,
                    generated=len(job.gen_ids) + 1, max_gen=req.max_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p,
                    gram_state=self._gram_state_for(job) if last else 0,
                    seed=req.seed or 0, adapter_ix=job.adapter_ix))
                start += len(chunk_ids)
                if last:
                    finals.append(job)
            job.prefilled = job.total_len = start
        self._state, _ = self.core.prefill_group(self._state, items)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_chunks"] += len(items)
        for job in finals:
            self._prefilling.remove(job)
            # the prompt's pages are now write-dispatched: publish them
            self._cache_insert(job)
            self._enter_decode(job)
        return len(items)

    def _gram_state_for(self, job: _Job) -> int:
        """The flat DFA state a grammared job's fused first token samples
        under (0: unconstrained). A resume re-walks the tokens it already
        emitted. Grammars of active, prefilling and pending jobs stay
        pinned (a preempted job's client was promised enforcement). A
        failed registration (an unsupported schema, every slot pinned)
        degrades the job to unconstrained: ``grammar_attached`` False."""
        grammar = job.request.grammar
        if grammar is None:
            return 0
        job.request.grammar_attached = False
        try:
            self.core.ensure_token_bytes(self.tokenizer)
            with self._lock:
                pending = list(self._pending)
            active = {j.request.grammar.key
                      for j in (list(self._slots.values())
                                + list(self._prefilling) + pending)
                      if j.request.grammar is not None}
            prefix = job.request.grammar_prefix.encode("utf-8")
            if job.gen_ids or prefix:
                state = self.core.walk_grammar(grammar, list(job.gen_ids),
                                               active, prefix=prefix)
            else:
                state = self.core.register_grammar(grammar, active)
            job.gram_on = state > 0
            job.request.grammar_attached = job.gram_on
            return state
        except Exception as exc:
            logger.warning("constrained decoding disabled for %s: %s",
                           job.request.request_id, exc)
            job.gram_on = False
            return 0

    def _enter_decode(self, job: _Job) -> None:
        """A job's final chunk is dispatched: flag its fused first token
        for resolution and hand the slot to the decode set."""
        job.first_pending = True
        job.first_inflight = False
        job.first_batched = False
        job.first_epoch += 1
        self._slots[job.slot] = job

    def _resolve_first(self, job: _Job, first: int,
                       defer: Optional[List[tuple]] = None,
                       lp: Optional[float] = None) -> bool:
        """Emit the fused first token, from whichever lands first: a
        batched fetch (also between a dispatch's steps) or a decode
        dispatch's step-0 inputs (idempotent via ``first_pending``; True
        when this call resolved it). The device already left the slot
        inactive when it is EOS or the budget is spent. With ``defer`` (a
        dispatch is being issued) the token is stamped and streamed, and a
        first token that ends the request leaves ``(job, reason)`` in
        ``defer`` for :meth:`_end_first` once the dispatch is issued: a
        release inside a narrow-rung dispatch would be overwritten by its
        merge. ``lp`` is the token's logprob (``logprob_data``)."""
        if not job.first_pending:
            return False
        job.first_pending = False
        job.first_batched = False
        req = job.request
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        if first == self.core.eos_id:
            end = "eos"
        elif self._emit_token(job, first, lp):
            end = "stop"
        elif len(job.gen_ids) >= req.max_tokens:
            end = "length"
        else:
            return True
        if defer is None:
            self._end_first(job, end)
        else:
            defer.append((job, end))
        return True

    def _end_first(self, job: _Job, end: str) -> None:
        """Finish a job whose first token ended it: a stop string also
        deactivates the slot on the device."""
        if end == "stop":
            self._retire(job)
            return
        job.request.finish_reason = end
        self._vacate(job)
        self._finish(job)

    def _vacate(self, job: _Job) -> None:
        """A job that ended by EOS or its length leaves its slot (the
        device already left the slot inactive); a slot that served an
        adapter is released too, so its adapter returns to the base model
        and later passes make no LoRA call for it."""
        del self._slots[job.slot]
        if job.adapter_ix:
            self._state = self.core.release(self._state, job.slot)

    def _retire(self, job: _Job) -> None:
        """Stop-string end: deactivate the slot on device, then finish."""
        del self._slots[job.slot]
        self._state = self.core.release(self._state, job.slot)
        self._finish(job)

    def _emit_token(self, job: _Job, tok: int, lp: Optional[float] = None,
                    top: Optional[list] = None) -> bool:
        """Append a generated token (with its logprob and top alternatives
        for a ``logprobs`` request): detokenize, scan stop strings, stream
        the emit-safe text. True when a stop string matched."""
        job.gen_ids.append(tok)
        job.request.completion_tokens += 1
        job.request.output_ids.append(tok)
        job.total_len += 1
        req = job.request
        if req.logprobs:
            req.logprob_data.append((tok, lp, top))
        delta = job.detok.push(tok)
        if req.stop:
            emit, job.stop_buf, stopped = _stop_scan(req.stop,
                                                     job.stop_buf + delta)
            if emit:
                req.out_queue.put(emit)
            if stopped:
                job.stopped = True
                req.finish_reason = "stop"
                return True
        elif delta:
            req.out_queue.put(delta)
        return False

    # -- decode -------------------------------------------------------------

    def _grow_pages(self, steps: int, spec_w: int = 1) -> int:
        """Give every active slot pages for its next ``steps`` dispatch
        steps of ``spec_w`` positions each, past the positions already in
        flight (``_pending_steps``: the host's ``total_len`` lags them).
        Preempt the youngest request only when even one position cannot
        be covered, and only after draining every dispatch in flight,
        whose results may finish jobs and free pages. Returns the
        power-of-two step count all slots have pages for (positions a
        starved row could not cover land on the null page, and the engine
        clamps acceptance to the covered span)."""
        effective = steps
        for slot in list(self._slots):
            job = self._slots.get(slot)
            if job is None:
                continue   # finished or preempted earlier in this pass
            while self._slots.get(slot) is job:
                next_write = job.total_len + self._pending_steps
                target = min(self.core.pages_for(next_write
                                                 + steps * spec_w - 1),
                             self.core.max_pages_per_slot)
                minimum = min(self.core.pages_for(next_write),
                              self.core.max_pages_per_slot)
                if len(job.pages) >= target:
                    break
                got = self._alloc_pages(1)
                if got is not None:
                    self._table[slot, len(job.pages)] = got[0]
                    job.pages.extend(got)
                    self._table_dev = None
                    continue
                if len(job.pages) >= minimum:
                    break
                if self._inflight:
                    # the host view is up to _pending_steps stale: drain
                    # before a destructive decision, then re-evaluate
                    while self._inflight:
                        self._process_decode()
                    continue
                victim = max(list(self._prefilling) + list(self._slots.values()),
                             key=lambda j: j.admit_seq)
                self._preempt(victim)
            if self._slots.get(slot) is not job:
                continue
            if len(job.pages) < self.core.max_pages_per_slot:
                covered = (len(job.pages) * self.core.page_size
                           - job.total_len - self._pending_steps)
                effective = max(1, min(effective, covered // spec_w))
        p2 = 1
        while p2 * 2 <= effective:
            p2 *= 2
        return p2

    def _preempt(self, job: _Job) -> None:
        """Recompute preemption: free the slot and pages, re-queue the job
        at the head as prompt + generated tokens. Results still in flight
        for it are dropped by the identity checks."""
        if self._slots.get(job.slot) is job:
            del self._slots[job.slot]
        else:
            self._prefilling.remove(job)
        self._state = self.core.release(self._state, job.slot)
        # publish what the slot computed: the resume re-admits against these
        # pages instead of recomputing from token 0
        self._cache_insert(job, with_generated=True)
        self._release(job)
        job.ids = list(job.request.prompt_ids) + list(job.gen_ids)
        job.prefilled = job.total_len = 0
        job.first_pending = job.first_batched = job.first_inflight = False
        with self._lock:
            self._pending.appendleft(job)
        job.request.preemptions += 1
        self.stats["preemptions"] += 1
        logger.info("preempted request %s at %d generated tokens",
                    job.request.request_id, len(job.gen_ids))

    # EMA smoothing of the acceptance signal, and the headroom between the
    # trailing accepted-drafts mean and the offered draft: cap = ceil(
    # headroom x ema), so a slot whose drafts all land climbs the ladder;
    # below _SPEC_MIN_EMA a slot gets no drafts at all
    _SPEC_EMA_ALPHA = 0.3
    _SPEC_HEADROOM = 2.0
    _SPEC_MIN_EMA = 0.05

    def _choose_draft(self, job: _Job) -> int:
        """Acceptance-tuned draft budget for one slot: the smallest ladder
        draft covering headroom x trailing acceptance. Exact-match
        acceptance makes any cap token-identical: it tunes waste only."""
        if job.spec_ema < 0:
            job.spec_ema = self._spec_ema_global
        if job.spec_ema < self._SPEC_MIN_EMA:
            return 0
        want = math.ceil(self._SPEC_HEADROOM * job.spec_ema)
        top = self._spec_w - 1
        for w in self._spec_widths:
            if w - 1 >= want:
                return min(w - 1, top)
        return top

    def _spec_plan(self):
        """(dispatch width, (B,) per-slot draft caps) for this dispatch:
        the smallest rung covering every slot's cap; (ceiling, None) when
        the engine has no adaptive ladder."""
        if self._spec_w <= 1 or len(self._spec_widths) <= 1:
            return self._spec_w, None
        caps = np.zeros((self.core.batch,), np.int32)
        top = 0
        for slot, job in self._slots.items():
            caps[slot] = self._choose_draft(job)
            top = max(top, int(caps[slot]))
        w_disp = next((w for w in self._spec_widths if w >= 1 + top),
                      self._spec_widths[-1])
        return w_disp, caps

    def _note_acceptance(self, out: Dict[str, np.ndarray], w_disp: int,
                         active_map: Dict[int, _Job]) -> None:
        """Feed the controller and the spec counters from one dispatch:
        per widened step, a slot's accepted drafts (tokens emitted - 1)
        update its EMA and the global one."""
        if w_disp <= 1:
            return
        em = out["emitted"].reshape(-1, w_disp, out["emitted"].shape[1])
        per_step = em.sum(axis=1)                       # (steps, B)
        self.stats["spec_bonus_tokens"] += int(
            np.maximum(per_step - 1, 0).sum())
        self.stats["spec_base_steps"] += int((per_step > 0).sum())
        a = self._SPEC_EMA_ALPHA
        for slot, job in active_map.items():
            col = per_step[:, slot]
            live = col > 0
            if not live.any():
                continue
            mean = float((col[live] - 1).mean())
            if job.spec_ema < 0:
                job.spec_ema = self._spec_ema_global
            job.spec_ema = (1 - a) * job.spec_ema + a * mean
            self._spec_ema_global = ((1 - a) * self._spec_ema_global
                                     + a * mean)

    def _mixed_eligible(self, job: _Job) -> bool:
        """May this prefilling job's next chunk ride the decode dispatch?
        Not while more than a group of chunks is left: the mixed program
        moves one chunk per job a dispatch, the grouped one up to
        ``prefill_group``. Nor when the chunk starts within
        ``prefill_chunk`` of the block-table row's end (a cache hit left it
        at a page, not a chunk, boundary): the mixed program pads every
        chunk to ``prefill_chunk`` positions, which would pass the row, so
        that chunk takes the grouped path, which pads to pages. Nor an
        adapter'd job: the mixed program runs base weights only."""
        if job.adapter_ix or job.request.adapter:
            return False
        if job.prefilled + self.core.chunk > self.core.row_tokens:
            return False
        remaining = len(job.ids) - job.prefilled
        return remaining <= self.core.prefill_group_max * self.core.chunk

    def _pack_mixed_chunks(self):
        """Every prefilling job's next chunk as a PrefillItem to ride this
        decode dispatch, one per job (their slots are disjoint). Called
        after _grow_pages, whose preemption may have evicted jobs, so the
        checks run again; returns (items, [(job, is_last), ...]) or None
        (the chunks then take the grouped prefill next tick)."""
        if not self._prefilling or not self._slots or \
                not self.core.mixed_supported:
            return None
        jobs = list(self._prefilling)
        if len(jobs) > self.core.prefill_group_max or \
                not all(self._mixed_eligible(j) for j in jobs):
            return None
        items, metas = [], []
        for job in jobs:
            req = job.request
            start = job.prefilled
            chunk_ids = job.ids[start:start + self.core.chunk]
            last = start + len(chunk_ids) >= len(job.ids)
            if req.prefill_start_at is None:
                req.prefill_start_at = time.perf_counter()
            # a grammared final samples its fused first token under the
            # DFA inside the mixed dispatch, as on the grouped path
            items.append(PrefillItem(
                chunk_ids=chunk_ids, page_row=self._table[job.slot],
                slot=job.slot, start_pos=start, is_last=last,
                generated=len(job.gen_ids) + 1, max_gen=req.max_tokens,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p,
                gram_state=self._gram_state_for(job) if last else 0,
                seed=req.seed or 0, adapter_ix=job.adapter_ix))
            metas.append((job, last))
        return items, metas

    @property
    def _steps(self) -> int:
        """Decode steps of a per-step dispatch: ``decode_steps_per_dispatch``,
        deepened by powers of two up to ``decode_steps_max`` while the batch
        is at least half full and every slot's remaining budget, net of
        the positions in flight, covers the deeper depth (so deepening
        never wastes a request's last steps)."""
        base = max(1, self.core.cfg.decode_steps_per_dispatch)
        cap = self.core.cfg.decode_steps_max or base
        if cap <= base or len(self._slots) < self.core.batch // 2:
            return base
        rem = (min(j.request.max_tokens - len(j.gen_ids)
                   for j in self._slots.values())
               - self._pending_steps) // self._spec_w
        steps = base
        while steps * 2 <= min(cap, rem):
            steps *= 2
        return steps

    def _multi_plan(self) -> int:
        """M of this dispatch (0: the per-step path). A fleet is eligible
        when the core has a multi-step ladder and every live slot is plain
        steady-state decode: no grammar, no top logprobs, no held-back
        stop text (a stop is near: the per-step path ends it), and no
        speculative widening pending (speculation off, or the adaptive
        controller gives every slot no drafts). The largest rung whose K·M
        fits every slot's remaining budget, net of the positions in
        flight, is taken."""
        ms = self.core.multi_ms
        if not ms or not self._slots:
            return 0
        for j in self._slots.values():
            if j.gram_on or j.stop_buf:
                return 0
            if j.request.logprobs and j.request.top_logprobs > 0:
                return 0
        if self._spec_w > 1:
            if len(self._spec_widths) <= 1:
                return 0   # a static width always widens
            if any(self._choose_draft(j) > 0 for j in self._slots.values()):
                return 0
        base = max(1, self.core.cfg.decode_steps_per_dispatch)
        rem = min(j.request.max_tokens - len(j.gen_ids)
                  for j in self._slots.values()) - self._pending_steps
        m = 0
        for rung in ms:
            if base * rung <= max(rem, 0):
                m = rung
        return m

    def _decode_width(self) -> int:
        """Batch-width rung of a pure decode dispatch: the smallest one
        covering the highest live slot (slots are allocated lowest id
        first, so the live set compacts). Mixed dispatches keep the full
        width."""
        if len(self._decode_widths) <= 1 or not self._slots:
            return self.core.batch
        hi = max(self._slots) + 1
        return next(w for w in self._decode_widths if w >= hi)

    def _dispatch_decode(self, try_mixed: bool = False) -> None:
        """Issue one K-step decode dispatch (with the prefilling jobs' next
        chunks fused in when ``try_mixed``) without waiting for it: its
        packed result starts its copy to the host and the dispatch joins
        the in-flight queue. Jobs whose first token is pending are
        snapshotted with it, so their first token resolves from its step-0
        inputs."""
        w_plan, _ = self._spec_plan()
        if not try_mixed and self._slots and self.core.multi_ms:
            # the tail kill: once the steps in flight cover every live
            # slot's remaining budget, another dispatch could only make
            # rows the host drops (a preemption voids them and dispatch
            # resumes); only with the ladder on, so the cadence with the
            # feature off is unchanged
            if (max(j.request.max_tokens - len(j.gen_ids)
                    for j in self._slots.values()) <= self._pending_steps):
                return
        multi_m = 0 if try_mixed else self._multi_plan()
        if multi_m:
            # page pressure halves M until the grown horizon covers the
            # block; below 2 the dispatch is an ordinary per-step one
            base = max(1, self.core.cfg.decode_steps_per_dispatch)
            grown = self._grow_pages(base * multi_m, 1)
            while multi_m >= 2 and base * multi_m > grown:
                multi_m //= 2
            if multi_m < 2:
                multi_m = 0
            steps = base if multi_m else self._grow_pages(self._steps,
                                                          w_plan)
        else:
            steps = self._grow_pages(self._steps, w_plan)
        if not self._slots:
            return
        packed = self._pack_mixed_chunks() if try_mixed else None
        fresh = [(s, j) for s, j in self._slots.items()
                 if j.first_pending and not j.first_inflight]
        for _, j in fresh:
            j.first_inflight = True   # only the first dispatch resolves it
        # re-planned after _grow_pages: preemption only removes slots, so
        # the rung never widens past the grown horizon
        w_disp, caps = self._spec_plan()
        use_grammar = any(j.gram_on for j in self._slots.values())
        want_top = any(j.request.logprobs and j.request.top_logprobs > 0
                       for j in self._slots.values())
        active_map = dict(self._slots)
        table = self._table_device()
        # first tokens whose batched fetch lands while the dispatch is being
        # issued stream at once; the finishes they cause wait for its end
        ended: List[tuple] = []

        def between_steps() -> None:
            self._resolve_first_fetches(ended)
        if packed is not None:
            # mixed dispatches run the ceiling width, uncapped, over the
            # full batch: the ragged kernel pads every decode row to
            # q_block whatever W is
            items, metas = packed
            w_disp = self._spec_w
            for it, (job, _) in zip(items, metas):
                job.prefilled = job.total_len = (it.start_pos
                                                 + len(it.chunk_ids))
            self._state, out = self.core.decode_mixed(
                self._state, table, steps, items, use_grammar, want_top,
                between_steps=between_steps)
            self.stats["mixed_dispatches"] += 1
            self.stats["prefill_chunks"] += len(items)
        elif multi_m:
            # K·M plain steps at width 1 over the full batch, one block to
            # fetch. The union of the live stop strings builds the suspect
            # table, and has_stop marks the slots it may pause; the host
            # replay below stays the stop truth
            w_disp = 1
            stop_set = sorted({s for j in self._slots.values()
                               for s in j.request.stop})
            has_stop = np.zeros((self.core.batch,), np.bool_)
            for slot, j in self._slots.items():
                if j.request.stop:
                    has_stop[slot] = True
            if stop_set:
                self.core.ensure_token_bytes(self.tokenizer)
            self._state, out = self.core.decode_multi(
                self._state, table, steps, multi_m, stops=tuple(stop_set),
                has_stop=has_stop, between_steps=between_steps)
            self.stats["multi_dispatches"] += 1
            self.stats[f"multi_m_{multi_m}"] += 1
            self.stats[f"decode_width_{self.core.batch}"] += 1
            steps *= multi_m
        else:
            if use_grammar or want_top:
                # these variants run at the ceiling width and the full
                # batch, as the reference pins them
                w_disp, caps = self._spec_w, None
                width = self.core.batch
            else:
                width = self._decode_width()
            kw = ({"between_steps": between_steps} if caps is None
                  else {"spec_width": w_disp, "draft_cap": caps,
                        "between_steps": between_steps})
            if width != self.core.batch:
                kw["width"] = width
            self._state, out = self.core.decode(
                self._state, table, steps, use_grammar, want_top, **kw)
            self.stats[f"decode_width_{width}"] += 1
        if not multi_m:
            key = f"decode_depth_{steps}"
            self.stats[key] = self.stats.get(key, 0) + 1
        if self._inflight:
            self.stats["overlapped_dispatches"] += 1
        self._inflight.append(_Dispatch(HostCopy(out["packed"]), fresh,
                                        active_map, steps * w_disp, w_disp))
        self._pending_steps += steps * w_disp
        self.stats["host_fetches"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += steps
        if w_disp > 1:
            self.stats["spec_steps"] += steps
        if packed is not None:
            # the finished prompts activated on the device at the end of the
            # dispatch: they join the decode set after its snapshot, and
            # their first tokens resolve from a later one (or a fetch)
            for job, last in metas:
                if last:
                    self._prefilling.remove(job)
                    self._cache_insert(job)
                    self._enter_decode(job)
        for job, end in ended:
            self._end_first(job, end)

    def _process_decode(self) -> None:
        """Resolve the oldest dispatch in flight (waiting for its copy if
        it is still running) and fan out its (steps*W, width) micro-rows:
        first tokens of the jobs it snapshotted, then up to W accepted
        tokens per slot a step."""
        entry = self._inflight.popleft()
        self._pending_steps -= entry.positions
        out = unpack_decode_out(entry.result.result())
        self._note_acceptance(out, entry.w_disp, entry.active_map)
        for slot, job in entry.fresh:
            if self._slots.get(slot) is job:
                self._resolve_first(job, int(out["input_tokens"][0, slot]),
                                    lp=float(out["input_lp"][0, slot]))
        for slot, job in entry.active_map.items():
            if self._slots.get(slot) is not job:
                continue   # finished or preempted since this dispatch
            req = job.request
            n_top = (min(req.top_logprobs, len(out.get("top_ids", ())))
                     if req.logprobs else 0)
            for k in range(out["sampled"].shape[0]):
                if not out["emitted"][k, slot]:
                    continue
                if not (out["done"][k, slot] and out["hit_eos"][k, slot]):
                    lp = (float(out["sampled_lp"][k, slot])
                          if req.logprobs else None)
                    top = ([(int(out["top_ids"][j, k, slot]),
                             float(out["top_lps"][j, k, slot]))
                            for j in range(n_top)] if n_top else None)
                    if self._emit_token(job, int(out["sampled"][k, slot]),
                                        lp, top):
                        self._retire(job)
                        break
                if out["done"][k, slot]:
                    req.finish_reason = ("eos" if out["hit_eos"][k, slot]
                                         else "length")
                    self._vacate(job)
                    self._finish(job)
                    break

    def _fetch_first_tokens(self, hold: bool) -> None:
        """Batched first-token fetch: one (2, B) snapshot of the state's
        tokens and logprob bits covers every job activated since the last
        one and not yet snapshotted into a decode dispatch. Only while
        decode is held or at most one dispatch is in flight (deeper, the
        next dispatch's result carries them as soon)."""
        waiting = [(j.slot, j, j.first_epoch) for j in self._slots.values()
                   if j.first_pending and not j.first_inflight
                   and not j.first_batched]
        if not (waiting and (hold or len(self._inflight) <= 1)
                and len(self._first_fetches) < self._first_fetch_depth):
            return
        for _, j, _e in waiting:
            j.first_batched = True
        self._first_fetches.append((self.core.snapshot_tokens(self._state),
                                    waiting))
        self.stats["host_fetches"] += 1

    def _resolve_first_fetches(self, defer: Optional[List[tuple]] = None
                               ) -> bool:
        """Resolve the first tokens of every batched fetch that has landed
        (never waits); True when one had. ``defer`` as in
        :meth:`_resolve_first`, and each first token resolved so counts in
        ``stats["first_mid_dispatch"]``."""
        landed = [ff for ff in self._first_fetches if ff[0].done()]
        if not landed:
            return False
        self._first_fetches = [ff for ff in self._first_fetches
                               if all(ff is not x for x in landed)]
        for fetch, pairs in landed:
            snap = fetch.result()
            for slot, job, epoch in pairs:
                # identity and epoch: the job may have been preempted and
                # re-admitted into the same slot since the snapshot
                if (self._slots.get(slot) is job and job.first_epoch == epoch
                        and self._resolve_first(job, int(snap[0, slot]),
                                                defer,
                                                bits_to_f32(snap[1, slot]))
                        and defer is not None):
                    self.stats["first_mid_dispatch"] += 1
        return True

    # -- driver loop --------------------------------------------------------

    def _tick(self) -> bool:
        """One scheduling round; False when fully idle."""
        worked = False
        # results that already landed resolve now: first tokens stamp and
        # done slots free without waiting for the backpressure point
        while self._inflight and self._inflight[0].result.done():
            self._process_decode()
            worked = True
        worked |= self._resolve_first_fetches()
        self._admit()
        # prefill-priority ramp: while admissions prefill into a batch under
        # half full, decode dispatches are held, for at most
        # prefill_hold_chunks chunks per episode (the held slots' first
        # tokens already rode their fused final chunks)
        ramp = (bool(self._prefilling)
                and len(self._slots) < self.core.batch // 2)
        if ramp and not self._holding:
            self._holding = True
            self._hold_left = self.core.cfg.prefill_hold_chunks
        elif not ramp:
            self._holding = False
        # while slots decode and few enough prompts prefill, each prompt's
        # next chunk rides the decode dispatch instead of stalling it; a
        # ramp that holds keeps the grouped prefill
        try_mixed = (bool(self._prefilling) and bool(self._slots)
                     and self.core.mixed_supported
                     and len(self._prefilling) <= self.core.prefill_group_max
                     and not (self._holding and self._hold_left > 0)
                     and all(self._mixed_eligible(j)
                             for j in self._prefilling))
        if self._prefilling and not try_mixed:
            consumed = self._prefill_step()
            if self._holding:
                self._hold_left -= consumed
            worked = True
        hold = (self._holding and self._hold_left > 0
                and bool(self._prefilling))
        self._fetch_first_tokens(hold)
        if self._slots and hold:
            self.stats["held_ticks"] += 1
        elif self._slots:
            self._dispatch_decode(try_mixed)
            worked = True
        # backpressure: at most pipeline_depth dispatches in flight; drain
        # fully once no slot is left to dispatch for
        while (len(self._inflight) > self._pipeline_depth
               or (self._inflight and not self._slots)):
            self._process_decode()
            worked = True
        self.stats["inflight_peak"] = max(self.stats["inflight_peak"],
                                          len(self._inflight))
        return worked

    def _loop(self) -> None:
        while self._running:
            try:
                if not self._tick():
                    if self._first_fetches:
                        # nothing else to do: wait for the oldest fetch on
                        # the device rather than a timed sleep
                        self._first_fetches[0][0].result()
                        continue
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception:
                # fail loudly but keep serving: release every consumer and
                # start from a clean device state
                logger.exception("engine driver step failed; resetting state")
                self._fail_all("engine error")
                self._state = self.core.init_state()
        self._fail_all("scheduler stopped")
