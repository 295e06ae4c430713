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

KV movement, as there. Disaggregated roles: a ``prefill_only`` request
runs chunked prefill and ends at its first token, whose slot's pages and
sampling state it exports into ``Request.handoff`` (``finish_reason``
"handoff"; a ``role="prefill"`` scheduler never dispatches decode); a
decode worker admits such a payload with :meth:`Scheduler.submit_prefilled`
(imported into fresh pages, activated at the payload's first token, the
grammar re-walked). Evacuation: :meth:`Scheduler.request_evacuation` queues,
for the driver thread, a snapshot of live slots (``export_live_slot``: the
pages written so far, the emitted tokens, the seed's position, the stop
holdback and the grammar spec) into an outbox that
:meth:`Scheduler.take_evacuated` serves once (``APP_EVAC_TTL_S`` expires
what is never pulled); the stream ends "evacuated", and a peer's
``submit_prefilled`` resumes it token for token. Spill: with a host budget
(``APP_KV_SPILL_MB``), a page-exhaust preemption demotes a decoding
victim's pages to host RAM and re-imports them at its re-admission, no
prefill; over budget it recomputes, as there. With ``APP_KV_TIER=prefix``
the pool is the prefix-addressed tier (``engine/kv_tier.PrefixKVTier``): a
spill contributes its prefix run under its page-chain hashes, the run stays
as priced cache after the request, and ``_plan_admission`` probes it for
every prompt; ``_admit_tier`` imports the covered pages and prefills only
the tail. ``load_stats`` carries the tier's hot-set advert and
``prefix_key_hex`` the ``X-KV-Prefix`` header's hash.

The host planes, as there: the reference's counters, gauges and
histograms go to ``core/metrics.REGISTRY`` under its names, beside
``Scheduler.stats`` (whose keys the card smoke and ``/health`` read; a
stats key with a registry counter of the same name moves with it, and
``host_fetches`` with ``engine_host_fetches_total``). A request carries
its SLO class and deadline (``slo.stamp_request`` at submission), its
tenant and its KV page-seconds; every terminal event (finish, failure,
evacuation, driver reset) judges it (``SLO.observe``), bills it
(``USAGE.bill_request``) and records its timeline (``REQUEST_LOG``)
before the stream ends. Under critical SLO pressure pending sheddable
requests are shed at admission. ``TRACE`` records admission, dispatch,
preemption, spill, promotion, migration and finish; ``DEVTIME`` keys
every dispatch (``prefill``, ``decode[+gram][+top]``, ``mixed``,
``decode_multi`` with its deferred census, ``kv_import``, ``kv_export``)
and counts every result fetch at the ``HostCopy`` seam; ``FLIGHT``
samples the scheduler's state every ``APP_FLIGHT_INTERVAL_MS``; the
chaos plane's page, spill and tick faults fire at their seams. The
driver stamps ``last_tick_mono`` every loop and each in-flight dispatch
its issue instant and steps (``_Dispatch.issued``): the engine watchdog
(``engine/watchdog.py``) reads both.

The QoS admission plane, as there (``engine/qos.py``, ``APP_QOS=off|fair``):
off, the scheduler holds no policy and makes no qos call. Fair, each
admission pass first sheds the sheddable fresh submissions whose remaining
deadline cannot cover their estimated service (``_qos_shed_unmeetable``:
no prefill runs for them), then scans the policy's order (per-tenant EDF
merged by weighted-fair virtual time, quota-throttled tenants held back)
with the same page-fit and bounded-bypass walk; a first admission charges
the tenant's virtual clock and quota, every terminal event settles it
(``_qos_settle``), page pressure picks its victim by tenant overuse, then
slack, then age (``_pick_victim``), and the prefix tier prices each spill
by its tenant's overuse and its slack. With ``APP_FORENSICS=on`` every
terminal event also feeds ``FORENSICS.observe`` (the tail-exemplar ring
and the burn-rate alerts); the dispatch records carry their requests'
ids (``rids``), which the forensics plane joins to each request.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import math
import os
import queue
import random
import threading
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.engine.engine import (
    EngineCore, HostCopy, PrefillItem, bits_to_f32, unpack_decode_out)
from generativeaiexamples_tpu_torch.engine import kv_tier as kv_tier_mod
from generativeaiexamples_tpu_torch.engine import qos as qos_mod
from generativeaiexamples_tpu_torch.engine.kv_tier import (
    KVSpillPool, PrefixKVTier, spill_budget_bytes, tier_disk_bytes, tier_mode)
from generativeaiexamples_tpu_torch.engine.prefix_cache import chain_hashes
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    IncrementalDetokenizer, Tokenizer)
from generativeaiexamples_tpu_torch.observability import chaos as chaos_mod
from generativeaiexamples_tpu_torch.observability import (
    forensics as forensics_mod)
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability import usage as usage_mod
from generativeaiexamples_tpu_torch.observability.devtime import (
    DEVTIME, pow2_bucket)
from generativeaiexamples_tpu_torch.observability.flight import (
    FLIGHT, REQUEST_LOG)
from generativeaiexamples_tpu_torch.observability.lockwatch import (
    tracked_lock)
from generativeaiexamples_tpu_torch.observability.trace import TRACE

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
    # disaggregated serving: a prefill_only request runs chunked prefill
    # and ends at its first sampled token, exporting its slot's KV pages
    # and sampling state into ``handoff`` (finish_reason "handoff"; no
    # text streams); a decode worker admits the payload with
    # Scheduler.submit_prefilled. kv_import_s: host seconds of the import
    # at admission on the decode side
    prefill_only: bool = False
    handoff: Optional[dict] = None
    kv_import_s: Optional[float] = None
    # SLO plane (observability/slo.py): the serving class ("" = the
    # configured default, stamped at submission), the remaining end-to-end
    # budget in seconds, the W3C trace id breach records link on, and the
    # verdict (slo_outcome: a preset such as "shed" that overrides judging)
    slo_class: str = ""
    deadline_s: Optional[float] = None
    trace_id: str = ""
    slo_outcome: Optional[str] = None
    slo: Optional[dict] = None
    # usage plane (observability/usage.py): the tenant billed ("" = anon)
    # and the KV pages held x seconds, stamped at every page-count change
    tenant: str = ""
    kv_page_seconds: float = 0.0
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    # the timeline (observability/flight.py renders it); every stamp is on
    # the injected perf clock (core/clock.py)
    submitted_at: float = field(default_factory=clock.perf)
    admitted_at: Optional[float] = None
    prefill_start_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    # preemptions promoted back from the host spill pool (no re-prefill),
    # and mid-decode snapshots of a peer resumed on this worker
    spill_resumes: int = 0
    snapshot_resumes: int = 0
    prefix_hit_tokens: int = 0    # prompt tokens served from the prefix cache
    # of those, the tokens promoted from the prefix-addressed host tier
    # (engine/kv_tier.py) at admission
    tier_hit_tokens: int = 0
    completion_tokens: int = 0
    # generated ids (a resumed snapshot's include those generated before
    # it, on the evacuated worker)
    output_ids: List[int] = field(default_factory=list)
    error: Optional[str] = None
    # "eos" | "stop" | "length" | "handoff" | "evacuated"; None = not
    # finished or failed
    finish_reason: Optional[str] = None


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
    # a handoff payload imported at admission instead of prefilling
    # (submit_prefilled), and a spilled snapshot of this job's own pages
    # promoted back at re-admission (_admit_spilled)
    preload: Optional[dict] = None
    spill: Optional[dict] = None
    # a prefill_only job's resolved (first token, logprob), exported once
    # the dispatch that resolved it was issued
    handoff_first: Optional[tuple] = None
    # the host tier's promotion plan from _plan_admission: (entry key,
    # covered tokens); _admit_tier imports the covered pages and the
    # chunked prefill starts at the boundary. Recomputed every plan
    tier_plan: Optional[tuple] = None
    page_clock: float = 0.0       # the usage plane's page-second stamp
    prefill_started: float = 0.0  # first chunk dispatched (prefill_s)


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
    # (issue instant on the mono clock, steps): the watchdog's hung-
    # dispatch bound reads the head entry's age
    issued: tuple = (0.0, 0)
    # a multi-step dispatch's deferred devtime census key:
    # (program, bucket, padded tokens)
    census: Optional[tuple] = None


class Scheduler:
    """Drives an :class:`EngineCore` from one background thread."""

    def __init__(self, core: EngineCore, tokenizer: Tokenizer) -> None:
        self.core = core
        self.tokenizer = tokenizer
        self._lock = tracked_lock("scheduler._lock")
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
        # disaggregated serving role: a "prefill" worker never dispatches
        # decode (its slots are finished prefills awaiting their first
        # token and export); "decode" and "unified" behave alike here
        self._role = core.role
        # live-migration evacuation: callers queue a request, the driver
        # thread (the owner of _state) performs it inside _tick and parks
        # each live slot's snapshot in the outbox, count-capped and
        # expired after APP_EVAC_TTL_S (device-native snapshots hold card
        # memory)
        self._evac_lock = tracked_lock("scheduler._evac_lock")
        self._evac_reqs: List[dict] = []
        self._evac_outbox: "OrderedDict[str, tuple]" = OrderedDict()
        self._evac_outbox_cap = 64
        self._evac_ttl_s = float(os.environ.get("APP_EVAC_TTL_S", "")
                                 or 120.0)
        # tick heartbeat for the engine watchdog (engine/watchdog.py): the
        # driver stamps this every loop iteration
        self.last_tick_mono = clock.mono()
        # the last dispatch's active over padded query rows (the flight
        # recorder's ragged_row_util)
        self._ragged_row_util = 0.0
        # counts read by chip_smoke.py and /health: dispatches, mixed
        # dispatches, widened decode steps (W > 1), accepted drafts
        # (spec_bonus_tokens) over slot-steps that emitted (spec_base_steps),
        # prompt tokens served from the prefix cache over prompt tokens
        # admitted, admissions past a page-blocked head, cached pages
        # reclaimed by allocation; prefill_tokens: the tokens of every
        # prefill chunk dispatched (grouped or riding a mixed dispatch)
        self.stats = {"prefill_dispatches": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0,
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
                         for w in self._decode_widths},
                      # KV movement: handoffs submitted, imported and
                      # exported, snapshots resumed here and evacuated
                      # (with a snapshot or for re-prefill), snapshots
                      # expired unpulled, spills promoted back (the pool
                      # adds kv_spill_<outcome>)
                      "kv_handoff_submitted": 0, "kv_handoff_imports": 0,
                      "kv_handoff_exports": 0, "snapshot_resumes": 0,
                      "evacuations_snapshot": 0,
                      "evacuations_reprefill": 0,
                      "evacuation_snapshots_expired": 0,
                      "spill_resumes": 0}
        # host-spill preemption: with a budget, page-exhaust preemption
        # demotes the victim's pages to host RAM instead of recomputing.
        # APP_KV_TIER=prefix grows the pool into the prefix-addressed tier
        # (retention, hash addressing, value-priced eviction), which
        # _plan_admission probes for every prompt
        budget = spill_budget_bytes(core.cfg)
        self._spill: Optional[KVSpillPool] = None
        self._tier: Optional[PrefixKVTier] = None
        if budget > 0:
            if tier_mode(core.cfg) == "prefix":
                self._tier = PrefixKVTier(
                    budget, disk_budget_bytes=tier_disk_bytes(core.cfg),
                    perf_model=getattr(core, "perf_model", None),
                    stats=self.stats)
                self._spill = self._tier
            else:
                self._spill = KVSpillPool(budget, self.stats)
        kv_tier_mod.register_pool(self._spill)
        # QoS admission plane (engine/qos.py, APP_QOS=off|fair): None in
        # off mode, where admission is the FIFO walk with no qos call
        self._qos: Optional[qos_mod.QosPolicy] = qos_mod.policy_from_env(
            core.cfg, perf_model=getattr(core, "perf_model", None),
            batch_hint=int(getattr(core, "batch", 1) or 1))
        if self._tier is not None and self._qos is not None:
            # cached prefixes of an overusing tenant evict first, as its
            # live jobs spill first. The hint reads the policy's published
            # snapshot without the QoS lock: the tier calls it under its
            # own lock, which must never be held while taking qos._lock
            self._tier.set_victim_bias(self._qos.tenant_overuse_hint)

    # ------------------------------------------------------------------ API

    def start(self) -> None:
        if self._running:
            return
        # the devtime plane gets this engine's perf model (live MFU / HBM
        # gauges) and closes the warm window: program keys first seen from
        # here on count as engine_recompiles_total
        DEVTIME.attach_perf(getattr(self.core, "perf_model", None))
        DEVTIME.mark_serving()
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
        if self._tier is not None:
            # bounded join of the tier's write-behind thread
            self._tier.close()

    def submit(self, request: Request) -> Request:
        """Enqueue; stream text deltas with :meth:`iter_text`."""
        if not request.prompt_ids:
            raise ValueError("empty prompt: a request needs at least one "
                             "token")
        if request.seed is None:
            request.seed = random.getrandbits(31)
        else:
            request.seed = int(request.seed) & 0x7FFFFFFF
        # the SLO class and deadline: explicit fields, else the ambient
        # admission context, else the default class's full budget
        slo_mod.stamp_request(request, slo_class=request.slo_class or None,
                              deadline_s=request.deadline_s)
        job = _Job(request=request,
                   detok=IncrementalDetokenizer(self.tokenizer),
                   ids=list(request.prompt_ids))
        with self._lock:
            self._pending.append(job)
        self._wake.set()
        REGISTRY.counter("requests_submitted").inc()
        if TRACE.enabled:
            self._trace("submit", request,
                        prompt_tokens=len(request.prompt_ids),
                        max_tokens=request.max_tokens,
                        slo=request.slo_class,
                        deadline_s=request.deadline_s,
                        prefix=self.prefix_key_hex(request.prompt_ids,
                                                   request.adapter or ""),
                        est_cost_s=self._est_cost_s(len(request.prompt_ids),
                                                    request.max_tokens))
        return request

    def submit_prefilled(self, request: Request, payload: dict) -> Request:
        """Admit a request whose prompt KV arrives as a handoff payload
        (decode role): admission imports the pages into fresh ones
        (``EngineCore.import_slot_kv``) and starts decoding at the
        payload's first token. A mid-decode snapshot (``resume``) resumes
        at its position: its ``prompt_ids`` are the prompt plus the tokens
        generated before it, split by ``prompt_len``. Raises ValueError
        before anything is queued when this pool cannot host the payload."""
        self.core.validate_handoff(payload)
        if request.seed is None:
            request.seed = int(payload.get("seed", 0) or 0)
        request.seed = int(request.seed) & 0x7FFFFFFF
        # the payload's class/deadline/tenant ride the handoff; explicit
        # request fields win
        if not request.slo_class and payload.get("slo_class"):
            request.slo_class = str(payload["slo_class"])
        if request.deadline_s is None and \
                payload.get("deadline_s") is not None:
            request.deadline_s = float(payload["deadline_s"])
        if not request.tenant and payload.get("tenant"):
            request.tenant = str(payload["tenant"])
        slo_mod.stamp_request(request, slo_class=request.slo_class or None,
                              deadline_s=request.deadline_s)
        job = _Job(request=request,
                   detok=IncrementalDetokenizer(self.tokenizer),
                   ids=list(request.prompt_ids))
        if payload.get("resume"):
            # ids mirror the written KV (page math, history, a later
            # preemption); gen_ids reseed the generated prefix so grammar
            # walks and stop accounting run as if it had decoded here
            full = [int(t) for t in payload.get("prompt_ids", [])]
            plen = max(0, min(int(payload.get("prompt_len", len(full))),
                              len(full)))
            request.prompt_ids = full[:plen]
            job.ids = list(full)
            job.gen_ids = full[plen:]
        job.preload = dict(payload)
        with self._lock:
            self._pending.append(job)
        self.stats["kv_handoff_submitted"] += 1
        REGISTRY.counter("requests_submitted").inc()
        REGISTRY.counter("kv_handoff_submitted").inc()
        self._wake.set()
        if TRACE.enabled:
            self._trace("submit", request,
                        prompt_tokens=len(request.prompt_ids),
                        max_tokens=request.max_tokens,
                        slo=request.slo_class,
                        deadline_s=request.deadline_s, path="handoff",
                        resume=bool(payload.get("resume")))
        return request

    def _est_cost_s(self, prompt_tokens: int, max_tokens: int) -> float:
        """Perf-model estimate of a request's device seconds (the trace's
        ``est_cost_s``): its prefill at the card's matmul peak plus one
        weight read a token; 0.0 where the peaks are unknown."""
        pm = getattr(self.core, "perf_model", None)
        try:
            if pm is None or not pm.peak_flops or not pm.peak_bw:
                return 0.0
            per_tok = pm.weight_read_bytes(1) / pm.peak_bw
            return round((pm.prefill_seconds(prompt_tokens) or 0.0)
                         + max(1, max_tokens) * per_tok, 6)
        except (AttributeError, TypeError):
            return 0.0

    def _trace(self, kind: str, req: Request, **fields) -> None:
        """One fleet-trace record (observability/trace.py) of a
        request-scoped event. Callers guard with ``TRACE.enabled``, so the
        off mode costs one attribute read."""
        TRACE.emit(kind, rid=req.request_id,
                   tenant=str(getattr(req, "tenant", "") or ""), **fields)

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
        hits = REGISTRY.counter("prefix_hit_tokens").value
        prompted_all = REGISTRY.counter("prefix_prompt_tokens").value
        REGISTRY.gauge("prefix_hit_frac").set(
            round(hits / prompted_all, 4) if prompted_all else 0.0)
        return {"engine_role": self._role, "running": len(self._slots),
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
                # host spill occupancy: a replica's host-RAM headroom
                "kv_spill_used_bytes": (self._spill.used_bytes
                                        if self._spill is not None else 0),
                "kv_spill_budget_bytes": (self._spill.budget_bytes
                                          if self._spill is not None else 0),
                # the tier's occupancy and its top-K hottest opening-page
                # hashes: the advert a router's promote routing matches
                **(self._tier.hot_stats() if self._tier is not None else {}),
                **self.stats}

    def prefix_key_hex(self, prompt_ids: Sequence[int],
                       adapter: str = "") -> str:
        """h0, the chain hash of a prompt's first full page under this
        scheduler's cache seed: what ``load_stats`` advertises and the
        ``X-KV-Prefix`` response header carries. "" when the tier is off or
        the prompt does not fill one page."""
        if self._tier is None:
            return ""
        ps = self.core.page_size
        if len(prompt_ids) < ps:
            return ""
        hs = chain_hashes([int(t) for t in prompt_ids[:ps]], ps,
                          seed=f"{self._cache_seed}|{adapter}")
        return hs[0].hex() if hs else ""

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
        now = clock.perf()
        for job in jobs:
            job.request.error = reason
            if job.request.finished_at is None:
                job.request.finished_at = now
            REGISTRY.counter("requests_failed").inc()
            REGISTRY.counter("requests_finished",
                             labels={"finish": "error"}).inc()
            slo_mod.SLO.observe(job.request)
            # page-seconds close before the pool rebuild below
            self._bill_pages(job)
            job.page_clock = 0.0
            # spilled host buffers die with their job
            self._drop_spill(job)
            self._qos_settle(job)
            usage_mod.USAGE.bill_request(job.request)
            REQUEST_LOG.record(job.request)
            if forensics_mod.FORENSICS.enabled:
                forensics_mod.FORENSICS.observe(job.request)
            job.request.out_queue.put(_STOP)
        self._alloc = self.core.new_allocator()
        self._free = list(range(self.core.batch))
        self._table[:] = 0
        self._table_dev = None
        # evacuation waiters: their jobs just failed
        with self._evac_lock:
            waiters, self._evac_reqs = self._evac_reqs, []
        for entry in waiters:
            entry["result"] = {"error": reason}
            entry["event"].set()

    def _qos_settle(self, job: _Job) -> None:
        """Close the job's QoS reservation (the virtual-time true-up and
        the quota refund) at its terminal event: called on every path
        that bills the usage ledger, so the policy's outstanding set
        drains through finishes, failures, evacuations and driver
        resets. No-op in off mode."""
        if self._qos is not None:
            self._qos.settle(job.request)

    def _bill_pages(self, job: _Job) -> None:
        """Add the job's KV page-seconds (pages held x seconds) to its
        request and restamp the clock: called at every page-count change
        (admission, growth, release, export), so the usage plane's vector
        integrates exactly the pages the job held. A stopped clock (0.0)
        only restamps: admission starts billing that way."""
        now = clock.perf()
        if job.page_clock and job.pages:
            job.request.kv_page_seconds += (len(job.pages)
                                            * (now - job.page_clock))
        job.page_clock = now

    def _release(self, job: _Job) -> None:
        """Return the job's slot and pages to the pools (its device row is
        already inactive)."""
        self._bill_pages(job)
        job.page_clock = 0.0      # billing stops with the hold
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
        # stamp, judge, bill and log before the stream ends: a client that
        # reads [DONE] and polls /debug/requests/<id> at once finds it
        req.finished_at = clock.perf()
        REGISTRY.counter("requests_completed").inc()
        REGISTRY.counter("requests_finished",
                         labels={"finish": req.finish_reason or "unknown"}
                         ).inc()
        REGISTRY.histogram("request_latency_s").observe(
            req.finished_at - req.submitted_at)
        if TRACE.enabled:
            self._trace("finish", req,
                        finish=req.finish_reason or "unknown",
                        completion_tokens=len(job.gen_ids),
                        prompt_tokens=len(req.prompt_ids),
                        e2e_s=round(req.finished_at - req.submitted_at, 6),
                        ttft_s=(round(req.first_token_at
                                      - req.submitted_at, 6)
                                if req.first_token_at else None),
                        preemptions=req.preemptions,
                        prefix_hit_tokens=req.prefix_hit_tokens,
                        tier_hit_tokens=req.tier_hit_tokens)
        slo_mod.SLO.observe(req)
        self._bill_pages(job)
        job.page_clock = 0.0
        self._qos_settle(job)
        usage_mod.USAGE.bill_request(req)
        REQUEST_LOG.record(req)
        if forensics_mod.FORENSICS.enabled:
            forensics_mod.FORENSICS.observe(req)
        req.out_queue.put(_STOP)
        # decode-written pages join the prefix cache before release: a
        # follow-up turn whose prompt embeds this one re-admits against them
        self._cache_insert(job, with_generated=True)
        self._drop_spill(job)
        self._release(job)

    def _fail(self, job: _Job, reason: str) -> None:
        job.request.error = reason
        job.request.finished_at = clock.perf()
        REGISTRY.counter("requests_failed").inc()
        REGISTRY.counter("requests_finished", labels={"finish": "error"}).inc()
        if TRACE.enabled:
            self._trace("finish", job.request, finish="error",
                        error=reason[:200],
                        completion_tokens=len(job.gen_ids),
                        prompt_tokens=len(job.request.prompt_ids))
        slo_mod.SLO.observe(job.request)
        # page-seconds close before billing: failure paths that still hold
        # pages release after this call
        self._bill_pages(job)
        job.page_clock = 0.0
        self._drop_spill(job)
        self._qos_settle(job)
        usage_mod.USAGE.bill_request(job.request)
        REQUEST_LOG.record(job.request)
        if forensics_mod.FORENSICS.enabled:
            forensics_mod.FORENSICS.observe(job.request)
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
        the cached pages it reclaimed into ``stats``. The chaos plane's
        forced exhaustion injects here, so a chaos run takes exactly the
        paths an empty pool takes; APP_CHAOS=off is one attribute read."""
        if chaos_mod.CHAOS.enabled and chaos_mod.CHAOS.page_fault():
            return None
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
        job now; sets ``job.tier_plan`` when the host tier covers more of
        the prompt than the device cache."""
        n = len(job.ids)
        job.tier_plan = None
        if job.preload is not None or job.spill is not None \
                or (not self._caching and self._tier is None):
            # handoff and spill imports scatter into their pages: they must
            # never be given shared prefix-cache pages
            return self.core.pages_for(n), 0, []
        if job.hashed_len != n:
            job.page_hashes = chain_hashes(
                job.ids, self.core.page_size,
                seed=f"{self._cache_seed}|{job.request.adapter}")
            job.hashed_len = n
        hits = self._alloc.match(job.page_hashes) if self._caching else []
        shared = self._cap_shared(n, len(hits) * self.core.page_size)
        if self._tier is not None:
            # the tier's promotion imports (scatters) the covered span, so
            # like a handoff it takes fresh pages for the whole prompt, and
            # the chunk walk starts at the covered boundary
            hit = self._tier.probe(job.page_hashes)
            if hit is not None:
                key, depth = hit
                covered = self._cap_shared(n, depth * self.core.page_size)
                if covered > shared:
                    job.tier_plan = (key, covered)
                    return self.core.pages_for(n), 0, []
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

    def _shed_pending(self) -> None:
        """Load shedding under critical error-budget burn
        (observability/slo.py): while ``SLO.pressure()`` is ``critical``,
        pending requests of a sheddable class are refused at admission.
        Only fresh submissions shed: a preempted resume already streamed
        tokens to its client."""
        if slo_mod.SLO.pressure() != "critical":
            return
        with self._lock:
            shed = [j for j in self._pending
                    if not j.gen_ids and j.admit_seq == 0
                    and slo_mod.SLO.resolve_or_default(
                        j.request.slo_class).sheddable]
            for job in shed:
                self._pending.remove(job)
        for job in shed:
            job.request.slo_outcome = "shed"
            if TRACE.enabled:
                self._trace("qos", job.request, decision="shed",
                            reason="slo_pressure")
            REGISTRY.counter("slo_shed_total",
                             labels={"class": job.request.slo_class}).inc()
            self._fail(job, "shed: SLO pressure is critical (error budget "
                            "burning); best-effort admission rejected — "
                            "retry when pressure clears (/debug/slo)")

    def _qos_shed_unmeetable(self) -> None:
        """Shed before prefill (engine/qos.py, ``APP_QOS=fair``): a
        sheddable pending request whose remaining deadline cannot cover
        its estimated prefill and decode service is refused at admission
        (``slo_outcome`` "shed", an error finish) before any prefill
        program runs for it. Only fresh local submissions shed: a resume
        already streamed to its client, and a handoff or spill import
        carries work already paid for."""
        now = clock.perf()
        with self._lock:
            shed = []
            for j in self._pending:
                if (j.gen_ids or j.admit_seq != 0 or j.preload is not None
                        or j.spill is not None):
                    continue
                if not slo_mod.SLO.resolve_or_default(
                        j.request.slo_class).sheddable:
                    continue
                est = self._qos.should_shed(j.request, len(j.ids), now)
                if est is not None:
                    shed.append((j, est))
            for job, _est in shed:
                self._pending.remove(job)
        for job, est in shed:
            job.request.slo_outcome = "shed"
            if TRACE.enabled:
                self._trace("qos", job.request, decision="shed",
                            reason="deadline_unmeetable",
                            est_s=round(est, 6))
            self._qos.note_shed(job.request)
            REGISTRY.counter("slo_shed_total",
                             labels={"class": job.request.slo_class}).inc()
            rem = qos_mod.request_remaining_s(job.request, now)
            self._fail(job, f"shed: deadline unmeetable before prefill "
                            f"(estimated service {est:.3f}s > remaining "
                            f"budget {0.0 if rem is None else rem:.3f}s); "
                            f"nothing was dispatched — retry with a larger "
                            f"deadline (/debug/qos)")

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
        ends at its current length. Under critical SLO pressure sheddable
        fresh submissions are refused first (``_shed_pending``).

        With the QoS plane armed the scan takes the policy's order (EDF
        within a tenant, merged by weighted-fair virtual time, throttled
        tenants held back for the pass) after the unmeetable deadlines
        are shed; the page-fit and bypass walk runs unchanged on it."""
        self._shed_pending()
        if self._qos is not None:
            self._qos_shed_unmeetable()
        while self._free:
            if self._qos is not None:
                with self._lock:
                    pending = list(self._pending)
                cands = self._qos.order(pending, self._ADMIT_SCAN)
            else:
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
                    REGISTRY.counter("admission_skips").inc()
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
            fresh = self._alloc_pages(need)
            if fresh is None:
                # an injected exhaustion (the chaos plane): the head waits
                # for the next tick, as for an empty pool
                if hits:
                    self._alloc.free(hits)
                return
            pages = list(hits) + fresh
            with self._lock:
                self._pending.remove(job)
            slot = heapq.heappop(self._free)   # lowest id first
            job.slot, job.pages = slot, pages
            # the page-second clock starts: a resume keeps accumulating on
            # the same request
            self._bill_pages(job)
            job.prefilled = job.total_len = job.shared = shared
            if job.request.admitted_at is None:
                job.request.admitted_at = clock.perf()
            if self._caching or self._tier is not None:
                if shared:
                    job.request.prefix_hit_tokens += shared
                    self.stats["prefix_hit_tokens"] += shared
                    REGISTRY.counter("prefix_hit_tokens").inc(shared)
                    if self._spec_w > 1:
                        # cache-hit chunks skip prefill, so the drafting
                        # history row is seeded here
                        self._state = self.core.seed_history(
                            self._state, slot, job.ids)
                self.stats["prefix_prompt_tokens"] += len(job.ids)
                REGISTRY.counter("prefix_prompt_tokens").inc(len(job.ids))
            if job.admit_seq == 0:
                # resumes keep their admission age, so youngest-first
                # preemption cannot thrash an old request
                self._admit_counter += 1
                job.admit_seq = self._admit_counter
                if self._qos is not None:
                    # a first admission charges the tenant's virtual clock
                    # and quota (a resume re-admits free); settled at the
                    # request's terminal event
                    self._qos.charge_admission(job.request)
            self._table[slot, :] = 0
            self._table[slot, :len(pages)] = pages
            self._table_dev = None
            if TRACE.enabled:
                self._trace("admit", job.request, slot=slot,
                            pages=len(pages), shared_tokens=shared,
                            resume=bool(job.gen_ids),
                            waited_s=round(clock.perf()
                                           - job.request.submitted_at, 6),
                            path=("handoff" if job.preload is not None
                                  else "spill" if job.spill is not None
                                  else "tier" if job.tier_plan is not None
                                  else "prefill"))
            if job.preload is not None:
                self._admit_prefilled(job)
            elif job.spill is not None:
                self._admit_spilled(job)
            elif job.tier_plan is not None:
                self._admit_tier(job)
            else:
                self._prefilling.append(job)

    def _admit_prefilled(self, job: _Job) -> None:
        """Admission with prefilled KV: import the handoff payload into the
        slot's fresh pages, seed history, activate at the payload's first
        token and emit it; from here the slot decodes as after a local
        prefill. A snapshot resume instead restores its stream state and
        streams only the text its client has not seen."""
        req = job.request
        payload = job.preload
        job.preload = None
        now = clock.perf()
        if req.prefill_start_at is None:
            req.prefill_start_at = now
        t0 = DEVTIME.track()
        self._state = self.core.import_slot_kv(self._state, job.slot,
                                               job.pages, payload)
        job.prefilled = job.total_len = len(job.ids)
        DEVTIME.commit("kv_import", f"p{self._import_bucket(payload)}",
                       self._state.tokens, t0=t0, tokens=len(job.ids),
                       mfu=False)
        req.kv_import_s = round(clock.perf() - now, 6)
        self.stats["kv_handoff_imports"] += 1
        REGISTRY.counter("kv_handoff_imports").inc()
        first = int(payload.get("first_token", self.core.eos_id))
        gen = max(1, int(payload.get("generated", 1)))
        resume = bool(payload.get("resume"))
        if resume:
            self.stats["snapshot_resumes"] += 1
            REGISTRY.counter("snapshot_resumes").inc()
            req.snapshot_resumes += 1
        elif req.first_token_at is None:
            # the first token was sampled remotely and reaches this
            # worker's client now
            req.first_token_at = now
            REGISTRY.histogram("ttft_s").observe(now - req.submitted_at)
        if first == self.core.eos_id and not resume:
            req.finish_reason = "eos"
            self._finish(job)
            return
        alive = gen < req.max_tokens
        if alive:
            if self._spec_w > 1:
                # imported pages skip prefill, so the drafting history is
                # seeded here
                self._state = self.core.seed_history(self._state, job.slot,
                                                     job.ids)
            # a grammar that rode the handoff walks the prefix and the
            # remotely sampled token: the slot activates at the DFA state
            # the prefill worker's sample reached (a resume walks its whole
            # emitted history the same way)
            gs = (self._gram_state_for(job, extra=(first,))
                  if req.grammar is not None else 0)
            self._state = self.core.activate(
                self._state, job.slot, first, gen, req.max_tokens,
                req.temperature, req.top_k, req.top_p, seed=req.seed or 0,
                gram_state=gs)
            self._slots[job.slot] = job
        if resume:
            self._resume_stream_state(job, payload, first, alive)
            return
        if self._emit_token(job, first,
                            float(payload.get("first_logprob") or 0.0)):
            if alive:
                self._retire(job)
            else:
                self._finish(job)
            return
        if not alive:
            req.finish_reason = "length"
            self._finish(job)

    def _import_bucket(self, payload: dict, n_pages: int = 0) -> int:
        """The ledger bucket of a KV import: its page count's power of two,
        capped at a slot's pages (the reference's ``p<pages>`` keys)."""
        n = n_pages or int(payload.get("n_pages", 1) or 1)
        return min(pow2_bucket(max(1, n)), int(self.core.max_pages_per_slot))

    def _resume_stream_state(self, job: _Job, payload: dict, first: int,
                             alive: bool) -> None:
        """A snapshot's host stream state: replay the emitted tokens
        through the fresh detokenizer (held UTF-8 bytes continue where the
        evacuated worker stopped), restore the stop holdback, and emit
        only the text the client has not seen (``resume_chars``: the
        characters it was delivered; absent, everything the evacuated
        worker streamed). The pending token joins ``gen_ids`` without
        streaming again."""
        req = job.request
        replay = "".join(job.detok.push(int(t))
                         for t in list(job.gen_ids) + [first])
        job.gen_ids.append(first)
        req.output_ids = list(job.gen_ids)
        job.total_len += 1
        job.stop_buf = str(payload.get("stop_buf") or "")
        # what the evacuated worker streamed: every delta minus its holdback
        streamed = max(0, len(replay) - len(job.stop_buf))
        sent = payload.get("resume_chars")
        already = streamed if sent is None else max(0, min(int(sent),
                                                           streamed))
        gap = replay[already:streamed]
        if gap:
            req.out_queue.put(gap)
        if not alive:
            # the snapshot sat at the budget: end cleanly without flushing
            # the replayed text again
            job.stopped = True
            req.finish_reason = "length"
            self._finish(job)

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
                    req.prefill_start_at = clock.perf()
                if not job.prefill_started:
                    job.prefill_started = clock.perf()
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
        t_issue = clock.perf()
        t0 = DEVTIME.track()
        self._state, toks = self.core.prefill_group(self._state, items)
        n_tok = sum(len(it.chunk_ids) for it in items)
        # one ledger key per grouped-prefill bucket (the padded group size)
        g_bucket = next(b for b in self.core.group_buckets
                        if len(items) <= b)
        DEVTIME.commit("prefill", f"g{g_bucket}", toks, t0=t0, tokens=n_tok,
                       padded_tokens=g_bucket * self.core.chunk,
                       weight_passes=1.0)
        REGISTRY.histogram("prefill_issue_s").observe(clock.perf() - t_issue)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_chunks"] += len(items)
        REGISTRY.counter("prefill_chunks").inc(len(items))
        self.stats["prefill_tokens"] += n_tok
        if TRACE.enabled:
            slots_hit = {it.slot for it in items}
            TRACE.emit("dispatch", phase="prefill", chunks=len(items),
                       tokens=n_tok, jobs=len(slots_hit),
                       rids=",".join(j.request.request_id
                                     for j in self._prefilling
                                     if j.slot in slots_hit))
        for job in finals:
            self._prefilling.remove(job)
            # the prompt's pages are now write-dispatched: publish them
            self._cache_insert(job)
            self._enter_decode(job)
        return len(items)

    def _gram_state_for(self, job: _Job, extra: tuple = ()) -> int:
        """The flat DFA state a grammared job's fused first token samples
        under (0: unconstrained). A resume re-walks the tokens it already
        emitted, then ``extra`` (a handoff's remotely sampled first
        token). Grammars of active, prefilling and pending jobs stay
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
            tokens = list(job.gen_ids) + list(extra)
            if tokens or prefix:
                state = self.core.walk_grammar(grammar, tokens, active,
                                               prefix=prefix)
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
        for resolution and hand the slot to the decode set. A prefill_only
        slot is released on the device at once: nothing may decode it
        before its export (its first token stays in ``state.tokens``)."""
        job.first_pending = True
        job.first_inflight = False
        job.first_batched = False
        job.first_epoch += 1
        self._slots[job.slot] = job
        if job.request.prefill_only:
            self._state = self.core.release(self._state, job.slot)

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
        now = clock.perf()
        if req.first_token_at is None:
            req.first_token_at = now
            REGISTRY.histogram("ttft_s").observe(now - req.submitted_at)
        if job.prefill_started:
            # first chunk dispatched -> first token on the host
            REGISTRY.histogram("prefill_s").observe(now - job.prefill_started)
            job.prefill_started = 0.0
        if req.prefill_only:
            # a prefill_only request ends here: its pages and sampling
            # state are exported instead of decoded
            job.handoff_first = (first, lp)
            end = "handoff"
        elif first == self.core.eos_id:
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
        deactivates the slot on the device; a prefill_only job exports."""
        if end == "handoff":
            self._export_handoff(job, *job.handoff_first)
            return
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

    # -- KV handoff and live migration ---------------------------------------

    def _export_handoff(self, job: _Job, first: int,
                        lp: Optional[float] = None) -> None:
        """Finish a prefill_only request by exporting its pages and sampling
        state (``EngineCore.export_slot_kv``) into ``Request.handoff``. The
        gather is issued before the slot's pages are freed, and its
        outputs are fresh tensors, so page reuse cannot reach them."""
        req = job.request
        t0 = DEVTIME.track()
        try:
            payload = self.core.export_slot_kv(self._state, job.pages,
                                               len(job.ids))
        except Exception as exc:
            logger.exception("KV export failed for %s", req.request_id)
            del self._slots[job.slot]
            self._state = self.core.release(self._state, job.slot)
            self._fail(job, f"kv export failed: {exc}")
            self._release(job)
            return
        self._commit_export(payload, t0)
        self.stats["kv_handoff_exports"] += 1
        REGISTRY.counter("kv_handoff_exports").inc()
        payload.update({
            "prompt_ids": [int(t) for t in job.ids],
            "first_token": int(first),
            "first_logprob": float(lp) if lp is not None else 0.0,
            "generated": len(job.gen_ids) + 1,
            **self._sampling_scalars(req),
        })
        # the grammar rides as its constructor spec; grammar_attached says
        # whether this worker's first token was sampled under it
        payload.update(self._grammar_scalars(job))
        req.handoff = payload
        req.finish_reason = "handoff"
        del self._slots[job.slot]
        self._state = self.core.release(self._state, job.slot)
        self._finish(job)

    def _commit_export(self, payload: dict, t0: float) -> None:
        """The host seconds an export took to issue (device-native: the
        gather is not waited for), riding the payload as ``export_s``,
        the ``kv_export_s`` histogram and the ledger's ``kv_export`` key
        (fenced on the gather's output when sampled)."""
        export_s = round(clock.perf() - t0, 6)
        payload["export_s"] = export_s
        REGISTRY.histogram("kv_export_s").observe(export_s)
        marker = payload.get("k")
        DEVTIME.commit("kv_export", f"p{self._import_bucket(payload)}",
                       marker, t0=t0,
                       tokens=int(payload.get("length", 0) or 0),
                       mfu=False, retain=False)

    @staticmethod
    def _sampling_scalars(req: Request) -> dict:
        """The sampling scalars every exported payload carries (the
        prefill handoff and the mid-decode snapshot alike)."""
        return {"seed": int(req.seed or 0),
                "max_tokens": int(req.max_tokens),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k),
                "top_p": float(req.top_p),
                "stop": list(req.stop),
                # one logical request keeps its class, deadline and tenant
                # across the disaggregated route
                "slo_class": req.slo_class,
                "deadline_s": req.deadline_s,
                "tenant": req.tenant}

    @staticmethod
    def _grammar_scalars(job: _Job) -> dict:
        req = job.request
        if not req.grammar_spec:
            return {}
        return {"grammar_kind": req.grammar_spec[0],
                "grammar_payload": req.grammar_spec[1],
                "grammar_prefix": req.grammar_prefix,
                "grammar_attached": bool(job.gram_on)}

    def _snapshot_eligible(self, job: _Job) -> bool:
        """May this slot's live decode state be exported mid-stream? It
        needs a resolved pending token, base weights (the importer
        activates at the base model), budget left, and no dispatch in
        flight (the host view must equal the device's, or the in-flight
        steps' tokens would be lost)."""
        req = job.request
        return (not req.prefill_only and not req.adapter
                and bool(job.gen_ids) and not job.first_pending
                and not job.stopped
                and len(job.gen_ids) < req.max_tokens
                and not self._inflight)

    def export_live_slot(self, job: _Job, fetch: bool = False) -> dict:
        """A mid-decode snapshot that a peer resumes token for token at
        its position: the pages of every position written (``total_len -
        1``: the last emitted token is the next input, its KV not yet
        written), the emitted tokens (``prompt_ids`` + ``prompt_len``), the
        seed and its position (``generated``: the threefry keys fold in
        the position, so the resumed draws are the same), the stop
        holdback and the grammar spec. The caller has checked
        :meth:`_snapshot_eligible`."""
        req = job.request
        written = job.total_len - 1
        t0 = DEVTIME.track()
        payload = self.core.export_slot_kv(self._state, job.pages, written,
                                           fetch=fetch)
        self._commit_export(payload, t0)
        payload.update({
            "prompt_ids": ([int(t) for t in req.prompt_ids]
                           + [int(t) for t in job.gen_ids[:-1]]),
            "prompt_len": len(req.prompt_ids),
            "first_token": int(job.gen_ids[-1]),
            "first_logprob": 0.0,
            "generated": len(job.gen_ids),
            "resume": True,
            "stop_buf": job.stop_buf,
            **self._sampling_scalars(req),
        })
        payload.update(self._grammar_scalars(job))
        return payload

    def request_evacuation(self, rids: Optional[set] = None,
                           wait_s: float = 30.0, reason: str = "drain",
                           guard=None) -> dict:
        """Queue an evacuation for the driver thread and wait up to
        ``wait_s`` for its summary (0: return at once). ``rids`` limits it
        to those request ids (None: everything live). ``guard``, when
        given, is called by the driver when it acts: False cancels the
        sweep (the trigger may have cleared meanwhile)."""
        ev = threading.Event()
        entry = {"rids": set(rids) if rids else None, "event": ev,
                 "result": None, "reason": reason, "guard": guard}
        with self._evac_lock:
            self._evac_reqs.append(entry)
        self._wake.set()
        if wait_s and ev.wait(wait_s):
            return entry["result"] or {}
        return entry["result"] or {"queued": True, "reason": reason}

    def _prune_outbox(self) -> None:
        """Expire outbox entries older than ``APP_EVAC_TTL_S`` (the caller
        holds ``_evac_lock``); insertion order is age order."""
        now = clock.mono()
        while self._evac_outbox:
            rid, (_payload, parked) = next(iter(self._evac_outbox.items()))
            if now - parked <= self._evac_ttl_s:
                break
            self._evac_outbox.popitem(last=False)
            self.stats["evacuation_snapshots_expired"] += 1
            REGISTRY.counter("evacuation_snapshots_expired").inc()
            logger.warning("evacuation snapshot for %s expired unpulled "
                           "after %.0f s; its stream can only resume by "
                           "re-prefill now", rid, self._evac_ttl_s)

    def take_evacuated(self, rid: str) -> Optional[dict]:
        """Pop a parked snapshot (each is served once: a second resume
        would fork the stream)."""
        with self._evac_lock:
            self._prune_outbox()
            entry = self._evac_outbox.pop(rid, None)
        return entry[0] if entry is not None else None

    def evacuated_ids(self) -> List[str]:
        with self._evac_lock:
            self._prune_outbox()
            return list(self._evac_outbox)

    def _run_evacuations(self) -> bool:
        """Driver side: run every queued evacuation (and age the outbox,
        whether or not a pull ever comes)."""
        with self._evac_lock:
            if self._evac_outbox:
                self._prune_outbox()
            if not self._evac_reqs:
                return False
            entries, self._evac_reqs = self._evac_reqs, []
        for entry in entries:
            try:
                guard = entry.get("guard")
                if guard is not None and not guard():
                    logger.warning("evacuation (%s) cancelled: its trigger "
                                   "cleared before the driver could act",
                                   entry["reason"])
                    entry["result"] = {"canceled": True,
                                       "reason": entry["reason"]}
                    continue
                entry["result"] = self._do_evacuate(entry["rids"],
                                                    entry["reason"])
            except Exception as exc:
                logger.exception("evacuation failed")
                entry["result"] = {"error": str(exc)}
            finally:
                entry["event"].set()
        return True

    def _do_evacuate(self, rids: Optional[set], reason: str) -> dict:
        """Snapshot every live slot (of ``rids``) into the outbox and end
        its stream with finish_reason "evacuated". The dispatches in flight
        (multi-step blocks too) resolve first. A job that cannot be
        snapshotted (first token in flight, mid-prefill, an adapter, still
        pending) ends the same way without a snapshot: its pull finds
        nothing and the caller re-prefills; a spilled pending job ships its
        spill."""
        while self._inflight:
            self._process_decode()
        summary = {"reason": reason, "snapshot": [], "reprefill": []}

        def count(snapshot: bool, req: Request) -> None:
            kind = "snapshot" if snapshot else "reprefill"
            self.stats[f"evacuations_{kind}"] += 1
            REGISTRY.counter("engine_evacuations_total",
                             labels={"outcome": kind}).inc()
            summary[kind].append(req.request_id)

        for slot, job in list(self._slots.items()):
            req = job.request
            if rids is not None and req.request_id not in rids:
                continue
            if self._slots.get(slot) is not job or req.prefill_only:
                continue   # a prefill_only job awaits its own export
            payload = None
            if self._snapshot_eligible(job):
                try:
                    payload = self.export_live_slot(job)
                except Exception:
                    logger.exception("snapshot export failed for %s; it "
                                     "resumes by re-prefill",
                                     req.request_id)
                    payload = None
            del self._slots[slot]
            self._state = self.core.release(self._state, slot)
            self._cache_insert(job, with_generated=True)
            count(payload is not None, req)
            self._finish_evacuated(job, payload)
        for job in list(self._prefilling):
            req = job.request
            if rids is not None and req.request_id not in rids:
                continue
            self._prefilling.remove(job)
            if job.slot >= 0:
                self._state = self.core.release(self._state, job.slot)
                self._cache_insert(job, with_generated=True)
            count(False, req)
            self._finish_evacuated(job, None)
        with self._lock:
            pending = [j for j in self._pending
                       if rids is None or j.request.request_id in rids]
            for job in pending:
                self._pending.remove(job)
        for job in pending:
            # a spilled job holds a complete host snapshot already
            payload = job.spill
            if payload is not None:
                self._drop_spill(job, outcome="evacuated")
            count(payload is not None, job.request)
            self._finish_evacuated(job, payload)
        FLIGHT.event("evacuation", reason=reason,
                     snapshots=len(summary["snapshot"]),
                     reprefills=len(summary["reprefill"]))
        return summary

    def _finish_evacuated(self, job: _Job, payload: Optional[dict]) -> None:
        """End an evacuated stream: finish_reason "evacuated" (resumable,
        not an error), the snapshot parked before the stream's end (a
        consumer that sees the end and pulls at once finds it), and no
        detokenizer flush (held bytes re-emerge from the resume's
        replay)."""
        req = job.request
        req.finish_reason = "evacuated"
        if payload is not None:
            with self._evac_lock:
                self._prune_outbox()
                self._evac_outbox[req.request_id] = (payload, clock.mono())
                self._evac_outbox.move_to_end(req.request_id)
                while len(self._evac_outbox) > self._evac_outbox_cap:
                    self._evac_outbox.popitem(last=False)
        req.slo_outcome = req.slo_outcome or "evacuated"
        req.finished_at = clock.perf()
        REGISTRY.counter("requests_finished",
                         labels={"finish": "evacuated"}).inc()
        if TRACE.enabled:
            self._trace("migrate", req, snapshot=payload is not None,
                        generated=len(job.gen_ids))
        slo_mod.SLO.observe(req)
        self._bill_pages(job)
        job.page_clock = 0.0
        self._qos_settle(job)
        usage_mod.USAGE.bill_request(req)
        REQUEST_LOG.record(req)
        if forensics_mod.FORENSICS.enabled:
            forensics_mod.FORENSICS.observe(req)
        req.out_queue.put(_STOP)
        self._release(job)

    def _drop_spill(self, job: _Job, outcome: str = "dropped") -> None:
        """Return a dead spilled job's bytes to the pool's budget."""
        if job.spill is not None and self._spill is not None:
            self._spill.release(job.request.request_id, outcome=outcome)
        job.spill = None

    def _spill_out(self, job: _Job) -> bool:
        """Demote a preemption victim's pages to the host spill pool
        instead of freeing and recomputing them: one device-to-host copy
        now, one upload at promotion, no prefill. False when the job is
        ineligible or the pool over budget: the caller recomputes."""
        if self._spill is None or self._slots.get(job.slot) is not job \
                or not self._snapshot_eligible(job):
            return False
        if chaos_mod.CHAOS.enabled and chaos_mod.CHAOS.spill_fault():
            return False   # injected pool exhaustion: recompute
        req = job.request
        try:
            payload = self.export_live_slot(job, fetch=True)
        except Exception:
            logger.exception("spill export failed for %s; recomputing",
                             req.request_id)
            return False
        if not self._spill.admit(req.request_id, payload):
            return False   # over APP_KV_SPILL_MB: recompute
        if self._tier is not None:
            self._tier_contribute(job, payload)
        job.spill = payload
        del self._slots[job.slot]
        self._state = self.core.release(self._state, job.slot)
        self._cache_insert(job, with_generated=True)
        self._release(job)
        # the job keeps its live detokenizer, stop and grammar state; only
        # its KV moved. ids cover the written context and the pending token
        job.ids = list(req.prompt_ids) + list(job.gen_ids)
        job.prefilled = job.total_len = 0
        job.prefill_started = 0.0
        with self._lock:
            self._pending.appendleft(job)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        REGISTRY.counter("preemptions").inc()
        logger.info("spilled request %s at %d generated tokens (%d bytes "
                    "on the host)", req.request_id, len(job.gen_ids),
                    self._spill.used_bytes)
        if TRACE.enabled:
            self._trace("spill", req, generated=len(job.gen_ids),
                        pool_used_bytes=self._spill.used_bytes)
        return True

    def _tier_contribute(self, job: _Job, payload: dict) -> None:
        """Register a fresh spill's full-page prefix run in the tier under
        its chain hashes: the spill pins the entry while it lives; after the
        request id releases it stays as priced cache, so a later prompt
        that shares the prefix promotes instead of prefilling. The hashes
        run over the written context (prompt and fed-back generated
        tokens), which a returning conversation's next turn extends."""
        req = job.request
        ids = payload.get("prompt_ids") or []
        ps = self.core.page_size
        hashes = chain_hashes([int(t) for t in ids], ps,
                              seed=f"{self._cache_seed}|{req.adapter}")
        depth = min(len(hashes), int(payload.get("n_pages", 0)))
        if depth <= 0:
            return
        self._tier.contribute(req.request_id, hashes[:depth], payload,
                              tokens=depth * ps,
                              tenant=req.tenant,
                              slack_s=qos_mod.request_remaining_s(req))

    def _admit_tier(self, job: _Job) -> None:
        """The tier's promotion at admission: import the cached prefix run
        into the job's fresh pages (a partial scatter, no slot state) and
        start the chunk walk at the covered boundary. No prefill runs over
        the covered span; the tail prefills as after a prefix-cache hit of
        the same span, whose stream it equals. Any failure (the entry evicted
        since the plan, a corrupt disk copy, a geometry mismatch) falls
        back to a full prefill on the same pages."""
        key, covered = job.tier_plan
        job.tier_plan = None
        req = job.request
        tier = self._tier
        payload = tier.checkout(key)
        if payload is None:
            self._prefilling.append(job)
            return
        now = clock.perf()
        t0 = DEVTIME.track()
        n_imp = covered // self.core.page_size
        try:
            self._state = self.core.import_pages_kv(
                self._state, job.pages, payload, n_pages=n_imp)
        except Exception as exc:
            logger.warning("kv tier promote failed for %s (%s); "
                           "re-prefilling", req.request_id, exc)
            tier.count_tier("import_failed")
            self._prefilling.append(job)
            return
        finally:
            tier.checkin(key)
        job.prefilled = job.total_len = job.shared = covered
        DEVTIME.commit("kv_import",
                       f"p{self._import_bucket(payload, n_imp)}",
                       self._state.tokens, t0=t0, tokens=covered, mfu=False)
        req.kv_import_s = round(clock.perf() - now, 6)
        req.tier_hit_tokens += covered
        req.prefix_hit_tokens += covered
        self.stats["prefix_hit_tokens"] += covered
        REGISTRY.counter("prefix_hit_tokens").inc(covered)
        self.stats["kv_tier_hit_tokens"] += covered
        REGISTRY.counter("kv_tier_hit_tokens").inc(covered)
        tier.count_tier("promoted")
        if TRACE.enabled:
            self._trace("promote", req, source="tier",
                        covered_tokens=covered, import_s=req.kv_import_s)
        if self._spec_w > 1:
            # promoted pages skip prefill, so the drafting history row is
            # seeded here, as for cache hits
            self._state = self.core.seed_history(self._state, job.slot,
                                                 job.ids)
        self._prefilling.append(job)

    def _admit_spilled(self, job: _Job) -> None:
        """Promotion: re-import a spilled job's pages into its fresh ones and
        reactivate the slot at the snapshot's position. No prefill runs,
        and nothing is re-emitted: the job's stream state never left."""
        req = job.request
        payload = job.spill
        job.spill = None
        if self._spill is not None:
            self._spill.release(req.request_id, outcome="promoted")
        t0 = DEVTIME.track()
        try:
            self._state = self.core.import_slot_kv(self._state, job.slot,
                                                   job.pages, payload)
        except Exception as exc:
            # a local promote cannot fail for wire reasons: fail loudly,
            # never serve garbage KV
            logger.exception("spill promote failed for %s", req.request_id)
            self._fail(job, f"kv spill promote failed: {exc}")
            self._release(job)
            return
        job.prefilled = job.total_len = len(job.ids)
        DEVTIME.commit("kv_import", f"p{self._import_bucket(payload)}",
                       self._state.tokens, t0=t0, tokens=len(job.ids),
                       mfu=False)
        self.stats["spill_resumes"] += 1
        REGISTRY.counter("spill_resumes").inc()
        req.spill_resumes += 1
        if TRACE.enabled:
            self._trace("promote", req, source="spill",
                        generated=len(job.gen_ids))
        if self._spec_w > 1:
            self._state = self.core.seed_history(self._state, job.slot,
                                                 job.ids)
        gs = self._gram_state_for(job) if req.grammar is not None else 0
        self._state = self.core.activate(
            self._state, job.slot, int(job.gen_ids[-1]), len(job.gen_ids),
            req.max_tokens, req.temperature, req.top_k, req.top_p,
            seed=req.seed or 0, gram_state=gs)
        self._slots[job.slot] = job

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
            if job.request.prefill_only:
                continue   # awaiting its export; never decode-advances
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
                    self._bill_pages(job)   # the count changes now
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
                self._preempt(self._pick_victim())
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

    def _pick_victim(self) -> _Job:
        """The youngest admission, decoding or mid-prefill (both hold
        pages; the growing job too, so it preempts itself rather than an
        older request). With the QoS plane armed: the job whose tenant
        runs furthest ahead of the global virtual clock, then the one with
        the most SLO slack, then the youngest (``QosPolicy.pick_victim``)."""
        cands = list(self._prefilling) + list(self._slots.values())
        if self._qos is not None:
            return self._qos.pick_victim(cands)
        return max(cands, key=lambda j: j.admit_seq)

    def _preempt(self, job: _Job) -> None:
        """Preemption under page pressure: with the host spill pool armed a
        decoding victim's pages demote to host RAM (``_spill_out``); else,
        or when it is ineligible or over budget, recompute preemption: free
        the slot and pages, re-queue the job at the head as prompt +
        generated tokens. Results still in flight for it are dropped by
        the identity checks."""
        if self._spill_out(job):
            return
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
        job.prefill_started = 0.0
        job.first_pending = job.first_batched = job.first_inflight = False
        with self._lock:
            self._pending.appendleft(job)
        job.request.preemptions += 1
        self.stats["preemptions"] += 1
        REGISTRY.counter("preemptions").inc()
        logger.info("preempted request %s at %d generated tokens",
                    job.request.request_id, len(job.gen_ids))
        if TRACE.enabled:
            self._trace("preempt", job.request, mode="recompute",
                        generated=len(job.gen_ids))

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
        bonus = int(np.maximum(per_step - 1, 0).sum())
        base_steps = int((per_step > 0).sum())
        self.stats["spec_bonus_tokens"] += bonus
        self.stats["spec_base_steps"] += base_steps
        REGISTRY.counter("spec_bonus_tokens").inc(bonus)
        REGISTRY.counter("spec_base_steps").inc(base_steps)
        accept_h = REGISTRY.histogram("spec_accept_len")
        a = self._SPEC_EMA_ALPHA
        for slot, job in active_map.items():
            col = per_step[:, slot]
            live = col > 0
            if not live.any():
                continue
            accepted = col[live] - 1                    # drafts accepted
            for v in accepted:
                accept_h.observe(float(v))
            mean = float(accepted.mean())
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
        adapter'd job: the mixed program runs base weights only. Nor a
        prefill_only job: its export stays on the grouped program."""
        if job.adapter_ix or job.request.adapter or job.request.prefill_only:
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
                req.prefill_start_at = clock.perf()
            if not job.prefill_started:
                job.prefill_started = clock.perf()
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
        t_issue = clock.perf()
        t0 = DEVTIME.track()
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
            REGISTRY.counter("mixed_dispatches").inc()
            REGISTRY.counter("prefill_chunks").inc(len(items))
            self.stats["prefill_tokens"] += sum(len(it.chunk_ids)
                                                for it in items)
            width = self.core.batch
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
            width = self.core.batch
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
        census = self._commit_decode(out, t0, steps, multi_m, w_disp, caps,
                                     width, use_grammar, want_top, packed)
        self._note_decode_issue(t_issue, steps, width, w_disp, packed)
        self._inflight.append(_Dispatch(self._fetch(out["packed"], steps),
                                        fresh, active_map, steps * w_disp,
                                        w_disp, issued=(clock.mono(), steps),
                                        census=census))
        self._pending_steps += steps * w_disp
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += steps
        REGISTRY.counter("decode_steps").inc(steps)
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

    def _fetch(self, packed, steps: int = 0) -> HostCopy:
        """The one result-fetch seam: start a device tensor's copy to the
        host (``engine.HostCopy``) and count it (``stats["host_fetches"]``
        and the ledger's ``engine_host_fetches_total``; ``steps`` is the
        decode steps the block carries, 0 for a first-token snapshot)."""
        self.stats["host_fetches"] += 1
        DEVTIME.note_fetch(steps)
        if isinstance(packed, HostCopy):
            return packed
        return HostCopy(packed)

    def _commit_decode(self, out, t0, steps: int, multi_m: int, w_disp: int,
                       caps, width: int, use_grammar: bool, want_top: bool,
                       packed) -> Optional[tuple]:
        """The devtime ledger's entry of one decode dispatch, keyed by its
        program shape as the reference keys it: grammar and top-logprob
        variants split the program name, useful tokens are steps x active
        slots x width (plus fused chunk tokens). A multi-step dispatch's
        census is deferred to its result: returns its (program, bucket,
        padded tokens)."""
        suffix = (("+gram" if use_grammar else "")
                  + ("+top" if want_top else ""))
        if caps is None:
            dec_useful = steps * len(self._slots) * w_disp
        else:
            dec_useful = steps * sum(1 + int(caps[s]) for s in self._slots)
        if packed is not None:
            items = packed[0]
            g_bucket = next(b for b in self.core.group_buckets
                            if len(items) <= b)
            DEVTIME.commit(
                f"mixed{suffix}", self.core.mixed_bucket(g_bucket, steps),
                out["packed"], t0=t0,
                tokens=dec_useful + sum(len(it.chunk_ids) for it in items),
                padded_tokens=(steps * self.core.batch * w_disp
                               + g_bucket * self.core.chunk),
                weight_passes=float(steps))
            return None
        if multi_m:
            base = steps // multi_m
            bucket = self.core.decode_multi_bucket(base, multi_m)
            DEVTIME.commit("decode_multi", bucket, out["packed"], t0=t0,
                           tokens=0, padded_tokens=0,
                           weight_passes=float(steps), defer_census=True)
            return ("decode_multi", bucket, float(steps * self.core.batch))
        DEVTIME.commit(f"decode{suffix}",
                       self.core.decode_bucket(steps, w_disp, width),
                       out["packed"], t0=t0, tokens=dec_useful,
                       padded_tokens=steps * width * w_disp,
                       weight_passes=float(steps))
        return None

    def _note_decode_issue(self, t_issue: float, steps: int, width: int,
                           w_disp: int, packed) -> None:
        """The issue-side gauges and histograms of a decode dispatch and
        its trace record: active over padded query rows
        (``ragged_row_util``), host issue seconds, batch fill."""
        active_q = len(self._slots) * w_disp
        padded_q = width * w_disp
        if packed is not None:
            items = packed[0]
            g_bucket = next(b for b in self.core.group_buckets
                            if len(items) <= b)
            active_q += sum(len(it.chunk_ids) for it in items)
            padded_q = (self.core.batch * self._spec_w
                        + g_bucket * self.core.chunk)
        self._ragged_row_util = active_q / padded_q if padded_q else 0.0
        REGISTRY.gauge("ragged_row_util").set(round(self._ragged_row_util, 4))
        REGISTRY.histogram("decode_issue_s").observe(clock.perf() - t_issue)
        REGISTRY.histogram("decode_batch_fill").observe(
            len(self._slots) / self.core.batch)
        if TRACE.enabled:
            TRACE.emit("dispatch", phase="decode", steps=steps,
                       width=width, slots=len(self._slots),
                       mixed=packed is not None,
                       fill=round(len(self._slots) / self.core.batch, 4),
                       rids=",".join(j.request.request_id
                                     for j in self._slots.values()))

    def _process_decode(self) -> None:
        """Resolve the oldest dispatch in flight (waiting for its copy if
        it is still running) and fan out its (steps*W, width) micro-rows:
        first tokens of the jobs it snapshotted, then up to W accepted
        tokens per slot a step."""
        entry = self._inflight.popleft()
        self._pending_steps -= entry.positions
        t0 = clock.perf()
        out = unpack_decode_out(entry.result.result())
        REGISTRY.histogram("sync_wait_s").observe(clock.perf() - t0)
        REGISTRY.counter("tokens_generated").inc(int(out["emitted"].sum()))
        if entry.census is not None:
            # the deferred census: only rows the block emitted are useful
            prog, bucket, padded = entry.census
            DEVTIME.note_tokens(prog, bucket, float(out["emitted"].sum()),
                                padded)
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
        self._first_fetches.append(
            (self._fetch(self.core.snapshot_tokens(self._state)), waiting))

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

    def _flight_fields(self) -> Dict[str, object]:
        """One flight-recorder sample of the scheduler's state, the
        reference's fields (called only when a sample is due)."""
        with self._lock:
            waiting = len(self._pending)
        free = int(self._alloc.available)
        total = int(self.core.num_pages)
        decodes = self.stats["decode_dispatches"]
        return {
            "fill": round(len(self._slots) / self.core.batch, 4),
            "running": len(self._slots),
            "prefilling": len(self._prefilling),
            "waiting": waiting,
            "inflight_dispatches": len(self._inflight),
            "kv_pages_free": free,
            "kv_pages_used": total - free,
            "prefix_hit_tokens": REGISTRY.counter("prefix_hit_tokens").value,
            "preemptions": REGISTRY.counter("preemptions").value,
            "tokens_generated": REGISTRY.counter("tokens_generated").value,
            "mixed_dispatch_frac": (round(self.stats["mixed_dispatches"]
                                          / decodes, 4) if decodes else 0.0),
            "ragged_row_util": round(self._ragged_row_util, 4),
            "padding_waste_frac": round(DEVTIME.padding_waste(), 4),
            "recompiles": REGISTRY.counter("engine_recompiles_total").value,
            "devtime_attributed_s": round(DEVTIME.attributed_s(), 4),
            "steps_per_fetch": round(DEVTIME.steps_per_fetch(), 2),
        }

    def _tick(self) -> bool:
        """One scheduling round; False when fully idle."""
        # the chaos plane's tick stall (what the watchdog's heartbeat
        # detects) and worker death (the driver loop's crash path); off is
        # one attribute read
        if chaos_mod.CHAOS.enabled:
            chaos_mod.CHAOS.tick_fault()
        # queued evacuations run first: the driver owns the device state,
        # and an evacuating worker's ticks move streams out
        worked = self._run_evacuations()
        # the flight ring's time-gated sample (idle ticks sample too)
        FLIGHT.maybe_sample(self._flight_fields)
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
        try_mixed = (self._role != "prefill"
                     and bool(self._prefilling) and bool(self._slots)
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
        elif self._slots and self._role != "prefill":
            # a prefill worker never dispatches decode: its slots are
            # finished prefills awaiting their first token and export
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
            self.last_tick_mono = clock.mono()
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
                REGISTRY.counter("driver_errors").inc()
                self._fail_all("engine error")
                self._state = self.core.init_state()
        self._fail_all("scheduler stopped")
