"""Serving core: paged chunked prefill -> slot activation -> batched decode.

Port of ``EngineCore`` from ``generativeaiexamples_tpu/engine/engine.py``
for a single card: grouped chunked prefill with a fused first-token sample
and slot activation (``prefill_group``); K decode steps per dispatch
(``decode``), each narrow or, with prompt-lookup speculative decoding, a
W-wide verify step (``step_wide``: drafts from the slot's own history,
one widened forward, per-position seeded samples, exact-match acceptance)
at a rung of the acceptance-tuned width ladder (``spec_widths``) and of
the batch-width ladder (``decode_widths``: the full batch and the largest
power of two below it; a narrow rung runs the steps over the first slots
only); and the mixed-phase program (``decode_mixed``), whose first step
also prefills the next chunk of up to ``prefill_group`` prompts as extra
ragged rows of the same forward (``kv_cache.mixed_step``). PyTorch runs
eagerly, so a Python loop takes the place of ``lax.scan`` and the state is
updated in place rather than donated (CUDA graphs are later work).
``warmup`` runs every program once on a throwaway state before traffic.

Sampling draws are JAX's: each slot keeps a raw threefry key
(``DecodeState.rngs``, ``PRNGKey(seed)``), and token ``n`` of a request
draws ``categorical(fold_in(key, n))`` (``ops/threefry.py``). Every
sampling call (a narrow or widened step, a mixed dispatch's step, the
fused first tokens) is one ``ops.sampling.sample_slots`` call: on CUDA one
launch of the sampling kernel, which folds the keys, reads each slot's
live settings, finds the top-k/top-p cutoffs, draws and returns the
logprob; on the CPU its plain version. ``sample_calls`` counts them. No
step reads a device value back: host arrays go up through pinned buffers
without a stream sync, and results come back only through
:class:`HostCopy`, which the scheduler's in-flight queue holds.
``decode``/``decode_mixed`` call an optional ``between_steps`` hook on the
host after each step's launches, where the scheduler streams first
tokens whose fetch has landed.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request it raises. ``attention="auto"``
resolves to the hand-written kernels on CUDA and to the plain PyTorch
path on the CPU; ``"kernel"`` on the CPU raises. ``mixed_phase_dispatch=
"auto"`` resolves on for a CUDA device and off on the CPU.

``kv_quant="int8"`` serves from an int8 KV pool with per-token-per-head
scales (half the pool's bytes, so more slots fit on a card); its decode
attention is the int8 instance of the ragged paged kernel.

``prefix_cache="on"`` (the default) hands the scheduler a refcounting
``CachingAllocator`` (``engine/prefix_cache.py``), so identical
page-aligned prompt prefixes share pages; a cache-hit admission starts its
prefill at the covered offset and ``seed_history`` writes the skipped
tokens into the drafting history.

``quant="int8"`` serves per-channel weight-only int8 weights
(``ops/quant.py``): matrices not already int8 are quantized at load, one
at a time, and every projection and the unembedding run through the
hand-written W8A16 GEMM on the card (``ops/cuda/quant.py``). ``n_params``
and ``param_bytes`` (one byte a parameter at int8) are taken before
quantization, as the reference's.

Constrained decoding (the reference's grammar stack): compiled grammars
(``engine/grammar.py``) live in a flat device stack of ``GRAM_SLOTS``
slots of ``GRAM_STATES`` DFA states (:class:`GrammarStack`), each slot's
DFA state rides ``DecodeState.gram_state``, and a ``use_grammar`` call
masks each constrained row's draw by the ``grammar_mask`` kernel's
bitmask and advances the state inside the sampling launch; under
speculation a constrained slot's drafts are voided and only position 0 is
masked. ``want_top`` adds ``TOP_LP`` id rows and ``TOP_LP`` logprob rows
of each position's raw logits to the packed block, as the reference's.

Per-request multi-LoRA (the reference's stacked adapter serving):
:meth:`EngineCore.register_adapter` installs a trained adapter tree
(``train/lora.py`` layout) into one of ``max_adapters`` resident slots
(slot 0 is the all-zero base model), each slot's adapter index rides
``DecodeState.adapter_ix`` (and its host copy ``adapter_host``), and
every projection of a forward adds its rows' low-rank updates
(``ops/lora.py``: one ``lora_apply_group`` call on the card for the
projections that read one input, 4 a layer at seven targets). A pass in
which no row has an adapter makes no call: the host knows each row's
slot. ``lora_passes`` counts the passes that made them. An ``adapters=``
tree given to the constructor is global instead: every row takes it, and
no adapter can be registered. While any adapter tree is resident the
mixed-phase dispatch is off, as there (``mixed_step`` runs base weights
only).

Multi-step decode (the reference's ``decode_multi``): with
``decode_multistep`` M set, :meth:`EngineCore.decode_multi` runs K·M plain
decode steps (K = ``decode_steps_per_dispatch``, M a rung of ``multi_ms``)
as one dispatch whose packed block the host fetches once. Each step is
:meth:`EngineCore._step` over the full batch with ``active`` masked by a
``running`` mask: a slot that draws a token of the stop-suspect table
(``_stop_suspect``, from ``ops.sampling.stop_suspect_mask``) while it
carries a stop string is paused for the rest of the dispatch, keeping its
activation, key counter and length, so it resumes token-identically. The
reference skips the forward once every slot is done or paused
(``lax.cond``); here every step runs, since testing the mask would read
the device back, and a paused or done slot is masked exactly as an
inactive one. ``warmup`` runs every depth rung up to ``decode_steps_max``
and every M rung.

KV handoff (the reference's disaggregated roles): ``role`` is
``unified``, ``prefill`` (chunked prefill only; ``warmup`` skips the
decode programs) or ``decode``. :meth:`EngineCore.export_slot_kv` gathers a
slot's pages (``kv_cache.export_pages``) into a payload with the
reference's keys and shapes, device-native by default: its tensors stay on
the card, with the CUDA event recorded behind the gather under
``kv_wire.READY_KEY`` for a host copy made on another thread;
:meth:`EngineCore.validate_handoff` refuses a payload this pool cannot
host, loudly; :meth:`EngineCore.import_slot_kv` scatters one into this
pool's pages in place (``kv_cache.import_pages``) from CUDA or CPU tensors
or numpy arrays (a bf16 one as ``ml_dtypes`` gives it, or as the wire's
``uint16`` words). No page-count bucket: nothing here compiles per shape.

Not ported here: tensor parallelism (ROADMAP A2, A11). Its config knobs
are refused in ``core/config.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core import kv_wire, perfmodel
from generativeaiexamples_tpu_torch.core.config import EngineConfig
from generativeaiexamples_tpu_torch.core.runtime import resolve_device
from generativeaiexamples_tpu_torch.engine import grammar as grammar_mod
from generativeaiexamples_tpu_torch.engine import kv_cache
from generativeaiexamples_tpu_torch.engine.kv_cache import PagedKVCache
from generativeaiexamples_tpu_torch.engine.prefix_cache import CachingAllocator
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import lora as lora_ops
from generativeaiexamples_tpu_torch.ops import quant as quant_ops
from generativeaiexamples_tpu_torch.ops import sampling, threefry
from generativeaiexamples_tpu_torch.ops.cuda import attention as kernels
from generativeaiexamples_tpu_torch.ops.cuda import lora as lora_kernels
from generativeaiexamples_tpu_torch.ops.cuda import quant as quant_kernels
from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
from generativeaiexamples_tpu_torch.ops.speculative import (
    acceptance, draft_lookup)

logger = logging.getLogger(__name__)

# rows of the (fields, steps*W, B) int32 "packed" decode output; logprob
# rows carry float32 bits (bitcast) and unpack_decode_out restores them
_PACKED_FIELDS = ("sampled", "emitted", "done", "hit_eos", "input_tokens",
                  "sampled_lp", "input_lp")
_LP_FIELDS = frozenset({"sampled_lp", "input_lp"})
# top-logprob rows appended past the base block with ``want_top``: TOP_LP
# id rows, then TOP_LP logprob rows (bitcast)
TOP_LP = sampling.TOP_LP
# the grammar stack's geometry: GRAM_SLOTS grammars resident at once, each
# of up to GRAM_STATES DFA states (the reference's)
GRAM_SLOTS = 4
GRAM_STATES = 4096


def spec_ladder(engine_cfg: EngineConfig) -> Tuple[int, Tuple[int, ...]]:
    """(ceiling width, ladder rungs) of speculative decoding: width 1 when
    it is off; one rung of 1 + spec_draft when not adaptive; else 1 + each
    draft of {1, 2, 4, ...} below the ceiling ``spec_draft_max`` (0 = twice
    spec_draft), spec_draft and the ceiling itself."""
    if engine_cfg.spec_decode not in ("on", "off"):
        raise ValueError(f"unknown spec_decode {engine_cfg.spec_decode!r}")
    if engine_cfg.spec_draft < 0:
        raise ValueError(f"spec_draft ({engine_cfg.spec_draft}) must be "
                         ">= 0 (0 disables drafting)")
    if engine_cfg.spec_ngram < 1:
        raise ValueError(f"spec_ngram ({engine_cfg.spec_ngram}) must be >= 1")
    adaptive = (engine_cfg.spec_adaptive or "on").strip().lower()
    if adaptive not in ("on", "off"):
        raise ValueError(f"engine.spec_adaptive must be on|off, "
                         f"got {adaptive!r}")
    dmax = engine_cfg.spec_draft_max or 0
    if dmax < 0:
        raise ValueError(f"spec_draft_max ({dmax}) must be >= 0")
    draft = engine_cfg.spec_draft
    if engine_cfg.spec_decode != "on" or draft == 0:
        return 1, (1,)
    if adaptive == "off":
        return 1 + draft, (1 + draft,)
    dmax = dmax or 2 * draft
    if dmax < draft:
        raise ValueError(f"spec_draft_max ({dmax}) must cover spec_draft "
                         f"({draft})")
    drafts, d = {draft, dmax}, 1
    while d < dmax:
        drafts.add(d)
        d *= 2
    return 1 + dmax, tuple(sorted(1 + d for d in drafts))


def multi_ladder(engine_cfg: EngineConfig) -> Tuple[int, ...]:
    """The multi-step decode's M rungs (2, 4, ..., M) for ``decode_multistep``
    M, or () when it is 0 or 1 (1 is the per-step path already). The bare
    env ``APP_DECODE_MULTISTEP`` overrides the field."""
    raw = (os.environ.get("APP_DECODE_MULTISTEP", "").strip()
           or str(engine_cfg.decode_multistep or 0))
    try:
        mm = int(raw)
    except ValueError:
        raise ValueError(f"APP_DECODE_MULTISTEP must be an integer (0 = off, "
                         f"else a power of two >= 2), got {raw!r}")
    if mm < 0 or (mm > 1 and mm & (mm - 1)):
        raise ValueError(f"decode_multistep ({mm}) must be 0 (off) or a "
                         f"power of two >= 2")
    rungs, r = [], 2
    while r <= mm:
        rungs.append(r)
        r *= 2
    return tuple(rungs)


def depth_ladder(engine_cfg: EngineConfig) -> Tuple[int, ...]:
    """The depths a per-step dispatch may take: powers of two from
    ``decode_steps_per_dispatch`` to ``decode_steps_max`` (0: the base
    only)."""
    base = engine_cfg.decode_steps_per_dispatch
    rungs, k = [], base
    while k <= max(engine_cfg.decode_steps_max, base):
        rungs.append(k)
        k *= 2
    return tuple(rungs)


@dataclasses.dataclass(frozen=True)
class PrefillItem:
    """One prompt's next chunk, for a grouped prefill dispatch or a mixed
    one. ``is_last`` items also get the fused first-token sample and slot
    activation."""

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
    gram_state: int = 0           # flat DFA state of the first token (0: none)
    seed: int = 0                 # per-request sampling seed
    adapter_ix: int = 0           # resident LoRA slot (0 = base model)


def unpack_decode_out(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """Split a host copy of ``out["packed"]`` back into named arrays;
    trailing rows (a ``want_top`` dispatch) become ``top_ids`` and
    ``top_lps`` of shape (TOP_LP, steps * W, B)."""
    out = {k: packed[i] for i, k in enumerate(_PACKED_FIELDS)}
    for k in _LP_FIELDS:
        out[k] = np.ascontiguousarray(out[k]).view(np.float32)
    base = len(_PACKED_FIELDS)
    if packed.shape[0] > base:
        out["top_ids"] = packed[base:base + TOP_LP]
        out["top_lps"] = np.ascontiguousarray(
            packed[base + TOP_LP:base + 2 * TOP_LP]).view(np.float32)
    return out


def bits_to_f32(x) -> float:
    """A float32 carried as its int32 bits, as a Python float."""
    return float(np.int32(x).view(np.float32))


class GrammarStack:
    """The resident grammars (``engine/grammar.py`` ``Grammar``) as one flat
    DFA: slot g's local state s is flat state ``g * GRAM_STATES + s``,
    local 0
    (reject) is flat 0, and each slot's row 0 stays zero, so state 0 is the
    absorbing reject state of every slot. ``register`` installs a grammar
    (once per key) and returns its flat start state, evicting an unpinned
    grammar when every slot is taken; ``tensors`` are the (S, 256) table,
    (S,) accept and (S,) dist on the device, uploaded after each
    registration. The reference's ``register_grammar``/``walk_grammar``
    stack, held apart from the engine so a kernel check can build one."""

    def __init__(self, device, upload=None) -> None:
        self._upload = upload or (lambda a: torch.as_tensor(a).to(device))
        self._slot: Dict[str, int] = {}       # key -> slot
        self._start: Dict[str, int] = {}      # key -> flat start state
        self._dfa: Dict[str, Any] = {}
        n = GRAM_SLOTS * GRAM_STATES
        self.table = np.zeros((n, 256), np.int32)
        self.accept = np.zeros((n,), np.bool_)
        self.dist = np.full((n,), grammar_mod.DIST_INF, np.int32)
        self._dev: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def keys(self) -> List[str]:
        return list(self._slot)

    def register(self, grammar, active_keys=()) -> int:
        """The grammar's flat start state, installing it if it is not
        resident. ``active_keys`` (grammars of requests in flight) are
        never evicted. Raises ``UnsupportedSchema`` when the DFA exceeds a
        slot or every slot is pinned."""
        if grammar.key in self._slot:
            return self._start[grammar.key]
        dfa = grammar.dfa
        S = GRAM_STATES
        if dfa.n_states > S:
            raise grammar_mod.UnsupportedSchema(
                f"grammar needs {dfa.n_states} DFA states; engine stack "
                f"holds {S} per slot")
        if len(self._slot) >= GRAM_SLOTS:
            evictable = [k for k in self._slot if k not in active_keys]
            if not evictable:
                raise grammar_mod.UnsupportedSchema(
                    f"all {GRAM_SLOTS} grammar slots pinned by active "
                    f"requests")
            victim = evictable[0]
            del self._slot[victim], self._start[victim], self._dfa[victim]
        g = next(i for i in range(GRAM_SLOTS)
                 if i not in self._slot.values())
        flat = np.where(dfa.table > 0, g * S + dfa.table, 0).astype(np.int32)
        self.table[g * S:g * S + dfa.n_states] = flat
        self.table[g * S] = 0
        self.accept[g * S:g * S + dfa.n_states] = dfa.accept
        self.dist[g * S:g * S + dfa.n_states] = dfa.dist
        self._dev = None
        self._slot[grammar.key] = g
        self._start[grammar.key] = g * S + dfa.start
        self._dfa[grammar.key] = dfa
        return self._start[grammar.key]

    def walk(self, grammar, token_ids, tok_bytes: np.ndarray,
             tok_lens: np.ndarray, active_keys=(), prefix: bytes = b"") -> int:
        """The flat state after ``prefix`` and then ``token_ids`` from the
        grammar's start (a resume re-walks what it emitted); 0 when the
        walk rejects."""
        start = self.register(grammar, active_keys)
        dfa = self._dfa[grammar.key]
        g = self._slot[grammar.key]
        s = start - g * GRAM_STATES
        for b in prefix:
            s = int(dfa.table[s, int(b)])
            if s == 0:
                return 0
        for t in token_ids:
            n = int(tok_lens[t])
            if n <= 0:
                return 0
            for b in tok_bytes[t, :n]:
                s = int(dfa.table[s, int(b)])
                if s == 0:
                    return 0
        return g * GRAM_STATES + s

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(table, accept, dist) on the device, as last registered."""
        if self._dev is None:
            self._dev = (self._upload(self.table), self._upload(self.accept),
                         self._upload(self.dist))
        return self._dev


class HostCopy:
    """A device tensor on its way to the host: a ``non_blocking`` copy into
    a pinned buffer of its own, then an event recorded on the serving
    stream behind it. On the CPU it is the tensor itself, ready at once.
    The tensor must be one no later launch writes (a fresh stack)."""

    def __init__(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def done(self) -> bool:
        """The copy has landed (never blocks)."""
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        """The host array, waiting for the copy if it is still running."""
        return self.tensor().numpy()

    def tensor(self) -> torch.Tensor:
        """The host tensor (pinned on CUDA; any dtype, bf16 too), waiting
        for the copy if it is still running."""
        if self._event is not None:
            self._event.synchronize()
        return self._host


@dataclasses.dataclass
class DecodeState:
    """Fixed-capacity slot batch for continuous decoding; device tensors
    are (B,) and updated in place by the engine."""

    cache: PagedKVCache
    tokens: torch.Tensor        # (B,) i32 last token per slot
    active: torch.Tensor        # (B,) bool
    generated: torch.Tensor     # (B,) i32 tokens generated so far
    max_gen: torch.Tensor       # (B,) i32 generation budget
    temperature: torch.Tensor   # (B,) f32
    top_k: torch.Tensor         # (B,) i32
    top_p: torch.Tensor         # (B,) f32
    rngs: torch.Tensor          # (B, 2) i64 raw threefry key, PRNGKey(seed)
    last_logprob: torch.Tensor  # (B,) f32 model logprob of tokens[b]
    gram_state: torch.Tensor    # (B,) i32 flat DFA state; <= 0 unconstrained
    adapter_ix: torch.Tensor    # (B,) i32 resident LoRA slot (0 = base)
    # (B, max_seq + 1) i32: each slot's token at each absolute position,
    # valid through index cache.lengths[b] inclusive (the token fed next);
    # written by prefill chunks, activation and decode appends, read by
    # prompt-lookup drafting. Column max_seq is a sink for dropped writes
    # and is never read.
    history: torch.Tensor
    # (B,) i32 on the host: adapter_ix as set, so a pass without adapter
    # rows is known without reading the device
    adapter_host: np.ndarray

    def rows(self, width: int) -> "DecodeState":
        """The first ``width`` slots as views: in-place writes (the pool,
        lengths, history) land in this state; rebound fields are merged
        back by :meth:`merge`."""
        sl = lambda a: a[:width]
        return DecodeState(
            cache=dataclasses.replace(self.cache,
                                      lengths=sl(self.cache.lengths)),
            tokens=sl(self.tokens), active=sl(self.active),
            generated=sl(self.generated), max_gen=sl(self.max_gen),
            temperature=sl(self.temperature), top_k=sl(self.top_k),
            top_p=sl(self.top_p), rngs=sl(self.rngs),
            last_logprob=sl(self.last_logprob),
            gram_state=sl(self.gram_state), adapter_ix=sl(self.adapter_ix),
            history=sl(self.history), adapter_host=sl(self.adapter_host))

    def merge(self, narrow: "DecodeState") -> None:
        """Write a :meth:`rows` view's rebound per-slot fields back."""
        w = narrow.tokens.shape[0]
        for name in ("tokens", "active", "generated", "last_logprob",
                     "gram_state"):
            getattr(self, name)[:w] = getattr(narrow, name)


class EngineCore:
    """Owns the weights and runs the serving passes. Call from one driver
    thread (the scheduler)."""

    def __init__(self, model_cfg: llama.LlamaConfig, engine_cfg: EngineConfig,
                 params: llama.Params, eos_id: int, device=None,
                 adapters: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> None:
        self.device = resolve_device(device)
        role = str(getattr(engine_cfg, "role", "unified")
                   or "unified").strip().lower()
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"APP_ENGINE_ROLE must be unified|prefill|"
                             f"decode, got {role!r}")
        # disaggregated serving: a "prefill" worker runs chunked prefill
        # only and exports finished requests' pages (export_slot_kv); a
        # "decode" worker also imports handed-off pages (import_slot_kv)
        self.role = role
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
        km = engine_cfg.decode_steps_max
        if km and (km < k or km & (km - 1)):
            raise ValueError(
                f"decode_steps_max ({km}) must be a power of two >= "
                f"decode_steps_per_dispatch ({k})")
        # the depth ladder of per-step dispatches, and the M rungs
        # decode_multi takes (() when off); warmup runs every one
        self.decode_depths = depth_ladder(engine_cfg)
        self.multi_ms = multi_ladder(engine_cfg)
        # the device-time ledger's gate (observability/devtime.py): the
        # bare env APP_DEVTIME wins, else engine.devtime; a bad value fails
        # at init. A CUDA device arms the ledger's timing events
        dv = (os.environ.get("APP_DEVTIME", "").strip().lower()
              or str(getattr(engine_cfg, "devtime", "off")
                     or "off").strip().lower())
        if dv not in ("off", "sample", "on"):
            raise ValueError(f"engine.devtime (APP_DEVTIME) must be "
                             f"off|sample|on, got {dv!r}")
        DEVTIME.configure(mode=dv, device=self.device)
        # prompt-lookup speculative decoding: every decode step widens to a
        # rung of the width ladder; spec_width is the ceiling, which sizes
        # the mixed program's q_block and the scheduler's page horizon
        self.spec_width, self.spec_widths = spec_ladder(engine_cfg)
        self.max_pages_per_slot = -(-self.max_seq // self.page_size)
        self.num_pages = (engine_cfg.num_pages
                          or self.batch * self.max_pages_per_slot + 1)
        prefix = (engine_cfg.prefix_cache or "on").strip().lower()
        if prefix not in ("on", "off"):
            raise ValueError(f"engine.prefix_cache must be on|off, "
                             f"got {engine_cfg.prefix_cache!r}")
        self.prefix_caching = prefix == "on"
        # final-chunk buckets: page-aligned powers of two up to the chunk
        # (the scheduler's cache-hit geometry cap reads them)
        buckets, b = [], self.page_size
        while b < self.chunk:
            buckets.append(b)
            b *= 2
        buckets.append(self.chunk)
        self.buckets = tuple(buckets)
        self.prefill_group_max = max(1, engine_cfg.prefill_group)
        # grouped/mixed chunk-count buckets: powers of two up to the group
        gb, g = [], 1
        while g < self.prefill_group_max:
            gb.append(g)
            g *= 2
        gb.append(self.prefill_group_max)
        self.group_buckets = tuple(gb)
        # batch-width ladder of pure-decode dispatches: the full batch and
        # the largest power of two below it (two rungs bound the warmup
        # grid); the scheduler allocates slots lowest id first, so the live
        # set compacts into the narrow rung
        ladder = str(engine_cfg.decode_width_ladder).strip().lower()
        if ladder == "off" or self.batch <= 2:
            self.decode_widths = (self.batch,)
        else:
            p = 1
            while p * 2 < self.batch:
                p *= 2
            self.decode_widths = tuple(sorted({self.batch, p}))

        # ---- kernel-support gate: a config the kernels refuse must fail
        # here, never at the first dispatch
        HD = self.model_cfg.head_dim
        G = self.model_cfg.n_heads // self.model_cfg.n_kv_heads
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
            # rows of more than qg_max(HD) query vectors are cut into
            # query tiles (kernels.query_tile); only the group must fit a
            # block
            if G > kernels.qg_max(HD):
                raise ValueError(
                    f"GQA group {G} exceeds the ragged kernel's "
                    f"{kernels.qg_max(HD)} query vectors a block at "
                    f"head_dim={HD}")

        # ---- mixed-phase dispatch gate, resolved once and loudly; the
        # bare env APP_MIXED_PHASE_DISPATCH overrides the config field
        mixed = (os.environ.get("APP_MIXED_PHASE_DISPATCH", "").strip().lower()
                 or (engine_cfg.mixed_phase_dispatch or "auto").strip().lower())
        if mixed not in ("on", "off", "auto"):
            raise ValueError(f"APP_MIXED_PHASE_DISPATCH must be on|off|auto, "
                             f"got {mixed!r}")
        # ragged rows carry q_block queries; a decode slot's whole verify
        # width must fit one row
        qb = 8
        while qb < self.spec_width:
            qb *= 2
        self._mixed_q_block = qb
        reasons = []
        if self.chunk % qb:
            reasons.append(f"prefill_chunk ({self.chunk}) not a multiple of "
                           f"the ragged q_block ({qb})")
        if attn == "kernel" and not kernels.ragged_paged_supported(
                self.page_size, HD, qb):
            reasons.append(f"page_size={self.page_size} / head_dim={HD} "
                           f"outside the ragged kernel's limits")
        if mixed == "on" and reasons:
            raise ValueError("APP_MIXED_PHASE_DISPATCH=on but the mixed "
                             "program cannot serve this config: "
                             + "; ".join(reasons))
        if mixed == "auto":
            mixed = ("on" if not reasons and self.device.type == "cuda"
                     else "off")
            if mixed == "off":
                logger.info("mixed-phase dispatch: auto resolved off (%s)",
                            "; ".join(reasons) or
                            f"device {self.device.type!r} is not cuda")
        self._mixed = mixed == "on"

        # ---- int8 weights (ops/quant.py), as the reference's load path:
        # the parameter count and the weight bytes a decode step streams are
        # taken before quantization, which then consumes the caller's dict
        # one leaf at a time (the engine owns the weights from here on)
        self.quant = (engine_cfg.quant or "none").strip().lower() or "none"
        if self.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {engine_cfg.quant!r} "
                             f"(engine.quant); expected 'none' or 'int8'")
        self.n_params = quant_ops.n_params(params)
        self.param_bytes = quant_ops.weight_bytes(
            self.n_params, self.quant, self.model_cfg.torch_dtype.itemsize)
        # the analytic envelope on this card (core/perfmodel.py): the
        # devtime ledger's live MFU / HBM gauges, the host tier's pricing
        # and the watchdog's dispatch bound read it; no peaks on the CPU
        peak_flops, peak_bw = perfmodel.chip_peaks(self.device)
        self.perf_model = perfmodel.PerfModel(
            n_params=self.n_params, param_bytes=float(self.param_bytes),
            peak_flops=peak_flops, peak_bw=peak_bw)
        if self.quant == "int8":
            params = quant_ops.quantize_params(params, donate=True)
            logger.info("serving with int8 weight-only quantization")
        if self.device.type == "cuda":
            dt = self.model_cfg.torch_dtype
            for w in quant_ops.weights(params):
                if (isinstance(w, quant_ops.QTensor)
                        and not quant_kernels.w8a16_supported(w.shape[1], dt)):
                    raise ValueError(f"w8a16_gemm kernel does not take "
                                     f"in_features={w.shape[1]} with {dt} "
                                     f"activations")
        self.params = params
        # sampling calls made (each one sample_slots launch on the card)
        self.sample_calls = 0
        # constrained decoding: the grammar stack, and the vocabulary's
        # byte table (ensure_token_bytes) on the host and on the device:
        # int32 for the sampler's advance, uint8 bytes and int8 lengths
        # for the mask
        self.grammars = GrammarStack(self.device, upload=self._up)
        self._tok_bytes: Optional[torch.Tensor] = None
        self._tok_lens: Optional[torch.Tensor] = None
        self._tok_bytes8: Optional[torch.Tensor] = None
        self._tok_lens8: Optional[torch.Tensor] = None
        self._tok_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # the multi-step decode's stop-suspect tables, by stop-byte set
        self._suspect_cache: Dict[frozenset, torch.Tensor] = {}
        # LoRA: a global tree (every row) given here, or the stacked slots
        # register_adapter fills ({target: {"a": (L, N, r, in), "b": (L, N,
        # out, r)}} in the model dtype); the names map to slots, and each
        # registered tree's digest makes a re-registration idempotent
        self.adapters: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._adapter_names: Dict[str, int] = {"": 0}
        self._adapters_stacked = False
        self._adapter_digests: Dict[str, str] = {}
        # the resident tree as each layer's groups (ops.lora.prepare), and
        # the forward passes that made the update
        self._lora_layers: Optional[lora_ops.LoraLayers] = None
        self.lora_passes = 0
        if adapters is not None:
            self.adapters = {target: {"a": a, "b": b} for target, a, b in
                             self._adapter_leaves(adapters, "global")}
            self._lora_layers = lora_ops.prepare(self.adapters,
                                                 model_cfg.n_layers)

    @property
    def mixed_row_queries(self) -> int:
        """Padded query positions per decode slot inside a mixed dispatch:
        the ragged kernel pads every slot's row to q_block, the plain path
        keeps the raw speculative width."""
        if self.model_cfg.attn_impl == "kernel":
            return self._mixed_q_block
        return self.spec_width

    @property
    def mixed_supported(self) -> bool:
        """Mixed-phase dispatch (one forward = decode step + prefill
        chunks, ``kv_cache.mixed_step``) is on for this engine: the
        init-time gate held and no adapter tree is resident (the fused
        forward runs base weights for every row, so the first
        ``register_adapter`` turns it off and the scheduler takes the
        two-dispatch path)."""
        return self._mixed and self.adapters is None

    @property
    def lora_groups(self) -> int:
        """LoRA calls a layer makes in a pass with adapter rows."""
        return (lora_ops.group_count(self._lora_layers)
                if self._lora_layers is not None else 0)

    def _lora(self, adapter_ix: Optional[torch.Tensor],
              host_ix: Optional[np.ndarray]) -> Dict[str, Any]:
        """The paged passes' adapter arguments: the resident tree's groups
        and, when it is stacked, the rows' slots (``adapter_ix``, whose
        host copy is ``host_ix``). None when no row has an adapter: the
        pass then makes no call (rows of slot 0 are never written)."""
        if self._lora_layers is None or (self._adapters_stacked
                                         and not host_ix.any()):
            return dict(adapters=None, adapter_ix=None)
        self.lora_passes += 1
        return dict(adapters=self._lora_layers,
                    adapter_ix=adapter_ix if self._adapters_stacked else None)

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
            rngs=torch.zeros((B, 2), dtype=torch.int64, device=dev),
            last_logprob=z(torch.float32), gram_state=z(torch.int32),
            adapter_ix=z(torch.int32),
            history=torch.zeros((B, self.max_seq + 1), dtype=torch.int32,
                                device=dev),
            adapter_host=np.zeros((B,), np.int32))

    def new_allocator(self):
        """Page allocator for the pool: with ``prefix_cache="on"`` a
        refcounting :class:`CachingAllocator`, so the scheduler shares
        identical page-aligned prompt prefixes across requests."""
        if self.prefix_caching:
            return CachingAllocator(self.num_pages, self.page_size)
        return kv_cache.PageAllocator(self.num_pages)

    @property
    def row_tokens(self) -> int:
        """Token positions one block-table row addresses."""
        return self.max_pages_per_slot * self.page_size

    def _check_spans(self, items: Sequence[PrefillItem], C: int) -> None:
        """Refuse a chunk whose C padded positions from its start pass its
        block-table row: its page gather would index past the row (on the
        card a device-side assert), and clamping it back, as a dynamic
        slice does, writes the chunk over an earlier, possibly shared,
        page. The scheduler never issues one."""
        for it in items:
            if it.start_pos + C > self.row_tokens:
                raise ValueError(
                    f"chunk at {it.start_pos} padded to {C} positions passes "
                    f"its block-table row of {self.row_tokens}")

    def pages_for(self, n_tokens: int) -> int:
        """Pages so positions 0..n_tokens (inclusive next write) fit."""
        return n_tokens // self.page_size + 1

    def put_table(self, table: np.ndarray) -> torch.Tensor:
        """Host block table -> a fresh device tensor (the host array may
        change at once: the upload reads a copy)."""
        return self._up(np.asarray(table, np.int32))

    def _up(self, a) -> torch.Tensor:
        """A host array (or a CPU tensor) as a fresh tensor on the device.
        On CUDA it goes through a pinned copy with ``non_blocking``, which
        queues on the serving stream instead of waiting for it (a pageable
        upload would sync the stream and drain every dispatch in flight);
        the caching host allocator keeps the pinned block until the copy
        has run."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t.clone() if t.device.type == "cpu" else t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sample_slots(self, *args, **opts):
        """One sampling call (``ops.sampling.sample_slots``'s arguments):
        (R,) tokens, logprobs and the options' outputs, counted in
        ``sample_calls``."""
        self.sample_calls += 1
        return sampling.sample_slots(*args, **opts)

    # ---------------------------------------------------- constrained decoding

    def ensure_token_bytes(self, tokenizer) -> None:
        """Build and upload the vocabulary's byte table once (the grammar's
        prerequisite), padded to the model's vocabulary: ids past the
        tokenizer's are never allowed under a grammar. One host table
        feeds both device copies: int32 (the sampler's advance) and uint8
        bytes with int8 lengths (``grammar_mask``, which reads each
        entry's 16 bytes as one vector)."""
        if self._tok_bytes is not None:
            return
        tb, tl = grammar_mod.token_byte_table(tokenizer)
        V = self.model_cfg.vocab_size
        if V > tb.shape[0]:
            pad = V - tb.shape[0]
            tb = np.concatenate([tb, np.zeros((pad, tb.shape[1]), np.int32)])
            tl = np.concatenate([tl, np.full((pad,), -1, np.int32)])
        elif V < tb.shape[0]:
            tb, tl = tb[:V], tl[:V]
        self._tok_host = (tb, tl)
        self._suspect_cache.clear()    # tables built without the bytes
        self._tok_bytes = self._up(np.ascontiguousarray(tb))
        self._tok_lens = self._up(np.ascontiguousarray(tl))
        self._tok_bytes8, self._tok_lens8 = (
            self._up(t) for t in sampling.mask_byte_table(tb, tl))

    def register_grammar(self, grammar, active_keys=()) -> int:
        """Install a compiled grammar in the stack; its flat start state
        (what a PrefillItem carries). ``active_keys`` are never evicted;
        raises ``UnsupportedSchema`` past the stack's geometry or with every
        slot pinned."""
        return self.grammars.register(grammar, active_keys)

    def walk_grammar(self, grammar, token_ids, active_keys=(),
                     prefix: bytes = b"") -> int:
        """The flat state after ``prefix`` bytes and then ``token_ids``
        from the grammar's start; 0 when the walk rejects."""
        tb, tl = self._tok_host
        return self.grammars.walk(grammar, token_ids, tb, tl, active_keys,
                                  prefix)

    def _sample_opts(self, row_states: Optional[torch.Tensor], row_budget,
                     slot_states, use_grammar: bool,
                     want_top: bool) -> Dict[str, Any]:
        """``sample_slots``' options for one call: with ``use_grammar`` the
        ``grammar_mask`` bitmask of the rows' states and budgets, those
        states (rows <= 0 skip the mask) and the advance of the slots'
        states; with ``want_top`` the top rows."""
        opts: Dict[str, Any] = {}
        if use_grammar:
            table, accept, dist = self.grammars.tensors()
            opts["allowed"] = sampling.grammar_mask(
                row_states, row_budget, self.eos_id, table, accept, dist,
                self._tok_bytes8, self._tok_lens8)
            opts["mask_states"] = row_states
            opts["grammar"] = (slot_states, table, self._tok_bytes,
                               self._tok_lens)
        if want_top:
            opts["want_top"] = True
        return opts

    # ---------------------------------------------------------------- prefill

    def _write_chunk_history(self, state: DecodeState,
                             items: Sequence[PrefillItem]) -> None:
        """Every item's chunk tokens into its slot's history row, in one
        indexed write built on the host."""
        n = [len(it.chunk_ids) for it in items]
        if not sum(n):
            return
        rows = np.repeat([it.slot for it in items], n)
        cols = np.concatenate([it.start_pos + np.arange(k)
                               for it, k in zip(items, n)])
        vals = np.concatenate([np.asarray(it.chunk_ids, np.int32)
                               for it in items])
        state.history[self._up(rows.astype(np.int64)),
                      self._up(cols.astype(np.int64))] = self._up(vals)

    def _activate_rows(self, state: DecodeState, logits: torch.Tensor,
                       items: Sequence[PrefillItem]) -> torch.Tensor:
        """Fused first-token sample for each item's last-position logits
        (G, V); ``is_last`` rows activate their slot with it, and the token
        enters history at the prompt's end. The slot's key is
        ``PRNGKey(seed)``, and the first token draws under
        ``fold_in(key, generated - 1)``, continuing the request's stream
        across a preemption's resume; rows that are not ``is_last`` draw
        greedily (their token is not used). Returns the (G,) samples, valid
        for is_last rows."""
        last = np.array([it.is_last for it in items], np.bool_)
        temperature = np.array([it.temperature for it in items], np.float32)
        top_k = np.array([it.top_k for it in items], np.int32)
        top_p = np.array([it.top_p for it in items], np.float32)
        seeds = np.array([it.seed for it in items], np.int64)
        generated = np.array([it.generated for it in items], np.int32)
        gram = np.array([it.gram_state if it.is_last else 0 for it in items],
                        np.int32)
        t = self._up
        keys = t(threefry.prng_key(torch.from_numpy(seeds)))
        temp_dev, top_k_dev, top_p_dev = t(temperature), t(top_k), t(top_p)
        # a grammared final samples its first token under its DFA state
        # with the budget max_gen - generated (the reference's group tail)
        use_grammar = bool((gram > 0).any())
        gram_dev = t(gram) if use_grammar else None
        opts = (self._sample_opts(
            gram_dev, t(np.array([it.max_gen - it.generated for it in items],
                                 np.int32)), gram_dev, True, False)
            if use_grammar else {})
        toks, lps, extra = self._sample_slots(
            keys, t(generated - 1), 1, logits, temp_dev, top_k_dev,
            top_p_dev, t(last), **opts)
        rows = np.flatnonzero(last)
        if not len(rows):
            return toks
        slots = np.array([items[i].slot for i in rows], np.int64)
        ix = self._up(rows.astype(np.int64))
        sl = self._up(slots)
        gen = self._up(generated[rows].astype(np.int32))
        mx = self._up(np.array([items[i].max_gen for i in rows], np.int32))
        col = self._up(np.array([min(items[i].start_pos
                                     + len(items[i].chunk_ids),
                                     self.max_seq - 1) for i in rows],
                                np.int64))
        state.tokens[sl] = toks[ix]
        state.active[sl] = (toks[ix] != self.eos_id) & (gen < mx)
        state.generated[sl] = gen
        state.max_gen[sl] = mx
        state.temperature[sl] = temp_dev[ix]
        state.top_k[sl] = top_k_dev[ix]
        state.top_p[sl] = top_p_dev[ix]
        state.rngs[sl] = keys[ix]
        state.last_logprob[sl] = lps[ix]
        # activation sets (or clears) the slot's DFA state
        state.gram_state[sl] = (extra["next_state"][ix] if use_grammar
                                else torch.zeros_like(sl, dtype=torch.int32))
        if self._adapters_stacked:
            # the slot's adapter from its first token on (0: base)
            ixs = np.array([items[i].adapter_ix for i in rows], np.int32)
            state.adapter_ix[sl] = self._up(ixs)
            state.adapter_host[slots] = ixs
        state.history[sl, col] = toks[ix]
        return toks

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
        self._check_spans(items, C)
        self._check_grammar(any(it.gram_state > 0 for it in items))
        tokens = np.zeros((G, C), np.int32)
        page_rows = np.zeros((G, self.max_pages_per_slot), np.int32)
        start_pos = np.zeros((G,), np.int32)
        chunk_len = np.zeros((G,), np.int32)
        for i, it in enumerate(items):
            n = len(it.chunk_ids)
            tokens[i, :n] = it.chunk_ids
            page_rows[i] = it.page_row
            start_pos[i] = it.start_pos
            chunk_len[i] = n
        t = self._up
        ixs = np.array([it.adapter_ix for it in items], np.int32)
        lora = self._lora(t(ixs) if self._adapters_stacked and ixs.any()
                          else None, ixs)
        logits = kv_cache.prefill_chunks(
            self.params, self.model_cfg, t(tokens), state.cache,
            t(page_rows), t(self._length_slots(items, G)), t(start_pos),
            t(chunk_len), self.num_pages, **lora)
        self._write_chunk_history(state, items)
        return state, self._activate_rows(state, logits, items)

    def _length_slots(self, items: Sequence[PrefillItem], G: int
                      ) -> np.ndarray:
        """(G,) slots for the lengths update: only a slot's newest row
        keeps its id; the others, and padding rows, carry the batch size
        (dropped)."""
        slots = np.full((G,), self.batch, np.int32)
        for slot, i in {it.slot: i for i, it in enumerate(items)}.items():
            slots[i] = slot
        return slots

    # ----------------------------------------------------------------- decode

    def _sample(self, state: DecodeState, logits: torch.Tensor, W: int,
                use_grammar: bool = False, want_top: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """Tokens and logprobs of a step's (B * W, V) logits in one
        sampling call, row (b, w) under ``fold_in(rngs[b], generated[b] +
        w)``, the reference's keys for a narrow (W = 1) and a widened step,
        with slot b's live settings (an inactive slot greedy). With
        ``use_grammar`` each slot's position 0 draws under its DFA state,
        with the budget it has left after that token, and the state
        advances; rows w > 0 are unconstrained. ``want_top``: the top rows
        of every position."""
        opts = {}
        if use_grammar or want_top:
            B = state.gram_state.shape[0]
            rows = state.gram_state
            budget = state.max_gen - state.generated - 1
            if W > 1:
                rows = torch.cat([rows[:, None], rows.new_zeros((B, W - 1))],
                                 dim=1).reshape(B * W)
                budget = budget.repeat_interleave(W)
            opts = self._sample_opts(rows, budget, state.gram_state,
                                     use_grammar, want_top)
        return self._sample_slots(
            state.rngs, state.generated, W, logits, state.temperature,
            state.top_k, state.top_p, state.active, **opts)

    def _step(self, state: DecodeState, page_table: torch.Tensor,
              forward: Optional[Callable] = None, use_grammar: bool = False,
              want_top: bool = False) -> Dict[str, torch.Tensor]:
        """One narrow decode step over every slot (``step_narrow`` there).
        ``forward(tokens) -> (B, V)`` replaces the model call and advances
        every slot's length by one, as ``kv_cache.decode_step`` does.
        Out arrays are (1, B), the top rows (1, B, TOP_LP)."""
        cache = state.cache
        if forward is None:
            forward = lambda toks: kv_cache.decode_step(
                self.params, self.model_cfg, toks, cache, page_table,
                state.active, self.num_pages,
                **self._lora(state.adapter_ix, state.adapter_host))
        prev_len = cache.lengths.clone()
        logits = forward(state.tokens)
        active = state.active
        sampled, lp, extra = self._sample(state, logits, 1, use_grammar,
                                          want_top)
        generated = state.generated + active.to(torch.int32)
        hit_eos = sampled == self.eos_id
        done = active & (hit_eos | (generated >= state.max_gen)
                         | (cache.lengths >= self.max_seq - 1))
        # inactive slots keep their lengths, so their positions stay put
        cache.lengths.copy_(torch.where(active, cache.lengths, prev_len))
        cols = torch.where(active & (cache.lengths < self.max_seq),
                           cache.lengths, self.max_seq).long()
        state.history.scatter_(1, cols[:, None], sampled[:, None])
        # state.tokens/active/last_logprob are rebound below, never written
        # in place, so the step's inputs can ride out without copies
        out = {"sampled": sampled, "emitted": active, "done": done,
               "hit_eos": hit_eos, "input_tokens": state.tokens,
               "sampled_lp": lp, "input_lp": state.last_logprob}
        if want_top:
            out["top_ids"], out["top_lps"] = extra["top_ids"], extra["top_lps"]
        state.tokens = torch.where(active, sampled, state.tokens)
        state.last_logprob = torch.where(active, lp, state.last_logprob)
        if use_grammar:
            state.gram_state = extra["next_state"]
        state.generated = generated
        state.active = active & ~done
        return {k: v[None] for k, v in out.items()}

    def _step_wide(self, state: DecodeState, page_table: torch.Tensor,
                   W: int, draft_cap: Optional[torch.Tensor] = None,
                   forward: Optional[Callable] = None,
                   use_grammar: bool = False, want_top: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """One speculative verify step (``step_wide`` there): draft W - 1
        tokens per slot from its history (capped by ``draft_cap``), run one
        W-wide forward (``forward(inputs (B, W)) -> (B, W, V)``, lengths
        unchanged), sample position w under the slot's key folded with
        ``generated + w``, accept the longest matching prefix, clamp it to
        pages actually covered, the budget and the capacity, and cut it
        after an EOS. A constrained slot (``use_grammar``, state > 0)
        drafts nothing and draws position 0 under its DFA. Out arrays are
        (W, B), the top rows (W, B, TOP_LP)."""
        B, dev = state.tokens.shape[0], self.device
        cache = state.cache
        if forward is None:
            forward = lambda inputs: kv_cache.decode_step_wide(
                self.params, self.model_cfg, inputs, cache, page_table,
                state.active, self.num_pages,
                **self._lora(state.adapter_ix, state.adapter_host))
        L = cache.lengths.to(torch.int64)
        draft, dlen = draft_lookup(state.history[:, :self.max_seq], L, W - 1,
                                   self.cfg.spec_ngram)
        if draft_cap is not None:
            dlen = torch.minimum(dlen, draft_cap)
        if use_grammar:
            # the DFA advances one sampled token at a time
            dlen = torch.where(state.gram_state > 0, 0, dlen)
        inputs = torch.cat([state.tokens[:, None], draft], dim=1)
        raw = forward(inputs)                                     # (B, W, V)
        active = state.active
        sampled, lp, extra = self._sample(
            state, raw.reshape(B * W, raw.shape[-1]), W, use_grammar,
            want_top)
        lp = lp.reshape(B, W)
        sampled = sampled.reshape(B, W)
        e = acceptance(sampled, draft, dlen).to(torch.int64)      # 1..W
        pos_w = torch.arange(W, device=dev)[None]
        # accepted positions need real pages behind their writes (the
        # scheduler may not have grown the row that far: such writes went
        # to the null page); position L is always covered
        cols = (L[:, None] + pos_w).clamp_max(self.max_seq - 1) // self.page_size
        covered = page_table.to(torch.int64).gather(1, cols) != 0
        lead = torch.cumprod(covered.to(torch.int64), dim=1).sum(dim=1)
        e = torch.minimum(e, lead.clamp_min(1))
        gen0 = state.generated.to(torch.int64)
        e = torch.minimum(e, (state.max_gen.to(torch.int64) - gen0).clamp_min(1))
        e = torch.minimum(e, ((self.max_seq - 1) - L).clamp_min(1))
        is_eos = sampled == self.eos_id
        first_eos = torch.where(is_eos, pos_w, torch.full_like(pos_w, W)
                                ).amin(dim=1)
        e = torch.minimum(e, first_eos + 1)
        emitted_w = active[:, None] & (pos_w < e[:, None])
        generated = (gen0 + torch.where(active, e, 0)).to(torch.int32)
        lengths = torch.where(active, L + e, L)
        last_ix = (e - 1)[:, None]
        last_tok = sampled.gather(1, last_ix)[:, 0]
        last_lp = lp.gather(1, last_ix)[:, 0]
        last_eos = is_eos.gather(1, last_ix)[:, 0]
        done_slot = active & (last_eos | (generated >= state.max_gen)
                              | (lengths >= self.max_seq - 1))
        done_w = emitted_w & (pos_w == last_ix) & done_slot[:, None]
        cache.lengths.copy_(lengths.to(torch.int32))
        h_cols = L[:, None] + 1 + pos_w
        h_cols = torch.where(emitted_w & (h_cols < self.max_seq), h_cols,
                             self.max_seq)
        state.history.scatter_(1, h_cols, sampled)
        out = {"sampled": sampled.T, "emitted": emitted_w.T, "done": done_w.T,
               "hit_eos": is_eos.T, "input_tokens": inputs.T, "sampled_lp": lp.T,
               "input_lp": torch.cat([state.last_logprob[None],
                                      torch.zeros((W - 1, B), device=dev)])}
        if want_top:
            out["top_ids"] = extra["top_ids"].reshape(B, W, TOP_LP
                                                      ).transpose(0, 1)
            out["top_lps"] = extra["top_lps"].reshape(B, W, TOP_LP
                                                      ).transpose(0, 1)
        state.tokens = torch.where(active, last_tok, state.tokens)
        state.last_logprob = torch.where(active, last_lp, state.last_logprob)
        if use_grammar:
            state.gram_state = extra["next_state"]
        state.generated = generated
        state.active = active & ~done_slot
        return out

    def _width(self, spec_width: Optional[int], draft_cap
               ) -> Tuple[int, Optional[torch.Tensor]]:
        W = spec_width or self.spec_widths[-1]
        if W not in self.spec_widths:
            raise ValueError(f"spec_width {W} is not a ladder rung "
                             f"{self.spec_widths}")
        if draft_cap is not None:
            draft_cap = self._up(np.asarray(draft_cap, np.int32))
        return W, draft_cap

    def _run_step(self, state: DecodeState, page_table: torch.Tensor, W: int,
                  draft_cap, forward=None, use_grammar: bool = False,
                  want_top: bool = False) -> Dict[str, torch.Tensor]:
        if W == 1:
            return self._step(state, page_table, forward, use_grammar,
                              want_top)
        return self._step_wide(state, page_table, W, draft_cap, forward,
                               use_grammar, want_top)

    @staticmethod
    def _pack(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
        """Stack the steps' (W, B) arrays into (steps*W, B) micro-rows, and
        every field as int32 (logprobs bitcast) into ``packed`` for one
        device-to-host copy, the top rows (a ``want_top`` dispatch) after
        them as TOP_LP id rows and TOP_LP logprob rows. Every array is a
        fresh tensor, which no later dispatch writes."""
        res: Dict[str, Any] = {k: torch.cat([o[k] for o in outs])
                               for k in _PACKED_FIELDS}
        rows = [res[k].view(torch.int32) if k in _LP_FIELDS
                else res[k].to(torch.int32) for k in _PACKED_FIELDS]
        if "top_ids" in outs[0]:
            for k in ("top_ids", "top_lps"):
                res[k] = torch.cat([o[k] for o in outs])  # (steps*W, B, K)
            rows += list(res["top_ids"].permute(2, 0, 1))
            rows += list(res["top_lps"].permute(2, 0, 1).contiguous()
                         .view(torch.int32))
        res["packed"] = torch.stack(rows)
        return res

    def _steps(self, state: DecodeState, page_table: torch.Tensor, W: int,
               cap, steps: int, between_steps: Optional[Callable[[], None]],
               use_grammar: bool = False, want_top: bool = False
               ) -> List[Dict[str, torch.Tensor]]:
        outs = []
        for _ in range(steps):
            outs.append(self._run_step(state, page_table, W, cap,
                                       use_grammar=use_grammar,
                                       want_top=want_top))
            if between_steps is not None:
                between_steps()
        return outs

    def _check_grammar(self, use_grammar: bool) -> None:
        if use_grammar and self._tok_bytes is None:
            raise ValueError("use_grammar needs the vocabulary's byte table "
                             "(ensure_token_bytes)")

    @torch.no_grad()
    def decode(self, state: DecodeState, page_table: torch.Tensor,
               steps: int = 1, use_grammar: bool = False,
               want_top: bool = False, *, spec_width: Optional[int] = None,
               width: Optional[int] = None, draft_cap=None,
               between_steps: Optional[Callable[[], None]] = None
               ) -> Tuple[DecodeState, Dict[str, Any]]:
        """Run ``steps`` decode steps, each ``spec_width`` wide (a ladder
        rung; default the ceiling) with per-slot draft caps ``draft_cap``
        (B,) (default uncapped), over the first ``width`` slots (a rung of
        ``decode_widths``; default the full batch; the caller keeps every
        live slot below it); ``page_table`` from :meth:`put_table`. Out
        arrays are (steps*W, width) micro-rows, (step, position) in order;
        ``input_tokens`` carries each position's input, and
        ``out["packed"]`` stacks every field as int32 (logprobs bitcast)
        for one device-to-host copy. ``use_grammar`` masks and advances each
        constrained slot (gram_state > 0); ``want_top`` appends the top rows
        to ``packed``. ``between_steps()``, when given, runs on the host
        after each step's launches; it must leave the state alone."""
        W, cap = self._width(spec_width, draft_cap)
        self._check_grammar(use_grammar)
        bw = width or self.batch
        if bw not in self.decode_widths:
            raise ValueError(f"width {bw} is not a ladder rung "
                             f"{self.decode_widths}")
        flags = dict(use_grammar=use_grammar, want_top=want_top)
        if bw == self.batch:
            return state, self._pack(self._steps(state, page_table, W, cap,
                                                 steps, between_steps,
                                                 **flags))
        narrow = state.rows(bw)
        cap = cap[:bw] if cap is not None else None
        res = self._pack(self._steps(narrow, page_table[:bw], W, cap, steps,
                                     between_steps, **flags))
        state.merge(narrow)
        return state, res

    @torch.no_grad()
    def decode_mixed(self, state: DecodeState, page_table: torch.Tensor,
                     steps: int, items: Sequence[PrefillItem],
                     use_grammar: bool = False, want_top: bool = False, *,
                     spec_width: Optional[int] = None, draft_cap=None,
                     between_steps: Optional[Callable[[], None]] = None
                     ) -> Tuple[DecodeState, Dict[str, Any]]:
        """One mixed-phase dispatch (``_mixed_impl`` there): ``steps``
        decode steps whose first forward also prefills one chunk of each
        item (distinct prefilling slots) as ragged rows of ``q_block``
        queries (``kv_cache.mixed_step``). The chunks' lengths and history
        are set after step 0 (their slots stay inactive through the
        steps); ``is_last`` items then sample their first token and
        activate their slot, so they decode from the next dispatch. Chunks
        pad to ``prefill_chunk`` and the group to a ``group_buckets`` size.
        The out block is :meth:`decode`'s at the full batch, plus
        ``first_tokens`` (G,) for the items (valid for is_last ones);
        ``use_grammar``, ``want_top`` and ``between_steps`` as in
        :meth:`decode` (a grammared final samples under its item's
        ``gram_state`` whatever ``use_grammar`` says)."""
        if not self.mixed_supported:
            raise ValueError("mixed-phase dispatch is gated off for this "
                             "engine (APP_MIXED_PHASE_DISPATCH or an "
                             "unsupported config)")
        if not 1 <= len(items) <= self.prefill_group_max:
            raise ValueError(f"{len(items)} chunks; limit is "
                             f"{self.prefill_group_max}")
        if len({it.slot for it in items}) != len(items):
            raise ValueError("a mixed dispatch takes one chunk per slot")
        G = next(b for b in self.group_buckets if len(items) <= b)
        C = self.chunk
        self._check_spans(items, C)
        tokens = np.zeros((G, C), np.int32)
        page_rows = np.zeros((G, self.max_pages_per_slot), np.int32)
        start_pos = np.zeros((G,), np.int32)
        chunk_len = np.zeros((G,), np.int32)
        for i, it in enumerate(items):
            n = len(it.chunk_ids)
            if n > C:
                raise ValueError(f"chunk of {n} tokens exceeds "
                                 f"prefill_chunk ({C})")
            tokens[i, :n] = it.chunk_ids
            page_rows[i] = it.page_row
            start_pos[i] = it.start_pos
            chunk_len[i] = n
        t = self._up
        W, cap = self._width(spec_width, draft_cap)
        self._check_grammar(use_grammar
                            or any(it.gram_state > 0 for it in items))
        flags = dict(use_grammar=use_grammar, want_top=want_top)
        cache = state.cache
        ch_args = (t(tokens), t(page_rows), t(start_pos), t(chunk_len))
        cell: Dict[str, torch.Tensor] = {}

        def forward(inputs: torch.Tensor) -> torch.Tensor:
            wide = inputs if inputs.dim() == 2 else inputs[:, None]
            dec, cell["chunk"] = kv_cache.mixed_step(
                self.params, self.model_cfg, wide, cache, page_table,
                state.active, self.num_pages, *ch_args,
                q_block=self._mixed_q_block)
            if inputs.dim() == 2:
                return dec
            cache.lengths += 1         # the narrow step's contract
            return dec[:, 0]

        outs = [self._run_step(state, page_table, W, cap, forward, **flags)]
        cache.lengths[t(np.array([it.slot for it in items], np.int64))] = \
            t((start_pos + chunk_len)[:len(items)])
        self._write_chunk_history(state, items)
        if between_steps is not None:
            between_steps()
        outs += self._steps(state, page_table, W, cap, steps - 1,
                            between_steps, **flags)
        first = self._activate_rows(state, cell["chunk"][:len(items)], items)
        res = self._pack(outs)
        res["first_tokens"] = first
        return state, res

    # ------------------------------------------------------ multi-step decode

    # the ring of recent sampled ids a slot's stop maybe-match reads: 8
    # tokens cover any practical stop string's first contributing token
    STOP_RING = 8

    def decode_bucket(self, steps: int, spec_width: Optional[int] = None,
                      width: Optional[int] = None) -> str:
        """The reference's ledger bucket of a pure-decode program shape:
        width parts appear only where that ladder has more than one rung,
        so the scheduler's commits and warmup's marks share one key
        space."""
        parts = [f"s{steps}"]
        if len(self.spec_widths) > 1:
            parts.append(f"w{spec_width or self.spec_widths[-1]}")
        if len(self.decode_widths) > 1:
            parts.append(f"b{width or self.batch}")
        return "".join(parts)

    def mixed_bucket(self, group: int, steps: int) -> str:
        """The reference's ledger bucket of a mixed dispatch: it runs the
        full batch at the ceiling width, so (G, K) is its key."""
        return f"g{group}s{steps}"

    def decode_multi_bucket(self, steps: int, m: int) -> str:
        """The reference's ledger bucket of a multi-step dispatch: it runs
        the base K at the full batch and width 1, so (K, M) is its key."""
        return f"s{steps}m{m}"

    def _stop_suspect(self, stops: Sequence[str]) -> torch.Tensor:
        """(V+1,) bool device table of the multi-step decode: token id ->
        may it contribute to a match of one of ``stops``
        (``ops.sampling.stop_suspect_mask`` over the byte table). The last
        entry is the ring's padding id and is never suspect. Without the
        byte table (``ensure_token_bytes`` not yet called) every real
        token is suspect, so stop-bearing slots gain no depth. Cached per
        stop-byte set, at most 64 sets."""
        stop_bytes = frozenset(b for s in stops for b in s.encode("utf-8"))
        hit = self._suspect_cache.get(stop_bytes)
        if hit is not None:
            return hit
        V = self.model_cfg.vocab_size
        if not stop_bytes:
            mask = np.zeros((V,), np.bool_)
        elif self._tok_host is None:
            mask = np.ones((V,), np.bool_)
        else:
            mask = sampling.stop_suspect_mask(*self._tok_host, stop_bytes)
        table = self._up(np.concatenate([mask, np.zeros((1,), np.bool_)]))
        if len(self._suspect_cache) >= 64:
            self._suspect_cache.clear()
        self._suspect_cache[stop_bytes] = table
        return table

    @torch.no_grad()
    def decode_multi(self, state: DecodeState, page_table: torch.Tensor,
                     steps: Optional[int] = None, m: Optional[int] = None, *,
                     stops: Sequence[str] = (), has_stop=None,
                     between_steps: Optional[Callable[[], None]] = None
                     ) -> Tuple[DecodeState, Dict[str, Any]]:
        """``steps``·``m`` narrow decode steps over the full batch as one
        dispatch with one packed block (``_decode_multi_impl`` there): the
        scheduler's eligibility test keeps grammared, top-logprob and
        widened slots out. ``m`` must be a rung of ``multi_ms`` (default
        the top one) and ``steps`` the base K. ``stops``: the union of the
        live slots' stop strings (the suspect table); ``has_stop`` (B,)
        bool: the slots that carry one, the only ones a suspect token
        pauses. A paused slot is masked like an inactive one for the rest
        of the dispatch and keeps its activation; done slots end as in
        :meth:`decode`. Out arrays are (steps·m, B), :meth:`decode`'s
        layout; ``between_steps`` as there. Adapter rows ride each step
        through ``_lora``."""
        if not self.multi_ms:
            raise ValueError("multi-step decode is off "
                             "(APP_DECODE_MULTISTEP=0)")
        m = m or self.multi_ms[-1]
        if m not in self.multi_ms:
            raise ValueError(f"multistep m {m} is not a ladder rung "
                             f"{self.multi_ms}")
        base = self.cfg.decode_steps_per_dispatch
        steps = steps or base
        if steps != base:
            raise ValueError(f"multi-step dispatches run the base K "
                             f"({base}), got steps={steps}")
        suspect = self._stop_suspect(tuple(stops))
        B, dev = self.batch, self.device
        has_stop = self._up(np.zeros((B,), np.bool_) if has_stop is None
                            else np.asarray(has_stop, np.bool_))
        running = torch.ones((B,), dtype=torch.bool, device=dev)
        ring = torch.full((B, self.STOP_RING), suspect.shape[0] - 1,
                          dtype=torch.int64, device=dev)
        outs = []
        for _ in range(steps * m):
            active = state.active
            state.active = active & running
            out = self._step(state, page_table)
            # a paused (not done) slot keeps its activation: it resumes on
            # the next dispatch with the same token, counter and length
            state.active = torch.where(running, state.active, active)
            ring = torch.where(out["emitted"][0][:, None],
                               torch.cat([ring[:, 1:],
                                          out["sampled"][0][:, None].long()],
                                         dim=1), ring)
            running = running & ~(has_stop & suspect[ring].any(dim=1))
            outs.append(out)
            if between_steps is not None:
                between_steps()
        return state, self._pack(outs)

    @torch.no_grad()
    def activate(self, state: DecodeState, slot: int, token: int,
                 generated: int, max_gen: int, temperature: float, top_k: int,
                 top_p: float, seed: int = 0,
                 gram_state: int = 0) -> DecodeState:
        """Start decoding a prefilled slot (lengths set by its last chunk;
        ``generated`` counts tokens already produced, >= 1); the token
        enters history at the slot's length, the slot's key becomes
        ``PRNGKey(seed)``, its DFA state ``gram_state`` and its adapter the
        base model, as the reference's ``activate``."""
        state.history[slot, state.cache.lengths[slot].long()
                      .clamp_max(self.max_seq - 1)] = token
        state.tokens[slot] = token
        state.active[slot] = True
        state.generated[slot] = generated
        state.max_gen[slot] = max_gen
        state.temperature[slot] = temperature
        state.top_k[slot] = top_k
        state.top_p[slot] = top_p
        state.rngs[slot] = self._up(threefry.prng_key(seed))
        state.last_logprob[slot] = 0.0
        state.gram_state[slot] = gram_state
        state.adapter_ix[slot] = 0
        state.adapter_host[slot] = 0
        return state

    @torch.no_grad()
    def snapshot_tokens(self, state: DecodeState) -> HostCopy:
        """A (2, B) int32 snapshot of every slot's current token and its
        logprob bits on its way to the host: the batched fetch of fused
        first tokens. A fresh stack, so later dispatches cannot change it."""
        return HostCopy(torch.stack([state.tokens,
                                     state.last_logprob.view(torch.int32)]))

    @torch.no_grad()
    def release(self, state: DecodeState, slot: int) -> DecodeState:
        """Deactivate a slot; its pages may be reused at once (its later
        decode writes go to the null page). Its adapter returns to the base
        model, so a pass whose rows hold no live adapter request makes no
        LoRA call (a dispatch already issued read the slot before, in
        stream order)."""
        state.active[slot] = False
        state.adapter_ix[slot] = 0
        state.adapter_host[slot] = 0
        return state

    @torch.no_grad()
    def seed_history(self, state: DecodeState, slot: int,
                     ids: Sequence[int]) -> DecodeState:
        """Write ``ids[:max_seq]`` into the slot's history row (zeros
        after), for a slot whose prompt prefix came from the prefix cache:
        those chunks never run a prefill dispatch, so the drafting history
        is seeded here. Column ``max_seq``, the sink, is left alone."""
        row = np.zeros((self.max_seq,), np.int32)
        n = min(len(ids), self.max_seq)
        row[:n] = np.asarray(ids[:n], np.int32)
        state.history[slot, :self.max_seq] = self._up(row)
        return state

    # ------------------------------------------- KV handoff (disaggregation)

    def export_slot_kv(self, state: DecodeState, pages, length,
                       fetch: bool = False) -> Dict[str, Any]:
        """Gather a slot's first ``length`` positions of KV into a handoff
        payload (``kv_cache.export_pages``): the prefill worker's half of
        disaggregated serving, and a live slot's snapshot. An int8 pool
        ships int8 values and f32 scales.

        Device-native by default (``fetch=False``): the tensors stay on the
        engine's device, and on CUDA the event recorded on the serving
        stream behind the gather rides under ``kv_wire.READY_KEY``, so an
        encoder on another thread copies them out only after the gather
        ran (the gather's outputs are fresh tensors, so pages freed and
        reused after it cannot change them). An in-process importer
        scatters them straight back. ``fetch=True`` returns host tensors
        (pinned on CUDA), copied through ``HostCopy``."""
        n_exp = max(1, -(-int(length) // self.page_size))
        ids = np.zeros((n_exp,), np.int64)
        got = list(pages)[:n_exp]
        ids[:len(got)] = got
        k, v, k_s, v_s = kv_cache.export_pages(state.cache, self._up(ids),
                                               self.num_pages)
        L = self.model_cfg.n_layers

        def trim(a):
            if a is None:
                return None
            a = a.view((L, n_exp) + tuple(a.shape[1:]))
            # the gather's output is fresh, so no later launch writes it
            return HostCopy(a).tensor() if fetch else a

        payload: Dict[str, Any] = {
            "version": 1,
            "length": int(length),
            "n_pages": n_exp,
            "page_size": self.page_size,
            "n_layers": L,
            "kv_dim": self.model_cfg.n_kv_heads * self.model_cfg.head_dim,
            "kv_dtype": self.kv_dtype,
            "k": trim(k), "v": trim(v),
            "k_s": trim(k_s), "v_s": trim(v_s),
        }
        if not fetch and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            payload[kv_wire.READY_KEY] = event
        return payload

    def validate_handoff(self, payload: Dict[str, Any]) -> None:
        """Refuse, with ``ValueError``, a payload this pool cannot host: a
        page-size, layer-count, width or dtype mismatch, a length outside
        the slot's capacity, a page count or prompt length that disagrees
        with the length, or buffers of another shape (the reference's
        checks)."""
        self._check_geometry(payload, "handoff", " — prefill and decode "
                             "workers must share model geometry and kv_quant")
        n = int(payload.get("length", 0))
        if n < 1 or n + 1 >= self.max_seq:
            raise ValueError(f"handoff length {n} outside this engine's "
                             f"serving range (max_seq {self.max_seq})")
        n_pages = int(payload.get("n_pages", 0))
        if n_pages != max(1, -(-n // self.page_size)):
            raise ValueError("handoff n_pages inconsistent with length")
        if "prompt_ids" in payload and len(payload["prompt_ids"]) != n:
            raise ValueError(
                f"handoff length {n} does not match its "
                f"{len(payload['prompt_ids'])} prompt_ids")
        self._check_buffers(payload, n_pages, "handoff")

    def _check_geometry(self, payload: Dict[str, Any], what: str,
                        hint: str = "") -> None:
        """``ValueError`` unless the payload's page size, layer count, KV
        width and dtype are this pool's."""
        mine = {"page_size": self.page_size,
                "n_layers": self.model_cfg.n_layers,
                "kv_dim": self.model_cfg.n_kv_heads * self.model_cfg.head_dim,
                "kv_dtype": self.kv_dtype}
        for key, want in mine.items():
            got = payload.get(key)
            if got != want:
                raise ValueError(
                    f"{what} {key} mismatch: payload carries {got!r}, this "
                    f"engine serves {want!r}{hint}")

    def _check_buffers(self, payload: Dict[str, Any], n_pages: int,
                       what: str) -> None:
        """``ValueError`` unless k and v (and an int8 pool's scales) are
        there in the shapes of ``n_pages`` pages of this pool."""
        cfg = self.model_cfg
        want_kv = (cfg.n_layers, n_pages, self.page_size,
                   cfg.n_kv_heads * cfg.head_dim)
        want_sc = (cfg.n_layers, n_pages, cfg.n_kv_heads, self.page_size)
        for key, want in (("k", want_kv), ("v", want_kv),
                          ("k_s", want_sc), ("v_s", want_sc)):
            arr = payload.get(key)
            if arr is None:
                if key in ("k", "v") or self.cfg.kv_quant == "int8":
                    raise ValueError(f"{what} payload is missing {key!r}")
                continue
            shape = tuple(getattr(arr, "shape", ()))
            if shape != want:
                raise ValueError(
                    f"{what} {key} buffer shape {shape} does not match "
                    f"the metadata's {want}")

    def _kv_in(self, a, dtype: torch.dtype) -> torch.Tensor:
        """A payload array on this engine's device, read as ``dtype``: a
        device tensor as it is; a CPU tensor or numpy array uploaded (a
        read-only wire view too: the upload reads a copy). bf16 words
        arrive as a numpy ``bfloat16`` array (the reference's host export)
        or as 16-bit integers (the wire's numpy form); both are read bit
        for bit."""
        if not isinstance(a, torch.Tensor):
            arr = np.ascontiguousarray(a)
            if arr.dtype.name == "bfloat16":
                arr = arr.view(np.int16)
            with warnings.catch_warnings():
                # a read-only wire view: nothing writes through it
                warnings.simplefilter("ignore", UserWarning)
                a = torch.from_numpy(arr)
        if (dtype == torch.bfloat16 and a.dtype in (torch.int16,
                                                    torch.uint16)):
            a = a.view(torch.bfloat16)
        if a.device.type != "cpu":
            return a.to(self.device)
        if self.device.type != "cpu":
            return self._up(a)
        if a.data_ptr() % a.element_size():
            a = a.clone()      # a wire view at an unaligned offset
        return a

    @torch.no_grad()
    def import_slot_kv(self, state: DecodeState, slot: int, pages,
                       payload: Dict[str, Any]) -> DecodeState:
        """Scatter a handoff payload into pages ``pages`` of this pool and
        set ``lengths[slot]`` (``kv_cache.import_pages``, in place): the
        decode worker's half. The caller then activates the slot at the
        payload's first token, and decode runs as after a local prefill.
        Validates first (``ValueError``)."""
        self.validate_handoff(payload)
        n_exp = int(payload["n_pages"])
        ids = np.zeros((n_exp,), np.int64)
        got = list(pages)[:n_exp]
        ids[:len(got)] = got
        cache = state.cache
        L = self.model_cfg.n_layers

        def flat(key, dtype):
            a = self._kv_in(payload[key], dtype)
            return a.reshape((L * n_exp,) + tuple(a.shape[2:]))

        quant = self.cfg.kv_quant == "int8"
        kv_cache.import_pages(
            cache, self._up(ids), self.num_pages, slot,
            int(payload["length"]), flat("k", cache.k.dtype),
            flat("v", cache.v.dtype),
            flat("k_s", torch.float32) if quant else None,
            flat("v_s", torch.float32) if quant else None)
        return state

    def validate_pages_payload(self, payload: Dict[str, Any],
                               n_pages: int) -> None:
        """Refuse, with ``ValueError``, a partial page import this pool
        cannot host: the prefix tier's variant of :meth:`validate_handoff`.
        Geometry only: the tier promotes the first ``n_pages`` full pages
        of a cached run and the scheduler prefills the tail, but a
        page-size, layer, width or dtype mismatch, a page count outside the
        payload or the slot, or buffers of another shape would scatter
        garbage KV."""
        self._check_geometry(payload, "tier import")
        total = int(payload.get("n_pages", 0))
        if n_pages < 1 or n_pages > total:
            raise ValueError(f"tier import of {n_pages} pages from a "
                             f"{total}-page payload")
        if n_pages > self.max_pages_per_slot:
            raise ValueError(f"tier import of {n_pages} pages exceeds this "
                             f"engine's {self.max_pages_per_slot} pages/slot")
        self._check_buffers(payload, total, "tier")

    @torch.no_grad()
    def import_pages_kv(self, state: DecodeState, pages,
                        payload: Dict[str, Any],
                        n_pages: Optional[int] = None) -> DecodeState:
        """Scatter the first ``n_pages`` pages of an exported payload into
        pages ``pages`` of this pool (``kv_cache.import_pages_partial``, in
        place): the prefix tier's promotion. No slot state is touched: the
        caller starts its chunked prefill at the covered boundary, so the
        promoted span costs no prefill and the tail runs as a fresh
        admission. Validates first (``ValueError``)."""
        n_imp = int(payload["n_pages"] if n_pages is None else n_pages)
        self.validate_pages_payload(payload, n_imp)
        ids = np.asarray(list(pages)[:n_imp], np.int64)
        if ids.shape[0] != n_imp:
            raise ValueError(f"tier import of {n_imp} pages into "
                             f"{ids.shape[0]} allocated pages")
        cache = state.cache
        L = self.model_cfg.n_layers

        def flat(key, dtype):
            # only the covered pages cross to the device
            a = self._kv_in(payload[key][:, :n_imp], dtype)
            return a.reshape((L * n_imp,) + tuple(a.shape[2:]))

        quant = self.cfg.kv_quant == "int8"
        kv_cache.import_pages_partial(
            cache, self._up(ids), self.num_pages, flat("k", cache.k.dtype),
            flat("v", cache.v.dtype),
            flat("k_s", torch.float32) if quant else None,
            flat("v_s", torch.float32) if quant else None)
        return state

    # ------------------------------------------------- multi-LoRA serving

    def _adapter_leaves(self, tree, name: str):
        """(target, a, b) of an adapter tree in the model dtype on the
        device, each leaf checked against the model's dimensions (a (L, r,
        in), b (L, out, r)) and, on the card, against what the kernel
        takes. Raises ValueError naming ``name``."""
        from generativeaiexamples_tpu_torch.train import lora as lora_mod
        cfg, dt = self.model_cfg, self.model_cfg.torch_dtype
        out = []
        for target in sorted(tree):
            if target not in lora_mod.TARGETS:
                raise ValueError(f"adapter {name!r}: unknown target "
                                 f"{target!r}; valid: {list(lora_mod.TARGETS)}")
            a = torch.as_tensor(tree[target]["a"])
            b = torch.as_tensor(tree[target]["b"])
            d_in, d_out = lora_mod.target_dims(cfg, target)
            L, r = cfg.n_layers, a.shape[1] if a.dim() == 3 else -1
            if (tuple(a.shape) != (L, r, d_in)
                    or tuple(b.shape) != (L, d_out, r)):
                raise ValueError(
                    f"adapter {name!r} target {target!r}: a "
                    f"{tuple(a.shape)}, b {tuple(b.shape)}; the model takes "
                    f"a (L, r, in) = ({L}, r, {d_in}) and b (L, out, r) = "
                    f"({L}, {d_out}, r)")
            if self.device.type == "cuda" and not \
                    lora_kernels.lora_supported(r, d_in, dt):
                raise ValueError(
                    f"adapter {name!r}: rank {r} on {target!r} ({d_in} "
                    f"inputs) is outside the lora_apply kernel's limits for "
                    f"{dt}; it takes ranks "
                    f"{list(lora_kernels.supported_ranks(dt))}")
            out.append((target, a.to(self.device, dt).contiguous(),
                        b.to(self.device, dt).contiguous()))
        return out

    @staticmethod
    def _adapter_digest(tree) -> str:
        """A digest of a tree's exact values (as f32) and layout: a
        re-registration is idempotent only on bit-equal weights."""
        h = hashlib.sha256()
        for target in sorted(tree):
            for key in ("a", "b"):
                leaf = torch.as_tensor(tree[target][key]).detach()
                h.update(f"{target}.{key}{tuple(leaf.shape)}".encode())
                h.update(leaf.to("cpu", torch.float32).contiguous()
                         .numpy().tobytes())
        return h.hexdigest()

    def register_adapter(self, name: str, tree) -> int:
        """Install a trained adapter tree (``train/lora.py`` layout: leaves
        (L, r, in) / (L, out, r)) into a resident slot and return the slot;
        requests select it by name (``Request.adapter``, the OpenAI
        ``model`` field). The first registration fixes the slots' layout
        (targets and rank) and turns the mixed-phase dispatch off (register
        before ``warmup``). Slot 0 stays the all-zero base model.
        Idempotent on bit-equal weights; a rebind of a name to other
        weights, a layout that differs from the resident one, more than
        ``max_adapters`` slots, a rank the kernel does not take (on the
        card) and an engine built with a global tree raise ValueError."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        if name in self._adapter_names:
            # No-rebind invariant: a registered name maps to the SAME
            # weights forever. The scheduler's prefix-cache hash seed
            # namespaces KV pages by adapter NAME alone, so rebinding a
            # name to new weights would serve pages computed under the old
            # ones. The comparison is exact: a fine-tune whose deltas sit
            # under a tolerance must not be absorbed as identical.
            if self._adapter_digest(tree) != self._adapter_digests[name]:
                raise ValueError(
                    f"adapter {name!r} is already registered with "
                    f"different weights; rebinding is not supported — "
                    f"prefix-cache pages are namespaced by adapter name "
                    f"and would go stale. Register under a new name.")
            return self._adapter_names[name]
        if self.adapters is not None and not self._adapters_stacked:
            raise ValueError(
                "engine was built with a global adapter tree; per-request "
                "adapters need a base-only engine (serve the global tree "
                "merged, or register it as a named adapter instead)")
        N = self.cfg.max_adapters
        ix = len(self._adapter_names)
        if ix >= N:
            raise ValueError(f"all {N} adapter slots in use "
                             f"(APP_ENGINE_MAX_ADAPTERS)")
        leaves = self._adapter_leaves(tree, name)
        if not self._adapters_stacked:
            # (L, ...) -> (L, N, ...) zero-initialized slot stack
            self.adapters = {
                target: {key: torch.zeros(
                    (leaf.shape[0], N) + tuple(leaf.shape[1:]),
                    dtype=leaf.dtype, device=leaf.device)
                    for key, leaf in (("a", a), ("b", b))}
                for target, a, b in leaves}
            self._adapters_stacked = True
        # a rank- or target-mismatched adapter fails loudly here: all
        # resident adapters share the first registration's layout
        layout = {t: tuple((s.shape[0],) + tuple(s.shape[2:])
                           for s in (ab["a"], ab["b"]))
                  for t, ab in self.adapters.items()}
        got = {t: (tuple(a.shape), tuple(b.shape)) for t, a, b in leaves}
        if got != layout:
            raise ValueError(
                f"adapter {name!r} leaf shapes {got} do not match the "
                f"resident slot layout {layout} — all resident adapters "
                f"must share rank/targets (first registration fixes the "
                f"layout)")
        for target, a, b in leaves:
            self.adapters[target]["a"][:, ix] = a
            self.adapters[target]["b"][:, ix] = b
        self._lora_layers = lora_ops.prepare(self.adapters,
                                             self.model_cfg.n_layers)
        self._adapter_names[name] = ix
        self._adapter_digests[name] = self._adapter_digest(tree)
        return ix

    def adapter_index(self, name: str) -> int:
        """Resolve a request's adapter name (KeyError for an unknown one:
        the scheduler fails the request loudly, never serving base weights
        under a fine-tune's name)."""
        return self._adapter_names[name or ""]

    @property
    def adapter_names(self) -> List[str]:
        return [n for n in self._adapter_names if n]

    # ----------------------------------------------------------------- warmup

    @torch.no_grad()
    def warmup(self, tokenizer=None) -> float:
        """Run every serving program once on a throwaway state before
        traffic, as the reference's ``warmup`` compiles its grid: every
        grouped-prefill bucket (sampled fused first tokens, so the sampling
        kernel runs too), every decode program (each rung of the batch
        width ladder times each speculative rung, at every depth from
        ``decode_steps_per_dispatch`` to ``decode_steps_max``, with sampled
        slots), every multi-step rung of ``multi_ms`` (at the base depth),
        and every mixed group bucket. With ``tokenizer`` the constrained variants
        run too, as the reference's: the byte table is built, a tiny
        grammar registered, and one grouped prefill, one decode at the
        ceiling width and the full batch (where the scheduler pins
        grammared and top-logprob dispatches) with ``use_grammar`` and
        ``want_top``, and one mixed dispatch with both, each run once; the
        other ``want_top`` and mixed-bucket crossings stay cold, as the
        reference leaves them. With adapters registered the warmup rows
        take slot 1, so every program runs the adapter update. On the card
        this builds every kernel and touches every shape before the first
        request. The rows write to the null page and end at once (budget
        0). Returns the seconds it took, the device included."""
        t0 = time.perf_counter()
        gram_start = 0
        if tokenizer is not None:
            self.ensure_token_bytes(tokenizer)
            gram_start = self.register_grammar(
                grammar_mod.Grammar.from_schema({"type": "boolean"}))
        state = self.init_state()
        zero_row = np.zeros((self.max_pages_per_slot,), np.int32)
        table = self.put_table(np.zeros(
            (self.batch, self.max_pages_per_slot), np.int32))
        steps = self.cfg.decode_steps_per_dispatch

        ix = 1 if self._adapters_stacked else 0

        def items(g, last, gs=0):
            return [PrefillItem(chunk_ids=[1] * min(4, self.chunk),
                                page_row=zero_row, slot=i % self.batch,
                                start_pos=0, is_last=last(i), generated=1,
                                max_gen=0, temperature=1.0, gram_state=gs,
                                adapter_ix=ix)
                    for i in range(g)]

        for g in self.group_buckets:
            state, _ = self.prefill_group(state, items(g, lambda i: True))
            DEVTIME.mark_warm("prefill", f"g{g}")
        if self.role == "prefill":
            # a prefill worker never dispatches decode
            if gram_start:
                state, _ = self.prefill_group(
                    state, items(1, lambda i: True, gram_start))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0
        # the compile-watch (observability/devtime.py) marks every program
        # shape visited here: its first serving dispatch is not counted in
        # engine_recompiles_total; shapes left cold are
        for depth in self.decode_depths:
            for wi in self.spec_widths:
                for bw in self.decode_widths:
                    state, _ = self.decode(state, table, depth,
                                           spec_width=wi, width=bw)
                    DEVTIME.mark_warm("decode",
                                      self.decode_bucket(depth, wi, bw))
        for mi in self.multi_ms:       # at the base K only
            state, _ = self.decode_multi(state, table, m=mi)
            DEVTIME.mark_warm("decode_multi",
                              self.decode_multi_bucket(steps, mi))
        if self.mixed_supported:
            for g in self.group_buckets:
                state, _ = self.decode_mixed(
                    state, table, steps,
                    items(min(g, self.batch), lambda i: bool(i % 2)))
                DEVTIME.mark_warm("mixed", self.mixed_bucket(
                    next(b for b in self.group_buckets
                         if min(g, self.batch) <= b), steps))
        if gram_start:
            state, _ = self.prefill_group(state, items(1, lambda i: True,
                                                       gram_start))
            state, _ = self.decode(state, table, steps, True, True)
            DEVTIME.mark_warm("decode+gram+top", self.decode_bucket(
                steps, self.spec_widths[-1], self.batch))
            if self.mixed_supported:
                state, _ = self.decode_mixed(
                    state, table, steps,
                    items(min(2, self.batch), lambda i: bool(i % 2),
                          gram_start), True, True)
                DEVTIME.mark_warm("mixed+gram+top",
                                  self.mixed_bucket(2, steps))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del state
        return time.perf_counter() - t0
