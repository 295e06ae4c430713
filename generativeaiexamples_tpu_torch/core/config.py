"""Engine configuration with the ``APP_*`` environment overlay.

Port of the parts of ``generativeaiexamples_tpu/core/config.py`` that the
port runs: ``EngineConfig`` (only the knobs this port serves),
``LLMConfig`` (``model_name``, ``server_url``, ``model_engine``), the
retrieval sections (``VectorStoreConfig``,
``TextSplitterConfig``, ``EmbeddingConfig``, ``RankingConfig``,
``RetrieverConfig``: the reference's fields, defaults and env names), and
the loader (an optional JSON file named by ``APP_CONFIG_FILE``, then
``APP_<SECTION>_<FIELD>`` variables on top).

Knobs of the TPU engine that this port does not serve yet are refused
loudly: setting one of them in the environment or the file raises
``NotImplementedError`` naming its ROADMAP item, instead of being ignored.
"""

from __future__ import annotations

import json
import os
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Mapping, Optional

ENV_PREFIX = "APP"

# TPU-engine knobs not served by the port yet -> the ROADMAP item that
# ports them, and the value that means "feature off" (accepted as a no-op)
NOT_PORTED: Dict[str, tuple] = {
    "long_prefill": ("A11 (sequence-parallel prefill)", "off"),
    "devtime": ("A6 (device-time ledger)", "off"),
    "qos": ("A6 (QoS plane)", "off"),
    "kv_tier": ("A.9, second part (the prefix-addressed host KV tier)",
                "off"),
    "kv_tier_disk_mb": ("A.9, second part (the prefix-addressed host KV "
                        "tier)", "0"),
    "mesh_shape": ("A11 (tensor parallelism)", ""),
    "donate_buffers": ("none: PyTorch updates the pool in place", "auto"),
}


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs of the port (``APP_ENGINE_<FIELD>``)."""

    # serving role for disaggregated prefill/decode topologies: unified
    # (default: one worker does everything) | prefill (runs chunked prefill
    # only and exports the finished request's KV pages and sampling state
    # via /v1/kv/prefill; never dispatches decode) | decode (a full worker
    # that also imports handed-off KV via /v1/kv/handoff and decodes from
    # the first token on)
    role: str = "unified"
    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 128
    num_pages: int = 0            # 0 = full slot capacity (+ null page 0)
    prefill_chunk: int = 512
    decode_steps_per_dispatch: int = 8
    # adaptive upper bound on fused decode steps: when the batch is at
    # least half full and every active slot has the budget, dispatches
    # deepen up to this many steps (power of two; 0 = always use
    # decode_steps_per_dispatch)
    decode_steps_max: int = 0
    # multi-step decode with deferred token fetch: ceiling M of the
    # multiplier ladder (power of two >= 2; 0 = off). Eligible
    # steady-state dispatches (no grammar, no top logprobs, no speculative
    # widening pending, no held-back stop match) run
    # decode_steps_per_dispatch x M plain decode steps in one dispatch
    # (decode_multi) whose token block the host fetches once; a stop-string
    # maybe-match over a ring of recent ids pauses a stop-bearing slot on
    # the device until the host confirms. Streams stay token-identical to
    # the per-step path. The bare env APP_DECODE_MULTISTEP overrides
    decode_multistep: int = 0
    prefill_group: int = 8
    dtype: str = "bfloat16"
    # KV pool storage: none (the model dtype) | int8 (per-token-per-head
    # scales; the paged kernel folds the dequant past its dots)
    kv_quant: str = "none"
    # weight storage: none (the model dtype) | int8 (per-channel weight-only
    # int8, the projections through the W8A16 GEMM)
    quant: str = "none"
    # auto (kernel on CUDA tensors, plain on CPU tensors) | kernel | plain
    attention: str = "auto"
    # the architecture served with random weights: llama3-8b, llama3-70b,
    # gemma-2b, gemma-7b, codegemma-7b, tiny, tiny-gemma (models.model_configs)
    model_family: str = "llama3-8b"
    # a local HF Llama directory (config.json, *.safetensors,
    # tokenizer.json) to serve; "" serves random weights of model_family
    checkpoint_dir: str = ""
    # prompt-lookup speculative decoding: on | off. Each decode step drafts
    # from the request's own history and verifies the drafts in one widened
    # step; exact-match acceptance keeps the stream token-identical
    spec_decode: str = "on"
    spec_draft: int = 4           # drafted tokens per step (0 = no drafts)
    spec_ngram: int = 2           # suffix n-gram matched against history
    # on: per-slot draft caps from an acceptance EMA pick a rung of the
    # width ladder each dispatch; off: every dispatch is 1 + spec_draft wide
    spec_adaptive: str = "on"
    spec_draft_max: int = 0       # ladder ceiling; 0 = 2 x spec_draft
    # prefill chunks ride the decode dispatch as ragged rows: on | off |
    # auto (on for a CUDA device, off on the CPU); the bare env
    # APP_MIXED_PHASE_DISPATCH overrides
    mixed_phase_dispatch: str = "auto"
    # prefix caching over the paged KV pool: on | off. Full prompt pages
    # are shared across requests by chain hash (refcounted, LRU-evicted
    # under pool pressure), so repeated chat templates, system prompts and
    # retrieved chunks skip re-prefill
    prefix_cache: str = "on"
    # decode dispatches kept in flight ahead of result processing: the
    # host issues dispatch N+1 while dispatch N's result is still copying
    pipeline_depth: int = 2
    # while admissions prefill into a batch under half full, hold decode
    # dispatches for up to this many prefill chunks per ramp episode
    # (0 = never hold)
    prefill_hold_chunks: int = 16
    # pure-decode dispatches run at the smallest batch-width rung covering
    # the highest live slot: on | off (full batch only)
    decode_width_ladder: str = "on"
    # resident LoRA adapter slots for per-request multi-adapter serving
    # (slot 0 is the base model); requests select an adapter by its
    # registered name (the OpenAI `model` field) and one decode batch mixes
    # adapters freely
    max_adapters: int = 4
    # bounded host-RAM pool (MiB) for spill preemption of KV pages
    # (engine/kv_tier.py): under page exhaustion the victim slot's pages
    # are demoted to this pool instead of freed, and promotion re-imports
    # them when pages free, so preemption costs one transfer each way
    # instead of a re-prefill; 0 (default) = off, preemption recomputes.
    # The bare env APP_KV_SPILL_MB overrides this field
    kv_spill_mb: int = 0

    def __post_init__(self) -> None:
        if self.pipeline_depth < 1:
            raise ValueError(f"engine.pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.prefill_hold_chunks < 0:
            raise ValueError(f"engine.prefill_hold_chunks must be >= 0, got "
                             f"{self.prefill_hold_chunks}")
        if str(self.decode_width_ladder).strip().lower() not in ("on", "off"):
            raise ValueError(f"engine.decode_width_ladder must be on|off, "
                             f"got {self.decode_width_ladder!r}")


@dataclass(frozen=True)
class LLMConfig:
    """``APP_LLM_<FIELD>``: the chains' LLM (``chains/llm_client.py``)."""

    model_name: str = "llama3-8b-instruct"   # the OpenAI model id
    # a remote OpenAI-compatible server; "" = the in-process engine
    server_url: str = ""
    # the reference reads this field nowhere: it takes remote or in-process
    # from server_url alone, so the port refuses any other value than its
    # default instead of ignoring it
    model_engine: str = "tpu"

    def __post_init__(self) -> None:
        if str(self.model_engine).strip().lower() != "tpu":
            raise ValueError(
                f"llm.model_engine={self.model_engine!r} is not served: the "
                f"chains use the in-process engine, or the OpenAI-compatible "
                f"server that llm.server_url (APP_LLM_SERVER_URL) names")


@dataclass(frozen=True)
class VectorStoreConfig:
    """``APP_VECTOR_STORE_<FIELD>``: the store backend
    (``retrieval/adapters.make_store``: the in-process store,
    ``retrieval/store.py``, or a Milvus, pgvector or Elasticsearch
    adapter)."""

    name: str = "tpu"             # tpu | milvus | pgvector | elasticsearch
    url: str = ""                 # remote vector DB URL (unused in-process)
    nlist: int = 64               # IVF coarse cells
    nprobe: int = 16              # IVF cells probed per query
    index_type: str = "exact"     # exact | ivf


@dataclass(frozen=True)
class TextSplitterConfig:
    """``APP_TEXT_SPLITTER_<FIELD>``: chunking in tokens."""

    model_name: str = "byte-bpe"  # tokenizer that counts while chunking
    chunk_size: int = 510
    chunk_overlap: int = 200


@dataclass(frozen=True)
class EmbeddingConfig:
    """``APP_EMBEDDINGS_<FIELD>``: the embedder."""

    model_name: str = "e5-base-tpu"
    dimensions: int = 512
    model_engine: str = "tpu"
    server_url: str = ""          # remote embedding server; "" in-process
    # cross-request micro-batch window (encoders/microbatch.py); 0 = off
    microbatch_window_ms: float = 2.0


@dataclass(frozen=True)
class RankingConfig:
    """``APP_RANKING_<FIELD>``: the reranker."""

    model_name: str = "rerank-minilm-tpu"
    model_engine: str = "tpu"
    server_url: str = ""          # remote rerank server; "" in-process
    microbatch_window_ms: float = 2.0


@dataclass(frozen=True)
class RetrieverConfig:
    """``APP_RETRIEVER_<FIELD>``: retrieval knobs."""

    top_k: int = 4                # documents returned to the prompt
    score_threshold: float = 0.25
    nr_top_k: int = 40            # documents fetched before reranking
    max_context_tokens: int = 1500


@dataclass(frozen=True)
class AppConfig:
    engine: EngineConfig = field(default_factory=EngineConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    vector_store: VectorStoreConfig = field(
        default_factory=VectorStoreConfig)
    text_splitter: TextSplitterConfig = field(
        default_factory=TextSplitterConfig)
    embeddings: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    ranking: RankingConfig = field(default_factory=RankingConfig)
    retriever: RetrieverConfig = field(default_factory=RetrieverConfig)



def _coerce(value: Any, ftype: Any) -> Any:
    if ftype is int:
        return int(value)
    if ftype is float:
        return float(value)
    return str(value)


def _section(cls: type, data: Mapping[str, Any], env: Mapping[str, str],
             prefix: str) -> Any:
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in fields(cls):
        name = f"{prefix}_{f.name.upper()}"
        if name in env:
            kwargs[f.name] = _coerce(env[name], hints[f.name])
        elif f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints[f.name])
    return cls(**kwargs)


def refuse_not_ported(engine_data: Mapping[str, Any],
                      env: Mapping[str, str]) -> None:
    """Raise for any TPU-engine knob set to something this port lacks."""
    for key, (item, off) in NOT_PORTED.items():
        raw = env.get(f"{ENV_PREFIX}_ENGINE_{key.upper()}",
                      engine_data.get(key))
        if raw is not None and str(raw).strip().lower() != off:
            raise NotImplementedError(
                f"engine.{key}={raw!r} is not served by the PyTorch port "
                f"yet (ROADMAP {item})")


def load_config(path: Optional[str] = None,
                env: Optional[Mapping[str, str]] = None) -> AppConfig:
    """Defaults, then the JSON file (``APP_CONFIG_FILE``), then env vars."""
    env = os.environ if env is None else env
    path = path or env.get(f"{ENV_PREFIX}_CONFIG_FILE", "")
    data: Dict[str, Any] = {}
    if path and os.path.isfile(path):
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        if text.strip():
            data = json.loads(text)
    engine_data = data.get("engine", {}) or {}
    refuse_not_ported(engine_data, env)
    sections = {f.name: f.default_factory for f in fields(AppConfig)}
    return AppConfig(**{
        name: _section(cls, data.get(name, {}) or {}, env,
                       f"{ENV_PREFIX}_{name.upper()}")
        for name, cls in sections.items()})


def get_config() -> AppConfig:
    """The process configuration, read fresh from file and environment."""
    return load_config()

