"""Bi-encoder embedding service (e5-class): replaces the embedding NIM.

Port of ``generativeaiexamples_tpu/encoders/embedder.py``: passage and
query embedding with the e5 instruction prefixes (``query: `` /
``passage: ``), texts packed into power-of-two (batch, length) buckets
from 8 (capped at ``max_batch`` and ``max_len``), padding rows keeping one
valid token so masked-mean pooling never divides by zero, L2-normalised
f32 vectors out.

Dispatch-ahead: every batch of a call is uploaded (pinned host memory, a
copy that does not wait for the device) and launched before any result
is fetched, so the card works through the batches while the host packs
the next; the one fetch per batch comes after all are queued, and
``embeddings_computed`` counts after it (a failed batch reports none).

``device`` is ``cuda`` unless the caller asks for another
(``core/runtime.resolve_device``); ``dtype`` is the model dtype, by
default bf16 on the card and f32 on the CPU. Without ``cfg`` the encoder
is ``BertConfig.e5_base()``; without ``params`` its weights are drawn
from a ``torch.Generator`` seeded 11 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.core.runtime import resolve_device
from generativeaiexamples_tpu_torch.encoders.microbatch import MicroBatcher
from generativeaiexamples_tpu_torch.engine.tokenizer import (Tokenizer,
                                                            get_tokenizer)
from generativeaiexamples_tpu_torch.models import bert

QUERY_PREFIX = "query: "
PASSAGE_PREFIX = "passage: "


def bucket(n: int, cap: int) -> int:
    """The power of two from 8 that holds ``n``, capped at ``cap``."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def encoder_setup(cfg: Optional[bert.BertConfig], params, device, dtype,
                  seed: int, with_rank_head: bool = False):
    """(device, cfg, params) of an encoder: ``cfg`` (e5-base without one)
    in ``dtype`` (bf16 on the card, f32 elsewhere, without one), and
    ``params`` cast there, or weights drawn from ``seed``."""
    device = resolve_device(device)
    if dtype is None:
        dtype = "bfloat16" if device.type == "cuda" else "float32"
    dtype = str(dtype).replace("torch.", "")
    cfg = dataclasses.replace(cfg or bert.BertConfig.e5_base(), dtype=dtype)
    if params is None:
        params = bert.init_params(torch.Generator(device=device).manual_seed(
            seed), cfg, with_rank_head=with_rank_head, device=device)
    else:
        params = bert.cast_params(params, device, cfg.torch_dtype)
    return device, cfg, params


def upload(arrays: Sequence[np.ndarray], device: torch.device):
    """Host arrays as tensors on ``device``. To a card the copies go from
    pinned memory without waiting for the device, so a batch uploads while
    the previous one computes."""
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return [t.to(device) for t in out]
    return [t.pin_memory().to(device, non_blocking=True) for t in out]


class Embedder:
    def __init__(self, cfg: Optional[bert.BertConfig] = None,
                 params: Optional[bert.Params] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 max_len: int = 512, max_batch: int = 32,
                 micro_window_s: float = 0.0, device=None,
                 dtype=None) -> None:
        self.device, self.cfg, self.params = encoder_setup(
            cfg, params, device, dtype, seed=11)
        self.tokenizer = tokenizer or get_tokenizer("")
        self.max_len = min(max_len, self.cfg.max_positions)
        self.max_batch = max_batch
        # cross-request micro-batching (encoders/microbatch.py): concurrent
        # embed calls from chains and the HTTP server coalesce into single
        # dispatches. Opt-in: direct bulk users (ingest, tests) keep the
        # plain path
        self._batcher: Optional[MicroBatcher] = (
            MicroBatcher(self._run, max_items=max_batch,
                         window_s=micro_window_s, name="embed")
            if micro_window_s > 0 else None)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def close(self) -> None:
        """Stop the micro-batch worker thread (no-op without one). Code
        that constructs embedders repeatedly in one process must close them
        or leak a parked daemon thread per instance."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    def _batchify(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = [self.tokenizer.encode(t)[: self.max_len] for t in texts]
        S = bucket(max((len(i) for i in ids), default=1), self.max_len)
        B = bucket(len(ids), self.max_batch)
        tokens = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), bool)
        for r, seq in enumerate(ids):
            tokens[r, :len(seq)] = seq
            mask[r, :len(seq)] = True
        # padding rows keep one valid token so masked-mean never divides by 0
        for r in range(len(ids), B):
            mask[r, 0] = True
        return tokens, mask

    @torch.inference_mode()
    def _run(self, texts: Sequence[str]) -> np.ndarray:
        # dispatch-ahead: launch every batch before fetching any result
        pending = []
        for i in range(0, len(texts), self.max_batch):
            chunk = texts[i:i + self.max_batch]
            tokens, mask = upload(self._batchify(chunk), self.device)
            vecs = bert.embed(self.params, self.cfg, tokens, mask,
                              normalize=True)
            pending.append((vecs, len(chunk)))
        # count AFTER the fetch: a failed batch must not report embeddings
        out = []
        for v, n in pending:
            out.append(v[:n].cpu().numpy())
            REGISTRY.counter("embeddings_computed").inc(n)
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, self.dim), np.float32))

    def _dispatch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        if self._batcher is not None:
            # rows route back as this submission's contiguous slice of the
            # coalesced batch output: stacking keeps the input order
            return np.asarray(self._batcher.submit(list(texts)))
        return self._run(texts)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._dispatch([QUERY_PREFIX + t for t in texts])

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._dispatch([PASSAGE_PREFIX + t for t in texts])
