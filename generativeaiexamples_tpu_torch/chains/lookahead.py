"""Lookahead retrieval: overlap embed+search with an in-flight LLM call.

TeleRAG's observation (arxiv 2502.20969): when a RAG chain runs an LLM call
whose OUTPUT becomes the retrieval query (condense-the-question, rewrite,
routing), the retrieval latency can be hidden by speculatively retrieving on
the RAW query while that call is generating, then reconciling once the
rewritten query lands — rewritten queries usually stay close to the raw one,
so the speculative hits are usually the right hits.

`LookaheadRetrieval` wraps that pattern with the same futures shape the
engine scheduler uses for dispatch-ahead decode:

  * ``start(query)`` kicks the work fn (embed + search, caller-supplied) onto
    a pool thread and returns immediately — the caller then runs its LLM call;
  * ``reconcile(final_query)`` joins the future. Identical query → reuse.
    Otherwise the final query is embedded and compared against the raw
    query's vector (both L2-normalized, so the dot IS the cosine): above
    ``sim_threshold`` the speculative hits are reused, below it the chain
    retrieves again with the final vector — correctness never depends on
    the speculation.

Observability (core/metrics.py):

  * ``lookahead_reuse`` / ``lookahead_requery`` counters — how often the
    speculation paid off;
  * ``retrieval_overlap_frac`` histogram — fraction of the speculative
    retrieval's latency hidden behind the overlapped LLM call (1.0 = the
    retrieval was entirely free).

Port of ``generativeaiexamples_tpu/chains/lookahead.py``; the counters and
the histogram go to the port's ``core/metrics.REGISTRY``. The pool's
threads start on its first submission, never at import.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional, Tuple

import numpy as np

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

logger = logging.getLogger(__name__)

# Shared pool for speculative retrievals and sibling pipeline stages. Sized
# well past typical request concurrency: a worker BLOCKS for a whole encoder
# dispatch, and a multi-turn request can hold 3 at once (lookahead + two
# funnels) — an undersized pool would queue funnel thunks past the
# micro-batcher's wait window and break the very coalescing it feeds.
# Threads here are cheap (they sleep on futures/GIL).
_POOL = ThreadPoolExecutor(max_workers=32, thread_name_prefix="rag-lookahead")

# cosine floor for reusing speculative hits under a rewritten query —
# e5-class normalized embeddings of a question and its standalone rewrite
# sit well above this; genuinely re-scoped questions fall below
DEFAULT_SIM_THRESHOLD = 0.85


class LookaheadRetrieval:
    """One speculative retrieval, started before / reconciled after an LLM
    call. ``retrieve(query, qvec=None)`` maps a query string to
    ``(qvec, payload)``: ``qvec`` is the L2-normalized query embedding used
    for the similarity reconcile (may be None to force exact-match-only
    reuse) and ``payload`` is whatever the chain needs (hits, pools, …).
    When reconcile re-retrieves after a failed similarity gate it passes
    the final query's ALREADY-COMPUTED embedding back as ``qvec`` so the
    retrieve fn must not embed it a second time."""

    def __init__(self, retrieve: Callable[..., Tuple[Optional[np.ndarray], Any]],
                 sim_threshold: float = DEFAULT_SIM_THRESHOLD) -> None:
        self._retrieve = retrieve
        self.sim_threshold = sim_threshold
        self._query: Optional[str] = None
        self._future: Optional[Future] = None
        self._started_at = 0.0

    def start(self, query: str) -> "LookaheadRetrieval":
        self._query = query
        self._started_at = time.perf_counter()
        self._future = _POOL.submit(self._timed_retrieve, query)
        return self

    def seed(self, query: str,
             result: Tuple[Optional[np.ndarray], Any]) -> "LookaheadRetrieval":
        """Adopt an ALREADY-COMPUTED retrieval for ``query`` as the
        speculation — zero new encoder/store work. Used when the caller is
        holding this query's hits and is about to run an LLM call that may
        rewrite the query (the agentic chain's retry paths): reconcile()
        then reuses or re-retrieves exactly as it would for start()."""
        self._query = query
        self._started_at = time.perf_counter()
        fut: Future = Future()
        fut.set_result((result, 0.0))   # spec_wall 0: nothing was overlapped
        self._future = fut
        return self

    def _timed_retrieve(self, query: str):
        t0 = time.perf_counter()
        result = self._retrieve(query)
        return result, time.perf_counter() - t0

    def reconcile(self, final_query: str,
                  embed: Optional[Callable[[str], np.ndarray]] = None
                  ) -> Tuple[Optional[np.ndarray], Any]:
        """Join the speculation and return ``(qvec, payload)`` valid for
        ``final_query``. ``embed`` (query text → normalized vector) is
        required for similarity-based reuse of a REWRITTEN query; without
        it only an exact match reuses the speculation."""
        assert self._future is not None, "reconcile() before start()"
        llm_wall = time.perf_counter() - self._started_at
        try:
            (qvec, payload), spec_wall = self._future.result()
        except Exception as exc:   # noqa: BLE001 — speculation is best-effort
            # correctness never depends on the speculation: a failure there
            # (e.g. a poisoned co-batched encoder dispatch, or the batcher
            # closing during shutdown) must not fail the REQUEST — retrieve
            # fresh on the final query instead
            logger.warning("speculative retrieval failed (%s); retrieving "
                           "on the final query", exc)
            REGISTRY.counter("lookahead_requery").inc()
            return self._retrieve(final_query)
        if spec_wall > 0:
            REGISTRY.histogram("retrieval_overlap_frac").observe(
                min(1.0, llm_wall / spec_wall))
        if final_query == self._query:
            REGISTRY.counter("lookahead_reuse").inc()
            return qvec, payload
        fvec: Optional[np.ndarray] = None
        # an unsatisfiable threshold (> 1.0 for normalized vectors, the
        # exact-match-only mode) must not burn an embed dispatch on a gate
        # that cannot pass
        if qvec is not None and embed is not None and self.sim_threshold <= 1.0:
            fvec = np.asarray(embed(final_query))
            sim = float(np.dot(fvec, qvec))
            if sim >= self.sim_threshold:
                # the rewrite stayed on-topic: the speculative hits stand
                # (TeleRAG's common case), and the final query's OWN vector
                # is the honest one to carry forward
                REGISTRY.counter("lookahead_reuse").inc()
                return fvec, payload
        REGISTRY.counter("lookahead_requery").inc()
        # pass the already-computed final vector along (if any) so the
        # retrieval does not embed the same string twice
        return self._retrieve(final_query, fvec)


def submit_concurrently(*thunks: Callable[[], Any]) -> list:
    """Run the thunks on the lookahead pool and join in order — used to
    issue sibling pipeline stages (e.g. the two rerank funnels of the
    multi-turn chain) at the same time so the encoder micro-batcher can
    coalesce them into one device dispatch. Every future is awaited before any
    exception re-raises: a failing sibling must not leave the others
    running unobserved (their exceptions would otherwise surface only as
    GC-time 'never retrieved' warnings)."""
    futures = [_POOL.submit(t) for t in thunks]
    results: list = []
    first_exc: Optional[BaseException] = None
    for f in futures:
        try:
            results.append(f.result())
        # tpulint: disable=except-swallow -- gather pattern: the first
        # exception re-raises after every sibling future is observed
        except BaseException as exc:   # noqa: BLE001 — re-raised below
            if first_exc is None:
                first_exc = exc
            results.append(None)
    if first_exc is not None:
        raise first_exc
    return results
