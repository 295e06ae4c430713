"""Event-driven agent loop — queue-triggered analysis with bounded concurrency.

Behavioral parity with the reference's event-driven RAG CVE pipeline
(ref: community/event-driven-rag-cve-analysis — a Morpheus/Kafka consumer
triggers an LLM agent per incoming CVE event: look up the knowledge base,
run the analysis chain, publish a structured verdict; failures are retried
and surfaced, not dropped). The Kafka/Morpheus runtime is replaced by an
asyncio consumer over pluggable async event sources — the same seam
pattern as retrieval/streaming_ingest.py: a Kafka source is a ~10-line
async generator against the `Event` contract.

Mechanics the reference gets from its streaming engine, kept here:
  * bounded concurrency (a flood of events cannot stampede the device);
  * per-event retry with capped attempts and FULL-JITTER exponential
    backoff (server/resilience.py — the shared implementation; the old
    linear ``retry_delay_s * attempt`` sleep retried a correlated burst
    of failures in lockstep), then a dead-letter list — an event is
    either answered, or visibly failed, never lost. Dead letters count
    into ``event_agent_dead_letter_total`` and the most recent ride the
    process-wide :data:`DEAD_LETTERS` ring, served at
    ``GET /debug/deadletter`` (server/common.py) — a poisoned topic is
    an operator page, not a log archaeology project;
  * results stream to a sink callback as they finish (publish side).

Port of ``generativeaiexamples_tpu/chains/event_agent.py``, the same in
behaviour. :func:`dead_letter_payload` is the body of every server's
``GET /debug/deadletter`` (``server/common.DEBUG_ROUTES``), and the
retry policy reads the ambient SLO deadline (``server/resilience.py``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import (Any, AsyncIterator, Callable, Dict, List, Optional,
                    Sequence)

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.engine.tools import extract_json_value
from generativeaiexamples_tpu_torch.server.resilience import full_jitter_backoff

logger = logging.getLogger(__name__)

# process-wide dead-letter ring (newest last): every EventDrivenAgent in
# the process appends here so /debug/deadletter shows poisoned events
# without a handle on the agent instance. Bounded — an unbounded poison
# topic must not become an unbounded memory leak.
DEAD_LETTERS: deque = deque(maxlen=256)
_DEAD_LOCK = threading.Lock()


def record_dead_letter(event: "Event", error: str, attempts: int) -> None:
    with _DEAD_LOCK:
        DEAD_LETTERS.append({"ts_unix": round(time.time(), 3),
                             "key": event.key, "error": error,
                             "attempts": attempts})
    REGISTRY.counter("event_agent_dead_letter_total").inc()


def dead_letter_payload() -> Dict[str, Any]:
    """The ``GET /debug/deadletter`` body (newest first)."""
    with _DEAD_LOCK:
        items = list(DEAD_LETTERS)[::-1]
    return {"total": REGISTRY.counter("event_agent_dead_letter_total").value,
            "ring_capacity": DEAD_LETTERS.maxlen,
            "dead_letters": items}


@dataclasses.dataclass
class Event:
    """One triggering event (e.g. a CVE advisory landing on a topic)."""
    key: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attempt: int = 0


@dataclasses.dataclass
class EventResult:
    key: str
    output: str = ""
    ok: bool = True
    error: str = ""
    attempts: int = 1
    latency_s: float = 0.0


async def list_source(events: Sequence[Event]) -> AsyncIterator[Event]:
    """In-tree source: a finite batch (tests, backfills)."""
    for e in events:
        yield e


async def jsonl_event_source(path: str, key_field: str = "id"
                             ) -> AsyncIterator[Event]:
    """Events from a JSONL feed (the file-tap equivalent of a topic)."""
    def read():
        with open(path, "r", encoding="utf-8") as fh:
            return [json.loads(line) for line in fh if line.strip()]

    for row in await asyncio.to_thread(read):
        yield Event(key=str(row.get(key_field, "")), payload=row)


class EventDrivenAgent:
    """Consumes events, runs ``handler`` per event under a concurrency cap.

    handler: Callable[[Event], str] — typically a closure over a chain or
    ToolAgent; runs on a worker thread (chains block on device work)."""

    def __init__(self, handler: Callable[[Event], str],
                 result_sink: Optional[Callable[[EventResult], None]] = None,
                 max_concurrency: int = 4, max_retries: int = 2,
                 retry_delay_s: float = 0.5,
                 retry_cap_s: float = 30.0) -> None:
        self.handler = handler
        self.result_sink = result_sink
        self.max_concurrency = max_concurrency
        self.max_retries = max_retries
        # base of the shared full-jitter exponential backoff (retry n
        # sleeps uniform in [0, min(retry_cap_s, retry_delay_s * 2^(n-1))])
        self.retry_delay_s = retry_delay_s
        self.retry_cap_s = retry_cap_s
        self.results: List[EventResult] = []
        self.dead_letter: List[Event] = []

    async def _process(self, event: Event,
                       sem: asyncio.Semaphore) -> None:
        async with sem:
            t0 = time.perf_counter()
            attempt = 0
            while True:
                attempt += 1
                try:
                    output = await asyncio.to_thread(self.handler, event)
                    result = EventResult(
                        key=event.key, output=output, attempts=attempt,
                        latency_s=time.perf_counter() - t0)
                    break
                except Exception as exc:
                    logger.warning("event %s attempt %d failed: %s",
                                   event.key, attempt, exc)
                    if attempt > self.max_retries:
                        result = EventResult(
                            key=event.key, ok=False, error=str(exc),
                            attempts=attempt,
                            latency_s=time.perf_counter() - t0)
                        self.dead_letter.append(
                            dataclasses.replace(event, attempt=attempt))
                        record_dead_letter(event, str(exc), attempt)
                        break
                    # jittered exponential backoff (shared helper): a
                    # correlated failure burst (engine restart, dead
                    # retriever) retries decorrelated instead of in
                    # lockstep waves
                    await asyncio.sleep(full_jitter_backoff(
                        attempt, base_s=self.retry_delay_s,
                        cap_s=self.retry_cap_s))
        self.results.append(result)
        if self.result_sink is not None:
            try:
                self.result_sink(result)
            except Exception:
                logger.exception("result sink failed for %s", event.key)

    async def run(self, source: AsyncIterator[Event]) -> Dict[str, int]:
        sem = asyncio.Semaphore(self.max_concurrency)
        tasks = []
        async for event in source:
            tasks.append(asyncio.ensure_future(self._process(event, sem)))
        if tasks:
            await asyncio.gather(*tasks)
        ok = sum(1 for r in self.results if r.ok)
        return {"processed": len(self.results), "succeeded": ok,
                "failed": len(self.results) - ok,
                "dead_letter": len(self.dead_letter)}

    def run_sync(self, source: AsyncIterator[Event]) -> Dict[str, int]:
        return asyncio.run(self.run(source))


# ------------------------------------------------------- concrete handler

CVE_TRIAGE_PROMPT = """\
You are a security analyst. A new advisory arrived:

{advisory}

Relevant internal context (software inventory, prior notes):
{context}

Assess whether our deployment is affected. Respond with ONLY a JSON object:
{{"cve": "<id>", "affected": true|false, "severity": "low|medium|high|critical",
"justification": "<one paragraph>"}}"""


def make_cve_triage_handler(ctx, collection: str = "default",
                            top_k: int = 4, **sampling) -> Callable[[Event], str]:
    """The reference pipeline's analysis step as a handler: retrieve
    deployment context for the advisory, ask the LLM for a structured
    verdict (ref: event-driven-rag-cve-analysis's LLM agent stage)."""

    def handler(event: Event) -> str:
        advisory = json.dumps(event.payload)
        query = f"{event.key} {event.payload.get('summary', '')}"
        qvec = ctx.embedder.embed_queries([query])[0]
        hits = ctx.store(collection).search(qvec, top_k=top_k)
        context = "\n\n".join(d.content for d, _ in hits) or "(none)"
        prompt = CVE_TRIAGE_PROMPT.format(advisory=advisory, context=context)
        text = "".join(ctx.llm.chat(
            [{"role": "user", "content": prompt}], **sampling))
        found = extract_json_value(text)
        if found is None:
            raise ValueError(f"no JSON verdict in analysis for {event.key}")
        verdict = found[0]
        if not isinstance(verdict, dict) or "affected" not in verdict:
            raise ValueError(f"malformed verdict for {event.key}")
        verdict.setdefault("cve", event.key)
        return json.dumps(verdict)

    return handler
