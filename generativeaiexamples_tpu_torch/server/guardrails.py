"""Guardrails — colang-style input rails + fact-check output rail.

Behavioral parity with the reference's guardrails integrations
(ref: RAG/notebooks/langchain/Using_NVIDIA_NIMs_with_NeMo_Guardrails/config/
flows.co — `define user <intent>` with example utterances, `define bot
<name>` with a canned reply, `define flow` linking them; NeMo matches user
turns to intents by embedding similarity over the examples.
ref: community/oran-chatbot-multimodal/guardrails/fact_check.py — an LLM
fact-check of the response against the retrieved context, verdict-prefixed
TRUE/FALSE). The NeMo-Guardrails runtime + hosted models are replaced by
the in-proc embedder and LLM.

Composition:
  * `parse_colang` reads the reference's flow format (the subset those
    configs actually use) into intent → response rules;
  * `IntentRail` embeds every example once and matches incoming queries by
    cosine similarity — above threshold, the flow's canned bot reply is
    returned instead of running the chain;
  * `RegexRail` blocks/scrubs pattern matches (PII-style) on input or
    output;
  * `FactCheckRail` judges the generated answer against the retrieval
    context and prefixes the reference's TRUE/FALSE verdict marker;
  * `Guardrails` runs input rails before the chain and output rails after.

Everything is opt-in: a server without a rails config behaves exactly as
before (`from_config` returns None).

A copy of ``generativeaiexamples_tpu/server/guardrails.py`` (numpy and
the standard library); the rails run over the port's ``Embedder`` and
LLM client.
"""

from __future__ import annotations

import contextvars
import dataclasses
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# Retrieval context handoff: chains record the exact context they prompted
# with so the fact-check rail judges the answer against what the model
# actually saw, instead of re-running retrieval (which doubles embedder/
# store work and can fetch different chunks). Context-local, so concurrent
# requests on different threads never see each other's context.
_retrieved_context: contextvars.ContextVar[Optional[str]] = (
    contextvars.ContextVar("rails_retrieved_context", default=None))


def record_context(text: str) -> None:
    """Called by chains right after building their retrieval context."""
    _retrieved_context.set(text)


def take_context() -> Optional[str]:
    """Return and clear the recorded context (None if no chain recorded)."""
    text = _retrieved_context.get()
    _retrieved_context.set(None)
    return text


@dataclasses.dataclass
class Flow:
    intent: str
    examples: List[str]
    response: str


def parse_colang(text: str) -> List[Flow]:
    """Parse the `define user / define bot / define flow` subset the
    reference configs use (ref flows.co). Quoted lines under a `define
    user` are example utterances; under `define bot`, the canned reply;
    a `define flow` pairs `user X` with the following `bot Y` line."""
    users: Dict[str, List[str]] = {}
    bots: Dict[str, str] = {}
    pairs: List[Tuple[str, str]] = []
    mode: Optional[Tuple[str, str]] = None
    flow_user: Optional[str] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("define user "):
            mode = ("user", line[len("define user "):].strip())
            users.setdefault(mode[1], [])
            flow_user = None
            continue
        if line.startswith("define bot "):
            mode = ("bot", line[len("define bot "):].strip())
            flow_user = None
            continue
        if line.startswith("define flow"):
            mode = ("flow", "")
            flow_user = None
            continue
        quoted = re.fullmatch(r'"(.*)"', line)
        if mode and mode[0] == "user" and quoted:
            users[mode[1]].append(quoted.group(1))
        elif mode and mode[0] == "bot" and quoted:
            bots[mode[1]] = (bots.get(mode[1], "") + " " +
                             quoted.group(1)).strip()
        elif mode and mode[0] == "flow":
            if line.startswith("user "):
                flow_user = line[len("user "):].strip()
            elif line.startswith("bot ") and flow_user:
                pairs.append((flow_user, line[len("bot "):].strip()))
                flow_user = None
    flows = []
    for user_intent, bot_name in pairs:
        if user_intent in users and bot_name in bots:
            flows.append(Flow(intent=user_intent,
                              examples=users[user_intent],
                              response=bots[bot_name]))
    return flows


class IntentRail:
    """Embedding-matched intent rail: the NeMo mechanism — every example
    utterance is embedded once; an incoming query whose nearest example
    clears ``threshold`` triggers the flow's canned response."""

    def __init__(self, flows: Sequence[Flow], embedder,
                 threshold: float = 0.75) -> None:
        self.flows = [f for f in flows if f.examples]
        self.embedder = embedder
        self.threshold = threshold
        examples = [e for f in self.flows for e in f.examples]
        self._owner = [i for i, f in enumerate(self.flows)
                       for _ in f.examples]
        if examples:
            m = np.asarray(embedder.embed_queries(examples))
            self._matrix = m / np.clip(
                np.linalg.norm(m, axis=1, keepdims=True), 1e-9, None)
        else:
            self._matrix = np.zeros((0, 1))

    def check(self, query: str) -> Optional[str]:
        if not len(self._matrix):
            return None
        q = np.asarray(self.embedder.embed_queries([query]))[0]
        q = q / max(float(np.linalg.norm(q)), 1e-9)
        sims = self._matrix @ q
        best = int(np.argmax(sims))
        if float(sims[best]) >= self.threshold:
            flow = self.flows[self._owner[best]]
            logger.info("input rail %r triggered (sim %.2f)",
                        flow.intent, float(sims[best]))
            return flow.response
        return None


class RegexRail:
    """Pattern rail: ``block`` returns the refusal on match (input rails);
    ``scrub`` replaces matches with the mask (output rails)."""

    def __init__(self, patterns: Sequence[str], refusal: str = "",
                 mask: str = "[redacted]") -> None:
        self._res = [re.compile(p, re.IGNORECASE) for p in patterns]
        self.refusal = refusal
        self.mask = mask

    def check(self, text: str) -> Optional[str]:
        for rx in self._res:
            if rx.search(text):
                return self.refusal or "I can't help with that request."
        return None

    def scrub(self, text: str) -> str:
        for rx in self._res:
            text = rx.sub(self.mask, text)
        return text


FACT_CHECK_SYS = """\
Your task is to fact-check a response from a language model. You are given
the context documents as [[CONTEXT]], the user's question as [[QUESTION]],
and the model's response as [[RESPONSE]]. Verify each claim in the response
strictly against the context — no external knowledge. Reply starting with
TRUE if the response is entirely supported by the context, or FALSE if any
part is not, followed by a one-sentence justification."""


class FactCheckRail:
    """Output rail: LLM fact-check of the answer against the retrieval
    context (ref fact_check.py); a FALSE verdict prepends a visible
    warning rather than silently passing the answer through."""

    WARNING = ("[guardrails] fact-check could not verify this answer "
               "against the retrieved documents:\n")

    def __init__(self, llm) -> None:
        self.llm = llm

    def check(self, answer: str, context: str, query: str) -> str:
        if not context.strip():
            return answer
        verdict = "".join(self.llm.chat(
            [{"role": "system", "content": FACT_CHECK_SYS},
             {"role": "user",
              "content": f"[[CONTEXT]]\n{context}\n\n[[QUESTION]]\n{query}"
                         f"\n\n[[RESPONSE]]\n{answer}"}],
            max_tokens=128, temperature=0.0)).strip()
        if verdict.upper().startswith("FALSE"):
            logger.warning("fact-check failed: %s", verdict[:120])
            return self.WARNING + answer
        return answer


class Guardrails:
    """Runs input rails before the chain and output rails after it."""

    def __init__(self, input_rails: Sequence = (),
                 output_scrub: Optional[RegexRail] = None,
                 fact_check: Optional[FactCheckRail] = None) -> None:
        self.input_rails = list(input_rails)
        self.output_scrub = output_scrub
        self.fact_check = fact_check

    @property
    def has_output_rails(self) -> bool:
        return self.fact_check is not None or self.output_scrub is not None

    def check_input(self, query: str) -> Optional[str]:
        """A canned refusal/response, or None to proceed to the chain."""
        for rail in self.input_rails:
            hit = rail.check(query)
            if hit is not None:
                return hit
        return None

    def check_output(self, answer: str, context: str = "",
                     query: str = "") -> str:
        if self.fact_check is not None:
            answer = self.fact_check.check(answer, context, query)
        if self.output_scrub is not None:
            answer = self.output_scrub.scrub(answer)
        return answer


def from_config(path: str, embedder, llm,
                threshold: float = 0.75,
                enable_fact_check: bool = False,
                scrub_patterns: Sequence[str] = ()) -> Optional[Guardrails]:
    """Build Guardrails from a flows.co file; None when no path is set
    (rails are strictly opt-in). ``enable_fact_check`` /
    ``scrub_patterns`` activate the output rails (the server reads them
    from APP_GUARDRAILS_FACT_CHECK / APP_GUARDRAILS_SCRUB)."""
    if not path:
        return None
    with open(path, "r", encoding="utf-8") as fh:
        flows = parse_colang(fh.read())
    if not flows:
        logger.warning("guardrails config %s defines no usable flows", path)
    rails = Guardrails(
        input_rails=[IntentRail(flows, embedder, threshold=threshold)],
        output_scrub=(RegexRail(list(scrub_patterns)) if scrub_patterns
                      else None),
        fact_check=FactCheckRail(llm) if enable_fact_check else None)
    logger.info("guardrails active: %d flows from %s (fact_check=%s, "
                "scrub=%d patterns)", len(flows), path, enable_fact_check,
                len(scrub_patterns))
    return rails
