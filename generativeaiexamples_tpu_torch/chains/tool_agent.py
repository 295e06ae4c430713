"""tool_agent — OpenAI-tool-calling agent loop with human-in-the-loop gates.

Capability parity with the reference's tool-calling agent notebooks
(ref: RAG/notebooks/langchain/Agent_use_tools_leveraging_NVIDIA_AI_endpoints
.ipynb — an LLM bound to typed tools loops call → result → call until it
answers; ref: RAG/notebooks/langchain/NIM_tool_call_HumanInTheLoop_
MultiAgents.ipynb — sensitive tools interrupt the loop and wait for a human
verdict before executing; ref: LangGraph_HandlingAgent_IntermediateSteps
.ipynb — intermediate steps surface as a typed event stream).

The LangGraph runtime is replaced by a plain resumable generator: `run`
yields typed events ({"type": "tool_call" | "tool_result" |
"approval_request" | "final"}); when a tool marked `requires_approval`
comes up, the loop emits an `approval_request` carrying a serializable
`PendingApproval` and STOPS. `resume(pending, approved)` picks the episode
back up with the human verdict — deny feeds the model a refusal message
(it can re-plan), approve executes. Deny-by-default posture matches
chains/bash_agent.py: nothing sensitive runs without an explicit verdict.

Port of ``generativeaiexamples_tpu/chains/tool_agent.py``.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Sequence

logger = logging.getLogger(__name__)

DEFAULT_SYSTEM = ("You are a helpful assistant. Use the available tools "
                  "when they help; answer directly when they don't.")


@dataclass
class Tool:
    """A typed callable the agent may invoke."""

    name: str
    description: str
    parameters: Dict[str, Any]            # JSON schema for the arguments
    fn: Callable[..., str]
    requires_approval: bool = False       # HITL gate

    def spec(self) -> Dict[str, Any]:
        return {"type": "function", "function": {
            "name": self.name, "description": self.description,
            "parameters": self.parameters}}


@dataclass
class PendingApproval:
    """Everything needed to resume an interrupted episode (json-able via
    `to_json`/`from_json`, so the wait can cross a process boundary)."""

    messages: List[Dict[str, Any]]
    call: Dict[str, Any]                  # the tool_call awaiting a verdict
    remaining: List[Dict[str, Any]] = field(default_factory=list)
    steps: int = 0

    def to_json(self) -> str:
        return json.dumps({"messages": self.messages, "call": self.call,
                           "remaining": self.remaining, "steps": self.steps})

    @classmethod
    def from_json(cls, blob: str) -> "PendingApproval":
        d = json.loads(blob)
        return cls(messages=d["messages"], call=d["call"],
                   remaining=d["remaining"], steps=d["steps"])


class ToolAgent:
    """Drives a tool-capable LLM (`chat_tools` seam, chains/llm_client.py)."""

    def __init__(self, llm, tools: Sequence[Tool], max_steps: int = 6,
                 system_prompt: str = DEFAULT_SYSTEM,
                 **sampling: Any) -> None:
        self.llm = llm
        self.tools = {t.name: t for t in tools}
        self.max_steps = max_steps
        self.system_prompt = system_prompt
        self.sampling = sampling

    # ------------------------------------------------------------------ API

    def run(self, query: str,
            history: Sequence[Dict[str, str]] = ()) -> Iterator[Dict]:
        messages = ([{"role": "system", "content": self.system_prompt}]
                    + list(history) + [{"role": "user", "content": query}])
        yield from self._drive(messages, [], 0)

    def resume(self, pending: PendingApproval, approved: bool,
               feedback: str = "") -> Iterator[Dict]:
        """Continue after a human verdict on ``pending.call``."""
        messages = list(pending.messages)
        call = pending.call
        if approved:
            yield {"type": "tool_call", "call": call, "approved": True}
            result = self._execute(call)
            yield {"type": "tool_result",
                   "name": call["function"]["name"], "content": result}
        else:
            result = ("Tool call denied by the user."
                      + (f" Feedback: {feedback}" if feedback else ""))
            yield {"type": "tool_result",
                   "name": call["function"]["name"], "content": result}
        messages.append(self._tool_message(call, result))
        yield from self._drive(messages, list(pending.remaining),
                               pending.steps)

    # ------------------------------------------------------------ internals

    @staticmethod
    def _tool_message(call: Dict[str, Any], content: str) -> Dict[str, Any]:
        return {"role": "tool", "tool_call_id": call.get("id", ""),
                "name": call["function"]["name"], "content": content}

    def _execute(self, call: Dict[str, Any]) -> str:
        name = call["function"]["name"]
        tool = self.tools[name]
        try:
            args = json.loads(call["function"].get("arguments") or "{}")
            if not isinstance(args, dict):
                args = {"value": args}
        except ValueError:
            return f"error: arguments for {name} were not valid JSON"
        try:
            return str(tool.fn(**args))
        except Exception as exc:  # tool errors feed back, never crash the loop
            logger.exception("tool %s failed", name)
            return f"error: {exc}"

    def _drive(self, messages: List[Dict], queue: List[Dict],
               steps: int) -> Iterator[Dict]:
        while True:
            while queue:
                call = queue.pop(0)
                name = call["function"]["name"]
                tool = self.tools.get(name)
                if tool is None:
                    result = f"error: unknown tool {name!r}"
                elif tool.requires_approval:
                    yield {"type": "approval_request", "call": call,
                           "pending": PendingApproval(
                               messages=[dict(m) for m in messages],
                               call=call, remaining=list(queue),
                               steps=steps)}
                    return   # interrupted: resume() continues the episode
                else:
                    yield {"type": "tool_call", "call": call}
                    result = self._execute(call)
                    yield {"type": "tool_result", "name": name,
                           "content": result}
                messages.append(self._tool_message(call, result))
            if steps >= self.max_steps:
                yield {"type": "final",
                       "content": "I could not finish within the step "
                                  "budget.", "exhausted": True}
                return
            msg = self.llm.chat_tools(
                messages, [t.spec() for t in self.tools.values()],
                tool_choice="auto", **self.sampling)
            if msg.get("tool_calls"):
                messages.append(msg)
                queue = list(msg["tool_calls"])
                steps += 1
                continue
            yield {"type": "final", "content": msg.get("content") or ""}
            return
