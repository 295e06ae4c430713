"""bash_agent — allowlisted bash computer-use agent loop.

Behavioral parity with the reference's from-scratch bash agent
(ref: nemotron/LLM/bash_computer_use_agent/{main_from_scratch,bash,config}.py —
an LLM drives an `exec_bash_command` tool; bash.py:exec_bash_command blocks
`` ` `` / ``$`` injection patterns, splits compound commands and checks
every part against an allowlist, tracks the working directory; the main
loop confirms each execution with the user and feeds tool results back
until the model answers without a tool call).

The reference's OpenAI tool-calling wire format is replaced by a JSON-in-
text protocol (the in-proc LLM is a plain chat stream): the model either
emits ``{"tool": "exec_bash_command", "cmd": "..."}`` or a final answer.
Safety posture is strictly tighter than the reference: same injection
guards and allowlist, plus a **deny-by-default confirm callback** — headless
runs execute nothing unless the embedder explicitly supplies a policy —
and output size/time caps on every command.

A copy of ``generativeaiexamples_tpu/chains/bash_agent.py`` over the
port's ``extract_json``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.chains.query_decomposition import extract_json

logger = logging.getLogger(__name__)

# ref config.py: read-only inspection commands; anything mutating requires
# the operator to extend the allowlist deliberately
DEFAULT_ALLOWED = ("ls", "pwd", "cat", "head", "tail", "wc", "grep", "find",
                   "echo", "date", "whoami", "du", "df", "file", "stat",
                   "uname", "cd")

# Flags that turn an allowlisted command into a write/exec primitive —
# `find -delete` passes every other guard yet wipes the tree; `-exec`
# escapes the allowlist entirely. Checked across ALL tokens of a command.
DENIED_TOKENS = frozenset({
    "-delete", "-exec", "-execdir", "-ok", "-okdir",
    "-fprint", "-fprint0", "-fprintf", "-fls",     # find's file writers
})

SYSTEM_PROMPT = """\
You are a careful computer-use assistant operating a bash shell.
To run a command, reply with ONLY this JSON (no other text):
{"tool": "exec_bash_command", "cmd": "<command>"}
You will receive the result as a tool message. When you have enough
information, reply with a plain-text answer instead of JSON.
Rules: one command per turn; only simple commands (no backticks, no $());
prefer read-only inspection."""


@dataclass
class BashTool:
    """Sandboxed command executor (ref bash.py Bash class)."""

    allowed_commands: Sequence[str] = DEFAULT_ALLOWED
    root_dir: str = "."
    timeout_s: float = 10.0
    max_output: int = 4096
    cwd: str = field(init=False)

    def __post_init__(self) -> None:
        self.cwd = os.path.abspath(self.root_dir)

    # -- validation (ref bash.py:exec_bash_command) -----------------------

    @staticmethod
    def _split_commands(cmd: str) -> List[str]:
        """Leading command word of every segment of a compound command."""
        parts = re.split(r"\|\||&&|\||;|&|\n", cmd)
        words = []
        for part in parts:
            try:
                tokens = shlex.split(part.strip())
            except ValueError:
                return ["<unparseable>"]
            if tokens:
                words.append(tokens[0])
        return words

    def exec_bash_command(self, cmd: str) -> Dict[str, str]:
        if not cmd or not cmd.strip():
            return {"error": "No command was provided."}
        # injection guards (ref bash.py: backticks and $ block substitution
        # and variables alike); also block redirection (`>` would make the
        # read-only `echo` a write primitive) and `&` outright — a lone
        # ampersand backgrounds a second command that the compound-split
        # below would never see
        if re.search(r"[`$<>&]", cmd):
            return {"error": "Command injection/redirection/background "
                             "patterns are not allowed."}
        for word in self._split_commands(cmd):
            if word not in self.allowed_commands:
                return {"error": f"Command {word!r} is not in the allowlist."}
        try:
            all_tokens = shlex.split(cmd)
        except ValueError:
            return {"error": "Unparseable command."}
        denied = DENIED_TOKENS.intersection(all_tokens)
        if denied:
            return {"error": f"Flag {sorted(denied)[0]!r} is not allowed "
                             "(write/exec primitive)."}
        # `cd` updates tracked cwd instead of spawning a shell
        tokens = all_tokens
        if tokens and tokens[0] == "cd":
            target = os.path.abspath(os.path.join(
                self.cwd, tokens[1] if len(tokens) > 1 else "."))
            if not os.path.isdir(target):
                return {"error": f"No such directory: {target}"}
            self.cwd = target
            return {"stdout": "", "stderr": "", "cwd": self.cwd}
        return self._run(cmd)

    def _run(self, cmd: str) -> Dict[str, str]:
        try:
            proc = subprocess.run(
                cmd, shell=True, cwd=self.cwd, capture_output=True,
                text=True, timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            return {"error": f"Command timed out after {self.timeout_s}s."}
        return {"stdout": proc.stdout[-self.max_output:],
                "stderr": proc.stderr[-self.max_output:],
                "returncode": str(proc.returncode), "cwd": self.cwd}


def parse_tool_call(text: str) -> Optional[str]:
    """Extract a {"tool": "exec_bash_command", "cmd": ...} call; None means
    the reply is a final answer."""
    obj = extract_json(text)
    if (isinstance(obj, dict) and obj.get("tool") == "exec_bash_command"
            and isinstance(obj.get("cmd"), str)):
        return obj["cmd"]
    return None


class BashAgent:
    """The agent loop (ref main_from_scratch.py): user goal → model → tool
    call → confirm → execute → tool result → ... → final answer.

    ``confirm(cmd) -> bool`` gates every execution; the DEFAULT DENIES
    (the reference prompts interactively — headless callers must opt in
    with an explicit policy, e.g. ``confirm=lambda cmd: True`` for the
    allowlisted read-only set).
    """

    def __init__(self, llm, tool: Optional[BashTool] = None,
                 confirm: Optional[Callable[[str], bool]] = None,
                 max_turns: int = 8) -> None:
        self.llm = llm
        self.tool = tool or BashTool()
        self.confirm = confirm or (lambda cmd: False)
        self.max_turns = max_turns

    def run(self, goal: str) -> Tuple[str, List[Dict[str, str]]]:
        """Drive the loop; returns (final_answer, transcript). The
        transcript records every tool call and result for auditing."""
        messages: List[Dict[str, str]] = [
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user",
             "content": f"{goal}\nCurrent working directory: "
                        f"`{self.tool.cwd}`"},
        ]
        transcript: List[Dict[str, str]] = []
        for _ in range(self.max_turns):
            reply = "".join(self.llm.chat(messages, max_tokens=256,
                                          temperature=0.0)).strip()
            cmd = parse_tool_call(reply)
            if cmd is None:
                return reply, transcript
            if self.confirm(cmd):
                result = self.tool.exec_bash_command(cmd)
            else:
                result = {"error": "Execution declined by policy."}
            transcript.append({"cmd": cmd, **result})
            messages.append({"role": "assistant", "content": reply})
            messages.append({
                "role": "user",
                "content": f"Tool result: {json.dumps(result)}\n"
                           f"Current working directory: `{self.tool.cwd}`"})
        return ("I hit the step limit before finishing; partial results "
                "are in the transcript."), transcript
