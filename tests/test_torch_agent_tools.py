"""The port's agent loops against the JAX package's on the CPU.

``tool_agent``, ``extraction`` and ``bash_agent`` run over both packages
with the same inputs:

  * **a scripted LLM** (the reference's own cases, from
    ``tests/test_tool_calling.py``, ``tests/test_guardrails_extraction.py``
    and ``tests/test_breadth_chains.py``): the same replies in the same
    order; the events (tool-call ids renumbered in order of appearance,
    since both mint them at random), records, transcripts and the
    messages each LLM received must be equal, and the reference's own
    assertions hold on both. Shell commands run only from the allowlist,
    inside the test's temporary folder, with ``timeout_s`` set;
  * **the same tiny weights** (the tiny llama of
    ``jax.random.PRNGKey(99)``, carried across by ``llama.params_from_jax``,
    over the byte tokenizer, f32, greedy, ``test_torch_chains.py``'s engine
    geometry with rows of 2,048 positions for the tool prompts): one ``ToolAgent`` episode with every turn under the tool
    grammar (both packages' agents send ``"auto"``, so each LLM is wrapped
    to ask for ``"required"``), two tools,
    one behind approval: equal events and prompt ids, every call's
    arguments valid under its tool's schema. This is the case that reaches
    ``grammar_mask`` (its plain version, on the CPU).

The card's case of the same episode, at the tiny size on the card against
the CPU, is ``tests/test_torch_cuda_kernels.py``'s
``test_tool_agent_episode_on_the_card_matches_cpu`` (that file imports no
JAX, so it runs on the card's machine).
"""

import json
import re

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.chains import bash_agent as jbash
from generativeaiexamples_tpu.chains import extraction as jextract
from generativeaiexamples_tpu.chains import tool_agent as jagent
from generativeaiexamples_tpu.chains.llm_client import LocalLLM as JLocalLLM
from generativeaiexamples_tpu.core import config as jconfig
from generativeaiexamples_tpu.engine.engine import EngineCore as JCore
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JScheduler
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JByte
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.chains import bash_agent as tbash
from generativeaiexamples_tpu_torch.chains import extraction as textract
from generativeaiexamples_tpu_torch.chains import tool_agent as tagent
from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
from generativeaiexamples_tpu_torch.core import config as tconfig
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama
from test_torch_chains import GEOMETRY

PACKAGES = {"jax": dict(agent=jagent, extract=jextract, bash=jbash),
            "torch": dict(agent=tagent, extract=textract, bash=tbash)}


def _both(run):
    """``run(mods)`` on both packages: their results equal."""
    got = {package: run(mods) for package, mods in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _plain(events):
    """Events as JSON text, a pending approval by its ``to_json`` and the
    tool-call ids renumbered in order of appearance."""
    ids = {}

    def renumber(match):
        return ids.setdefault(match.group(0), f"call_{len(ids)}")

    return [re.sub(r"call_[0-9a-f]{12}", renumber, json.dumps(
        {k: (v.to_json() if k == "pending" else v) for k, v in e.items()},
        sort_keys=True)) for e in events]


class FakeLLM:
    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def chat(self, messages, **settings):
        self.calls.append([dict(m) for m in messages])
        text = self.responses.pop(0) if self.responses else "default answer"
        mid = max(1, len(text) // 2)
        yield text[:mid]
        yield text[mid:]


class FakeToolLLM:
    """chat_tools seam with scripted assistant messages."""

    def __init__(self, messages):
        self.outputs = [json.loads(json.dumps(m)) for m in messages]
        self.seen = []

    def chat_tools(self, messages, tools, tool_choice="auto", **kw):
        self.seen.append(([dict(m) for m in messages], tool_choice, kw))
        return self.outputs.pop(0)


def _call(name, args, cid="call_1"):
    return {"id": cid, "type": "function",
            "function": {"name": name, "arguments": json.dumps(args)}}


# ---------------------------------------------------------------- tool agent

def test_tool_spec_and_pending_round_trip():
    def run(mods):
        tool = mods["agent"].Tool(name="deploy", description="ship it",
                                  parameters={"type": "object"},
                                  fn=lambda **kw: "ok",
                                  requires_approval=True)
        pending = mods["agent"].PendingApproval(
            messages=[{"role": "user", "content": "go"}],
            call=_call("deploy", {"env": "prod"}),
            remaining=[_call("deploy", {"env": "dev"}, "call_2")], steps=3)
        back = mods["agent"].PendingApproval.from_json(pending.to_json())
        return tool.spec(), pending.to_json(), back == pending

    spec, blob, same = _both(run)
    assert same and spec["function"]["name"] == "deploy"
    assert json.loads(blob)["steps"] == 3


def test_tool_agent_loop_executes_and_answers():
    def run(mods):
        calc = mods["agent"].Tool(
            name="calculator", description="math",
            parameters={"type": "object"},
            fn=lambda expression="": str(eval(expression,
                                              {"__builtins__": {}})))
        llm = FakeToolLLM([
            {"role": "assistant", "content": None,
             "tool_calls": [_call("calculator", {"expression": "6*7"})]},
            {"role": "assistant", "content": "The answer is 42."}])
        events = list(mods["agent"].ToolAgent(llm, [calc]).run("6*7?"))
        return _plain(events), llm.seen

    events, seen = _both(run)
    events = [json.loads(e) for e in events]
    assert [e["type"] for e in events] == ["tool_call", "tool_result",
                                          "final"]
    assert events[1]["content"] == "42"
    assert events[2]["content"] == "The answer is 42."
    assert any(m.get("role") == "tool" and m.get("content") == "42"
               for m in seen[1][0])
    assert all(choice == "auto" for _, choice, _ in seen)


def test_tool_agent_tool_error_feeds_back():
    def boom(**kw):
        raise RuntimeError("no such city")

    def run(mods):
        weather = mods["agent"].Tool(name="get_weather", description="w",
                                     parameters={"type": "object"}, fn=boom)
        llm = FakeToolLLM([
            {"role": "assistant", "content": None,
             "tool_calls": [_call("get_weather", {"city": "Atlantis"}),
                            _call("no_such_tool", {}, "call_2"),
                            {"id": "call_3", "type": "function",
                             "function": {"name": "get_weather",
                                          "arguments": "{not json"}}]},
            {"role": "assistant", "content": "I could not find it."}])
        events = list(mods["agent"].ToolAgent(llm, [weather]).run("w?"))
        return _plain(events), llm.seen

    events, seen = _both(run)
    results = [json.loads(e)["content"] for e in events
               if json.loads(e)["type"] == "tool_result"]
    assert "error: no such city" in results[0]
    assert results[1] == "error: arguments for get_weather were not valid JSON"
    fed = [m["content"] for m in seen[1][0] if m.get("role") == "tool"]
    assert "error: unknown tool 'no_such_tool'" in fed
    assert json.loads(events[-1])["type"] == "final"


@pytest.mark.parametrize("approved", [True, False])
def test_tool_agent_hitl_interrupt_and_resume(approved):
    def run(mods):
        executed = []
        deploy = mods["agent"].Tool(
            name="deploy", description="ship it",
            parameters={"type": "object"},
            fn=lambda env="": executed.append(env) or f"deployed to {env}",
            requires_approval=True)
        llm = FakeToolLLM([
            {"role": "assistant", "content": None,
             "tool_calls": [_call("deploy", {"env": "prod"})]},
            {"role": "assistant", "content": "Done."}])
        agent = mods["agent"].ToolAgent(llm, [deploy])
        events = list(agent.run("deploy to prod"))
        before = list(executed)
        pending = mods["agent"].PendingApproval.from_json(
            events[-1]["pending"].to_json())
        resumed = list(agent.resume(pending, approved=approved,
                                    feedback="not during the freeze"))
        return _plain(events), before, _plain(resumed), executed, llm.seen

    events, before, resumed, executed, seen = _both(run)
    assert json.loads(events[-1])["type"] == "approval_request"
    assert before == []            # nothing ran before the verdict
    kinds = [json.loads(e)["type"] for e in resumed]
    fed = [m for m in seen[1][0] if m.get("role") == "tool"]
    if approved:
        assert executed == ["prod"]
        assert kinds == ["tool_call", "tool_result", "final"]
        assert json.loads(resumed[1])["content"] == "deployed to prod"
    else:
        assert executed == []
        assert kinds == ["tool_result", "final"]
        assert fed and "not during the freeze" in fed[0]["content"]


def test_tool_agent_step_budget():
    def run(mods):
        ping = mods["agent"].Tool(name="ping", description="p",
                                  parameters={"type": "object"},
                                  fn=lambda **kw: "pong")
        llm = FakeToolLLM([{"role": "assistant", "content": None,
                            "tool_calls": [_call("ping", {})]}
                           for _ in range(10)])
        events = list(mods["agent"].ToolAgent(llm, [ping],
                                              max_steps=3).run("loop"))
        return _plain(events), len(llm.seen)

    events, turns = _both(run)
    last = json.loads(events[-1])
    assert last["type"] == "final" and last.get("exhausted")
    assert turns == 3


# ---------------------------------------------------------------- extraction

FIELDS = [("device", "string", "device name", True),
          ("voltage", "number", "", True),
          ("certified", "boolean", "", False),
          ("ports", "list", "", False)]


def _fields(mods, spec=FIELDS):
    return [mods["extract"].Field(n, t, d, required=r) for n, t, d, r in spec]


def test_structured_extraction_happy_path():
    def run(mods):
        llm = FakeLLM([json.dumps({"device": "PumpX", "voltage": 24,
                                   "certified": True, "ports": ["a", "b"],
                                   "extra": "dropped"})])
        out = mods["extract"].StructuredExtractor(llm).extract(
            "PumpX runs at 24V, certified, ports a and b", _fields(mods))
        return out, llm.calls

    out, calls = _both(run)
    assert out == {"device": "PumpX", "voltage": 24, "certified": True,
                   "ports": ["a", "b"]}
    assert '"voltage": number (required)' in calls[0][0]["content"]


@pytest.mark.parametrize("replies, expect", [
    (['{"voltage": "twenty-four"}', '{"voltage": 24}'], {"voltage": 24}),
    (['{"voltage": true}', "```json\n{\"voltage\": 24.5}\n```"],
     {"voltage": 24.5}),
    (["no json", "still no json", "nope"], "extraction failed"),
    (['{"voltage": "x"}', "prose only", "prose again"], "no JSON object"),
])
def test_structured_extraction_retries_with_feedback(replies, expect):
    def run(mods):
        llm = FakeLLM(replies)
        try:
            out = mods["extract"].StructuredExtractor(llm).extract(
                "text", _fields(mods, [("voltage", "number", "", True)]))
        except ValueError as exc:
            out = str(exc)
        return out, llm.calls

    out, calls = _both(run)
    if isinstance(expect, dict):
        assert out == expect
        assert "must be" in calls[1][-1]["content"]
    else:
        assert expect in out and len(calls) == 3


def test_structured_extraction_batch_isolates_failures():
    def run(mods):
        llm = FakeLLM(['{"n": 1}', "bad", "bad", "bad", '{"n": 3}'])
        return mods["extract"].StructuredExtractor(
            llm, max_retries=2).extract_many(
                ["a", "b", "c"], _fields(mods, [("n", "number", "", True)]))

    assert _both(run) == [{"n": 1}, None, {"n": 3}]


@pytest.mark.parametrize("kind", ["integer", "object", ""])
def test_field_type_validation(kind):
    for mods in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown field type"):
            mods["extract"].Field("x", kind)


# ---------------------------------------------------------------- bash agent

GUARDED = ["rm hello.txt", "echo `whoami`", "echo $HOME", "echo hi > f.txt",
           "ls && rm -rf /", "ls & rm -rf /", "cat 'unclosed",
           "find . -delete", "find . -exec rm {} +", "ls | sh", "", "   ",
           "ls\nrm hello.txt", "cat < hello.txt"]


@pytest.mark.parametrize("cmd", GUARDED)
def test_bash_tool_refuses(tmp_path, cmd):
    (tmp_path / "hello.txt").write_text("hi from the sandbox")

    def run(mods):
        return mods["bash"].BashTool(root_dir=str(tmp_path),
                                     timeout_s=5.0).exec_bash_command(cmd)

    out = _both(run)
    assert "error" in out and "stdout" not in out
    assert (tmp_path / "hello.txt").exists()


def test_bash_tool_allowlist_cwd_and_caps(tmp_path):
    (tmp_path / "hello.txt").write_text("hi from the sandbox")
    (tmp_path / "sub").mkdir()
    (tmp_path / "long.txt").write_text("x" * 100 + "tail")

    def run(mods):
        tool = mods["bash"].BashTool(root_dir=str(tmp_path), timeout_s=5.0,
                                     max_output=8)
        steps = [tool.exec_bash_command(c) for c in (
            "cat hello.txt", "find . -name hello.txt", "cat long.txt",
            "cd sub", "pwd", "cd nope", "cd ..", "ls | wc -l")]
        slow = mods["bash"].BashTool(root_dir=str(tmp_path), timeout_s=0.2,
                                     allowed_commands=("sleep",))
        steps.append(slow.exec_bash_command("sleep 5"))
        return steps

    steps = _both(run)
    assert steps[0]["stdout"] == " sandbox"            # the last 8 bytes
    assert steps[2]["stdout"] == "x" * 4 + "tail"      # the output cap
    assert steps[3]["cwd"].endswith("sub")
    assert steps[4]["stdout"].strip().endswith("sub")
    assert "error" in steps[5]
    assert steps[6]["cwd"] == str(tmp_path)
    assert steps[7]["returncode"] == "0"
    assert steps[8] == {"error": "Command timed out after 0.2s."}


def test_bash_agent_loop_runs_tool_and_answers(tmp_path):
    (tmp_path / "data.txt").write_text("alpha\nbeta\ngamma\n")

    def run(mods):
        llm = FakeLLM([
            json.dumps({"tool": "exec_bash_command", "cmd": "cat data.txt"}),
            "The file has three lines: alpha, beta, gamma."])
        agent = mods["bash"].BashAgent(
            llm, tool=mods["bash"].BashTool(root_dir=str(tmp_path),
                                            timeout_s=5.0),
            confirm=lambda cmd: True)
        answer, transcript = agent.run("what is in data.txt?")
        return answer, transcript, llm.calls

    answer, transcript, calls = _both(run)
    assert "three lines" in answer
    assert transcript[0]["cmd"] == "cat data.txt"
    assert "alpha" in transcript[0]["stdout"]
    assert "alpha" in calls[1][-1]["content"]


def test_bash_agent_confirm_policy_and_turn_limit(tmp_path):
    """A policy that approves only ``ls`` and ``pwd``: the others are
    declined without running; the loop stops at ``max_turns``."""
    (tmp_path / "secret.txt").write_text("do not read")

    def run(mods):
        llm = FakeLLM([json.dumps({"tool": "exec_bash_command", "cmd": c})
                       for c in ("ls", "cat secret.txt", "pwd", "ls -a")])
        agent = mods["bash"].BashAgent(
            llm, tool=mods["bash"].BashTool(root_dir=str(tmp_path),
                                            timeout_s=5.0),
            confirm=lambda cmd: cmd.split()[0] in ("ls", "pwd"),
            max_turns=3)
        return agent.run("look around")

    answer, transcript = _both(run)
    assert answer.startswith("I hit the step limit")
    assert [t["cmd"] for t in transcript] == ["ls", "cat secret.txt", "pwd"]
    assert "secret.txt" in transcript[0]["stdout"]
    assert transcript[1] == {"cmd": "cat secret.txt",
                             "error": "Execution declined by policy."}
    assert transcript[2]["stdout"].strip() == str(tmp_path)


@pytest.mark.parametrize("text", [
    '{"tool": "exec_bash_command", "cmd": "grep \'}\' src.c"}',
    'Sure: {"tool": "exec_bash_command", "cmd": "echo {a}"} done',
    "no json here",
    '{"tool": "other", "cmd": "ls"}',
    '{"tool": "exec_bash_command", "cmd": 5}',
    '[{"tool": "exec_bash_command", "cmd": "pwd"}]',
])
def test_parse_tool_call_matches_jax(text):
    assert tbash.parse_tool_call(text) == jbash.parse_tool_call(text)


def test_parse_tool_call_braces_inside_strings():
    parse = tbash.parse_tool_call
    assert parse('{"tool": "exec_bash_command", "cmd": "grep \'}\' src.c"}'
                 ) == "grep '}' src.c"
    assert parse('Sure: {"tool": "exec_bash_command", "cmd": "echo {a}"} '
                 'done') == "echo {a}"
    assert parse("no json here") is None


def test_bash_agent_denies_by_default():
    def run(mods):
        llm = FakeLLM([json.dumps({"tool": "exec_bash_command",
                                   "cmd": "ls"}),
                       "I was not allowed to run the command."])
        return mods["bash"].BashAgent(llm).run("list files")

    answer, transcript = _both(run)
    assert transcript[0]["error"] == "Execution declined by policy."
    assert answer == "I was not allowed to run the command."


# --------------------------------------- one episode under the tool grammar

LOOKUP = {"type": "object", "properties": {
    "topic": {"type": "string", "enum": ["llamas", "pages"]}},
    "required": ["topic"]}
REPORT = {"type": "object", "properties": {
    "to": {"type": "string", "maxLength": 6},
    "urgent": {"type": "boolean"}}, "required": ["to", "urgent"]}
EPISODE_TOKENS = 96


@pytest.fixture(scope="module")
def llms():
    """(the JAX package's LocalLLM, the port's) over the same tiny llama,
    schedulers started."""
    cfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jax.random.PRNGKey(99), cfg)
    geometry = dict(GEOMETRY, max_seq_len=2048)
    jsched = JScheduler(JCore(cfg, jconfig.EngineConfig(**geometry), jparams,
                              eos_id=JByte().eos_id), JByte())
    tcfg = llama.LlamaConfig.tiny(vocab_size=300)
    tsched = Scheduler(EngineCore(
        tcfg, tconfig.EngineConfig(**geometry),
        llama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg),
        eos_id=ByteTokenizer().eos_id, device="cpu"), ByteTokenizer())
    jsched.start()
    tsched.start()
    try:
        yield JLocalLLM(jsched), LocalLLM(tsched)
    finally:
        jsched.stop()
        tsched.stop()


def _validates(value, schema):
    """``value`` under the subset of JSON schema the tools above use."""
    if "enum" in schema:
        return value in schema["enum"]
    t = schema.get("type")
    if t == "string":
        return isinstance(value, str) and len(value) <= schema.get(
            "maxLength", 10 ** 9)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "object":
        props = schema.get("properties", {})
        return (isinstance(value, dict)
                and all(r in value for r in schema.get("required", []))
                and all(k in props and _validates(v, props[k])
                        for k, v in value.items()))
    return False


class _ToolChoice:
    """A LocalLLM with every tool turn under ``choice`` (ToolAgent sends
    "auto" always)."""

    def __init__(self, llm, choice):
        self.llm, self.choice = llm, choice

    def chat_tools(self, messages, tools, tool_choice="auto", **sampling):
        return self.llm.chat_tools(messages, tools, tool_choice=self.choice,
                                   **sampling)


def episode(mods, llm):
    """Two tools, ``report`` behind approval, two steps under the tool
    grammar; the first approval granted, any later one denied. Returns the
    plain events and the tool calls with their schemas."""
    agent_mod = mods["agent"]
    tools = [agent_mod.Tool(name="lookup", description="Look a topic up.",
                            parameters=LOOKUP,
                            fn=lambda topic: f"notes on {topic}"),
             agent_mod.Tool(name="report", description="Send a report.",
                            parameters=REPORT,
                            fn=lambda to, urgent: f"sent to {to}",
                            requires_approval=True)]
    sampling = dict(max_tokens=EPISODE_TOKENS, temperature=0.0)
    agent = agent_mod.ToolAgent(_ToolChoice(llm, "required"), tools,
                                max_steps=2, **sampling)
    events = list(agent.run("Look up llamas, then report it to ops."))
    approvals = 0
    while events[-1]["type"] == "approval_request":
        approvals += 1
        events += list(agent.resume(events[-1]["pending"],
                                    approved=approvals == 1,
                                    feedback="only one report"))
    schemas = {"lookup": LOOKUP, "report": REPORT}
    calls = [e["call"]["function"] for e in events
             if e["type"] in ("tool_call", "approval_request")]
    return _plain(events), [(c["name"], json.loads(c["arguments"]),
                             schemas[c["name"]]) for c in calls]


def test_tool_agent_episode_under_the_grammar_matches_jax(llms):
    out, prompts = {}, {}
    for package, llm in (("jax", llms[0]), ("torch", llms[1])):
        sched = llm.scheduler
        submitted, submit = [], sched.submit

        def spy(req, submitted=submitted, submit=submit):
            submitted.append(req)
            return submit(req)

        sched.submit = spy
        try:
            out[package] = episode(PACKAGES[package], llm)
        finally:
            sched.submit = submit
        prompts[package] = [list(r.prompt_ids) for r in submitted]
        assert all(r.grammar is not None for r in submitted)
        assert all(r.grammar_attached for r in submitted), package
    assert out["torch"] == out["jax"]
    assert prompts["torch"] == prompts["jax"]
    events, calls = out["torch"]
    assert calls and all(_validates(args, schema)
                         for _, args, schema in calls)
    assert json.loads(events[-1])["type"] == "final"
