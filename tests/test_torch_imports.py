"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

Every module of ``generativeaiexamples_tpu_torch`` imports in a fresh
interpreter whose import system refuses ``jax``, ``jaxlib`` and exactly
``generativeaiexamples_tpu[.*]`` (the port's own name shares that prefix,
so the match is on the top-level name). An AST scan of the sources and of
``chip_smoke.py`` finds no such import either, and the entry points refuse
to fall back to the CPU when no GPU is present. The packages the serving
machine lacks (``tokenizers``, ``safetensors``, ``transformers``) are
imported by no module of the port nor the smoke, but inside
``HFTokenizer.__init__``, which only a refused ``tokenizer.json`` reaches.
Nor does it need the chain server's packages there (``aiohttp``,
``bleach``, ``httpx``, ``requests``, ``yaml``, ``bs4``): with them refused
every module imports and the port's chain server answers a ``/generate``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "generativeaiexamples_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "generativeaiexamples_tpu")
# packages the serving machine lacks: the port reads safetensors and
# tokenizer.json itself, and imports `tokenizers` only inside HFTokenizer
HF_PACKAGES = ("tokenizers", "safetensors", "transformers")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _modules():
    for path in _sources():
        if path.startswith(PKG):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_forbidden_name_match_is_exact():
    assert _forbidden("generativeaiexamples_tpu.models.llama")
    assert _forbidden("jax.numpy")
    assert not _forbidden("generativeaiexamples_tpu_torch.models.llama")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_nothing_of_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_GUARD = r'''
import importlib, importlib.abc, sys
FORBIDDEN = ("jax", "jaxlib", "generativeaiexamples_tpu")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import of " + name)
        return None
for mod in list(sys.modules):
    if mod.split(".")[0] in FORBIDDEN:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not leaked, leaked
print("ok", len(sys.argv) - 1)
'''


def test_every_module_imports_with_jax_refused():
    mods = sorted(_modules())
    proc = subprocess.run([sys.executable, "-c", _GUARD, *mods], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"ok {len(mods)}"


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_hf_packages_only_in_hftokenizer(path):
    """``tokenizers``, ``safetensors`` and ``transformers`` are imported
    nowhere in the port or the smoke but inside ``HFTokenizer.__init__``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    allowed = set()
    if path == os.path.join(PKG, "engine", "tokenizer.py"):
        for cls in tree.body:
            if isinstance(cls, ast.ClassDef) and cls.name == "HFTokenizer":
                for fn in cls.body:
                    if isinstance(fn, ast.FunctionDef) and \
                            fn.name == "__init__":
                        allowed = {id(n) for n in ast.walk(fn)}
        assert allowed, "HFTokenizer.__init__ not found"
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        bad = [n for n in names if n.split(".")[0] in HF_PACKAGES]
        assert not bad or id(node) in allowed, \
            f"{path}:{node.lineno} imports {bad}"


def test_every_module_imports_without_hf_packages():
    """Every module of the port and the smoke script import with
    ``tokenizers``, ``safetensors`` and ``transformers`` refused."""
    guard = _GUARD.replace(
        'FORBIDDEN = ("jax", "jaxlib", "generativeaiexamples_tpu")',
        f"FORBIDDEN = {HF_PACKAGES!r}")
    assert guard != _GUARD
    mods = sorted(_modules()) + ["chip_smoke"]
    proc = subprocess.run([sys.executable, "-c", guard, *mods], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"ok {len(mods)}"


def test_every_module_imports_without_ml_dtypes():
    """The card's machine has no ``ml_dtypes``: every module of the port
    and the smoke script import with it refused (the KV wire reads bf16
    as its raw 2-byte words), and no source imports it."""
    guard = _GUARD.replace(
        'FORBIDDEN = ("jax", "jaxlib", "generativeaiexamples_tpu")',
        'FORBIDDEN = ("ml_dtypes",)')
    assert guard != _GUARD
    mods = sorted(_modules()) + ["chip_smoke"]
    proc = subprocess.run([sys.executable, "-c", guard, *mods], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"ok {len(mods)}"
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not [n for n in names if n.split(".")[0] == "ml_dtypes"], \
                f"{path}:{node.lineno} imports ml_dtypes"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no GPU and no explicit CPU request the entry points raise; an
    explicit ``device='cpu'`` works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from generativeaiexamples_tpu_torch.core.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
    from generativeaiexamples_tpu_torch.engine.engine import EngineCore
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(cfg, EngineConfig(max_seq_len=512), params, eos_id=257)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scheduler(tiny=True)
    sched, name = build_scheduler(tiny=True, device="cpu")
    assert name == "tiny-llama-test" and sched.core.device.type == "cpu"


def test_unported_config_knobs_are_refused(monkeypatch):
    from generativeaiexamples_tpu_torch.core.config import load_config
    from generativeaiexamples_tpu_torch.models import model_config

    monkeypatch.setenv("APP_ENGINE_LONG_PREFILL", "on")
    with pytest.raises(NotImplementedError, match="A11"):
        load_config()
    monkeypatch.delenv("APP_ENGINE_LONG_PREFILL")
    monkeypatch.setenv("APP_ENGINE_QUANT", "int8")        # ported
    assert load_config().engine.quant == "int8"
    monkeypatch.setenv("APP_ENGINE_KV_QUANT", "int8")     # ported
    assert load_config().engine.kv_quant == "int8"
    monkeypatch.setenv("APP_ENGINE_PREFILL_CHUNK", "256")
    assert load_config().engine.prefill_chunk == 256
    # the Gemma family is ported; StarCoder2 and the MoE configs are not
    assert model_config("gemma-2b").head_dim == 256
    for name in ("starcoder2-3b", "mixtral-8x7b"):
        with pytest.raises(NotImplementedError, match=r"A\.12"):
            model_config(name)


# the host planes' second part, looked up by the port's own module names
PLANE_MODULES = ("generativeaiexamples_tpu_torch.engine.qos",
                 "generativeaiexamples_tpu_torch.observability.alerts",
                 "generativeaiexamples_tpu_torch.observability.forensics")


def test_plane_modules_are_scanned_and_found_by_their_port_names():
    """The QoS, alert and forensics modules are among the modules every
    case above imports and scans; the flight dump, ``/debug/qos`` and the
    doctor find the QoS plane under the port's name (a lookup under the
    reference's name would never find it, and a dump would silently lack
    ``qos``)."""
    assert set(PLANE_MODULES) <= set(_modules())
    for rel in ("observability/flight.py", "observability/forensics.py",
                "server/common.py"):
        with open(os.path.join(PKG, rel)) as fh:
            src = fh.read()
        assert 'sys.modules.get("generativeaiexamples_tpu_torch.engine.qos")' \
            in src, rel


# the chain server's packages there, which the card's machine lacks
WEB_PACKAGES = ("aiohttp", "bleach", "httpx", "requests", "yaml", "bs4")

_CHAIN_SERVER = r'''
import json, urllib.request
from generativeaiexamples_tpu_torch.chains.basic_rag import BasicRAG
from generativeaiexamples_tpu_torch.server.__main__ import tiny_context
from generativeaiexamples_tpu_torch.server.api import serve_in_thread
ctx = tiny_context("cpu")
_, httpd, thread = serve_in_thread(BasicRAG(context=ctx))
try:
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % httpd.server_address[1],
        data=json.dumps({"messages": [{"role": "user", "content": "<b>hi</b>"}],
                         "use_knowledge_base": False, "max_tokens": 4,
                         "temperature": 0.0}).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": "r1"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        frames = [f for f in resp.read().decode().split("\n\n") if f]
finally:
    httpd.shutdown()
    httpd.server_close()
    ctx.llm.scheduler.stop()
assert frames[-1] == "data: [DONE]", frames
assert json.loads(frames[-2][6:])["choices"][0]["finish_reason"] == "stop"
assert json.loads(frames[0][6:])["id"] == "r1"
leaked = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not leaked, leaked
print("served", len(frames))
'''


def test_every_module_imports_and_serves_without_web_packages():
    """``aiohttp``, ``bleach``, ``httpx``, ``requests``, ``yaml`` and
    ``bs4`` refused: every module of the port and the smoke script import,
    and the port's chain server answers one ``/generate`` on the CPU."""
    guard = _GUARD.replace(
        'FORBIDDEN = ("jax", "jaxlib", "generativeaiexamples_tpu")',
        f"FORBIDDEN = {WEB_PACKAGES!r}")
    assert guard != _GUARD
    mods = sorted(_modules()) + ["chip_smoke"]
    proc = subprocess.run([sys.executable, "-c", guard + _CHAIN_SERVER,
                           *mods], cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.split()
    assert lines[:2] == ["ok", str(len(mods))] and lines[2] == "served"


def test_chain_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no GPU and no explicit device the chain context and the chain
    server's CLI raise; their engine and encoders would run on ``cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from generativeaiexamples_tpu_torch.chains import context
    from generativeaiexamples_tpu_torch.server import __main__ as cli
    monkeypatch.setattr(context, "_context", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.get_context()
    assert context._context is None
    monkeypatch.setattr(sys, "argv", ["server", "--example", "basic_rag"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main()
