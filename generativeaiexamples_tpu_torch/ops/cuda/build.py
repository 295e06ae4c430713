"""Build-on-first-use for the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), and is loaded with ``ctypes``. Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of every
``.cu``/``.cuh`` source and the compiler flags, so editing a source
rebuilds and an unchanged tree reuses what is there. ``build_all`` starts
every compile at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the
port, and ``nvcc`` is needed only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from generativeaiexamples_tpu_torch.core.runtime import BUILD_DIR

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
KERNEL_SOURCES = ("flash_prefill", "ragged_paged", "ragged_decode",
                  "sample_slots", "w8a16_gemm", "grammar_mask", "lora")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# launches of each kernel, raised by one by its wrapper where it launches
# (ops/cuda/attention.py, ops/cuda/sampling.py, ops/cuda/quant.py,
# ops/cuda/grammar.py, ops/cuda/lora.py), and nowhere else
LAUNCHES: Dict[str, int] = {"flash_prefill": 0, "ragged_paged_attention": 0,
                            "ragged_paged_attention_int8": 0,
                            "ragged_decode": 0, "sample_slots": 0,
                            "w8a16_gemm": 0, "grammar_mask": 0, "lora": 0}
# sample_slots' launches by variant, beside LAUNCHES["sample_slots"]: the
# options a launch took ("mask", "advance", "top", joined by "+"), or
# "plain" for none
SAMPLER_VARIANTS: Dict[str, int] = {}
# w8a16_gemm's launches by activation rows, beside LAUNCHES["w8a16_gemm"]:
# "m<=R" for a decode tile of R rows (M <= 128), "m=M" above
GEMM_ROWS: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(LAUNCHES)


def gemm_launches_by_rows() -> Dict[str, int]:
    """``w8a16_gemm`` launches by activation rows since the last
    :func:`reset_launch_counts`."""
    return dict(sorted(GEMM_ROWS.items(),
                       key=lambda kv: int(kv[0].lstrip("m<="))))


def sampler_launches_by_variant() -> Dict[str, int]:
    """``sample_slots`` launches by variant since the last
    :func:`reset_launch_counts`."""
    return dict(sorted(SAMPLER_VARIANTS.items()))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    GEMM_ROWS.clear()
    SAMPLER_VARIANTS.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def source_digest() -> str:
    """Hash of every kernel source and the flags (the rebuild key)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(SRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(SRC_DIR, name), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{source_digest()}.so")


def build_all(names=KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together. Returns seconds per library built (empty when all were
    current). Raises with the compiler's output if any build fails; the
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept next
    to each library as ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", SRC_DIR,
               os.path.join(SRC_DIR, f"{name}.cu"), "-o", tmp]
        log = open(f"{out}.log", "w")
        procs.append((name, out, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    seconds: Dict[str, float] = {}
    failed: List[str] = []
    for name, out, tmp, log, t0, proc in procs:
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = -1
        finally:
            log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            with open(f"{out}.log") as fh:
                failed.append(f"{name} (rc {rc}):\n{fh.read()[-4000:]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
