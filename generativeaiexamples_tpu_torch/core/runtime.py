"""Where the port runs and where it builds: shared by every layer.

``resolve_device`` picks the device an entry point serves on (``cuda``
unless the caller asks for another, never a silent CPU fallback), and
``BUILD_DIR`` is where the hand-written CUDA kernels (``ops/cuda/build.py``)
and the native tokenizer core (``engine/native_tokenizer.py``) put what
they compile at first use: ``build/torch_kernels/`` at the repository
root, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent
    CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the PyTorch engine serves on the GPU; pass "
                "device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
