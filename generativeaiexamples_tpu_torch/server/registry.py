"""Explicit example registry.

Port of ``generativeaiexamples_tpu/server/registry.py``: examples register
by name (``register_example``), and ``get_example`` instantiates the one
named (or ``EXAMPLE``, default ``basic_rag``), importing its module on
first use. ``_KNOWN`` maps the names to the port's modules. The
reference's other chains are not ported yet: naming one raises
``KeyError`` with the ROADMAP item that ports it, as the reference raises
for a module that is missing.
"""

from __future__ import annotations

import importlib
import logging
import os
from typing import Callable, Dict, Optional

from generativeaiexamples_tpu_torch.server.base import BaseExample

logger = logging.getLogger(__name__)

_REGISTRY: Dict[str, Callable[..., BaseExample]] = {}

# name -> module that registers it on import (lazy, so chains' deps load
# only when selected)
_KNOWN = {
    "basic_rag": "generativeaiexamples_tpu_torch.chains.basic_rag",
    "multi_turn_rag": "generativeaiexamples_tpu_torch.chains.multi_turn_rag",
    "query_decomposition_rag":
        "generativeaiexamples_tpu_torch.chains.query_decomposition",
    "agentic_rag": "generativeaiexamples_tpu_torch.chains.agentic_rag",
    "router_rag": "generativeaiexamples_tpu_torch.chains.router_rag",
    "text_to_sql": "generativeaiexamples_tpu_torch.chains.text_to_sql",
    "structured_data_rag":
        "generativeaiexamples_tpu_torch.chains.structured_data",
    "knowledge_graph_rag":
        "generativeaiexamples_tpu_torch.chains.knowledge_graph_rag",
}

# the reference's examples that wait for a later part of the port
NOT_PORTED = {
    "multimodal_rag": "A.16",
    "asr_stream_rag": "A.16",
}


def register_example(name: str):
    def wrap(factory: Callable[..., BaseExample]):
        _REGISTRY[name] = factory
        return factory
    return wrap


def get_example(name: Optional[str] = None, **kwargs) -> BaseExample:
    """Instantiate the selected example (env ``EXAMPLE``, default basic_rag)."""
    name = name or os.environ.get("EXAMPLE", "basic_rag")
    if name not in _REGISTRY:
        if name in NOT_PORTED:
            raise KeyError(
                f"example {name!r} is not implemented yet in the PyTorch "
                f"port (ROADMAP {NOT_PORTED[name]})")
        module = _KNOWN.get(name)
        if module is None:
            raise KeyError(f"unknown example {name!r}; known: "
                           f"{sorted(set(_KNOWN) | set(NOT_PORTED))}")
        importlib.import_module(module)
    if name not in _REGISTRY:
        raise KeyError(f"module for {name!r} imported but did not register")
    logger.info("serving example: %s", name)
    return _REGISTRY[name](**kwargs)
