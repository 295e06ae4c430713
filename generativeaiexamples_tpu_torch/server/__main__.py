"""CLI entry: run the port's chain server.

    python -m generativeaiexamples_tpu_torch.server [--example basic_rag]
        [--port 8081] [--host 0.0.0.0] [--tiny] [--device cpu]

One server, the example chosen by flag or the ``EXAMPLE`` env (default
``basic_rag``; ``multi_turn_rag`` is the other ported one). It serves on
the GPU unless ``--device cpu`` is given, and with no GPU it raises. The
chains' context is the reference's: the LLM from ``APP_LLM_SERVER_URL``
(one remote ``/v1`` server) or the in-process engine (the tiny model
unless ``APP_ENGINE_CHECKPOINT_DIR`` names a checkpoint), and e5-base
encoders with the configured micro-batch windows. ``--tiny`` serves the
tiny engine and tiny BERT encoders (tests, a quick look on the CPU).
There is no ``core/debug.install`` (ROADMAP A.17).
"""

from __future__ import annotations

import argparse
import logging
import os


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--example", default=None, help="chain to serve")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8081)
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny engine and tiny encoders (tests/dev)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run "
                             "without a GPU)")
    args = parser.parse_args()
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO").upper())

    from generativeaiexamples_tpu_torch.chains.context import (
        get_context, set_context)
    from generativeaiexamples_tpu_torch.server.api import run_server
    from generativeaiexamples_tpu_torch.server.registry import get_example

    if args.tiny:
        set_context(tiny_context(args.device))
    else:
        get_context(device=args.device)
    example = get_example(args.example)
    run_server(example, host=args.host, port=args.port)


def tiny_context(device=None):
    """A ChainContext over the tiny engine (started) and tiny BERT
    encoders with the configured micro-batch windows, on ``device``."""
    from generativeaiexamples_tpu_torch.chains.context import ChainContext
    from generativeaiexamples_tpu_torch.chains.llm_client import LocalLLM
    from generativeaiexamples_tpu_torch.core.config import get_config
    from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
    from generativeaiexamples_tpu_torch.engine.__main__ import build_scheduler
    from generativeaiexamples_tpu_torch.models import bert

    config = get_config()
    scheduler, _ = build_scheduler(tiny=True, device=device)
    scheduler.start()
    return ChainContext(
        config=config, llm=LocalLLM(scheduler),
        embedder=Embedder(cfg=bert.BertConfig.tiny(), device=device,
                          micro_window_s=(
                              config.embeddings.microbatch_window_ms / 1e3)),
        reranker=Reranker(cfg=bert.BertConfig.tiny(), device=device,
                          micro_window_s=(
                              config.ranking.microbatch_window_ms / 1e3)))


if __name__ == "__main__":
    main()
