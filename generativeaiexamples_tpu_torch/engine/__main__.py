"""CLI entry: run the port's OpenAI-compatible model server.

    python -m generativeaiexamples_tpu_torch.engine [--tiny] [--port 8000]
        [--host 0.0.0.0] [--device cpu]

Serves on the GPU unless ``--device cpu`` is given. ``--tiny`` serves the
test-scale model with the byte tokenizer. With
``APP_ENGINE_CHECKPOINT_DIR`` set to a local HF Llama directory
(``config.json``, ``*.safetensors``, ``tokenizer.json``) it serves that
checkpoint: the architecture from ``config.json`` (``model_family`` is
ignored), the weights in ``APP_ENGINE_DTYPE``, the directory's tokenizer
and its end-of-turn id. Otherwise the architecture is
``APP_ENGINE_MODEL_FAMILY`` (default llama3-8b; also llama3-70b,
mixtral-8x7b, gemma-2b, gemma-7b, codegemma-7b, starcoder2-3b,
starcoder2-7b, tiny, tiny-moe, tiny-gemma and tiny-starcoder2, the
reference's names; mixtral-8x7b's 32 layers take 93.4 GB in bf16, past
one card, and a StarCoder2 config's sliding window raises on the card
until the kernels take it, ROADMAP A.12) with random weights drawn from a
seeded generator on the device, and the byte tokenizer. An HF directory
must hold a Llama architecture: ``config.json`` of another
(``GemmaForCausalLM``) is refused, as the reference's loader refuses it.
Engine knobs come from ``APP_ENGINE_*`` (``core/config.py``): speculative
decoding is on by default (``APP_ENGINE_SPEC_DECODE=off`` turns it off),
``APP_ENGINE_QUANT=int8`` serves int8 weights (loaded or drawn and
quantized one matrix at a time; llama3-70b fits one 80 GB card only so),
and the mixed-phase dispatch follows ``APP_MIXED_PHASE_DISPATCH`` (auto:
on for a CUDA device, off on the CPU; ``on`` runs it on the CPU too). Two
decode dispatches stay in flight (``APP_ENGINE_PIPELINE_DEPTH``), ramps
hold decode for up to 16 prefill chunks (``APP_ENGINE_PREFILL_HOLD_CHUNKS``)
and pure decode dispatches take the narrowest batch-width rung
(``APP_ENGINE_DECODE_WIDTH_LADDER``). Multi-step decode is off by default:
``APP_DECODE_MULTISTEP=8`` (or ``APP_ENGINE_DECODE_MULTISTEP``) runs
eligible fleets K·M steps a dispatch with one fetch, and
``APP_ENGINE_DECODE_STEPS_MAX=32`` deepens per-step dispatches up to 32
steps once the batch is half full. ``APP_ENGINE_ROLE`` picks the
disaggregated role: ``unified`` (default), ``prefill`` (serves
``/v1/kv/prefill`` only, never decodes, and its warmup skips the decode
programs) or ``decode`` (also imports ``/v1/kv/handoff`` bodies); any
worker serves ``GET /v1/kv/evacuation/<rid>``. ``APP_KV_SPILL_MB`` (or
``APP_ENGINE_KV_SPILL_MB``) arms the host spill pool of preempted slots'
pages (0, the default, recomputes); ``APP_EVAC_TTL_S`` (default 120) is
how long an evacuation snapshot waits to be pulled. Per-request LoRA adapters are
served once registered (``EngineCore.register_adapter``); loading them
from ``APP_ENGINE_ADAPTERS`` directories (the reference's orbax
checkpoints) waits for ROADMAP A.15, and a non-empty value exits with a
message that says so. Before it listens, the server runs
``EngineCore.warmup`` (every program once, the grammared and top-logprob
variants too, building every kernel on the card) and prints its seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import torch

from generativeaiexamples_tpu_torch.core.config import get_config
from generativeaiexamples_tpu_torch.core.runtime import resolve_device
from generativeaiexamples_tpu_torch.engine.engine import EngineCore
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.server import run_server
from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.models import (
    hf_loader, llama, model_config)


def build_scheduler(tiny: bool = False, device=None, seed: int = 0) -> tuple:
    """(Scheduler, model name) for the configured model on ``device``
    (``cuda`` unless the caller asks for another; raises with no GPU)."""
    spec = os.environ.get("APP_ENGINE_ADAPTERS", "").strip()
    if spec:
        # adapter directories are train/lora.py save_adapters' orbax
        # checkpoints there
        raise SystemExit(
            f"APP_ENGINE_ADAPTERS={spec!r}: loading adapter directories "
            f"(orbax checkpoints, train/checkpoints.py) is not ported yet "
            f"(ROADMAP A.15); register adapters with "
            f"EngineCore.register_adapter")
    dev = resolve_device(device)
    cfg = get_config()
    quant = cfg.engine.quant.strip().lower()
    ckpt = "" if tiny else cfg.engine.checkpoint_dir
    if ckpt and not hf_loader.is_hf_dir(ckpt):
        raise NotImplementedError(
            f"checkpoint {ckpt!r} is not an HF directory (config.json and "
            f"*.safetensors); orbax params directories "
            f"(train/checkpoints.py) are not ported (ROADMAP A.15)")
    tokenizer = get_tokenizer(ckpt)
    if ckpt:
        # int8 weights are quantized as each matrix is read, so a model
        # too large for the card in its dtype (llama3-70b) loads
        model_cfg, params = hf_loader.load_hf_dir(
            ckpt, device=dev, quant=quant, dtype=cfg.engine.dtype)
        model_name = cfg.llm.model_name
        logging.info("serving HF checkpoint %s (%d layers, dim %d)", ckpt,
                     model_cfg.n_layers, model_cfg.dim)
    else:
        if tiny:
            model_cfg = llama.LlamaConfig.tiny(vocab_size=300)
            seed, model_name = 5, "tiny-llama-test"
        else:
            model_cfg = dataclasses.replace(
                model_config(cfg.engine.model_family), dtype=cfg.engine.dtype)
            model_name = cfg.llm.model_name
            logging.warning("serving RANDOM weights (seed %d)", seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # int8 weights are quantized as they are drawn
        params = llama.init_params(gen, model_cfg, device=dev, quant=quant)
    core = EngineCore(model_cfg, cfg.engine, params,
                      eos_id=tokenizer.eos_id, device=dev)
    return Scheduler(core, tokenizer), model_name


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tiny", action="store_true",
                        help="serve the tiny test model")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run "
                             "without a GPU)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    scheduler, model_name = build_scheduler(tiny=args.tiny,
                                            device=args.device)
    # the tokenizer, so the constrained-decoding variants warm too
    seconds = scheduler.core.warmup(tokenizer=scheduler.tokenizer)
    print(f"warmup: {seconds:.3f} s (every serving program once)",
          flush=True)
    run_server(scheduler, model_name, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
