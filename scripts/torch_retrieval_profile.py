#!/usr/bin/env python3
"""Where the retrieval half of the RAG path spends its time, on one GPU.

    python3 scripts/torch_retrieval_profile.py

Two parts, each printing one JSON line, then the card's name and power
limit (``nvidia-smi``):

* ``search``: the stores of ``retrieval/bench_ivf.py`` at its defaults
  (1,000,000 x 384 clustered rows, nlist 1,024, nprobe 32), every query run
  once first; then per search the host's wall ms, the device ms of its
  kernels under ``torch.profiler`` (their sum over 8 searches, divided by
  8), the device-busy share, the kernels that take the most device time,
  and each step of a search timed alone on the device with CUDA events
  (20 launches each).
* ``encoders``: e5-base in bf16 with seeded random weights, an
  ``Embedder`` without and with its micro-batcher (2 ms window) and a
  ``Reranker``: host ms of one query's embedding and of one 40-pair
  rerank, and the device ms of their kernels under ``torch.profiler``.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from generativeaiexamples_tpu_torch.retrieval import bench_ivf  # noqa: E402
from generativeaiexamples_tpu_torch.retrieval import store as store_mod  # noqa: E402

PROFILED = 8        # calls under torch.profiler
EVENT_REPS = 20     # launches of a step between CUDA events


def host_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_profile(fn, calls=PROFILED, top=6):
    """(device ms a call: the sum of its kernels' times, the kernels with
    the most device time as (name, ms a call))."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    total = sum(by_name.values()) / 1e3 / calls
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return total, [(name[:80], us / 1e3 / calls) for name, us in ranked]


def event_ms(fn, reps=EVENT_REPS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def search_part(dev):
    emb, qs = bench_ivf.corpus()
    exact, ivf, _, _ = bench_ivf.build_stores(emb, device=dev)
    out = {"part": "search", "n": len(emb), "dim": emb.shape[1],
           "nlist": ivf.nlist, "nprobe": ivf.nprobe}
    for name, st in (("exact", exact), ("ivf", ivf)):
        for q in qs:
            st.search(q, top_k=10)
        it = iter(np.concatenate([qs] * 64))
        wall = host_ms(lambda: st.search(next(it), top_k=10), len(qs))
        dev_ms, kernels = device_profile(
            lambda: st.search(next(it), top_k=10))
        out[name] = {"host_ms_per_search": wall,
                     "device_ms_per_search": dev_ms,
                     "device_busy_share": dev_ms / wall,
                     "top_kernels_ms": kernels}
    q = torch.from_numpy(qs[0]).to(dev)
    valid = torch.from_numpy(ivf._valid_host.copy()).to(dev)
    g, gi, c = ivf._grouped, ivf._grouped_ids, ivf._centroids
    probe = torch.topk(c @ q, ivf.nprobe).indices
    steps = {
        "valid_mask_upload": lambda: torch.from_numpy(
            ivf._valid_host.copy()).to(dev),
        "exact_search": lambda: store_mod._topk_scores(exact._matrix, q,
                                                       valid, 10),
        "ivf_search": lambda: store_mod._ivf_search(g, gi, c, valid, q,
                                                    ivf.nprobe, 10),
        "ivf_centroids_topk": lambda: torch.topk(c @ q, ivf.nprobe),
        "ivf_gather": lambda: g[probe],
        "ivf_gather_and_product": lambda: torch.einsum("pcd,d->pc",
                                                       g[probe], q),
        "ivf_valid_gather": lambda: valid[gi[probe].clamp(min=0)],
    }
    out["step_device_ms"] = {k: event_ms(fn) for k, fn in steps.items()}
    out["matrix_bytes"] = exact._matrix.numel() * 4
    out["gathered_bytes"] = g[probe].numel() * 4
    return out


def encoder_part(dev):
    from generativeaiexamples_tpu_torch.encoders import Embedder, Reranker
    from generativeaiexamples_tpu_torch.models import bert
    cfg = bert.BertConfig.e5_base()
    plain = Embedder(cfg=cfg, device=dev, dtype="bfloat16")
    batched = Embedder(cfg=cfg, params=plain.params, device=dev,
                       dtype="bfloat16", micro_window_s=0.002)
    rer = Reranker(cfg=cfg, device=dev, dtype="bfloat16")
    query = "How are the CUDA kernels built and checked on the card?"
    passages = [f"passage {i}: " + "the paged KV cache keeps pages " * 14
                for i in range(40)]
    out = {"part": "encoders", "encoder": "e5-base, bfloat16",
           "rerank_pairs": len(passages),
           "rerank_pair_tokens": len(rer._pack_pairs(
               [(query, passages[0])])[0][0])}
    calls = {
        "embed_query": lambda: plain.embed_queries([query]),
        "embed_query_microbatched": lambda: batched.embed_queries([query]),
        "rerank_40": lambda: rer.score(query, passages),
    }
    for name, fn in calls.items():
        wall = host_ms(fn, 20)
        dev_ms, kernels = device_profile(fn)
        out[name] = {"host_ms": wall, "device_ms": dev_ms,
                     "device_busy_share": dev_ms / wall,
                     "top_kernels_ms": kernels}
    batched.close()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_retrieval_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps(search_part(dev)), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps(encoder_part(dev)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
