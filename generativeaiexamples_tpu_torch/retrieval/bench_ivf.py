"""IVF vs exact search microbench at million-vector scale.

    python -m generativeaiexamples_tpu_torch.retrieval.bench_ivf [--n 1000000] [--device cpu]

Port of ``generativeaiexamples_tpu/retrieval/bench_ivf.py``, with the same
arguments, defaults, clustered corpus (a mixture of Gaussians from
``np.random.default_rng(0)``) and JSON line, plus ``--device`` (``cuda``
unless given), each store's device bytes, and each path timed a second
time once every query has run (``*_warm``: PyTorch's first calls of a
shape pay for allocations where JAX's pay for compiles). The parity target is
Milvus ``GPU_IVF_FLAT``: a probe-bounded index whose per-query work does
not grow with N. It prints per-query latency for the exact path and the
IVF gather path over the same corpus, and recall@10 of IVF against the
exact ranking.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.store import Document, VectorStore


def _timed_queries(store: VectorStore, queries: np.ndarray, top_k: int):
    results = []
    store.search(queries[0], top_k=top_k)          # warm up
    t0 = time.perf_counter()
    for q in queries:
        results.append(store.search(q, top_k=top_k))
    wall = time.perf_counter() - t0
    return wall / len(queries), results


def corpus(n: int = 1_000_000, dim: int = 384, nlist: int = 1024,
           queries: int = 32):
    """The benchmark's rows (a mixture of ``nlist // 2`` Gaussians, unit
    rows: IVF's intended regime, and what real embedding spaces look like)
    and its queries (rows plus noise), from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    n_modes = max(nlist // 2, 1)
    modes = rng.standard_normal((n_modes, dim)).astype(np.float32)
    which = rng.integers(0, n_modes, n)
    emb = modes[which] + 0.15 * rng.standard_normal(
        (n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q_ix = rng.integers(0, n, queries)
    qs = emb[q_ix] + 0.05 * rng.standard_normal(
        (queries, dim)).astype(np.float32)
    return emb, qs


def build_stores(emb: np.ndarray, nlist: int = 1024, nprobe: int = 32,
                 top_k: int = 10, device=None):
    """(exact store, IVF store, ingest s, IVF build s) over ``emb``, added
    in chunks of 100,000 rows; the IVF index is built by a first search."""
    n, dim = emb.shape
    docs = [Document(content=str(i)) for i in range(n)]
    exact = VectorStore(dim=dim, index_type="exact", device=device)
    ivf = VectorStore(dim=dim, index_type="ivf", nlist=nlist, nprobe=nprobe,
                      device=device)
    t0 = time.perf_counter()
    chunk = 100_000
    for s in range(0, n, chunk):
        exact.add(docs[s:s + chunk], emb[s:s + chunk])
        ivf.add(docs[s:s + chunk], emb[s:s + chunk])
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf.search(emb[0], top_k=top_k)      # build (train + group) once
    return exact, ivf, ingest_s, time.perf_counter() - t0


def run(n: int = 1_000_000, dim: int = 384, nlist: int = 1024,
        nprobe: int = 32, queries: int = 32, top_k: int = 10,
        device=None) -> dict:
    """The benchmark's JSON fields over a fresh pair of stores. The
    ``*_warm`` fields time the same queries a second time, after every
    query has run once."""
    emb, qs = corpus(n, dim, nlist, queries)
    exact, ivf, ingest_s, build_s = build_stores(emb, nlist, nprobe, top_k,
                                                 device)
    exact_s, exact_res = _timed_queries(exact, qs, top_k)
    ivf_s, ivf_res = _timed_queries(ivf, qs, top_k)
    exact_warm_s, _ = _timed_queries(exact, qs, top_k)
    ivf_warm_s, _ = _timed_queries(ivf, qs, top_k)

    recalls = []
    for e_hits, i_hits in zip(exact_res, ivf_res):
        truth = {d.content for d, _ in e_hits}
        got = {d.content for d, _ in i_hits}
        recalls.append(len(truth & got) / max(len(truth), 1))

    cell_cap = ivf._grouped.shape[1]
    return {
        "n": n, "dim": dim,
        "nlist": nlist, "nprobe": nprobe,
        "exact_ms_per_query": round(exact_s * 1e3, 3),
        "ivf_ms_per_query": round(ivf_s * 1e3, 3),
        "speedup": round(exact_s / ivf_s, 2),
        "recall_at_10_vs_exact": round(float(np.mean(recalls)), 4),
        "rows_scanned_ivf": nprobe * cell_cap,
        "rows_scanned_exact": n,
        "build_s": round(build_s, 2),
        "ingest_s": round(ingest_s, 2),
        "device": str(exact.device),
        "exact_ms_per_query_warm": round(exact_warm_s * 1e3, 3),
        "ivf_ms_per_query_warm": round(ivf_warm_s * 1e3, 3),
        "exact_store_bytes": exact.nbytes,
        "ivf_store_bytes": ivf.nbytes,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)     # e5-small class
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args()
    print(json.dumps(run(args.n, args.dim, args.nlist, args.nprobe,
                         args.queries, args.top_k, args.device)))


if __name__ == "__main__":
    main()
