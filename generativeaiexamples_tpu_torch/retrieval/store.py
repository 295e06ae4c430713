"""In-process vector store with device matmul search (exact and IVF).

Port of ``generativeaiexamples_tpu/retrieval/store.py``: add, search
(top-k with a score threshold), list-sources and delete-by-source over
one named collection, the vector-store operations the reference's chain
server exercises.

The vectors live in a matrix on the store's device, grown in power-of-two
blocks from 256 rows on the device. Exact search is one matrix-vector
product, the invalid rows masked, and ``torch.topk``. IVF (Milvus
``GPU_IVF_FLAT`` parity) clusters with k-means seeded from
``np.random.default_rng(0)`` into a cell-major ``(nlist, cell_cap, dim)``
layout on the device and gathers ONLY the ``nprobe`` probed cells'
vectors per query: bounded work per search whatever N, at the cost of a
second padded copy of the vectors. The assignment is capacity-balanced
(a cell holds at most twice the mean; overflow spills to the next-nearest
centroid, stragglers to the emptiest cell), k-means retrains only when
the live rows double, and adds in between are assigned incrementally.
Cosine scores in [-1, 1] map to the [0, 1] the reference's
``score_threshold`` default of 0.25 expects.

The snapshot contract: ``search`` takes references to the matrix, the
grouped layout and a device copy of the valid mask under the lock, and
scores outside it, so concurrent searches do not serialise on the lock.
That is safe because nothing the store publishes is ever written again:
``add`` and the IVF builds write a new tensor and then publish it (the
reference's ``dynamic_update_slice`` and ``.at[].set`` do the same), so a
search holding the old tensors sees the state it snapshotted.

``device`` is ``cuda`` unless the caller asks for another
(``core/runtime.resolve_device``).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.runtime import resolve_device


@dataclass
class Document:
    content: str
    metadata: Dict[str, object] = field(default_factory=dict)
    doc_id: str = field(default_factory=lambda: uuid.uuid4().hex)


def _topk_scores(matrix: torch.Tensor, query: torch.Tensor,
                 valid: torch.Tensor, k: int):
    """scores = matrix @ query, invalid rows masked; returns (vals, idx)."""
    scores = matrix @ query                                # (N,)
    scores = scores.masked_fill(~valid, float("-inf"))
    return torch.topk(scores, k)


def _ivf_search(grouped: torch.Tensor, grouped_ids: torch.Tensor,
                centroids: torch.Tensor, valid: torch.Tensor,
                query: torch.Tensor, nprobe: int, k: int):
    """Score the centroids, gather ONLY the probed cells' vectors and
    product those with the query: nprobe * cell_cap * dim work per query
    whatever N. Returns (scores, original row ids); padding and deleted
    rows come back as -inf."""
    cell_scores = centroids @ query                        # (nlist,)
    probe = torch.topk(cell_scores, nprobe).indices        # (nprobe,)
    sub = grouped[probe]                                   # (nprobe, cap, dim)
    ids = grouped_ids[probe]                               # (nprobe, cap)
    scores = torch.einsum("pcd,d->pc", sub, query)
    # ids of -1 mark padding
    ok = (ids >= 0) & valid[ids.clamp(min=0)]
    scores = scores.masked_fill(~ok, float("-inf"))
    vals, flat = torch.topk(scores.reshape(-1), k)
    return vals, ids.reshape(-1)[flat]


class VectorStore:
    """One named collection (the reference's ``collection_name``)."""

    def __init__(self, dim: int, index_type: str = "exact", nlist: int = 64,
                 nprobe: int = 16, name: str = "default", device=None) -> None:
        self.dim = dim
        self.name = name
        self.index_type = index_type
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._docs: List[Optional[Document]] = []
        self._capacity = 0
        self._matrix: Optional[torch.Tensor] = None      # (cap, dim) f32
        self._valid_host = np.zeros((0,), bool)
        self._centroids: Optional[torch.Tensor] = None   # (nlist, dim)
        self._grouped: Optional[torch.Tensor] = None     # (nlist, cap, dim)
        self._grouped_ids: Optional[torch.Tensor] = None  # (nlist, cap) ids
        self._ivf_dirty = True
        self._ivf_trained_n = 0     # live rows at the last k-means training
        self._ivf_upto = 0          # docs rows already inserted into grouped
        self._cell_fill: Optional[np.ndarray] = None     # (nlist,) host

    @property
    def nbytes(self) -> int:
        """Device bytes the store holds: the matrix, and for IVF the
        centroids and the grouped layout with its ids."""
        return sum(t.numel() * t.element_size() for t in (
            self._matrix, self._centroids, self._grouped, self._grouped_ids)
            if t is not None)

    # ------------------------------------------------------------------ add

    def add(self, docs: Sequence[Document], embeddings: np.ndarray) -> List[str]:
        if len(docs) != len(embeddings):
            raise ValueError("docs/embeddings length mismatch")
        emb = np.asarray(embeddings, np.float32)
        emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9, None)
        rows = torch.from_numpy(emb).to(self.device)
        with self._lock:
            n_old = len(self._docs)
            n_new = n_old + len(docs)
            # a new matrix, published whole: a search holding the old one
            # never sees these writes
            if n_new > self._capacity:
                cap = max(256, self._capacity)
                while cap < n_new:
                    cap *= 2
                matrix = torch.zeros((cap, self.dim), dtype=torch.float32,
                                     device=self.device)
                if self._matrix is not None:
                    matrix[:n_old] = self._matrix[:n_old]    # on the device
                self._capacity = cap
                self._valid_host = np.resize(self._valid_host, cap)
                self._valid_host[n_old:] = False
            else:
                matrix = self._matrix.clone()
            matrix[n_old:n_new] = rows
            self._matrix = matrix
            self._docs.extend(docs)
            self._valid_host[n_old:n_new] = True
            self._ivf_dirty = True
            return [d.doc_id for d in docs]

    # --------------------------------------------------------------- search

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: float = 0.0) -> List[Tuple[Document, float]]:
        # under the lock: snapshot only (see the module docstring)
        with self._lock:
            if not self._docs or self._matrix is None:
                return []
            valid = torch.from_numpy(self._valid_host.copy()).to(self.device)
            matrix = self._matrix
            k = min(top_k, self._capacity)
            # gate on *live* rows (deleted entries stay as None
            # placeholders); an all-deleted store falls through to brute
            # force rather than k-means over zero vectors
            n_live = int(np.count_nonzero(self._valid_host[: self._capacity]))
            use_ivf = self.index_type == "ivf" and n_live > self.nlist * 4
            if use_ivf:
                self._maybe_build_ivf()
                grouped, grouped_ids = self._grouped, self._grouped_ids
                centroids = self._centroids
        q = torch.from_numpy(np.array(query_embedding, np.float32)).to(
            self.device)
        q = q / torch.linalg.vector_norm(q).clamp(min=1e-9)
        if use_ivf:
            k = min(k, self.nprobe * grouped.shape[1])
            vals, idx = _ivf_search(grouped, grouped_ids, centroids, valid, q,
                                    self.nprobe, k)
        else:
            vals, idx = _topk_scores(matrix, q, valid, k)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        out: List[Tuple[Document, float]] = []
        for score, i in zip(vals, idx):
            if not np.isfinite(score):
                continue
            # rows only append, and a delete leaves None: a row deleted
            # since the snapshot is skipped here
            doc = self._docs[int(i)]
            if doc is None:
                continue
            relevance = (float(score) + 1.0) / 2.0  # cosine -> [0, 1]
            if relevance >= score_threshold:
                out.append((doc, relevance))
        return out

    # ------------------------------------------------------------------ IVF

    def _maybe_build_ivf(self, iters: int = 8) -> None:
        """(Re)build the probe index (the caller holds the lock).

        k-means retrains only when the live rows have doubled since the
        last training; other dirty builds assign the new rows to the
        existing centroids. cell_cap is the largest cell rounded up to a
        power of two."""
        if not self._ivf_dirty and self._centroids is not None:
            return
        n_live = int(np.count_nonzero(self._valid_host[: self._capacity]))
        if self._centroids is None or n_live >= 2 * self._ivf_trained_n:
            self._full_build_ivf(iters)
        else:
            self._insert_new_rows_ivf()
        self._ivf_upto = len(self._docs)
        self._ivf_dirty = False

    _ASSIGN_ROWS = 65536    # rows scored against the centroids at once

    def _full_build_ivf(self, iters: int) -> None:
        """Train k-means on the device and regroup everything (first
        build, or the live rows doubled since the last training)."""
        live_ix = np.flatnonzero(self._valid_host[: self._capacity])
        live = torch.from_numpy(live_ix).to(self.device)
        data = self._matrix[live]
        n_live = len(live_ix)
        rng = np.random.default_rng(0)
        seeds = rng.choice(n_live, self.nlist, replace=n_live < self.nlist)
        centroids = data[torch.from_numpy(seeds).to(self.device)]
        for _ in range(iters):
            assign = torch.cat([
                torch.argmax(data[s:s + self._ASSIGN_ROWS] @ centroids.T,
                             dim=1)
                for s in range(0, n_live, self._ASSIGN_ROWS)])
            sums = torch.zeros_like(centroids).index_add_(0, assign, data)
            counts = torch.bincount(assign, minlength=self.nlist)[:, None]
            new_c = torch.where(counts > 0,
                                sums / counts.clamp(min=1).float(), centroids)
            centroids = new_c / torch.linalg.vector_norm(
                new_c, dim=1, keepdim=True).clamp(min=1e-9)
        self._centroids = centroids
        self._ivf_trained_n = n_live
        # capacity-BALANCED assignment: raw k-means cells skew badly on
        # clustered data, and probe work scales with the LARGEST cell
        assign = self._balanced_assign(data)
        counts = np.bincount(assign, minlength=self.nlist)
        cell_cap = 1
        while cell_cap < max(int(counts.max()), 1):
            cell_cap *= 2
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        pos = np.arange(n_live) - starts[sorted_assign]
        cells = torch.from_numpy(sorted_assign.astype(np.int64)).to(self.device)
        slots = torch.from_numpy(pos.astype(np.int64)).to(self.device)
        order_t = torch.from_numpy(order).to(self.device)
        grouped = torch.zeros((self.nlist, cell_cap, self.dim),
                              dtype=torch.float32, device=self.device)
        grouped[cells, slots] = data[order_t]
        grouped_ids = torch.full((self.nlist, cell_cap), -1, dtype=torch.long,
                                 device=self.device)
        grouped_ids[cells, slots] = live[order_t]
        self._grouped = grouped
        self._grouped_ids = grouped_ids
        self._cell_fill = counts.astype(np.int64)

    _BALANCE_FACTOR = 2.0    # cell capacity as a multiple of the mean
    _SPILL_CHOICES = 4       # nearest centroids considered per row

    def _cell_capacity(self, n_live: int) -> int:
        return max(8, int(self._BALANCE_FACTOR * -(-n_live // self.nlist)))

    def _top_centroids(self, data: torch.Tensor) -> np.ndarray:
        """(N, _SPILL_CHOICES) nearest-centroid ranking of device rows."""
        K = min(self._SPILL_CHOICES, self.nlist)
        return torch.cat([
            torch.topk(data[s:s + self._ASSIGN_ROWS] @ self._centroids.T,
                       K).indices
            for s in range(0, len(data), self._ASSIGN_ROWS)]).cpu().numpy()

    def _balanced_assign(self, data: torch.Tensor) -> np.ndarray:
        """Assign rows to cells with a hard per-cell capacity: first-choice
        placement in distance order, overflow spills to the next-nearest
        choice, stragglers land in the emptiest cells."""
        n = len(data)
        cap = self._cell_capacity(n)
        choices = self._top_centroids(data)
        assign = np.full((n,), -1, np.int32)
        counts = np.zeros((self.nlist,), np.int64)
        for r in range(choices.shape[1]):
            undone = np.flatnonzero(assign < 0)
            if len(undone) == 0:
                break
            cand = choices[undone, r]
            order = np.argsort(cand, kind="stable")
            rows, cells = undone[order], cand[order]
            starts = np.searchsorted(cells, np.arange(self.nlist))
            ends = np.searchsorted(cells, np.arange(self.nlist) + 1)
            for c in range(self.nlist):
                free = cap - counts[c]
                if free <= 0 or starts[c] == ends[c]:
                    continue
                take = rows[starts[c]: min(ends[c], starts[c] + free)]
                assign[take] = c
                counts[c] += len(take)
        leftovers = np.flatnonzero(assign < 0)
        for j in leftovers:       # all top choices full: emptiest cell
            c = int(np.argmin(counts))
            assign[j] = c
            counts[c] += 1
        return assign

    def _insert_new_rows_ivf(self) -> None:
        """Incremental build: assign ONLY rows added since the last build
        to their nearest centroid with room, and write them into a new
        grouped layout: O(batch) host work per add cycle, not O(N)."""
        new_ix = np.flatnonzero(
            self._valid_host[self._ivf_upto: len(self._docs)])
        if len(new_ix) == 0:
            return     # deletes only: the search-time valid mask covers it
        new_ix = new_ix + self._ivf_upto
        new_t = torch.from_numpy(new_ix).to(self.device)
        vecs = self._matrix[new_t]                      # device gather
        n_live = int(np.count_nonzero(self._valid_host[: self._capacity]))
        cap_soft = self._cell_capacity(n_live)
        choices = self._top_centroids(vecs)
        # a slot per new row: its nearest cell with balance headroom (spill
        # to later choices, then the emptiest cell, as the full build)
        assign = np.empty((len(new_ix),), np.int64)
        slots = np.empty_like(assign)
        fill = self._cell_fill
        for j in range(len(new_ix)):        # O(batch) python, batch-sized
            for c in choices[j]:
                if fill[c] < cap_soft:
                    break
            else:
                c = int(np.argmin(fill))
            assign[j] = c
            slots[j] = fill[c]
            fill[c] += 1
        cap = self._grouped.shape[1]
        new_cap = cap
        while new_cap < int(fill.max()):
            new_cap *= 2
        # new tensors, published whole (the snapshot contract)
        grouped = torch.zeros((self.nlist, new_cap, self.dim),
                              dtype=torch.float32, device=self.device)
        grouped[:, :cap] = self._grouped
        grouped_ids = torch.full((self.nlist, new_cap), -1, dtype=torch.long,
                                 device=self.device)
        grouped_ids[:, :cap] = self._grouped_ids
        a = torch.from_numpy(assign).to(self.device)
        s = torch.from_numpy(slots).to(self.device)
        grouped[a, s] = vecs
        grouped_ids[a, s] = new_t
        self._grouped = grouped
        self._grouped_ids = grouped_ids

    # ------------------------------------------------------------ documents

    def list_sources(self) -> List[str]:
        """Distinct source filenames."""
        with self._lock:
            seen = []
            for d in self._docs:
                if d is None:
                    continue
                src = str(d.metadata.get("source", ""))
                if src and src not in seen:
                    seen.append(src)
            return seen

    def delete_by_source(self, sources: Sequence[str]) -> int:
        """Remove all chunks from the named source files."""
        targets = set(sources)
        removed = 0
        with self._lock:
            for i, d in enumerate(self._docs):
                if d is not None and str(d.metadata.get("source", "")) in targets:
                    self._docs[i] = None
                    self._valid_host[i] = False
                    removed += 1
            # no IVF rebuild: the search-time valid mask hides deleted rows;
            # they just occupy probe slots until the next add-triggered build
        return removed

    def __len__(self) -> int:
        return sum(1 for d in self._docs if d is not None)
