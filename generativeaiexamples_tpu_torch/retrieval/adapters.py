"""External vector-DB adapters: Milvus, pgvector and Elasticsearch behind
the store seam.

Port of ``generativeaiexamples_tpu/retrieval/adapters.py``: the adapters
are that module's (numpy and the standard library; ``_EsRest`` speaks
``urllib``), with ``pymilvus`` / ``psycopg2`` still imported lazily, only
when no client is injected, so a missing driver raises with the package
name. ``make_store`` dispatches on ``VectorStoreConfig.name``: "tpu" (the
default) builds the in-process ``retrieval.store.VectorStore`` on
``device`` (the embedder's, ``cuda`` unless the caller asks for another),
"milvus" | "pgvector" | "elasticsearch" an adapter, anything else raises
``ValueError``. Every backend offers ``add / search / list_sources /
delete_by_source / __len__`` with scores in cosine-similarity terms.
"""


from __future__ import annotations

import json
import logging
import uuid
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.store import Document

logger = logging.getLogger(__name__)


class MilvusStore:
    """Milvus collection adapter (ref utils.py:253-287 Milvus branch).

    Schema: auto-id pk, float-vector field "embedding" (COSINE), varchar
    "content", JSON "metadata", varchar "source" (delete-by-source filter).
    """

    def __init__(self, dim: int, url: str = "http://localhost:19530",
                 name: str = "default", client: Any = None) -> None:
        self.dim = dim
        self.name = f"gaie_{name}"
        if client is None:
            try:
                from pymilvus import MilvusClient
            except ImportError as exc:   # pragma: no cover - env-dependent
                raise ImportError(
                    "MilvusStore needs the 'pymilvus' package (or pass a "
                    "compatible client=)") from exc
            client = MilvusClient(uri=url)
        self.client = client
        if not self.client.has_collection(self.name):
            self.client.create_collection(
                collection_name=self.name, dimension=dim,
                metric_type="COSINE", auto_id=False,
                id_type="string", max_length=64)   # uuid4 hex string pks

    def add(self, docs: Sequence[Document], embeddings: np.ndarray) -> List[str]:
        emb = np.asarray(embeddings, np.float32)
        rows, ids = [], []
        for doc, vec in zip(docs, emb):
            pk = uuid.uuid4().hex
            ids.append(pk)
            rows.append({"id": pk, "vector": vec.tolist(),
                         "content": doc.content,
                         "source": str(doc.metadata.get("source", "")),
                         "metadata": json.dumps(doc.metadata)})
        if rows:
            self.client.insert(collection_name=self.name, data=rows)
        return ids

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: float = 0.0
               ) -> List[Tuple[Document, float]]:
        res = self.client.search(
            collection_name=self.name,
            data=[np.asarray(query_embedding, np.float32).tolist()],
            limit=top_k, output_fields=["content", "metadata"])
        hits: List[Tuple[Document, float]] = []
        for hit in (res[0] if res else []):
            score = float(hit.get("distance", 0.0))
            if score < score_threshold:
                continue
            entity = hit.get("entity", hit)
            meta = entity.get("metadata", "{}")
            meta = json.loads(meta) if isinstance(meta, str) else dict(meta)
            hits.append((Document(content=entity.get("content", ""),
                                  metadata=meta), score))
        return hits

    def list_sources(self) -> List[str]:
        rows = self.client.query(collection_name=self.name,
                                 filter="source != ''",
                                 output_fields=["source"])
        return sorted({r["source"] for r in rows})

    def delete_by_source(self, sources: Sequence[str]) -> int:
        n = 0
        for src in sources:
            # escape the quoted value: a filename like x" || source != "
            # must not widen the filter expression
            quoted = str(src).replace("\\", "\\\\").replace('"', '\\"')
            res = self.client.delete(
                collection_name=self.name,
                filter=f'source == "{quoted}"')
            n += int(res.get("delete_count", 0)) if isinstance(res, dict) \
                else len(res or [])
        return n

    def __len__(self) -> int:
        rows = self.client.query(collection_name=self.name,
                                 output_fields=["count(*)"])
        return int(rows[0]["count(*)"]) if rows else 0


class PgVectorStore:
    """Postgres + pgvector adapter (ref utils.py:289-332 PGVector branch).

    One table per collection: (id uuid, content text, source text,
    metadata jsonb, embedding vector(dim)); cosine distance operator <=>.
    """

    def __init__(self, dim: int, url: str = "", name: str = "default",
                 conn: Any = None) -> None:
        self.dim = dim
        self.table = f"gaie_{name}"
        if conn is None:
            try:
                import psycopg2
            except ImportError as exc:   # pragma: no cover - env-dependent
                raise ImportError(
                    "PgVectorStore needs the 'psycopg2' package (or pass a "
                    "compatible conn=)") from exc
            conn = psycopg2.connect(url)
        self.conn = conn
        with self.conn.cursor() as cur:
            cur.execute("CREATE EXTENSION IF NOT EXISTS vector")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {self.table} ("
                f"id text PRIMARY KEY, content text, source text, "
                f"metadata jsonb, embedding vector({dim}))")
        self.conn.commit()

    @staticmethod
    def _vec_literal(vec: np.ndarray) -> str:
        return "[" + ",".join(f"{x:.8f}" for x in np.asarray(vec)) + "]"

    def add(self, docs: Sequence[Document], embeddings: np.ndarray) -> List[str]:
        ids = []
        with self.conn.cursor() as cur:
            for doc, vec in zip(docs, np.asarray(embeddings, np.float32)):
                pk = uuid.uuid4().hex
                ids.append(pk)
                cur.execute(
                    f"INSERT INTO {self.table} "
                    f"(id, content, source, metadata, embedding) "
                    f"VALUES (%s, %s, %s, %s, %s)",
                    (pk, doc.content, str(doc.metadata.get("source", "")),
                     json.dumps(doc.metadata), self._vec_literal(vec)))
        self.conn.commit()
        return ids

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: float = 0.0
               ) -> List[Tuple[Document, float]]:
        lit = self._vec_literal(query_embedding)
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT content, metadata, 1 - (embedding <=> %s) AS score "
                f"FROM {self.table} ORDER BY embedding <=> %s LIMIT %s",
                (lit, lit, top_k))
            rows = cur.fetchall()
        hits = []
        for content, meta, score in rows:
            if float(score) < score_threshold:
                continue
            meta = json.loads(meta) if isinstance(meta, str) else dict(meta)
            hits.append((Document(content=content, metadata=meta),
                         float(score)))
        return hits

    def list_sources(self) -> List[str]:
        with self.conn.cursor() as cur:
            cur.execute(f"SELECT DISTINCT source FROM {self.table} "
                        f"WHERE source != ''")
            return sorted(r[0] for r in cur.fetchall())

    def delete_by_source(self, sources: Sequence[str]) -> int:
        n = 0
        with self.conn.cursor() as cur:
            for src in sources:
                cur.execute(f"DELETE FROM {self.table} WHERE source = %s",
                            (src,))
                n += cur.rowcount
        self.conn.commit()
        return n

    def __len__(self) -> int:
        with self.conn.cursor() as cur:
            cur.execute(f"SELECT count(*) FROM {self.table}")
            return int(cur.fetchone()[0])


class _EsRest:
    """Minimal Elasticsearch REST client (urllib; no vendored driver)."""

    def __init__(self, url: str) -> None:
        self.url = (url or "http://localhost:9200").rstrip("/")

    def request(self, method: str, path: str, body=None) -> Dict:
        import urllib.error
        import urllib.request

        if isinstance(body, str):            # NDJSON (_bulk)
            data = body.encode()
            ctype = "application/x-ndjson"
        else:
            data = json.dumps(body).encode() if body is not None else None
            ctype = "application/json"
        req = urllib.request.Request(
            f"{self.url}{path}", method=method, data=data,
            headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            # surface the ES error BODY (e.g. resource_already_exists_
            # exception) — HTTPError's str() is just "HTTP Error 400"
            detail = exc.read().decode("utf-8", "replace")[:500]
            raise RuntimeError(
                f"elasticsearch {method} {path} -> {exc.code}: "
                f"{detail}") from exc
        return json.loads(payload) if payload else {}


class ElasticsearchStore:
    """Elasticsearch dense-vector kNN adapter (ref: RAG/examples/
    local_deploy/docker-compose-vectordb.yaml:86-104 runs elasticsearch as a
    first-class store next to Milvus/pgvector).

    One index per collection: dense_vector (cosine) + content/source/
    metadata fields; search is the ES 8 top-level ``knn`` query; deletes go
    through ``_delete_by_query`` on the source keyword. The wire surface is
    a single ``request(method, path, body)`` callable, so tests inject an
    in-memory fake and deployments get the real REST endpoint with zero
    extra dependencies."""

    def __init__(self, dim: int, url: str = "http://localhost:9200",
                 name: str = "default", client: Any = None) -> None:
        self.dim = dim
        self.index = f"gaie_{name}".lower()
        self.client = client if client is not None else _EsRest(url)
        try:
            self.client.request("PUT", f"/{self.index}", {
                "mappings": {"properties": {
                    "embedding": {"type": "dense_vector", "dims": dim,
                                  "index": True, "similarity": "cosine"},
                    "content": {"type": "text"},
                    "source": {"type": "keyword"},
                    "metadata": {"type": "object", "enabled": False},
                }}})
        except Exception as exc:
            # idempotent reconnect (Milvus/pgvector adapters' semantics):
            # an existing index is fine, anything else is a real failure
            if "resource_already_exists" not in str(exc):
                raise

    def add(self, docs: Sequence[Document], embeddings: np.ndarray) -> List[str]:
        ids = []
        lines = []
        for doc, vec in zip(docs, np.asarray(embeddings, np.float32)):
            pk = uuid.uuid4().hex
            ids.append(pk)
            lines.append(json.dumps({"index": {"_id": pk}}))
            lines.append(json.dumps({
                "embedding": vec.tolist(), "content": doc.content,
                "source": str(doc.metadata.get("source", "")),
                "metadata": doc.metadata}))
        if lines:
            # one _bulk round trip for the whole batch, not one per chunk
            self.client.request("POST", f"/{self.index}/_bulk",
                                "\n".join(lines) + "\n")
            self.client.request("POST", f"/{self.index}/_refresh")
        return ids

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: float = 0.0
               ) -> List[Tuple[Document, float]]:
        res = self.client.request("POST", f"/{self.index}/_search", {
            "knn": {"field": "embedding",
                    "query_vector": np.asarray(query_embedding,
                                               np.float32).tolist(),
                    "k": top_k, "num_candidates": max(top_k * 10, 100)},
            "_source": ["content", "metadata"], "size": top_k})
        hits = []
        for h in res.get("hits", {}).get("hits", []):
            # ES kNN cosine score is (1 + cos) / 2, already in [0, 1] —
            # the same range the in-proc store reports
            score = float(h.get("_score", 0.0))
            if score < score_threshold:
                continue
            src = h.get("_source", {})
            hits.append((Document(content=src.get("content", ""),
                                  metadata=dict(src.get("metadata") or {})),
                         score))
        return hits

    def list_sources(self) -> List[str]:
        res = self.client.request("POST", f"/{self.index}/_search", {
            "size": 0, "aggs": {"sources": {
                "terms": {"field": "source", "size": 10000}}}})
        buckets = (res.get("aggregations", {}).get("sources", {})
                   .get("buckets", []))
        return sorted(b["key"] for b in buckets if b.get("key"))

    def delete_by_source(self, sources: Sequence[str]) -> int:
        res = self.client.request(
            "POST", f"/{self.index}/_delete_by_query?refresh=true",
            {"query": {"terms": {"source": [str(s) for s in sources]}}})
        return int(res.get("deleted", 0))

    def __len__(self) -> int:
        res = self.client.request("GET", f"/{self.index}/_count")
        return int(res.get("count", 0))


def make_store(dim: int, config, name: str = "default",
               client: Any = None, device=None):
    """Backend dispatch on VectorStoreConfig.name (ref utils.py:220-250 +
    the elasticsearch compose service): "tpu" (default, in-proc
    device-resident, on ``device``) | "milvus" | "pgvector" |
    "elasticsearch"."""
    backend = (config.name or "tpu").lower()
    if backend in ("tpu", "inproc", "default"):
        from generativeaiexamples_tpu_torch.retrieval.store import VectorStore

        return VectorStore(dim=dim, index_type=config.index_type,
                           nlist=config.nlist, nprobe=config.nprobe,
                           name=name, device=device)
    if backend == "milvus":
        return MilvusStore(dim=dim, url=config.url, name=name, client=client)
    if backend == "pgvector":
        return PgVectorStore(dim=dim, url=config.url, name=name, conn=client)
    if backend in ("elasticsearch", "es"):
        return ElasticsearchStore(dim=dim, url=config.url, name=name,
                                  client=client)
    raise ValueError(f"unknown vector store backend {config.name!r} "
                     f"(expected tpu|milvus|pgvector|elasticsearch)")
