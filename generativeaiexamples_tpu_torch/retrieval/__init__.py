"""Retrieval: on-device vector search, BM25, text splitting, documents.

Port of ``generativeaiexamples_tpu/retrieval``'s core: an in-process
store whose similarity search is a matrix product on the GPU (exact, and
IVF mirroring Milvus ``GPU_IVF_FLAT``'s knobs), BM25 with reciprocal-rank
fusion, and the token splitter; ``adapters.py`` puts Milvus, pgvector
and Elasticsearch behind the same surface (``make_store``).
``streaming_ingest.py`` waits for ROADMAP A.16 with its one chain.
"""

from generativeaiexamples_tpu_torch.retrieval.store import Document, VectorStore  # noqa: F401
from generativeaiexamples_tpu_torch.retrieval.text_splitter import TokenTextSplitter  # noqa: F401
from generativeaiexamples_tpu_torch.retrieval.bm25 import BM25Index  # noqa: F401
