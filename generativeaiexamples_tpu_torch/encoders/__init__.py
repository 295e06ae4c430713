"""Encoder services: embeddings and reranking on the GPU.

Port of ``generativeaiexamples_tpu/encoders`` (the text encoders): the
embedding NIM (``nv-embedqa-e5-v5``) and reranking NIM
(``nv-rerankqa-mistral-4b-v3``) replaced by batch-bucketed BERT-class
encoders servable in-process or over the same ``/v1`` REST shapes the
reference's clients consume (``encoders/server.py``). The vision and VLM
encoders are ROADMAP A.16.
"""

from generativeaiexamples_tpu_torch.encoders.embedder import Embedder  # noqa: F401
from generativeaiexamples_tpu_torch.encoders.microbatch import MicroBatcher  # noqa: F401
from generativeaiexamples_tpu_torch.encoders.reranker import Reranker  # noqa: F401
