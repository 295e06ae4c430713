"""Example chains: the pluggable RAG pipelines.

Port of ``generativeaiexamples_tpu/chains``. Each module registers a
``BaseExample`` with the server registry:

  basic_rag            ingest→split→embed→store; retrieve→prompt→stream
                       (ref basic_rag/langchain/chains.py)
  multi_turn_rag       conversation memory + retrieve-40→rerank-4 funnel,
                       the follow-up condensed with lookahead retrieval
                       (ref advanced_rag/multi_turn_rag/chains.py)

The other chains of the reference wait for ROADMAP A.13's third part (and
A.16 for the multimodal and speech ones); ``server/registry.py`` names the
item when one is asked for.

All chains share `ChainContext` (engine + encoders + stores) so one process
serves any example.
"""

from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context  # noqa: F401

# Shared retrieval-failure message (ref chains.py "No response generated…"
# strings, identical across the reference examples).
NO_CONTEXT_MSG = ("No response generated from LLM, make sure your query is "
                  "relevant to the ingested document.")
