"""Example chains: the pluggable RAG pipelines.

Port of ``generativeaiexamples_tpu/chains``. Each module registers a
``BaseExample`` with the server registry:

  basic_rag            ingest→split→embed→store; retrieve→prompt→stream
                       (ref basic_rag/langchain/chains.py)
  multi_turn_rag       conversation memory + retrieve-40→rerank-4 funnel,
                       the follow-up condensed with lookahead retrieval
                       (ref advanced_rag/multi_turn_rag/chains.py)
  query_decomposition  recursive sub-question agent with search+math tools
                       (ref advanced_rag/query_decomposition_rag/chains.py)
  agentic_rag          self-corrective graph: grade→rewrite→regenerate over
                       BM25 + dense retrieval fused by reciprocal rank
                       (ref notebooks/langchain/agentic_rag_with_nemo_retriever_nim.ipynb)
  router_rag           route queries across KB / web seam / direct LLM
                       (ref community/routing-multisource-rag/workflow.py)
  text_to_sql          Vanna-style retrieval-augmented SQL over sqlite,
                       read-only authorizer (ref asset_lifecycle vanna_util.py)

and the agent loops that are not registered examples: ``tool_agent``
(OpenAI tool calls with approval gates), ``extraction`` (schema-checked
JSON with retries) and ``bash_agent`` (allowlisted shell, deny by default).

``structured_data_rag`` and ``knowledge_graph_rag`` wait for ROADMAP A.13's
part 3b, the multimodal and speech chains for A.16; ``server/registry.py``
names the item when one is asked for.

All chains share `ChainContext` (engine + encoders + stores) so one process
serves any example.
"""

from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context  # noqa: F401

# Shared retrieval-failure message (ref chains.py "No response generated…"
# strings, identical across the reference examples).
NO_CONTEXT_MSG = ("No response generated from LLM, make sure your query is "
                  "relevant to the ingested document.")
