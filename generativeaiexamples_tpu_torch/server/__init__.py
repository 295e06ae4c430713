"""Chain server: REST + SSE orchestration API with pluggable example chains.

Port of ``generativeaiexamples_tpu/server``: the same endpoint set
(/health, /metrics, /generate, /search, /documents GET/POST/DELETE) and
SSE chunk contract (``api.py``), on the standard library's
``ThreadingHTTPServer``, with the explicit plugin registry.
"""

from generativeaiexamples_tpu_torch.server.base import BaseExample  # noqa: F401
from generativeaiexamples_tpu_torch.server.registry import get_example, register_example  # noqa: F401
