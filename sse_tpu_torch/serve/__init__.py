"""Serving layer: query engine, micro-batcher and HTTP front end (port
of ``sse_tpu.serve``)."""

from sse_tpu_torch.serve.batcher import MicroBatcher
from sse_tpu_torch.serve.engine import QueryEngine, build_fused_query_fn
from sse_tpu_torch.serve.http import serve_http

__all__ = ["MicroBatcher", "QueryEngine", "build_fused_query_fn", "serve_http"]
