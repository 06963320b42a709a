"""Serving front end of the port: the micro-batching core and its HTTP
server (`serve/server.py`). The exported bundles of the JAX package's
`serve.export` are not ported (ROADMAP item 8)."""

from probpose_pytorch_tpu_torch.serve.server import MicroBatcher, PoseHTTPServer

__all__ = ["MicroBatcher", "PoseHTTPServer"]
