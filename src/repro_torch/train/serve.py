"""Import shim: the server lives in ``repro_torch.serve``.

``repro_torch.serve`` is the serving package (``Server``/``ServeConfig``,
the single-device reference; ``InferencePlane``/``Router``/``ServeEngine``);
this module keeps the JAX package's historical ``train.serve`` import path.
"""
from repro_torch.serve.server import ServeConfig, Server

__all__ = ["ServeConfig", "Server"]
