"""Serving-side components (torch port of `lattice_tpu/serving/`): dynamic
micro-batching over the device store and the HTTP surface that exposes it
to concurrent clients."""

from lattice_tpu_torch.serving.frontend import (
    BatchingFrontend,
    DeadlineExceeded,
    FrontendStats,
    Overloaded,
)
from lattice_tpu_torch.serving.router import FrontendRouter

__all__ = [
    "BatchingFrontend", "FrontendStats", "FrontendRouter",
    "DeadlineExceeded", "Overloaded", "ServingHTTPServer",
]


def __getattr__(name):
    # http.server import is lazy: the frontend is used by library paths
    # that never open a socket
    if name == "ServingHTTPServer":
        from lattice_tpu_torch.serving.http import ServingHTTPServer
        return ServingHTTPServer
    raise AttributeError(name)
