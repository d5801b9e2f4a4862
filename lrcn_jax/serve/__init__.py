"""Online serving: dynamic batching + HTTP front-end.

New production-facing surface (the reference only generates offline,
lrcn.jl:127-160).  ``lrcn serve`` is the CLI entry point.
"""

from lrcn_jax.serve.batcher import BatcherStats, DynamicBatcher
from lrcn_jax.serve.http import make_server
from lrcn_jax.serve.service import CaptionService

__all__ = ["BatcherStats", "CaptionService", "DynamicBatcher",
           "make_server"]


def native_frontend(*args, **kwargs):
    """Construct the C++ HTTP front-end (serve/native_http.py); raises
    if the native library cannot build/load."""
    from lrcn_jax.serve.native_http import NativeFrontend
    return NativeFrontend(*args, **kwargs)
