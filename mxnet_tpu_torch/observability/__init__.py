"""Observability (port of ``mxnet_tpu/observability/``), so far the two
pieces the durable serving path stands on: ``chaos``, the deterministic
fault injection, whole, and the out-of-memory classification of
``membudget``. The rest of the JAX package's observability (telemetry,
tracing, the SLO window, the memory budget, the watchdog) is ROADMAP
item A10: each of its other submodules raises ``MXNetError`` naming that
item.
"""

from ..base import MXNetError
from . import chaos, membudget

__all__ = ["chaos", "membudget"]

# the JAX package's other observability submodules
_QUEUED = ("attribution", "core", "costmodel", "dist", "events", "export",
           "flight", "goodput", "histogram", "hlo", "http", "integrity",
           "profile_store", "recompile", "sideband", "slo", "timeseries",
           "watchdog")


def __getattr__(name):
    if name in _QUEUED:
        raise MXNetError(
            "mx.observability.%s is mxnet_tpu/observability/%s.py, which "
            "the PyTorch port has not ported yet (ROADMAP item A10)"
            % (name, name))
    raise AttributeError(name)
