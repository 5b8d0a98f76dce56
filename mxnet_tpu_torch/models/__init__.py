"""The transformer of the port: ``transformer`` (model, training step,
prefill, decode steps, generate), ``serving`` (the continuous batcher),
``convert`` (parameters, momentum and KV caches from and to the JAX
package's trees), ``checkpoint`` (save, load, lineage and resume, in the
JAX package's format), ``journal`` (the request write-ahead journal
crash recovery replays) and ``router`` (the fleet of batchers: routing,
shedding, breakers and rolling weight rollouts)."""

from . import checkpoint, convert, journal, serving, transformer, router

__all__ = ["checkpoint", "convert", "journal", "router", "serving",
           "transformer"]
