"""The transformer of the port: ``transformer`` (model, training step,
prefill, decode steps, generate), ``serving`` (the paged continuous
batcher) and ``convert`` (parameters, momentum and KV caches from and to
the JAX package's trees)."""

from . import convert, serving, transformer

__all__ = ["convert", "serving", "transformer"]
