"""The transformer serving path of the port: ``transformer`` (model,
prefill, decode steps, generate), ``serving`` (the paged continuous
batcher) and ``convert`` (parameters from and to the JAX package's
tree)."""

from . import convert, serving, transformer

__all__ = ["convert", "serving", "transformer"]
