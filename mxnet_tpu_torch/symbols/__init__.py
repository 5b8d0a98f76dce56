"""Symbolic networks of the examples, the port's own copies (the
examples import the JAX package, so the port cannot import them):
``resnet`` is ``examples/image_classification/symbols/resnet.py``."""

from . import resnet

__all__ = ["resnet"]
