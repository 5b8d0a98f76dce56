"""Gluon model zoo (port of ``mxnet_tpu/gluon/model_zoo/``; reference:
python/mxnet/gluon/model_zoo/__init__.py)."""

from . import vision
from .vision import get_model
