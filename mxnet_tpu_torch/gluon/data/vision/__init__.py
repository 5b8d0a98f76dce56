"""Gluon vision data API (port of ``mxnet_tpu/gluon/data/vision/``;
reference: python/mxnet/gluon/data/vision/__init__.py)."""

from .datasets import *
from . import transforms
