"""Gluon data API (port of ``mxnet_tpu/gluon/data/``; reference:
python/mxnet/gluon/data/__init__.py)."""

from .dataset import *
from .sampler import *
from .dataloader import *
from . import vision
