"""Module API, the symbolic training loops (port of
``mxnet_tpu/module/``; reference: python/mxnet/module/: BaseModule,
Module, BucketingModule, SequentialModule, PythonModule).
"""

from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
