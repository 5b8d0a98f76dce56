"""Devices (port of ``mxnet_tpu/context.py``).

``Context(device_type, device_id)`` with a ``with`` scope and a thread
default, over ``torch.device``. One point differs from the JAX package on
purpose: there, the default context falls back to the host when no
accelerator exists. Here the default context is ``gpu(0)``, and using it
without a CUDA device raises; CPU callers say ``with cpu():`` or pass
``ctx=cpu()``.

``resolve_device`` is what the model entry points call: it takes a
``Context``, a ``torch.device`` or a device string, and None for the
current CUDA device.
"""

import threading

import torch

from .base import MXNetError

_thread_local = threading.local()


class Context:
    """Device context, usable as a ``with`` scope
    (python/mxnet/context.py:28)."""

    devstr2type = {"cpu": 1, "gpu": 2}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devstr2type:
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = device_id

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes; raises for a GPU
        context when no CUDA device exists."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%r: no CUDA device (the default context is gpu(0); run on "
                "the host with `with cpu():` or ctx=cpu())" % (self,))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(_thread_local, "ctx_stack"):
            _thread_local.ctx_stack = []
        _thread_local.ctx_stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        _thread_local.ctx_stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(_thread_local, "ctx_stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    return Context.default_ctx()


def gpu_memory_info(device_id=0):
    """(free, total) bytes of a GPU (reference context.gpu_memory_info
    over cudaMemGetInfo)."""
    resolve_device(torch.device("cuda", device_id))
    return torch.cuda.mem_get_info(device_id)


def context_of(device):
    """The Context of a ``torch.device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


def resolve_device(device=None):
    """``device`` (a Context, a ``torch.device`` or a string) as a
    ``torch.device``; None means the current CUDA device. Raises
    RuntimeError when a CUDA device is asked for (or implied) and none
    exists."""
    if isinstance(device, Context):
        return device.torch_device
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless a device "
                "is given (pass device='cpu' or ctx=cpu(), or use "
                "`with cpu():`, to run on the host)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
