"""The out-of-memory classification of ``mxnet_tpu/observability/
membudget.py``.

Only :func:`is_resource_exhausted` is ported: it reads the exception
alone. The budget itself (headroom, preflights, the snapshot ledger) is
to be redesigned over ``torch.cuda.mem_get_info``, ROADMAP item A10;
until then the port behaves as the JAX package does with no budget set,
and every other name of the JAX module raises naming that item.
"""

import torch

from ..base import MXNetError

__all__ = ["is_resource_exhausted"]


def is_resource_exhausted(exc):
    """Does ``exc`` look like a device allocation failure? The JAX
    package's test on the exception's text (a RESOURCE_EXHAUSTED status,
    "out of memory" in either case, as the chaos layer's injected
    ``oom`` reads) plus ``torch.cuda.OutOfMemoryError``."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = "%s: %s" % (type(exc).__name__, exc)
    return ("RESOURCE_EXHAUSTED" in text
            or "ResourceExhausted" in text
            or "Out of memory" in text
            or "out of memory" in text)


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise MXNetError(
        "observability.membudget.%s: the memory budget is not ported yet "
        "(ROADMAP item A10); only is_resource_exhausted is" % name)
