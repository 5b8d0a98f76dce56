"""Operator registry (port of ``mxnet_tpu/ops/__init__.py``).

An op's ``fn(*tensors, **attrs)`` is a function on ``torch.Tensor``
inputs, with static Python attrs; a multi-output op returns a tuple.
That one function carries what the reference's NNVM attributes did:

  * FCompute         -> the function itself, run eagerly by PyTorch
  * FInferShape/Type -> the function run on ``meta`` tensors
                        (``infer_shape``)
  * FGradient        -> torch.autograd through the function; where
                        torch's gradient at a tie or a kink differs from
                        JAX's, the op computes JAX's (``elemwise.py``)

An op with ``mutate_inputs`` (the optimizer updates' state inputs, the
reference's FMutateInputs) returns its declared outputs followed by the
new values of those inputs, which the dispatcher writes back into the
NDArrays passed (``ndarray.imperative_invoke``).

The port registers the ops of ``elemwise.py``, ``reduce_ops.py``,
``matrix.py``, ``nn.py``, ``image_ops.py``, ``optimizer_ops.py``,
``random_ops.py`` and ``control_flow_ops.py``. The JAX registry's
other names (``_queued.py``) raise ``MXNetError`` naming the module and
the ROADMAP item that ports them.
"""

import inspect

import torch

from ..base import MXNetError
from ._queued import QUEUED

_REGISTRY = {}
_ALIAS = {}


class Op:
    """A registered operator."""

    def __init__(self, name, fn, differentiable=True, stateful_rng=False,
                 num_outputs=1, mutate_inputs=()):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.stateful_rng = stateful_rng
        self.num_outputs = num_outputs
        # input names or positions, or a callable attrs -> positions (the
        # fused multi-weight ops, whose state slots follow num_weights)
        self.mutate_inputs = mutate_inputs if callable(mutate_inputs) \
            else tuple(mutate_inputs)
        self._sig = None
        self._has_varargs = None
        self._param_names = None

    def __repr__(self):
        return "Op(%s)" % self.name


def register(name=None, aliases=(), differentiable=True, stateful_rng=False,
             num_outputs=1, mutate_inputs=()):
    """Decorator: register a function on torch tensors as an operator."""
    def deco(fn):
        opname = name or fn.__name__
        _REGISTRY[opname] = Op(opname, fn, differentiable=differentiable,
                               stateful_rng=stateful_rng,
                               num_outputs=num_outputs,
                               mutate_inputs=mutate_inputs)
        for a in aliases:
            _ALIAS[a] = opname
        return fn
    return deco


def queued_error(name):
    """The MXNetError for a JAX-registry op the port does not have yet."""
    module, item = QUEUED[name]
    return MXNetError(
        "operator %s is defined in mxnet_tpu/%s, which the PyTorch port "
        "has not ported yet (ROADMAP item %s)" % (name, module, item))


def get(name):
    op = _REGISTRY.get(name)
    if op is None:
        real = _ALIAS.get(name)
        if real is not None:
            op = _REGISTRY[real]
    if op is None:
        if name in QUEUED:
            raise queued_error(name)
        raise MXNetError("Operator %s is not registered" % name)
    return op


def exists(name):
    return name in _REGISTRY or name in _ALIAS


def list_ops():
    return sorted(_REGISTRY)


def op_signature(name):
    op = get(name)
    if op._sig is None:
        op._sig = inspect.signature(op.fn)
    return op._sig


def op_dispatch_meta(op):
    """(has_varargs, param_names), cached on the Op."""
    if op._has_varargs is None:
        if op._sig is None:
            op._sig = inspect.signature(op.fn)
        params = op._sig.parameters
        op._has_varargs = any(
            p.kind == inspect.Parameter.VAR_POSITIONAL
            for p in params.values())
        op._param_names = tuple(params)
    return op._has_varargs, op._param_names


def infer_shape(name, *inputs, **attrs):
    """Output shapes and dtypes of op ``name`` for inputs given as
    (shape, dtype) pairs, from one run on ``meta`` tensors (no data, no
    device): a list of (shape, dtype), one per output."""
    metas = [torch.empty(tuple(shape), dtype=dtype, device="meta")
             for shape, dtype in inputs]
    out = get(name).fn(*metas, **attrs)
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [(tuple(o.shape), o.dtype) for o in outs]


# Import op definition modules so the registry is populated at import time.
from . import elemwise  # noqa: E402,F401
from . import reduce_ops  # noqa: E402,F401
from . import matrix  # noqa: E402,F401
from . import nn  # noqa: E402,F401
from . import image_ops  # noqa: E402,F401
from . import optimizer_ops  # noqa: E402,F401
from . import random_ops  # noqa: E402,F401
from . import control_flow_ops  # noqa: E402,F401
