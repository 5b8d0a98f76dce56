"""CachedOp — the executor of ``HybridBlock.hybridize()`` (port of
``mxnet_tpu/cached_op.py``; reference: src/imperative/cached_op.cc).

A CachedOp holds a traced Symbol and runs it as one call: the graph
function of ``executor.build_graph_fn`` over the inputs' tensors, built
once per train/predict mode. Under ``autograd.record()`` torch records
it like any other ops, so the gradients of the parameters (variables)
come from ``backward`` as in the imperative route. The BatchNorm
running statistics a training call produces are written back into the
aux inputs' NDArrays (the parameters), out of the graph.
"""

import torch

from . import autograd
from . import random as _random
from .base import MXNetError
from .executor import build_graph_fn, needs_rng


class CachedOp:
    """Callable over a Symbol.

    ``__call__(*inputs)`` takes NDArrays ordered as ``sym.list_inputs()``
    (arguments, then auxiliary states), as MXInvokeCachedOp does, and
    returns the list of output NDArrays. ``flags`` (``hybridize``'s
    keyword arguments) are accepted as in the reference; its
    static_alloc/static_shape and mirroring flags have no effect here.
    """

    def __init__(self, sym, flags=()):
        self._sym = sym
        self._arg_names = sym.list_arguments()
        self._aux_names = sym.list_auxiliary_states()
        self._input_names = sym.list_inputs()
        self._fns = {}
        self._needs_rng = needs_rng(sym)

    @property
    def symbol(self):
        return self._sym

    def _get_fn(self, is_train):
        fn = self._fns.get(is_train)
        if fn is None:
            fn = self._fns[is_train] = build_graph_fn(self._sym, is_train)
        return fn

    def __call__(self, *inputs):
        from . import ndarray as nd
        if len(inputs) != len(self._input_names):
            raise MXNetError(
                "CachedOp expects %d inputs (%s), got %d"
                % (len(self._input_names), self._input_names, len(inputs)))
        by_name = dict(zip(self._input_names, inputs))
        args = {n: by_name[n]._data for n in self._arg_names}
        aux = {n: by_name[n]._data for n in self._aux_names}
        ctx = inputs[0]._ctx
        device = inputs[0]._data.device
        # drawn from on every call, so a hybridized block's masks are
        # fresh each time
        gen = _random.generator(device) if self._needs_rng else None
        recording = autograd.is_recording() and any(
            t.requires_grad for t in args.values())
        with torch.set_grad_enabled(recording):
            outs, aux_up = self._get_fn(autograd.is_training())(
                args, aux, gen, device)
        for name, val in aux_up.items():
            by_name[name]._set_data(val)
        return [nd.NDArray(o, ctx) for o in outs]
