"""Autograd (port of ``mxnet_tpu/autograd.py``).

The scopes (``record``/``pause``/``train_mode``/``predict_mode``) and
the API (``mark_variables``, ``backward``, ``grad``, ``Function``) are
the reference's. Underneath is torch.autograd, not a tape of closures:
a variable (``attach_grad``/``mark_variables``) holds a tensor that
requires grad, an op recorded under ``record()`` is a torch op run with
grad mode on, and every other op runs with grad mode off. ``backward``
asks torch for the gradients of the live variables and writes them into
each variable's ``.grad`` by its ``grad_req`` (``write``, ``add`` or
``null``).
"""

import threading
import weakref

import torch

from .base import MXNetError

_state = threading.local()
# every marked variable by id(), so that backward can hand their tensors
# to torch.autograd.grad; a variable that is collected drops out by itself.
# Keyed by identity: a WeakSet would compare NDArrays with their
# elementwise __eq__.
_VARIABLES = weakref.WeakValueDictionary()
_VARIABLES_LOCK = threading.Lock()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


# ------------------------------------------------------------- scopes --
class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._enter_is_record is not None:
            st.recording = self._enter_is_record
        if self._enter_train_mode is not None:
            st.training = self._enter_train_mode
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """python/mxnet/autograd.py:93 — record ops (and by default enter
    train mode) inside the scope."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    st = _st()
    prev, st.recording = st.recording, is_record
    return prev


def set_training(train):
    st = _st()
    prev, st.training = st.training, train
    return prev


# ---------------------------------------------------------- variables --
def _note_variable(arr):
    with _VARIABLES_LOCK:
        _VARIABLES[id(arr)] = arr


def _leaves(v):
    """The tensors a variable has been recorded as: its current ``_data``
    and the earlier leaves it was rebound from (an in-place update,
    ``__setitem__``, ``copyto`` or a private copy outside ``record()``)
    that a live graph still holds. Gradients are summed over them, as the
    reference accumulates by the NDArray whatever its values were."""
    return [v._data] + v._old_leaves()


def mark_variables(variables, gradients, grad_reqs="write"):
    """python/mxnet/autograd.py mark_variables."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        v._mark_variable(g, r)


def _as_list(x):
    from .ndarray import NDArray
    return [x] if isinstance(x, NDArray) else list(x)


def _heads(outputs, head_grads):
    outputs = _as_list(outputs)
    for o in outputs:
        if not o._data.requires_grad:
            raise MXNetError(
                "cannot differentiate %s: it was not computed inside an "
                "autograd.record() scope from a variable" % repr(o))
    if head_grads is None:
        head_grads = [None] * len(outputs)
    else:
        head_grads = _as_list(head_grads)
    grads = [torch.ones_like(o._data) if g is None
             else g._data.to(o._data.dtype) for o, g in zip(outputs, head_grads)]
    return [o._data for o in outputs], grads


def backward(outputs, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse pass (analogue of Imperative::Backward): the gradient of
    ``outputs`` (seeded with ``head_grads``, ones by default) with
    respect to every live variable it depends on, written into the
    variables' ``.grad`` by their ``grad_req``."""
    heads, seeds = _heads(outputs, head_grads)
    with _VARIABLES_LOCK:
        variables = [v for v in _VARIABLES.values()
                     if v._grad_req != "null" and v._grad is not None
                     and v._data.requires_grad]
    if not variables:
        return
    leaves = [_leaves(v) for v in variables]
    grads = torch.autograd.grad(heads, [t for ts in leaves for t in ts],
                                grad_outputs=seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    at = 0
    for v, ts in zip(variables, leaves):
        g = _sum_grads(grads[at:at + len(ts)])
        at += len(ts)
        if g is None:
            continue
        g = g.to(v._grad._data.dtype)
        if v._grad_req == "add":
            v._grad._data = v._grad._data + g
        else:
            v._grad._data = g
        v._fresh_grad = True


def _sum_grads(grads):
    """The sum of a variable's leaves' gradients; None if none was used."""
    live = [g for g in grads if g is not None]
    return sum(live[1:], live[0]) if live else None


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """python/mxnet/autograd.py grad: return the gradients of ``heads``
    with respect to ``variables`` instead of writing ``.grad``. With
    ``create_graph`` the returned gradients are themselves recorded, so
    they can be differentiated again."""
    from .ndarray import NDArray
    variables = _as_list(variables)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad: %r is not a variable; call "
                             "attach_grad() before recording" % (v,))
    outs, seeds = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    leaves = [_leaves(v) for v in variables]
    grads = torch.autograd.grad(outs, [t for ts in leaves for t in ts],
                                grad_outputs=seeds,
                                retain_graph=bool(retain_graph),
                                create_graph=create_graph,
                                allow_unused=True)
    out, at = [], 0
    for v, ts in zip(variables, leaves):
        g = _sum_grads(grads[at:at + len(ts)])
        at += len(ts)
        out.append(NDArray(torch.zeros_like(v._data) if g is None else g,
                           v._ctx))
    return out


def get_symbol(x):
    raise MXNetError("autograd.get_symbol: the port records torch.autograd "
                     "graphs, not nnvm symbols; use gluon.HybridBlock "
                     "tracing to obtain a Symbol")


class _Bridge(torch.autograd.Function):
    """Runs a user ``Function``'s forward and backward, over NDArrays,
    as one node of torch's graph."""

    @staticmethod
    def forward(ctx, func, in_ctx, *tensors):
        from .ndarray import NDArray
        ctx.func, ctx.in_ctx = func, in_ctx
        with pause():
            outputs = func.forward(*[NDArray(t, in_ctx) for t in tensors])
        ctx.single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if ctx.single else list(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray import NDArray
        with pause():
            igrads = ctx.func.backward(*[NDArray(c, ctx.in_ctx)
                                         for c in cts])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        return (None, None) + tuple(
            None if g is None else g._data for g in igrads)


class Function:
    """Custom differentiable function
    (python/mxnet/autograd.py:Function): subclass and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)``,
    both over NDArrays."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not (is_recording() and any(i._requires_tape() for i in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = _Bridge.apply(self, inputs[0]._ctx,
                             *[i._data for i in inputs])
        results = [NDArray(o, inputs[0]._ctx) for o in outs]
        return results[0] if len(results) == 1 else results

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
