"""NDArray — the imperative value type, and the ``nd.*`` op namespace
(port of ``mxnet_tpu/ndarray.py``).

An NDArray holds a ``torch.Tensor`` in ``_data`` and its Context. The
``nd.*`` functions are made from the op registry (``ops``) at import;
names of the JAX registry that the port has not ported yet are functions
that raise ``MXNetError`` naming their ROADMAP item.

Value semantics. A JAX NDArray never shares a buffer with another, and
neither does a write here show through another NDArray, though torch
views (``reshape``, ``transpose``, slices) share storage:

  * the in-place operators (``+=``, ...) and ``copyto`` rebind
    ``_data`` to a new tensor;
  * ``__setitem__`` writes into a copy and rebinds ``_data`` to it;
  * a writer through a raw pointer (``rtc.CudaKernel.launch``,
    ``to_dlpack_for_write``) first calls ``_own_buffer()``, which copies
    the tensor when it is a view or its storage is shared.

Dtypes follow the JAX package: ``float16`` requests give ``bfloat16``,
64-bit requests their 32-bit types, and ``array`` turns float64 data into
float32 and keeps int64 data. ``dtype`` is a numpy dtype, as there
(``base.np_dtype``); ``asnumpy`` of a bfloat16 array gives ``ml_dtypes``'
bfloat16, or float32 where ``ml_dtypes`` is missing. ``stype`` other than
``"default"`` (``sparse.py``: ``sparse``, ``csr_matrix``,
``row_sparse_array``) waits for ROADMAP A9.

``nd.random`` routes a draw as the JAX package does: scalar parameters to
the ``_random_*`` ops, NDArray parameters to the ``sample_*`` ops. A draw
with no array parameter lands on ``ctx`` if given, else on the current
context (the JAX package ignores ``ctx``). ``nd.contrib.foreach``,
``while_loop`` and ``cond`` are ``control_flow``'s eager loops.
"""

import builtins
import inspect
import io
import json
import struct
import sys
import weakref

import numpy as np
import torch

from . import autograd, engine, ops
from . import random as _random_mod
from . import storage as _storage
from .base import BFLOAT16, MXNetError, dtype_name, np_dtype, torch_dtype
from .context import Context, context_of, current_context
from .ops._queued import QUEUED

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "concatenate", "stack", "save", "load", "waitall",
           "imperative_invoke"]

_DTYPE_ALIAS = {"float16": "bfloat16"}  # as in the JAX package


def _to_torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    name = dtype_name(dtype)
    return torch_dtype(_DTYPE_ALIAS.get(name, name))


def _sparse_error(stype):
    return MXNetError(
        "storage type %r is mxnet_tpu/sparse.py, which the PyTorch port "
        "has not ported yet (ROADMAP item A9)" % (stype,))


def _grad_mode():
    return torch.set_grad_enabled(autograd.is_recording())


def _storage_shared(t):
    """Whether another tensor may share ``t``'s storage (``t`` is a view,
    or some tensor views it, or a graph saved it). Without torch's
    storage use count, every storage counts as shared."""
    if t._base is not None:
        return True
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return True
    # one reference is ``t``'s own, one the temporary storage object's
    return use_count(t.untyped_storage()._cdata) > 2


class NDArray:
    """Multi-dimensional array on a device (include/mxnet/ndarray.h)."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_ag_leaf",
                 "_ag_old", "_fresh_grad", "__weakref__")

    def __init__(self, data, ctx=None, stype="default"):
        if stype != "default":
            raise _sparse_error(stype)
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data.device)
        if _storage._TRACKING:
            _storage._note_alloc(self)
        self._grad = None
        self._grad_req = "null"
        self._ag_leaf = False
        self._ag_old = ()
        self._fresh_grad = False

    def _set_data(self, tensor):
        """Rebind ``_data``; a variable's new tensor requires grad. When a
        variable's leaf is replaced by a new leaf (a rebinding outside
        ``record()``), the old one is remembered weakly: a graph recorded
        from it still owes this variable its gradient."""
        if self._ag_leaf and not tensor.requires_grad and (
                tensor.dtype.is_floating_point):
            tensor = tensor.detach().requires_grad_(True)
            old = self._data
            if old is not tensor and old.requires_grad and old.is_leaf:
                self._ag_old = tuple(r for r in self._ag_old
                                     if r() is not None) + (weakref.ref(old),)
        self._data = tensor

    def _old_leaves(self):
        """Earlier leaves of this variable that are still alive (a tensor
        outlives its last Python reference while a graph holds it)."""
        return [t for t in (r() for r in self._ag_old) if t is not None]

    def _own_buffer(self):
        """Make ``_data`` a contiguous tensor that no other tensor shares,
        copying it if needed, so that it can be written in place."""
        # another holder of this very tensor object (an NDArray wrapping
        # it too): references beyond the slot's and the argument's
        held = sys.getrefcount(self._data) > 2
        t = self._data
        if held or _storage_shared(t) or not t.is_contiguous():
            with torch.no_grad():
                t = t.clone(memory_format=torch.contiguous_format)
            self._set_data(t)
        return self._data

    # ------------------------------------------------------------ props --
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return transpose(self)

    @property
    def grad(self):
        return self._grad

    # ------------------------------------------------------- conversion --
    def asnumpy(self):
        t = self._data.detach()
        if t.dtype != torch.bfloat16:
            return t.cpu().numpy()
        host = t.to(torch.float32).cpu().numpy()
        bf16 = np_dtype(torch.bfloat16)
        return host if bf16 is BFLOAT16 else host.astype(bf16)

    def __reduce__(self):
        return (_ndarray_unpickle,
                (self.asnumpy(), dtype_name(self.dtype),
                 self._ctx.device_type))

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0].item()

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        dt = _to_torch_dtype(dtype)
        if dt == self._data.dtype and not copy:
            return self
        return imperative_invoke("Cast", [self], {"dtype": dtype_name(dt)})

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        with _grad_mode():
            return NDArray(self._data.to(ctx.torch_device), ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, NDArray):
            with _grad_mode():
                other._set_data(self._data.to(other._ctx.torch_device))
            return other
        return self.as_in_context(other)

    def copy(self):
        with _grad_mode():
            return NDArray(self._data.clone(), self._ctx)

    def tostype(self, stype):
        if stype != "default":
            raise _sparse_error(stype)
        return self.copy()

    def wait_to_read(self):
        engine.wait_for_var(self._data)

    # --------------------------------------------------------- autograd --
    def _requires_tape(self):
        return self._data.requires_grad

    def _mark_variable(self, grad, grad_req):
        self._ag_leaf = True
        self._grad = grad
        self._grad_req = grad_req
        self._set_data(self._data)
        autograd._note_variable(self)

    def attach_grad(self, grad_req="write", stype=None):
        """python/mxnet/ndarray/ndarray.py attach_grad."""
        if stype not in (None, "default"):
            raise _sparse_error(stype)
        self._mark_variable(zeros(self.shape, dtype=self._data.dtype,
                                  ctx=self._ctx), grad_req)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    # --------------------------------------------------------- reshape --
    def reshape(self, *shape, **kwargs):
        if "shape" in kwargs:
            shape = kwargs["shape"]
        elif len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return reshape(self, shape=tuple(shape),
                       reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return reshape_like(self, other)

    def expand_dims(self, axis):
        return expand_dims(self, axis=axis)

    def squeeze(self, axis=None):
        return squeeze(self, axis=axis)

    def flatten(self):
        return flatten(self)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes=axes if axes else None)

    def swapaxes(self, dim1, dim2):
        return swapaxes(self, dim1=dim1, dim2=dim2)

    def flip(self, axis):
        return reverse(self, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return split(self, num_outputs=num_outputs, axis=axis,
                     squeeze_axis=squeeze_axis)

    def tile(self, reps):
        return tile(self, reps=reps)

    def repeat(self, repeats, axis=None):
        return repeat(self, repeats=repeats, axis=axis)

    def pad(self, mode, pad_width, constant_value=0.0):
        return pad(self, mode=mode, pad_width=pad_width,
                   constant_value=constant_value)

    def broadcast_to(self, shape):
        return broadcast_to(self, shape=shape)

    def broadcast_like(self, other):
        return broadcast_like(self, other)

    def one_hot(self, depth, **kw):
        return one_hot(self, depth=depth, **kw)

    def take(self, indices, axis=0, mode="clip"):
        return take(self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return pick(self, index, axis=axis, keepdims=keepdims)

    def topk(self, **kw):
        return topk(self, **kw)

    def sort(self, axis=-1, is_ascend=True):
        return sort(self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return argsort(self, axis=axis, is_ascend=is_ascend)

    def argmax(self, axis=None, keepdims=False):
        return argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return argmin(self, axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        return clip(self, a_min=a_min, a_max=a_max)

    def abs(self):
        return abs_op(self)

    def sum(self, axis=None, keepdims=False, **kw):
        return sum(self, axis=axis, keepdims=keepdims, **kw)

    def mean(self, axis=None, keepdims=False, **kw):
        return mean(self, axis=axis, keepdims=keepdims, **kw)

    def max(self, axis=None, keepdims=False, **kw):
        return max(self, axis=axis, keepdims=keepdims, **kw)

    def min(self, axis=None, keepdims=False, **kw):
        return min(self, axis=axis, keepdims=keepdims, **kw)

    def prod(self, axis=None, keepdims=False, **kw):
        return prod(self, axis=axis, keepdims=keepdims, **kw)

    def norm(self, ord=2, axis=None, keepdims=False):
        return norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def dot(self, other, **kw):
        return dot(self, other, **kw)

    def slice(self, begin, end, step=()):
        return slice_op(self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return slice_axis(self, axis=axis, begin=begin, end=end)

    def zeros_like(self):
        return zeros_like(self)

    def ones_like(self):
        return ones_like(self)

    # ------------------------------------------------------- operators --
    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(self, other)

    def __iadd__(self, other):
        self._set_data(add(self, other)._data)
        return self

    def __sub__(self, other):
        return subtract(self, other)

    def __rsub__(self, other):
        if isinstance(other, NDArray):
            return subtract(other, self)
        return imperative_invoke("_rminus_scalar", [self], {"scalar": other})

    def __isub__(self, other):
        self._set_data(subtract(self, other)._data)
        return self

    def __mul__(self, other):
        return multiply(self, other)

    def __rmul__(self, other):
        return multiply(self, other)

    def __imul__(self, other):
        self._set_data(multiply(self, other)._data)
        return self

    def __truediv__(self, other):
        return divide(self, other)

    def __rtruediv__(self, other):
        if isinstance(other, NDArray):
            return divide(other, self)
        return imperative_invoke("_rdiv_scalar", [self], {"scalar": other})

    def __itruediv__(self, other):
        self._set_data(divide(self, other)._data)
        return self

    def __mod__(self, other):
        return modulo(self, other)

    def __rmod__(self, other):
        if isinstance(other, NDArray):
            return modulo(other, self)
        return imperative_invoke("_rmod_scalar", [self], {"scalar": other})

    def __pow__(self, other):
        return power(self, other)

    def __rpow__(self, other):
        if isinstance(other, NDArray):
            return power(other, self)
        return imperative_invoke("_rpower_scalar", [self], {"scalar": other})

    def __neg__(self):
        return negative(self)

    def __abs__(self):
        return abs_op(self)

    def __eq__(self, other):
        return equal(self, other)

    def __ne__(self, other):
        return not_equal(self, other)

    def __gt__(self, other):
        return greater(self, other)

    def __ge__(self, other):
        return greater_equal(self, other)

    def __lt__(self, other):
        return lesser(self, other)

    def __le__(self, other):
        return lesser_equal(self, other)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy().reshape(-1)[0])
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self._ctx)

    # -------------------------------------------------------- indexing --
    def __getitem__(self, key):
        return imperative_invoke("_index", [self], {"key": self._norm_key(key)})

    def _norm_key(self, key):
        def conv(k):
            if isinstance(k, NDArray):
                k = k._data
            elif isinstance(k, np.ndarray):
                k = torch.from_numpy(k)
            if isinstance(k, torch.Tensor):
                k = k.detach().to(self._data.device)
                return k if k.dtype == torch.bool else \
                    k.to(torch.int32).to(torch.int64)
            return k
        if isinstance(key, tuple):
            return tuple(conv(k) for k in key)
        return conv(key)

    def __setitem__(self, key, value):
        key = self._norm_key(key)
        if isinstance(value, NDArray):
            value = value._data
        with _grad_mode():
            if isinstance(key, builtins.slice) and key == builtins.slice(None):
                value = torch.as_tensor(value, device=self._data.device)
                new = value.to(self._data.dtype).expand(self.shape).clone(
                    memory_format=torch.contiguous_format)
            else:
                new = self._data.clone()
                new[key] = value
        self._set_data(new)


# `_index`: getitem as an op, so that a recorded index is differentiated
@ops.register(name="_index")
def _index_op(data, key=None):
    return data[key]


# ---------------------------------------------------------- dispatch ----
def imperative_invoke(op_name, nd_inputs, attrs, out=None, input_names=None,
                      ctx=None):
    """Eager dispatch (analogue of MXImperativeInvoke): run the op's
    function on the inputs' tensors with torch's grad mode on only when
    recording and an input is a variable or depends on one."""
    op = ops.get(op_name)
    datas = [a._data for a in nd_inputs]
    kw = {k: v for k, v in attrs.items()
          if v is not None or k in ("axis", "axes")}
    out_ctx = nd_inputs[0]._ctx if nd_inputs else (ctx or current_context())

    has_varargs, param_names = ops.op_dispatch_meta(op)
    if "is_train" in param_names and "is_train" not in kw:
        kw["is_train"] = autograd.is_training()
    if "device" in param_names and "device" not in kw:
        kw["device"] = out_ctx.torch_device
    if op.stateful_rng and kw.get("generator") is None:
        kw["generator"] = _random_mod.generator(
            datas[0].device if datas else out_ctx.torch_device)

    if has_varargs:
        arr_names = None
    elif input_names is not None:
        arr_names = list(input_names)
    else:
        arr_names = [p for p in param_names if p not in kw][:len(datas)]

    record = (autograd.is_recording() and op.differentiable
              and any(t.requires_grad for t in datas))
    with torch.set_grad_enabled(record):
        if has_varargs:
            outs = op.fn(*datas, **kw)
        else:
            call = dict(kw)
            call.update(zip(arr_names, datas))
            outs = op.fn(**call)
    multi = isinstance(outs, (tuple, list))
    results = [NDArray(o, out_ctx) for o in (outs if multi else [outs])]
    if op.mutate_inputs:
        # in-place state (FMutateInputs): the trailing outputs are the
        # new values of the mutable inputs, written back into them
        spec = op.mutate_inputs(attrs) if callable(op.mutate_inputs) \
            else op.mutate_inputs
        results, new_states = results[:-len(spec)], results[-len(spec):]
        multi = len(results) > 1
        for slot, new in zip(spec, new_states):
            if not isinstance(slot, int):
                if not arr_names or slot not in arr_names:
                    continue
                slot = arr_names.index(slot)
            if slot < len(nd_inputs):
                nd_inputs[slot]._set_data(new._data)
    # BatchNorm and RNN show their extra outputs only on request, as the
    # reference's ops do (output_mean_var, state_outputs)
    if op.name in ("BatchNorm", "_contrib_SyncBatchNorm") and \
            not attrs.get("output_mean_var", False):
        results, multi = results[:1], False
    elif op.name == "RNN" and not attrs.get("state_outputs", False):
        results, multi = results[:1], False

    if out is not None:
        tgt = out if isinstance(out, (tuple, list)) else [out]
        for t, r in zip(tgt, results):
            t._set_data(r._data)
        return out
    return results if multi else results[0]


_INPUT_TYPES = (NDArray, np.ndarray, torch.Tensor)


def _make_op_func(op_name):
    op = ops.get(op_name)
    sig = ops.op_signature(op_name)
    has_varargs = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                      for p in sig.parameters.values())
    pnames = [p.name for p in sig.parameters.values()
              if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]

    def func(*args, out=None, name=None, ctx=None, **kwargs):
        named_inputs = []  # (param_name, NDArray)
        attrs = {}
        if has_varargs:
            arrs = []
            for a in args:
                if isinstance(a, (list, tuple)):
                    arrs.extend(a)
                else:
                    arrs.append(a)
            named_inputs = [(None, _as_nd(a, ctx)) for a in arrs]
        else:
            for pname, val in zip(pnames, args):
                if isinstance(val, _INPUT_TYPES):
                    named_inputs.append((pname, _as_nd(val, ctx)))
                elif val is not None:
                    attrs[pname] = val
        for k, v in kwargs.items():
            if isinstance(v, _INPUT_TYPES):
                named_inputs.append((k, _as_nd(v, ctx)))
            elif k != "dtype":
                attrs[k] = _canon_attr(v)
            elif v is not None:
                attrs["dtype"] = dtype_name(v)
        if has_varargs:
            nd_inputs = [a for _, a in named_inputs]
            input_names = None
        else:
            # bind tensors to op parameters by name, in signature order
            order = {p: i for i, p in enumerate(pnames)}
            named_inputs.sort(key=lambda t: order.get(t[0], 99))
            nd_inputs = [a for _, a in named_inputs]
            input_names = [n for n, _ in named_inputs]
        return imperative_invoke(op_name, nd_inputs, attrs, out=out,
                                 input_names=input_names, ctx=ctx)

    func.__name__ = op_name
    func.__doc__ = (op.fn.__doc__ or "") + "\n\n(made from the op registry)"
    return func


def _make_queued_func(op_name):
    def func(*args, **kwargs):
        raise ops.queued_error(op_name)
    func.__name__ = op_name
    func.__doc__ = str(ops.queued_error(op_name))
    return func


def _canon_attr(v):
    if isinstance(v, str):
        low = v.strip()
        if low.startswith("(") or low.startswith("["):
            try:
                return tuple(int(x) for x in low.strip("()[]").split(",")
                             if x.strip())
            except ValueError:
                return v
        for cast in (int, float):
            try:
                return cast(low)
            except ValueError:
                pass
        if low in ("True", "true"):
            return True
        if low in ("False", "false"):
            return False
    return v


def _as_nd(v, ctx=None, dtype=None):
    if isinstance(v, NDArray):
        return v
    if isinstance(v, torch.Tensor):
        return NDArray(v, ctx)
    return array(v, ctx=ctx, dtype=dtype)


# Synthesize the op namespace (python/mxnet/ndarray/register.py:258).
_g = globals()
for _name in ops.list_ops():
    if _name not in _g:
        _g[_name] = _make_op_func(_name)
for _alias in list(ops._ALIAS):
    if _alias not in _g:
        _g[_alias] = _make_op_func(_alias)
for _name in QUEUED:
    if _name not in _g:
        _g[_name] = _make_queued_func(_name)

# Friendlier python names used by NDArray methods above
slice_op = _g["slice"]
abs_op = _g["abs"]
maximum_nd = _g["broadcast_maximum"]
minimum_nd = _g["broadcast_minimum"]

_REVERSED_SCALAR_OP = {
    "_plus_scalar": "_plus_scalar", "_mul_scalar": "_mul_scalar",
    "_minus_scalar": "_rminus_scalar", "_div_scalar": "_rdiv_scalar",
    "_power_scalar": "_rpower_scalar", "_mod_scalar": "_rmod_scalar",
    "_maximum_scalar": "_maximum_scalar",
    "_minimum_scalar": "_minimum_scalar",
    "_equal_scalar": "_equal_scalar",
    "_not_equal_scalar": "_not_equal_scalar",
    "_greater_scalar": "_lesser_scalar",
    "_greater_equal_scalar": "_lesser_equal_scalar",
    "_lesser_scalar": "_greater_scalar",
    "_lesser_equal_scalar": "_greater_equal_scalar"}


def _binary_with_scalar(nd_op, scalar_op):
    def f(lhs, rhs):
        if isinstance(rhs, NDArray) and isinstance(lhs, NDArray):
            return nd_op(lhs, rhs)
        if isinstance(lhs, NDArray):
            return imperative_invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        return imperative_invoke(_REVERSED_SCALAR_OP[scalar_op], [rhs],
                                 {"scalar": float(lhs)})
    return f


add = _binary_with_scalar(_g["broadcast_add"], "_plus_scalar")
subtract = _binary_with_scalar(_g["broadcast_sub"], "_minus_scalar")
multiply = _binary_with_scalar(_g["broadcast_mul"], "_mul_scalar")
divide = _binary_with_scalar(_g["broadcast_div"], "_div_scalar")
modulo = _binary_with_scalar(_g["broadcast_mod"], "_mod_scalar")
power = _binary_with_scalar(_g["broadcast_power"], "_power_scalar")
maximum = _binary_with_scalar(_g["broadcast_maximum"], "_maximum_scalar")
minimum = _binary_with_scalar(_g["broadcast_minimum"], "_minimum_scalar")
equal = _binary_with_scalar(_g["broadcast_equal"], "_equal_scalar")
not_equal = _binary_with_scalar(_g["broadcast_not_equal"],
                                "_not_equal_scalar")
greater = _binary_with_scalar(_g["broadcast_greater"], "_greater_scalar")
greater_equal = _binary_with_scalar(_g["broadcast_greater_equal"],
                                    "_greater_equal_scalar")
lesser = _binary_with_scalar(_g["broadcast_lesser"], "_lesser_scalar")
lesser_equal = _binary_with_scalar(_g["broadcast_lesser_equal"],
                                   "_lesser_equal_scalar")
true_divide = divide


def _logical_pair(nd_op_name):
    nd_op = _g[nd_op_name]

    def f(lhs, rhs):
        return nd_op(_as_nd(lhs), _as_nd(rhs))
    f.__name__ = nd_op_name.replace("broadcast_", "")
    return f


logical_and = _logical_pair("broadcast_logical_and")
logical_or = _logical_pair("broadcast_logical_or")
logical_xor = _logical_pair("broadcast_logical_xor")


def from_numpy(ndarray_np, zero_copy=False):
    """mx.nd.from_numpy: a copy of a numpy array (``zero_copy`` is
    accepted for API parity)."""
    return array(ndarray_np)


# --------------------------------------------------------- dlpack -------
def to_dlpack_for_read(data):
    """The array's tensor, which implements the DLPack protocol
    (``torch.from_dlpack``, ``np.from_dlpack``, ``jax.dlpack``)."""
    data.wait_to_read()
    return data._data.detach()


def to_dlpack_for_write(data):
    """The array's tensor, made its own first (no other NDArray shares
    it), so that writes through it change this array alone."""
    data.wait_to_read()
    return data._own_buffer().detach()


def from_dlpack(dlpack):
    """An NDArray over a DLPack-protocol object (torch tensor, numpy
    array, jax array...), sharing its memory."""
    if not hasattr(dlpack, "__dlpack__"):
        raise MXNetError(
            "from_dlpack needs an object implementing the DLPack protocol "
            "(__dlpack__/__dlpack_device__); raw PyCapsules are not "
            "supported — pass the tensor itself")
    t = torch.from_dlpack(dlpack)
    return NDArray(t, context_of(t.device))


def _ndarray_unpickle(arr, dtype_name_, device_type):
    out = array(arr, ctx=Context(device_type, 0))
    if dtype_name(out.dtype) != dtype_name_:
        out = out.astype(dtype_name_)
    return out


# --------------------------------------------------------- creation -----
def _resolve_ctx(ctx):
    return ctx if ctx is not None else current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _check_stype(kwargs):
    stype = kwargs.get("stype")
    if stype not in (None, "default"):
        raise _sparse_error(stype)


def array(source_array, ctx=None, dtype=None):
    """mx.nd.array (python/mxnet/ndarray/utils.py): a new array holding a
    copy of ``source_array``."""
    ctx = _resolve_ctx(ctx)
    device = ctx.torch_device
    if isinstance(source_array, (NDArray, torch.Tensor)):
        t = source_array._data if isinstance(source_array, NDArray) \
            else source_array
        dt = t.dtype if dtype is None else _to_torch_dtype(dtype)
        return NDArray(t.detach().to(device=device, dtype=dt, copy=True),
                       ctx)
    if dtype is None:
        if isinstance(source_array, np.ndarray):
            dtype = source_array.dtype
            if dtype == np.float64:
                dtype = np.float32
        else:
            dtype = np.float32
            probe = np.asarray(source_array)
            if probe.dtype.kind in "iub":
                dtype = probe.dtype
    name = _DTYPE_ALIAS.get(dtype_name(dtype), dtype_name(dtype))
    if name == "bfloat16":
        # numpy has no bfloat16: stage through float32
        arr = np.asarray(source_array, dtype=np.float32)
        return NDArray(torch.tensor(arr, device=device).to(torch.bfloat16),
                       ctx)
    arr = np.asarray(source_array, dtype=np.dtype(name))
    # 64-bit integer VALUES stay intact (large-tensor indices), as in the
    # JAX package; every other type follows its narrowing
    dt = torch_dtype(name, narrow=arr.dtype not in (np.int64, np.uint64))
    return NDArray(torch.tensor(arr, dtype=dt, device=device), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    _check_stype(kwargs)
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=_to_torch_dtype(dtype),
                               device=ctx.torch_device), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    _check_stype(kwargs)
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=_to_torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    _check_stype(kwargs)
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.full(_shape(shape), val,
                              dtype=_to_torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    ctx = _resolve_ctx(ctx)
    return NDArray(ops.matrix.arange_tensor(
        start, stop, step, repeat, _to_torch_dtype(dtype), ctx.torch_device),
        ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    ctx = _resolve_ctx(ctx)
    return NDArray(ops.matrix.eye_tensor(
        int(N), int(M), int(k), _to_torch_dtype(dtype), ctx.torch_device),
        ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    ctx = _resolve_ctx(ctx)
    return NDArray(ops.matrix.linspace_tensor(
        start, stop, num, endpoint, _to_torch_dtype(dtype),
        ctx.torch_device), ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return _g["Concat"](*arrays, dim=axis)


def waitall():
    engine.wait_for_all()


def moveaxis(tensor, source, destination):
    with _grad_mode():
        return NDArray(tensor._data.movedim(source, destination),
                       tensor._ctx)


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """``_split_v2`` with a tuple of split points turned into section
    starts by prepending 0 (python/mxnet/ndarray/ndarray.py split_v2)."""
    if isinstance(indices_or_sections, int):
        attrs = {"sections": indices_or_sections}
    else:
        attrs = {"indices": (0,) + tuple(indices_or_sections), "sections": 0}
    out = imperative_invoke("_split_v2", [_as_nd(ary)],
                            dict(attrs, axis=axis, squeeze_axis=squeeze_axis))
    return out if isinstance(out, list) else [out]


# ------------------------------------------------------------ save/load --
_SAVE_MAGIC = b"MXTPU001"


def save(fname, data):
    """mx.nd.save in the JAX package's format, so that a file written by
    one package loads in the other: magic | json header (names, dtypes,
    shapes) | raw little-endian buffers, bfloat16 widened to float32."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = None
        arrays = list(data)
    header = {
        "names": names,
        "dtypes": [dtype_name(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
    }
    hb = json.dumps(header).encode()
    with open(fname, "wb") as f:
        f.write(_SAVE_MAGIC)
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for a in arrays:
            host = a._data.detach()
            if host.dtype == torch.bfloat16:
                host = host.to(torch.float32)
            f.write(np.ascontiguousarray(host.cpu().numpy()).tobytes())


def load(fname, ctx=None):
    """mx.nd.load. Only a file that is not in the format gets "invalid
    NDArray file"; an error of the arrays' context (no CUDA device for
    the default gpu(0)) comes through as it is."""
    with open(fname, "rb") as f:
        buf = f.read()
    try:
        f, header = _parse_header(buf)
    except MXNetError:
        raise MXNetError("invalid NDArray file %s" % fname)
    return _load_arrays(f, header, ctx)


def load_frombuffer(buf, ctx=None):
    """mx.nd.load_frombuffer: deserialize from bytes."""
    f, header = _parse_header(buf)
    return _load_arrays(f, header, ctx)


def _parse_header(buf):
    """(stream at the first payload, header) of a saved buffer."""
    f = io.BytesIO(buf)
    if f.read(8) != _SAVE_MAGIC:
        raise MXNetError("invalid NDArray buffer")
    try:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
    except (struct.error, ValueError) as exc:
        raise MXNetError("invalid NDArray buffer: %s" % exc)
    return f, header


def _load_arrays(f, header, ctx):
    arrays = []
    for dt, shp in zip(header["dtypes"], header["shapes"]):
        # bfloat16 payloads are stored widened to float32 (see save)
        npdt = np.dtype(np.float32) if dt == "bfloat16" else np.dtype(dt)
        n = int(np.prod(shp)) if shp else 1
        arr = np.frombuffer(f.read(n * npdt.itemsize),
                            dtype=npdt).reshape(shp)
        a = array(arr, ctx=ctx, dtype=npdt)
        arrays.append(a.astype("bfloat16") if dt == "bfloat16" else a)
    if header["names"] is not None:
        return dict(zip(header["names"], arrays))
    return arrays


# ------------------------------------------------------------- random ---
class _RandomNamespace:
    """mx.nd.random.* (python/mxnet/ndarray/random.py)."""

    @staticmethod
    def _call(op_both, op_scalar, params, shape, dtype, ctx, **extra):
        if any(isinstance(p, NDArray) for p in params):
            nds = [_as_nd(p, ctx) for p in params]
            return imperative_invoke(op_both, nds,
                                     dict(shape=shape, dtype=dtype, **extra))
        attrs = dict(shape=shape if shape != () else (1,), dtype=dtype,
                     **extra)
        return imperative_invoke(
            op_scalar, [], dict(attrs, **dict(zip(
                ops.op_signature(op_scalar).parameters, params))), ctx=ctx)

    @staticmethod
    def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None,
                out=None, **kw):
        return _RandomNamespace._call("sample_uniform", "_random_uniform",
                                      [low, high], shape, dtype, ctx)

    @staticmethod
    def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None,
               out=None, **kw):
        return _RandomNamespace._call("sample_normal", "_random_normal",
                                      [loc, scale], shape, dtype, ctx)

    @staticmethod
    def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, **kw):
        return _RandomNamespace._call("sample_gamma", "_random_gamma",
                                      [alpha, beta], shape, dtype, ctx)

    @staticmethod
    def exponential(lam=1, shape=(), dtype="float32", ctx=None, **kw):
        return _RandomNamespace._call("sample_exponential",
                                      "_random_exponential", [lam], shape,
                                      dtype, ctx)

    @staticmethod
    def poisson(lam=1, shape=(), dtype="float32", ctx=None, **kw):
        return _RandomNamespace._call("sample_poisson", "_random_poisson",
                                      [lam], shape, dtype, ctx)

    @staticmethod
    def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                          **kw):
        return imperative_invoke("_random_negative_binomial", [],
                                 {"k": k, "p": p, "shape": shape or (1,),
                                  "dtype": dtype}, ctx=ctx)

    @staticmethod
    def generalized_negative_binomial(mu=1, alpha=1, shape=(),
                                      dtype="float32", ctx=None, **kw):
        return imperative_invoke("_random_generalized_negative_binomial", [],
                                 {"mu": mu, "alpha": alpha,
                                  "shape": shape or (1,), "dtype": dtype},
                                 ctx=ctx)

    @staticmethod
    def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
        return imperative_invoke("_sample_multinomial", [_as_nd(data)],
                                 {"shape": shape, "get_prob": get_prob,
                                  "dtype": dtype})

    @staticmethod
    def randint(low, high, shape=(), dtype="int32", ctx=None, **kw):
        return imperative_invoke("_random_randint", [],
                                 {"low": low, "high": high,
                                  "shape": shape or (1,), "dtype": dtype},
                                 ctx=ctx)

    @staticmethod
    def randn(*shape, loc=0, scale=1, dtype="float32", ctx=None, **kw):
        return _RandomNamespace.normal(loc, scale, shape=shape, dtype=dtype,
                                       ctx=ctx)

    @staticmethod
    def shuffle(data, **kw):
        return _g["shuffle"](data)


random = _RandomNamespace()


class _OpNamespace:
    """nd.op — the bare operator namespace: every registry op/alias."""

    def __getattr__(self, item):
        if ops.exists(item) or item in QUEUED:
            return _g[item]
        raise AttributeError(item)

    def __dir__(self):
        return sorted(set(list(ops._REGISTRY) + list(ops._ALIAS)))


op = _OpNamespace()


class _PrefixNamespace:
    """nd.contrib / nd.linalg / nd.image: the registry's ``<prefix>*``
    names (``contrib.boolean_mask`` is ported; most are queued);
    ``contrib``'s ``foreach``, ``while_loop`` and ``cond`` are the eager
    loops of ``control_flow``."""

    def __init__(self, prefix, control_flow=False):
        self._prefix = prefix
        self._control_flow = control_flow

    def __getattr__(self, item):
        if self._control_flow and item in ("foreach", "while_loop", "cond"):
            from . import control_flow
            return getattr(control_flow, item)
        for name in (self._prefix + item, item):
            if ops.exists(name) or name in QUEUED:
                return _g[name]
        raise AttributeError(item)


class _ImageNamespace(_PrefixNamespace):
    """nd.image: the registered ``_image_*`` ops first, then the helpers
    of the ``image`` module (``imdecode``, ``resize_short``, ...), as in
    the reference."""

    def __getattr__(self, item):
        try:
            return super().__getattr__(item)
        except AttributeError:
            from . import image as _image
            return getattr(_image, item)


contrib = _PrefixNamespace("_contrib_", control_flow=True)
linalg = _PrefixNamespace("linalg_")
image = _ImageNamespace("_image_")


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its second axis
    is the depth)."""
    return one_hot(indices, depth=out.shape[1], out=out)


_SPARSE_NAMES = ("sparse", "csr_matrix", "row_sparse_array")


def __getattr__(name):
    if name in _SPARSE_NAMES:
        raise MXNetError(
            "nd.%s is mxnet_tpu/sparse.py, which the PyTorch port has not "
            "ported yet (ROADMAP item A9)" % name)
    raise AttributeError(name)


# ------------------------------------------------- fluent methods -------
_FLUENT_METHODS = [
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "argmax_channel", "broadcast_axes", "cbrt", "ceil", "cos", "cosh",
    "degrees", "depth_to_space", "diag", "expm1", "fix", "floor",
    "log10", "log1p", "log2", "nanprod", "nansum", "radians", "rcbrt",
    "reciprocal", "rint", "round", "rsqrt", "shape_array", "sin",
    "sinh", "size_array", "slice_like", "softmin", "space_to_depth",
    "tan", "trunc", "exp", "log", "sqrt", "square", "abs", "sign",
    "relu", "sigmoid", "tanh", "softmax", "log_softmax", "argsort",
    "sort", "clip", "norm",
]


def _make_fluent(name):
    fn = _g[name]

    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = "Fluent form of nd.%s(self, ...)." % name
    return method


for _name in _FLUENT_METHODS:
    if _name in _g and not hasattr(NDArray, _name):
        setattr(NDArray, _name, _make_fluent(_name))


def _nd_slice_assign(self, rhs, begin, end, step=()):
    return _g["_slice_assign"](self, rhs, begin=begin, end=end, step=step)


def _nd_slice_assign_scalar(self, scalar, begin, end, step=()):
    return _g["_slice_assign_scalar"](self, scalar=scalar, begin=begin,
                                      end=end, step=step)


def _as_np_ndarray(self):
    raise MXNetError("mx.np arrays are mxnet_tpu/numpy, which the PyTorch "
                     "port has not ported yet (ROADMAP item A9)")


NDArray.slice_assign = _nd_slice_assign
NDArray.slice_assign_scalar = _nd_slice_assign_scalar
NDArray.split_v2 = lambda self, *a, **kw: split_v2(self, *a, **kw)
NDArray.to_dlpack_for_read = lambda self: to_dlpack_for_read(self)
NDArray.to_dlpack_for_write = lambda self: to_dlpack_for_write(self)
NDArray.as_np_ndarray = _as_np_ndarray
NDArray.as_nd_ndarray = lambda self: self
