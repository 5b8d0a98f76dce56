"""Gluon Parameter / ParameterDict (port of
``mxnet_tpu/gluon/parameter.py``; reference:
python/mxnet/gluon/parameter.py).

A Parameter holds one NDArray on one device (its Context), so
``list_data`` returns a single element. Deferred initialization (shape
inferred at first forward) is kept: ``initialize`` on a parameter whose
shape is not known yet records the initializer, and the first forward
finishes it.
"""

import json
import warnings

import torch

from .. import autograd
from .. import initializer
from .. import ndarray as nd
from ..base import MXNetError, dtype_name
from ..context import current_context

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (nd.NDArray,)


def _one_ctx(ctx):
    """The Context a parameter lives on: one Context (the first of a
    list), or None for the current context when it is made."""
    if isinstance(ctx, (list, tuple)):
        return ctx[0] if ctx else None
    return ctx


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization
    (python/mxnet/gluon/parameter.py:36)."""
    pass


class Parameter(object):
    """A Container holding parameters (weights) of Blocks
    (python/mxnet/gluon/parameter.py:42).

    Parameters
    ----------
    name : str
    grad_req : {'write', 'add', 'null'}
    shape : tuple, elements may be 0/-1 (unknown, inferred at first forward)
    dtype : numpy dtype or str
    lr_mult / wd_mult : float
    init : Initializer
    allow_deferred_init : bool
    differentiable : bool
    stype / grad_stype : {'default', 'row_sparse', 'csr'}
    """

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self._shape = tuple(shape) if shape is not None else None
        self.name = name
        self._dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._stype = stype
        self._grad_stype = grad_stype
        self.grad_req = grad_req

    def __repr__(self):
        s = "Parameter {name} (shape={shape}, dtype={dtype})"
        return s.format(name=self.name, shape=self.shape, dtype=self.dtype)

    # ------------------------------------------------------- properties --
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(
                "grad_req must be write/add/null, got %s" % req)
        effective = req if self._differentiable else "null"
        if effective == self._grad_req:
            return
        self._grad_req = effective
        # transitioning in/out of "null" (re)binds the grad buffer
        if effective == "null":
            self._grad = None
        elif self._data is not None:
            self._init_grad()

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self.cast(dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is not None:
            # every previously-declared dim must either be a wildcard
            # (0/-1, deferred) or agree exactly
            mismatch = len(self._shape) != len(new_shape) or any(
                old not in (0, -1) and old != new
                for old, new in zip(self._shape, new_shape))
            if mismatch:
                raise AssertionError(
                    "Expected shape %s is incompatible with given shape "
                    "%s for Parameter %s"
                    % (str(new_shape), str(self._shape), self.name))
        self._shape = tuple(new_shape)

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    # ---------------------------------------------------------- helpers --
    def _shape_known(self):
        return (self._shape is not None and len(self._shape) > 0 and
                all(s > 0 for s in self._shape))

    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters."
                % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you should "
            "initialize parameters and create Trainer with Block.collect_params() "
            "instead of Block.params" % self.name)

    def _init_impl(self, data):
        self._data = data if isinstance(data, nd.NDArray) else nd.array(data)
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = nd.zeros(self._data.shape, dtype=self._data.dtype,
                              ctx=self._data.context)
        self._data.attach_grad(self._grad_req)
        self._data._grad = self._grad

    def _init_spec_str(self, init):
        """The per-param initializer override serialized the way
        InitDesc attrs carry it (empty = use the default init)."""
        if init is None:
            return ""
        return json.dumps([init, {}]) if isinstance(init, str) \
            else init.dumps()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if not self._shape_known():
            raise MXNetError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self._shape)))
        with autograd.pause():
            if data is None:
                data = nd.zeros(self._shape, dtype=self._dtype, ctx=ctx)
                desc = initializer.InitDesc(
                    self.name, {"__init__": self._init_spec_str(init)})
                initializer.create(default_init)(desc, data)
            self._init_impl(data)

    # -------------------------------------------------------------- API --
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize parameter and gradient arrays
        (python/mxnet/gluon/parameter.py:337)."""
        if self._data is not None and not force_reinit:
            warnings.warn(
                "Parameter '%s' is already initialized, ignoring. "
                "Set force_reinit=True to re-initialize." % self.name)
            return
        self._data = self._grad = None
        pending = (init if init is not None else self.init, _one_ctx(ctx),
                   default_init or initializer.Uniform(), None)
        if self._shape_known():
            self._deferred_init = pending
            self._finish_deferred_init()
        elif self._allow_deferred_init:
            self._deferred_init = pending
        else:
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s. Please specify in_units, in_channels, etc "
                "for `Block`s." % (self.name, str(self._shape)))

    def _load_init(self, data, ctx=None, cast_dtype=False,
                   dtype_source="current"):
        """Initialize from loaded data (used by load_parameters), on
        ``ctx``, else where the parameter already lives."""
        ctx = _one_ctx(ctx)
        if ctx is None and self._data is not None:
            ctx = self._data.context
        if ctx is not None:
            data = data.as_in_context(ctx)
        if cast_dtype and dtype_source == "current" and self._dtype is not None:
            data = data.astype(self._dtype)
        else:
            self._dtype = dtype_name(data.dtype)
        if self._shape is not None and self._shape_known():
            if tuple(self.shape) != tuple(data.shape):
                raise AssertionError(
                    "Failed loading Parameter '%s' from saved params: shape "
                    "incompatible expected %s vs saved %s"
                    % (self.name, str(self.shape), str(data.shape)))
        else:
            self._shape = tuple(data.shape)
        self._deferred_init = ()
        self._init_impl(data)

    def set_data(self, data):
        """Sets this parameter's value on all contexts."""
        self.shape = data.shape
        if self._data is not None:
            self._data._set_data(
                data._data if isinstance(data, nd.NDArray)
                else nd.array(data, ctx=self._data.context)._data)
            return
        if not self._deferred_init:
            raise AssertionError(
                "Parameter '%s' has not been initialized" % self.name)
        # stash the value into the pending init so the first forward
        # lands it instead of drawing from the initializer
        self._deferred_init = self._deferred_init[:3] + (data,)

    def data(self, ctx=None):
        """Returns this parameter's array (one context holds it)."""
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def row_sparse_data(self, row_id):
        """Rows `row_id` of a row_sparse parameter (reference
        parameter.py row_sparse_data; dense-backed here, so this is a
        gather of the requested rows)."""
        if self._stype != "row_sparse":
            raise RuntimeError(
                "Cannot return a copy of Parameter %s via row_sparse_data()"
                " because its storage type is %s" % (self.name, self._stype))
        self._check_initialized()
        return nd.take(self._data, row_id)

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        self._check_initialized()
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._grad is None:
            return
        self._grad._data = torch.zeros_like(self._grad._data)

    def list_ctx(self):
        if self._data is None and self._deferred_init:
            return [self._deferred_init[1] or current_context()]
        self._check_initialized()
        return [self._data.context]

    def reset_ctx(self, ctx):
        """Moves the parameter (and its gradient) to ``ctx``."""
        if self._data is None:
            if self._deferred_init:
                self._deferred_init = (self._deferred_init[0], ctx) + \
                    self._deferred_init[2:]
            return
        with autograd.pause():
            self._data = self._data.as_in_context(ctx)
            if self._grad_req != "null":
                self._init_grad()

    def var(self):
        """Returns the symbol representing this parameter."""
        from .. import symbol
        if self._var is None:
            # only bake the shape into the variable once fully known —
            # partial shapes (zeros) would defeat deferred shape inference
            shape = self.shape if self._shape_known() else None
            self._var = symbol.var(self.name, shape=shape,
                                   dtype=self._dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult,
                                   init=self.init)
        return self._var

    def cast(self, dtype):
        self._dtype = dtype_name(dtype)
        if self._data is None:
            return
        with autograd.pause():
            self._data = self._data.astype(self._dtype)
            if self._grad is not None:
                self._grad = self._grad.astype(self._dtype)
                self._data.attach_grad(self._grad_req)
                self._data._grad = self._grad


class Constant(Parameter):
    """A constant parameter for holding non-differentiable values
    (python/mxnet/gluon/parameter.py:653)."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(value)
        self.value = value

        class Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                arr[:] = value._data
        init_name = "Constant_{}_{}".format(name, id(self))
        initializer._INIT_REGISTRY[init_name.lower()] = Init
        super(Constant, self).__init__(
            name, grad_req="null", shape=value.shape, dtype=value.dtype,
            init=init_name)


class ParameterDict(object):
    """A dictionary managing a set of parameters
    (python/mxnet/gluon/parameter.py:703)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        s = "{name}(\n{content}\n)"
        name = self._prefix + " " if self._prefix else ""
        return s.format(
            name=name,
            content="\n".join("  " + repr(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        found = self._params.get(name)
        if found is None and self._shared is not None:
            found = self._shared._params.get(name)
            if found is not None:
                self._params[name] = found   # adopt the shared param
        return found

    def get(self, name, **kwargs):
        """Retrieves or creates a ``Parameter`` named ``self.prefix+name``.
        Matches the reference's attribute-compatibility rule
        (gluon/parameter.py ParameterDict.get): existing attributes must be
        compatible with the requested ones, partial shapes unify."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            private = {"differentiable": "_differentiable",
                       "allow_deferred_init": "_allow_deferred_init"}
            for k, v in kwargs.items():
                if v is None:
                    continue
                attr = private.get(k, k)
                existing = getattr(param, attr, None)
                if k in private:
                    # construction-time flags: must simply agree
                    if existing != v:
                        raise AssertionError(
                            "Cannot retrieve Parameter '%s' because desired "
                            "attribute does not match with stored for "
                            "attribute '%s': desired '%s' vs stored '%s'."
                            % (name, k, str(v), str(existing)))
                    continue
                if existing is None:
                    setattr(param, k, v)
                    continue
                if k == "shape" and len(v) == len(existing):
                    # unify: 0/-1 dims are wildcards on either side
                    if all(sv in (0, -1) or ev in (0, -1) or sv == ev
                           for sv, ev in zip(v, existing)):
                        param._shape = tuple(
                            ev if sv in (0, -1) else sv
                            for sv, ev in zip(v, existing))
                        continue
                elif k == "init" or existing == v:
                    continue
                raise AssertionError(
                    "Cannot retrieve Parameter '%s' because desired "
                    "attribute does not match with stored for attribute "
                    "'%s': desired '%s' vs stored '%s'."
                    % (name, k, str(v), str(existing)))
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(
                    "No constant named '{}'. Please specify value if you want "
                    "to create a new constant.".format(name))
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            if not isinstance(param, Constant):
                raise TypeError("Parameter '{}' already exists but is not a "
                                "constant.".format(name))
        return param

    def update(self, other):
        """Copies all Parameters in ``other`` to self."""
        for k, v in other.items():
            mine = self._params.setdefault(k, v)
            if mine is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name '%s'" % k)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        default = init or initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        misnamed = next((p.name for p in self.values()
                         if not p.name.startswith(strip_prefix)), None)
        if misnamed is not None:
            raise ValueError(
                "Prefix '%s' is to be striped before saving, but "
                "Parameter's name '%s' does not start with it"
                % (strip_prefix, misnamed))
        nd.save(filename, {p.name[len(strip_prefix):]: p.data()
                           for p in self.values()})

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        lprefix = len(restore_prefix)
        if restore_prefix:
            stray = next((n for n in self.keys()
                          if not n.startswith(restore_prefix)), None)
            assert stray is None, \
                "restore_prefix is '%s' but Parameter name '%s' does " \
                "not start with it" % (restore_prefix, stray)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in nd.load(filename, ctx=_one_ctx(ctx)).items()}
        if not allow_missing:
            absent = next((n for n in self.keys()
                           if n not in arg_dict), None)
            assert absent is None, \
                "Parameter '%s' is missing in file '%s'" \
                % (absent and absent[lprefix:], filename)
        for name, value in arg_dict.items():
            target = self._params.get(name)
            if target is None:
                assert ignore_extra, \
                    "Parameter '%s' loaded from file '%s' is not " \
                    "present in ParameterDict" % (name[lprefix:], filename)
                continue
            target._load_init(value, ctx, cast_dtype=cast_dtype,
                              dtype_source=dtype_source)
