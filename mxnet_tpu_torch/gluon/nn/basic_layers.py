"""Gluon basic layers (port of ``mxnet_tpu/gluon/nn/basic_layers.py``;
reference: python/mxnet/gluon/nn/basic_layers.py:34-758).

BatchNorm's running-statistics update is functional: the op returns the
batch statistics, and the layer (eagerly) or the graph executor
(hybridized, ``executor.build_graph_fn``) folds the momentum update.
``InstanceNorm``, ``LayerNorm`` and ``GroupNorm`` run their ops of
``ops/nn.py``; a sparse ``Embedding`` gradient waits for ``sparse.py``
(A9).
"""

import torch

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Concurrent", "HybridConcurrent", "Identity"]


class _ChainContainer(object):
    """Shared container protocol for the two sequential stacks: add(),
    chained application, indexing (slices clone into a same-prefix
    container), len/iter, and the tree repr — written once instead of
    twice."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def _apply_chain(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        body = "\n".join(
            "  (%s): %s" % (key, repr(block).replace("\n", "\n  "))
            for key, block in self._children.items())
        return "%s(\n%s\n)" % (type(self).__name__, body)

    def __getitem__(self, key):
        picked = list(self._children.values())[key]
        if not isinstance(picked, list):
            return picked
        clone = type(self)(prefix=self._prefix)
        with clone.name_scope():
            clone.add(*picked)
        return clone

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_ChainContainer, Block):
    """Stacks Blocks sequentially (gluon/nn/basic_layers.py:34)."""

    def forward(self, x):
        return self._apply_chain(x)

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            import warnings
            warnings.warn(
                "All children of this Sequential layer '%s' are "
                "HybridBlocks. Consider using HybridSequential for the "
                "best performance." % self.prefix, stacklevel=2)
        super(Sequential, self).hybridize(active, **kwargs)


class HybridSequential(_ChainContainer, HybridBlock):
    """Stacks HybridBlocks sequentially (gluon/nn/basic_layers.py:117)."""

    def hybrid_forward(self, F, x):
        return self._apply_chain(x)


class Dense(HybridBlock):
    """Densely-connected layer: out = act(dot(x, W^T) + b)
    (gluon/nn/basic_layers.py:167)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super(Dense, self).__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten,
                               name="fwd")
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({layout}, {act})"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        act=self.act if self.act else "linear",
                        layout="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]))


class Dropout(HybridBlock):
    """Dropout regularization (gluon/nn/basic_layers.py:237). The mask
    is drawn from the device's generator (``random.generator``), in a
    hybridized graph as in ``nd``."""

    def __init__(self, rate, axes=(), **kwargs):
        super(Dropout, self).__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd",
                             cudnn_off=False)
        return F._copy(x)

    def __repr__(self):
        s = "{name}(p = {_rate}, axes={_axes})"
        return s.format(name=self.__class__.__name__, **self.__dict__)


def _affine_pair(layer, in_channels, gamma_init, beta_init,
                 scale, center, track_grads=True):
    """Declare the norm family's gamma/beta pair under the layer's
    scope. scale/center toggle learnability (grad_req null keeps the
    param present for checkpoint parity even when frozen)."""
    def declare(name, init, learn):
        kw = dict(grad_req="write" if learn else "null",
                  shape=(in_channels,), init=init,
                  allow_deferred_init=True)
        if track_grads:
            kw["differentiable"] = learn
        return layer.params.get(name, **kw)
    layer.gamma = declare("gamma", gamma_init, scale)
    layer.beta = declare("beta", beta_init, center)


def _norm_repr(layer):
    inside = ", ".join("%s=%r" % kv for kv in layer._kwargs.items())
    width = layer.gamma.shape[0]
    return "%s(%s, in_channels=%s)" % (type(layer).__name__, inside,
                                       width if width else None)


class BatchNorm(HybridBlock):
    """Batch normalization (gluon/nn/basic_layers.py:291)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super(BatchNorm, self).__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            _affine_pair(self, in_channels, gamma_initializer,
                         beta_initializer, scale, center)
            for stat, init in (("running_mean", running_mean_initializer),
                               ("running_var",
                                running_variance_initializer)):
                setattr(self, stat, self.params.get(
                    stat, grad_req="null", shape=(in_channels,),
                    init=init, allow_deferred_init=True,
                    differentiable=False))

    def cast(self, dtype):
        if dtype in ("float16", "bfloat16"):
            dtype = "float32"  # stats stay fp32 (reference: BN runs fp32)
        super(BatchNorm, self).cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if F is nd and autograd.is_training() \
                and not self._kwargs["use_global_stats"]:
            out, mean, var = F.BatchNorm(
                x, gamma, beta, running_mean, running_var,
                output_mean_var=True, name="fwd", **self._kwargs)
            mom = self._kwargs["momentum"]
            with torch.no_grad():
                running_mean._set_data(mom * running_mean._data +
                                       (1 - mom) * mean._data)
                running_var._set_data(mom * running_var._data +
                                      (1 - mom) * var._data)
            return out
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        return _norm_repr(self)


class Embedding(HybridBlock):
    """Turns non-negative integers into dense vectors
    (gluon/nn/basic_layers.py:397)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        if sparse_grad:
            raise MXNetError(
                "Embedding(sparse_grad=True) needs row_sparse gradients, "
                "mxnet_tpu/sparse.py, which the PyTorch port has not "
                "ported yet (ROADMAP item A9)")
        super(Embedding, self).__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        s = "{block_name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(block_name=self.__class__.__name__, **self._kwargs)


class Flatten(HybridBlock):
    """Flattens the input to (batch, -1) (gluon/nn/basic_layers.py:459)."""

    def __init__(self, **kwargs):
        super(Flatten, self).__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class InstanceNorm(HybridBlock):
    """Instance normalization (gluon/nn/basic_layers.py:480)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super(InstanceNorm, self).__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            _affine_pair(self, in_channels, gamma_initializer,
                         beta_initializer, scale, center,
                         track_grads=False)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd", eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd",
                              eps=self._epsilon).swapaxes(1, self._axis)

    def __repr__(self):
        return _norm_repr(self)


class LayerNorm(HybridBlock):
    """Layer normalization over the last (or given) axis
    (gluon/nn/basic_layers.py:563)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super(LayerNorm, self).__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis}
        self._axis = axis
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        with self.name_scope():
            _affine_pair(self, in_channels, gamma_initializer,
                         beta_initializer, scale, center,
                         track_grads=False)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)

    def __repr__(self):
        return _norm_repr(self)


class GroupNorm(HybridBlock):
    """Group normalization (gluon/nn/basic_layers.py:657)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super(GroupNorm, self).__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "num_groups": num_groups}
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        with self.name_scope():
            _affine_pair(self, in_channels, gamma_initializer,
                         beta_initializer, scale, center,
                         track_grads=False)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.GroupNorm(data, gamma=gamma, beta=beta,
                           num_groups=self._num_groups, eps=self._epsilon)

    def __repr__(self):
        inside = ", ".join("%s=%r" % kv for kv in self._kwargs.items())
        return "%s(%s)" % (type(self).__name__, inside)


def _named_callable(function, namespaces):
    """Resolve a Lambda layer's function argument: a name looked up in
    the given op namespaces (returns a {namespace: fn} dispatch map), or
    a callable used as-is. Returns (impl, display_name)."""
    if callable(function):
        return function, function.__name__
    if isinstance(function, str):
        table = {ns: getattr(ns, function, None) for ns in namespaces}
        if any(fn is not None for fn in table.values()):
            return table, function
        raise AssertionError(
            "Function name %s is not found in %s." % (
                function, "/".join(ns.__name__.rsplit(".", 1)[-1]
                                   for ns in namespaces)))
    raise ValueError("Unrecognized function in lambda: {} of type {}"
                     .format(function, type(function)))


class Lambda(Block):
    """Wraps a function as a Block (gluon/nn/basic_layers.py:727)."""

    def __init__(self, function, prefix=None):
        super(Lambda, self).__init__(prefix=prefix)
        impl, self._func_name = _named_callable(function, (nd,))
        self._func_impl = impl[nd] if isinstance(impl, dict) else impl

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)


class HybridLambda(HybridBlock):
    """Wraps a function as a HybridBlock (gluon/nn/basic_layers.py:758)."""

    def __init__(self, function, prefix=None):
        super(HybridLambda, self).__init__(prefix=prefix)
        from ... import symbol as sym
        self._func, self._func_name = _named_callable(function, (sym, nd))

    def hybrid_forward(self, F, x, *args):
        if isinstance(self._func, dict):
            return self._func[F](x, *args)
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)


from .activations import Activation  # noqa: E402  (Dense uses it)


class Concurrent(Sequential):
    """Runs children on the same input and concatenates their outputs
    along `axis` (reference gluon/contrib/nn/basic_layers.py Concurrent;
    promoted into gluon.nn as in later MXNet)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super(Concurrent, self).__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            import warnings
            warnings.warn(
                "All children of this Concurrent layer '%s' are HybridBlocks. "
                "Consider using HybridConcurrent for the best performance."
                % self.prefix, stacklevel=2)
        Block.hybridize(self, active, **kwargs)


class HybridConcurrent(HybridSequential):
    """Hybridizable Concurrent."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super(HybridConcurrent, self).__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Identity mapping — useful as a no-op branch in Concurrent."""

    def hybrid_forward(self, F, x):
        return x
