"""Weight initializers (port of ``mxnet_tpu/initializer.py``; reference:
python/mxnet/initializer.py).

The ``Initializer`` base with its registry and ``InitDesc`` attr routing
(an ``__init__`` attr names the initializer, else the name's suffix
picks the handler: weight, bias, gamma, beta, ...), ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``, ``Mixed`` and
``Load``.
Random draws come from the explicit ``torch.Generator`` of the array's
device (``random.generator``), on that device, so ``random.seed(n)``
reproduces an initialization on one device. PyTorch's and JAX's streams
never agree: an initialization crosses between the packages by
``save_parameters``/``load_parameters`` or ``models.convert``.
"""

import json
import re

import numpy as np
import torch

from . import ndarray as nd
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)


def _draw(arr):
    """(generator, device) to draw ``arr``'s values with."""
    device = arr._data.device
    return _random.generator(device), device


class InitDesc(str):
    """Parameter name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer(object):
    """Base init: routes by the ``__init__`` attr, else by name suffix."""

    # suffix -> handler-method name; checked in order, first match wins
    _SUFFIX_ROUTES = (
        ("weight_quantize", "_init_quantized_weight"),
        ("weight", "_init_weight"),
        ("bias", "_init_bias"),
        ("gamma", "_init_gamma"),
        ("beta", "_init_beta"),
        ("min", "_init_zero"),
        ("max", "_init_one"),
    )

    def __init__(self, **kwargs):
        # the kwargs double as the serialized config (dumps) AND the
        # subclass's hyperparameters
        self._kwargs = kwargs
        self.__dict__.update(kwargs)
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func or (lambda x: None)
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init_attr = desc.attrs.get("__init__", "")
        if init_attr:
            try:
                name, kwargs = json.loads(init_attr)
            except (json.JSONDecodeError, ValueError):
                name, kwargs = init_attr, {}   # bare registry name
            create(name, **kwargs)._init_weight(desc, arr)
            return
        for suffix, handler in self._SUFFIX_ROUTES:
            if desc.endswith(suffix):
                getattr(self, handler)(desc, arr)
                return
        self._init_default(desc, arr)

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_quantized_weight(self, _, arr):
        gen, device = _draw(arr)
        arr[:] = torch.randint(-127, 127, arr.shape, generator=gen,
                               device=device, dtype=torch.int32
                               ).to(torch.int8)

    def _init_default(self, name, arr):
        raise ValueError("Unknown initialization pattern for %s." % name)


def _uniform(arr, lo, hi):
    gen, device = _draw(arr)
    return lo + (hi - lo) * torch.rand(arr.shape, generator=gen,
                                       device=device)


def _normal(arr):
    gen, device = _draw(arr)
    return torch.randn(arr.shape, generator=gen, device=device)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale), drawn on the array's device."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)

    def _init_weight(self, _, arr):
        arr[:] = _uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma), drawn on the array's device."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)

    def _init_weight(self, _, arr):
        arr[:] = self.sigma * _normal(arr)


@register
class Orthogonal(Initializer):
    """Scaled orthogonal matrix: the Q factor of a Gaussian matrix with
    its columns' signs fixed by R's diagonal (Haar-distributed). The
    leading axis is the output dim; trailing axes are flattened into the
    input dim (as for conv weights)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        # rand_type is accepted for API parity; both settings draw the
        # Haar-distributed factor, as in the reference package
        super().__init__(scale=scale, rand_type=rand_type)

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        n, m = max(nout, nin), min(nout, nin)
        gen, device = _draw(arr)
        a = torch.randn((n, n), generator=gen, device=device)
        q, r = torch.linalg.qr(a)
        q = (q * torch.sign(torch.diagonal(r)))[:, :m]
        if nout < nin:
            q = q.t()
        arr[:] = (self.scale * q).reshape(arr.shape)


@register
class Xavier(Initializer):
    """Glorot init: variance set by fan_in/fan_out/avg of the layer."""

    _FACTORS = {
        "avg": lambda fin, fout: (fin + fout) / 2.0,
        "in": lambda fin, fout: fin,
        "out": lambda fin, fout: fout,
    }

    def __init__(self, rnd_type="uniform", factor_type="avg",
                 magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.magnitude = float(magnitude)

    def _fans(self, name, shape):
        if len(shape) < 2:
            raise ValueError(
                "Xavier initializer cannot be applied to vector {0}. It "
                "requires at least 2D.".format(name))
        receptive = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        return shape[1] * receptive, shape[0] * receptive

    def _init_weight(self, name, arr):
        fan_in, fan_out = self._fans(name, arr.shape)
        try:
            factor = self._FACTORS[self.factor_type](fan_in, fan_out)
        except KeyError:
            raise ValueError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            arr[:] = _uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = scale * _normal(arr)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He init with the gain corrected for a PReLU negative slope."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel for deconvolution weights: the outer
    product of two 1-D triangle profiles broadcast over (out, in)."""

    def _init_weight(self, _, arr):
        kh, kw = arr.shape[2], arr.shape[3]
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        ramp_x = 1.0 - np.abs(np.arange(kw) / f - c)
        ramp_y = 1.0 - np.abs(np.arange(kh) / f - c)
        kernel = (ramp_y[:, None] * ramp_x[None, :]).astype(np.float32)
        arr[:] = torch.as_tensor(np.broadcast_to(kernel, arr.shape).copy())


@register
class LSTMBias(Initializer):
    """Zero bias with the forget-gate quarter set to forget_bias.

    Gate layout along the bias vector: [input, forget, cell, output].
    """

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)

    def _init_weight(self, name, arr):
        hidden = arr.shape[0] // 4
        gate = torch.arange(arr.shape[0]) // hidden
        arr[:] = torch.where(gate == 1, float(self.forget_bias), 0.0)


class Mixed(object):
    """Dispatches each parameter to the first regex-matching initializer."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self._routes = [(re.compile(p), init)
                        for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        chosen = next((init for prog, init in self._routes
                       if prog.match(name)), None)
        if chosen is None:
            raise ValueError(
                "Parameter name %s did not match any pattern. Consider "
                'adding a ".*" pattern at the end.' % name)
        chosen(name, arr)


@register
class Load(object):
    """Init from a dict of saved params, with optional fallback init."""

    def __init__(self, param, default_init=None, verbose=False):
        table = nd.load(param) if isinstance(param, str) else param
        self.param = {
            (name[4:] if name[:4] in ("arg:", "aux:") else name): arr
            for name, arr in table.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        saved = self.param.get(name)
        if saved is not None:
            if arr.shape != saved.shape:
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. "
                    "Shape mismatch, target %s vs loaded %s"
                    % (name, str(arr.shape), saved.shape))
            arr[:] = saved._data
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(
                "Cannot Initialize parameter %s. Not found in loaded "
                "param and no default Initializer is provided." % name)


@register
class FusedRNN(Initializer):
    """Init for the fused RNN's packed parameter vector (ops/nn.py RNN):
    all gate weights, then all gate biases. As in the JAX package, every
    weight draws from U(-0.07, 0.07) whatever ``init`` says, and the
    biases are zero but for the LSTM forget gates, at ``forget_bias``."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                 "gru": 3}[self._mode]
        h = self._num_hidden
        dirs = 2 if self._bidirectional else 1
        total = int(np.prod(arr.shape))
        nbias = 2 * dirs * self._num_layers * gates * h
        gen, device = _draw(arr)
        weights = torch.rand((total - nbias,), generator=gen,
                             device=device) * 0.14 - 0.07
        bias = torch.zeros((nbias,), device=device)
        if self._mode == "lstm":
            gate = (torch.arange(nbias, device=device) % (gates * h)) // h
            bias = torch.where(gate == 1, float(self._forget_bias), bias)
        arr[:] = torch.cat([weights, bias]).reshape(arr.shape)


# Registry aliases matching the reference's registered names.
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
_INIT_REGISTRY["msra"] = MSRAPrelu
