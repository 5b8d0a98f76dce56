"""Global RNG state (port of ``mxnet_tpu/random.py``).

``seed`` reseeds one explicit ``torch.Generator`` per device, which the
stateful ops draw from (``shuffle``, the samplers of
``ops/random_ops.py``, dropout): it takes the place of the JAX package's
key chain (``next_key``/``key_scope``). PyTorch's and JAX's streams never
agree, so a stateful op is checked by its properties, not its values.
The convenience samplers (``uniform``, ``normal``, ...) call
``nd.random``, as mx.random.* does (python/mxnet/ndarray/random.py).
"""

import threading

import torch

_lock = threading.Lock()
_generators = {}
_seed = [0]


def seed(seed_state, ctx="all"):
    """mx.random.seed (python/mxnet/random.py:38): reseed the generator
    of every device, or of ``ctx`` alone."""
    with _lock:
        if ctx == "all":
            _seed[0] = int(seed_state)
            _generators.clear()
        else:
            from .context import Context
            dev = Context(ctx).torch_device
            _generators[dev] = _new(dev, int(seed_state))


def _new(device, seed_state):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_state)
    return gen


def generator(device):
    """The generator of ``device`` (a ``torch.device``), made from the
    last ``seed`` at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = _generators[device] = _new(device, _seed[0])
        return gen


def _nd():
    from . import ndarray as nd
    return nd


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None,
            **kw):
    return _nd().random.uniform(low, high, shape=shape, dtype=dtype, ctx=ctx)


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None,
           **kw):
    return _nd().random.normal(loc, scale, shape=shape, dtype=dtype, ctx=ctx)


def randn(*shape, **kw):
    return normal(shape=shape, **kw)


def poisson(lam=1, shape=(), dtype="float32", ctx=None, **kw):
    return _nd().random.poisson(lam, shape=shape, dtype=dtype, ctx=ctx)


def exponential(scale=1, shape=(), dtype="float32", ctx=None, **kw):
    return _nd().random.exponential(1.0 / scale, shape=shape, dtype=dtype,
                                    ctx=ctx)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, **kw):
    return _nd().random.gamma(alpha, beta, shape=shape, dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None, **kw):
    return _nd().random.negative_binomial(k, p, shape=shape, dtype=dtype,
                                          ctx=ctx)


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, **kw):
    return _nd().random.generalized_negative_binomial(
        mu, alpha, shape=shape, dtype=dtype, ctx=ctx)


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    return _nd().random.multinomial(data, shape=shape, get_prob=get_prob,
                                    dtype=dtype)


def randint(low, high, shape=(), dtype="int32", ctx=None, **kw):
    return _nd().random.randint(low, high, shape=shape, dtype=dtype, ctx=ctx)


def shuffle(data, **kw):
    return _nd().shuffle(data)
