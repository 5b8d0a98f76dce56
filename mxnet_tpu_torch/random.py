"""Global RNG state (port of ``mxnet_tpu/random.py``).

``seed`` reseeds one explicit ``torch.Generator`` per device, which the
stateful ops draw from (``shuffle``, ``ops/matrix.py``). PyTorch's and
JAX's streams never agree, so a stateful op is checked by its
properties, not its values. The samplers (``uniform``, ``normal``, ...)
are ops of ``ops/random_ops.py``, which waits for ROADMAP A9.
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


def shuffle(data, **kw):
    return _nd().shuffle(data)
