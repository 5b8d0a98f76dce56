"""The port's sampling namespaces (``nd.random``, ``mx.random``,
``sym.random``) against the JAX package's: each routes a draw to the
scalar ``_random_*`` op or the tensor ``sample_*`` op as JAX's does, so
the same calls give the same shapes and dtypes (the streams differ, so
values are not compared), and a ``sym.random`` graph infers and binds
as JAX's."""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import sym as tsym
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P2 = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.25, 0.25]], np.float32)
A3 = np.array([1.0, 2.5, 4.0], np.float32)
B3 = np.array([0.5, 1.0, 2.0], np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _dt(arr):
    return str(arr.dtype)


# ---------------------------------------------------- namespaces, seed --
ROUTES = [
    ("uniform", (0, 2), dict(shape=(2, 3))),
    ("uniform", (0, 2), {}),
    ("normal", (1, 2), dict(shape=(4,))),
    ("gamma", (2, 1), dict(shape=(4,))),
    ("exponential", (2,), dict(shape=(4,))),
    ("poisson", (2,), dict(shape=(4,))),
    ("negative_binomial", (3, 0.5), dict(shape=(4,))),
    ("generalized_negative_binomial", (2, 0.5), dict(shape=(4,))),
    ("negative_binomial", (3, 0.5), {}),
    ("randint", (0, 5), dict(shape=(2, 2))),
    ("uniform", ("A", "B"), dict(shape=(2,))),
    ("normal", ("A", "B"), dict(shape=(2, 3))),
    ("gamma", ("A", "B"), {}),
    ("exponential", ("B",), dict(shape=(5,))),
    ("poisson", ("A",), dict(shape=(5,))),
    ("multinomial", ("P",), dict(shape=(2,))),
]


@pytest.mark.parametrize("case", range(len(ROUTES)),
                         ids=["%s-%d" % (r[0], k)
                              for k, r in enumerate(ROUTES)])
def test_nd_random_routes_as_jax(case):
    """nd.random.* picks the scalar or the tensor op as JAX's does: the
    same shapes and dtypes (a scalar draw with shape () has shape (1,)
    in both)."""
    name, params, kw = ROUTES[case]
    arrays = {"A": A3, "B": B3, "P": P2}

    def call(nd):
        args = [nd.array(arrays[p]) if isinstance(p, str) else p
                for p in params]
        return getattr(nd.random, name)(*args, **kw)
    want, got = call(jnd), call(tnd)
    assert got.shape == want.shape and _dt(got) == _dt(want)


def test_mx_random_convenience_samplers_match_jax():
    """mx.random.* at the parameters and shapes of ``ROUTES``' scalar
    cases (exponential's ``scale`` is 1 / lam)."""
    for name, args, kw in (("uniform", (0, 2), dict(shape=(2, 3))),
                           ("normal", (1, 2), dict(shape=(4,))),
                           ("randn", (4,), {}),
                           ("poisson", (2,), dict(shape=(4,))),
                           ("exponential", (0.5,), dict(shape=(4,))),
                           ("gamma", (2, 1), dict(shape=(4,))),
                           ("negative_binomial", (3, 0.5), dict(shape=(4,))),
                           ("generalized_negative_binomial", (2, 0.5),
                            dict(shape=(4,))),
                           ("randint", (0, 5), dict(shape=(2, 2)))):
        want = getattr(jmx.random, name)(*args, **kw)
        got = getattr(mt.random, name)(*args, **kw)
        assert got.shape == want.shape and _dt(got) == _dt(want), name
    want = jmx.random.multinomial(jnd.array(P2), shape=(2,))
    got = mt.random.multinomial(tnd.array(P2), shape=(2,))
    assert got.shape == want.shape and _dt(got) == _dt(want)


def test_sym_random_composes_and_binds_as_jax():
    jsym = jmx.sym
    for route in ("scalar", "symbol"):
        outs = {}
        for mod, sym_ns, nd in (("jax", jsym, jnd), ("port", tsym, tnd)):
            if route == "scalar":
                s = sym_ns.random.normal(loc=1.0, scale=2.0, shape=(3, 4))
                args = {}
            else:
                s = sym_ns.random.uniform(sym_ns.var("lo"),
                                          sym_ns.var("hi"), shape=(5,))
                args = {"lo": nd.array(A3), "hi": nd.array(A3 + B3)}
            ctx = mt.cpu() if mod == "port" else jmx.cpu()
            shapes = s.infer_shape(**{k: v.shape for k, v in args.items()})
            outs[mod] = (shapes[1], s.bind(ctx, args).forward()[0])
        assert outs["port"][0] == outs["jax"][0]
        assert outs["port"][1].shape == outs["jax"][1].shape
    got = outs["port"][1].asnumpy()
    assert (got >= A3[:, None]).all() and (got < (A3 + B3)[:, None]).all()
