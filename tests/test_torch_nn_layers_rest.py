"""The Gluon layers over the rest of the port's ``ops/nn.py`` against the
JAX package's, imperative and hybridized: LeakyReLU, PReLU, ELU, SELU,
GELU, InstanceNorm, LayerNorm, GroupNorm and the 1-, 2- and 3-d
transposed convolutions (the layers that raised naming ROADMAP item A6
before their ops were ported). Parameters are set in both packages from
the same seeded numpy arrays; the output and the input's gradient under a
seeded head gradient are compared.

Tolerance: fp32 at rtol 1e-5 with an atol of 1e-5 times the largest
magnitude of the reference."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def U(shape, seed, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape), np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want, rtol, what):
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


X = U((2, 4, 5, 5), 1)


LAYERS = {
    "LeakyReLU": lambda nn: nn.LeakyReLU(0.1),
    "PReLU": lambda nn: nn.PReLU(),
    "ELU": lambda nn: nn.ELU(0.5),
    "SELU": lambda nn: nn.SELU(),
    "GELU": lambda nn: nn.GELU(),
    "InstanceNorm": lambda nn: nn.InstanceNorm(in_channels=4),
    "LayerNorm": lambda nn: nn.LayerNorm(in_channels=5),
    "GroupNorm": lambda nn: nn.GroupNorm(num_groups=2, in_channels=4),
    "Conv2DTranspose": lambda nn: nn.Conv2DTranspose(
        3, 4, strides=2, padding=1, output_padding=1, in_channels=4),
    "Conv1DTranspose": lambda nn: nn.Conv1DTranspose(2, 3, strides=2,
                                                     in_channels=4),
    "Conv3DTranspose": lambda nn: nn.Conv3DTranspose(2, 2, in_channels=4),
}
LAYER_X = {"Conv1DTranspose": U((2, 4, 5), 21),
           "Conv3DTranspose": U((1, 4, 3, 3, 3), 22)}


def _layer_run(mx, name, hybrid):
    blk = LAYERS[name](mx.gluon.nn)
    blk.initialize()
    for k, (pname, p) in enumerate(sorted(blk.collect_params().items())):
        p.set_data(mx.nd.array(U(p.shape, 70 + k, 0.2, 1.0)))
    if hybrid:
        blk.hybridize()
    x = mx.nd.array(LAYER_X.get(name, X))
    x.attach_grad()
    with mx.autograd.record():
        y = blk(x)
    y.backward(mx.nd.array(U(y.shape, 98)))
    return y.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("hybrid", [False, True], ids=["imperative",
                                                       "hybridized"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_gluon_layer_matches_jax(name, hybrid):
    ty, tg = _layer_run(mt, name, hybrid)
    jy, jg = _layer_run(jmx, name, hybrid)
    _close(ty.astype(np.float64), jy.astype(np.float64), 1e-5,
           name + " output")
    _close(tg.astype(np.float64), jg.astype(np.float64), 1e-5,
           name + " input gradient")
