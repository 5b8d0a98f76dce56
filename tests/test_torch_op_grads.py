"""Gradient parity of the port's ops with the JAX package's: for every
differentiable op of ``ops/elemwise.py`` (``ops/reduce_ops.py`` and
``ops/matrix.py``: ``test_torch_op_grads_matrix.py``), on the cases of
``test_torch_ops.py``, the gradient of
sum(output * cotangent) with respect to every float32 input, through
the JAX package's autograd and the port's (torch.autograd), for a seeded
cotangent, at ten times the case's value tolerance."""

import numpy as np
import pytest

import test_torch_ops as cases
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu import ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def differentiable(modules):
    return [n for n in cases._jax_ops() if jops.get(n).differentiable
            and jops.get(n).fn.__module__.split(".")[-1] in modules]


def check_gradient(name, monkeypatch):
    inputs, attrs, tol = cases._case(name, monkeypatch)
    assert any(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in inputs), "%s's case has no float32 input" % name
    want = cases._grads(jnd, jag, name, inputs, attrs, None)
    got = cases._grads(tnd, tag, name, inputs, attrs, mt.cpu())
    if got is None:
        # the port's output does not depend on a variable through torch
        # (a comparison): JAX's gradient is zero
        for g in want:
            np.testing.assert_array_equal(g, 0 * g, err_msg=name)
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol[0] * 10, atol=tol[1] * 10,
                                   err_msg=name)


@pytest.mark.parametrize("name", differentiable(("elemwise",)))
def test_op_gradient_parity(name, monkeypatch):
    check_gradient(name, monkeypatch)
