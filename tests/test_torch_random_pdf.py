"""The port's pdf ops (``ops/random_ops.py``'s eight ``_random_pdf_*``
densities) against the JAX package's: values and the gradients of every
input at fp32 atol 1e-5 / rtol 1e-4, as ``tests/test_op_parity.py`` and
``tests/test_op_gradients.py`` hold JAX's, and the closed forms those
tests check."""

import numpy as np
import pytest
from scipy import stats

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


# ------------------------------------------------------------- pdf ops --
def _u(shape, seed, lo, hi):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ints(shape, seed, hi):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(
        np.float32)


def _simplex(shape, seed):
    x = _u(shape, seed, 0.1, 1.0)
    return x / x.sum(-1, keepdims=True)


PDF_CASES = {
    "_random_pdf_uniform": [_u((2, 5), 1, 0.05, 0.95),
                            np.array([0.0, -0.2], np.float32),
                            np.array([1.0, 1.3], np.float32)],
    "_random_pdf_normal": [_u((2, 5), 2, -2, 2), _u((2,), 3, -0.5, 0.5),
                           _u((2,), 4, 0.5, 2.0)],
    "_random_pdf_gamma": [_u((2, 5), 5, 0.2, 3.0), _u((2,), 6, 1.0, 3.0),
                          _u((2,), 7, 0.5, 2.0)],
    "_random_pdf_exponential": [_u((2, 5), 8, 0.0, 3.0),
                                _u((2,), 9, 0.5, 2.0)],
    "_random_pdf_poisson": [_ints((2, 5), 10, 7), _u((2,), 11, 0.5, 4.0)],
    "_random_pdf_negative_binomial": [_ints((2, 5), 12, 8),
                                      np.array([3.0, 5.0], np.float32),
                                      _u((2,), 13, 0.2, 0.8)],
    "_random_pdf_generalized_negative_binomial": [
        _ints((2, 5), 14, 8), _u((2,), 15, 1.0, 4.0),
        _u((2,), 16, 0.2, 1.0)],
    "_random_pdf_dirichlet": [_simplex((2, 4, 3), 17),
                              _u((2, 3), 18, 0.8, 3.0)],
}


def _pdf_run(nd, ag, name, inputs, is_log):
    arrs = [nd.array(x) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        out = getattr(nd, name)(*arrs, is_log=is_log)
    cot = _u(out.shape, 99, 0.5, 1.5)
    out.backward(nd.array(cot))
    return out.asnumpy(), [a.grad.asnumpy() for a in arrs]


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("name", sorted(PDF_CASES))
def test_pdf_op_and_gradients_match_jax(name, is_log):
    """Values and the gradients of every input, at fp32 atol 1e-5 /
    rtol 1e-4, against ``test_op_gradients.py``'s JAX pdf gradients."""
    want, jgrads = _pdf_run(jnd, jag, name, PDF_CASES[name], is_log)
    got, tgrads = _pdf_run(tnd, tag, name, PDF_CASES[name], is_log)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_pdf_family_matches_closed_forms():
    """``test_op_parity.py``'s closed forms through the port, and the
    uniform density outside its support (0, log -inf, as in JAX)."""
    x = np.array([[0.5, 1.5, 2.5]], np.float32)
    lam = np.array([1.3], np.float32)
    np.testing.assert_allclose(
        tnd._random_pdf_exponential(tnd.array(x), tnd.array(lam))
        .asnumpy(), stats.expon.pdf(x, scale=1 / lam), rtol=1e-5)
    np.testing.assert_allclose(
        tnd._random_pdf_gamma(tnd.array(x), tnd.array([2.0]),
                              tnd.array([1.5])).asnumpy(),
        stats.gamma.pdf(x, a=2.0, scale=1 / 1.5), rtol=1e-5)
    cnt = np.array([[0.0, 2.0, 5.0]], np.float32)
    np.testing.assert_allclose(
        tnd._random_pdf_negative_binomial(
            tnd.array(cnt), tnd.array([3.0]), tnd.array([0.6])).asnumpy(),
        stats.nbinom.pmf(cnt, 3, 0.6), rtol=1e-5)
    np.testing.assert_allclose(
        tnd.pdf_dirichlet(tnd.array([[0.2, 0.3, 0.5]]),
                          tnd.array([[1.5, 2.0, 2.5]])).asnumpy(),
        stats.dirichlet.pdf([0.2, 0.3, 0.5], [1.5, 2.0, 2.5]), rtol=1e-4)
    s = np.array([[-0.5, 0.5, 3.0]], np.float32)
    args = (s, np.array([0.0], np.float32), np.array([2.0], np.float32))
    for is_log in (False, True):
        want = jnd.pdf_uniform(*map(jnd.array, args), is_log=is_log)
        got = tnd.pdf_uniform(*map(tnd.array, args), is_log=is_log)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
