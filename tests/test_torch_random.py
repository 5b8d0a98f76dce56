"""The port's samplers (``mxnet_tpu_torch.ops.random_ops``) against the
JAX package's.

PyTorch's generators and JAX's keys never draw the same numbers, so the
samplers are held against JAX by shape, dtype (JAX's float16 is the
port's bfloat16) and support, and against their distributions by a
seeded Kolmogorov-Smirnov or chi-square test (p > 1e-4, as
``tests/test_op_parity.py``'s samplers are). Also here: the op
registry's random names, seeding, where a draw lands, and the executor's
device for zero-input nodes (``_zeros``, the samplers), which it did not
pass before. The pdf ops are ``test_torch_random_pdf.py``'s, the
namespaces' routing ``test_torch_random_api.py``'s."""

import functools

import numpy as np
import pytest
import torch
from scipy import stats

from mxnet_tpu import nd as jnd
from mxnet_tpu import ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch import sym as tsym
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P_MIN = 1e-4
N_DRAWS = 20000


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _port_dtype(name):
    return "bfloat16" if name == "float16" else name


def _dt(arr):
    return str(arr.dtype)


# ------------------------------------------------------------ registry --
def test_gate_every_random_op_and_alias_is_ported():
    jax_ops = {n: op for n, op in jops._REGISTRY.items()
               if op.fn.__module__.endswith(".random_ops")}
    port = {n for n, op in tops._REGISTRY.items()
            if op.fn.__module__.endswith(".random_ops")}
    assert port == set(jax_ops)
    for alias, real in jops._ALIAS.items():
        if real in jax_ops:
            assert tops._ALIAS.get(alias) == real, alias
    for name, op in jax_ops.items():
        assert tops.get(name).stateful_rng == op.stateful_rng, name
        assert tops.get(name).differentiable == op.differentiable, name


# ----------------------------------------------------- shapes and dtypes --
P2 = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.25, 0.25]], np.float32)
A3 = np.array([1.0, 2.5, 4.0], np.float32)
B3 = np.array([0.5, 1.0, 2.0], np.float32)
PR3 = np.array([0.3, 0.5, 0.7], np.float32)

# (op, array inputs, attrs, support): support(draws, inputs) -> bool
SAMPLER_CASES = [
    ("_random_uniform", [], dict(low=-1.0, high=2.0, shape=(3, 4)),
     lambda d, i: (d >= -1).all() and (d < 2).all()),
    ("_random_uniform", [], dict(shape=(6,), dtype="float16"),
     lambda d, i: (d >= 0).all() and (d <= 1).all()),
    ("_random_normal", [], dict(loc=1.0, scale=2.0, shape=(3, 4)),
     lambda d, i: np.isfinite(d).all()),
    ("_random_normal", [], dict(shape=(5,), dtype="float16"),
     lambda d, i: np.isfinite(d).all()),
    ("_random_gamma", [], dict(alpha=2.0, beta=3.0, shape=(7,)),
     lambda d, i: (d > 0).all()),
    ("_random_exponential", [], dict(lam=2.0, shape=(7,)),
     lambda d, i: (d >= 0).all()),
    ("_random_poisson", [], dict(lam=3.0, shape=(7,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
    ("_random_negative_binomial", [], dict(k=3, p=0.4, shape=(7,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
    ("_random_generalized_negative_binomial", [],
     dict(mu=2.0, alpha=0.5, shape=(7,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
    ("_random_randint", [], dict(low=2, high=9, shape=(4, 5)),
     lambda d, i: (d >= 2).all() and (d < 9).all()),
    ("_sample_multinomial", [P2], dict(shape=(3,)),
     lambda d, i: ((d >= 0) & (d < 4)).all() and (d[1] != 1).all()),
    ("_sample_multinomial", [P2[0]], dict(shape=(5,)),
     lambda d, i: ((d >= 0) & (d < 4)).all()),
    ("_sample_multinomial", [P2[0]], {}, lambda d, i: 0 <= d < 4),
    ("_sample_unique_zipfian", [], dict(range_max=50, shape=(3, 20)),
     lambda d, i: ((d >= 0) & (d < 50)).all()
     and all(len(set(r)) == len(r) for r in d)),
    ("sample_uniform", [A3, A3 + B3], dict(shape=(4,)),
     lambda d, i: (d >= i[0][:, None]).all() and (d < i[1][:, None]).all()),
    ("sample_normal", [A3, B3], dict(shape=(2, 3)),
     lambda d, i: np.isfinite(d).all()),
    ("sample_gamma", [A3, B3], dict(shape=(4,)), lambda d, i: (d > 0).all()),
    ("sample_exponential", [B3], dict(shape=(4,)),
     lambda d, i: (d >= 0).all()),
    ("sample_poisson", [A3], dict(shape=(4,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
    ("sample_negative_binomial", [A3, PR3], dict(shape=(4,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
    ("sample_generalized_negative_binomial", [A3, B3], dict(shape=(4,)),
     lambda d, i: (d >= 0).all() and (d == np.round(d)).all()),
]


@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)),
                         ids=["%s-%d" % (c[0], k)
                              for k, c in enumerate(SAMPLER_CASES)])
def test_sampler_shape_dtype_and_support_match_jax(case):
    name, inputs, attrs, support = SAMPLER_CASES[case]
    want = getattr(jnd, name)(*[jnd.array(x) for x in inputs], **attrs)
    mt.random.seed(case)
    got = getattr(tnd, name)(*[tnd.array(x) for x in inputs], **attrs)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert _dt(got) == _port_dtype(_dt(want)), (_dt(got), _dt(want))
    assert support(got.asnumpy().astype(np.float64), inputs)
    assert support(want.asnumpy().astype(np.float64), inputs)


# ------------------------------------------------------- distributions --
def _ks(draws, cdf):
    return stats.kstest(draws, cdf).pvalue


def _chi2(draws, pmf, support):
    """Chi-square of integer draws against ``pmf`` over ``support``, the
    tail beyond it pooled into the last cell."""
    counts = np.array([(draws == k).sum() for k in support], np.float64)
    probs = np.array([pmf(k) for k in support])
    counts = np.append(counts, len(draws) - counts.sum())
    probs = np.append(probs, max(1.0 - probs.sum(), 0.0))
    keep = probs * len(draws) >= 5
    rest = (counts[~keep].sum(), probs[~keep].sum())
    counts = np.append(counts[keep], rest[0])
    probs = np.append(probs[keep], rest[1])
    if probs[-1] * len(draws) < 5:
        counts[-2] += counts[-1]
        probs[-2] += probs[-1]
        counts, probs = counts[:-1], probs[:-1]
    return stats.chisquare(counts, probs / probs.sum() * len(draws)).pvalue


N = (N_DRAWS,)
DIST_CASES = {
    "uniform": (lambda: tnd.random.uniform(-1, 3, shape=N),
                lambda d: _ks(d, stats.uniform(-1, 4).cdf)),
    "normal": (lambda: tnd.random.normal(0.5, 2.0, shape=N),
               lambda d: _ks(d, stats.norm(0.5, 2.0).cdf)),
    "gamma": (lambda: tnd.random.gamma(3.0, 2.0, shape=N),
              lambda d: _ks(d, stats.gamma(3.0, scale=2.0).cdf)),
    "gamma_small_alpha": (lambda: tnd.random.gamma(0.5, 1.0, shape=N),
                          lambda d: _ks(d, stats.gamma(0.5).cdf)),
    "exponential": (lambda: tnd.random.exponential(1.5, shape=N),
                    lambda d: _ks(d, stats.expon(scale=1 / 1.5).cdf)),
    "mx.random.exponential": (lambda: mt.random.exponential(2.0, shape=N),
                              lambda d: _ks(d, stats.expon(scale=2.0).cdf)),
    "poisson": (lambda: tnd.random.poisson(3.5, shape=N),
                lambda d: _chi2(d, stats.poisson(3.5).pmf, range(15))),
    "negative_binomial": (
        lambda: tnd.random.negative_binomial(3, 0.4, shape=N),
        lambda d: _chi2(d, stats.nbinom(3, 0.4).pmf, range(25))),
    "generalized_negative_binomial": (
        lambda: tnd.random.generalized_negative_binomial(2.0, 0.5, shape=N),
        lambda d: _chi2(d, stats.nbinom(2.0, 0.5).pmf, range(20))),
    "randint": (lambda: tnd.random.randint(-3, 5, shape=N),
                lambda d: _chi2(d, lambda k: 1 / 8, range(-3, 5))),
    "multinomial": (
        lambda: tnd.random.multinomial(tnd.array(P2[0]), shape=N),
        lambda d: _chi2(d, lambda k: P2[0][k], range(4))),
    "sample_normal": (
        lambda: tnd.random.normal(tnd.array([0.0, 5.0]),
                                  tnd.array([1.0, 0.5]), shape=N)[1],
        lambda d: _ks(d, stats.norm(5.0, 0.5).cdf)),
    "sample_gamma": (
        lambda: tnd.random.gamma(tnd.array([1.0, 4.0]),
                                 tnd.array([2.0, 0.5]), shape=N)[1],
        lambda d: _ks(d, stats.gamma(4.0, scale=0.5).cdf)),
    "sample_poisson": (
        lambda: tnd.random.poisson(tnd.array([1.0, 7.0]), shape=N)[1],
        lambda d: _chi2(d, stats.poisson(7.0).pmf, range(20))),
    "sample_negative_binomial": (
        lambda: tnd.sample_negative_binomial(
            tnd.array([2.0, 5.0]), tnd.array([0.5, 0.7]), shape=N)[1],
        lambda d: _chi2(d, stats.nbinom(5.0, 0.7).pmf, range(15))),
}


@pytest.mark.parametrize("name", sorted(DIST_CASES))
def test_sampler_distribution(name):
    """The seeded draw passes its distribution's test at p > 1e-4."""
    draw, test = DIST_CASES[name]
    mt.random.seed(1234)
    p = test(draw().asnumpy().astype(np.float64))
    assert p > P_MIN, "%s failed its distribution test (p=%g)" % (name, p)


def test_bfloat16_draws_follow_their_distribution():
    mt.random.seed(5)
    u = tnd.random.uniform(shape=N, dtype="float16")
    assert u._data.dtype == torch.bfloat16
    d = u.asnumpy().astype(np.float64)
    # bfloat16 rounds the draws to 8 bits of mantissa: bins of 1/16
    hist = np.histogram(d, bins=16, range=(0, 1))[0]
    assert stats.chisquare(hist).pvalue > P_MIN


# ------------------------------------------------------------- seed --
def test_seed_reproduces_every_sampler_bitwise():
    draws = []
    for _ in range(2):
        mt.random.seed(42)
        draws.append([
            tnd.random.uniform(shape=(50,)), tnd.random.normal(shape=(50,)),
            tnd.random.gamma(0.7, shape=(50,)),
            tnd.random.exponential(shape=(50,)),
            tnd.random.poisson(3, shape=(50,)),
            tnd.random.negative_binomial(2, 0.3, shape=(50,)),
            tnd.random.generalized_negative_binomial(2, 0.3, shape=(50,)),
            tnd.random.randint(0, 100, shape=(50,)),
            tnd.random.multinomial(tnd.array(P2), shape=(50,)),
            tnd._sample_unique_zipfian(range_max=1000, shape=(2, 50)),
            tnd.random.normal(tnd.array(A3), tnd.array(B3), shape=(9,))])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    mt.random.seed(43)
    assert not np.array_equal(tnd.random.uniform(shape=(50,)).asnumpy(),
                              draws[0][0].asnumpy())


def test_a_draw_lands_on_ctx_else_the_current_context():
    mt.random.seed(0)
    assert tnd.random.uniform(shape=(2,), ctx=mt.cpu(0)).context == \
        mt.cpu(0)
    assert tnd.random.normal(shape=(2,)).context == mt.current_context()
    assert mt.random.randint(0, 3, shape=(2,), ctx=mt.cpu()).context == \
        mt.cpu()
    # without a context the default is gpu(0), which raises on a host
    with mt.gpu(0):
        if not torch.cuda.is_available():
            with pytest.raises(mt.MXNetError, match="CUDA"):
                tnd.random.uniform(shape=(2,))


# ------------------------------------------------- the executor's device --
def _record_devices(monkeypatch, names):
    seen = {n: [] for n in names}
    for name in names:
        op = tops.get(name)
        fn = op.fn

        @functools.wraps(fn)
        def rec(*a, _fn=fn, _name=name, **kw):
            seen[_name].append((kw.get("device"),
                                getattr(kw.get("generator"), "device",
                                        None)))
            return _fn(*a, **kw)
        monkeypatch.setattr(op, "fn", rec)
    return seen


def test_executor_passes_its_device_to_zero_input_nodes(monkeypatch):
    """A bound graph's zero-input nodes (``_zeros``, ``_arange``) get the
    executor's device: before the repair, ``executor._node_call`` passed
    a graph node no ``device``, and such nodes made their outputs on
    torch's default device whatever the executor's context (fault C12,
    ROADMAP §C). Shape inference runs the same nodes on meta tensors."""
    seen = _record_devices(monkeypatch, ("_zeros", "_arange"))
    x = tsym.var("x")
    net = tsym.zeros((2, 3)) + x + tsym._arange(start=0, stop=3).reshape(
        (1, 3))
    ex = net.bind(mt.cpu(), {"x": tnd.ones((2, 3))})
    out = ex.forward()[0]
    np.testing.assert_array_equal(out.asnumpy(), [[1, 2, 3], [1, 2, 3]])
    cpu = torch.device("cpu")
    assert seen["_zeros"][-1][0] == cpu
    assert seen["_arange"][-1][0] == cpu
    assert net.infer_shape(x=(2, 3))[1] == [(2, 3)]
    assert seen["_zeros"][-1][0] == torch.device("meta")


def test_executor_gives_a_sampler_node_its_device_and_generator(
        monkeypatch):
    """A sampler node in a bound graph draws on the executor's device
    from that device's generator, also in a graph with no argument."""
    seen = _record_devices(monkeypatch, ("_random_uniform",))
    x = tsym.var("x")
    net = x + tsym.random.uniform(shape=(2, 3))
    out = net.bind(mt.cpu(), {"x": tnd.ones((2, 3))}).forward()[0]
    assert out.shape == (2, 3) and out.context == mt.cpu()
    cpu = torch.device("cpu")
    assert seen["_random_uniform"][-1] == (cpu, cpu)
    only = tsym.random.uniform(shape=(4,)).bind(mt.cpu(), {})
    assert only.forward()[0].shape == (4,)
    assert seen["_random_uniform"][-1] == (cpu, cpu)


def test_cached_op_passes_the_inputs_device_and_draws_fresh_masks(
        monkeypatch):
    """A hybridized block's zero-input nodes land on its inputs' device;
    its dropout draws a new mask on every call (``tests/test_gluon.py``'s
    ``test_dropout_hybrid_randomness``)."""
    seen = _record_devices(monkeypatch, ("_zeros",))
    layer = mt.gluon.nn.HybridLambda(
        lambda F, x: x + F.zeros((2, 3)))
    layer.hybridize()
    layer(tnd.ones((2, 3)))
    assert seen["_zeros"][-1][0] == torch.device("cpu")
    drop = mt.gluon.nn.Dropout(0.5)
    drop.hybridize()
    x = tnd.ones((100,))
    with tag.record():
        y1 = drop(x).asnumpy()
        y2 = drop(x).asnumpy()
    assert not np.allclose(y1, y2)
    np.testing.assert_array_equal(drop(x).asnumpy(), 1.0)
