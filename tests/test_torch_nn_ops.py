"""The port's ResNet subset of ``ops/nn.py`` against the JAX package's,
op by op, forward and gradient, on the same seeded numpy inputs through
each package's ``nd`` and ``autograd``.

Tolerances: fp32 at rtol 1e-5 and an atol of 1e-5 times the largest
magnitude of the reference; bf16 (BatchNorm on a bf16 stream) at rtol
and atol 2^-6 of the largest magnitude for the output and 2^-5 for
the gradients, since the two packages round the bf16 intermediates of
``x * scale + bias`` and of the reductions' inputs at different points.
The ties are pinned exactly: max pooling sends an all-equal window's
whole gradient to its first position, ``Activation(relu)`` has gradient
0 at 0 while the elementwise ``relu`` splits a tie in half. Dropout is
checked by its properties: torch's and JAX's streams never agree.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops.nn import batch_norm
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5
BF16_OUT, BF16_GRAD = 2.0 ** -6, 2.0 ** -5


def U(shape, seed, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape), np.float32)


def labels(n, classes, seed):
    return np.random.RandomState(seed).randint(0, classes, n).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _run(nd, ag, name, inputs, attrs, head_seed, train=True, dtype=None,
         out_index=0):
    """(outputs, gradients of every input) as numpy, the gradient of
    output ``out_index`` seeded with a uniform head from ``head_seed``."""
    arrs = {k: nd.array(v, dtype=dtype) for k, v in inputs}
    for a in arrs.values():
        a.attach_grad()
    with ag.record(train_mode=train):
        out = getattr(nd, name)(**arrs, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    head = U(outs[out_index].shape, head_seed)
    outs[out_index].backward(nd.array(head, dtype=dtype))
    return ([o.asnumpy().astype(np.float64) for o in outs],
            [a.grad.asnumpy().astype(np.float64) for a in arrs.values()])


def _close(got, want, rtol, scale):
    want_max = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * want_max)


def _check(name, inputs, attrs, train=True, dtype=None, out_index=0,
           tol=(RTOL, RTOL, RTOL)):
    jouts, jgrads = _run(jnd, jag, name, inputs, attrs, 99, train, dtype,
                         out_index)
    touts, tgrads = _run(tnd, tag, name, inputs, attrs, 99, train, dtype,
                         out_index)
    rtol, out_atol, grad_atol = tol
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        _close(t, j, rtol, out_atol)
    for (k, _), t, j in zip(inputs, tgrads, jgrads):
        _close(t, j, rtol, grad_atol)
    return touts, tgrads


X = U((2, 4, 7, 7), 1)
CONV = [
    ("plain", [("data", X), ("weight", U((6, 4, 3, 3), 2)),
               ("bias", U((6,), 3))],
     {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1)}),
    ("strided", [("data", X), ("weight", U((6, 4, 3, 3), 2))],
     {"kernel": (3, 3), "num_filter": 6, "stride": (2, 2), "pad": (1, 2),
      "no_bias": True}),
    ("dilated", [("data", X), ("weight", U((5, 4, 3, 3), 2)),
                 ("bias", U((5,), 3))],
     {"kernel": (3, 3), "num_filter": 5, "dilate": (2, 2), "pad": (2, 2)}),
    ("grouped", [("data", X), ("weight", U((6, 2, 3, 3), 2)),
                 ("bias", U((6,), 3))],
     {"kernel": (3, 3), "num_filter": 6, "num_group": 2, "stride": (2, 1)}),
    ("depthwise", [("data", X), ("weight", U((4, 1, 3, 3), 2))],
     {"kernel": (3, 3), "num_filter": 4, "num_group": 4, "pad": (1, 1),
      "no_bias": True}),
    ("1x1 stride 2", [("data", X), ("weight", U((8, 4, 1, 1), 2))],
     {"kernel": (1, 1), "num_filter": 8, "stride": (2, 2), "no_bias": True}),
    ("stem 7x7", [("data", U((1, 3, 16, 16), 4)),
                  ("weight", U((4, 3, 7, 7), 5))],
     {"kernel": (7, 7), "num_filter": 4, "stride": (2, 2), "pad": (3, 3),
      "no_bias": True}),
    ("1d", [("data", U((2, 3, 9), 1)), ("weight", U((4, 3, 3), 2)),
            ("bias", U((4,), 3))],
     {"kernel": (3,), "num_filter": 4, "pad": (1,), "stride": (2,)}),
    ("3d", [("data", U((1, 2, 5, 5, 5), 1)), ("weight", U((3, 2, 3, 3, 3), 2))],
     {"kernel": (3, 3, 3), "num_filter": 3, "pad": (1, 1, 1),
      "no_bias": True}),
]


@pytest.mark.parametrize("case", CONV, ids=[c[0] for c in CONV])
def test_convolution(case):
    _, inputs, attrs = case
    _check("Convolution", inputs, attrs)


P = U((2, 3, 8, 9), 6)
POOL = [
    ("max stem", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ("max full", {"kernel": (3, 3), "stride": (2, 2),
                  "pooling_convention": "full"}),
    ("max full padded", {"kernel": (2, 3), "stride": (2, 2), "pad": (1, 1),
                         "pooling_convention": "full"}),
    ("max 2x2", {"kernel": (2, 2), "stride": (2, 2)}),
    ("avg include pad", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                         "pool_type": "avg"}),
    ("avg exclude pad", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                         "pool_type": "avg", "count_include_pad": False}),
    ("avg full exclude pad", {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "avg", "count_include_pad": False,
                              "pooling_convention": "full"}),
    ("sum", {"kernel": (2, 2), "stride": (1, 1), "pool_type": "sum"}),
    ("lp", {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
            "p_value": 2}),
    ("global max", {"global_pool": True, "pool_type": "max"}),
    ("global avg", {"global_pool": True, "pool_type": "avg"}),
    ("global sum", {"global_pool": True, "pool_type": "sum"}),
    ("global lp", {"global_pool": True, "pool_type": "lp", "p_value": 2}),
]


@pytest.mark.parametrize("case", POOL, ids=[c[0] for c in POOL])
def test_pooling(case):
    _check("Pooling", [("data", P)], case[1])


@pytest.mark.parametrize("data, attrs", [
    (U((2, 3, 10), 7), {"kernel": (3,), "stride": (2,), "pad": (1,)}),
    (U((1, 2, 5, 6, 4), 7), {"kernel": (2, 2, 2), "stride": (2, 2, 1),
                             "pool_type": "avg"}),
], ids=["max 1d", "avg 3d"])
def test_pooling_1d_3d(data, attrs):
    _check("Pooling", [("data", data)], attrs)


def test_pooling_valid_convention_refuses_an_oversized_kernel():
    x = U((1, 1, 3, 3), 1)
    for nd in (jnd, tnd):
        with pytest.raises(ValueError, match="exceeds padded input"):
            nd.Pooling(nd.array(x), kernel=(5, 5), stride=(1, 1))


@pytest.mark.parametrize("shape, attrs", [
    ((2, 3, 7, 7), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ((1, 2, 4, 4), {"kernel": (2, 2), "stride": (2, 2)}),
    ((1, 1, 5, 6), {"kernel": (3, 3), "stride": (1, 2),
                    "pooling_convention": "full"}),
], ids=["stem", "2x2", "full"])
def test_max_pool_ties_go_to_the_first_max(shape, attrs):
    """All-equal windows (a post-ReLU stem is mostly zeros): each
    window's gradient lands whole on its first position, as in the
    reference, bitwise."""
    x = np.zeros(shape, np.float32)
    grads = []
    for nd, ag in ((jnd, jag), (tnd, tag)):
        a = nd.array(x)
        a.attach_grad()
        with ag.record():
            y = nd.Pooling(a, **attrs)
        y.backward(nd.ones(y.shape))
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    if attrs["kernel"] == (2, 2):
        want = np.zeros(shape, np.float32)
        want[..., ::2, ::2] = 1.0
        np.testing.assert_array_equal(grads[1], want)
    assert grads[1].sum() == np.prod(y.shape)


def test_relu_conventions_at_zero():
    """Activation(relu) has gradient 0 at 0 (the reference's relu mask);
    the elementwise relu splits the tie in half, as jnp.maximum does."""
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    for nd, ag in ((jnd, jag), (tnd, tag)):
        got = {}
        for name, call in (("act", lambda a: nd.Activation(a, act_type="relu")),
                           ("relu", lambda a: nd.relu(a))):
            a = nd.array(x)
            a.attach_grad()
            with ag.record():
                y = call(a)
            y.backward(nd.ones(y.shape))
            got[name] = a.grad.asnumpy()
        np.testing.assert_array_equal(got["act"], [0.0, 0.0, 0.0, 1.0])
        np.testing.assert_array_equal(got["relu"], [0.0, 0.5, 0.5, 1.0])


@pytest.mark.parametrize("data, w, attrs", [
    (U((3, 2, 2, 2), 1), U((5, 8), 2), {"num_hidden": 5}),
    (U((2, 3, 4), 1), U((5, 4), 2), {"num_hidden": 5, "flatten": False}),
], ids=["flatten", "no flatten"])
@pytest.mark.parametrize("bias", [True, False])
def test_fully_connected(data, w, attrs, bias):
    inputs = [("data", data), ("weight", w)]
    if bias:
        inputs.append(("bias", U((5,), 3)))
    else:
        attrs = dict(attrs, no_bias=True)
    _check("FullyConnected", inputs, attrs)


def _bn_inputs(c=4, seed=10, shape=(3, 4, 5, 5)):
    return [("data", U(shape, seed, -2.0, 3.0)),
            ("gamma", U((c,), seed + 1, 0.5, 1.5)),
            ("beta", U((c,), seed + 2)),
            ("moving_mean", U((c,), seed + 3, 0.0, 0.5)),
            ("moving_var", U((c,), seed + 4, 0.5, 2.0))]


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batch_norm_fp32(train, fix_gamma):
    _check("BatchNorm", _bn_inputs(),
           {"fix_gamma": fix_gamma, "eps": 1e-5}, train=train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_batch_norm_three_outputs(train):
    """With output_mean_var the op returns (out, mean, var): the batch
    statistics in training, the moving ones in inference."""
    outs, _ = _check("BatchNorm", _bn_inputs(),
                     {"fix_gamma": False, "output_mean_var": True},
                     train=train)
    assert len(outs) == 3
    x = _bn_inputs()[0][1]
    if train:
        np.testing.assert_allclose(outs[1], x.mean(axis=(0, 2, 3)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(outs[2], x.var(axis=(0, 2, 3)),
                                   rtol=1e-4, atol=1e-6)


def test_batch_norm_last_axis():
    _check("BatchNorm", _bn_inputs(shape=(6, 3, 4)),
           {"fix_gamma": False, "axis": -1})


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_batch_norm_bf16(train):
    """A bf16 stream: the centred value stays bf16, the statistics sum in
    fp32, the output is bf16 (and so are the statistics, as the moving
    stats are)."""
    outs, _ = _check("BatchNorm", _bn_inputs(),
                     {"fix_gamma": False, "output_mean_var": True},
                     train=train, dtype="bfloat16",
                     tol=(BF16_OUT, BF16_OUT, BF16_GRAD))
    with mt.cpu():
        arrs = [tnd.array(v, dtype="bfloat16") for _, v in _bn_inputs()]
        with tag.record(train_mode=train):
            got = tnd.BatchNorm(*arrs, fix_gamma=False, output_mean_var=True)
    assert all(o.dtype == "bfloat16" for o in got)


def test_batch_norm_float64_stays_float64():
    """A float64 stream (a graph function run on float64 tensors, as a
    float64 reference step does; nd arrays are fp32) keeps float64 through the statistics, the scale
    and the bias, held against numpy in float64 at rtol 1e-6. The single
    pass is shifted by a running mean of 0 while the data sit near 1e3,
    so E[x^2] - E[x]^2 cancels ~1e7-fold: float64 keeps ~1e-9 of the
    variance, fp32 would lose all of it."""
    x = 1e3 + np.random.RandomState(11).uniform(0, 1, (3, 4, 5, 5))
    gamma, beta = np.linspace(0.5, 1.5, 4), np.linspace(-1, 1, 4)
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    want = ((x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5)
            * gamma[:, None, None] + beta[:, None, None])
    got = batch_norm(*(torch.from_numpy(v) for v in
                       (x, gamma, beta, np.zeros(4), np.ones(4))),
                     fix_gamma=False, eps=1e-5, is_train=True)
    assert all(o.dtype == torch.float64 for o in got)
    for o, w in zip(got, (want, mean, var)):
        np.testing.assert_allclose(o.numpy(), w, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    _check("Activation", [("data", U((3, 5), 11, -3.0, 3.0))],
           {"act_type": act})


S = U((3, 6), 12, -3.0, 3.0)
SOFTMAX = [
    ("softmax", [("data", S)], {}),
    ("softmax", [("data", U((2, 5, 3), 12))], {"axis": 1}),
    ("softmax", [("data", S)], {"temperature": 2.5}),
    ("softmax", [("data", S), ("length", np.array([2, 6, 4], np.float32))],
     {"use_length": True}),
    ("log_softmax", [("data", S)], {}),
    ("log_softmax", [("data", S)], {"temperature": 0.5, "axis": 0}),
    ("softmin", [("data", S)], {}),
    ("SoftmaxActivation", [("data", U((2, 3, 2, 2), 13))], {}),
    ("SoftmaxActivation", [("data", U((2, 3, 2, 2), 13))],
     {"mode": "channel"}),
    ("softmax_cross_entropy", [("data", S), ("label", labels(3, 6, 14))], {}),
]


@pytest.mark.parametrize("case", SOFTMAX,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(SOFTMAX)])
def test_softmax_family(case):
    name, inputs, attrs = case
    _check(name, inputs, attrs)


SOFTMAX_OUTPUT = [
    ([("data", S), ("label", labels(3, 6, 15))], {}),
    ([("data", S), ("label", np.array([1, -1, 4], np.float32))],
     {"use_ignore": True, "ignore_label": -1, "normalization": "valid"}),
    ([("data", S), ("label", labels(3, 6, 15))],
     {"normalization": "batch", "grad_scale": 2.0, "smooth_alpha": 0.1}),
    ([("data", U((2, 4, 3, 3), 16)), ("label", np.random.RandomState(17)
                                      .randint(0, 4, (2, 3, 3))
                                      .astype(np.float32))],
     {"multi_output": True}),
]


@pytest.mark.parametrize("inputs, attrs", SOFTMAX_OUTPUT,
                         ids=["plain", "ignore", "smooth", "multi"])
@pytest.mark.parametrize("name", ["SoftmaxOutput", "Softmax"])
def test_softmax_output(name, inputs, attrs):
    """The gradient is (p - onehot) scaled, and ignores the head
    gradient: ones and a random head give the same data gradient."""
    _, grads = _check(name, inputs, attrs)
    arrs = [tnd.array(v) for _, v in inputs]
    arrs[0].attach_grad()
    with tag.record():
        y = getattr(tnd, name)(*arrs, **attrs)
    y.backward(tnd.ones(y.shape))
    np.testing.assert_array_equal(arrs[0].grad.asnumpy(), grads[0])
    if not attrs:
        p = y.asnumpy()
        onehot = np.eye(6, dtype=np.float32)[inputs[1][1].astype(int)]
        np.testing.assert_allclose(grads[0], p - onehot, rtol=1e-6,
                                   atol=1e-7)


def test_dropout_by_its_properties():
    """Kept values are x / (1 - p), the rest 0, the share kept near
    1 - p; the gradient is the same mask over (1 - p); a mask shared
    along ``axes``; the identity outside training."""
    x = U((64, 128), 18, 0.5, 1.5)
    p = 0.3
    a = tnd.array(x)
    a.attach_grad()
    with tag.record():
        y = tnd.Dropout(a, p=p)
    y.backward(tnd.ones(y.shape))
    out, grad = y.asnumpy(), a.grad.asnumpy()
    kept = out != 0
    np.testing.assert_allclose(out[kept], x[kept] / (1 - p), rtol=1e-6)
    np.testing.assert_allclose(grad, kept / (1 - p), rtol=1e-6)
    assert abs(kept.mean() - (1 - p)) < 0.02
    with tag.record():
        shared = tnd.Dropout(tnd.array(x), p=p, axes=(1,)).asnumpy()
    rows = shared != 0
    assert (rows.all(axis=1) | (~rows).all(axis=1)).all()
    for nd in (tnd, jnd):
        with (tag if nd is tnd else jag).record(train_mode=False):
            same = nd.Dropout(nd.array(x), p=p)
        np.testing.assert_array_equal(same.asnumpy(), x)
        np.testing.assert_array_equal(nd.Dropout(nd.array(x), p=p)
                                      .asnumpy(), x)
    with tag.record():
        first = tnd.Dropout(tnd.array(x), p=p).asnumpy()
        second = tnd.Dropout(tnd.array(x), p=p).asnumpy()
    assert (first != second).any()


def test_nn_ops_infer_shape_on_meta_tensors():
    """Each op of the subset runs on meta tensors (shape inference)."""
    import torch
    f32 = torch.float32
    assert mt.ops.infer_shape("Convolution", ((2, 4, 7, 7), f32),
                              ((6, 2, 3, 3), f32), kernel=(3, 3),
                              num_filter=6, num_group=2, stride=(2, 2),
                              no_bias=True) == [((2, 6, 3, 3), f32)]
    assert mt.ops.infer_shape("Pooling", ((2, 3, 8, 9), f32),
                              kernel=(3, 3), stride=(2, 2),
                              pool_type="avg", count_include_pad=False,
                              pooling_convention="full") == \
        [((2, 3, 4, 4), f32)]
    bf = torch.bfloat16
    assert [s for s, _ in mt.ops.infer_shape(
        "BatchNorm", ((2, 4, 3, 3), bf), ((4,), f32), ((4,), f32),
        ((4,), bf), ((4,), bf), is_train=True)] == \
        [(2, 4, 3, 3), (4,), (4,)]
