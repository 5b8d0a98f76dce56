"""The port's Gluon (``mxnet_tpu_torch.gluon``: Parameter, Block,
HybridBlock, SymbolBlock, the nn layers, the initializers) against the
JAX package's: deferred initialization, the initializers' routing by
name and their scales, the hybridized route against the imperative one,
``cast("bfloat16")``, parameters saved by one package and loaded by the
other, BatchNorm running statistics after a recorded step in each
route, export/import, and the refusals of what is not ported yet.

Parameters cross by ``save_parameters``/``load_parameters`` (structural
names), never drawn twice. Tolerances: fp32 at rtol 1e-5 with an atol of
1e-5 times the reference's largest magnitude; the bf16 forward at rtol
and atol 2^-5 of the largest magnitude (bf16 rounding of each layer's
output, in an order that differs between the packages)."""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

X = np.random.RandomState(0).uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want, scale=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=scale,
                               atol=scale * max(1.0, np.abs(want).max()))


def _small(gluon):
    nn = gluon.nn
    net = nn.HybridSequential(prefix="small_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2, 2, 1),
                nn.Conv2D(6, 3, strides=2, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(5))
    return net


def _port_and_jax(tmp_path, init=None):
    """The small net in both packages with the port's initialization,
    carried to JAX by save_parameters/load_parameters."""
    t = _small(tgluon)
    t.initialize(init or tinit.Xavier())
    t(mt.nd.array(X))
    path = str(tmp_path / "small.params")
    t.save_parameters(path)
    j = _small(jgluon)
    j.load_parameters(path)
    return t, j


def _step(mx_mod, ag, net, x):
    """One recorded forward + backward of sum(output): (output, grads by
    structural name, params by structural name after the step)."""
    with ag.record():
        y = net(mx_mod.nd.array(x))
    y.backward(mx_mod.nd.ones(y.shape))
    params = net._collect_params_with_prefix()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    values = {k: p.data().asnumpy() for k, p in params.items()}
    return y.asnumpy(), grads, values


def test_deferred_initialization():
    net = tgluon.nn.Dense(5, in_units=0)
    net.initialize()
    assert net.weight.shape == (5, 0)
    with pytest.raises(tgluon.parameter.DeferredInitializationError):
        net.weight.data()
    net(mt.nd.ones((2, 7)))
    assert net.weight.data().shape == (5, 7)
    t = _small(tgluon)
    t.initialize()
    t(mt.nd.array(X))
    j = _small(jgluon)
    j.initialize()
    j(jmx.nd.array(X))
    assert {k: p.shape for k, p in t.collect_params().items()} == \
        {k: p.shape for k, p in j.collect_params().items()}


def test_initializers_route_by_name():
    """gamma and running_var to 1, beta, running_mean and biases to 0,
    weights by the initializer, as in the JAX package."""
    t = _small(tgluon)
    t.initialize(tinit.Xavier())
    t(mt.nd.array(X))
    j = _small(jgluon)
    j.initialize(jmx.init.Xavier())
    j(jmx.nd.array(X))
    jp = j.collect_params()
    for name, p in t.collect_params().items():
        v = p.data().asnumpy()
        if name.endswith(("gamma", "running_var")):
            np.testing.assert_array_equal(v, 1.0)
        elif name.endswith(("beta", "running_mean", "bias")):
            np.testing.assert_array_equal(v, 0.0)
        else:
            assert name.endswith("weight") and np.abs(v).max() > 0
        if not name.endswith("weight"):
            np.testing.assert_array_equal(v, jp[name].data().asnumpy())


@pytest.mark.parametrize("make, dist", [
    (lambda: tinit.Xavier(), "uniform"),
    (lambda: tinit.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2), "gaussian"),
    (lambda: tinit.MSRAPrelu(slope=0.25), "gaussian"),
    (lambda: tinit.MSRAPrelu(factor_type="out", slope=0.0), "gaussian"),
], ids=["xavier", "xavier gaussian in", "msra", "msra out"])
def test_initializer_scales_by_fan(make, dist):
    """Xavier and MSRAPrelu scales: sqrt(magnitude / factor), with
    factor the fan-in, fan-out or their mean of a (64, 32, 3, 3) conv
    weight; uniform draws fill [-scale, scale], gaussian ones have
    standard deviation scale."""
    init = make()
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
              "out": fan_out}[init.factor_type]
    scale = np.sqrt(init.magnitude / factor)
    if isinstance(init, tinit.MSRAPrelu):
        slope = init._kwargs["slope"]
        assert init.magnitude == pytest.approx(2.0 / (1 + slope ** 2))
    arr = mt.nd.zeros(shape)
    init(tinit.InitDesc("conv_weight"), arr)
    v = arr.asnumpy()
    if dist == "uniform":
        assert np.abs(v).max() <= scale
        assert np.abs(v).max() > 0.99 * scale
        assert abs(v.std() - scale / np.sqrt(3)) < 0.03 * scale
    else:
        assert abs(v.std() - scale) < 0.03 * scale
    assert abs(v.mean()) < 0.02 * scale


def test_initializer_attr_and_constant():
    p = tgluon.Parameter("w", shape=(2, 3), init=tinit.Constant(2.5))
    p.initialize(init=None, default_init=tinit.Xavier())
    np.testing.assert_array_equal(p.data().asnumpy(), 2.5)
    arr = mt.nd.zeros((3,))
    tinit.Xavier()(tinit.InitDesc("x_moving_var", {"__init__": "ones"}), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 1.0)
    # FusedRNN (ported with the recurrent nets): weights in U(-0.07, 0.07),
    # biases zero but for the LSTM forget gate
    packed = mt.nd.zeros((4 * 4 * (3 + 4 + 2),))
    fused = tinit.FusedRNN(None, 4, 1, "lstm", forget_bias=1.5)
    tinit.Xavier()(tinit.InitDesc("lstm_parameters",
                                  {"__init__": fused.dumps()}), packed)
    w, b = packed.asnumpy()[:-32], packed.asnumpy()[-32:]
    assert np.abs(w).max() <= 0.07 and np.abs(w).max() > 0.05
    np.testing.assert_array_equal(b, np.tile(np.repeat([0, 1.5, 0, 0], 4), 2))


def test_hybridized_matches_imperative(tmp_path):
    """The CachedOp route and the nd route run the same torch ops: the
    outputs, gradients and BatchNorm running statistics after one
    recorded step agree (here bitwise), and agree with the JAX
    package's after the same step in each of its routes."""
    t, j = _port_and_jax(tmp_path)
    path = str(tmp_path / "small.params")
    routes = {}
    for hybrid in (False, True):
        t.load_parameters(path)
        t.hybridize(hybrid)
        routes[hybrid] = _step(mt, tag, t, X)
    for a, b in zip(routes[False][:1], routes[True][:1]):
        np.testing.assert_array_equal(a, b)
    for part in (1, 2):
        for k in routes[False][part]:
            np.testing.assert_array_equal(routes[False][part][k],
                                          routes[True][part][k])
    for hybrid in (False, True):
        j.load_parameters(path)
        j.hybridize(hybrid)
        jy, jg, jv = _step(jmx, jag, j, X)
        ty, tg, tv = routes[hybrid]
        _close(ty, jy)
        for k in jg:
            _close(tg[k], jg[k])
        for k in jv:
            _close(tv[k], jv[k])
    means = [k for k in tv if k.endswith("running_mean")]
    assert means and all(np.abs(tv[k]).max() > 0 for k in means)


def test_cast_bfloat16(tmp_path):
    """cast("bfloat16") narrows every parameter but BatchNorm's, which
    stay fp32 as in the reference; the forward runs in bf16 and agrees
    with the JAX package's cast net."""
    t, j = _port_and_jax(tmp_path)
    t.cast("bfloat16")
    j.cast("bfloat16")
    for name, p in t.collect_params().items():
        want = "float32" if "batchnorm" in name else "bfloat16"
        assert p.dtype == want
        assert p.data().dtype == want
    ty = t(mt.nd.array(X, dtype="bfloat16"))
    jy = j(jmx.nd.array(X, dtype="bfloat16"))
    assert ty.dtype == "bfloat16"
    _close(ty.asnumpy(), jy.asnumpy(), scale=2.0 ** -5)


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_parameters_cross_between_the_packages(tmp_path, direction):
    t = _small(tgluon)
    j = _small(jgluon)
    path = str(tmp_path / "p.params")
    if direction == "port to jax":
        t.initialize(tinit.Xavier())
        t(mt.nd.array(X))
        t.save_parameters(path)
        j.load_parameters(path)
    else:
        j.initialize(jmx.init.Xavier())
        j(jmx.nd.array(X))
        j.save_parameters(path)
        t.load_parameters(path)
    for k, p in t._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            j._collect_params_with_prefix()[k].data().asnumpy())
    with tag.predict_mode():
        ty = t(mt.nd.array(X)).asnumpy()
    _close(ty, j(jmx.nd.array(X)).asnumpy())


def test_symbol_block_imports_a_jax_export(tmp_path):
    t, j = _port_and_jax(tmp_path)
    j.hybridize()
    want = j(jmx.nd.array(X)).asnumpy()
    prefix = str(tmp_path / "exported")
    j.export(prefix)
    block = tgluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params")
    _close(block(mt.nd.array(X)).asnumpy(), want)


def test_model_zoo_and_refusals():
    net = tvision.get_model("resnet18_v1", classes=7)
    assert isinstance(net, tvision.ResNetV1)
    with pytest.raises(mt.MXNetError, match="A9"):
        tvision.get_model("vgg16")
    with pytest.raises(ValueError, match="pretrained"):
        tvision.resnet18_v1(pretrained=True)
    # gluon.rnn and gluon.contrib.rnn resolve (A9's recurrent nets are
    # ported); gluon.contrib's other submodules name A9
    assert tgluon.rnn.LSTM and tgluon.contrib.rnn.VariationalDropoutCell
    for name, item in (("estimator", "A9"), ("nn", "A9"), ("data", "A9"),
                       ("cnn", "A9")):
        with pytest.raises(mt.MXNetError, match=item):
            getattr(tgluon.contrib, name)
    # gluon.data resolves (A8 is ported)
    assert tgluon.data.DataLoader and tgluon.data.vision.transforms.ToTensor
    assert tgluon.Trainer is tgluon.trainer.Trainer
    assert tgluon.loss.L2Loss and tgluon.utils.split_data
    # the layers over the ops of ROADMAP A6 run now
    x = mt.nd.ones((2, 3, 4, 4))
    for layer, shape in ((tgluon.nn.LayerNorm(), (2, 3, 4, 4)),
                         (tgluon.nn.InstanceNorm(), (2, 3, 4, 4)),
                         (tgluon.nn.Conv2DTranspose(2, 3), (2, 2, 6, 6)),
                         (tgluon.nn.LeakyReLU(0.1), (2, 3, 4, 4))):
        layer.initialize()
        assert layer(x).shape == shape
    with pytest.raises(mt.MXNetError, match="A9"):
        tgluon.nn.Embedding(4, 3, sparse_grad=True)
