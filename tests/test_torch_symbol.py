"""The port's Symbol and Executor (``mxnet_tpu_torch.symbol``,
``executor``) against the JAX package's: composition, the argument and
auxiliary-state lists, shape and type inference, JSON written by one
package and loaded by the other (same outputs on the same parameters),
and ``simple_bind`` forward and backward. Parameters and inputs are
seeded numpy arrays given to both; values agree at fp32 rtol 1e-5 with
an atol of 1e-5 times the reference's largest magnitude."""

import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = (2, 3, 8, 8)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _net(S):
    data = S.var("data")
    x = S.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      name="conv0")
    x = S.BatchNorm(x, fix_gamma=False, name="bn0")
    x = S.Activation(x, act_type="relu", name="relu0")
    x = S.Pooling(x, kernel=(2, 2), stride=(2, 2), name="pool0")
    x = S.FullyConnected(x, num_hidden=5, name="fc0")
    return S.SoftmaxOutput(x, name="softmax")


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _values(symbol, seed=0):
    """Seeded arguments (labels as class indices) and aux states, by
    name, as numpy arrays, at DATA's shapes."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=DATA)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name.endswith("label"):
            args[name] = rs.randint(0, 5, shape).astype(np.float32)
        else:
            args[name] = rs.uniform(-1, 1, shape).astype(np.float32)
    aux = {n: rs.uniform(0.5, 1.5, s).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def test_composition_lists_and_inference_match_jax():
    j, t = _net(jsym), _net(tsym)
    assert t.list_arguments() == j.list_arguments() == [
        "data", "conv0_weight", "conv0_bias", "bn0_gamma", "bn0_beta",
        "fc0_weight", "fc0_bias", "softmax_label"]
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == [
        "bn0_moving_mean", "bn0_moving_var"]
    assert t.list_outputs() == j.list_outputs()
    assert t.list_inputs() == j.list_inputs()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.infer_shape(data=DATA) == j.infer_shape(data=DATA)
    for dt in ("float32", "bfloat16"):
        # bf16 data meets fp32 weights: the conv cannot run, and both
        # packages leave its output's type unknown
        jt, tt = j.infer_type(data=dt), t.infer_type(data=dt)
        for jl, tl in zip(jt, tt):
            assert [x and dtype_name(x) for x in tl] == \
                [x and np.dtype(x).name for x in jl]
    # partial inference leaves what it cannot know unknown, as JAX does
    assert t.infer_shape_partial() == j.infer_shape_partial()


def test_group_and_outputs_match_jax():
    def grouped(S):
        a = S.var("a")
        return S.Group([S.Activation(a, act_type="tanh", name="t"),
                        S.softmax(a, name="s")])
    assert grouped(tsym).list_outputs() == grouped(jsym).list_outputs()
    assert grouped(tsym).infer_shape(a=(2, 3)) == \
        grouped(jsym).infer_shape(a=(2, 3))


def _forward(mx_mod, symbol, args, aux, ctx):
    nd = mx_mod.nd
    ex = symbol.bind(ctx, {k: nd.array(v) for k, v in args.items()},
                     aux_states={k: nd.array(v) for k, v in aux.items()})
    return [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_json_crosses_between_the_packages(direction):
    src, dst = (jsym, tsym) if direction == "jax to port" else (tsym, jsym)
    text = _net(src).tojson()
    loaded = dst.load_json(text)
    assert loaded.list_arguments() == _net(src).list_arguments()
    assert loaded.list_auxiliary_states() == \
        _net(src).list_auxiliary_states()
    assert json.loads(loaded.tojson())["nodes"] == json.loads(text)["nodes"]
    args, aux = _values(_net(jsym))
    j = _forward(jmx, jsym.load_json(text), args, aux, jmx.cpu())
    t = _forward(mt, tsym.load_json(text), args, aux, mt.cpu())
    for a, b in zip(t, j):
        _close(a, b)


def test_save_and_load_file(tmp_path):
    path = str(tmp_path / "net-symbol.json")
    _net(tsym).save(path)
    assert jsym.load(path).list_arguments() == _net(tsym).list_arguments()
    assert tsym.load(path).tojson() == _net(tsym).tojson()


def test_resnet_graph_traces_as_in_jax():
    """The model zoo's ResNet-18 (thumbnail) traces into the same graph
    in both packages, node for node: the JSON text is identical."""
    x = (1, 3, 32, 32)
    j = jvision.resnet18_v1(thumbnail=True, classes=10, prefix="r18_")
    t = tvision.resnet18_v1(thumbnail=True, classes=10, prefix="r18_")
    jtext = j._get_graph(jmx.nd.zeros(x))[1].tojson()
    ttext = t._get_graph(mt.nd.zeros(x))[1].tojson()
    assert ttext == jtext


def _bind(mx_mod, S, args, aux, ctx):
    nd = mx_mod.nd
    ex = _net(S).simple_bind(ctx, data=DATA, softmax_label=DATA[:1])
    for k, v in args.items():
        ex.arg_dict[k][:] = v
    for k, v in aux.items():
        ex.aux_dict[k][:] = v
    outs = ex.forward(is_train=True)
    ex.backward()
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()},
            {k: a.asnumpy() for k, a in ex.aux_dict.items()})


def test_simple_bind_forward_backward_match_jax():
    args, aux = _values(_net(jsym), seed=3)
    jo, jg, ja = _bind(jmx, jsym, args, aux, jmx.cpu())
    to, tg, ta = _bind(mt, tsym, args, aux, mt.cpu())
    for a, b in zip(to, jo):
        _close(a, b)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k])
    for k in ja:
        _close(ta[k], ja[k])
        assert not np.allclose(ta[k], aux[k])      # folded in training


def test_executor_backward_takes_head_gradients_and_repeats():
    args, aux = _values(_net(tsym), seed=4)
    ex = tsym.Activation(tsym.var("data"), act_type="tanh").simple_bind(
        mt.cpu(), data=DATA)
    ex.arg_dict["data"][:] = args["data"]
    with pytest.raises(mt.MXNetError, match="before forward"):
        ex.backward()
    out = ex.forward(is_train=True)[0].asnumpy()
    head = np.full(DATA, 2.0, np.float32)
    ex.backward(mt.nd.array(head))
    first = ex.grad_dict["data"].asnumpy()
    np.testing.assert_allclose(first, 2.0 * (1 - out ** 2), rtol=1e-6)
    ex.backward(mt.nd.array(head))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), first)


def test_refusals_name_their_item():
    with pytest.raises(mt.MXNetError, match="A9"):
        tsym.MultiBoxPrior(tsym.var("x"))
    with pytest.raises(mt.MXNetError, match="A9"):
        tsym.linalg_gemm2(tsym.var("x"), tsym.var("x"))
    # sym.random is ported (A9's second item)
    assert tsym.random.uniform(shape=(2,)).list_outputs()
    with pytest.raises(mt.MXNetError, match="HybridBlock"):
        mt.autograd.get_symbol(mt.nd.zeros((2,)))
