"""The port's Module front end (``mxnet_tpu_torch.module``, ``model``,
``callback``, ``executor_manager``, ``symbols.resnet`` and
``entry.module_fit``) against the JAX package's on the CPU: the same
code runs through both packages on seeded numpy data and parameters.

Covered: ``Module`` bind, init_params/set_params, fit, score, predict
(an iterator and a bare array), iter_predict, save/load of checkpoints
and optimizer states, reshape, the input-name checks, and the context
arguments that refused before they were ported (``group2ctxs``, a
context list with a ``work_load_list``, the executor's ``group2ctx``;
their parity with JAX is tests/test_torch_group2ctx.py's); all four routes of ``update`` (the store's
``pushpull_fused`` or its per-key push/pull, with the optimizer in the
store or local; and no store), bitwise equal among themselves;
``BucketingModule`` (switching buckets, checkpoint, ``load_dict``),
``SequentialModule``, ``PythonModule`` and ``PythonLossModule``;
``model.save_checkpoint``/``load_checkpoint``/``load_params`` and
``FeedForward``; the callbacks; ``executor_manager``; and the port's
copy of the example's ResNet symbol (argument names and inferred
shapes). ``entry.module_fit`` against JAX's ``Module.fit`` is
``tests/test_torch_module_fit.py``'s.

Tolerances (fp32): an MLP's parameters after fitting within rtol 1e-5,
atol 1e-6 of JAX's (a dense net's fp32 arithmetic in another order);
outputs and scores likewise; the four update routes bitwise one
another; checkpoints bitwise."""

import importlib.util
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.symbols import resnet as tresnet
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _example_resnet():
    spec = importlib.util.spec_from_file_location(
        "example_resnet_symbols", os.path.join(
            ROOT, "examples", "image_classification", "symbols",
            "resnet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp(mx, hidden=16, classes=4):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, num_hidden=hidden, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _data(n=32, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _mlp_params(dim=8, hidden=16, classes=4, seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(hidden, dim) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(hidden) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(classes, hidden) * 0.3)
            .astype(np.float32),
            "fc2_bias": (rng.randn(classes) * 0.1).astype(np.float32)}


def _nds(mx, params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _arrays(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _close(t, j, **tol):
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **(tol or TOL))


def _fit_mlp(mx, kvstore="device", epochs=2, seed=1):
    x, y = _data()
    np.random.seed(seed)
    it = mx.io.NDArrayIter(x, y, batch_size=8, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.fit(it, num_epoch=epochs, kvstore=kvstore, optimizer="sgd",
            optimizer_params=dict(OPT), eval_metric="acc",
            arg_params=_nds(mx, _mlp_params()))
    return mod, it


def test_fit_score_predict_match_jax():
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        mod, it = _fit_mlp(mx)
        arg, aux = mod.get_params()
        score = dict(mod.score(it, ["acc", "ce"]))
        pred = mod.predict(it).asnumpy()
        one = mod.predict(mx.nd.array(_data(8, seed=3)[0])).asnumpy()
        parts = [(o[0].asnumpy(), n, b.pad)
                 for o, n, b in mod.iter_predict(it, num_batch=2)]
        got[key] = (_arrays(arg), score, pred, one, parts,
                    mod.output_shapes, mod.data_shapes, mod.label_shapes)
    t, j = got["port"], got["jax"]
    _close(t[0], j[0])
    assert t[1]["accuracy"] == j[1]["accuracy"]
    np.testing.assert_allclose(t[1]["cross-entropy"], j[1]["cross-entropy"],
                               **TOL)
    np.testing.assert_allclose(t[2], j[2], **TOL)
    np.testing.assert_allclose(t[3], j[3], **TOL)
    assert [(p[1], p[2]) for p in t[4]] == [(p[1], p[2]) for p in j[4]]
    assert t[5:] == j[5:]


def _route_run(route):
    """Two epochs of the MLP through one of update()'s routes: the
    store's fused path or its per-key path, with the optimizer on the
    store or local (the route ``local`` with a store takes when a
    parameter exceeds 16M elements), or no store."""
    x, y = _data()
    np.random.seed(1)
    it = mt.io.NDArrayIter(x, y, batch_size=8, shuffle=True,
                           label_name="softmax_label")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_nds(mt, _mlp_params()))
    kv = None
    if route != "none":
        kv = mt.kvstore.create("dist_sync", fusion=route.startswith("fused"))
    mod.init_optimizer(kvstore=None if route.endswith("local") else kv,
                       optimizer="sgd", optimizer_params=dict(OPT))
    if route.endswith("local"):
        # what init_optimizer does when _create_kvstore keeps the update
        # local beside a store: the store holds the parameters only
        mod._kvstore = kv
        for i, name in enumerate(mod._param_names):
            kv.init(i, mod._arg_params[name])
    for _ in range(2):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    stats = dict(kv.dispatch_stats) if kv is not None else None
    return _arrays(mod.get_params()[0]), stats


@pytest.mark.parametrize("route", ["fused_store", "perkey_store",
                                   "fused_local", "perkey_local"])
def test_update_routes_are_bitwise_the_storeless_one(route):
    want, _ = _route_run("none")
    got, stats = _route_run(route)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    steps, keys = 8, 4
    if route.startswith("fused"):
        assert stats["keys"] == steps * keys and stats["buckets"] == steps
    else:
        assert stats == {"collectives": steps * keys, "keys": steps * keys,
                         "buckets": 0, "shard_updates": 0}


@pytest.mark.parametrize("kvstore", ["device", "local", "dist_sync", None])
def test_fit_through_each_store_matches_jax(kvstore):
    """One context: 'device' and 'local' make no store, 'dist_sync' the
    dist store with update_on_kvstore, as JAX's _create_kvstore decides;
    each fit is JAX's."""
    t, _ = _fit_mlp(mt, kvstore)
    j, _ = _fit_mlp(jmx, kvstore)
    assert (t._kvstore is None) == (j._kvstore is None)
    assert t._update_on_kvstore == j._update_on_kvstore
    _close(_arrays(t.get_params()[0]), _arrays(j.get_params()[0]))


def test_checkpoint_and_optimizer_states_round_trip(tmp_path):
    """save_checkpoint with the optimizer states; Module.load (and the
    JAX package's Module.load of the port's files) gives the parameters
    bitwise, and a module resumed from the states continues as the one
    that saved them."""
    mod, it = _fit_mlp(mt, "dist_sync", epochs=1)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    for f in ("-symbol.json", "-0003.params", "-0003.states"):
        assert os.path.exists(prefix + f)
    arg = _arrays(mod.get_params()[0])
    for mx in (mt, jmx):
        back = mx.mod.Module.load(prefix, 3, load_optimizer_states=True)
        back.bind(it.provide_data, it.provide_label)
        for k, v in _arrays(back.get_params()[0]).items():
            np.testing.assert_array_equal(v, arg[k])
        if mx is mt:
            back.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                                optimizer_params=dict(OPT))
            it.reset()
            batch = next(iter(it))
            for m in (mod, back):
                m.forward_backward(batch)
                m.update()
            a, b = _arrays(mod.get_params()[0]), \
                _arrays(back.get_params()[0])
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    local = str(tmp_path / "local.states")
    m2, _ = _fit_mlp(mt, None, epochs=1)
    m2.save_optimizer_states(local)
    m2.load_optimizer_states(local)


def test_set_params_reshape_and_forward_outputs():
    x, y = _data(8)
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.bind([("data", (8, 8))], [("softmax_label", (8,))],
                 for_training=False)
        mod.set_params(_nds(mx, _mlp_params()), {})
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
        first = mod.get_outputs()[0].asnumpy()
        mod.reshape([("data", (4, 8))], [("softmax_label", (4,))])
        mod.forward(mx.io.DataBatch([mx.nd.array(x[:4])],
                                    [mx.nd.array(y[:4])]))
        got[key] = (first, mod.get_outputs()[0].asnumpy(),
                    mod.output_shapes)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], **TOL)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **TOL)
    assert got["port"][2] == got["jax"][2] == [("softmax_output", (4, 4))]


def test_input_name_checks_and_refusals():
    """The input-name checks raise; the context arguments that refused
    before they were ported now run, each the same as JAX's Module: a
    ``group2ctxs`` placement and a two-context module with a
    ``work_load_list`` give JAX's forward outputs (TOL), and an executor
    with a ``group2ctx`` the unplaced one's (bitwise)."""
    sym = _mlp(mt)
    with pytest.raises(ValueError, match="data_names"):
        mt.mod.Module(sym, data_names=("image",))
    mt.mod.Module(sym, label_names=("no_such_label",))   # warns only
    mod = mt.mod.Module(sym)
    with pytest.raises(mt.MXNetError, match="bind"):
        mod.get_params()
    x, y = _data()
    params = _mlp_params()
    want = None
    for kw in (dict(group2ctxs={"dev1": "cpu1"}),
               dict(context=["cpu0", "cpu1"], work_load_list=[1, 1])):
        outs = []
        for mx in (mt, jmx):
            ctxs = {"cpu0": mx.cpu(), "cpu1": mx.Context("cpu", 1)}
            args = {k: ({g: ctxs[c] for g, c in v.items()}
                        if isinstance(v, dict) else
                        [ctxs.get(c, c) for c in v]
                        if k == "context" else v) for k, v in kw.items()}
            m = mx.mod.Module(_mlp(mx), **args)
            m.bind([("data", (4, 8))], [("softmax_label", (4,))])
            m.init_params(arg_params=_nds(mx, params))
            m.forward(mx.io.DataBatch([mx.nd.array(x[:4])],
                                      [mx.nd.array(y[:4])]))
            outs.append(m.get_outputs()[0].asnumpy())
        np.testing.assert_allclose(outs[0], outs[1], **TOL)
        want = outs[1] if want is None else want
        np.testing.assert_allclose(outs[0], want, **TOL)
    args = {k: mt.nd.array(v) for k, v in params.items()}
    args.update(data=mt.nd.array(x[:4]), softmax_label=mt.nd.array(y[:4]))
    plain = mt.executor.Executor(sym, mt.cpu(), args).forward()[0]
    placed = mt.executor.Executor(sym, mt.cpu(), args,
                                  group2ctx={"a": mt.cpu()}).forward()[0]
    np.testing.assert_array_equal(placed.asnumpy(), plain.asnumpy())


def _bucket_sym_gen(mx):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        pooled = mx.sym.sum(data, axis=1, keepdims=True)
        fc = mx.sym.FullyConnected(pooled, name="bfc", num_hidden=4)
        return mx.sym.SoftmaxOutput(fc, name="softmax"), ["data"], \
            ["softmax_label"]
    return sym_gen


def test_bucketing_module_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    batches = [(key, rng.randn(4, key).astype(np.float32),
                rng.randint(0, 4, 4).astype(np.float32))
               for key in (8, 4, 8, 6)]
    w = {"bfc_weight": rng.randn(4, 1).astype(np.float32),
         "bfc_bias": np.zeros(4, np.float32)}
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        mod = mx.mod.BucketingModule(_bucket_sym_gen(mx),
                                     default_bucket_key=8)
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params=_nds(mx, w))
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        outs = []
        for bkey, x, y in batches:
            batch = mx.io.DataBatch(
                data=[mx.nd.array(x)], label=[mx.nd.array(y)],
                bucket_key=bkey, provide_data=[("data", (4, bkey))],
                provide_label=[("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        prefix = str(tmp_path / key)
        mod.save_checkpoint(prefix, 2)
        back = mx.mod.BucketingModule.load(prefix, 2,
                                           sym_gen=_bucket_sym_gen(mx),
                                           default_bucket_key=8)
        back.bind(data_shapes=[("data", (4, 8))],
                  label_shapes=[("softmax_label", (4,))])
        arg = _arrays(mod.get_params()[0])
        for k, v in _arrays(back.get_params()[0]).items():
            np.testing.assert_array_equal(v, arg[k])
        loaded = mx.mod.BucketingModule.load_dict(
            sym_gen=_bucket_sym_gen(mx), default_bucket_key=8,
            arg_params=_nds(mx, w))
        loaded.bind(data_shapes=[("data", (4, 8))],
                    label_shapes=[("softmax_label", (4,))])
        got[key] = (outs, arg, _arrays(loaded.get_params()[0]),
                    sorted(os.listdir(tmp_path)))
    for a, b in zip(got["port"][0], got["jax"][0]):
        np.testing.assert_allclose(a, b, **TOL)
    _close(got["port"][1], got["jax"][1])
    _close(got["port"][2], w)
    assert {"port.buckets", "port-0002.params", "port-4-symbol.json",
            "port-6-symbol.json", "port-8-symbol.json"} <= \
        set(got["jax"][3])


def _sequential(mx, python_loss):
    net1 = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Variable("data"), name="fc1", num_hidden=8),
        act_type="relu", name="relu1")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net1, label_names=[], context=mx.cpu()))
    if python_loss:
        scores = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc2",
                                       num_hidden=4)
        seq.add(mx.mod.Module(scores, label_names=None, context=mx.cpu()),
                auto_wiring=True)
        seq.add(mx.mod.PythonLossModule(), take_labels=True,
                auto_wiring=True)
    else:
        net2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("relu1_output"), name="fc2", num_hidden=4),
            name="softmax")
        seq.add(mx.mod.Module(net2, data_names=["relu1_output"],
                              context=mx.cpu()),
                take_labels=True, auto_wiring=True)
    return seq


@pytest.mark.parametrize("python_loss", [False, True])
def test_sequential_and_python_loss_modules_match_jax(python_loss):
    x, y = _data(16)
    params = {k: v for k, v in _mlp_params(hidden=8).items()}
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        seq = _sequential(mx, python_loss)
        it = mx.io.NDArrayIter(x, y, batch_size=8,
                               label_name="softmax_label")
        seq.bind(it.provide_data, it.provide_label)
        seq.init_params(arg_params=_nds(mx, params), allow_missing=False)
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.5),))
        for _ in range(2):
            it.reset()
            for batch in it:
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
        it.reset()
        seq.forward(next(iter(it)), is_train=False)
        got[key] = (_arrays(seq.get_params()[0]),
                    seq.get_outputs()[0].asnumpy(), seq.output_shapes,
                    seq.data_names, seq.output_names)
    _close(got["port"][0], got["jax"][0])
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **TOL)
    assert [tuple(s) for s in got["port"][2]] == \
        [tuple(s) for s in got["jax"][2]]
    assert got["port"][3:] == got["jax"][3:]


def test_python_loss_module_grad_func():
    calls = []

    def grad_func(scores, labels):
        calls.append(scores.shape)
        return np.full(scores.shape, 0.5, np.float32)

    m = mt.mod.PythonLossModule(grad_func=grad_func)
    m.bind(data_shapes=[("data", (2, 3))],
           label_shapes=[("softmax_label", (2,))])
    m.forward(mt.io.DataBatch([mt.nd.ones((2, 3))], [mt.nd.zeros((2,))]),
              is_train=True)
    m.backward()
    assert calls == [(2, 3)]
    np.testing.assert_array_equal(m.get_input_grads()[0].asnumpy(), 0.5)
    assert m.output_shapes[0].shape == (2, 3)
    assert m.get_params() == ({}, {})


def test_model_checkpoints_and_feedforward_match_jax(tmp_path):
    x, y = _data(32)
    params = _mlp_params()
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        prefix = str(tmp_path / key)
        mx.model.save_checkpoint(prefix, 7, _mlp(mx), _nds(mx, params),
                                 {})
        sym, arg, aux = mx.model.load_checkpoint(prefix, 7)
        arg2, _ = mx.model.load_params(prefix, 7)
        assert sym.list_arguments() == _mlp(mx).list_arguments()
        np.random.seed(2)
        ff = mx.model.FeedForward(sym, ctx=mx.cpu(), num_epoch=2,
                                  numpy_batch_size=8, arg_params=arg,
                                  aux_params=aux, learning_rate=0.1)
        ff.fit(x, y)
        pred = ff.predict(x)
        ff.save(str(tmp_path / (key + "_ff")))
        ff2 = mx.model.FeedForward.load(str(tmp_path / (key + "_ff")), 2,
                                        ctx=mx.cpu(), numpy_batch_size=8)
        got[key] = (_arrays(arg), _arrays(arg2), _arrays(ff.arg_params),
                    pred, ff2.predict(x), ff2.begin_epoch)
    _close(got["port"][0], params, rtol=0, atol=0)
    _close(got["port"][1], params, rtol=0, atol=0)
    _close(got["port"][2], got["jax"][2])
    np.testing.assert_allclose(got["port"][3], got["jax"][3], **TOL)
    np.testing.assert_allclose(got["port"][4], got["port"][3], rtol=0,
                               atol=0)
    assert got["port"][5] == got["jax"][5] == 2
    # the JAX package reads the port's files: the same params bitwise
    _, jarg, _ = jmx.model.load_checkpoint(str(tmp_path / "port"), 7)
    _close(_arrays(jarg), params, rtol=0, atol=0)


def test_callbacks(tmp_path, caplog):
    mod, it = _fit_mlp(mt, None, epochs=1)
    arg, aux = mod.get_params()
    prefix = str(tmp_path / "cb")
    mt.callback.do_checkpoint(prefix, period=2)(0, mod.symbol, arg, aux)
    assert not os.path.exists(prefix + "-0001.params")
    mt.callback.do_checkpoint(prefix, period=2)(1, mod.symbol, arg, aux)
    assert os.path.exists(prefix + "-0002.params")
    mt.callback.module_checkpoint(mod, prefix + "m", 1, True)(0)
    assert os.path.exists(prefix + "m-0001.states")
    metric = mt.metric.create("acc")
    metric.update([mt.nd.array([1.0, 0.0])],
                  [mt.nd.array([[0.2, 0.8], [0.9, 0.1]])])
    param = mt.model.BatchEndParam(epoch=0, nbatch=4, eval_metric=metric,
                                   locals=None)
    assert param == mt.model.BatchEndParam(0, 4, metric, None)
    assert type(param).__name__ == \
        type(jmx.model.BatchEndParam(0, 4, None, None)).__name__
    with caplog.at_level(logging.INFO):
        mt.callback.log_train_metric(2, auto_reset=True)(param)
        assert metric.num_inst == 0
        metric.update([mt.nd.array([1.0])], [mt.nd.array([[0.2, 0.8]])])
        speed = mt.callback.Speedometer(2, frequent=2)
        for n in range(5):
            speed(param._replace(nbatch=n))
        speed(param._replace(nbatch=0))          # a new epoch re-anchors
        mt.callback.ProgressBar(total=8, length=8)(param)
        mt.callback.LogValidationMetricsCallback()(param)
    text = caplog.text
    assert "Train-accuracy=1.000000" in text
    assert text.count("samples/sec") == 2 and "Batch [2-4]" in text
    assert "[====----] 50%" in text


def test_executor_manager_matches_jax():
    for loads in ([1, 1], [1, 2, 1], [3]):
        assert mt.executor_manager.split_input_slice(10, loads) == \
            jmx.executor_manager.split_input_slice(10, loads)
    for mx in (mt, jmx):
        with pytest.raises(mx.MXNetError, match="Too many slices"):
            mx.executor_manager.split_input_slice(2, [1, 1, 1])
        with pytest.raises(mx.MXNetError, match="Invalid workload"):
            mx.executor_manager.split_input_slice(2, [0])
        mx.executor_manager.check_arguments(_mlp(mx))
        # both symbol packages merge a repeated name into one argument,
        # so the check meets a duplicate only in a hand-made listing
        for args, aux, what in ((["a", "w", "w"], [], "argument"),
                                (["a"], ["m", "m"], "auxiliary")):
            listing = type("Listing", (), {
                "list_arguments": lambda self, args=args: args,
                "list_auxiliary_states": lambda self, aux=aux: aux})()
            with pytest.raises(mx.MXNetError, match="duplicated " + what):
                mx.executor_manager.check_arguments(listing)


@pytest.mark.parametrize("layers,shape", [(18, (3, 32, 32)),
                                          (50, (3, 224, 224)),
                                          (34, (3, 64, 64))])
def test_resnet_symbol_is_the_examples(layers, shape):
    ex = _example_resnet()
    want = ex.get_symbol(10, layers, shape)
    got = tresnet.get_symbol(10, layers, shape)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    assert got.list_outputs() == want.list_outputs()
    kw = dict(data=(2,) + shape, softmax_label=(2,))
    assert [tuple(s) for part in got.infer_shape(**kw) for s in part] == \
        [tuple(s) for part in want.infer_shape(**kw) for s in part]
    with pytest.raises(ValueError):
        tresnet.get_symbol(10, 20, shape)
