"""Placement and several contexts in one process, held against the JAX
package on the CPU (JAX on two of its virtual CPU devices, the port on
``cpu(0)`` and ``cpu(1)``, which torch holds as one device):

* a ``group2ctx``-placed executor gives the unplaced one's outputs and
  gradients bitwise, its arrays carrying their group's context, and its
  ``transfers`` the boundary copies of a forward and a backward;
* ``examples/model_parallel/matrix_factorization.py``'s net through
  ``Module.fit`` with ``group2ctxs`` on ``cpu(0)``/``cpu(1)`` against
  JAX's fit (JAX's Module accepts ``group2ctxs`` and binds every node on
  its first context), from the same Normal(0.1) draws and the same
  shuffle;
* ``Module`` over two contexts with ``kvstore="device"`` makes a store
  and updates on it, as JAX's does, its parameters after two batches
  against JAX's, and bitwise those of a one-context module given a
  created ``device`` store;
* the Gluon ``Trainer`` over parameters on two devices: without a store
  it trains each where it lies, as JAX's does (against JAX's, the
  parameters on its second device); with the default store JAX's fused
  push fails on them and the port raises saying so.

Tolerances: the placed executor bitwise; the factorization fit's
parameters after 2 epochs of Adam (128 updates) within 1e-4 of their
change from the initial draws, relative L2 (fp32 arithmetic in another
order, which Adam's normalised steps carry; 1.2e-5 measured);
the two-context Module and the Trainer rtol 1e-5, atol 1e-6 against JAX
and bitwise port to port."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MF = dict(num_users=200, num_items=100, factor_size=8, batch_size=64,
          lr=0.1, ratings=4096)
MF_EPOCHS = 2
# the fit's change from its initial draws, relative L2 (measured 1.2e-5)
TOL_MF_REL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def mf_net(mx, factor_size, num_users, num_items):
    """matrix_factorization.py's net, in either package."""
    user = mx.sym.Variable("user")
    item = mx.sym.Variable("item")
    score = mx.sym.Variable("score_label")
    with mx.AttrScope(ctx_group="dev1"):
        user_emb = mx.sym.Embedding(user, input_dim=num_users,
                                    output_dim=factor_size, name="user_emb")
        user_vec = mx.sym.Flatten(user_emb)
    with mx.AttrScope(ctx_group="dev2"):
        item_emb = mx.sym.Embedding(item, input_dim=num_items,
                                    output_dim=factor_size, name="item_emb")
        item_vec = mx.sym.Flatten(item_emb)
        pred = mx.sym.sum(user_vec * item_vec, axis=1)
    return mx.sym.LinearRegressionOutput(pred, score, name="score")


def synthetic_ratings(num_users, num_items, n, seed=0):
    """The example's ratings."""
    rng = np.random.RandomState(seed)
    true_u = rng.randn(num_users, 4).astype(np.float32)
    true_i = rng.randn(num_items, 4).astype(np.float32)
    users = rng.randint(0, num_users, n)
    items = rng.randint(0, num_items, n)
    scores = (true_u[users] * true_i[items]).sum(1)
    return users.astype(np.float32), items.astype(np.float32), scores


def mf_params(spec=MF, seed=1):
    """Normal(0.1) draws for the two embeddings (the example's
    initializer), made once for both packages."""
    rng = np.random.RandomState(seed)
    return {"user_emb_weight": (rng.randn(spec["num_users"],
                                          spec["factor_size"]) * 0.1)
            .astype(np.float32),
            "item_emb_weight": (rng.randn(spec["num_items"],
                                          spec["factor_size"]) * 0.1)
            .astype(np.float32)}


def mf_fit(mx, group2ctxs, spec=MF, epochs=MF_EPOCHS):
    users, items, scores = synthetic_ratings(
        spec["num_users"], spec["num_items"], spec["ratings"])
    np.random.seed(3)
    train = mx.io.NDArrayIter({"user": users, "item": items},
                              {"score_label": scores},
                              batch_size=spec["batch_size"], shuffle=True)
    mod = mx.mod.Module(mf_net(mx, spec["factor_size"], spec["num_users"],
                               spec["num_items"]),
                        data_names=("user", "item"),
                        label_names=("score_label",), group2ctxs=group2ctxs)
    mod.fit(train, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": spec["lr"]},
            arg_params={k: mx.nd.array(v) for k, v in mf_params().items()},
            eval_metric="mse")
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}


def test_placed_executor_equals_unplaced():
    sym = mf_net(mt, 8, 20, 10)
    rng = np.random.RandomState(0)
    base = {"user": rng.randint(0, 20, 16).astype(np.float32),
            "item": rng.randint(0, 10, 16).astype(np.float32),
            "score_label": rng.randn(16).astype(np.float32)}
    base.update(mf_params(dict(MF, num_users=20, num_items=10)))
    grads = {}
    for placed in (False, True):
        args = {k: mt.nd.array(v) for k, v in base.items()}
        grad = {k: mt.nd.zeros(base[k].shape) for k in
                ("user_emb_weight", "item_emb_weight")}
        g2c = {"dev1": mt.Context("cpu", 1), "dev2": mt.cpu()} \
            if placed else None
        ex = mt.executor.Executor(sym, mt.cpu(), args, args_grad=grad,
                                  group2ctx=g2c)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        grads[placed] = (out, {k: v.asnumpy() for k, v in grad.items()})
        if placed:
            assert ex.arg_dict["user_emb_weight"].context == \
                mt.Context("cpu", 1)
            assert ex.grad_dict["user_emb_weight"].context == \
                mt.Context("cpu", 1)
            assert ex.arg_dict["item_emb_weight"].context == mt.cpu()
            # torch holds both CPU contexts on one device: no copy
            assert ex.transfers == []
    np.testing.assert_array_equal(grads[True][0], grads[False][0])
    for k in grads[False][1]:
        np.testing.assert_array_equal(grads[True][1][k], grads[False][1][k])
        assert np.any(grads[True][1][k])


def test_matrix_factorization_fit_against_jax():
    _, got = mf_fit(mt, {"dev1": mt.cpu(), "dev2": mt.Context("cpu", 1)})
    mod, want = mf_fit(jmx, {"dev1": jmx.cpu(), "dev2": jmx.Context("cpu",
                                                                     1)})
    assert sorted(got) == sorted(want)
    init = mf_params()
    for k in want:
        change = np.linalg.norm(want[k] - init[k])
        assert change > 1.0
        assert np.linalg.norm(got[k] - want[k]) <= TOL_MF_REL * change, k
    _, flat = mf_fit(mt, None)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])


def _mlp(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _mlp_params(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(16, 8) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(16) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(4, 16) * 0.3).astype(np.float32),
            "fc2_bias": (rng.randn(4) * 0.1).astype(np.float32)}


def _two_batches(mx, context, kvstore):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    mod = mx.mod.Module(_mlp(mx), context=context)
    mod.bind([("data", (4, 8))], [("softmax_label", (4,))])
    mod.init_params(arg_params={k: mx.nd.array(v)
                                for k, v in _mlp_params().items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    for i in range(2):
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x[4 * i:4 * i + 4])],
            [mx.nd.array(y[4 * i:4 * i + 4])]))
        mod.update()
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}


def test_module_over_two_contexts_makes_a_store():
    mod, got = _two_batches(mt, [mt.cpu(), mt.Context("cpu", 1)], "device")
    assert mod._kvstore is not None and mod._update_on_kvstore
    assert mod._kvstore.dispatch_stats["keys"] > 0
    jmod, want = _two_batches(jmx, [jmx.cpu(), jmx.Context("cpu", 1)],
                              "device")
    assert jmod._kvstore is not None and jmod._update_on_kvstore
    one, created = _two_batches(mt, [mt.cpu()], mt.kvstore.create("device"))
    assert one._kvstore.dispatch_stats == mod._kvstore.dispatch_stats
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
        np.testing.assert_array_equal(got[k], created[k])
    # a work_load_list rides along, as in JAX
    mt.mod.Module(_mlp(mt), context=[mt.cpu(), mt.Context("cpu", 1)],
                  work_load_list=[1, 1])


X = np.random.RandomState(4).rand(2, 4).astype(np.float32)


def _trainer_run(mx, kvstore, place):
    """Dense(3) on the first device and Dense(2) on the second, each with
    its own loss (JAX cannot add arrays that lie on two devices), one
    Trainer over both."""
    c1 = mx.Context("cpu", 1)
    net = mx.gluon.nn.Dense(3, in_units=4, prefix="a_")
    net.initialize(mx.init.Constant(0.5))
    other = mx.gluon.nn.Dense(2, in_units=4, prefix="o_")
    other.initialize(mx.init.Constant(0.25), ctx=c1)
    if place:                     # JAX's initialize keeps its first device
        for p in other.collect_params().values():
            p.set_data(mx.nd.array(p.data().asnumpy(), ctx=c1))
    params = net.collect_params()
    params.update(other.collect_params())
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9},
                               kvstore=kvstore)
    for _ in range(2):
        with mx.autograd.record():
            y0 = (net(mx.nd.array(X)) ** 2).sum()
        y0.backward()
        with mx.autograd.record():
            y1 = other(mx.nd.array(X, ctx=c1)).sum() * 3
        y1.backward()
        trainer.step(2)
    return {p.name: p.data().asnumpy() for p in params.values()}, params


def test_trainer_over_two_devices_as_jax():
    got, params = _trainer_run(mt, None, place=False)
    assert params["o_weight"].list_ctx() == [mt.Context("cpu", 1)]
    want, jparams = _trainer_run(jmx, None, place=True)
    assert {d.id for d in jparams["o_weight"].data()._data.devices()} == {1}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
        assert not np.allclose(got[k], {"a": 0.5, "o": 0.25}[k[0]])
    with pytest.raises(mt.MXNetError, match="JAX package's Trainer fails"):
        _trainer_run(mt, "device", place=False)
    with pytest.raises(ValueError, match="incompatible devices"):
        _trainer_run(jmx, "device", place=True)
