"""The port's Gluon ``Trainer`` (``mxnet_tpu_torch.gluon.trainer``) against
the JAX package's: the ResNet-18 thumbnail, hybridized, for 3 steps of
``Trainer("sgd", momentum=0.9, wd=1e-4)`` with ``SoftmaxCrossEntropyLoss``;
2 iterations of ``examples/dcgan.py``'s loop (a discriminator step and a
generator step through it, Adam with beta1 0.5, sigmoid BCE),
imperative; then stale gradients and ``ignore_stale_grad``,
``save_states``/``load_states``, ``allreduce_grads`` + ``update``,
``learning_rate``, and the kvstores: ``"device"``, ``"local"``,
``None``, ``dist_sync``, ``nccl``, a ``KVStore`` object,
``update_on_kvstore`` and 2-bit compression
(``tests/test_torch_kvstore_world.py`` has the store over a world of
ranks).

Parameters cross from the port to JAX by
``save_parameters``/``load_parameters``; data are numpy arrays from
seeds. Tolerances: each step's loss and, after the last step, every
parameter and the logits at a relative L2 of 1e-4 from JAX's (fp32).
The ResNet starts with each residual block's last BatchNorm gamma at
0.01 and a seeded Xavier draw: from Xavier's gammas of 1 its 3-step
trajectory is chaotic (a 1e-7 relative perturbation of the reference's
own start moves a BatchNorm beta by 5%), while from this start it moves
the reference by 2e-6, far under the limit. A BatchNorm beta's update is
a sum that nearly cancels (the next BatchNorm takes the channel mean
out), so other draws leave one beta ill-conditioned at 1e-4."""

import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _carry(tnet, jnet, tmp_path, name):
    path = str(tmp_path / (name + ".params"))
    tnet.save_parameters(path)
    jnet.load_parameters(path)


def _resnet(mx):
    return mx.gluon.model_zoo.vision.resnet18_v1(thumbnail=True, classes=10,
                                                 prefix="r18_")


def _resnet_loop(mx, net, steps=3):
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for step in range(steps):
        rs = np.random.RandomState(step)
        x = mx.nd.array(rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
        y = mx.nd.array(rs.randint(0, 10, 4).astype(np.float32))
        with mx.autograd.record():
            logits = net(x)
            loss = loss_fn(logits, y)
        loss.backward()
        trainer.step(4)
        losses.append(loss.asnumpy())
    return losses, logits.asnumpy(), _params(net)


def test_resnet18_thumbnail_sgd_loop_matches_jax(tmp_path):
    tnet = _resnet(mt)
    mt.random.seed(0)           # the same start whatever ran before
    tnet.initialize(mt.init.Xavier())
    tnet(mt.nd.zeros((1, 3, 32, 32)))
    for name, p in tnet._collect_params_with_prefix().items():
        if name.endswith("body.4.gamma"):
            p.set_data(mt.nd.ones(p.shape) * 0.01)
    jnet = _resnet(jmx)
    _carry(tnet, jnet, tmp_path, "r18")
    tl, tlogits, tp = _resnet_loop(mt, tnet)
    jl, jlogits, jp = _resnet_loop(jmx, jnet)
    for step, (t, j) in enumerate(zip(tl, jl)):
        assert _rel_l2(t, j) < REL_L2, ("loss", step, t, j)
    assert _rel_l2(tlogits, jlogits) < REL_L2
    assert sorted(tp) == sorted(jp)
    worst = max((_rel_l2(tp[k], jp[k]), k) for k in tp)
    assert worst[0] < REL_L2, worst


def _dcgan():
    spec = importlib.util.spec_from_file_location(
        "dcgan_example", os.path.join(ROOT, "examples", "dcgan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dcgan_nets(gluon):
    """examples/dcgan.py's build(), for either package's gluon."""
    nn = gluon.nn
    net_g = nn.HybridSequential(prefix="gen_")
    with net_g.name_scope():
        net_g.add(nn.Conv2DTranspose(32, 4, strides=1, padding=0,
                                     use_bias=False))
        net_g.add(nn.BatchNorm())
        net_g.add(nn.Activation("relu"))
        net_g.add(nn.Conv2DTranspose(16, 4, strides=2, padding=1,
                                     use_bias=False))
        net_g.add(nn.BatchNorm())
        net_g.add(nn.Activation("relu"))
        net_g.add(nn.Conv2DTranspose(1, 4, strides=2, padding=1,
                                     use_bias=False))
        net_g.add(nn.Activation("tanh"))
    net_d = nn.HybridSequential(prefix="disc_")
    with net_d.name_scope():
        net_d.add(nn.Conv2D(16, 4, strides=2, padding=1))
        net_d.add(nn.LeakyReLU(0.2))
        net_d.add(nn.Conv2D(32, 4, strides=2, padding=1))
        net_d.add(nn.LeakyReLU(0.2))
        net_d.add(nn.Conv2D(1, 4, strides=1, padding=0))
        net_d.add(nn.Flatten())
    return net_g, net_d


def _dcgan_loop(mx, net_g, net_d, ex, iters=2, batch=8):
    """dcgan.py's loop body: (lossD, lossG) per iteration."""
    nd, autograd = mx.nd, mx.autograd
    trainer_g = mx.gluon.Trainer(net_g.collect_params(), "adam",
                                 {"learning_rate": 2e-3, "beta1": 0.5})
    trainer_d = mx.gluon.Trainer(net_d.collect_params(), "adam",
                                 {"learning_rate": 2e-3, "beta1": 0.5})
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    rs = np.random.RandomState(0)
    ones, zeros = nd.ones((batch,)), nd.zeros((batch,))
    out = []
    for _ in range(iters):
        real = nd.array(ex.real_batch(rs, batch))
        latent = nd.array(rs.randn(batch, ex.LATENT, 1, 1)
                          .astype(np.float32))
        with autograd.record():
            out_real = net_d(real).reshape((-1,))
            fake = net_g(latent)
            out_fake = net_d(fake.detach()).reshape((-1,))
            loss_d = loss_fn(out_real, ones) + loss_fn(out_fake, zeros)
        loss_d.backward()
        trainer_d.step(batch)
        with autograd.record():
            fake = net_g(latent)
            loss_g = loss_fn(net_d(fake).reshape((-1,)), ones)
        loss_g.backward()
        trainer_g.step(batch)
        out.append((loss_d.asnumpy(), loss_g.asnumpy()))
    return out


def test_dcgan_loop_matches_jax(tmp_path):
    ex = _dcgan()
    tg, td = _dcgan_nets(mt.gluon)
    mt.random.seed(0)
    for net in (tg, td):
        net.initialize(mt.init.Normal(0.02))
    tg(mt.nd.zeros((1, ex.LATENT, 1, 1)))
    td(mt.nd.zeros((1, 1, ex.SIZE, ex.SIZE)))
    jg, jd = _dcgan_nets(jmx.gluon)
    _carry(tg, jg, tmp_path, "gen")
    _carry(td, jd, tmp_path, "disc")
    tl = _dcgan_loop(mt, tg, td, ex)
    jl = _dcgan_loop(jmx, jg, jd, ex)
    for it, ((tld, tlg), (jld, jlg)) in enumerate(zip(tl, jl)):
        assert _rel_l2(tld, jld) < REL_L2, ("lossD", it)
        assert _rel_l2(tlg, jlg) < REL_L2, ("lossG", it)
    for tnet, jnet in ((tg, jg), (td, jd)):
        tp, jp = _params(tnet), _params(jnet)
        assert sorted(tp) == sorted(jp)
        worst = max((_rel_l2(tp[k], jp[k]), k) for k in tp)
        assert worst[0] < REL_L2, worst


def _dense(mx):
    net = mx.gluon.nn.Dense(3, in_units=4, prefix="fc_")
    net.initialize(mx.init.Constant(0.5))
    return net


def _fwd_bwd(mx, net, x):
    with mx.autograd.record():
        y = net(mx.nd.array(x))
    y.backward()


X = np.random.RandomState(3).uniform(-1, 1, (2, 4)).astype(np.float32)


def test_stale_gradients_raise_unless_ignored():
    for mx in (jmx, mt):
        a, b = _dense(mx), mx.gluon.nn.Dense(2, in_units=4, prefix="b_")
        b.initialize()
        params = a.collect_params()
        params.update(b.collect_params())
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        _fwd_bwd(mx, a, X)
        with pytest.raises(UserWarning, match="b_weight"):
            trainer.step(2)
        before = b.weight.data().asnumpy()
        _fwd_bwd(mx, a, X)
        trainer.step(2, ignore_stale_grad=True)
        np.testing.assert_array_equal(b.weight.data().asnumpy(), before)
        # a's gradient is stale now: it was consumed by the last step
        with pytest.raises(UserWarning, match="fc_weight"):
            trainer.step(2)


def test_allreduce_then_update_equals_step_and_learning_rate():
    got = {}
    for key, mx in (("jax", jmx), ("port", mt)):
        outs = []
        for split in (False, True):
            net = _dense(mx)
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.1,
                                        "momentum": 0.5}, kvstore=None)
            for _ in range(2):
                _fwd_bwd(mx, net, X)
                if split:
                    trainer.allreduce_grads()
                    trainer.update(2)
                else:
                    trainer.step(2)
            outs.append(net.weight.data().asnumpy())
            trainer.set_learning_rate(0.05)
            assert trainer.learning_rate == 0.05
            trainer.learning_rate = 0.02
            assert trainer.optimizer.lr == 0.02
        np.testing.assert_array_equal(outs[0], outs[1])
        got[key] = outs[0]
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-6)


@pytest.mark.parametrize("kvstore", ["device", "local", None])
def test_one_context_kvstores_update_locally(kvstore):
    got = {}
    for key, mx in (("jax", jmx), ("port", mt)):
        net = _dense(mx)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01}, kvstore=kvstore)
        for _ in range(2):
            _fwd_bwd(mx, net, X)
            trainer.step(2)
        got[key] = (net.weight.data().asnumpy(), net.bias.data().asnumpy())
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


def test_save_and_load_states_resume_alike(tmp_path):
    def run(mx, fname, resume):
        net = _dense(mx)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01})
        _fwd_bwd(mx, net, X)
        trainer.step(2)
        if resume:
            trainer.save_states(fname)
            trainer2 = mx.gluon.Trainer(net.collect_params(), "adam",
                                        {"learning_rate": 0.01})
            trainer2.load_states(fname)
            assert sorted(trainer2._updaters[0].states) == [0, 1]
            trainer = trainer2
            # the step counts are the optimizer's: a fresh one restarts
            # Adam's bias correction, as the reference's does
        _fwd_bwd(mx, net, X)
        trainer.step(2)
        return net.weight.data().asnumpy()

    for resume in (False, True):
        t = run(mt, str(tmp_path / "t.states"), resume)
        j = run(jmx, str(tmp_path / "j.states"), resume)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_refusals_name_the_kvstore_item():
    """What refused naming the kvstore item before it was ported now
    trains: a dist_sync, nccl or KVStore-object store (through
    pushpull_fused) and update_on_kvstore=True (the update on the store)
    give the store-less path's weights bitwise, each against JAX's same
    run; 2-bit compression
    (threshold 0.5, so that these gradients leave codes of 00 and of
    +-t) is JAX's too. The argument checks that remain still raise. A
    Trainer over two contexts, which refused before, trains without a
    store (each parameter updated where it lies, as JAX's does: the
    parameters are those of the same Trainer on one context, bitwise);
    with a store it raises saying that JAX's fused push fails there too
    (tests/test_torch_group2ctx.py holds both against JAX)."""
    def run(mx, **kw):
        net = _dense(mx)
        other = mx.gluon.nn.Dense(2, in_units=4, prefix="o_")
        other.initialize(mx.init.Constant(0.25))
        params = net.collect_params()
        params.update(other.collect_params())
        trainer = mx.gluon.Trainer(params, "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   **kw)
        for _ in range(2):
            with mx.autograd.record():
                y = (net(mx.nd.array(X)) ** 2).sum() + \
                    other(mx.nd.array(X)).sum() * 3
            y.backward()
            trainer.step(2)
        return [p.data().asnumpy() for p in params.values()], trainer

    want, plain = run(mt, kvstore=None)
    assert plain._kvstore is None
    for kw in (dict(kvstore="dist_sync"), dict(kvstore="nccl"),
               dict(kvstore=mt.kvstore.create("device")),
               dict(update_on_kvstore=True),
               dict(compression_params={"type": "2bit", "threshold": 0.5})):
        got, trainer = run(mt, **kw)
        assert trainer._kvstore.dispatch_stats["keys"] == 8
        jkw = dict(kw)
        if isinstance(kw.get("kvstore"), mt.kvstore.KVStore):
            jkw["kvstore"] = jmx.kvstore.create("device")
        jax_got, _ = run(jmx, **jkw)
        for t, j, w in zip(got, jax_got, want):
            if "compression_params" in kw:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
                assert not np.array_equal(t, w)
            else:
                np.testing.assert_array_equal(t, w)
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    net = _dense(mt)
    params = net.collect_params()
    other = mt.gluon.nn.Dense(2, in_units=4)
    other.initialize(ctx=mt.Context("cpu", 1))
    params.update(other.collect_params())
    trainer = mt.gluon.Trainer(params, "sgd")
    with pytest.raises(mt.MXNetError, match="JAX package"):
        trainer.step(1)

    def two_contexts(ctx):
        net = _dense(mt)
        other = mt.gluon.nn.Dense(2, in_units=4, prefix="o_")
        other.initialize(mt.init.Constant(0.25), ctx=ctx)
        params = net.collect_params()
        params.update(other.collect_params())
        trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                                   "momentum": 0.9},
                                   kvstore=None)
        for _ in range(2):
            with mt.autograd.record():
                y = (net(mt.nd.array(X)) ** 2).sum() + \
                    other(mt.nd.array(X)).sum() * 3
            y.backward()
            trainer.step(2)
        return [p.data().asnumpy() for p in params.values()], \
            [p.list_ctx()[0] for p in params.values()]
    got, ctxs = two_contexts(mt.Context("cpu", 1))
    one, _ = two_contexts(mt.cpu())
    assert ctxs[-1] == mt.Context("cpu", 1) and ctxs[0] == mt.cpu()
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        mt.gluon.Trainer([1, 2], "sgd")
    with pytest.raises(AssertionError):
        mt.gluon.Trainer(_dense(mt).collect_params(), mt.optimizer.SGD(),
                         {"learning_rate": 0.1})