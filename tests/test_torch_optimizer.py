"""The port's optimizers and LR schedulers (``mxnet_tpu_torch.optimizer``,
``mxnet_tpu_torch.lr_scheduler``) against the JAX package's: every
registered optimizer for 3 steps on two parameters with ``rescale_grad``
and ``clip_gradient`` (weights and states after each step), the
``multi_precision`` path on bf16 weights, the bf16 momentum state that
comes back fp32, every LR scheduler alone and driving an optimizer, the
``param_idx2name`` and Symbol multipliers, and ``Updater`` state
round-trips. Inputs are numpy arrays made from seeds; SGLD's noise is
the same array in both packages (their generators never agree).

Tolerances: fp32 at rtol 1e-5 with an atol of 1e-5 times the largest
magnitude, after up to 3 steps; a bf16 weight at 2^-7 of the largest
magnitude (one bf16 rounding of the same fp32 value); lr values to 1e-12
relative (the same Python arithmetic)."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import dtype_name
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = ((3, 4), (5,))
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
# optimizer name -> its own hyperparameters
RULES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9),
    "ccsgd": dict(learning_rate=0.1, momentum=0.9),
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01),
    "ftml": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9, warmup_strategy="lars"),
    "sgld": dict(learning_rate=0.01),
    "adam": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1),
    "adadelta": dict(),
    "rmsprop": dict(learning_rate=0.01),
    "rmsprop-centered": dict(learning_rate=0.01, centered=True,
                             clip_weights=0.9),
    "ftrl": dict(learning_rate=0.1),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "test": dict(),
}


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]


def _grads(step):
    rs = np.random.RandomState(100 + step)
    return [rs.uniform(-2, 2, s).astype(np.float32) for s in SHAPES]


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _close(t, j, what, tol=1e-5):
    assert dtype_name(t.dtype) == np.dtype(j.dtype).name, what
    tv = np.asarray(t.asnumpy(), np.float64)
    jv = np.asarray(j.asnumpy(), np.float64)
    np.testing.assert_allclose(tv, jv, rtol=tol,
                               atol=tol * max(1.0, np.abs(jv).max()),
                               err_msg=what)


def _same_noise(monkeypatch):
    """SGLD's noise: N(0, lr) from one numpy stream, in both packages."""
    rs = np.random.RandomState(7)
    draws = {}

    def draw(shape, lr):
        key = (len(draws), tuple(shape))
        draws[key] = (rs.standard_normal(shape) * np.sqrt(lr)) \
            .astype(np.float32)
        return draws[key]

    queue = []

    def jax_normal(loc, scale, shape=None, dtype=None, **kw):
        v = draw(shape, scale ** 2)
        queue.append(v)
        return jmx.nd.array(v)

    def port_noise(self, weight, lr):
        return torch.from_numpy(queue.pop(0))

    monkeypatch.setattr(jmx.nd.random, "normal", jax_normal)
    monkeypatch.setattr(mt.optimizer.SGLD, "_noise", port_noise)


def _run(mx, name, kwargs, dtype="float32", steps=3):
    """``steps`` updates of both parameters through an Updater: the
    (weights, states) after each step."""
    opt = mx.optimizer.create(name.split("-")[0], **kwargs)
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w, dtype=dtype) for w in _weights()]
    trail = []
    for step in range(steps):
        gs = [mx.nd.array(g, dtype=dtype) for g in _grads(step)]
        for i, (w, g) in enumerate(zip(ws, gs)):
            upd(i, g, w)
        trail.append(([w.copy() for w in ws],
                      [[a.copy() for a in _flat(upd.states[i])]
                       for i in range(len(ws))]))
    return trail, upd


@pytest.mark.parametrize("name", sorted(RULES))
def test_optimizer_three_steps_match_jax(name, monkeypatch):
    if name == "sgld":
        _same_noise(monkeypatch)
    kwargs = dict(COMMON, **RULES[name])
    jtrail, _ = _run(jmx, name, kwargs)
    ttrail, _ = _run(mt, name, kwargs)
    for step, ((tw, ts), (jw, js)) in enumerate(zip(ttrail, jtrail)):
        for i, (t, j) in enumerate(zip(tw, jw)):
            _close(t, j, "%s step %d weight %d" % (name, step, i))
        for i, (t, j) in enumerate(zip(ts, js)):
            assert len(t) == len(j)
            for k, (a, b) in enumerate(zip(t, j)):
                _close(a, b, "%s step %d state %d.%d" % (name, step, i, k))


@pytest.mark.parametrize("name", ["sgd", "nag", "adam"])
def test_multi_precision_keeps_an_fp32_master_for_bf16(name):
    kwargs = dict(COMMON, multi_precision=True, **RULES[name])
    jtrail, jupd = _run(jmx, name, kwargs, dtype="bfloat16")
    ttrail, tupd = _run(mt, name, kwargs, dtype="bfloat16")
    for (tw, ts), (jw, js) in zip(ttrail, jtrail):
        for t, j in zip(tw, jw):
            assert dtype_name(t.dtype) == "bfloat16"
            _close(t, j, name + " bf16 weight", tol=2.0 ** -7)
        for t, j in zip(ts, js):
            for a, b in zip(t, j):
                assert dtype_name(a.dtype) == "float32"
                _close(a, b, name + " master or state")
    # the bf16 weight is the master's cast
    master = tupd.states[0][0]
    np.testing.assert_array_equal(
        np.asarray(ttrail[-1][0][0].asnumpy(), np.float32),
        np.asarray(master.astype("bfloat16").asnumpy(), np.float32))


def test_bf16_momentum_state_comes_back_fp32_without_multi_precision():
    """SGD's rule computes in fp32: a bf16 weight stays bf16, its momentum
    state, made bf16, is fp32 after the first step, as in JAX."""
    kwargs = dict(COMMON, **RULES["sgd"])
    for mx in (jmx, mt):
        trail, upd = _run(mx, "sgd", kwargs, dtype="bfloat16", steps=2)
        assert [np.dtype(w.dtype).name for w in trail[-1][0]] == \
            ["bfloat16"] * 2
        assert [np.dtype(s.dtype).name for s in _flat(upd.states[0])] == \
            ["float32"]
    jtrail, _ = _run(jmx, "sgd", kwargs, dtype="bfloat16", steps=2)
    ttrail, _ = _run(mt, "sgd", kwargs, dtype="bfloat16", steps=2)
    for t, j in zip(ttrail[-1][0], jtrail[-1][0]):
        _close(t, j, "bf16 weight", tol=2.0 ** -7)
    for t, j in zip(ttrail[-1][1], jtrail[-1][1]):
        _close(t[0], j[0], "fp32 momentum", tol=2.0 ** -7)


SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=2, factor=0.5,
                                       stop_factor_lr=1e-3, warmup_steps=2,
                                       warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[2, 4], factor=0.1,
                                                 warmup_steps=1,
                                                 warmup_mode="constant",
                                                 warmup_begin_lr=0.05)),
    "poly": ("PolyScheduler", dict(max_update=6, pwr=2, final_lr=0.001,
                                   warmup_steps=2)),
    "cosine": ("CosineScheduler", dict(max_update=6, final_lr=0.001,
                                       warmup_steps=1)),
}


@pytest.mark.parametrize("which", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax(which):
    cls, kw = SCHEDULERS[which]
    j = getattr(jmx.lr_scheduler, cls)(base_lr=0.2, **kw)
    t = getattr(mt.lr_scheduler, cls)(base_lr=0.2, **kw)
    got = [t(n) for n in range(9)]
    want = [j(n) for n in range(9)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # driving an optimizer: the scheduler's base_lr becomes its lr
    jt, _ = _run(jmx, "sgd", dict(COMMON, learning_rate=0.3, momentum=0.9,
                                  lr_scheduler=getattr(
                                      jmx.lr_scheduler, cls)(**kw)))
    tt, _ = _run(mt, "sgd", dict(COMMON, learning_rate=0.3, momentum=0.9,
                                 lr_scheduler=getattr(
                                     mt.lr_scheduler, cls)(**kw)))
    for t, j in zip(tt[-1][0], jt[-1][0]):
        _close(t, j, which + " scheduled sgd")


def test_scheduler_refusals_match_jax():
    for mx in (jmx, mt):
        with pytest.raises(ValueError):
            mx.lr_scheduler.FactorScheduler(step=0)
        with pytest.raises(ValueError):
            mx.lr_scheduler.MultiFactorScheduler(step=[3, 2])
        with pytest.raises(ValueError):
            mx.lr_scheduler.LRScheduler(warmup_mode="cubic")
        opt = mx.optimizer.create(
            "sgd", lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2))
        with pytest.raises(UserWarning):
            opt.set_learning_rate(0.5)


def test_idx2name_and_symbol_multipliers_match_jax():
    """Decay applies by name to *_weight and *_gamma only; a Symbol's
    lr_mult/wd_mult attributes and set_lr_mult/set_wd_mult override."""
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma", 3: "bn_beta"}
    got = {}
    for key, mx in (("jax", jmx), ("port", mt)):
        w = mx.sym.var("fc_weight", lr_mult=2.0)
        b = mx.sym.var("fc_bias", wd_mult=3.0)
        net = mx.sym.FullyConnected(mx.sym.var("data"), weight=w, bias=b,
                                    num_hidden=4, name="fc")
        opt = mx.optimizer.create("sgd", learning_rate=0.1, wd=0.01,
                                  param_idx2name=names, sym=net)
        opt.set_lr_mult({"bn_beta": 0.5})
        plain = mx.optimizer.create("sgd", learning_rate=0.1, wd=0.01,
                                    param_idx2name=names)
        got[key] = (opt._get_lrs(list(names)), opt._get_wds(list(names)),
                    plain._get_wds(list(names)))
    assert got["port"] == got["jax"]
    assert got["port"][2] == [0.01, 0.0, 0.01, 0.0]


def test_updater_states_round_trip_and_continue_alike():
    kwargs = dict(COMMON, **RULES["adam"])
    _, jupd = _run(jmx, "adam", kwargs, steps=2)
    _, tupd = _run(mt, "adam", kwargs, steps=2)
    for dump in (False, True):
        blob = tupd.get_states(dump_optimizer=dump)
        fresh = mt.optimizer.get_updater(
            mt.optimizer.create("adam", **kwargs))
        fresh.set_states(blob)
        assert sorted(fresh.states) == [0, 1]
        assert fresh.states_synced == {0: False, 1: False}
        if dump:
            assert fresh.optimizer is not tupd.optimizer
            assert fresh.optimizer._index_update_count == {0: 2, 1: 2}
        for i in (0, 1):
            for a, b in zip(_flat(fresh.states[i]), _flat(jupd.states[i])):
                _close(a, b, "restored state %d" % i)


def test_create_register_and_refusals():
    assert sorted(mt.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    with pytest.raises(ValueError):
        mt.optimizer.create("nope")

    @mt.optimizer.register
    class Halve(mt.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            weight._set_data(weight._data.detach() / 2)

    opt = mt.optimizer.create("halve")
    w = mt.nd.array(np.ones(3, np.float32), dtype="bfloat16")
    opt.update_multi_precision(0, w, mt.nd.ones((3,)), None)
    assert dtype_name(w.dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(w.asnumpy(), np.float32), 0.5)
    del mt.optimizer.Optimizer.opt_registry["halve"]
