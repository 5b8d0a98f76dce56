"""The port's control flow (``mxnet_tpu_torch.control_flow`` and
``ops/control_flow_ops.py``: ``nd.contrib`` and ``sym.contrib``'s
``foreach``, ``while_loop`` and ``cond``) against the JAX package's, case
for case with ``tests/test_control_flow.py``: the same numpy inputs
through both packages, eager and symbolic, values and the gradients of
the data, the states and closure-captured arrays at fp32 atol 1e-5 /
rtol 1e-4; the JSON of a ``_foreach`` graph byte for byte; and a graph
saved by either package run by the other."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-4
PKGS = (("jax", jmx), ("port", mt))


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _both(fn):
    """fn(mx) in each package: {"jax": ..., "port": ...}."""
    return {key: fn(mx) for key, mx in PKGS}


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _cpu_of(mx):
    return mx.cpu()


# --------------------------------------------------------------- eager --
def test_foreach_eager_cumsum():
    data = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(mx):
        def body(x, s):
            new_s = s + x
            return new_s, new_s
        outs, final = mx.nd.contrib.foreach(body, mx.nd.array(data),
                                            mx.nd.zeros((3,)))
        return outs.asnumpy(), final.asnumpy()
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)
    _close(got["port"][0], np.cumsum(data, axis=0))


def test_foreach_eager_grad_flows_to_closure():
    def run(mx):
        data = mx.nd.array(np.ones((3, 2), np.float32))
        w = mx.nd.array(np.full((2,), 2.0, np.float32))
        data.attach_grad()
        w.attach_grad()
        with mx.autograd.record():
            def body(x, s):
                new_s = s + x * w
                return new_s, new_s
            outs, _ = mx.nd.contrib.foreach(body, data, mx.nd.zeros((2,)))
            loss = outs.sum()
        loss.backward()
        return w.grad.asnumpy(), data.grad.asnumpy()
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)
    _close(got["port"][0], [6.0, 6.0])


def test_while_loop_eager_reference_example():
    def run(mx):
        outputs, states = mx.nd.contrib.while_loop(
            lambda i, s: i <= 5, lambda i, s: (i + s, [i + 1, s + i]),
            [mx.nd.array([0.0]), mx.nd.array([1.0])], max_iterations=10)
        return outputs.asnumpy(), [s.asnumpy() for s in states]
    got = _both(run)
    assert got["port"][0].shape == (10, 1)
    _close(got["port"][0], got["jax"][0])
    _close(got["port"][0][:6].ravel(), [1, 2, 4, 7, 11, 16])
    for g, w in zip(got["port"][1], got["jax"][1]):
        _close(g, w)


def test_while_loop_never_true_raises():
    for _, mx in PKGS:
        with pytest.raises(ValueError):
            mx.nd.contrib.while_loop(lambda x: x < 0, lambda x: (x, x),
                                     mx.nd.array([1.0]), max_iterations=4)


def test_cond_eager():
    def run(mx):
        x, y = mx.nd.array([3.0]), mx.nd.array([5.0])
        return (mx.nd.contrib.cond(x < y, lambda: x * 2, lambda: y * 2)
                .asnumpy(),
                mx.nd.contrib.cond(x > y, lambda: x * 2, lambda: y * 2)
                .asnumpy())
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)


def test_foreach_rnn_style_eager_grad():
    rng = np.random.RandomState(0)
    data_np = rng.randn(5, 2, 4).astype(np.float32)
    w_np = rng.randn(4, 4).astype(np.float32) * 0.1

    def run(mx):
        w = mx.nd.array(w_np)
        w.attach_grad()
        with mx.autograd.record():
            def body(x, h):
                new_h = mx.nd.tanh(mx.nd.dot(x + h, w))
                return new_h, new_h
            outs, _ = mx.nd.contrib.foreach(body, mx.nd.array(data_np),
                                            mx.nd.zeros((2, 4)))
            loss = outs.sum()
        loss.backward()
        return outs.asnumpy(), w.grad.asnumpy()
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)


# ------------------------------------------------------------ symbolic --
def _foreach_graph(mx, name="fe"):
    data, init, w = (mx.sym.Variable(n) for n in ("data", "init", "w"))

    def body(x, s):
        new_s = s + x * w
        return new_s, new_s
    outs, final = mx.sym.contrib.foreach(body, data, init, name=name)
    return mx.sym.Group([outs, final])


FE_INPUTS = {"data": np.arange(12, dtype=np.float32).reshape(4, 3),
             "init": np.array([0.5, -1.0, 2.0], np.float32),
             "w": np.array([2.0, -0.5, 1.5], np.float32)}


def _bind_run(mx, graph, inputs, train=False, head=None):
    ex = graph.simple_bind(_cpu_of(mx), **{k: v.shape
                                            for k, v in inputs.items()})
    outs = ex.forward(is_train=train,
                      **{k: mx.nd.array(v) for k, v in inputs.items()})
    outs = [o.asnumpy() for o in outs]
    grads = {}
    if train:
        ex.backward([mx.nd.array(h) for h in head] if head else None)
        grads = {k: ex.grad_dict[k].asnumpy() for k in inputs}
    return outs, grads


def test_foreach_symbolic_matches_eager_and_jax():
    def run(mx):
        with mx.name.NameManager():
            return _bind_run(mx, _foreach_graph(mx), FE_INPUTS)[0]
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)
    want = np.cumsum(FE_INPUTS["data"] * FE_INPUTS["w"], axis=0) + \
        FE_INPUTS["init"]
    _close(got["port"][0], want)


def test_foreach_symbolic_closure_grad():
    head = [np.random.RandomState(3).rand(4, 3).astype(np.float32),
            np.random.RandomState(4).rand(3).astype(np.float32)]

    def run(mx):
        with mx.name.NameManager():
            return _bind_run(mx, _foreach_graph(mx), FE_INPUTS, True, head)
    got = _both(run)
    for k in FE_INPUTS:
        _close(got["port"][1][k], got["jax"][1][k])


def test_foreach_json_bytes_and_round_trip_both_ways():
    """The same graph gives JAX's JSON byte for byte, and a graph saved
    by either package loads and runs in the other."""
    js = _both(lambda mx: _fresh_json(mx))
    assert js["port"] == js["jax"]
    want = _both(lambda mx: _bind_run(mx, _foreach_graph_fresh(mx),
                                      FE_INPUTS)[0])
    for src, dst in (("jax", mt), ("port", jmx)):
        got, _ = _bind_run(dst, dst.sym.load_json(js[src]), FE_INPUTS)
        for g, w in zip(got, want["jax"]):
            _close(g, w)


def _foreach_graph_fresh(mx):
    with mx.name.NameManager():
        return _foreach_graph(mx)


def _fresh_json(mx):
    return _foreach_graph_fresh(mx).tojson()


def test_foreach_two_data_two_states_and_an_intermediate_capture():
    """Several data and state arrays; a body that captures an
    intermediate (not a variable) re-evaluates it inside the loop."""
    rs = np.random.RandomState(5)
    inputs = {"a": rs.rand(3, 2).astype(np.float32),
              "b": rs.rand(3, 2).astype(np.float32),
              "h": rs.rand(2).astype(np.float32),
              "c": rs.rand(2).astype(np.float32),
              "w": rs.rand(2).astype(np.float32)}

    def run(mx):
        with mx.name.NameManager():
            v = {k: mx.sym.Variable(k) for k in inputs}
            scaled = mx.sym.exp(v["w"])

            def body(xs, states):
                a, b = xs
                h, c = states
                nh = mx.sym.tanh(a * scaled + h)
                nc = c + b * nh
                return [nh, nc * 2.0], [nh, nc]
            outs, states = mx.sym.contrib.foreach(
                body, [v["a"], v["b"]], [v["h"], v["c"]], name="two")
            g = mx.sym.Group(list(outs) + list(states))
            return _bind_run(mx, g, inputs, True)
    got = _both(run)
    for g, w in zip(got["port"][0], got["jax"][0]):
        _close(g, w)
    for k in inputs:
        _close(got["port"][1][k], got["jax"][1][k])


def test_while_loop_symbolic_matches_eager():
    def run(mx):
        with mx.name.NameManager():
            i, s = mx.sym.Variable("i"), mx.sym.Variable("s")
            outs, states = mx.sym.contrib.while_loop(
                lambda i, s: i <= 5.0, lambda i, s: (i + s, [i + 1.0, s + i]),
                [i, s], max_iterations=10)
            g = mx.sym.Group([outs] + list(states))
            return _bind_run(mx, g, {"i": np.array([0.0], np.float32),
                                     "s": np.array([1.0], np.float32)})[0]
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)
    # the rows past the trip count: zeros, as JAX's masked scan leaves them
    _close(got["port"][0][6:].ravel(), np.zeros(4))


def test_while_loop_symbolic_grad_through_closure():
    """Gradients reach a free variable of the loop body; the trip count
    depends on the data (3 of 8 iterations here)."""
    inputs = {"x": np.array([0.5, 1.0], np.float32),
              "w": np.array([1.5, 0.5], np.float32)}

    def run(mx):
        with mx.name.NameManager():
            x, w = mx.sym.Variable("x"), mx.sym.Variable("w")
            outs, final = mx.sym.contrib.while_loop(
                lambda v: mx.sym.sum(v) < 10.0,
                lambda v: (v * w, v * w + 1.0), x, max_iterations=8)
            g = mx.sym.Group([outs, final])
            return _bind_run(mx, g, inputs, True)
    got = _both(run)
    for g, w in zip(got["port"][0], got["jax"][0]):
        _close(g, w)
    for k in inputs:
        _close(got["port"][1][k], got["jax"][1][k])


def test_while_loop_symbolic_never_true_gives_zero_rows():
    def run(mx):
        with mx.name.NameManager():
            x = mx.sym.Variable("x")
            outs, final = mx.sym.contrib.while_loop(
                lambda v: mx.sym.sum(v) < 0.0, lambda v: (v * 2.0, v + 1.0),
                x, max_iterations=3)
            return _bind_run(mx, mx.sym.Group([outs, final]),
                             {"x": np.array([1.0, 2.0], np.float32)})[0]
    got = _both(run)
    for g, w in zip(got["port"], got["jax"]):
        _close(g, w)
    assert got["port"][0].shape == (3, 2)


def test_cond_symbolic_single_branch_taken():
    def run(mx):
        with mx.name.NameManager():
            x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
            out = mx.sym.contrib.cond(x < y, lambda: x * 2.0,
                                      lambda: y * 3.0)
            return [_bind_run(mx, out, {"x": np.array([a], np.float32),
                                        "y": np.array([5.0], np.float32)})
                    [0][0] for a in (3.0, 7.0)]
    got = _both(run)
    _close(got["port"], got["jax"])
    _close(np.ravel(got["port"]), [6.0, 15.0])


def test_cond_runs_only_the_branch_it_takes(monkeypatch):
    """The untaken branch's ops do not run (``_cond`` builds and calls the
    taken subgraph only)."""
    from mxnet_tpu_torch import ops as tops
    calls = []
    op = tops.get("_rdiv_scalar")
    fn = op.fn
    monkeypatch.setattr(op, "fn",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    x = mt.sym.Variable("x")
    out = mt.sym.contrib.cond(mt.sym.sum(x) > 0.0, lambda: x * 2.0,
                              lambda: 1.0 / x)
    ex = out.bind(mt.cpu(), {"x": mt.nd.array([1.0, 2.0])})
    _close(ex.forward()[0].asnumpy(), [2.0, 4.0])
    assert calls == []
    ex.forward(x=mt.nd.array([-1.0, -2.0]))
    assert calls == [1]


def test_cond_symbolic_grad():
    def run(mx):
        with mx.name.NameManager():
            x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
            out = mx.sym.sum(mx.sym.contrib.cond(
                mx.sym.sum(x) < mx.sym.sum(y), lambda: x * 2.0,
                lambda: y * 3.0))
            return _bind_run(mx, out, {"x": np.array([1.0, 1.0], np.float32),
                                       "y": np.array([5.0, 5.0], np.float32)},
                             True)[1]
    got = _both(run)
    for k in ("x", "y"):
        _close(got["port"][k], got["jax"][k])
    _close(got["port"]["x"], [2.0, 2.0])


def test_foreach_body_draws_fresh_each_step_on_the_executors_device():
    """A stateful body (dropout) draws from the executor's generator at
    every step, and a zero-input node in the body lands on the
    executor's device."""
    data = mt.sym.Variable("data")

    def body(x, s):
        kept = mt.sym.Dropout(x + mt.sym.zeros((1, 64)), p=0.5)
        return kept, s + kept
    outs, _ = mt.sym.contrib.foreach(body, data, mt.sym.Variable("init"))
    ex = outs.simple_bind(mt.cpu(), data=(4, 1, 64), init=(1, 64))
    mt.random.seed(0)
    got = ex.forward(is_train=True, data=mt.nd.ones((4, 1, 64)),
                     init=mt.nd.zeros((1, 64)))[0].asnumpy()
    assert set(np.unique(got)) <= {0.0, 2.0}
    assert len({tuple(row.ravel()) for row in got}) == 4
    mt.random.seed(0)
    again = ex.forward(is_train=True, data=mt.nd.ones((4, 1, 64)),
                       init=mt.nd.zeros((1, 64)))[0].asnumpy()
    np.testing.assert_array_equal(got, again)
    assert ex.outputs[0]._data.device == torch.device("cpu")
