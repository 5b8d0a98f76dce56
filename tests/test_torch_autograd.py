"""The port's autograd (``mxnet_tpu_torch.autograd``, over
torch.autograd) against the JAX package's, mirroring
``tests/test_autograd.py``: the same seeded inputs go through both, and
the gradients agree at fp32 rtol 1e-6 (atol 1e-6)."""

import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RS = np.random.RandomState(0)
XV = RS.rand(3, 4).astype(np.float32) + 0.5
WV = RS.rand(4, 5).astype(np.float32)
PACKAGES = ((jnd, jag), (tnd, tag))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _both(fn):
    """fn(nd, ag) -> list of numpy arrays, for each package."""
    (j, t) = [fn(nd, ag) for nd, ag in PACKAGES]
    assert len(j) == len(t)
    for a, b in zip(t, j):
        _close(a, b)
    return t


def test_simple_chain_and_matmul_grads():
    def f(nd, ag):
        x, w = nd.array(XV), nd.array(WV)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            y = nd.exp(nd.log(x) * 2.0) + 2 * x
            loss = (nd.dot(y, w) ** 2).sum()
        loss.backward()
        return [loss.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy()]
    _both(f)


def test_head_gradient_and_multi_output():
    def f(nd, ag):
        x = nd.array(XV)
        x.attach_grad()
        with ag.record():
            parts = nd.split(x, num_outputs=2, axis=1)
            y = parts[0] * 1 + parts[1] * 3
        y.backward(nd.array(XV[:, :2]))
        return [x.grad.asnumpy()]
    _both(f)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    def f(nd, ag):
        x = nd.array(XV)
        x.attach_grad(grad_req=req)
        for _ in range(3):
            with ag.record():
                y = (x * x).sum()
            y.backward()
        return [x.grad.asnumpy()]
    (g,) = _both(f)
    want = {"write": 2 * XV, "add": 6 * XV, "null": 0 * XV}[req]
    _close(g, want)


def test_mark_variables_with_own_gradient_buffers():
    def f(nd, ag):
        x, w = nd.array(XV), nd.array(WV)
        gx, gw = nd.zeros(x.shape), nd.ones(w.shape)
        ag.mark_variables([x, w], [gx, gw], grad_reqs=["write", "add"])
        with ag.record():
            loss = nd.dot(x, w).sum()
        loss.backward()
        assert x.grad is gx and w.grad is gw
        return [gx.asnumpy(), gw.asnumpy()]
    _both(f)


def test_retain_graph():
    """Two backward passes through one retained graph add the gradient
    twice (grad_req "add"). The JAX package keeps each node's summed
    cotangents when the graph is retained and sums them again in the
    second pass (ROADMAP C); so the port is held against JAX's single
    pass, doubled."""
    def once(nd, ag):
        x = nd.array(XV)
        x.attach_grad()
        with ag.record():
            y = (nd.sin(x) * x).sum()
        y.backward()
        return [x.grad.asnumpy()]
    (want,) = once(jnd, jag)
    x = tnd.array(XV)
    x.attach_grad(grad_req="add")
    with tag.record():
        y = (tnd.sin(x) * x).sum()
    y.backward(retain_graph=True)
    _close(x.grad.asnumpy(), want)
    y.backward()
    _close(x.grad.asnumpy(), 2 * want)
    with pytest.raises(RuntimeError):
        y.backward()      # the graph was freed


def test_grad_function():
    def f(nd, ag):
        x = nd.array(XV)
        x.attach_grad()
        with ag.record():
            y = (x ** 3).sum()
        (g,) = ag.grad([y], [x])
        return [g.asnumpy()]
    (g,) = _both(f)
    _close(g, 3 * XV ** 2)
    x = tnd.array(XV)
    with tag.record():
        y = (x ** 3).sum()
    with pytest.raises(mt.MXNetError):
        tag.grad([y], [x])


def test_grad_create_graph_gives_a_second_derivative():
    x = tnd.array(XV)
    x.attach_grad()
    with tag.record():
        y = (x ** 3).sum()
        (g,) = tag.grad([y], [x], create_graph=True)
        z = g.sum()
    z.backward()
    _close(x.grad.asnumpy(), 6 * XV)


def test_detach_and_blockgrad():
    def f(nd, ag):
        x = nd.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * 3
            z = y.detach() * x + nd.BlockGrad(x * 5) * x
        z.backward()
        return [x.grad.asnumpy()]
    (g,) = _both(f)
    _close(g, [16.0])


def test_shared_input_and_astype_keep_the_tape():
    def f(nd, ag):
        x = nd.array(XV)
        x.attach_grad()
        with ag.record():
            y = (x * x).astype("bfloat16").astype("float32") * x
            loss = y.sum()
        loss.backward()
        return [x.grad.asnumpy()]
    _both(f)


def test_custom_function():
    def f(nd, ag):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 2     # twice the true gradient

        x = nd.array(XV)
        x.attach_grad()
        with ag.record():
            out = Sigmoid()(x)
            loss = (out * out).sum()
        loss.backward()
        unrecorded = Sigmoid()(nd.array(XV))
        return [out.asnumpy(), x.grad.asnumpy(), unrecorded.asnumpy()]
    _both(f)


def test_scopes():
    for ag in (jag, tag):
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(False) is False


def test_ops_outside_record_build_no_graph():
    x = tnd.array(XV)
    x.attach_grad()
    y = x * 2 + 1
    assert not y._requires_tape()
    with tag.record():
        z = x * 2
        with tag.pause():
            w = x * 2
    assert z._requires_tape() and not w._requires_tape()
    with pytest.raises(mt.MXNetError):
        y.backward()


def test_marking_a_variable_again_resets_it():
    """Marking an array a second time (here with grad_req="add") resets
    its gradient and request, as the reference's attach_grad does; it
    must not compare the array with itself elementwise."""
    def f(nd, ag):
        x = nd.array(np.array([1.0, 2.0, 3.0], np.float32))
        x.attach_grad()
        x.attach_grad(grad_req="add")
        for _ in range(2):
            with ag.record():
                y = (x * x).sum()
            y.backward()
        return [x.grad.asnumpy()]
    (g,) = _both(f)
    _close(g, [4.0, 8.0, 12.0])


@pytest.mark.parametrize("rebind", ["iadd", "setitem", "copyto"])
def test_variable_rebound_after_recording_gets_its_recorded_gradient(rebind):
    """A variable rebound outside record() after its graph was recorded
    (an in-place operator, __setitem__ or copyto) still receives the
    gradient at the values that were recorded, as the reference writes
    it by the NDArray on the tape; its .grad is never left stale."""
    def f(nd, ag):
        x = nd.array(np.array([1.0, 2.0, 3.0], np.float32))
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        if rebind == "iadd":
            x += 1
        elif rebind == "setitem":
            x[:] = 5.0
        else:
            nd.array(np.array([7.0, 8.0, 9.0], np.float32)).copyto(x)
        y.backward()
        return [x.grad.asnumpy(), x.asnumpy()]
    g, _ = _both(f)
    _close(g, [2.0, 4.0, 6.0])


def test_private_copy_after_recording_keeps_the_gradient():
    """NDArray._own_buffer (a kernel about to write the array) rebinds a
    shared variable to a private copy; the recorded graph's gradient
    still reaches the variable."""
    x = tnd.array(np.array([1.0, 2.0, 3.0], np.float32))
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    shared = x._data
    x._own_buffer()
    assert x._data is not shared
    y.backward()
    _close(x.grad.asnumpy(), [2.0, 4.0, 6.0])
