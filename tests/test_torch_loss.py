"""The port's Gluon losses (``mxnet_tpu_torch.gluon.loss``) against the JAX
package's: each of the 13 losses (and its variants: logits or
probabilities, sparse or dense labels, ``pos_weight``, signed or binary
labels, the Stirling term, padded CTC labels with and without lengths)
with a global ``weight`` and a ``sample_weight``, imperative and
hybridized: the loss and the gradient of each differentiable input,
under a seeded head gradient. Inputs are numpy arrays made from seeds.

Tolerance: fp32 at rtol 1e-5 with an atol of 1e-6 times the largest
magnitude (CTC: 1e-4 and 1e-5 of it, a 12-step recursion in log space;
its gradient where JAX's is finite: JAX's is NaN on early frames)."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C = 4, 5


def U(shape, lo=-1.0, hi=1.0, seed=0):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape), np.float32)


SIGN = np.where(U((N, 1), seed=9) > 0, 1.0, -1.0).astype(np.float32)
SW = U((N, 1), 0.5, 1.5, seed=8)
CTC_T, CTC_C = 12, 6
# labels of the classes 0..C-2 (the blank is the last), padded by -1
CTC_LABEL = np.array([[1, 2, 2, 0], [3, 4, -1, -1], [0, -1, -1, -1],
                      [4, 1, 3, 2]], np.float32)

# name -> (class, constructor kwargs, inputs, keyword inputs); an input is
# ("x", array) when differentiable, ("y", array) otherwise
CASES = {
    "l2": ("L2Loss", dict(weight=2.0), [("x", U((N, C))), ("y", U((N, C), seed=1))],
           dict(sample_weight=SW)),
    "l1": ("L1Loss", dict(weight=0.5), [("x", U((N, C))), ("y", U((N, C), seed=1))],
           dict(sample_weight=SW)),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", dict(weight=1.5),
                    [("x", U((N, C), -3, 3)),
                     ("y", (U((N, C), seed=2) > 0).astype(np.float32))],
                    dict(sample_weight=SW)),
    "sigmoid_bce_pos_weight": (
        "SigmoidBinaryCrossEntropyLoss", dict(),
        [("x", U((N, C), -3, 3)),
         ("y", (U((N, C), seed=2) > 0).astype(np.float32))],
        dict(pos_weight=U((C,), 0.5, 2.0, seed=3))),
    "sigmoid_bce_from_sigmoid": (
        "SigmoidBCELoss", dict(from_sigmoid=True),
        [("x", U((N, C), 0.05, 0.95)),
         ("y", (U((N, C), seed=2) > 0).astype(np.float32))],
        dict(sample_weight=SW)),
    "sigmoid_bce_from_sigmoid_pos_weight": (
        "SigmoidBCELoss", dict(from_sigmoid=True),
        [("x", U((N, C), 0.05, 0.95)),
         ("y", (U((N, C), seed=2) > 0).astype(np.float32))],
        dict(pos_weight=U((C,), 0.5, 2.0, seed=3))),
    "softmax_ce_sparse": ("SoftmaxCrossEntropyLoss", dict(weight=2.0),
                          [("x", U((N, C), -2, 2)),
                           ("y", np.array([0, 3, 4, 1], np.float32))],
                          dict(sample_weight=SW)),
    "softmax_ce_dense": ("SoftmaxCELoss", dict(sparse_label=False),
                         [("x", U((N, C), -2, 2)),
                          ("y", U((N, C), 0, 1, seed=4)
                           / U((N, C), 0, 1, seed=4).sum(1, keepdims=True))],
                         dict()),
    "softmax_ce_from_logits": ("SoftmaxCELoss", dict(from_logits=True),
                               [("x", -U((N, C), 0.1, 3)),
                                ("y", np.array([2, 0, 1, 4], np.float32))],
                               dict()),
    "kldiv": ("KLDivLoss", dict(), [("x", -U((N, C), 0.1, 3)),
                                    ("y", U((N, C), 0.01, 1, seed=5))],
              dict(sample_weight=SW)),
    "kldiv_softmax": ("KLDivLoss", dict(from_logits=False),
                      [("x", U((N, C), -2, 2)),
                       ("y", U((N, C), 0.01, 1, seed=5))], dict()),
    "ctc": ("CTCLoss", dict(weight=0.5),
            [("x", U((N, CTC_T, CTC_C), -2, 2)), ("y", CTC_LABEL)],
            dict(sample_weight=SW[:, 0])),
    "ctc_lengths": ("CTCLoss", dict(),
                    [("x", U((N, CTC_T, CTC_C), -2, 2)), ("y", CTC_LABEL)],
                    dict(pred_lengths=np.array([12, 9, 10, 12], np.float32),
                         label_lengths=np.array([4, 2, 1, 3], np.float32))),
    "ctc_tnc": ("CTCLoss", dict(layout="TNC", label_layout="TN"),
                [("x", U((CTC_T, N, CTC_C), -2, 2)),
                 ("y", np.ascontiguousarray(CTC_LABEL.T))], dict()),
    "huber": ("HuberLoss", dict(rho=0.5), [("x", U((N, C), -2, 2)),
                                            ("y", U((N, C), seed=1))],
              dict(sample_weight=SW)),
    "hinge": ("HingeLoss", dict(margin=1.5), [("x", U((N, C), -2, 2)),
                                              ("y", np.repeat(SIGN, C, 1))],
              dict(sample_weight=SW)),
    "squared_hinge": ("SquaredHingeLoss", dict(),
                      [("x", U((N, C), -2, 2)), ("y", np.repeat(SIGN, C, 1))],
                      dict()),
    "logistic_signed": ("LogisticLoss", dict(),
                        [("x", U((N, C), -3, 3)),
                         ("y", np.repeat(SIGN, C, 1))],
                        dict(sample_weight=SW)),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        [("x", U((N, C), -3, 3)),
                         ("y", (np.repeat(SIGN, C, 1) > 0).astype(np.float32))],
                        dict()),
    "triplet": ("TripletLoss", dict(margin=0.5),
                [("x", U((N, C))), ("x", U((N, C), seed=6)),
                 ("x", U((N, C), seed=7))], dict(sample_weight=SW[:, 0])),
    "poisson_nll": ("PoissonNLLLoss", dict(), [("x", U((N, C), -1, 1)),
                                               ("y", U((N, C), 0, 3, seed=1))],
                    dict(sample_weight=SW)),
    "poisson_nll_full": ("PoissonNLLLoss", dict(from_logits=False,
                                                compute_full=True),
                         [("x", U((N, C), 0.2, 3)),
                          ("y", U((N, C), 0.5, 4, seed=1))], dict()),
    "cosine_embedding": ("CosineEmbeddingLoss", dict(margin=0.2),
                         [("x", U((N, C))), ("x", U((N, C), seed=6)),
                          ("y", SIGN[:, 0])], dict(sample_weight=SW)),
}


# the optional inputs after the main ones, in each loss's order (a Block
# takes its inputs by position; a missing one is None)
TAIL = {"SigmoidBinaryCrossEntropyLoss": ("sample_weight", "pos_weight"),
        "SigmoidBCELoss": ("sample_weight", "pos_weight"),
        "CTCLoss": ("pred_lengths", "label_lengths", "sample_weight")}


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _run(mx, name, hybrid):
    cls, kw, inputs, kw_inputs = CASES[name]
    loss = getattr(mx.gluon.loss, cls)(**kw)
    if hybrid:
        loss.hybridize()
    arrs = [mx.nd.array(v) for _, v in inputs]
    for (kind, _), a in zip(inputs, arrs):
        if kind == "x":
            a.attach_grad()
    names = TAIL.get(cls, ("sample_weight",))
    last = max([names.index(k) + 1 for k in kw_inputs] or [0])
    tail = [mx.nd.array(kw_inputs[k]) if k in kw_inputs else None
            for k in names[:last]]
    with mx.autograd.record():
        out = loss(*(arrs + tail))
    head = U(out.shape, 0.5, 1.5, seed=11)
    out.backward(mx.nd.array(head))
    grads = [a.grad.asnumpy() for (kind, _), a in zip(inputs, arrs)
             if kind == "x"]
    return out.asnumpy(), grads


def _close(got, want, what, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol / 10 * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("hybrid", [False, True], ids=["imperative",
                                                       "hybridized"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, hybrid):
    tol = 1e-4 if name.startswith("ctc") else 1e-5
    jout, jgrads = _run(jmx, name, hybrid)
    tout, tgrads = _run(mt, name, hybrid)
    assert np.all(np.isfinite(tout))
    _close(tout, jout, name + " loss", tol)
    for k, (t, j) in enumerate(zip(tgrads, jgrads)):
        assert np.all(np.isfinite(t)), name
        if name.startswith("ctc"):
            # JAX's CTC gradient is NaN on early frames (ROADMAP §C); the
            # port's is held against torch's CTC in test_torch_nn_ops_rest
            t, j = t[np.isfinite(j)], j[np.isfinite(j)]
        _close(t, j, "%s gradient of input %d" % (name, k), tol)


def test_loss_repr_and_refusals_match_jax():
    for mx in (jmx, mt):
        assert repr(mx.gluon.loss.L2Loss()) == \
            "L2Loss(batch_axis=0, w=1.0)"
        with pytest.raises(ValueError):
            mx.gluon.loss.LogisticLoss(label_format="hot")
        with pytest.raises(AssertionError):
            mx.gluon.loss.CTCLoss(layout="NCT")
