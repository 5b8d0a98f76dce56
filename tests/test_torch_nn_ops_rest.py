"""The rest of the port's ``ops/nn.py`` (the ops beyond the ResNet
subset) against the JAX package's, op by op, forward and the gradient of
every float input, on the same seeded numpy inputs through each
package's ``nd`` and ``autograd``: LeakyReLU (six act types), the layer,
group and instance norms, LRN, Deconvolution (strided, grouped, dilated,
1-d, ``target_shape``, an ``adj`` that torch's output_padding cannot
take), _contrib_SyncBatchNorm, the regression, SVM and KL-sparsity
outputs with their own backward, SpatialTransformer, ROIPooling (ROIs
that round, overlap the edge and fall outside), CTCLoss (both blank
conventions, padded labels, lengths) and RNN (every mode, 2 layers,
bidirectional, given and zero states). rrelu in training is checked by
its properties: torch's and JAX's streams never agree. The Gluon layers
over these ops are in ``test_torch_nn_layers_rest.py``.

Tolerances: fp32 at rtol 1e-5 with an atol of 1e-5 times the largest
magnitude of the reference (CTCLoss and RNN: 1e-4, a recursion of 8 to 9
steps)."""

import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.nn import rnn_param_size as jax_rnn_param_size

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops.nn import rnn_param_size
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def U(shape, seed, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape), np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


X = U((2, 4, 5, 5), 1)
CTC_DATA = U((9, 3, 6), 2, -2, 2)
# blank "first": classes 1..5, padded by 0 and -1
CTC_FIRST = np.array([[1, 2, 2, 0], [3, 5, -1, -1], [4, 0, 0, 0]],
                     np.float32)
# blank "last": classes 0..4, padded by -1
CTC_LAST = np.array([[1, 1, 0, 4], [3, 4, -1, -1], [0, -1, -1, -1]],
                    np.float32)
ROIS = np.array([[0, 0.4, 0.6, 3.5, 4.4], [1, 1.0, 0.0, 4.0, 2.0],
                 [0, 3.0, 3.0, 9.0, 9.0], [1, 7.0, 7.0, 9.0, 9.0]],
                np.float32)


def _rnn_case(mode, layers, bidir, state, seed):
    seq, batch, isz, hsz = 5, 2, 3, 4
    d = 2 if bidir else 1
    n = rnn_param_size(mode, layers, isz, hsz, bidir)
    assert n == jax_rnn_param_size(mode, layers, isz, hsz, bidir)
    inputs = [("data", U((seq, batch, isz), seed)),
              ("parameters", U((n,), seed + 1, -0.5, 0.5))]
    if state:
        inputs.append(("state", U((layers * d, batch, hsz), seed + 2)))
        if mode == "lstm":
            inputs.append(("state_cell", U((layers * d, batch, hsz),
                                           seed + 3)))
    return ("RNN", inputs, dict(state_size=hsz, num_layers=layers,
                                mode=mode, bidirectional=bidir,
                                state_outputs=True), 1e-4)


# id -> (op, [(input name, value)], attrs, rtol); labels, ROIs and
# lengths are not differentiated
CASES = {
    "leaky": ("LeakyReLU", [("data", X)], dict(act_type="leaky", slope=0.2)),
    "prelu": ("LeakyReLU", [("data", X), ("gamma", U((4,), 3, 0, 0.5))],
              dict(act_type="prelu")),
    "elu": ("LeakyReLU", [("data", X)], dict(act_type="elu", slope=0.7)),
    "selu": ("LeakyReLU", [("data", X)], dict(act_type="selu")),
    "gelu": ("LeakyReLU", [("data", X)], dict(act_type="gelu")),
    "rrelu_inference": ("LeakyReLU", [("data", X)], dict(act_type="rrelu")),
    "layer_norm": ("LayerNorm", [("data", X), ("gamma", U((5,), 4)),
                                 ("beta", U((5,), 5))], dict(eps=1e-5)),
    "layer_norm_axis1": ("LayerNorm", [("data", X), ("gamma", U((4,), 4)),
                                       ("beta", U((4,), 5))], dict(axis=1)),
    "group_norm": ("GroupNorm", [("data", X), ("gamma", U((4,), 4)),
                                 ("beta", U((4,), 5))], dict(num_groups=2)),
    "instance_norm": ("InstanceNorm", [("data", X), ("gamma", U((4,), 4)),
                                       ("beta", U((4,), 5))], dict()),
    "lrn": ("LRN", [("data", X)], dict(nsize=3, alpha=0.1, beta=0.75,
                                       knorm=1.5)),
    "deconv": ("Deconvolution", [("data", X),
                                 ("weight", U((4, 3, 4, 4), 6)),
                                 ("bias", U((3,), 7))],
               dict(kernel=(4, 4), num_filter=3, stride=(2, 2), pad=(1, 1),
                    no_bias=False)),
    "deconv_grouped": ("Deconvolution", [("data", X),
                                         ("weight", U((4, 3, 3, 3), 6))],
                       dict(kernel=(3, 3), num_filter=6, num_group=2,
                            stride=(2, 1), pad=(1, 0), adj=(1, 0))),
    "deconv_dilated": ("Deconvolution", [("data", X),
                                         ("weight", U((4, 2, 3, 3), 6))],
                       dict(kernel=(3, 3), num_filter=2, dilate=(2, 2),
                            pad=(1, 2))),
    "deconv_target_shape": ("Deconvolution",
                            [("data", X), ("weight", U((4, 2, 3, 3), 6))],
                            dict(kernel=(3, 3), num_filter=2, stride=(2, 2),
                                 target_shape=(10, 9))),
    "deconv_adj_over_stride": ("Deconvolution",
                               [("data", X), ("weight", U((4, 2, 3, 3), 6))],
                               dict(kernel=(3, 3), num_filter=2, pad=(1, 2),
                                    adj=(1, 2))),
    "deconv_1d": ("Deconvolution", [("data", U((2, 3, 6), 8)),
                                    ("weight", U((3, 2, 3), 9))],
                  dict(kernel=(3,), num_filter=2, stride=(3,))),
    "sync_batch_norm": ("_contrib_SyncBatchNorm",
                        [("data", X), ("gamma", U((4,), 4, 0.5, 1.5)),
                         ("beta", U((4,), 5)),
                         ("moving_mean", U((4,), 10, -0.1, 0.1)),
                         ("moving_var", U((4,), 11, 0.5, 1.5))],
                        dict(fix_gamma=False, output_mean_var=True)),
    "svm_l2": ("SVMOutput", [("data", U((4, 5), 12)),
                             ("label", np.array([0, 3, 4, 1], np.float32))],
               dict(margin=0.8, regularization_coefficient=0.5)),
    "svm_l1": ("SVMOutput", [("data", U((4, 5), 12)),
                             ("label", np.array([2, 3, 0, 0], np.float32))],
               dict(use_linear=True)),
    "kl_sparse_reg": ("IdentityAttachKLSparseReg",
                      [("data", U((4, 5), 13, 0.05, 0.95))],
                      dict(sparseness_target=0.2, penalty=0.01)),
    "linear_regression": ("LinearRegressionOutput",
                          [("data", U((4, 3), 14)), ("label", U((4, 3), 15))],
                          dict(grad_scale=0.5)),
    "mae_regression": ("MAERegressionOutput",
                       [("data", U((4, 3), 14)), ("label", U((4, 3), 15))],
                       dict(grad_scale=2.0)),
    "logistic_regression": ("LogisticRegressionOutput",
                            [("data", U((4, 3), 14)),
                             ("label", U((4, 3), 15, 0, 1))], dict()),
    "spatial_transformer": ("SpatialTransformer",
                            [("data", U((2, 3, 6, 6), 16)),
                             # no tap lands on the image's edge, where
                             # the sampler's gradient jumps
                             ("loc", np.array([[0.9, 0.1, 0.05, -0.1, 1.1,
                                                0.03],
                                               [1.13, 0.02, -0.17, 0.07,
                                                0.83, 0.11]], np.float32))],
                            dict(target_shape=(5, 4))),
    "roi_pooling": ("ROIPooling", [("data", U((2, 3, 8, 8), 17)),
                                   ("rois", ROIS)],
                    dict(pooled_size=(2, 3), spatial_scale=0.8)),
    "ctc_blank_first": ("CTCLoss", [("data", CTC_DATA),
                                    ("label", CTC_FIRST)], dict()),
    "ctc_blank_last": ("CTCLoss", [("data", CTC_DATA), ("label", CTC_LAST)],
                       dict(blank_label="last")),
    "ctc_lengths": ("ctc_loss", [("data", CTC_DATA), ("label", CTC_LAST),
                                 ("data_lengths", np.array([9, 6, 7],
                                                           np.float32)),
                                 ("label_lengths", np.array([4, 2, 1],
                                                            np.float32))],
                    dict(use_data_lengths=True, use_label_lengths=True,
                         blank_label="last")),
}
CASES["rnn_lstm_bidir"] = _rnn_case("lstm", 2, True, False, 20)
CASES["rnn_gru_bidir"] = _rnn_case("gru", 2, True, True, 30)
CASES["rnn_tanh"] = _rnn_case("rnn_tanh", 2, False, True, 40)
CASES["rnn_relu"] = _rnn_case("rnn_relu", 1, True, False, 50)
CASES["rnn_lstm_state"] = _rnn_case("lstm", 1, False, True, 60)

NOT_DIFFERENTIATED = ("label", "rois", "data_lengths", "label_lengths",
                      "moving_mean", "moving_var")


def _run(nd, ag, name, inputs, attrs, train=True):
    """(outputs, {input: gradient}) as numpy, output 0 seeded with a
    uniform head gradient."""
    arrs = {k: nd.array(v) for k, v in inputs}
    for k, a in arrs.items():
        if k not in NOT_DIFFERENTIATED:
            a.attach_grad()
    with ag.record(train_mode=train):
        out = getattr(nd, name)(**arrs, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    outs[0].backward(nd.array(U(outs[0].shape, 99, 0.5, 1.5)))
    return ([o.asnumpy().astype(np.float64) for o in outs],
            {k: a.grad.asnumpy().astype(np.float64)
             for k, a in arrs.items() if k not in NOT_DIFFERENTIATED})


def _close(got, want, rtol, what):
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    spec = CASES[case]
    name, inputs, attrs = spec[:3]
    rtol = spec[3] if len(spec) > 3 else 1e-5
    if name in ("CTCLoss", "ctc_loss"):
        rtol = 1e-4
    train = case != "rrelu_inference"
    jouts, jgrads = _run(jnd, jag, name, inputs, attrs, train)
    touts, tgrads = _run(tnd, tag, name, inputs, attrs, train)
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert np.all(np.isfinite(t)), case
        _close(t, j, rtol, "%s output %d" % (case, k))
    for k in jgrads:
        t, j = tgrads[k], jgrads[k]
        assert np.all(np.isfinite(t)), case
        if name in ("CTCLoss", "ctc_loss"):
            # JAX's CTC gradient is NaN on frames holding a dead lattice
            # position (its log(0)); the port's is finite there and is
            # held against torch's CTC in test_ctc_gradient_*
            t, j = t[np.isfinite(j)], j[np.isfinite(j)]
        _close(t, j, rtol, "%s gradient of %s" % (case, k))


@pytest.mark.parametrize("case", ["ctc_blank_first", "ctc_blank_last",
                                  "ctc_lengths"])
def test_ctc_gradient_is_finite_and_matches_torch_ctc(case):
    """The whole CTC gradient, JAX's NaN frames included, against torch's
    own CTC (``F.ctc_loss``, an independent implementation) in float64."""
    import torch
    import torch.nn.functional as F
    name, inputs, attrs = CASES[case]
    touts, tgrads = _run(tnd, tag, name, inputs, attrs)
    inp = dict(inputs)
    blank = 0 if attrs.get("blank_label", "first") == "first" \
        else inp["data"].shape[2] - 1
    lab = torch.tensor(inp["label"]).long()
    lens = torch.tensor(inp["label_lengths"]).long() \
        if "label_lengths" in inp else ((lab != blank) & (lab >= 0)).sum(1)
    steps = torch.tensor(inp["data_lengths"]).long() \
        if "data_lengths" in inp else \
        torch.full((lab.shape[0],), inp["data"].shape[0])
    data = torch.tensor(inp["data"], dtype=torch.float64, requires_grad=True)
    loss = F.ctc_loss(torch.log_softmax(data, -1), lab.clamp(min=0), steps,
                      lens, blank=blank, reduction="none")
    loss.backward(torch.tensor(U(tuple(loss.shape), 99, 0.5, 1.5),
                               dtype=torch.float64))
    _close(touts[0], loss.detach().numpy(), 1e-5, case + " loss")
    _close(tgrads["data"], data.grad.numpy(), 1e-5, case + " gradient")
    jgrad = _run(jnd, jag, name, inputs, attrs)[1]["data"]
    assert np.isnan(jgrad).any(), "JAX's CTC gradient became finite"


def test_sync_batch_norm_in_inference_matches_jax():
    _, inputs, attrs = CASES["sync_batch_norm"]
    jouts, jgrads = _run(jnd, jag, "_contrib_SyncBatchNorm", inputs, attrs,
                         train=False)
    touts, tgrads = _run(tnd, tag, "_contrib_SyncBatchNorm", inputs, attrs,
                         train=False)
    for t, j in zip(touts, jouts):
        _close(t, j, 1e-5, "inference output")
    for k in jgrads:
        _close(tgrads[k], jgrads[k], 1e-5, "inference gradient " + k)


def test_rrelu_in_training_draws_slopes_within_its_bounds():
    x = -np.abs(U((64, 64), 5)) - 0.1
    mt.random.seed(4)
    with tag.record(train_mode=True):
        y = tnd.LeakyReLU(tnd.array(x), act_type="rrelu", lower_bound=0.1,
                          upper_bound=0.3).asnumpy()
    slopes = y / x
    assert 0.1 <= slopes.min() and slopes.max() < 0.3
    assert abs(slopes.mean() - 0.2) < 0.01 and slopes.std() > 0.05
    mt.random.seed(4)
    with tag.record(train_mode=True):
        again = tnd.LeakyReLU(tnd.array(x), act_type="rrelu",
                              lower_bound=0.1, upper_bound=0.3).asnumpy()
    np.testing.assert_array_equal(y, again)
    with tag.record(train_mode=False):
        infer = tnd.LeakyReLU(tnd.array(x), act_type="rrelu",
                              lower_bound=0.1, upper_bound=0.3).asnumpy()
    np.testing.assert_allclose(infer, 0.2 * x, rtol=1e-6)


def test_rnn_dropout_between_layers_draws_from_the_generator():
    _, inputs, attrs, _ = CASES["rnn_tanh"]
    arrs = {k: tnd.array(v) for k, v in inputs}
    outs = []
    for seed in (5, 5, 6):
        mt.random.seed(seed)
        with tag.record(train_mode=True):
            outs.append(tnd.RNN(p=0.5, **arrs, **attrs)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    with tag.record(train_mode=False):
        plain = tnd.RNN(p=0.5, **arrs, **attrs)[0].asnumpy()
    jplain = jnd.RNN(**{k: jnd.array(v) for k, v in inputs}, p=0.5,
                     **attrs)[0].asnumpy()
    np.testing.assert_allclose(plain, jplain, rtol=1e-4, atol=1e-4)


def test_deconvolution_refuses_a_target_beyond_its_reach():
    arrs = [tnd.array(X), tnd.array(U((4, 2, 3, 3), 6))]
    with pytest.raises(ValueError, match="too big target shape"):
        tnd.Deconvolution(*arrs, kernel=(3, 3), num_filter=2,
                          target_shape=(9, 9))


def test_sync_batch_norm_refuses_a_larger_world(monkeypatch):
    """Across ranks the statistics and their gradients are the global
    batch's. A world of two ranks that hold the same rows is emulated in
    one process (an all-reduce doubles its tensor): the output and the
    batch statistics are BatchNorm's over the two copies concatenated,
    within 1e-5, and the data's gradient is the gradient of the global
    loss (both ranks' sums) with respect to one copy. A real 4-rank world
    is tests/test_torch_kvstore_world.py's."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch.ops import nn as tnn
    _, inputs, attrs = CASES["sync_batch_norm"]
    arrs = {k: torch.from_numpy(v) for k, v in inputs}
    dy = torch.from_numpy(U(tuple(arrs["data"].shape), 12))

    def both(x, g, b, sync):
        fn = tnn.sync_batch_norm if sync else tnn.batch_norm
        return fn(x, g, b, arrs["moving_mean"], arrs["moving_var"],
                  fix_gamma=False, is_train=True)

    x1, g1, b1 = (arrs[k].clone().requires_grad_(True)
                  for k in ("data", "gamma", "beta"))
    xa, xb, g2, b2 = (t.clone().requires_grad_(True)
                      for t in (arrs["data"], arrs["data"], arrs["gamma"],
                                arrs["beta"]))
    out2, mean2, var2 = both(torch.cat([xa, xb]), g2, b2, False)
    (out2 * torch.cat([dy, dy])).sum().backward()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: t.mul_(2))
    out1, mean1, var1 = both(x1, g1, b1, True)
    (out1 * dy).sum().backward()
    n = arrs["data"].shape[0]
    for got, want, what in ((out1, out2[:n], "output"),
                            (mean1, mean2, "batch mean"),
                            (var1, var2, "batch variance"),
                            (x1.grad, xa.grad, "data gradient"),
                            (g1.grad * 2, g2.grad, "gamma gradient"),
                            (b1.grad * 2, b2.grad, "beta gradient")):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
