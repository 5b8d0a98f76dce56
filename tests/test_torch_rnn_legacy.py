"""The port's legacy symbolic RNN package (``mxnet_tpu_torch.rnn``: the
cells, ``FusedRNNCell``, the modifiers, ``BucketSentenceIter``,
``encode_sentences`` and the rnn checkpoints) against the JAX package's,
case for case with ``tests/test_rnn_legacy.py``: each unrolled graph is
bound in both packages with the same seeded inputs and parameters, and
the outputs agree at fp32 atol 1e-5 / rtol 1e-4 (the names of the
parameters and of the graph's arguments exactly). The iterator gives the
same batches from the same host seeds, and rnn-checkpoint files move
between the packages both ways."""

import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops.nn import rnn_param_size as j_rnn_param_size

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.nn import rnn_param_size as t_rnn_param_size
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-4
PKGS = (("jax", jmx), ("port", mt))


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _unroll_run(make_cell, length, input_dim, batch=2, seed=0,
                **unroll_kw):
    """The cell made by ``make_cell(mx)`` unrolled over ``length`` steps
    in each package, bound with the same seeded data and parameters;
    {pkg: (outputs, argument names, cell)}."""
    res = {}
    for key, mx in PKGS:
        cell = make_cell(mx)
        data = mx.sym.Variable("data")
        outputs, _ = cell.unroll(length, data, **unroll_kw)
        if isinstance(outputs, list):
            outputs = mx.sym.Group(outputs)
        rs = np.random.RandomState(seed)
        args = {"data": rs.rand(batch, length, input_dim).astype(
            np.float32)}
        shapes, _, _ = outputs.infer_shape(data=(batch, length, input_dim))
        for name, shp in zip(outputs.list_arguments(), shapes):
            if name != "data":
                args[name] = rs.rand(*shp).astype(np.float32) * 0.1
        ex = outputs.bind(mx.cpu(), {k: mx.nd.array(v)
                                     for k, v in args.items()})
        res[key] = ([o.asnumpy() for o in ex.forward()],
                    outputs.list_arguments(), cell)
    assert res["port"][1] == res["jax"][1]
    for g, w in zip(res["port"][0], res["jax"][0]):
        _close(g, w)
    return res


def test_rnn_cell_unroll_shapes():
    res = _unroll_run(lambda mx: mx.rnn.RNNCell(num_hidden=8,
                                                prefix="rnn_"), 3, 4)
    outs, _, cell = res["port"]
    assert len(outs) == 3 and outs[0].shape == (2, 8)
    assert sorted(cell.params._params) == [
        "rnn_h2h_bias", "rnn_h2h_weight", "rnn_i2h_bias", "rnn_i2h_weight"]


def test_lstm_cell_unroll_merged():
    res = _unroll_run(lambda mx: mx.rnn.LSTMCell(num_hidden=8,
                                                 prefix="lstm_"),
                      3, 4, merge_outputs=True)
    assert res["port"][0][0].shape == (2, 3, 8)


def test_gru_matches_manual_step():
    nh, ni = 3, 2
    rs = np.random.RandomState(1)
    x = rs.rand(1, 1, ni).astype(np.float32)
    cell = mt.rnn.GRUCell(num_hidden=nh, prefix="gru_")
    out = cell.unroll(1, mt.sym.Variable("data"), merge_outputs=False)[0][0]
    shapes, _, _ = out.infer_shape(data=(1, 1, ni))
    params = {name: rs.rand(*shp).astype(np.float32) * 0.3
              for name, shp in zip(out.list_arguments(), shapes)
              if name != "data"}
    got = out.bind(mt.cpu(), {"data": mt.nd.array(x), **{
        k: mt.nd.array(v) for k, v in params.items()}}).forward()[0]

    def sigmoid(v):
        return 1 / (1 + np.exp(-v))
    i2h = x[0] @ params["gru_i2h_weight"].T + params["gru_i2h_bias"]
    h0 = np.zeros((1, nh), np.float32)
    h2h = h0 @ params["gru_h2h_weight"].T + params["gru_h2h_bias"]
    ir, iz, io = np.split(i2h, 3, axis=1)
    hr, hz, ho = np.split(h2h, 3, axis=1)
    r, z = sigmoid(ir + hr), sigmoid(iz + hz)
    _close(got.asnumpy(), (1 - z) * np.tanh(io + r * ho) + z * h0)


def test_sequential_stack_and_residual():
    def make(mx):
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.LSTMCell(num_hidden=8, prefix="l0_"))
        stack.add(mx.rnn.ResidualCell(mx.rnn.GRUCell(num_hidden=8,
                                                     prefix="l1_")))
        return stack
    res = _unroll_run(make, 3, 8, merge_outputs=True)
    assert res["port"][0][0].shape == (2, 3, 8)
    assert len(res["port"][2].state_info) == 3


def test_bidirectional_concat():
    res = _unroll_run(lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(num_hidden=4, prefix="l_"),
        mx.rnn.LSTMCell(num_hidden=4, prefix="r_")), 3, 5,
        merge_outputs=True)
    assert res["port"][0][0].shape == (2, 3, 8)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_fused_cell_unroll_and_unfuse(mode):
    res = _unroll_run(lambda mx: mx.rnn.FusedRNNCell(
        num_hidden=8, num_layers=2, mode=mode, prefix="%s_" % mode), 4, 6,
        merge_outputs=True)
    assert res["port"][0][0].shape == (2, 4, 8)
    res = _unroll_run(lambda mx: mx.rnn.FusedRNNCell(
        num_hidden=8, num_layers=2, mode=mode, prefix="%s_" % mode)
        .unfuse(), 4, 6, merge_outputs=True)
    assert isinstance(res["port"][2], mt.rnn.SequentialRNNCell)


def test_fused_bidirectional_cell():
    res = _unroll_run(lambda mx: mx.rnn.FusedRNNCell(
        num_hidden=4, num_layers=2, mode="lstm", bidirectional=True,
        prefix="bi_"), 3, 5, merge_outputs=True)
    assert res["port"][0][0].shape == (2, 3, 8)


def test_pack_unpack_roundtrip():
    rs = np.random.RandomState(0)
    fused = {"lstm_i2h_weight": rs.rand(16, 5), "lstm_i2h_bias": rs.rand(16),
             "lstm_h2h_weight": rs.rand(16, 4), "lstm_h2h_bias": rs.rand(16)}
    fused = {k: v.astype(np.float32) for k, v in fused.items()}
    got = {}
    for key, mx in PKGS:
        cell = mx.rnn.LSTMCell(num_hidden=4, prefix="lstm_")
        unpacked = cell.unpack_weights({k: mx.nd.array(v)
                                        for k, v in fused.items()})
        packed = cell.pack_weights(unpacked)
        got[key] = ({k: v.asnumpy() for k, v in unpacked.items()},
                    {k: v.asnumpy() for k, v in packed.items()})
    assert sorted(got["port"][0]) == sorted(got["jax"][0])
    assert got["port"][0]["lstm_i2h_f_weight"].shape == (4, 5)
    for k, v in got["jax"][0].items():
        np.testing.assert_array_equal(got["port"][0][k], v)
    for k, v in fused.items():
        np.testing.assert_array_equal(got["port"][1][k], v)


def test_zoneout_and_dropout_cells():
    _unroll_run(lambda mx: mx.rnn.ZoneoutCell(
        mx.rnn.RNNCell(num_hidden=4, prefix="rnn_"), zoneout_outputs=0.3,
        zoneout_states=0.2), 3, 4)

    def make(mx):
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.RNNCell(num_hidden=4, prefix="a_"))
        stack.add(mx.rnn.DropoutCell(0.5))
        stack.add(mx.rnn.RNNCell(num_hidden=4, prefix="b_"))
        return stack
    res = _unroll_run(make, 2, 4, merge_outputs=True)
    assert res["port"][0][0].shape == (2, 2, 4)


def test_dropout_cell_merged_unroll_returns_symbol():
    out, states = mt.rnn.DropoutCell(0.5).unroll(
        3, mt.sym.Variable("data"), merge_outputs=True)
    assert isinstance(out, mt.sym.Symbol) and states == []


def test_zoneout_draws_masks_in_training():
    """In training, the zoneout masks keep some of the previous outputs
    (dropout of ones, drawn from the executor's generator)."""
    cell = mt.rnn.ZoneoutCell(mt.rnn.RNNCell(num_hidden=16, prefix="z_"),
                              zoneout_outputs=0.5)
    outs, _ = cell.unroll(3, mt.sym.Variable("data"), merge_outputs=True)
    ex = outs.simple_bind(mt.cpu(), data=(4, 3, 8))
    for name, arr in ex.arg_dict.items():
        arr[:] = mt.nd.array(np.random.RandomState(1).rand(*arr.shape)
                             .astype(np.float32))
    train = ex.forward(is_train=True)[0].asnumpy()
    infer = ex.forward()[0].asnumpy()
    # step 0's previous output is zero: zoned-out entries are exactly 0
    assert (train[:, 0] == 0).any() and not (infer[:, 0] == 0).any()


def test_encode_sentences_and_bucket_iter():
    sents = [["a", "b", "c"], ["a", "c"], ["b", "c", "a", "b"],
             ["c"], ["a", "b"], ["b", "c"]]
    got = {}
    for key, mx in PKGS:
        coded, vocab = mx.rnn.encode_sentences(sents, start_label=1)
        random.seed(3)
        np.random.seed(3)
        it = mx.rnn.BucketSentenceIter(coded, batch_size=2, buckets=[2, 4],
                                       invalid_label=0)
        batches = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy())
                   for b in it]
        it.reset()
        again = [b.data[0].asnumpy() for b in it]
        got[key] = (coded, vocab, it.default_bucket_key, batches, again)
        with pytest.raises(AssertionError):
            mx.rnn.encode_sentences([["zzz"]], vocab=vocab)
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][2] == 4
    for (tk, td, tl), (jk, jd, jl) in zip(got["port"][3], got["jax"][3]):
        assert tk == jk
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tl[:, :-1], td[:, 1:])
    for t, j in zip(got["port"][4], got["jax"][4]):
        np.testing.assert_array_equal(t, j)


def test_bucket_iter_empty_bucket_and_time_major():
    coded = [[1, 2], [2, 1], [1, 1], [2, 2]]
    it = mt.rnn.BucketSentenceIter(coded, batch_size=2, buckets=[2, 50],
                                   invalid_label=0)
    batches = list(it)
    assert batches and all(b.bucket_key == 2 for b in batches)
    it = mt.rnn.BucketSentenceIter(coded, batch_size=2, buckets=[2],
                                   invalid_label=0, layout="TN")
    assert next(iter(it)).data[0].shape == (2, 2)


def _lstm_checkpoint_args(mx, seed=0):
    cell = mx.rnn.LSTMCell(num_hidden=4, prefix="lstm_")
    outputs, _ = cell.unroll(2, mx.sym.Variable("data"), merge_outputs=True)
    rs = np.random.RandomState(seed)
    shapes, _, _ = outputs.infer_shape(data=(1, 2, 3))
    args = {n: rs.rand(*s).astype(np.float32)
            for n, s in zip(outputs.list_arguments(), shapes) if n != "data"}
    return cell, outputs, args


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_rnn_checkpoint_interchange(tmp_path, writer, reader):
    """save_rnn_checkpoint in one package, load_rnn_checkpoint in the
    other: the per-gate file repacks to the same arrays bitwise, and the
    symbol loads."""
    wmx, rmx = dict(PKGS)[writer], dict(PKGS)[reader]
    cell, outputs, args = _lstm_checkpoint_args(wmx)
    prefix = str(tmp_path / "model")
    wmx.rnn.save_rnn_checkpoint(cell, prefix, 1, outputs, {
        k: wmx.nd.array(v) for k, v in args.items()}, {})
    rcell = rmx.rnn.LSTMCell(num_hidden=4, prefix="lstm_")
    sym2, args2, aux2 = rmx.rnn.load_rnn_checkpoint(rcell, prefix, 1)
    assert sorted(args2) == sorted(args) and aux2 == {}
    for k, v in args.items():
        np.testing.assert_array_equal(args2[k].asnumpy(), v)
    assert sym2.list_arguments() == outputs.list_arguments()


def test_do_rnn_checkpoint_writes_unpacked_weights(tmp_path):
    cell, outputs, args = _lstm_checkpoint_args(mt)
    prefix = str(tmp_path / "cb")
    cb = mt.rnn.do_rnn_checkpoint(cell, prefix, period=2)
    nd_args = {k: mt.nd.array(v) for k, v in args.items()}
    cb(0, outputs, nd_args, {})
    cb(1, outputs, nd_args, {})
    saved = mt.nd.load("%s-0002.params" % prefix)
    assert "arg:lstm_i2h_f_weight" in saved
    assert "arg:lstm_i2h_weight" not in saved


def test_fused_begin_state_batch_axis():
    fused = mt.rnn.FusedRNNCell(num_hidden=8, num_layers=2, mode="lstm",
                                prefix="lstm_")
    states = fused.begin_state(batch_size=4)
    outs = mt.sym.Group(states).bind(mt.cpu(), {}).forward()
    assert [o.shape for o in outs] == [(2, 4, 8), (2, 4, 8)]
    assert all(o.context == mt.cpu() for o in outs)
    with pytest.raises(ValueError, match="batch_size"):
        fused.begin_state()


def test_fused_unfused_checkpoint_interchange():
    """Packed fused weights unpacked to per-gate arrays; the fused cell
    and its unfused stack give the same outputs, in both packages."""
    h, ni, T, N = 4, 3, 5, 2
    assert t_rnn_param_size("lstm", 1, ni, h) == \
        j_rnn_param_size("lstm", 1, ni, h)
    rs = np.random.RandomState(0)
    packed = rs.rand(t_rnn_param_size("lstm", 1, ni, h)).astype(
        np.float32) * 0.2
    x_np = rs.rand(N, T, ni).astype(np.float32)
    got = {}
    for key, mx in PKGS:
        fused = mx.rnn.FusedRNNCell(num_hidden=h, num_layers=1, mode="lstm",
                                    prefix="lstm_")
        unpacked = fused.unpack_weights({"lstm_parameters":
                                         mx.nd.array(packed)})
        repacked = fused.pack_weights(dict(unpacked))
        np.testing.assert_array_equal(repacked["lstm_parameters"].asnumpy(),
                                      packed)
        fo, _ = fused.unroll(T, mx.sym.Variable("data"), merge_outputs=True)
        fused_out = fo.bind(mx.cpu(), {
            "data": mx.nd.array(x_np),
            "lstm_parameters": mx.nd.array(packed)}).forward()[0].asnumpy()
        stack = fused.unfuse()
        per_cell = stack.pack_weights(dict(unpacked))
        so, _ = stack.unroll(T, mx.sym.Variable("data"), merge_outputs=True)
        args = {"data": mx.nd.array(x_np)}
        args.update({k: v for k, v in per_cell.items()
                     if k in so.list_arguments()})
        stack_out = so.bind(mx.cpu(), args).forward()[0].asnumpy()
        _close(fused_out, stack_out)
        got[key] = (fused_out, {k: v.asnumpy() for k, v in unpacked.items()})
    _close(got["port"][0], got["jax"][0])
    for k, v in got["jax"][1].items():
        np.testing.assert_array_equal(got["port"][1][k], v)


def test_fused_rnn_initializer_layout_matches_jax():
    """initializer.FusedRNN in both packages: weights in (-0.07, 0.07),
    the same zero/forget-gate bias layout, the same shape."""
    n = t_rnn_param_size("lstm", 2, 3, 4)
    got = {}
    for key, mx in PKGS:
        arr = mx.nd.zeros((n,))
        mx.init.FusedRNN(None, 4, 2, "lstm", forget_bias=2.0)._init_weight(
            mx.init.InitDesc("lstm_parameters"), arr)
        got[key] = arr.asnumpy()
    nbias = 2 * 2 * 4 * 4
    np.testing.assert_array_equal(got["port"][-nbias:], got["jax"][-nbias:])
    for v in got.values():
        assert np.abs(v[:-nbias]).max() < 0.07
