"""The port's Gluon recurrent cells (``gluon.rnn``'s ``RNNCell``,
``LSTMCell``, ``GRUCell``, the sequential stacks, the modifier cells and
``BidirectionalCell``, and ``unroll`` with ``valid_length`` through
``SequenceMask``/``SequenceReverse``) against the JAX package's, case for
case with ``tests/test_rnn.py``'s cell tests: each block is built in both
packages under one explicit prefix, every parameter is set to the same
seeded values, and the same seeded inputs give outputs and states within
fp32 atol 1e-5 / rtol 1e-4 (the parameter names exactly). Dropout and
zoneout masks come from each package's own stream: outside training
they are the identity in both, in training the port's are held by their
properties. The fused layers are ``test_torch_gluon_rnn_layer.py``'s,
``gluon.contrib.rnn`` ``test_torch_gluon_contrib_rnn.py``'s."""

import numpy as np

import mxnet_tpu_torch as mt
from _torch_gluon_pair import PKGS, both, close, inputs, pair
from _torch_gluon_pair import on_cpu  # noqa: F401 (autouse)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_rnn_cell_step_and_unroll():
    x1, seq = inputs((2, 4), (2, 5, 4))
    blocks = pair(lambda mx: mx.gluon.rnn.RNNCell(8, input_size=4,
                                                   prefix="rnn_"))

    def run(mx, cell):
        out, st = cell(mx.nd.array(x1), cell.begin_state(batch_size=2))
        outs, st2 = cell.unroll(5, mx.nd.array(seq), layout="NTC",
                                merge_outputs=True)
        assert out.shape == (2, 8) and len(st) == 1
        assert outs.shape == (2, 5, 8)
        return [out, st, outs, st2]

    both(blocks, run)



def test_lstm_cell_state_shapes():
    (x,) = inputs((3, 4))
    blocks = pair(lambda mx: mx.gluon.rnn.LSTMCell(8, input_size=4,
                                                    prefix="lstm_"))

    def run(mx, cell):
        out, st = cell(mx.nd.array(x), cell.begin_state(batch_size=3))
        assert out.shape == (3, 8)
        assert [s.shape for s in st] == [(3, 8), (3, 8)]
        return [out, st]

    both(blocks, run)



def test_sequential_and_bidirectional():
    (seq,) = inputs((2, 5, 4))

    def stack(mx):
        s = mx.gluon.rnn.SequentialRNNCell(prefix="stack_")
        s.add(mx.gluon.rnn.GRUCell(8, input_size=4, prefix="gru_"))
        s.add(mx.gluon.rnn.RNNCell(6, input_size=8, prefix="rnn_"))
        return s

    def bi(mx):
        return mx.gluon.rnn.BidirectionalCell(
            mx.gluon.rnn.LSTMCell(4, input_size=4, prefix="l_"),
            mx.gluon.rnn.LSTMCell(4, input_size=4, prefix="r_"))

    for make, width in ((stack, 6), (bi, 8)):
        def run(mx, cell):
            outs, st = cell.unroll(5, mx.nd.array(seq), layout="NTC",
                                   merge_outputs=True)
            assert outs.shape == (2, 5, width)
            return [outs, st]

        both(pair(make), run)



def test_modifier_cells():
    (seq,) = inputs((2, 5, 8))
    blocks = pair(lambda mx: mx.gluon.rnn.ResidualCell(
        mx.gluon.rnn.GRUCell(8, input_size=8, prefix="gru_")))

    def run(mx, cell):
        outs, st = cell.unroll(5, mx.nd.array(seq), layout="NTC",
                               merge_outputs=True)
        assert outs.shape == (2, 5, 8)
        return [outs, st]

    both(blocks, run)
    # DropoutCell: the identity outside training, in both packages
    for _, mx in PKGS:
        out, st = mx.gluon.rnn.DropoutCell(0.5)(mx.nd.array(seq), [])
        assert out.shape == seq.shape and st == []
        np.testing.assert_array_equal(out.asnumpy(), seq)
    # in training the port's mask keeps about half, scaled by 2
    with mt.autograd.record():
        out, _ = mt.gluon.rnn.DropoutCell(0.5)(mt.nd.ones((64, 64)), [])
    vals = out.asnumpy()
    assert set(np.unique(vals)) <= {0.0, 2.0}
    assert 0.4 < (vals == 2.0).mean() < 0.6



def test_bidirectional_valid_length():
    """The reverse cell must not see padding before real tokens: a short
    sample's outputs do not depend on its padding, and agree with JAX's
    (the unroll runs through SequenceMask and SequenceReverse)."""
    base = np.random.RandomState(2).rand(2, 4, 3).astype(np.float32)
    pad_b = base.copy()
    pad_b[0, 2:] = 99.0  # sample 0 valid_length=2; alter only its padding

    def make(mx):
        return mx.gluon.rnn.BidirectionalCell(
            mx.gluon.rnn.LSTMCell(4, input_size=3, prefix="l_"),
            mx.gluon.rnn.LSTMCell(4, input_size=3, prefix="r_"))

    blocks = pair(make)

    def run(mx, bi):
        res = []
        for arr in (base, pad_b):
            outs, st = bi.unroll(4, mx.nd.array(arr), layout="NTC",
                                 merge_outputs=True,
                                 valid_length=mx.nd.array([2, 4]))
            res.append(outs.asnumpy())
        close(res[0][0, :2], res[1][0, :2])
        return res[0]

    both(blocks, run)



def test_unroll_valid_length_masks_outputs_and_states():
    (seq,) = inputs((3, 5, 4))
    blocks = pair(lambda mx: mx.gluon.rnn.GRUCell(6, input_size=4,
                                                   prefix="g_"))

    def run(mx, cell):
        outs, st = cell.unroll(5, mx.nd.array(seq), layout="NTC",
                               merge_outputs=True,
                               valid_length=mx.nd.array([1, 5, 3]))
        # past a sample's length its outputs are zero
        np.testing.assert_array_equal(outs.asnumpy()[0, 1:], 0.0)
        return [outs, st]

    both(blocks, run)



def test_hybrid_sequential_and_zoneout_inference():
    (seq,) = inputs((2, 4, 5))

    def make(mx):
        s = mx.gluon.rnn.HybridSequentialRNNCell(prefix="hs_")
        s.add(mx.gluon.rnn.ZoneoutCell(
            mx.gluon.rnn.LSTMCell(6, input_size=5, prefix="a_"),
            zoneout_outputs=0.3, zoneout_states=0.2))
        s.add(mx.gluon.rnn.ResidualCell(
            mx.gluon.rnn.RNNCell(6, input_size=6, prefix="b_")))
        return s

    blocks = pair(make)

    def run(mx, cell):
        cell.hybridize()
        outs, st = cell.unroll(4, mx.nd.array(seq), layout="NTC",
                               merge_outputs=True)
        return [outs, st]

    both(blocks, run)
    # in training the zoneout keeps some of the previous output
    cell = blocks["port"]
    with mt.autograd.record():
        zo, _ = cell.unroll(4, mt.nd.array(seq), layout="NTC",
                            merge_outputs=True)
    assert zo.shape == (2, 4, 6) and np.isfinite(zo.asnumpy()).all()
