"""The port's ``gluon.contrib.rnn`` (``LSTMPCell``,
``VariationalDropoutCell`` and the convolutional RNN, LSTM and GRU cells)
against the JAX package's, case for case with the recurrent tests of
``tests/test_gluon_contrib.py``: the same parameters and inputs give
outputs and states within fp32 atol 1e-5 / rtol 1e-4. The variational
mask comes from the port's own stream and is held by its property: one
mask for every step."""

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from _torch_gluon_pair import PKGS, both, close, inputs, pair
from _torch_gluon_pair import on_cpu  # noqa: F401 (autouse)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("cell_cls,dims,nstates", [
    ("Conv1DRNNCell", 1, 1), ("Conv2DRNNCell", 2, 1),
    ("Conv1DLSTMCell", 1, 2), ("Conv2DLSTMCell", 2, 2),
    ("Conv2DGRUCell", 2, 1), ("Conv3DLSTMCell", 3, 2),
])
def test_conv_rnn_cells(cell_cls, dims, nstates):
    spatial = (6, 6, 6)[:dims]
    (x,) = inputs((2, 3, 3) + spatial)
    blocks = pair(lambda mx: getattr(mx.gluon.contrib.rnn, cell_cls)(
        input_shape=(3,) + spatial, hidden_channels=5, i2h_kernel=3,
        h2h_kernel=3, i2h_pad=1, prefix="conv_"), scale=0.2)

    def run(mx, cell):
        outputs, states = cell.unroll(3, mx.nd.array(x), layout="NTC",
                                      merge_outputs=True)
        assert outputs.shape == (2, 3, 5) + spatial
        assert len(states) == nstates
        assert all(s.shape == (2, 5) + spatial for s in states)
        return [outputs, states]

    both(blocks, run)



def test_conv_lstm_gate_math():
    """ConvLSTM with 1x1 kernels over 1x1 spatial is the dense LSTMCell."""
    rng = np.random.RandomState(0)
    H = 4
    wi = rng.randn(4 * H, 3).astype(np.float32) * 0.5
    wh = rng.randn(4 * H, H).astype(np.float32) * 0.5
    x = rng.randn(2, 3).astype(np.float32)
    got = {}
    for key, mx in PKGS:
        conv = mx.gluon.contrib.rnn.Conv1DLSTMCell(
            input_shape=(3, 1), hidden_channels=H, i2h_kernel=1,
            h2h_kernel=1)
        dense = mx.gluon.rnn.LSTMCell(H, input_size=3)
        conv.initialize()
        dense.initialize()
        conv.i2h_weight.set_data(mx.nd.array(wi.reshape(4 * H, 3, 1)))
        conv.h2h_weight.set_data(mx.nd.array(wh.reshape(4 * H, H, 1)))
        dense.i2h_weight.set_data(mx.nd.array(wi))
        dense.h2h_weight.set_data(mx.nd.array(wh))
        out_d, _ = dense(mx.nd.array(x), [mx.nd.zeros((2, H)),
                                          mx.nd.zeros((2, H))])
        out_c, _ = conv(mx.nd.array(x).reshape((2, 3, 1)),
                        [mx.nd.zeros((2, H, 1)), mx.nd.zeros((2, H, 1))])
        close(out_c.asnumpy()[..., 0], out_d.asnumpy())
        got[key] = out_c.asnumpy()
    close(got["port"], got["jax"])



def test_lstmp_cell():
    x1, seq = inputs((4, 6), (2, 5, 6))
    blocks = pair(lambda mx: mx.gluon.contrib.rnn.LSTMPCell(
        8, 3, input_size=6, prefix="p_"))

    def run(mx, cell):
        out, states = cell(mx.nd.array(x1), cell.begin_state(batch_size=4))
        assert out.shape == (4, 3)
        assert [s.shape for s in states] == [(4, 3), (4, 8)]
        o, st = cell.unroll(5, mx.nd.array(seq), merge_outputs=True)
        assert o.shape == (2, 5, 3)
        return [out, states, o, st]

    both(blocks, run)



def test_variational_dropout_shares_mask_across_steps():
    (x,) = inputs((2, 4, 6))
    base = mt.gluon.rnn.RNNCell(6, input_size=6, prefix="v_")
    vd = mt.gluon.contrib.rnn.VariationalDropoutCell(base, drop_outputs=0.5)
    vd.initialize()
    with mt.autograd.record(train_mode=True):
        out, _ = vd.unroll(4, mt.nd.array(x), merge_outputs=False)
    zeros = [set(map(tuple, np.argwhere(o.asnumpy() == 0))) for o in out]
    assert zeros[0] == zeros[1] == zeros[2] == zeros[3] and zeros[0]
    # outside training it is the base cell, as in JAX
    blocks = pair(lambda mx: mx.gluon.contrib.rnn.VariationalDropoutCell(
        mx.gluon.rnn.RNNCell(6, input_size=6, prefix="v_"),
        drop_inputs=0.3, drop_states=0.3, drop_outputs=0.5))
    both(blocks, lambda mx, c: c.unroll(4, mx.nd.array(x),
                                         merge_outputs=True))
