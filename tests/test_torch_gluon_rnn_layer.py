"""The port's fused Gluon recurrent layers (``gluon.rnn``'s ``RNN``,
``LSTM``, ``GRU``) against the JAX package's, case for case with
``tests/test_rnn.py``'s layer tests: the same parameters and inputs give
outputs and every gradient within fp32 atol 1e-5 / rtol 1e-4, eager and
hybridized (through ``cached_op``), and the fused LSTM equals the
unrolled ``LSTMCell``. Training, files and dropout are
``test_torch_gluon_rnn_train.py``'s."""

import numpy as np
import pytest

from _torch_gluon_pair import PKGS, both, close, inputs, pair
from _torch_gluon_pair import on_cpu  # noqa: F401 (autouse)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("layer,kw", [("LSTM", {}), ("GRU", {}),
                                      ("RNN", {"activation": "tanh"})])
def test_fused_layer_shapes_and_grads(layer, kw):
    (seq,) = inputs((2, 5, 4))
    blocks = pair(lambda mx: getattr(mx.gluon.rnn, layer)(
        16, num_layers=2, layout="NTC", bidirectional=True, input_size=4,
        prefix="fused_", **kw), scale=0.3)

    def run(mx, net):
        x = mx.nd.array(seq)
        with mx.autograd.record():
            y = net(x)
            loss = (y * y).sum()
        loss.backward()
        assert y.shape == (2, 5, 32)
        grads = [p.grad() for p in net.collect_params().values()]
        assert float(np.abs(net.l0_i2h_weight.grad().asnumpy()).sum()) > 0
        return [y] + grads

    both(blocks, run)


def test_fused_lstm_matches_cell_unroll():
    (seq,) = inputs((2, 5, 4))
    for key, mx in PKGS:
        cell = mx.gluon.rnn.LSTMCell(8, input_size=4, prefix="c_")
        cell.initialize()
        fused = mx.gluon.rnn.LSTM(8, layout="NTC", input_size=4,
                                  prefix="f_")
        fused.initialize()
        fused.l0_i2h_weight.set_data(cell.i2h_weight.data())
        fused.l0_h2h_weight.set_data(cell.h2h_weight.data())
        fused.l0_i2h_bias.set_data(cell.i2h_bias.data())
        fused.l0_h2h_bias.set_data(cell.h2h_bias.data())
        co, _ = cell.unroll(5, mx.nd.array(seq), layout="NTC",
                            merge_outputs=True)
        close(fused(mx.nd.array(seq)).asnumpy(), co.asnumpy())
    blocks = pair(lambda mx: mx.gluon.rnn.LSTM(8, layout="NTC",
                                                input_size=4, prefix="f_"))
    both(blocks, lambda mx, net: net(mx.nd.array(seq)))


def test_fused_layer_hybridize_and_explicit_state():
    (seq,) = inputs((2, 5, 4))
    blocks = pair(lambda mx: mx.gluon.rnn.LSTM(8, layout="NTC",
                                                input_size=4, prefix="h_"))

    def run(mx, layer):
        eager = layer(mx.nd.array(seq))
        layer.hybridize()
        hybrid = layer(mx.nd.array(seq))
        close(hybrid.asnumpy(), eager.asnumpy())
        out, states = layer(mx.nd.array(seq), layer.begin_state(batch_size=2))
        assert out.shape == (2, 5, 8)
        assert [s.shape for s in states] == [(1, 2, 8), (1, 2, 8)]
        return [hybrid, out, states]

    both(blocks, run)
