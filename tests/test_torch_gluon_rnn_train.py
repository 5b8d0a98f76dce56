"""The port's fused Gluon recurrent layers in use, against the JAX
package's: a char-level Embedding + LSTM + Dense net trains under Adam
to the same losses (``tests/test_rnn.py``'s training case) at fp32 atol
1e-5 / rtol 1e-4; a ``.params`` file moves between the packages both
ways; ``input_size`` is inferred at the first call and ``begin_state``
makes its zeros where it is told; and the dropout between layers draws a
fresh mask on every hybridized call (``tests/test_gluon.py``'s property
for ``nn.Dropout``)."""

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from _torch_gluon_pair import PKGS, close, inputs, pair
from _torch_gluon_pair import on_cpu  # noqa: F401 (autouse)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_rnn_layer_trains():
    """Char-level next-step prediction: the same Embedding + LSTM + Dense
    under Adam in both packages, the losses step for step, and falling."""
    tokens = np.random.RandomState(0).randint(0, 16, (4, 9)).astype(
        np.float32)

    def make(mx):
        net = mx.gluon.nn.Sequential(prefix="char_")
        with net.name_scope():
            net.add(mx.gluon.nn.Embedding(16, 8))
            net.add(mx.gluon.rnn.LSTM(16, layout="NTC", input_size=8))
            net.add(mx.gluon.nn.Dense(16, flatten=False, in_units=16))
        return net

    blocks = pair(make)
    losses = {}
    for key, mx in PKGS:
        net = blocks[key]
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.01})
        lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x = mx.nd.array(tokens[:, :-1])
        y = mx.nd.array(tokens[:, 1:])
        losses[key] = []
        for _ in range(10):
            with mx.autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(4)
            losses[key].append(float(loss.mean().asnumpy()))
    close(losses["port"], losses["jax"])
    assert losses["port"][-1] < losses["port"][0]


def test_hybridized_lstm_dropout_draws_fresh_masks():
    """The property of tests/test_gluon.py's dropout test for the fused
    layer: hybridized, two recorded calls draw two masks between the
    layers; outside training it is deterministic."""
    layer = mt.gluon.rnn.LSTM(32, num_layers=2, dropout=0.5, input_size=8,
                              prefix="d_")
    layer.initialize()
    layer.hybridize()
    x = mt.nd.ones((3, 4, 8))
    with mt.autograd.record():
        y1 = layer(x).asnumpy()
        y2 = layer(x).asnumpy()
    assert not np.allclose(y1, y2)
    np.testing.assert_array_equal(layer(x).asnumpy(), layer(x).asnumpy())



@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_params_file_interchange(tmp_path, writer, reader):
    """A fused layer's ``.params`` file (``l0_i2h_weight`` ...
    ``r1_h2h_bias``) saved by one package loads in the other and gives the
    same outputs."""
    (seq,) = inputs((5, 2, 4))
    wmx, rmx = dict(PKGS)[writer], dict(PKGS)[reader]
    src = wmx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True,
                             input_size=4, prefix="io_")
    src.initialize(wmx.init.Xavier())
    want = src(wmx.nd.array(seq)).asnumpy()
    path = str(tmp_path / "lstm.params")
    src.save_parameters(path)
    dst = rmx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True,
                             prefix="other_")
    dst.load_parameters(path, ctx=rmx.cpu())
    assert sorted(dst._collect_params_with_prefix()) == \
        sorted(src._collect_params_with_prefix())
    close(dst(rmx.nd.array(seq)).asnumpy(), want)


def test_deferred_input_size_and_begin_state_context():
    """``input_size`` is inferred at the first call; ``begin_state`` makes
    its zeros on the context it is given, the fused op's own zero states
    on the input's device."""
    (seq,) = inputs((5, 2, 4))
    layer = mt.gluon.rnn.GRU(6, num_layers=2, prefix="def_")
    layer.initialize()
    out = layer(mt.nd.array(seq))
    assert out.shape == (5, 2, 6)
    assert layer.l0_i2h_weight.shape == (18, 4)
    states = layer.begin_state(batch_size=2, func=mt.nd.zeros,
                               ctx=mt.cpu())
    assert [s.context for s in states] == [mt.cpu()]
    assert states[0]._data.device.type == "cpu"
