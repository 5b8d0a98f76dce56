"""Gluon fused recurrent layers: RNN, LSTM, GRU (port of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; reference:
python/mxnet/gluon/rnn/rnn_layer.py:278-280).

A layer concatenates its per-layer i2h/h2h parameters (the names
``l0_i2h_weight`` ... ``r0_h2h_bias``, as in the JAX package, so a
``.params`` file loads in either) into the flat fused-RNN parameter
vector and calls the ``RNN`` op (ops/nn.py: a Python loop over time of
torch matmuls). Called without states, the op makes zero states on the
input's device; ``begin_state`` makes them on ``ctx`` (a keyword it
passes to ``func``), else on the current context.
"""

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super(_RNNLayer, self).__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][: self._dir]:
                self._register_param(
                    "%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                    i2h_weight_initializer)
                self._register_param(
                    "%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                    h2h_weight_initializer)
                self._register_param(
                    "%s%d_i2h_bias" % (j, i), (ng * nh,),
                    i2h_bias_initializer)
                self._register_param(
                    "%s%d_h2h_bias" % (j, i), (ng * nh,),
                    h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def _deferred_infer_shape(self, *args):
        """Shape inference can't run backward through the flat-param
        concat, so fill the per-layer weight shapes straight from the
        input's channel dim."""
        inputs = args[0]
        input_size = inputs.shape[-1]
        self._input_size = input_size
        ng, nh = self._gates, self._hidden_size
        ni = input_size
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                getattr(self, "%s%d_i2h_weight" % (j, i)).shape = \
                    (ng * nh, ni)
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        # states=None -> the fused RNN op synthesizes zero initial states
        # (no batch-size constant baked into hybridized graphs)
        skip_states = states is None
        if not skip_states and isinstance(states, type(inputs)):
            states = [states]
        out = self._forward_kernel(F, inputs, states, **kwargs)
        return out[0] if skip_states else out

    def _flat_params(self, F, kwargs):
        order = []
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                order.append(kwargs["%s%d_i2h_weight" % (j, i)])
                order.append(kwargs["%s%d_h2h_weight" % (j, i)])
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                order.append(kwargs["%s%d_i2h_bias" % (j, i)])
                order.append(kwargs["%s%d_h2h_bias" % (j, i)])
        flat = [F.reshape(p, shape=(-1,)) for p in order]
        if len(flat) == 1:
            return flat[0]
        return F.concat(*flat, dim=0)

    def _forward_kernel(self, F, inputs, states, **kwargs):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        params = self._flat_params(F, kwargs)
        rnn_args = states if states is not None else []
        rnn = F.RNN(inputs, params, *rnn_args,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, bidirectional=self._dir == 2,
                    p=self._dropout, state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or ReLU."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super(RNN, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer,
            "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super(LSTM, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super(GRU, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
