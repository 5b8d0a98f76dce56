"""Convolutional recurrent cells: ConvRNN / ConvLSTM / ConvGRU, 1D-3D
(port of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; reference:
python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py, Shi et al. 2015,
"Convolutional LSTM Network").

The gate pre-activations are convolutions over spatial feature maps
instead of dense products; the state's shape is the hidden feature map.
Gate order matches the dense cells (LSTM: i, f, g, o; GRU: r, z, n). The
gate convolutions are stacked into one Convolution per input and state
(num_filter = gates * hidden).
"""

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvRNNCellBase(HybridRecurrentCell):
    """Shared machinery: conv weights for input->hidden and
    hidden->hidden gate stacks, spatial state info."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad, dims, conv_layout, activation,
                 prefix=None, params=None):
        super(_ConvRNNCellBase, self).__init__(prefix=prefix,
                                               params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._dims = dims
        self._activation = activation
        self._conv_layout = conv_layout
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "h2h_kernel dims must be odd to preserve the state's "
                    "spatial shape, got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._h2h_pad = tuple((k - 1) // 2 for k in self._h2h_kernel)
        in_ch = self._input_shape[0]
        ngates = self._num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(ngates * hidden_channels, in_ch) + self._i2h_kernel,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(ngates * hidden_channels, hidden_channels) +
            self._h2h_kernel,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ngates * hidden_channels,), init="zeros",
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ngates * hidden_channels,), init="zeros",
            allow_deferred_init=True)

    def _spatial_out(self):
        # i2h conv output spatial dims (stride 1): s + 2p - k + 1
        return tuple(s + 2 * p - k + 1 for s, p, k in
                     zip(self._input_shape[1:], self._i2h_pad,
                         self._i2h_kernel))

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._spatial_out()
        return [{"shape": shape, "__layout__": self._conv_layout}] * \
            self._num_states

    def _conv_gates(self, F, inputs, state, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias, prefix):
        n_out = self._num_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=n_out, name=prefix + "i2h")
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=n_out, name=prefix + "h2h")
        return i2h, h2h


class _ConvRNNCell(_ConvRNNCellBase):
    _num_gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias,
                                    prefix)
        out = F.Activation(i2h + h2h, act_type=self._activation,
                           name=prefix + "out")
        return out, [out]


class _ConvLSTMCell(_ConvRNNCellBase):
    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias,
                                    prefix)
        gates = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1,
                               name=prefix + "slice")
        i = F.sigmoid(gates[0])
        f = F.sigmoid(gates[1])
        g = F.Activation(gates[2], act_type=self._activation)
        o = F.sigmoid(gates[3])
        next_c = f * states[1] + i * g
        next_h = o * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvRNNCellBase):
    _num_gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias,
                                    prefix)
        i2h_g = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_g = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i2h_g[0] + h2h_g[0])
        z = F.sigmoid(i2h_g[1] + h2h_g[1])
        n = F.Activation(i2h_g[2] + r * h2h_g[2],
                         act_type=self._activation)
        next_h = (1.0 - z) * n + z * states[0]
        return next_h, [next_h]


def _make_cell(base, dims, layout, alias):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, conv_layout=layout,
                     activation="tanh", prefix=None, params=None):
            super(Cell, self).__init__(
                input_shape=input_shape,
                hidden_channels=hidden_channels, i2h_kernel=i2h_kernel,
                h2h_kernel=h2h_kernel, i2h_pad=i2h_pad, dims=dims,
                conv_layout=conv_layout, activation=activation,
                prefix=prefix, params=params)
    Cell.__name__ = alias
    Cell.__qualname__ = alias
    return Cell


Conv1DRNNCell = _make_cell(_ConvRNNCell, 1, "NCW", "Conv1DRNNCell")
Conv2DRNNCell = _make_cell(_ConvRNNCell, 2, "NCHW", "Conv2DRNNCell")
Conv3DRNNCell = _make_cell(_ConvRNNCell, 3, "NCDHW", "Conv3DRNNCell")
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, 1, "NCW", "Conv1DLSTMCell")
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, 2, "NCHW", "Conv2DLSTMCell")
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, 3, "NCDHW", "Conv3DLSTMCell")
Conv1DGRUCell = _make_cell(_ConvGRUCell, 1, "NCW", "Conv1DGRUCell")
Conv2DGRUCell = _make_cell(_ConvGRUCell, 2, "NCHW", "Conv2DGRUCell")
Conv3DGRUCell = _make_cell(_ConvGRUCell, 3, "NCDHW", "Conv3DGRUCell")
