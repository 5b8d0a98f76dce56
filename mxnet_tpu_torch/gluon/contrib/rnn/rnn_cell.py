"""Contrib fully-connected recurrent cells (port of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; reference:
gluon/contrib/rnn/rnn_cell.py — LSTMPCell, VariationalDropoutCell).
Convolutional cells live in conv_rnn_cell.py."""

from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["LSTMPCell", "VariationalDropoutCell"]


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a learned projection of the hidden state (Sak et al.
    2014; reference gluon/contrib/rnn/rnn_cell.py LSTMPCell). The cell
    state keeps hidden_size; the recurrent/emitted state is the
    projection_size-dim h2r output."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super(LSTMPCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = F.SliceChannel(i2h + h2h, num_outputs=4,
                               name=prefix + "slice")
        in_gate = F.Activation(gates[0], act_type="sigmoid")
        forget_gate = F.Activation(gates[1], act_type="sigmoid")
        in_transform = F.Activation(gates[2], act_type="tanh")
        out_gate = F.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size,
                                  name=prefix + "out")
        return next_r, [next_r, next_c]


class VariationalDropoutCell(ModifierCell):
    """Variational (recurrent) dropout (Gal & Ghahramani 2016): ONE
    dropout mask per unroll, shared across time steps, applied to
    inputs/states/outputs per the given rates (reference
    gluon/contrib/rnn/rnn_cell.py VariationalDropoutCell)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super(VariationalDropoutCell, self).__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super(VariationalDropoutCell, self).reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_mask(self, F, name, like, rate):
        # same mask every step: Dropout of ones, captured on first step
        return F.Dropout(F.ones_like(like), p=rate)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states:
            if self.drop_states_mask is None:
                self.drop_states_mask = self._initialize_mask(
                    F, "states", states[0], self.drop_states)
            states = [states[0] * self.drop_states_mask] + list(states[1:])
        if self.drop_inputs:
            if self.drop_inputs_mask is None:
                self.drop_inputs_mask = self._initialize_mask(
                    F, "inputs", inputs, self.drop_inputs)
            inputs = inputs * self.drop_inputs_mask
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = self._initialize_mask(
                    F, "outputs", output, self.drop_outputs)
            output = output * self.drop_outputs_mask
        return output, states
