"""Gluon recurrent cells (port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``;
reference: python/mxnet/gluon/rnn/rnn_cell.py: RecurrentCell, RNNCell,
LSTMCell, GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
ZoneoutCell, ResidualCell, BidirectionalCell).

Cells are step functions; ``unroll`` builds a Python-unrolled graph (or
runs the steps eagerly), with ``valid_length`` through ``SequenceMask``,
``SequenceLast`` and ``SequenceReverse``. An eager unroll with no
begin_state makes its zero states on the inputs' context, so recurrent
state lives where the data does. For long sequences the fused
``gluon.rnn.RNN/LSTM/GRU`` layers run the ``RNN`` op (ops/nn.py).
"""

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _gathered_state_info(cells, batch_size):
    return [info for c in cells for info in c.state_info(batch_size)]


def _gathered_begin_state(cells, **kwargs):
    return [s for c in cells for s in c.begin_state(**kwargs)]


def _step_through(cells, inputs, states):
    """Feed one step through a stack of cells, threading the state
    window each cell owns; returns (output, flat next states)."""
    cursor, collected = 0, []
    for cell in cells:
        width = len(cell.state_info())
        inputs, nxt = cell(inputs, states[cursor:cursor + width])
        cursor += width
        collected.extend(nxt)
    return inputs, collected


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Returns (inputs, time_axis, F, batch_size)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        seq = list(inputs)
        F = _get_F(seq[0])
        batch = seq[0].shape[0] if hasattr(seq[0], "shape") and \
            seq[0].shape else 0
        if merge is True:
            return F.stack(*seq, axis=axis), axis, F, batch
        return seq, axis, F, batch
    F = _get_F(inputs)
    batch = 0
    if hasattr(inputs, "shape") and inputs.shape:
        batch = inputs.shape[batch_axis]
        if length is None:
            length = inputs.shape[axis]
    if merge is False:
        seq = F.split(inputs, num_outputs=length, axis=axis,
                      squeeze_axis=True)
        if not isinstance(seq, (list, tuple)):
            seq = [seq]
        return list(seq), axis, F, batch
    return inputs, axis, F, batch


def _get_F(x):
    from ... import symbol
    from ... import ndarray
    return symbol if isinstance(x, symbol.Symbol) else ndarray


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    """Zero out positions past valid_length (stacks step lists first,
    mirroring the reference helper)."""
    assert valid_length is not None
    if isinstance(data, (list, tuple)):
        data = F.stack(*data, axis=time_axis)
    outputs = F.SequenceMask(data, sequence_length=valid_length,
                             use_sequence_length=True, axis=time_axis)
    if not merge:
        outputs = F.split(outputs, num_outputs=length, axis=time_axis,
                          squeeze_axis=True)
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        else:
            outputs = list(outputs)
    return outputs


class RecurrentCell(Block):
    """Abstract cell (gluon/rnn/rnn_cell.py:81)."""

    def __init__(self, prefix=None, params=None):
        super(RecurrentCell, self).__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            spec = dict(kwargs) if info is None else {**info, **kwargs}
            states.append(func(
                name="%sbegin_state_%d" % (self._prefix,
                                           self._init_counter), **spec))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unrolls the cell `length` steps (gluon/rnn/rnn_cell.py:218)."""
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        begin_state = self._get_begin_state(F, begin_state, inputs,
                                            batch_size)
        states = begin_state
        outputs, state_history = [], []
        track = valid_length is not None
        for step_in in inputs[:length]:
            step_out, states = self(step_in, states)
            outputs.append(step_out)
            if track:
                state_history.append(states)
        if track:
            # per-row final state = the state at that row's last VALID
            # step, not the last unrolled one
            states = [F.SequenceLast(F.stack(*per_state, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
                      for per_state in zip(*state_history)]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis,
                bool(merge_outputs))
        elif merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def _get_begin_state(self, F, begin_state, inputs, batch_size):
        if begin_state is None:
            from ... import ndarray
            if F is ndarray:
                bs = batch_size if isinstance(batch_size, int) else 0
                first = inputs[0] if isinstance(inputs, (list, tuple)) \
                    else inputs
                begin_state = self.begin_state(batch_size=bs,
                                               func=ndarray.zeros,
                                               ctx=first.context)
            else:
                from ... import symbol
                begin_state = self.begin_state(
                    func=lambda name, **kw: symbol.var(name))
        return begin_state

    def __call__(self, inputs, states):
        self._counter += 1
        return super(RecurrentCell, self).__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError()

    def _alias(self):
        return "recurrent_cell"


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable cell."""

    def __init__(self, prefix=None, params=None):
        super(HybridRecurrentCell, self).__init__(prefix=prefix,
                                                  params=params)

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()

    def _declare_gate_params(self, hidden_size, input_size, n_gates,
                             inits):
        """The i2h/h2h weight+bias quartet, gate-fused along the
        leading axis (n_gates * hidden rows — one matmul covers
        every gate)."""
        rows = n_gates * hidden_size
        i2h_w, h2h_w, i2h_b, h2h_b = inits
        for attr, shape, init in (
                ("i2h_weight", (rows, input_size), i2h_w),
                ("h2h_weight", (rows, hidden_size), h2h_w),
                ("i2h_bias", (rows,), i2h_b),
                ("h2h_bias", (rows,), h2h_b)):
            setattr(self, attr, self.params.get(
                attr, shape=shape, init=init, allow_deferred_init=True))

    def _nc_state_info(self, batch_size, count):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"} for _ in range(count)]

    @staticmethod
    def _fc_pair(F, prefix, inputs, prev, weights, width):
        i2h_weight, h2h_weight, i2h_bias, h2h_bias = weights
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=width, name=prefix + "i2h")
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias,
                               num_hidden=width, name=prefix + "h2h")
        return i2h, h2h


class RNNCell(HybridRecurrentCell):
    """Elman cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self._declare_gate_params(
            hidden_size, input_size, 1,
            (i2h_weight_initializer, h2h_weight_initializer,
             i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return self._nc_state_info(batch_size, 1)

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h, h2h = self._fc_pair(
            F, prefix, inputs, states[0],
            (i2h_weight, h2h_weight, i2h_bias, h2h_bias),
            self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation,
                              name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (Hochreiter & Schmidhuber 1997); gate order i, f, g, o
    matches the fused RNN op (ops/nn.py _lstm_cell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None,
                 activation="tanh", recurrent_activation="sigmoid"):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._declare_gate_params(
            hidden_size, input_size, 4,
            (i2h_weight_initializer, h2h_weight_initializer,
             i2h_bias_initializer, h2h_bias_initializer))
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return self._nc_state_info(batch_size, 2)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h, h2h = self._fc_pair(
            F, prefix, inputs, states[0],
            (i2h_weight, h2h_weight, i2h_bias, h2h_bias),
            4 * self._hidden_size)
        gate = F.SliceChannel(i2h + h2h, num_outputs=4,
                              name=prefix + "slice")
        act, ract = self._activation, self._recurrent_activation
        in_gate = F.Activation(gate[0], act_type=ract)
        forget_gate = F.Activation(gate[1], act_type=ract)
        in_transform = F.Activation(gate[2], act_type=act)
        out_gate = F.Activation(gate[3], act_type=ract)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type=act)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (Cho et al. 2014), gate order r, z, n as the fused op."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._declare_gate_params(
            hidden_size, input_size, 3,
            (i2h_weight_initializer, h2h_weight_initializer,
             i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return self._nc_state_info(batch_size, 1)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        prev = states[0]
        i2h, h2h = self._fc_pair(
            F, prefix, inputs, prev,
            (i2h_weight, h2h_weight, i2h_bias, h2h_bias),
            3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3,
                                             name=prefix + "i2h_slice")
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3,
                                             name=prefix + "h2h_slice")
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        cand = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1. - update) * cand + update * prev
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stacks multiple cells."""

    def __init__(self, prefix=None, params=None):
        super(SequentialRNNCell, self).__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _gathered_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _gathered_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        cells = list(self._children.values())
        assert not any(isinstance(c, BidirectionalCell) for c in cells)
        return _step_through(cells, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        cells = list(self._children.values())
        _, _, F, batch_size = _format_sequence(length, inputs, layout,
                                               None)
        begin_state = self._get_begin_state(F, begin_state, inputs,
                                            batch_size)
        cursor, next_states = 0, []
        for i, cell in enumerate(cells):
            width = len(cell.state_info())
            inputs, states = cell.unroll(
                length, inputs=inputs,
                begin_state=begin_state[cursor:cursor + width],
                layout=layout,
                merge_outputs=merge_outputs if i == len(cells) - 1
                else None,
                valid_length=valid_length)
            cursor += width
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError()


class HybridSequentialRNNCell(HybridRecurrentCell):
    """Hybridizable sequential stack."""

    def __init__(self, prefix=None, params=None):
        super(HybridSequentialRNNCell, self).__init__(prefix=prefix,
                                                      params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _gathered_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _gathered_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return self.forward(inputs, states)

    def forward(self, inputs, states):
        return _step_through(list(self._children.values()), inputs,
                             states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        return SequentialRNNCell.unroll(
            self, length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """Applies dropout on input (a no-state cell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super(DropoutCell, self).__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(data=inputs, p=self._rate, axes=self._axes,
                               name="t%d_fwd" % self._counter)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells that wrap another cell."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super(ModifierCell, self).__init__(prefix=base_cell.prefix + self._alias(),
                                           params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2016): randomly keep previous states."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Apply ZoneoutCell to the cells underneath instead."
        self._alias_cache = "zoneout"
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super(ZoneoutCell, self).reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: F.Dropout(F.ones_like(like), p=p)
                if p > 0 else None)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        m_out = mask(p_outputs, next_output)
        output = (F.where(m_out, next_output, prev_output)
                  if m_out is not None else next_output)
        states = ([F.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output."""

    def __init__(self, base_cell):
        super(ResidualCell, self).__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = (isinstance(outputs, _get_F(outputs).__dict__.get(
            "NDArray", type(None))) if merge_outputs is None
            else merge_outputs)
        inputs, axis, F, _ = _format_sequence(length, inputs, layout,
                                              merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [o + i for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Runs two cells over the sequence in opposite directions and
    concatenates their per-step outputs. unroll-only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _gathered_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _gathered_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        if valid_length is None:
            reversed_inputs = list(reversed(inputs))
        else:
            # reverse only the valid prefix of each sample so the reverse
            # cell never sees padding before real tokens (reference
            # rnn_cell.py _reverse_sequences / SequenceReverse)
            stacked = F.SequenceReverse(F.stack(*inputs, axis=0),
                                        sequence_length=valid_length,
                                        use_sequence_length=True, axis=0)
            reversed_inputs = list(F.split(stacked, num_outputs=length,
                                           axis=0, squeeze_axis=True)) \
                if length > 1 else [stacked[0]]
        begin_state = self._get_begin_state(F, begin_state, inputs,
                                            batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            stacked = F.SequenceReverse(F.stack(*r_outputs, axis=0),
                                        sequence_length=valid_length,
                                        use_sequence_length=True, axis=0)
            r_outputs = list(F.split(stacked, num_outputs=length, axis=0,
                                     squeeze_axis=True)) \
                if length > 1 else [stacked[0]]
        outputs = [F.concat(l_o, r_o, dim=1,
                            name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(zip(l_outputs, r_outputs))]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        states = l_states + r_states
        return outputs, states
