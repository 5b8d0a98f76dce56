"""Symbolic RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``; reference:
python/mxnet/rnn/rnn_cell.py).

The cells compose Symbols of the port's registry. The equations are
MXNet's (gate order i/f/c/o for LSTM, r/z/o for GRU), so checkpoints and
per-gate parameter names line up with the reference and with the JAX
package; the graph each ``unroll`` builds runs through the executor, one
torch op a node.

As in the JAX package, ``begin_state(func=sym.zeros)`` needs a concrete
``batch_size``, and ``unroll`` with no begin_state derives zero states
from the input symbol itself (a tile of a zeroed input column).
"""

from .. import symbol


class _MultiCell(object):
    """Delegation shared by compound cells (Sequential, Bidirectional):
    state metadata and weight pack/unpack distribute over the member
    cells in order."""

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def _default_begin_state(self, step_input):
        return [s for c in self._cells
                for s in c._default_begin_state(step_input)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Convert between a merged (N,T,C)/(T,N,C) symbol and a per-step
    symbol list, per `merge` (True = want merged, False = want a list,
    None = leave as-is); returns (inputs, time_axis)."""
    assert inputs is not None
    axis = layout.find("T")
    in_axis = axis if in_layout is None else in_layout.find("T")
    merged_in = isinstance(inputs, symbol.Symbol)
    if merged_in and merge is False:
        if len(inputs.list_outputs()) != 1:
            raise ValueError(
                "unroll doesn't allow grouped symbol as input. Please "
                "convert to list first or let unroll handle splitting.")
        return list(symbol.SliceChannel(
            inputs, axis=in_axis, num_outputs=length,
            squeeze_axis=1)), axis
    if not merged_in:
        assert length is None or len(inputs) == length
        if merge is not True:
            return inputs, axis
        steps = [symbol.expand_dims(i, axis=axis) for i in inputs]
        return symbol.Concat(*steps, dim=axis), axis
    if axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNParams(object):
    """Container for cell parameters: lazily creates prefixed Variables."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


class BaseRNNCell(object):
    """Abstract cell: one step of `__call__(inputs, states)`."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        """Before re-unrolling: clears the per-step name counter."""
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """Per-state dicts ({'shape': (0, n), '__layout__': 'NC'})."""
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, batch_size=0, **kwargs):
        """Initial-state symbols. With the default zeros func a concrete
        batch_size is required (static shapes); unroll(begin_state=None)
        instead derives zeros from the input symbol."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        def concrete(shape):
            # a 0 marks the batch axis (index 0 for NC states, index 1
            # for the fused cells' LNC states) — fill it or fail loudly
            if 0 not in shape:
                return shape
            if not batch_size:
                raise ValueError(
                    "begin_state with unknown batch needs batch_size= "
                    "(static shapes) — or pass begin_state=None to "
                    "unroll, which infers it from the inputs")
            return tuple(batch_size if s == 0 else s for s in shape)

        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(func(
                concrete(tuple(info["shape"])),
                name="%sbegin_state_%d" % (self._prefix,
                                           self._init_counter),
                **dict(kwargs)))
        return states

    def _zeros_like_state(self, step_input, n):
        """(N, n) zero symbol carved out of a step input (N, C) — keeps
        the batch dimension symbolic-shape-free."""
        col = symbol.slice_axis(step_input, axis=-1, begin=0, end=1)
        return symbol.tile(col * 0.0, reps=(1, n))

    def _default_begin_state(self, step_input):
        states = []
        for info in self.state_info:
            states.append(self._zeros_like_state(step_input,
                                                 info["shape"][-1]))
        return states

    def unpack_weights(self, args):
        """Split fused per-cell 4h/3h parameters into per-gate arrays
        (name_i2h_weight -> name_i2h_i_weight, ...)."""
        args = args.copy()
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for suffix in ("weight", "bias"):
                name = "%s%s_%s" % (self._prefix, group, suffix)
                if name not in args:
                    continue
                arr = args.pop(name)
                for i, gate in enumerate(self._gate_names):
                    args["%s%s%s_%s" % (self._prefix, group, gate, suffix)] \
                        = arr[i * h:(i + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = args.copy()
        if not self._gate_names:
            return args
        from .. import ndarray as nd
        for group in ("i2h", "h2h"):
            for suffix in ("weight", "bias"):
                names = ["%s%s%s_%s" % (self._prefix, group, gate, suffix)
                         for gate in self._gate_names]
                # all-or-nothing: popping a partial gate set would lose
                # parameters silently
                if not all(n in args for n in names):
                    continue
                pieces = [args.pop(n) for n in names]
                args["%s%s_%s" % (self._prefix, group, suffix)] = \
                    nd.concat(*pieces, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll `length` steps; returns (outputs, states)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        states = begin_state if begin_state is not None \
            else self._default_begin_state(inputs[0])
        outputs = []
        for step_in in inputs[:length]:
            step_out, states = self(step_in, states)
            outputs.append(step_out)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    # -- shared machinery for the three unfused gate cells ------------
    def _declare_fc_params(self, i2h_bias_init=None):
        """The i2h/h2h weight+bias quartet every unfused cell owns."""
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias", init=i2h_bias_init) \
            if i2h_bias_init is not None else self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    def _nc_states(self, count):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}
                for _ in range(count)]

    def _step_name(self):
        self._counter += 1
        return "%st%d_" % (self._prefix, self._counter)

    def _fc_pair(self, name, inputs, prev, gate_mult):
        """The fused input/hidden projections one step consumes: each is
        one matmul over all gates at once."""
        width = self._num_hidden * gate_mult
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=width, name="%si2h" % name)
        h2h = symbol.FullyConnected(
            data=prev, weight=self._hW, bias=self._hB,
            num_hidden=width, name="%sh2h" % name)
        return i2h, h2h


class RNNCell(BaseRNNCell):
    """Elman cell: h' = act(W_x x + b_x + W_h h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._declare_fc_params()

    @property
    def state_info(self):
        return self._nc_states(1)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._fc_pair(name, inputs, states[0], 1)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, fused-gate layout [i, f, c, o]."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        # forget_bias lands in the bias initializer (the LSTMBias init
        # sets the forget-gate quarter, initializer.py)
        from .. import initializer
        self._declare_fc_params(
            initializer.LSTMBias(forget_bias) if forget_bias else None)

    @property
    def state_info(self):
        return self._nc_states(2)

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._fc_pair(name, inputs, states[0], 4)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name="%sslice" % name)
        squash = {"i": "sigmoid", "f": "sigmoid", "c": "tanh",
                  "o": "sigmoid"}
        i, f, c, o = (
            symbol.Activation(g, act_type=squash[tag],
                              name="%s%s" % (name, tag))
            for g, tag in zip(gates, "ifco"))
        next_c = f * states[1] + i * c
        next_h = o * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate layout [r, z, o]."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._declare_fc_params()

    @property
    def state_info(self):
        return self._nc_states(1)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        prev = states[0]
        i2h, h2h = self._fc_pair(name, inputs, prev, 3)
        ir, iz, io = symbol.SliceChannel(i2h, num_outputs=3,
                                         name="%si2h_slice" % name)
        hr, hz, ho = symbol.SliceChannel(h2h, num_outputs=3,
                                         name="%sh2h_slice" % name)
        r = symbol.Activation(ir + hr, act_type="sigmoid", name="%sr" % name)
        z = symbol.Activation(iz + hz, act_type="sigmoid", name="%sz" % name)
        cand = symbol.Activation(io + r * ho, act_type="tanh",
                                 name="%sh" % name)
        next_h = (1.0 - z) * cand + z * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer fused cell over the `RNN` op (src/operator/rnn.cc):
    one packed parameter vector."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super(FusedRNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameters = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            n.append({"shape": (b, 0, self._num_hidden),
                      "__layout__": "LNC"})
        return n

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll")

    def _dirs(self):
        return ("l", "r") if self._bidirectional else ("l",)

    def _layout(self, input_size):
        """[(name, shape)] in packed order (ops/nn.py _unpack_rnn_params:
        all weights layer-major, then all biases)."""
        h = self._num_hidden
        ng = self._num_gates
        d = 2 if self._bidirectional else 1
        slots = []
        for layer in range(self._num_layers):
            isz = input_size if layer == 0 else h * d
            for dr in self._dirs():
                for gate in self._gate_names:
                    slots.append(("%s%s%d_i2h%s_weight" % (
                        self._prefix, dr, layer, gate), (h, isz)))
                for gate in self._gate_names:
                    slots.append(("%s%s%d_h2h%s_weight" % (
                        self._prefix, dr, layer, gate), (h, h)))
        for layer in range(self._num_layers):
            for dr in self._dirs():
                for gate in self._gate_names:
                    slots.append(("%s%s%d_i2h%s_bias" % (
                        self._prefix, dr, layer, gate), (h,)))
                for gate in self._gate_names:
                    slots.append(("%s%s%d_h2h%s_bias" % (
                        self._prefix, dr, layer, gate), (h,)))
        return slots

    def _infer_input_size(self, total):
        h = self._num_hidden
        ng = self._num_gates
        d = 2 if self._bidirectional else 1
        per = total // (d * ng * h)
        return int(per - (self._num_layers - 1) * (h * d + h + 2) - h - 2)

    def unpack_weights(self, args):
        """Slice the packed vector into the per-gate arrays the unfused
        cells (unfuse()) use — checkpoint interchange both ways."""
        args = args.copy()
        name = self._prefix + "parameters"
        if name not in args:
            return args
        from .. import ndarray as nd
        import numpy as onp
        buf = args.pop(name).asnumpy().reshape(-1)
        off = 0
        for slot_name, shape in self._layout(self._infer_input_size(
                buf.size)):
            n = 1
            for s in shape:
                n *= s
            args[slot_name] = nd.array(
                onp.ascontiguousarray(buf[off:off + n].reshape(shape)))
            off += n
        if off != buf.size:
            raise ValueError(
                "packed RNN parameter vector has %d elements, layout "
                "consumed %d" % (buf.size, off))
        return args

    def pack_weights(self, args):
        args = args.copy()
        probe = "%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])
        if probe not in args:
            return args
        from .. import ndarray as nd
        import numpy as onp
        input_size = args[probe].shape[1]
        pieces = []
        for slot_name, shape in self._layout(input_size):
            if slot_name not in args:
                raise KeyError("missing %s while packing FusedRNNCell "
                               "parameters" % slot_name)
            pieces.append(args.pop(slot_name).asnumpy().reshape(-1))
        args[self._prefix + "parameters"] = nd.array(
            onp.concatenate(pieces))
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            # RNN op wants time-major (T, N, C)
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        mode = self._mode
        rnn_mode = {"rnn_relu": "rnn_relu", "rnn_tanh": "rnn_tanh",
                    "lstm": "lstm", "gru": "gru"}[mode]
        kwargs = {}
        if begin_state is not None:
            kwargs["state"] = begin_state[0]
            if mode == "lstm":
                kwargs["state_cell"] = begin_state[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameters,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout, state_outputs=self._get_next_state,
                         mode=rnn_mode, name="%srnn" % self._prefix,
                         **kwargs)
        if self._get_next_state:
            parts = list(rnn)
            outputs, states = parts[0], parts[1:]
        else:
            outputs = rnn[0] if len(rnn.list_outputs()) > 1 else rnn
            states = []
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, axis=layout.find("T"), num_outputs=length,
                squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused per-layer cells."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(_MultiCell, BaseRNNCell):
    """Stack of cells applied layer by layer each step."""

    def __init__(self, params=None):
        super(SequentialRNNCell, self).__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(st)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._default_begin_state(inputs[0])
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < len(self._cells) - 1
                else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout between stacked cells."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super(DropoutCell, self).__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def _default_begin_state(self, step_input):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])[0], []
        return [self(i, [])[0] for i in inputs], []


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (zoneout, residual)."""

    def __init__(self, base_cell):
        super(ModifierCell, self).__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    def _borrow_base(self, method, *args, **kwargs):
        """Temporarily lift the wrapped cell's modified flag to call
        one of its methods on the modifier's behalf."""
        self.base_cell._modified = False
        try:
            return method(*args, **kwargs)
        finally:
            self.base_cell._modified = True

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        return self._borrow_base(self.base_cell.begin_state,
                                 func=func, **kwargs)

    def _default_begin_state(self, step_input):
        return self._borrow_base(self.base_cell._default_begin_state,
                                 step_input)

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: keep previous output/state with prob p."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout; unfuse() first"
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super(ZoneoutCell, self).reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0.0
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output)
            output = symbol.where(m, next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0:
            states = [symbol.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output (He et al. shortcut)."""

    def __init__(self, base_cell):
        super(ResidualCell, self).__init__(base_cell)

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        outputs, states = self._borrow_base(
            self.base_cell.unroll, length, inputs=inputs,
            begin_state=begin_state, layout=layout, merge_outputs=False)
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        outputs = [o + i for o, i in zip(outputs, inputs)]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


class BidirectionalCell(_MultiCell, BaseRNNCell):
    """Runs l_cell forward and r_cell on the reversed sequence, concats."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._default_begin_state(inputs[0])
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l, r, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in enumerate(zip(l_outputs,
                                                  reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, l_states + r_states
