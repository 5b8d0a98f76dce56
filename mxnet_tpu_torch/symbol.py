"""Symbol — the declarative graph API (port of ``mxnet_tpu/symbol.py``;
reference: python/mxnet/symbol/symbol.py).

A Symbol is a Python DAG over the op registry: composition through the
``sym.*`` namespace (missing parameters and loss labels become
variables, as in MXNet), ``list_arguments`` / ``list_auxiliary_states``,
``infer_shape(_partial)`` and ``infer_type`` by running each node's op
on ``meta`` tensors (no data, no device), and ``bind``/``simple_bind``
into an ``Executor`` that runs the graph with torch ops. Dtypes are
torch dtypes; a variable's ``__dtype__`` attr holds the dtype's name.

JSON follows the reference node-list layout (symbol.py:1331 tojson) and
the JAX package's attrs, so a graph written by either package loads in
the other. Ops the port has not ported yet raise ``MXNetError`` naming
their ROADMAP item when composed, as in ``nd``.
"""

import json

import numpy as np
import torch

from . import ops
from .base import MXNetError, dtype_name, np_dtype, torch_dtype
from .ops._queued import QUEUED

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json", "zeros",
           "ones"]

# Ops whose trailing signature params are tensor inputs (not attrs); needed
# for symbolic composition where inputs must be identified statically
# (the reference encodes this in each op's FListInputNames).
OP_INPUTS = {
    "Convolution": ("data", "weight", "bias"),
    "Deconvolution": ("data", "weight", "bias"),
    "FullyConnected": ("data", "weight", "bias"),
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    "_contrib_SyncBatchNorm": ("data", "gamma", "beta", "moving_mean",
                               "moving_var"),
    "LayerNorm": ("data", "gamma", "beta"),
    "GroupNorm": ("data", "gamma", "beta"),
    "InstanceNorm": ("data", "gamma", "beta"),
    "Embedding": ("data", "weight"),
    "RNN": ("data", "parameters", "state", "state_cell"),
    "SoftmaxOutput": ("data", "label"),
    "Softmax": ("data", "label"),
    "softmax_cross_entropy": ("data", "label"),
    "CTCLoss": ("data", "label", "data_lengths", "label_lengths"),
    "ctc_loss": ("data", "label", "data_lengths", "label_lengths"),
    "LeakyReLU": ("data", "gamma"),
    "SequenceMask": ("data", "sequence_length"),
    "SequenceLast": ("data", "sequence_length"),
    "SequenceReverse": ("data", "sequence_length"),
    "BilinearSampler": ("data", "grid"),
    "SpatialTransformer": ("data", "loc"),
    "ROIPooling": ("data", "rois"),
    "_contrib_ROIAlign": ("data", "rois"),
    "where": ("condition", "x", "y"),
    "dot": ("lhs", "rhs"),
    "batch_dot": ("lhs", "rhs"),
}

# Aux states: inputs updated by the op during training rather than learned
# by gradient (reference: MutableInput lists; BatchNorm moving stats).
OP_AUX = {"BatchNorm": ("moving_mean", "moving_var"),
          "_contrib_SyncBatchNorm": ("moving_mean", "moving_var")}
# default initializer registry names for auto-created aux states
_AUX_DEFAULT_INIT = {"moving_mean": "zeros", "moving_var": "ones"}


# Loss heads whose missing `label` input is auto-created as `{name}_label`
# (the reference's ListArguments auto-var rule that makes `softmax_label`
# appear in list_arguments()). Value = label-shape rule from data shape.
LABEL_SHAPE_RULES = {
    "SoftmaxOutput": lambda ds, at: ds[:1] if not at.get("multi_output")
    else (ds[0],) + tuple(ds[2:]),
    "Softmax": lambda ds, at: ds[:1],
    "softmax_cross_entropy": lambda ds, at: ds[:1],
    "LinearRegressionOutput": lambda ds, at: ds,
    "MAERegressionOutput": lambda ds, at: ds,
    "LogisticRegressionOutput": lambda ds, at: ds,
}

# Params auto-created as trainable variables when omitted at composition
# time, and their deferred-shape rule given the first input's shape.
_NORM_PARAM = lambda data_shape, attrs, axis=1: (data_shape[attrs.get("axis", axis) % len(data_shape)],)


def _conv_w(data_shape, attrs):
    kernel = attrs.get("kernel", ())
    nf = attrs.get("num_filter", 1)
    ng = attrs.get("num_group", 1)
    return (nf, data_shape[1] // ng) + tuple(kernel)


def _deconv_w(data_shape, attrs):
    kernel = attrs.get("kernel", ())
    nf = attrs.get("num_filter", 1)
    ng = attrs.get("num_group", 1)
    return (data_shape[1], nf // ng) + tuple(kernel)


def _fc_w(data_shape, attrs):
    nh = attrs.get("num_hidden", 1)
    if attrs.get("flatten", True):
        in_units = int(np.prod(data_shape[1:]))
    else:
        in_units = data_shape[-1]
    return (nh, in_units)


def _rnn_params(data_shape, attrs):
    from .ops.nn import rnn_param_size
    return (rnn_param_size(attrs.get("mode", "lstm"),
                           attrs.get("num_layers", 1), data_shape[2],
                           attrs.get("state_size", 1),
                           attrs.get("bidirectional", False)),)


PARAM_SHAPE_RULES = {
    "Convolution": {"weight": _conv_w,
                    "bias": lambda ds, at: (at.get("num_filter", 1),)},
    "Deconvolution": {"weight": _deconv_w,
                      "bias": lambda ds, at: (at.get("num_filter", 1),)},
    "FullyConnected": {"weight": _fc_w,
                       "bias": lambda ds, at: (at.get("num_hidden", 1),)},
    "BatchNorm": {k: _NORM_PARAM for k in
                  ("gamma", "beta", "moving_mean", "moving_var")},
    "_contrib_SyncBatchNorm": {k: _NORM_PARAM for k in
                               ("gamma", "beta", "moving_mean",
                                "moving_var")},
    "LayerNorm": {"gamma": lambda ds, at: (ds[at.get("axis", -1) % len(ds)],),
                  "beta": lambda ds, at: (ds[at.get("axis", -1) % len(ds)],)},
    "GroupNorm": {"gamma": _NORM_PARAM, "beta": _NORM_PARAM},
    "InstanceNorm": {"gamma": _NORM_PARAM, "beta": _NORM_PARAM},
    "RNN": {"parameters": _rnn_params},
    "LeakyReLU": {"gamma": lambda ds, at: (ds[1] if len(ds) > 1 else 1,)},
    "Embedding": {"weight": lambda ds, at: (at.get("input_dim", 1),
                                            at.get("output_dim", 1))},
}


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op          # op name string; "null" for variables
        self.name = name
        self.attrs = attrs    # static attrs (variables store __shape__ etc.)
        self.inputs = inputs  # list of (Symbol(single-node), out_index)

    def is_var(self):
        return self.op == "null"


_name_counter = {}


def _auto_name(op_name, name=None):
    """Route op names through the active NameManager: auto-generated
    names draw from the scope's counter; explicit names pick up the
    scope prefix (so layer-internal fixed names like 'fwd' stay unique
    across sibling blocks)."""
    from .name import NameManager
    base = op_name.lower().lstrip("_")
    return NameManager.current().get(name, base)


class Symbol:
    """Symbolic multi-output expression (python/mxnet/symbol/symbol.py:61)."""

    def __init__(self, nodes, outputs):
        # nodes: topo-ordered list of _Node; outputs: list of (node_idx, out_idx)
        self._nodes = nodes
        self._outputs = outputs

    # ------------------------------------------------------- structure --
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._nodes[self._outputs[0][0]].name
        return None

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            index = names.index(index)
        return Symbol(self._nodes, [self._outputs[index]])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _active_nodes(self):
        """Topo-ordered ancestor set of this symbol's outputs (a Symbol can
        share a larger node list, e.g. after get_internals slicing)."""
        active = set()
        stack = [self._nodes[ni] for ni, _ in self._outputs]
        while stack:
            n = stack.pop()
            if id(n) in active:
                continue
            active.add(id(n))
            for s, _ in n.inputs:
                stack.append(s._nodes[s._outputs[0][0]])
        return [n for n in self._nodes if id(n) in active]

    def list_arguments(self):
        seen, out = set(), []
        for n in self._active_nodes():
            if n.is_var() and not n.attrs.get("__aux__") and n.name not in seen:
                seen.add(n.name)
                out.append(n.name)
        return out

    def list_auxiliary_states(self):
        seen, out = set(), []
        for n in self._active_nodes():
            if n.is_var() and n.attrs.get("__aux__") and n.name not in seen:
                seen.add(n.name)
                out.append(n.name)
        return out

    def list_outputs(self):
        out = []
        for ni, oi in self._outputs:
            node = self._nodes[ni]
            if node.is_var():
                out.append(node.name)
                continue
            op = ops.get(node.op)
            if op.num_outputs == 1 or \
                    node.op in ("BatchNorm", "_contrib_SyncBatchNorm"):
                suffix = "_output"
            else:
                suffix = "_output%d" % oi
            out.append(node.name + suffix)
        return out

    def list_inputs(self):
        return self.list_arguments() + self.list_auxiliary_states()

    def get_internals(self):
        outs = []
        for i, n in enumerate(self._nodes):
            if n.is_var():
                outs.append((i, 0))
            else:
                nout = _node_num_outputs(n)
                outs.extend((i, k) for k in range(nout))
        return Symbol(self._nodes, outs)

    def get_children(self):
        ni, _ = self._outputs[0]
        node = self._nodes[ni]
        if not node.inputs:
            return None
        return Symbol(self._nodes, [(_find_index(self._nodes, s._nodes[s._outputs[0][0]]), oi)
                                    for s, oi in node.inputs])

    def attr(self, key):
        ni, _ = self._outputs[0]
        return self._nodes[ni].attrs.get(key)

    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in self._nodes if n.attrs}

    def _set_attr(self, **kwargs):
        ni, _ = self._outputs[0]
        self._nodes[ni].attrs.update(kwargs)

    # ------------------------------------------------------ compose ops --
    def __call__(self, *args, **kwargs):
        raise MXNetError("Symbol composition via __call__ is not supported; "
                         "pass symbols as op arguments")

    def __add__(self, other):
        return _binary_sym("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return _binary_sym("broadcast_add", "_plus_scalar", self, other)

    def __sub__(self, other):
        return _binary_sym("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _scalar_sym("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _binary_sym("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return _binary_sym("broadcast_mul", "_mul_scalar", self, other)

    def __truediv__(self, other):
        return _binary_sym("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _scalar_sym("_rdiv_scalar", self, other)

    def __pow__(self, other):
        return _binary_sym("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        return _unary_sym("negative", self)

    # rich comparisons compose broadcast/scalar compare ops (reference
    # symbol.py __gt__ etc.); note __eq__/__ne__ build symbols, so Symbol
    # is identity-hashed like the reference
    def __eq__(self, other):
        return _binary_sym("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        return _binary_sym("broadcast_not_equal", "_not_equal_scalar",
                           self, other)

    def __gt__(self, other):
        return _binary_sym("broadcast_greater", "_greater_scalar",
                           self, other)

    def __ge__(self, other):
        return _binary_sym("broadcast_greater_equal",
                           "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _binary_sym("broadcast_lesser", "_lesser_scalar",
                           self, other)

    def __le__(self, other):
        return _binary_sym("broadcast_lesser_equal",
                           "_lesser_equal_scalar", self, other)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    def reshape(self, shape, reverse=False):
        return _compose("Reshape", [self], {"shape": tuple(shape),
                                            "reverse": reverse}, None)

    def astype(self, dtype):
        return _compose("Cast", [self], {"dtype": dtype_name(dtype)}, None)

    # -------------------------------------------------------- inference --
    def infer_shape(self, *args, **kwargs):
        """Forward shape inference incl. deferred parameter shapes
        (reference: infer_graph_attr_pass.cc; here each node's op on meta
        tensors + PARAM_SHAPE_RULES for auto-created parameter
        variables)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        if args:
            for name, shp in zip(self.list_arguments(), args):
                if shp is not None:
                    known[name] = tuple(shp)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes, dtypes = _infer_graph(self._active_nodes(), known, {},
                                      partial=partial)
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes.get(_out_key(self._nodes, ni, oi))
                      for ni, oi in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        known = {}
        if args:
            for name, dt in zip(self.list_arguments(), args):
                if dt is not None:
                    known[name] = torch_dtype(dt)
        known.update({k: torch_dtype(v) for k, v in kwargs.items()})
        shapes, dtypes = _infer_graph(self._active_nodes(), {}, known,
                                      partial=True)
        np_of = lambda dt: None if dt is None else np_dtype(dt)
        args_t = [np_of(dtypes.get(n)) for n in self.list_arguments()]
        aux_t = [np_of(dtypes.get(n))
                 for n in self.list_auxiliary_states()]
        out_t = [np_of(dtypes.get(_out_key(self._nodes, ni, oi)))
                 for ni, oi in self._outputs]
        return args_t, out_t, aux_t

    # ---------------------------------------------------------- binding --
    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             group2ctx=None, shared_exec=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, **kwargs):
        """symbol.py:1441 — infer shapes, allocate arg/grad/aux arrays, bind."""
        from . import ndarray as nd
        from .executor import Executor
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        type_dict = dict(type_dict or {})
        # variables may pin their dtype via the __dtype__ attr
        # (e.g. int8 quantized weights)
        for node in self._active_nodes():
            if node.is_var() and "__dtype__" in node.attrs:
                type_dict.setdefault(node.name, node.attrs["__dtype__"])
        args = {}
        for name, shp in zip(arg_names, arg_shapes):
            if shp is None:
                raise MXNetError("cannot infer shape for argument %s" % name)
            args[name] = nd.zeros(shp, ctx=ctx,
                                  dtype=type_dict.get(name, "float32"))
        args_grad = None
        if grad_req != "null":
            args_grad = {name: nd.zeros(a.shape, ctx=ctx, dtype=a.dtype)
                         for name, a in args.items()}
        aux = {name: nd.zeros(shp, ctx=ctx)
               for name, shp in zip(aux_names, aux_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        from .context import current_context
        ctx = ctx or current_context()
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    # ------------------------------------------------------------ io ----
    def tojson(self):
        """symbol.py:1331 — reference-layout JSON node list. Subgraph-
        valued attrs (control-flow ops) serialize into the node's
        "subgraphs" list, as the reference format does."""
        node_index = {id(n): i for i, n in enumerate(self._nodes)}
        nodes = []
        for n in self._nodes:
            attrs = {}
            subgraphs = []
            for k, v in n.attrs.items():
                if isinstance(v, Symbol):
                    attrs[k] = "__subgraph__:%d" % len(subgraphs)
                    subgraphs.append(json.loads(v.tojson()))
                else:
                    attrs[k] = str(v)
            entry = {
                "op": n.op,
                "name": n.name,
                "attrs": attrs,
                "inputs": [[node_index[id(s._nodes[s._outputs[0][0]])], oi, 0]
                           for s, oi in n.inputs],
            }
            if subgraphs:
                entry["subgraphs"] = subgraphs
            nodes.append(entry)
        heads = [[ni, oi, 0] for ni, oi in self._outputs]
        arg_nodes = [i for i, n in enumerate(self._nodes) if n.is_var()]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_tpu_version": ["str", "0.1.0"]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # gradient helper (MXGradient pass analogue) — symbolic grad symbols
    # are not materialized as Symbols; Executor computes grads with
    # torch.autograd.


def _node_num_outputs(node):
    if node.is_var():
        return 1
    if "__num_outputs__" in node.attrs:
        # per-node arity (control-flow subgraph ops: outputs depend on
        # the traced body, not the op class)
        return int(node.attrs["__num_outputs__"])
    op = ops.get(node.op)
    if node.op in ("BatchNorm", "_contrib_SyncBatchNorm"):
        return 1  # mean/var are internal plumbing, not user outputs
    if op.num_outputs == "n":
        resolver = _VARIADIC_ARITY.get(node.op)
        if resolver is not None:
            return resolver(node.attrs)
        return 1
    return op.num_outputs


# arity of num_outputs=="n" ops as a function of their static attrs
# (the symbolic analogue of the reference's set_num_outputs lambdas)
_VARIADIC_ARITY = {
    "SliceChannel": lambda a: int(a.get("num_outputs", 1)),
    "split": lambda a: int(a.get("num_outputs", 1)),
    "topk": lambda a: 2 if a.get("ret_typ") == "both" else 1,
    "_split_v2": lambda a: (int(a["sections"]) if int(a.get("sections", 0)) > 0
                            else len(tuple(a.get("indices", ())))),
    "amp_multicast": lambda a: int(a.get("num_outputs", 1)),
    "RNN": lambda a: 3 if a.get("mode", "lstm") == "lstm" else 2,
    "multi_sgd_update": lambda a: int(a.get("num_weights", 1)),
    "multi_sgd_mom_update": lambda a: int(a.get("num_weights", 1)),
    "preloaded_multi_sgd_update": lambda a: int(a.get("num_weights", 1)),
    "preloaded_multi_sgd_mom_update": lambda a: int(a.get("num_weights", 1)),
    "multi_mp_sgd_update": lambda a: int(a.get("num_weights", 1)),
    "multi_mp_sgd_mom_update": lambda a: int(a.get("num_weights", 1)),
}


def _out_key(nodes, ni, oi):
    return "%s#%d" % (nodes[ni].name, oi)


def _find_index(nodes, node):
    for i, n in enumerate(nodes):
        if n is node:
            return i
    raise KeyError


def _merge_nodes(syms):
    """Union the node lists of several symbols preserving topo order."""
    merged = []
    seen = set()
    def visit(nodes):
        for n in nodes:
            if id(n) not in seen:
                seen.add(id(n))
                merged.append(n)
    for s in syms:
        visit(s._nodes)
    return merged


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """sym.var / sym.Variable (symbol.py:2516)."""
    from .attribute import AttrScope
    scoped = AttrScope.current().get(None)
    attrs = {("__%s__" % k if not k.startswith("__") else k): v
             for k, v in scoped.items()} if scoped else {}
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    node = _Node("null", name, attrs, [])
    return Symbol([node], [(0, 0)])


Variable = var


def Group(symbols):
    nodes = _merge_nodes(symbols)
    outputs = []
    for s in symbols:
        for ni, oi in s._outputs:
            outputs.append((_find_index(nodes, s._nodes[ni]), oi))
    return Symbol(nodes, outputs)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    syms = []
    for nd_ in data["nodes"]:
        inputs = [(syms[i], oi) for i, oi, _ in nd_["inputs"]]
        attrs = {}
        for k, v in nd_.get("attrs", {}).items():
            if isinstance(v, str) and v.startswith("__subgraph__:"):
                sg = nd_["subgraphs"][int(v.split(":", 1)[1])]
                attrs[k] = load_json(json.dumps(sg))
            else:
                attrs[k] = _parse_attr(v)
        node = _Node(nd_["op"], nd_["name"], attrs, inputs)
        nodes.append(node)
        syms.append(Symbol(nodes[:], [(len(nodes) - 1, 0)]))
    outputs = [(ni, oi) for ni, oi, _ in data["heads"]]
    return Symbol(nodes, outputs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _parse_attr(v):
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s.startswith("(") or s.startswith("["):
        items = [x.strip() for x in s.strip("()[]").split(",") if x.strip()]
        out = []
        for x in items:
            if x.lstrip("-").isdigit():
                out.append(int(x))
            else:
                try:
                    out.append(float(x))
                except ValueError:
                    out.append(x.strip("'\""))
        return tuple(out)
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            continue
    return v


# ---------------------------------------------------------- composition --
def _compose(op_name, input_syms, attrs, name):
    """Create a node applying `op_name` to input symbols. `name`, when
    given, is already scope-resolved by the caller (func/_auto_name) —
    resolving again here would apply the active Prefix twice."""
    if not name:
        name = _auto_name(op_name)
    nodes = _merge_nodes(input_syms)
    node = _Node(op_name, name, attrs,
                 [(s, s._outputs[0][1]) for s in input_syms])
    nodes.append(node)
    nout = _node_num_outputs(node)
    return Symbol(nodes, [(len(nodes) - 1, k) for k in range(nout)]) \
        if nout > 1 else Symbol(nodes, [(len(nodes) - 1, 0)])


def _binary_sym(op, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return _compose(op, [lhs, rhs], {}, None)
    return _compose(scalar_op, [lhs], {"scalar": float(rhs)}, None)


def _scalar_sym(op, data, scalar):
    return _compose(op, [data], {"scalar": float(scalar)}, None)


def _unary_sym(op, data):
    return _compose(op, [data], {}, None)


def _make_sym_func(op_name):
    import inspect as _inspect
    op = ops.get(op_name)
    sig = ops.op_signature(op_name)
    has_varargs = any(p.kind == _inspect.Parameter.VAR_POSITIONAL
                      for p in sig.parameters.values())
    declared_inputs = OP_INPUTS.get(op_name)
    if declared_inputs is None:
        declared_inputs = tuple(
            p.name for p in sig.parameters.values()
            if p.default is _inspect.Parameter.empty
            and p.kind == _inspect.Parameter.POSITIONAL_OR_KEYWORD)

    def func(*args, name=None, attr=None, **kwargs):
        input_syms = []
        input_names = []
        attrs = {}
        pos_inputs = list(args)
        if has_varargs:
            flat = []
            for a in pos_inputs:
                flat.extend(a) if isinstance(a, (list, tuple)) else flat.append(a)
            input_syms = [a for a in flat if isinstance(a, Symbol)]
            input_names = [None] * len(input_syms)
        else:
            # bind positionals to signature parameters in order: Symbols are
            # inputs, everything else is a static attr of that parameter
            pnames = [p.name for p in sig.parameters.values()
                      if p.kind == _inspect.Parameter.POSITIONAL_OR_KEYWORD]
            for a, pname in zip(pos_inputs, pnames):
                if isinstance(a, Symbol):
                    input_syms.append(a)
                    input_names.append(pname)
                elif a is not None:
                    attrs[pname] = a
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                input_syms.append(v)
                input_names.append(k)
            elif v is not None:
                attrs[k] = v
        nm = _auto_name(op_name, name)

        # auto-create missing parameter variables (MXNet composition rule)
        if not has_varargs and op_name in PARAM_SHAPE_RULES:
            have = set(n for n in input_names if n)
            aux_set = set(OP_AUX.get(op_name, ()))
            for pname in declared_inputs:
                if pname in have or pname == declared_inputs[0]:
                    continue
                if _param_unused(op_name, pname, attrs):
                    continue
                vattrs = {"__aux__": True} if pname in aux_set else {}
                # ops declare default inits for their aux states (the
                # reference stamps __init__ on aux vars at composition,
                # batch_norm.cc); initializers route on this attr
                default_init = _AUX_DEFAULT_INIT.get(pname)
                if pname in aux_set and default_init:
                    vattrs["__init__"] = default_init
                v = var("%s_%s" % (nm, pname), attr=vattrs)
                input_syms.append(v)
                input_names.append(pname)
        # auto-create the label variable for loss heads ({name}_label)
        if not has_varargs and op_name in LABEL_SHAPE_RULES \
                and "label" not in set(n for n in input_names if n):
            v = var("%s_label" % nm)
            input_syms.append(v)
            input_names.append("label")
        # order inputs by declared order when names are known
        if input_names and all(n is not None for n in input_names) and not has_varargs:
            order = {n: i for i, n in enumerate(declared_inputs)}
            zipped = sorted(zip(input_names, input_syms),
                            key=lambda t: order.get(t[0], 99))
            input_syms = [s for _, s in zipped]
            input_names = [n for n, _ in zipped]
        # mark explicitly-passed variables bound to aux inputs (e.g. gluon
        # passing running_mean into BatchNorm's moving_mean slot) as aux
        aux_inputs = set(OP_AUX.get(op_name, ()))
        if aux_inputs and not has_varargs:
            for n, s in zip(input_names, input_syms):
                if n in aux_inputs:
                    node = s._nodes[s._outputs[0][0]]
                    if node.is_var():
                        node.attrs["__aux__"] = True
        attrs["__input_names__"] = tuple(n or "arg%d" % i
                                         for i, n in enumerate(input_names))
        from .attribute import AttrScope
        scoped = AttrScope.current().get(attr)
        if scoped:
            attrs.update(("__%s__" % k if not k.startswith("__") else k, v)
                         for k, v in scoped.items())
        return _compose(op_name, input_syms, attrs, nm)

    func.__name__ = op_name
    func.__doc__ = (op.fn.__doc__ or "") + "\n\n(symbolic version)"
    return func


def _param_unused(op_name, pname, attrs):
    if pname == "bias" and attrs.get("no_bias"):
        return True
    if pname in ("state", "state_cell"):
        # the RNN op synthesizes zero initial states when omitted; don't
        # auto-create bindable begin-state variables
        return True
    if pname in ("sequence_length", "data_lengths", "label_lengths") \
            and not attrs.get("use_sequence_length"):
        return True
    if op_name == "LeakyReLU" and pname == "gamma" \
            and attrs.get("act_type", "leaky") != "prelu":
        return True
    if pname == "label":
        return False
    return False


def _make_queued_func(op_name):
    def func(*args, **kwargs):
        raise ops.queued_error(op_name)
    func.__name__ = op_name
    func.__doc__ = str(ops.queued_error(op_name))
    return func


_g = globals()
for _opname in ops.list_ops():
    if _opname not in _g:
        _g[_opname] = _make_sym_func(_opname)
for _alias in list(ops._ALIAS):
    if _alias not in _g:
        _g[_alias] = _make_sym_func(_alias)
for _opname in QUEUED:
    if _opname not in _g:
        _g[_opname] = _make_queued_func(_opname)


def zeros(shape, dtype="float32", **kwargs):
    return _g["_zeros"](shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return _g["_ones"](shape=shape, dtype=dtype, **kwargs)


class _SymContribNamespace:
    def __getattr__(self, item):
        if item in ("foreach", "while_loop", "cond"):
            from . import control_flow
            return getattr(control_flow, "sym_" + item)
        for name in ("_contrib_" + item, item):
            if name in _g:
                return _g[name]
        raise AttributeError(item)


contrib = _SymContribNamespace()


class _SymImageNamespace:
    def __getattr__(self, item):
        full = "_image_" + item
        if full in _g:
            return _g[full]
        raise AttributeError(item)


image = _SymImageNamespace()


class _SymLinalgNamespace:
    def __getattr__(self, item):
        full = "linalg_" + item
        if full in _g:
            return _g[full]
        raise AttributeError(item)


linalg = _SymLinalgNamespace()


class _SymRandomNamespace:
    """sym.random.* (python/mxnet/symbol/random.py): scalar-parameter
    draws compose the ``_random_*`` ops, Symbol parameters the
    ``sample_*`` ops, the same split as ``nd.random``."""

    def __getattr__(self, item):
        scalar_op = "_random_" + item
        tensor_op = "sample_" + item
        if not (ops.exists(scalar_op) or ops.exists(tensor_op)):
            raise AttributeError(item)

        def f(*args, **kwargs):
            if any(isinstance(a, Symbol) for a in args) or \
                    any(isinstance(v, Symbol) for v in kwargs.values()):
                return _g[tensor_op](*args, **kwargs)
            return _g[scalar_op](*args, **kwargs)
        f.__name__ = item
        return f


random = _SymRandomNamespace()


# ----------------------------------------------------- graph inference --
def _infer_graph(nodes, known_shapes, known_dtypes, partial=False):
    """Walk the graph computing each node's outputs on ``meta`` tensors
    (shapes and dtypes, no data); fill missing variable shapes from
    PARAM_SHAPE_RULES. Returns ({key: shape}, {key: torch dtype}), keyed
    by variable name and by "node#output"."""
    from .executor import node_eval_fn

    shapes = dict(known_shapes)
    dtypes = dict(known_dtypes)
    results = {}  # node name -> list of meta tensors

    def meta(shape, dt):
        return torch.empty(tuple(shape), dtype=dt, device="meta")

    for node in nodes:
        if node.is_var():
            shp = shapes.get(node.name) or node.attrs.get("__shape__")
            dt = dtypes.get(node.name) or torch_dtype(
                node.attrs.get("__dtype__", "float32"))
            if shp is not None:
                shapes[node.name] = tuple(shp)
                results[node.name] = [meta(shp, dt)]
                dtypes[node.name] = dt
            continue
        # gather input specs, inferring deferred parameter shapes
        in_specs = []
        in_names = node.attrs.get("__input_names__",
                                  tuple("arg%d" % i for i in range(len(node.inputs))))
        data_spec = None
        for (s, oi), pname in zip(node.inputs, in_names):
            src = s._nodes[s._outputs[0][0]]
            srcres = results.get(src.name)
            if srcres is None and src.is_var():
                # try deferred param shape rule
                rule = PARAM_SHAPE_RULES.get(node.op, {}).get(pname)
                if rule is None and pname == "label":
                    rule = LABEL_SHAPE_RULES.get(node.op)
                if rule is not None and data_spec is not None:
                    shp = tuple(rule(tuple(data_spec.shape), node.attrs))
                    dt = data_spec.dtype
                    results[src.name] = [meta(shp, dt)]
                    shapes[src.name] = shp
                    dtypes[src.name] = dt
                    srcres = results[src.name]
            if srcres is None:
                if partial:
                    results[node.name] = None
                    break
                raise MXNetError("infer_shape: missing shape for input %s of "
                                 "node %s(%s)" % (src.name, node.op, node.name))
            spec = srcres[oi] if len(srcres) > oi else srcres[0]
            in_specs.append(spec)
            if data_spec is None:
                data_spec = spec
        else:
            fn = node_eval_fn(node)
            try:
                out = fn(*in_specs)
            except Exception as e:
                if partial:
                    results[node.name] = None
                    continue
                raise MXNetError("infer_shape failed at %s(%s): %s"
                                 % (node.op, node.name, e))
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            results[node.name] = outs
            for k, o in enumerate(outs):
                shapes[_node_out_name(node, k)] = tuple(o.shape)
                dtypes[_node_out_name(node, k)] = o.dtype
            continue
        # (break path: partial inference, leave unknown)
    return shapes, dtypes


def _node_out_name(node, k):
    return "%s#%d" % (node.name, k)


# ------------------------------------------------- fluent methods -------
# Reference Symbol fluent methods (python/mxnet/symbol/symbol.py):
# s.relu(), s.sum(axis=..), s.slice_axis(...) delegate to the namespace
# functions; NDArray-only operations raise NotImplementedForSymbol.
_SYM_FLUENT = [
    "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "argmax", "argmax_channel", "argmin", "argsort", "broadcast_axes",
    "broadcast_like", "broadcast_to", "cbrt", "ceil", "clip", "cos",
    "cosh", "degrees", "depth_to_space", "diag", "exp", "expand_dims",
    "expm1", "fix", "flatten", "flip", "floor", "log", "log10", "log1p",
    "log2", "log_softmax", "max", "mean", "min", "nanprod", "nansum",
    "norm", "one_hot", "ones_like", "pad", "pick", "prod", "radians",
    "rcbrt", "reciprocal", "relu", "repeat", "reshape_like", "rint",
    "round", "rsqrt", "shape_array", "sigmoid", "sign", "sin", "sinh",
    "size_array", "slice", "slice_axis", "slice_like", "softmax",
    "softmin", "sort", "space_to_depth", "split", "split_v2", "sqrt",
    "square", "squeeze", "sum", "swapaxes", "take", "tan", "tanh",
    "tile", "topk", "transpose", "trunc", "zeros_like",
]


def _make_sym_fluent(name):
    opname = {"flip": "reverse", "split": "SliceChannel",
              "split_v2": "_split_v2", "pad": "Pad",
              "slice": "slice"}.get(name, name)

    def method(self, *args, **kwargs):
        fn = _g.get(opname) or (_make_sym_func(opname)
                                if ops.exists(opname) else None)
        if fn is None:
            raise AttributeError(name)
        return fn(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = "Fluent form of sym.%s(self, ...)." % name
    return method


for _name in _SYM_FLUENT:
    if not hasattr(Symbol, _name):
        setattr(Symbol, _name, _make_sym_fluent(_name))


class NotImplementedForSymbol(MXNetError):
    """Raised by NDArray-only methods called on a Symbol (reference
    symbol.py NotImplementedForSymbol)."""

    def __init__(self, function, *_):
        super().__init__("Function %s is not implemented for Symbol and "
                         "only available in NDArray." % function)


def _sym_na(name):
    def method(self, *args, **kwargs):
        raise NotImplementedForSymbol(name)
    method.__name__ = name
    return method


for _name in ("asnumpy", "asscalar", "wait_to_read", "backward",
              "as_in_context", "copy", "detach"):
    if not hasattr(Symbol, _name):
        setattr(Symbol, _name, _sym_na(_name))

# the numpy-flavored symbol API resolves to the same Symbol class here
# (both namespaces dispatch into the one op registry)
Symbol.as_np_ndarray = lambda self: self
Symbol.as_nd_ndarray = lambda self: self


def _sym_list_attr(self, recursive=False):
    """Attributes of this symbol's node (reference list_attr)."""
    ni, _ = self._outputs[0]
    return dict(self._nodes[ni].attrs)


Symbol.list_attr = _sym_list_attr


def _sym_debug_str(self):
    lines = []
    for i, node in enumerate(self._nodes):
        ins = ", ".join(s._nodes[s._outputs[0][0]].name
                        for s, _ in node.inputs) if node.inputs else ""
        lines.append("%3d %-20s %-24s <- %s"
                     % (i, node.op or "Variable", node.name, ins))
    return "\n".join(lines)


Symbol.debug_str = _sym_debug_str


def _sym_infer_type_partial(self, *args, **kwargs):
    """Like infer_type but tolerates unknowns (reference
    infer_type_partial)."""
    try:
        return self.infer_type(*args, **kwargs)
    except Exception:
        n_args = len(self.list_arguments())
        n_aux = len(self.list_auxiliary_states())
        return ([None] * n_args, [None] * len(self._outputs),
                [None] * n_aux)


Symbol.infer_type_partial = _sym_infer_type_partial


def _sym_gradient(self, wrt):
    """Reference Symbol.gradient is unimplemented in MXNet 1.x as well
    (autodiff happens in bind/executor); keep the same contract."""
    raise MXNetError(
        "Symbol.gradient is not supported (same as the reference); "
        "gradients come from Executor.backward / autograd")


Symbol.gradient = _sym_gradient


def _sym_get_backend_symbol(self, backend):
    """Subgraph-backend partitioning (MKLDNN/TensorRT) has no analogue
    here. Returns self so pipelines that call it unconditionally keep
    working."""
    return self


Symbol.get_backend_symbol = _sym_get_backend_symbol
