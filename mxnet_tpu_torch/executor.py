"""Executor — bound symbolic graphs run with torch ops (port of
``mxnet_tpu/executor.py``; reference: src/executor/graph_executor.cc).

``build_graph_fn(symbol, is_train)`` turns a Symbol into a function
``fn(arg_dict, aux_dict, generator) -> (outputs, new_aux)`` over torch
tensors: each node's op runs in topological order, and in training each
BatchNorm's batch statistics fold into its running statistics,
``momentum * old + (1 - momentum) * stat`` in the aux arrays' dtype, out
of the autograd graph (the reference op mutates its aux states in
place; here the new values are returned). Stateful-RNG ops draw from the
``generator`` given, and an op that takes a ``device`` (the zero-input
ops: ``_zeros``, ``_arange``, the scalar samplers, ...) gets the graph's
device: the ``device`` given (the executor's context, a CachedOp's
inputs'), else the first argument's. With ``node_device`` (the ``group2ctx`` placement
pass, graph_executor.cc:997) every node runs on its device: its inputs
move there first, a transfer at each group boundary, and the copies are
differentiable, so gradients flow back across them.

``Executor`` (``Symbol.bind``/``simple_bind``) runs that function:
``forward(is_train=True)`` records the graph with torch.autograd and
``backward(out_grads)`` takes the gradients of the arguments whose
``grad_req`` is not "null", as often as it is called, until the next
forward. ``group2ctx`` places the nodes that carry a ``__ctx_group__``
attribute on their group's device and the rest on the default context;
each argument, gradient and auxiliary array moves at bind to the device
of the variable that owns it, and the placed graph runs op by op (as the
JAX package's placed graphs run unjitted). ``transfers`` lists the
boundary copies of the last forward and backward. The reference's
gradient mirroring (``MXNET_BACKWARD_DO_MIRROR``, a TPU memory lever) and
its observability and NaN-guard hooks are not ported.
"""

import torch

from . import ops
from . import random as _random
from .base import MXNetError


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith("__")}


def _node_call(node, is_train):
    """(fn(*inputs) -> op output, whether the op draws random numbers)
    for one graph node; ``fn`` takes ``generator`` and ``device``
    keywords, passed on to an op that declares them."""
    op = ops.get(node.op)
    attrs = _clean_attrs(node.attrs)
    has_varargs, param_names = ops.op_dispatch_meta(op)
    if "is_train" in param_names:
        attrs["is_train"] = is_train
    in_names = node.attrs.get("__input_names__")
    rng = op.stateful_rng and "generator" in param_names
    wants_device = "device" in param_names

    def fn(*ins, generator=None, device=None):
        call = dict(attrs)
        if rng:
            call["generator"] = generator
        if wants_device:
            call["device"] = device
        if has_varargs:
            return op.fn(*ins, **call)
        if in_names:
            call.update(zip(in_names, ins))
        else:
            pnames = [p for p in param_names if p not in call]
            call.update(zip(pnames, ins))
        return op.fn(**call)

    return fn, rng


def node_eval_fn(node):
    """fn(*input_tensors) for one graph node, in inference mode (used by
    shape inference on meta tensors: a zero-input op makes its output
    there too)."""
    fn, _ = _node_call(node, is_train=False)
    meta = torch.device("meta")
    return lambda *ins: fn(*ins, device=meta)


def build_graph_fn(symbol, is_train, node_device=None, transfers=None):
    """fn(arg_dict, aux_dict, generator, device) -> (outputs list, new_aux
    dict) over torch tensors; ``device`` (default: the first argument's)
    is where a node that takes one makes its output. ``node_device``
    (node -> torch.device or None) places each node: its inputs are
    copied to its device when they lie elsewhere, and each copy is
    appended to the list ``transfers`` as (source device, destination
    device, bytes); a placed node that draws random numbers draws from
    its device's generator."""
    all_nodes = symbol._nodes
    nodes = symbol._active_nodes()
    out_refs = [(all_nodes[ni], oi) for ni, oi in symbol._outputs]
    plan = []
    for node in nodes:
        if node.is_var():
            plan.append((node, None, False, ()))
            continue
        fn, rng = _node_call(node, is_train)
        folds = ()
        if node.op == "BatchNorm" and is_train \
                and not node.attrs.get("use_global_stats", False):
            names = list(node.attrs.get("__input_names__", ()))
            folds = tuple(
                (k, node.inputs[names.index(pname)][0]._nodes[
                    node.inputs[names.index(pname)][0]._outputs[0][0]].name)
                for k, pname in ((1, "moving_mean"), (2, "moving_var"))
                if pname in names)
        plan.append((node, fn, rng, folds))

    def place(node, t):
        dev = None if node_device is None else node_device(node)
        if dev is None or t.device == dev:
            return t
        if transfers is not None:
            transfers.append((t.device, dev, t.numel() * t.element_size()))
        return _Transfer.apply(t, dev, transfers)

    def graph_fn(arg_arrays, aux_arrays, generator=None, device=None):
        vals = {}
        aux_updates = {}
        if device is None and arg_arrays:
            device = next(iter(arg_arrays.values())).device
        for node, fn, rng, folds in plan:
            if fn is None:
                name = node.name
                if name in arg_arrays:
                    vals[(id(node), 0)] = place(node, arg_arrays[name])
                elif name in aux_arrays:
                    vals[(id(node), 0)] = place(node, aux_arrays[name])
                else:
                    raise MXNetError("unbound variable %s" % name)
                continue
            ins = [place(node, vals[(id(s._nodes[s._outputs[0][0]]), oi)])
                   for s, oi in node.inputs]
            dev = None if node_device is None else node_device(node)
            dev = device if dev is None else dev
            gen = generator
            if rng and gen is not None and dev is not None \
                    and gen.device != dev:
                gen = _random.generator(dev)
            out = fn(*ins, generator=gen, device=dev)
            if node.op == "BatchNorm":
                # the batch statistics are plumbing, not outputs; in
                # training they fold into the running statistics
                vals[(id(node), 0)] = out[0]
                mom = float(node.attrs.get("momentum", 0.9))
                with torch.no_grad():
                    for k, aux_name in folds:
                        old = aux_arrays[aux_name]
                        aux_updates[aux_name] = mom * old + (1 - mom) * \
                            out[k].detach().to(old.device)
                continue
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for k, o in enumerate(outs):
                vals[(id(node), k)] = o
        return [vals[(id(node), oi)] for node, oi in out_refs], aux_updates

    return graph_fn


class _Transfer(torch.autograd.Function):
    """A copy to another device whose backward copies the gradient back,
    each copy recorded in ``transfers``."""

    @staticmethod
    def forward(ctx, x, dev, transfers):
        ctx.src, ctx.transfers = x.device, transfers
        return x.to(dev)

    @staticmethod
    def backward(ctx, g):
        if ctx.transfers is not None:
            ctx.transfers.append((g.device, ctx.src,
                                  g.numel() * g.element_size()))
        return g.to(ctx.src), None, None


def needs_rng(symbol):
    """Whether a graph holds an op that draws random numbers."""
    return any(ops.get(n.op).stateful_rng
               for n in symbol._active_nodes() if not n.is_var())


class Executor:
    """Bound executor (python/mxnet/executor.py wrapper semantics)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        from . import ndarray as nd
        self._symbol = symbol
        self._ctx = ctx
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        self.arg_dict = {k: v if isinstance(v, nd.NDArray)
                         else nd.array(v, ctx=ctx) for k, v in args.items()}
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_dict = args_grad or {}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        self.aux_dict = aux_states or {}

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req)

        self._diff_args = [n for n in arg_names
                           if self._grad_req.get(n, "null") != "null"
                           and n in self.grad_dict]
        self.outputs = []
        self._recorded = None
        self._needs_rng = needs_rng(symbol)
        self._group2ctx = dict(group2ctx or {})
        self.transfers = []
        node_device = self._place(ctx) if self._group2ctx else None
        self._infer_fn = build_graph_fn(symbol, False, node_device,
                                        self.transfers)
        self._train_fn = build_graph_fn(symbol, True, node_device,
                                        self.transfers)

    def _place(self, ctx):
        """The group2ctx pass (graph_executor.cc:997): node -> device, a
        grouped node on its group's context and the rest on ``ctx``; each
        variable's argument, gradient and auxiliary arrays move to its
        device now."""
        def node_ctx(node):
            return self._group2ctx.get(node.attrs.get("__ctx_group__"), ctx)

        def node_device(node):
            return node_ctx(node).torch_device

        for node in self._symbol._active_nodes():
            if not node.is_var():
                continue
            for arrays in (self.arg_dict, self.grad_dict, self.aux_dict):
                arr = arrays.get(node.name)
                if arr is not None:
                    c = node_ctx(node)
                    arr._data = arr._data.to(c.torch_device)
                    arr._ctx = c
        return node_device

    # ------------------------------------------------------------ run ---
    def forward(self, is_train=False, **kwargs):
        """is_train=True records the graph for ``backward`` (with whatever
        head gradients it is given, ones by default) and updates the
        BatchNorm running statistics in ``aux_dict``; is_train=False is
        pure inference."""
        from . import ndarray as nd
        del self.transfers[:]
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(
                    "forward got unknown argument %r (bound arguments: %s)"
                    % (k, sorted(self.arg_dict)))
            tgt = self.arg_dict[k]
            tgt._set_data(v._data if isinstance(v, nd.NDArray)
                          else nd.array(v, ctx=tgt.context)._data)
        aux_arrays = {k: v._data for k, v in self.aux_dict.items()}
        device = self._ctx.torch_device
        gen = _random.generator(device) if self._needs_rng else None
        if is_train:
            leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                      for n in self._diff_args
                      if self.arg_dict[n]._data.dtype.is_floating_point}
            arg_arrays = {k: leaves.get(k, v._data.detach())
                          for k, v in self.arg_dict.items()}
            with torch.enable_grad():
                outs, aux_up = self._train_fn(arg_arrays, aux_arrays, gen,
                                              device)
            self._recorded = (outs, leaves)
            for name, val in aux_up.items():
                self.aux_dict[name]._set_data(val)
        else:
            self._recorded = None
            arg_arrays = {k: v._data.detach()
                          for k, v in self.arg_dict.items()}
            with torch.no_grad():
                outs, _ = self._infer_fn(arg_arrays, aux_arrays, gen, device)
        # a placed graph's outputs take the context of the device they lie on
        ctx = None if self._group2ctx else self._ctx
        self.outputs = [nd.NDArray(o.detach(), ctx) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        from . import ndarray as nd
        if self._recorded is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._recorded
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            heads = [g._data if isinstance(g, nd.NDArray)
                     else torch.as_tensor(g) for g in out_grads]
            heads = [h.to(device=o.device, dtype=o.dtype)
                     for h, o in zip(heads, outs)]
        live = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if live and names:
            grads = torch.autograd.grad(
                [o for o, _ in live], [leaves[n] for n in names],
                grad_outputs=[h for _, h in live], retain_graph=True,
                allow_unused=True)
        for name, g in zip(names, grads):
            tgt = self.grad_dict[name]
            g = torch.zeros_like(leaves[name]) if g is None else g
            g = g.to(tgt._data.dtype)
            if self._grad_req.get(name, "write") == "add":
                tgt._data = tgt._data + g
            else:
                tgt._data = g

    # ------------------------------------------------------- utilities --
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._symbol.list_auxiliary_states()]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                tgt = self.arg_dict[k]
                tgt._set_data(v._data.to(device=tgt._data.device,
                                         dtype=tgt._data.dtype))
            elif not allow_extra_params:
                raise MXNetError("unknown parameter %s" % k)
        if aux_params:
            for k, v in aux_params.items():
                if k in self.aux_dict:
                    tgt = self.aux_dict[k]
                    tgt._set_data(v._data.to(tgt._data.device))
                elif not allow_extra_params:
                    raise MXNetError("unknown aux state %s" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """graph_executor.cc:876 Reshape: arrays whose shape changes are
        made anew (zeros); the graph function runs at any shape."""
        from . import ndarray as nd
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        for name, shp in zip(self._symbol.list_arguments(), arg_shapes):
            cur = self.arg_dict[name]
            if tuple(cur.shape) != tuple(shp):
                self.arg_dict[name] = nd.zeros(shp, ctx=self._ctx, dtype=cur.dtype)
                if name in self.grad_dict and self.grad_dict[name] is not None:
                    self.grad_dict[name] = nd.zeros(shp, ctx=self._ctx,
                                                    dtype=cur.dtype)
        return self
