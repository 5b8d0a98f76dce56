"""Gluon Block / HybridBlock / SymbolBlock (port of
``mxnet_tpu/gluon/block.py``; reference: python/mxnet/gluon/block.py,
Block:131, HybridBlock:705, SymbolBlock:992).

``hybridize()`` traces ``hybrid_forward`` with Symbol proxies, as the
reference does, and runs the traced graph through a ``CachedOp``
(``cached_op.py``); un-hybridized, ``hybrid_forward`` runs with
``F = nd``, op by op. Both routes run the same torch ops. Parameters of
unknown shape are inferred from the first input through the traced
graph (deferred initialization). The reference's telemetry spans and
numpy-array outputs are not ported.
"""

import contextlib
import re
import threading

from .. import name as _name
from .. import ndarray as nd
from .. import symbol as _symbol
from ..base import MXNetError, dtype_name, torch_dtype
from ..cached_op import CachedOp
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _NamingState(threading.local):
    """Per-thread naming state: a stack of open ``name_scope`` frames
    plus the top-level hint counters.

    The auto-prefix CONTRACT is fixed by checkpoint parity with the
    reference (gluon/block.py _BlockScope): a block constructed with no
    explicit prefix is named ``<hint><index>_`` where the index counts
    hint uses within the enclosing scope (or within the thread, at top
    level), and children concatenate onto their parent's prefix. The
    mechanism here is this repo's own: one thread-local frame stack
    instead of a scope class threading save/restore pointers through
    static state.
    """

    def __init__(self):
        self.frames = []            # innermost-open-scope last
        self.top_counts = {}        # hint -> next index, outside scopes

    def sequence_number(self, hint):
        """Next per-hint index at the current nesting level."""
        counts = self.frames[-1].counts if self.frames \
            else self.top_counts
        idx = counts.get(hint, 0)
        counts[hint] = idx + 1
        return idx

    def owner(self):
        """The block whose ``name_scope`` is innermost, or None."""
        return self.frames[-1].block if self.frames else None


_NAMING = _NamingState()


class _Frame(object):
    """One block's naming frame: its per-hint child counters. Pushed on
    the thread's frame stack for the duration of ``name_scope``."""

    __slots__ = ("block", "counts")

    def __init__(self, block):
        self.block = block
        self.counts = {}


def _derive_identity(prefix, params, hint):
    """Resolve a new Block's (full_prefix, ParameterDict) from the
    enclosing ``name_scope``, its constructor arguments, and the
    auto-naming contract (see _NamingState)."""
    # identity checks throughout: container blocks define __len__, so
    # an empty Sequential is falsy yet very much an owner
    owner = _NAMING.owner()
    if prefix is None:
        prefix = "%s%d_" % (hint, _NAMING.sequence_number(hint))
    full_prefix = prefix if owner is None else owner.prefix + prefix
    if params is not None:
        # explicit sharing: reuse the donor dict's names verbatim
        pdict = ParameterDict(params.prefix, params)
    elif owner is not None:
        # child dict: named under the parent, sharing the parent's pool
        parent = owner.params
        pdict = ParameterDict(parent.prefix + prefix, parent._shared)
    else:
        pdict = ParameterDict(full_prefix)
    return full_prefix, pdict


def _flatten(args, fmt_name):
    """Flatten a nested list/tuple structure of NDArrays/Symbols into a
    flat list plus a structure spec (0 = one array, -1 = a None slot,
    list = nesting) that ``_regroup`` inverts (the reference's
    _flatten/_regroup contract, gluon/block.py:53)."""
    flat = []

    def walk(node):
        if isinstance(node, (nd.NDArray, _symbol.Symbol)):
            flat.append(node)
            return 0
        if node is None:
            flat.append(None)
            return -1
        if isinstance(node, (list, tuple)):
            return [walk(item) for item in node]
        raise ValueError(
            "When hybridized, the input of HybridBlock %s must be "
            "(nested) list of Symbol or NDArray, but got %s of type %s"
            % (fmt_name, node, type(node)))

    spec = walk(args)
    return flat, spec


def _regroup(args, fmt):
    """Rebuild the nested structure described by ``fmt`` from the flat
    ``args`` list; returns (structure, leftover_args)."""
    def take(spec, pos):
        if spec == -1:
            return None, pos + 1
        if spec == 0:
            return args[pos], pos + 1
        if isinstance(spec, int):
            return args[pos:pos + spec], pos + spec
        out = []
        for sub in spec:
            item, pos = take(sub, pos)
            out.append(item)
        return out, pos

    structure, used = take(fmt, 0)
    return structure, args[used:]


class Block(object):
    """Base class for all neural network layers and models
    (python/mxnet/gluon/block.py:131).

    Childs and Parameters set as attributes are registered automatically;
    ``collect_params()`` returns the full ParameterDict of the subtree.
    """

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _derive_identity(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._frame = _Frame(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def __repr__(self):
        children = [(attr, val) for attr, val in self.__dict__.items()
                    if isinstance(val, Block)]
        body = "\n".join("  (%s): %s" % (attr, repr(val).replace(
            "\n", "\n  ")) for attr, val in children)
        return "%s(\n%s\n)" % (type(self).__name__, body)

    def __setattr__(self, name, value):
        prev = getattr(self, name, None)
        if isinstance(prev, (Parameter, Block)):
            # re-binding a registered attribute must keep its kind:
            # related types are fine (subclass either way), a kind
            # switch is a user error
            related = isinstance(value, type(prev)) \
                or isinstance(prev, type(value))
            if not related:
                raise TypeError(
                    "Changing attribute type for %s from %s to %s is not "
                    "allowed." % (name, type(prev), type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            taken = self._reg_params.get(name)
            assert taken is None or taken is value, \
                "Overriding Parameter attribute %s is not allowed. " \
                "If you want to share parameters between blocks, please " \
                "set 'params' at Block construction instead." % name
            self._reg_params[name] = value
        super(Block, self).__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    # ---------------------------------------------------------- naming --
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @contextlib.contextmanager
    def name_scope(self):
        """Context manager under which children and symbols are named
        as descendants of this block. Each entry pushes this block's
        naming frame (child indices persist across re-entries, so
        ``with net.name_scope()`` twice keeps counting where it left
        off) and routes op naming through a ``Prefix`` manager; an
        empty-prefix block scopes nothing."""
        if self._empty_prefix:
            yield
            return
        _NAMING.frames.append(self._frame)
        try:
            with _name.Prefix(self._prefix):
                yield
        finally:
            _NAMING.frames.pop()

    @property
    def params(self):
        """Returns this Block's parameter dictionary (does not include its
        children's parameters)."""
        return self._params

    def _subtree(self):
        """Pre-order iterator over this block and every descendant."""
        yield self
        for child in self._children.values():
            yield from child._subtree()

    def collect_params(self, select=None):
        """Returns a ParameterDict containing this Block's and all of its
        children's Parameters, optionally filtered by regex ``select``."""
        keep = re.compile(select).match if select else None
        ret = ParameterDict(self._params.prefix)
        for blk in self._subtree():
            chosen = blk.params.items() if keep is None else \
                ((n, p) for n, p in blk.params.items() if keep(n))
            ret.update(dict(chosen))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """{structural dotted path: Parameter} over the subtree — the
        naming scheme save_parameters/load_parameters share."""
        found = {}
        todo = [(prefix, self)]
        while todo:
            path, blk = todo.pop()
            dot = path + "." if path else ""
            found.update((dot + key, val)
                         for key, val in blk._reg_params.items())
            todo.extend(reversed([(dot + name, child)
                                  for name, child in
                                  blk._children.items()]))
        return found

    # ---------------------------------------------------------- children --
    def register_child(self, block, name=None):
        key = str(len(self._children)) if name is None else name
        self._children[key] = block

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return hook

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return hook

    def apply(self, fn):
        """Applies ``fn`` to every block in the subtree, children before
        parents (post-order)."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    # -------------------------------------------------------------- io --
    def save_parameters(self, filename, deduplicate=False):
        """Saves parameters to file using structural naming
        (gluon/block.py:319)."""
        def fetch(param):
            reduce_fn = getattr(param, "_reduce", None)
            return reduce_fn() if reduce_fn is not None else param.data()
        nd.save(filename, {key: fetch(val) for key, val in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Loads parameters from file (gluon/block.py:361). Accepts both
        structural-name files (save_parameters) and full-name files
        (collect_params().save)."""
        loaded = nd.load(filename, ctx=ctx[0] if isinstance(
            ctx, (list, tuple)) else ctx)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        structural = any("." in key for key in loaded)
        if not structural:
            # full parameter names — a legacy collect_params().save file
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        missing = [n for n in params if n not in loaded]
        assert allow_missing or not missing, \
            "Parameter '%s' is missing in file '%s'" % \
            (missing[0] if missing else "", filename)
        for name, value in loaded.items():
            target = params.get(name)
            if target is None:
                assert ignore_extra, \
                    "Parameter '%s' loaded from file '%s' is not present " \
                    "in this block" % (name, filename)
                continue
            target._load_init(value, ctx, cast_dtype=cast_dtype,
                              dtype_source=dtype_source)

    save_params = save_parameters
    load_params = load_parameters

    # ------------------------------------------------------------- init --
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initializes Parameters of this Block and its children."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Activates or deactivates HybridBlock children recursively."""
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter in the subtree (post-order, matching
        apply())."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    # ------------------------------------------------------------- call --
    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        """Overridden by users: imperative computation over NDArray."""
        raise NotImplementedError

    def summary(self, *inputs):
        """Print a table of layer outputs and params for given inputs."""
        summary = []
        hooks = []

        def _register(block):
            def hook(blk, ins, outs):
                n_params = sum(
                    int(p.data().size) for p in blk.params.values()
                    if p._data is not None)
                first = outs[0] if isinstance(outs, (list, tuple)) else outs
                summary.append((blk.name, type(blk).__name__,
                                getattr(first, "shape", None), n_params))
            hooks.append(block.register_forward_hook(hook))

        self.apply(_register)
        try:
            self(*inputs)
            lines = ["%-30s %-20s %-20s %10s" %
                     ("Layer (name)", "Type", "Output Shape", "Params")]
            lines.append("-" * 84)
            total = 0
            for name, tname, shape, n in summary:
                total += n
                lines.append("%-30s %-20s %-20s %10d"
                             % (name, tname, str(shape), n))
            lines.append("-" * 84)
            lines.append("Total params: %d" % total)
            print("\n".join(lines))
        finally:
            def _clean(blk):
                blk._forward_hooks = [h for h in blk._forward_hooks
                                      if h not in hooks]
            self.apply(_clean)


class HybridBlock(Block):
    """A Block that supports hybridization: forwarding with NDArray or
    Symbol, and compilation of the traced graph via CachedOp
    (python/mxnet/gluon/block.py:705)."""

    def __init__(self, prefix=None, params=None):
        super(HybridBlock, self).__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = []
        self._clear_cached_op()

    def __setattr__(self, name, value):
        super(HybridBlock, self).__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super(HybridBlock, self).register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = list(kwargs.items())
        self._clear_cached_op()
        super(HybridBlock, self).hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super(HybridBlock, self).cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None
        self._cached_op_args = []   # (is_data, slot-or-Parameter) pairs

    # ------------------------------------------------------------ trace --
    def _get_graph(self, *args):
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(args, "input")
            real = [a for a in flat_args if a is not None]
            if len(real) == 1:
                syms = [_symbol.var("data")]
            else:
                syms = [_symbol.var("data%d" % i) for i in range(len(real))]
            it = iter(syms)
            grouped = [next(it) if a is not None else None for a in flat_args]
            grouped_args, _ = _regroup(grouped, self._in_format)
            if not isinstance(grouped_args, (list, tuple)):
                grouped_args = [grouped_args]
            params = {name: p.var() for name, p in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(_symbol, *grouped_args, **params)
            flat_out, self._out_format = _flatten(out, "output")
            if len(flat_out) > 1:
                self._cached_graph = (syms, _symbol.Group(flat_out))
            else:
                self._cached_graph = (syms, flat_out[0])
        return self._cached_graph

    def infer_shape(self, *args):
        """Infers shape of Parameters from inputs."""
        self._deferred_infer_shape(*args)

    def infer_type(self, *args):
        """Infers dtype of Parameters from inputs (reference
        HybridBlock.infer_type). Parameters follow the input dtype —
        under the bf16 AMP policy a float16/bfloat16 example input casts
        the float parameters accordingly."""
        flat_args, _ = _flatten(args, "input")
        real = [a for a in flat_args if a is not None]
        if not real:
            return
        dtype = real[0]._data.dtype
        if not dtype.is_floating_point:
            return
        for param in self.collect_params().values():
            if param._data is not None and \
                    torch_dtype(param.dtype).is_floating_point:
                param.cast(dtype)

    def _deferred_infer_shape(self, *args):
        try:
            inputs, out = self._get_graph(*args)
            flat_args, _ = _flatten(args, "input")
            real = [a for a in flat_args if a is not None]
            # stamp the REAL input dtypes onto the data vars: the
            # graph walk evaluates ops dtype-aware, and a cast()
            # network (bf16 weights) fed by a default-fp32 data var
            # hits mixed-dtype eval errors mid-graph, silently
            # stranding every later parameter shape as unknown
            for i, a in zip(inputs, real):
                i._set_attr(__dtype__=dtype_name(a.dtype))
            kwargs = {i.name: a.shape for i, a in zip(inputs, real)}
            arg_shapes, _, aux_shapes = out.infer_shape_partial(**kwargs)
            sdict = dict(zip(out.list_arguments(), arg_shapes))
            sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
            for name, param in self.collect_params().items():
                shp = sdict.get(name)
                if shp is not None:
                    param.shape = shp
        except MXNetError:
            raise       # a refusal (an op not ported yet) names its item
        except Exception as e:
            raise ValueError(
                "Deferred initialization failed because shape cannot be "
                "inferred: %s" % e)

    # ------------------------------------------------------------ cache --
    def _build_cache(self, *args):
        inputs, out = self._get_graph(*args)
        by_name = {p.name: p for p in self.collect_params().values()}
        slot_of = {sym.name: idx for idx, sym in enumerate(inputs)}
        plan = []
        for name in out.list_inputs():
            if name in slot_of:
                plan.append((True, slot_of[name]))
            elif name in by_name:
                plan.append((False, by_name[name]))
            else:
                raise AssertionError(
                    "Unknown input to HybridBlock: %s" % name)
        self._cached_op_args = plan
        self._cached_op = CachedOp(out, self._flags)

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            self._build_cache(*args)
        real = [a for a in _flatten(args, "input")[0] if a is not None]
        # arg structure changed since the trace (e.g. an RNN layer called
        # with and without explicit begin_state) -> retrace
        n_traced = sum(1 for is_data, _ in self._cached_op_args if is_data)
        if n_traced != len(real):
            self._clear_cached_op()
            self._build_cache(*args)
        out = self._cached_op(*[
            real[slot] if is_data else slot.data()
            for is_data, slot in self._cached_op_args])
        if len(out) == 1 and self._out_format == 0:
            return out[0]
        return _regroup(list(out), self._out_format)[0]

    # ---------------------------------------------------------- forward --
    def _materialize_params(self, x, *args):
        """Live param arrays for hybrid_forward; on a deferred init,
        infer shapes from the inputs, finish initialization, retry."""
        try:
            return {name: p.data()
                    for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_infer_shape(x, *args)
            for p in self.collect_params().values():
                p._finish_deferred_init()
            return {name: p.data()
                    for name, p in self._reg_params.items()}

    def forward(self, x, *args):
        """Defines the forward computation; dispatches to
        ``hybrid_forward`` with F=ndarray or F=symbol."""
        if isinstance(x, _symbol.Symbol):
            params = {name: p.var()
                      for name, p in self._reg_params.items()}
            with self.name_scope():
                return self.hybrid_forward(_symbol, x, *args, **params)
        if not isinstance(x, nd.NDArray):
            raise AssertionError(
                "HybridBlock requires the first argument to forward be "
                "either Symbol or NDArray, but got %s" % type(x))
        if self._active:
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                self._deferred_infer_shape(x, *args)
                for p in self.collect_params().values():
                    p._finish_deferred_init()
                return self._call_cached_op(x, *args)
        params = self._materialize_params(x, *args)
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Overridden by users: computation over ``F`` (mx.nd or mx.sym)."""
        raise NotImplementedError

    # ------------------------------------------------------------ export --
    def export(self, path, epoch=0):
        """Exports traced symbol + params for deployment
        (gluon/block.py:907): path-symbol.json and path-NNNN.params."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = self._cached_graph[1]
        sym.save("%s-symbol.json" % path)

        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in arg_names:
                arg_dict["arg:%s" % name] = param.data()
            elif name in aux_names:
                arg_dict["aux:%s" % name] = param.data()
        nd.save("%s-%04d.params" % (path, epoch), arg_dict)
        return sym


class SymbolBlock(HybridBlock):
    """Construct a Block from a Symbol (gluon/block.py:992) — the importer
    for exported models."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        names = [input_names] if isinstance(input_names, str) \
            else input_names
        block = SymbolBlock(_symbol.load(symbol_file),
                            [_symbol.var(n) for n in names])
        if param_file is not None:
            block.collect_params().load(
                param_file, ctx=ctx, cast_dtype=True,
                dtype_source="saved", allow_missing=False,
                ignore_extra=False)
        return block

    def __init__(self, outputs, inputs, params=None):
        super(SymbolBlock, self).__init__(prefix=None, params=None)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = _symbol.Group(outputs)
        if isinstance(inputs, _symbol.Symbol):
            inputs = [inputs]

        syms, self._in_format = _flatten(inputs, "input")
        out = outputs
        input_names = set(s.name for s in syms)

        for name in out.list_arguments():
            if name not in input_names:
                p = self._params.get(name, allow_deferred_init=True)
                self._reg_params[name] = p
        for name in out.list_auxiliary_states():
            if name not in input_names:
                p = self._params.get(name, grad_req="null",
                                     allow_deferred_init=True)
                self._reg_params[name] = p

        self._cached_graph = syms, out
        self._build_cache_from_graph()

    def _build_cache_from_graph(self):
        inputs, out = self._cached_graph
        by_name = {p.name: p for p in self._params.values()}
        slot_of = {sym.name: idx for idx, sym in enumerate(inputs)}
        self._cached_op_args = [
            (True, slot_of[name]) if name in slot_of
            else (False, by_name[name]) for name in out.list_inputs()]
        self._cached_op = CachedOp(out, self._flags)
        self._out_format = _flatten(
            [out] if len(out.list_outputs()) == 1 else
            [out[i] for i in range(len(out.list_outputs()))], "output")[1]
        if len(out.list_outputs()) == 1:
            self._out_format = 0

    def forward(self, x, *args):
        if isinstance(x, _symbol.Symbol):
            return self._cached_graph[1]
        if not isinstance(x, nd.NDArray):
            raise AssertionError(
                "SymbolBlock requires Symbol or NDArray input")
        try:
            return self._call_cached_op(x, *args)
        except DeferredInitializationError:
            self._deferred_infer_shape(x, *args)
            for p in self._params.values():
                p._finish_deferred_init()
            return self._call_cached_op(x, *args)

    def _call_cached_op(self, *args):
        real = [a for a in _flatten(args, "input")[0] if a is not None]
        out = self._cached_op(*[
            real[slot] if is_data else slot.data()
            for is_data, slot in self._cached_op_args])
        return out[0] if len(out) == 1 else list(out)

    def _clear_cached_op(self):
        tmp = getattr(self, "_cached_graph", ())
        super(SymbolBlock, self)._clear_cached_op()
        self._cached_graph = tmp

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
