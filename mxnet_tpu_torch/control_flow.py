"""Control flow: ``nd.contrib.{foreach, while_loop, cond}`` and the
symbolic ``sym.contrib`` counterparts (port of
``mxnet_tpu/control_flow.py``; reference: python/mxnet/ndarray/contrib.py
foreach :136, while_loop :232, cond :400, and
python/mxnet/symbol/contrib.py :212, :375, :598).

Two modes, as in the reference:

* eager (NDArray): Python loops over ``nd`` ops. The autograd tape
  records every step op by op, so gradients flow to the loop bodies and
  to closure-captured arrays as in the reference's imperative mode. Trip
  counts are dynamic.
* symbolic (Symbol): the body is traced once into a subgraph Symbol that
  becomes a static attribute of a ``_foreach``/``_while_loop``/``_cond``
  node (``ops/control_flow_ops.py`` runs it step by step). Free
  variables captured from the enclosing scope are found by diffing the
  subgraph's arguments against the loop-local variables (the
  reference's _cut_subgraph pass) and appended as node inputs, so
  gradients reach them.

A body that captures an intermediate (not a variable) re-evaluates its
upstream graph inside the loop, as in the JAX package.
"""

from . import ndarray as nd
from . import symbol as _sym

__all__ = ["foreach", "while_loop", "cond",
           "sym_foreach", "sym_while_loop", "sym_cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _like(template, lst):
    """Return lst with the container structure of template (single
    element unwrapped when template was a bare array/symbol)."""
    return lst if isinstance(template, (list, tuple)) else lst[0]


# ---------------------------------------------------------------- eager --

def foreach(body, data, init_states):
    """Eager scan: body(data_slice, states) -> (outputs, new_states),
    applied over axis 0 of `data` (ndarray/contrib.py:136)."""
    data_list = _as_list(data)
    n = data_list[0].shape[0]
    if n == 0:
        raise ValueError("foreach input has zero length")
    states = init_states
    per_step = []
    for i in range(n):
        xs = [d[i] for d in data_list]
        outs, states = body(_like(data, xs), states)
        per_step.append(_as_list(outs))
    stacked = [nd.stack(*[step[j] for step in per_step], axis=0)
               for j in range(len(per_step[0]))]
    return (stacked[0] if len(stacked) == 1 else stacked, states)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Eager while loop (ndarray/contrib.py:232): runs func while
    cond(*loop_vars) is true, at most max_iterations times. Outputs are
    stacked along axis 0 and padded with zeros to max_iterations (the
    reference leaves the tail undefined; zeros are deterministic)."""
    if max_iterations is None:
        raise ValueError("max_iterations must be specified")
    max_iterations = int(max_iterations)
    if max_iterations <= 0:
        raise ValueError("max_iterations must be positive")
    loop_vars = _as_list(loop_vars)
    steps = []
    n_steps = 0
    while n_steps < max_iterations and \
            bool(cond(*loop_vars).asnumpy().reshape(())):
        outs, new_vars = func(*loop_vars)
        loop_vars = _as_list(new_vars)
        steps.append(_as_list(outs))
        n_steps += 1
    if not steps:
        raise ValueError(
            "while_loop condition was never satisfied; step outputs "
            "cannot be inferred (reference ndarray-mode behavior)")
    n_out = len(steps[0])
    stacked = []
    for j in range(n_out):
        rows = [step[j] for step in steps]
        pad = max_iterations - len(rows)
        if pad:
            rows.extend([nd.zeros_like(rows[0])] * pad)
        stacked.append(nd.stack(*rows, axis=0))
    return (stacked[0] if n_out == 1 else stacked,
            loop_vars[0] if len(loop_vars) == 1 else loop_vars)


def cond(pred, then_func, else_func):
    """Eager branch (ndarray/contrib.py:400): evaluates only the taken
    branch. then_func/else_func take no arguments (closures)."""
    taken = bool(pred.asnumpy().reshape(()))
    return then_func() if taken else else_func()


# ------------------------------------------------------------- symbolic --

def _subgraph_free_inputs(subgraph, local_names):
    """Names + outer Symbols of subgraph arguments that were captured
    from the enclosing scope (everything except the loop-local vars)."""
    free = []
    for node in subgraph._active_nodes():
        if node.is_var() and node.name not in local_names:
            free.append((node.name, _sym.Symbol([node], [(0, 0)])))
    return free


def sym_foreach(body, data, init_states, name=None):
    """Symbolic foreach (symbol/contrib.py:212): traces body into a
    subgraph and emits a `_foreach` node."""
    name = _sym._auto_name("_foreach", name)
    data_list = _as_list(data)
    states_list = _as_list(init_states)
    data_vars = [_sym.var("%s_data%d" % (name, i))
                 for i in range(len(data_list))]
    state_vars = [_sym.var("%s_state%d" % (name, i))
                  for i in range(len(states_list))]
    outs, new_states = body(_like(data, data_vars),
                            _like(init_states, state_vars))
    out_list = _as_list(outs)
    new_state_list = _as_list(new_states)
    assert len(new_state_list) == len(states_list), \
        "body must return as many states as init_states"
    subgraph = _sym.Group(out_list + new_state_list)
    local = set(v.name for v in data_vars + state_vars)
    free = _subgraph_free_inputs(subgraph, local)
    sub_in_names = tuple([v.name for v in data_vars] +
                         [v.name for v in state_vars] +
                         [n for n, _ in free])
    attrs = {
        "subgraph": subgraph,
        "sub_in_names": sub_in_names,
        "num_data": len(data_list),
        "num_out_data": len(out_list),
        "num_states": len(states_list),
        "__num_outputs__": len(out_list) + len(states_list),
    }
    node_sym = _sym._compose(
        "_foreach", data_list + states_list + [s for _, s in free],
        attrs, name)
    outs_syms = [node_sym[i] for i in range(len(out_list))]
    state_syms = [node_sym[len(out_list) + i]
                  for i in range(len(states_list))]
    return (_like(outs, outs_syms) if len(outs_syms) > 1 or
            isinstance(outs, (list, tuple)) else outs_syms[0],
            _like(init_states, state_syms))


def sym_while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """Symbolic while_loop (symbol/contrib.py:375): cond and func are
    traced into subgraphs; emits `_while_loop`."""
    if max_iterations is None:
        raise ValueError("max_iterations must be specified")
    name = _sym._auto_name("_while_loop", name)
    vars_list = _as_list(loop_vars)
    var_vars = [_sym.var("%s_var%d" % (name, i))
                for i in range(len(vars_list))]
    cond_out = cond(*var_vars)
    outs, new_vars = func(*var_vars)
    out_list = _as_list(outs)
    new_var_list = _as_list(new_vars)
    assert len(new_var_list) == len(vars_list), \
        "func must return as many loop_vars as it consumes"
    cond_graph = _sym.Group([cond_out])
    func_graph = _sym.Group(out_list + new_var_list)
    local = set(v.name for v in var_vars)
    free = {}
    for n, s in _subgraph_free_inputs(cond_graph, local):
        free.setdefault(n, s)
    for n, s in _subgraph_free_inputs(func_graph, local):
        free.setdefault(n, s)
    sub_in_names = tuple([v.name for v in var_vars] + list(free))
    attrs = {
        "cond_graph": cond_graph,
        "func_graph": func_graph,
        "sub_in_names": sub_in_names,
        "num_out_data": len(out_list),
        "num_vars": len(vars_list),
        "max_iterations": int(max_iterations),
        "__num_outputs__": len(out_list) + len(vars_list),
    }
    node_sym = _sym._compose(
        "_while_loop", vars_list + list(free.values()), attrs, name)
    outs_syms = [node_sym[i] for i in range(len(out_list))]
    var_syms = [node_sym[len(out_list) + i]
                for i in range(len(vars_list))]
    return (outs_syms[0] if len(outs_syms) == 1 else outs_syms,
            _like(loop_vars, var_syms))


def sym_cond(pred, then_func, else_func, name=None):
    """Symbolic cond (symbol/contrib.py:598): branches traced into
    subgraphs; emits `_cond`, which runs the branch it takes."""
    name = _sym._auto_name("_cond", name)
    then_out = _as_list(then_func())
    else_out = _as_list(else_func())
    assert len(then_out) == len(else_out), \
        "then and else branches must produce the same number of outputs"
    then_graph = _sym.Group(then_out)
    else_graph = _sym.Group(else_out)
    free = {}
    for n, s in _subgraph_free_inputs(then_graph, set()):
        free.setdefault(n, s)
    for n, s in _subgraph_free_inputs(else_graph, set()):
        free.setdefault(n, s)
    attrs = {
        "then_graph": then_graph,
        "else_graph": else_graph,
        "sub_in_names": tuple(free),
        "num_outputs_branch": len(then_out),
        "__num_outputs__": len(then_out),
    }
    node_sym = _sym._compose(
        "_cond", [pred] + list(free.values()), attrs, name)
    if len(then_out) == 1:
        return node_sym[0]
    return [node_sym[i] for i in range(len(then_out))]
