"""Control-flow operators: ``_foreach``, ``_while_loop``, ``_cond`` (port
of ``mxnet_tpu/ops/control_flow_ops.py``; reference:
src/operator/control_flow.cc, _foreach :1089, _while_loop :1150, _cond
:1211).

The subgraph (a Symbol) is a static attribute of the node. Each op turns
it into a function on torch tensors (``executor.build_graph_fn``) and
runs it step by step as a Python loop, as the reference's engine runs
the subgraph node by node per iteration (the JAX package lowers the same
graphs onto ``lax.scan``/``lax.cond``). torch.autograd records every
step, so gradients reach the data, the states and the free variables
(the closure captures, appended as inputs after the loop's own).

``_while_loop``'s outputs have ``max_iterations`` rows: the rows past
the trip count are zeros and the loop variables keep their last values,
as JAX's masked scan leaves them. ``_cond`` runs only the branch it
takes. A stateful body (dropout, a sampler) draws from the
``generator`` the op is given, afresh at each step.

On ``meta`` tensors (shape inference) ``_while_loop`` and ``_cond``
cannot read their predicate: they give the shapes of one step stacked
``max_iterations`` times, and of the then-branch.
"""

import torch

from . import register


def _graph_fn(subgraph, is_train):
    from ..executor import build_graph_fn
    return build_graph_fn(subgraph, is_train)


def _device(arrays, device):
    return arrays[0].device if arrays else device


@register(name="_foreach", num_outputs="n", stateful_rng=True)
def _foreach(*arrays, subgraph=None, sub_in_names=(), num_data=1,
             num_out_data=0, num_states=0, is_train=False, generator=None,
             device=None):
    """Run ``subgraph`` over axis 0 of the data inputs.

    Inputs: num_data data arrays, num_states carry states, then the free
    (closure) arrays. The subgraph's outputs: num_out_data per-step
    outputs followed by num_states new states. Returns the stacked
    per-step outputs and the final states."""
    data = arrays[:num_data]
    states = tuple(arrays[num_data:num_data + num_states])
    free = arrays[num_data + num_states:]
    names = list(sub_in_names)
    data_names = names[:num_data]
    state_names = names[num_data:num_data + num_states]
    free_names = names[num_data + num_states:]
    gfn = _graph_fn(subgraph, is_train)
    device = _device(arrays, device)
    per_step = []
    for t in range(data[0].shape[0]):
        args = dict(zip(data_names, (d[t] for d in data)))
        args.update(zip(state_names, states))
        args.update(zip(free_names, free))
        outs, _ = gfn(args, {}, generator, device)
        per_step.append(outs[:num_out_data])
        states = tuple(outs[num_out_data:])
    stacked = tuple(torch.stack([step[j] for step in per_step])
                    for j in range(num_out_data))
    return stacked + states


@register(name="_while_loop", num_outputs="n", stateful_rng=True)
def _while_loop(*arrays, cond_graph=None, func_graph=None, sub_in_names=(),
                num_out_data=0, num_vars=0, max_iterations=None,
                is_train=False, generator=None, device=None):
    """Run ``func_graph`` while ``cond_graph`` holds, at most
    ``max_iterations`` times. Inputs: num_vars loop variables, then the
    free arrays. Returns the stacked step outputs (max_iterations rows,
    zeros past the trip count) and the final loop variables."""
    assert max_iterations is not None and max_iterations > 0, \
        "while_loop requires a positive max_iterations"
    loop_vars = tuple(arrays[:num_vars])
    free = arrays[num_vars:]
    names = list(sub_in_names)
    var_names = names[:num_vars]
    free_names = names[num_vars:]
    cfn = _graph_fn(cond_graph, is_train)
    ffn = _graph_fn(func_graph, is_train)
    device = _device(arrays, device)
    meta = device is not None and torch.device(device).type == "meta"
    steps = []
    while len(steps) < max_iterations:
        args = dict(zip(var_names, loop_vars))
        args.update(zip(free_names, free))
        (pred,), _ = cfn(args, {}, generator, device)
        if not meta and not bool(pred.reshape(())):
            break
        outs, _ = ffn(args, {}, generator, device)
        steps.append(outs[:num_out_data])
        loop_vars = tuple(outs[num_out_data:])
        if meta:
            steps *= int(max_iterations)
            break
    if not steps:
        # the condition never held: the rows' shapes come from one step
        # on meta tensors
        args = {n: torch.empty_like(a, device="meta")
                for n, a in zip(var_names + free_names,
                                tuple(loop_vars) + tuple(free))}
        outs, _ = ffn(args, {}, None, torch.device("meta"))
        rows = [torch.zeros((int(max_iterations),) + tuple(o.shape),
                            dtype=o.dtype, device=device)
                for o in outs[:num_out_data]]
        return tuple(rows) + loop_vars
    pad = int(max_iterations) - len(steps)
    stacked = []
    for j in range(num_out_data):
        rows = [step[j] for step in steps]
        if pad:
            rows.append(torch.zeros((pad,) + tuple(rows[0].shape),
                                    dtype=rows[0].dtype,
                                    device=rows[0].device))
            stacked.append(torch.cat([torch.stack(rows[:-1]), rows[-1]]))
        else:
            stacked.append(torch.stack(rows))
    return tuple(stacked) + loop_vars


@register(name="_cond", num_outputs="n", stateful_rng=True)
def _cond(*arrays, then_graph=None, else_graph=None, sub_in_names=(),
          num_outputs_branch=0, is_train=False, generator=None, device=None):
    """Run the branch the scalar predicate (input 0) selects; the other
    inputs are the union of both branches' free inputs."""
    pred = arrays[0]
    args = dict(zip(sub_in_names, arrays[1:]))
    device = _device(arrays, device)
    taken = pred.device.type == "meta" or bool(pred.reshape(()))
    gfn = _graph_fn(then_graph if taken else else_graph, is_train)
    outs, _ = gfn(args, {}, generator, device)
    return tuple(outs)
