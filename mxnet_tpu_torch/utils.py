"""Framework-level utilities (port of ``mxnet_tpu/utils.py``)."""

__all__ = ["functionalize_block"]


def functionalize_block(net, example, is_train=False):
    """Trace an initialized HybridBlock into a graph function.

    Returns (graph_fn, data_names, args, aux) where
    graph_fn(arg_dict, aux_dict, generator) -> (outputs, new_aux),
    data_names are the traced input variable names, and args/aux are the
    network's parameter tensors (detached: a call records no graph unless
    the caller asks for one) split per the symbol's list_arguments /
    list_auxiliary_states. ``entry`` uses it, as the JAX package's
    ``__graft_entry__`` and ``bench.py`` use its own."""
    from .executor import build_graph_fn

    net(example)  # materialize deferred-shape params
    data_syms, out_sym = net._get_graph(example)
    graph_fn = build_graph_fn(out_sym, is_train=is_train)
    arg_names = set(out_sym.list_arguments())
    aux_names = set(out_sym.list_auxiliary_states())
    all_params = {p.var().name: p.data()._data.detach()
                  for p in net.collect_params().values()}
    args = {k: v for k, v in all_params.items() if k in arg_names}
    aux = {k: v for k, v in all_params.items() if k in aux_names}
    return graph_fn, [s.name for s in data_syms], args, aux
