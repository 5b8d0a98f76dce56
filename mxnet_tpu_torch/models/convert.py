"""Parameters and optimizer state between the JAX package and the port.

The JAX package keeps the transformer's parameters as a tree of arrays
({"embed", "pos" (absent for rope models), "ln_f", "layers": [{"ln1",
"ln2", "wq", "wk", "wv", "wo", "w1", "w2", and "gate" for MoE layers},
...]}) and its momentum as a tree of the same shape in fp32; the port
keeps the parameters in a :class:`~.transformer.TransformerLM` with the
same names and shapes, and the momentum as a dict by parameter name
(``init_momentum``). The config crosses by field name
(``config_from_jax``), the mesh axes, ``num_microbatches`` and
``use_ring_attention`` with the rest; the JAX tree is global, so a mesh
takes ``transformer.shard_params`` of ``params_from_jax``'s model. A
weight-only int8 tree crosses too: a q8 leaf {"q8", "scale", "dt"} is a
``transformer.Q8Weight`` in the port. Serving state crosses as well:
per-layer KV caches and block pools, [{"k", "v"}, ...] or, under int8
KV, [{"k", "ks", "v", "vs"}, ...] in both packages. So do the parameters of a traced Gluon
graph (``graph_params_from_numpy``): the JAX package's
``functionalize_block`` dicts by graph name. Everything crosses as numpy
arrays, so this module imports nothing of JAX.
"""

import dataclasses

import numpy as np
import torch

from ..context import resolve_device
from .transformer import (Q8Weight, TransformerConfig, TransformerLM,
                          flatten_tree, load_numpy_tree, named_leaves,
                          numpy_to_tensor, unflatten_tree)

__all__ = ["config_from_jax", "params_from_jax", "params_to_numpy",
           "momentum_from_jax", "momentum_to_numpy", "cache_from_jax",
           "cache_to_numpy", "graph_params_from_numpy"]

# dtypes a cache leaf may have, by numpy name
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}
_CACHE_KEYS = ({"k", "v"}, {"k", "ks", "v", "vs"})
_DTYPE_NAMES = {t: n for n, t in _CACHE_DTYPES.items()}


def _numpy(t):
    """A tensor as a numpy array (bfloat16 comes back as float32, which
    holds it exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def config_from_jax(cfg):
    """The port's :class:`TransformerConfig` holding the JAX package's
    config ``cfg``: every field, by name, the dtype by its numpy name."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TransformerConfig)
          if hasattr(cfg, f.name)}
    kw["dtype"] = _CACHE_DTYPES[np.dtype(cfg.dtype).name]
    return TransformerConfig(**kw)


def params_from_jax(tree, cfg, device=None):
    """A :class:`TransformerLM` on ``device`` holding the JAX package's
    parameter tree ``tree`` (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``; q8 leaves of an int8 tree become ``Q8Weight``s). ``device``
    defaults to the current CUDA device."""
    return load_numpy_tree(TransformerLM(cfg, device), tree)


def params_to_numpy(model):
    """The inverse: ``model``'s parameters as a JAX-shaped tree of numpy
    arrays; an int8 weight as {"q8": int8, "scale": float32, "dt": the
    weight dtype's numpy name}."""
    def leaf(p):
        if isinstance(p, Q8Weight):
            return {"q8": _numpy(p.q8), "scale": _numpy(p.scale),
                    "dt": _DTYPE_NAMES[p.dt]}
        return _numpy(p)
    return unflatten_tree({n: leaf(p) for n, p in named_leaves(model).items()})


def momentum_from_jax(tree, params):
    """The JAX package's momentum tree (numpy arrays, fp32) as the port's
    momentum for ``params``: fp32 tensors on ``params``' device, by
    parameter name, checked against the parameters' names and shapes."""
    flat = flatten_tree(tree)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    if set(flat) != set(shapes):
        raise ValueError("momentum keys do not match the parameters': %s"
                         % sorted(set(flat) ^ set(shapes)))
    out = {}
    for name, shape in shapes.items():
        if tuple(np.shape(flat[name])) != shape:
            raise ValueError("momentum %s has shape %s, the parameter %s"
                             % (name, np.shape(flat[name]), shape))
        out[name] = numpy_to_tensor(flat[name], torch.float32, params.device)
    return out


def momentum_to_numpy(momentum):
    """The inverse: the port's momentum as a JAX-shaped tree of fp32
    numpy arrays."""
    return unflatten_tree({n: _numpy(m) for n, m in momentum.items()})


def cache_from_jax(cache, device=None):
    """The JAX package's per-layer KV caches or block pools (numpy arrays,
    e.g. ``jax.tree.map(np.asarray, cache)``) as the port's: tensors of
    the same names, shapes and dtypes (float32, bfloat16, or int8 codes
    with float32 scales) on ``device``, the current CUDA device by
    default."""
    device = resolve_device(device)
    out = []
    for layer in cache:
        if set(layer) not in _CACHE_KEYS:
            raise ValueError("a cache layer holds k, v (and ks, vs under "
                             "int8 KV), not %s" % sorted(layer))
        leaves = {}
        for name, arr in layer.items():
            dtype = _CACHE_DTYPES.get(np.asarray(arr).dtype.name)
            if dtype is None:
                raise TypeError("cache leaf %s has dtype %s"
                                % (name, np.asarray(arr).dtype))
            leaves[name] = numpy_to_tensor(arr, dtype, device)
        out.append(leaves)
    return out


def cache_to_numpy(cache):
    """The inverse: the port's caches or pools as lists of dicts of numpy
    arrays (bfloat16 leaves come back as float32, which holds them
    exactly)."""
    return [{name: _numpy(leaf) for name, leaf in layer.items()}
            for layer in cache]


def graph_params_from_numpy(args, aux, device=None):
    """The JAX package's ``functionalize_block`` parameter dicts ``args``
    and ``aux`` (numpy arrays by graph name, e.g. ``{k: np.asarray(v)}``)
    as the port's: tensors of the same names, shapes and dtypes (bfloat16
    and float32 as given, numpy's float64 as float32) on ``device``, the
    current CUDA device by default. The port's graph function takes them
    as they are."""
    device = resolve_device(device)

    def tensors(d):
        out = {}
        for name, arr in d.items():
            arr = np.asarray(arr)
            dtype = _CACHE_DTYPES.get(arr.dtype.name)
            out[name] = numpy_to_tensor(arr, dtype or torch.float32, device)
        return out
    return tensors(args), tensors(aux)
