"""The transformer language model in PyTorch (port of
``mxnet_tpu/models/transformer.py``): config, seeded parameters, the
training path (``forward``, ``loss_fn``, ``make_train_step``,
``init_momentum``), the model under a mesh (``param_specs``,
``shard_params``, ``shard_cache``; data, tensor, sequence, expert and
pipeline parallel training, sharded ``generate`` and ``beam_search``),
weight-only int8 trees (``quantize_weights_int8``), and the serving path
(prompt prefill, dense-cache and paged decode steps, the ragged verify
windows of speculative decoding, ``generate()`` greedy or sampled,
``speculative_generate`` and ``beam_search``).

Function names, argument order and numerics follow the JAX module, so a
reader finds each counterpart and one seed gives the same weights in
both packages. The op order that decides rounding is kept: scores
accumulate in fp32 and are divided by sqrt(D) after the dot, the
normalised probabilities are cast to the cache dtype before PV, and
``_rms_norm`` casts before it scales. Caches, pools, parameters and
momentum are updated in place (the JAX functions return new arrays, and
its train step donates them); each function still returns what it
wrote, so call sites read the same. Parameters never require a gradient
outside a train step, so the serving paths build no autograd graph.

Hand-written kernels carry the path on the GPU: the flash forward and
backward kernels in ``_causal_attention`` whenever
``cfg.use_flash_kernel`` (training, prefill, and ``generate()``'s
prompt), the dense-cache flash-decode kernel in ``decode_step`` with the
same flag (so also ``beam_search``'s steps and
``speculative_generate``'s draft steps), and the paged kernel in
``decode_step_paged`` and ``verify_chunk_paged`` (always, on CUDA
tensors; its int8 mode for an int8 KV pool; the verify window at span
k + 1, sliced where the kernel's 16 query rows a KV head do not hold
it). ``verify_chunk`` and ``speculative_generate``'s verify are plain
torch contractions, as the JAX functions are.

Under a mesh (``parallel.make_mesh``, one rank per process) the model
functions take the GLOBAL tokens on every rank, as the JAX functions take
a global array, and each rank holds its block of the parameters
(``shard_params``: Megatron tp over heads and the FFN hidden, experts
over ep, pipeline stages over pp). A rank runs its block of the batch
(over ``cfg.dp_axis``) and of the sequence (over ``cfg.sp_axis``), RoPE
and the position table at global positions. Attention over sp is ring
attention (``parallel.ring``, each fold through the ring-carry kernel
with ``cfg.use_flash_kernel``) or, with ``use_ring_attention=False``,
the whole sequence gathered and attended by ``_causal_attention``. The
layer all-reduces over tp after ``wo`` and ``w2`` and over ep x tp after
the experts' combine; where a replicated activation meets sharded
weights, ``parallel.pvary`` all-reduces its gradient. ``forward``
all-gathers the logits, so every rank returns the global [B, T, vocab];
``loss_fn`` all-reduces its token losses over dp x sp, so every rank
returns the global mean; ``make_train_step(cfg, mesh)`` reduces the
gradients over dp x sp with ``parallel.bucketed_all_reduce``. Under pp,
``forward`` runs the layers as ``parallel.pipeline.spmd_pipeline``'s
GPipe ticks over the stages.

A weight-only int8 tree (``quantize_weights_int8``) holds each weight of
rank 2 or more as a :class:`Q8Weight` (int8 codes, fp32 scales over axis
0, the weight's dtype) and keeps no full-precision copy: every serving
path dequantises each weight where it is used, in JAX's order, so at
most one weight exists in full precision at a time.

Every serving path carries RoPE (keys are cached rotated) and int8 KV
caches (int8 codes plus fp32 scale planes ``ks``/``vs`` per position and
KV head, quantised on the way in). Under int8 every cache read goes
through the one int8 contraction ``_int8_cache_attention``, and
``prefill`` delegates to ``prefill_chunk``, so solo ``generate()`` and
the batcher's admission read the prompt through the same quantiser.

``speculative_generate`` runs the JAX function's one device program as
a host loop over device tensors: each round's draft steps, verify
window, acceptance and buffer write are queued without a host read, and
the one read of a round is the loop's condition, the emitted count
compared with the budget (``int(n) < total`` in ``_spec_core``).
"""

import dataclasses
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..context import resolve_device
from ..kernels.common import NEG_INF
from ..kernels.common import int8_cache_attention as _int8_cache_attention
from ..kernels.common import kv_dequant as _kv_dequant  # noqa: F401
from ..kernels.common import kv_quant as _kv_quant
from ..kernels.flash_attention import flash_attention, flash_decode
from ..kernels.paged_decode import paged_attention
from ..parallel import (P, all_gather, all_reduce, bucketed_all_reduce,
                        pvary, shard)
from ..parallel.pipeline import spmd_pipeline, stack_stage_params
from ..parallel.ring import ring_attention

__all__ = ["TransformerConfig", "TransformerLM", "Q8Weight", "init_params",
           "forward", "loss_fn", "make_train_step", "init_momentum",
           "param_specs", "shard_params", "shard_cache", "init_cache",
           "prefill", "prefill_chunk", "decode_step", "make_decode_step",
           "init_paged_cache", "paged_cache_nbytes", "grow_paged_cache",
           "decode_step_paged", "verify_chunk", "verify_chunk_paged",
           "generate", "speculative_generate", "beam_search",
           "quantize_weights_int8", "save_checkpoint", "load_checkpoint",
           "restore_train_state", "resume_from_latest", "CheckpointCorrupt",
           "wait_for_pending_save", "install_emergency_checkpoint",
           "uninstall_emergency_checkpoint"]


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    # grouped-query attention: KV heads (None = n_heads, i.e. MHA)
    n_kv_heads: int = None
    n_layers: int = 2
    d_ff: int = 128
    n_experts: int = 0          # 0 = dense FFN; >0 = top-all MoE every layer
    max_len: int = 128
    dtype: torch.dtype = torch.float32
    # mesh axis names (None disables an axis): batch, heads / FFN hidden,
    # sequence and experts
    dp_axis: str = "dp"
    tp_axis: str = "tp"
    sp_axis: str = "sp"
    ep_axis: str = "ep"
    pp_axis: str = None         # set to 'pp' to pipeline the layer stack
    num_microbatches: int = 0   # 0 = one per pipeline stage
    # rotary positions on q/k instead of the learned `pos` table (which a
    # rope model does not carry), in training and every serving path;
    # caches hold the keys rotated
    rope: bool = False
    rope_base: float = 10000.0
    # under a mesh, attention over the sp axis as ring attention (else the
    # sequence is gathered over sp and attended whole)
    use_ring_attention: bool = True
    # attention through the hand-written flash kernels: the training
    # forward/backward and prefill, each ring step under a mesh (the carry
    # kernel, forward only), and decode_step's flash-decode kernel (not
    # under kv_cache_int8, whose dense decode is the int8 contraction)
    use_flash_kernel: bool = False
    # activation recompute: backward re-runs each layer from its input
    # (torch.utils.checkpoint, non-reentrant; its collectives run again,
    # in the same order on every rank) instead of storing it
    remat_layers: bool = False
    # int8 KV caches and pools: int8 codes plus fp32 scales per position
    # and KV head; the paged kernel reads them in its int8 mode
    kv_cache_int8: bool = False


def _axes(mesh, *names):
    """The axes among ``names`` that the config sets and the mesh has (an
    axis the mesh lacks has size 1)."""
    if mesh is None:
        return ()
    return tuple(n for n in names if n and n in mesh.shape)


def _size(mesh, name):
    return mesh.axis_size(name) if _axes(mesh, name) else 1


def _index(mesh, name):
    return mesh.axis_index(name) if _axes(mesh, name) else 0


def _check_mesh(cfg, mesh, fields=("dp_axis", "sp_axis")):
    """Raise for a mesh without the dp or sp axis the config names (as
    the JAX package's sharding specs refuse a missing axis; serving reads
    dp alone). The tp, ep and pp axes may be absent: each then has size
    1."""
    if mesh is None:
        return
    for field in fields:
        name = getattr(cfg, field)
        if name and name not in mesh.shape:
            raise ValueError("cfg.%s=%r is not an axis of the mesh %s (set "
                             "it to None to leave that dimension unsharded)"
                             % (field, name, mesh.shape))


def _shard_spans(cfg, mesh, shape):
    """((b0, b1), (t0, t1)): this rank's block of [B, T] tokens, over
    cfg.dp_axis and cfg.sp_axis (the whole of a dimension with no axis, or
    with no mesh)."""
    spans = []
    for name, size in zip((cfg.dp_axis, cfg.sp_axis), shape):
        n, i = _size(mesh, name), _index(mesh, name)
        if size % n:
            raise ValueError("dimension of size %d does not split over the "
                             "%d ranks of axis %r" % (size, n, name))
        spans.append((i * size // n, (i + 1) * size // n))
    return spans


def _kvh(cfg):
    kvh = cfg.n_kv_heads or cfg.n_heads
    if cfg.n_heads % kvh:
        raise ValueError(
            "n_heads=%d must be a multiple of n_kv_heads=%d"
            % (cfg.n_heads, kvh))
    return kvh


def param_specs(cfg):
    """The partition spec of each parameter, in the JAX tree's shape:
    Megatron tp (q/k/v over heads, wo over its head dim, w1 by columns and
    w2 by rows), MoE experts over ep with their d_ff over tp; everything
    else whole on every rank."""
    tp, ep = cfg.tp_axis, cfg.ep_axis
    layer = {"ln1": P(None), "ln2": P(None),
             "wq": P(None, tp, None), "wk": P(None, tp, None),
             "wv": P(None, tp, None), "wo": P(tp, None, None)}
    if cfg.n_experts:
        layer.update({"gate": P(None, None),
                      "w1": P(ep, None, tp), "w2": P(ep, tp, None)})
    else:
        layer.update({"w1": P(None, tp), "w2": P(tp, None)})
    out = {"embed": P(None, None), "ln_f": P(None),
           "layers": [dict(layer) for _ in range(cfg.n_layers)]}
    if not cfg.rope:
        out["pos"] = P(None, None)
    return out


class TransformerLayer(nn.Module):
    """One decoder layer's parameters, named and shaped as the JAX tree's
    ``layers[i]`` entry."""

    def __init__(self, cfg, device):
        super().__init__()
        d, h, kvh = cfg.d_model, cfg.n_heads, _kvh(cfg)
        hd = d // h

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                            device=device),
                                requires_grad=False)

        self.ln1, self.ln2 = p(d), p(d)
        self.wq, self.wk, self.wv = p(d, h, hd), p(d, kvh, hd), p(d, kvh, hd)
        self.wo = p(h, hd, d)
        if cfg.n_experts:
            e = cfg.n_experts
            self.gate = p(d, e)
            self.w1, self.w2 = p(e, d, cfg.d_ff), p(e, cfg.d_ff, d)
        else:
            self.w1, self.w2 = p(d, cfg.d_ff), p(cfg.d_ff, d)


class TransformerLM(nn.Module):
    """The decoder LM's parameters: ``embed [V, D]``, ``pos [max_len, D]``
    (absent when ``cfg.rope``), ``ln_f [D]`` and ``layers``, named and
    shaped as the JAX package's parameter tree. The model functions of
    this module take it where the JAX functions take ``params``. No
    parameter requires a gradient outside :func:`make_train_step`'s
    step. Under a mesh (:func:`shard_params`) each parameter is this
    rank's block, and under pp ``layers`` holds this rank's stage; in an
    int8 tree (:func:`quantize_weights_int8`) each weight of rank 2 or
    more is a :class:`Q8Weight`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                            device=device),
                                requires_grad=False)

        self.embed = p(cfg.vocab_size, d)
        if not cfg.rope:
            self.pos = p(cfg.max_len, d)
        self.ln_f = p(d)
        self.layers = nn.ModuleList(TransformerLayer(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self):
        return self.embed.device


class Q8Weight(nn.Module):
    """A weight-only int8 leaf, the JAX package's ``{"q8", "scale",
    "dt"}``: int8 codes ``q8``, fp32 ``scale`` (the absolute maximum over
    axis 0, over 127, kept with that axis of size 1) and the weight's
    dtype ``dt``. :meth:`dequantize` is ``(q8.float() * scale).to(dt)``,
    JAX's order, so both packages give the same bits."""

    def __init__(self, q8, scale, dt):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scale", scale)
        self.dt = dt

    shape = property(lambda self: self.q8.shape)
    device = property(lambda self: self.q8.device)

    def dequantize(self, index=None):
        """The weight in its dtype, or only its rows at ``index`` (an
        index of axis 0: the same bits as indexing the whole)."""
        q8 = self.q8 if index is None else self.q8[index]
        return (q8.float() * self.scale).to(self.dt)


def _w(w):
    """A weight as a tensor of its dtype: a :class:`Q8Weight` is
    dequantised here, where it is used, and freed after the use."""
    return w.dequantize() if isinstance(w, Q8Weight) else w


def _rows(table, index):
    """``table[index]`` of an embedding or position table, gathering the
    int8 rows before dequantising them when the table is a Q8Weight."""
    return table.dequantize(index) if isinstance(table, Q8Weight) \
        else table[index]


def _quantize(x):
    """JAX's quantiser: fp32 ``scale = max(amax over axis 0, 1e-30) /
    127``, codes ``round(x / scale)`` (half to even) clipped to +-127."""
    x = x.float()
    amax = x.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q8 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q8, scale


def named_leaves(params):
    """{name: parameter or Q8Weight} of a TransformerLM, by the names
    ``named_parameters()`` gives ("embed", "layers.0.wq", ...)."""
    out = {}
    for prefix, mod in params.named_modules():
        if isinstance(mod, Q8Weight):
            out[prefix] = mod
            continue
        for n, p in mod.named_parameters(recurse=False):
            out[prefix + "." + n if prefix else n] = p
    return out


def flat_tensors(params):
    """{name: tensor} of every array the JAX package's checkpoint flattens
    ``params`` to: a Q8Weight ``name`` as ``name#q8``, ``name#scale`` and
    ``name#dt`` (a zero-size tensor of the weight's dtype)."""
    out = {}
    for name, leaf in named_leaves(params).items():
        if isinstance(leaf, Q8Weight):
            out[name + "#q8"] = leaf.q8
            out[name + "#scale"] = leaf.scale
            out[name + "#dt"] = torch.empty(0, dtype=leaf.dt,
                                            device=leaf.device)
        else:
            out[name] = leaf
    return out


def _set_leaf(model, name, leaf):
    """Put ``leaf`` (a tensor, made a parameter, or a Q8Weight) at
    ``name`` in ``model``."""
    *path, attr = name.split(".")
    mod = model
    for part in path:
        mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
    delattr(mod, attr)
    if not isinstance(leaf, Q8Weight):
        leaf = nn.Parameter(leaf, requires_grad=False)
    setattr(mod, attr, leaf)


def _rebuild(params, fn, cfg=None, layers=None):
    """A new TransformerLM whose leaf ``name`` is ``fn(name, leaf)``, over
    the layers of ``params`` at indices ``layers`` (all by default),
    renumbered from 0. No parameter is allocated beyond what ``fn``
    returns."""
    cfg = cfg or params.cfg
    leaves = named_leaves(params)
    layers = list(range(len(params.layers))) if layers is None else layers
    out = TransformerLM(dataclasses.replace(cfg, n_layers=len(layers)),
                        "meta")
    out.cfg = cfg
    for name, leaf in leaves.items():
        parts = name.split(".")
        if parts[0] == "layers":
            if int(parts[1]) not in layers:
                continue
            parts[1] = str(layers.index(int(parts[1])))
        _set_leaf(out, ".".join(parts), fn(name, leaf))
    return out


def _is_q8(params):
    return any(isinstance(m, Q8Weight) for m in params.modules())


def quantize_weights_int8(params):
    """Weight-only int8 for serving: a new TransformerLM in which every
    weight of rank 2 or more is a :class:`Q8Weight`, scales shared only
    along the leading (input) axis; norms stay as they are (copied).
    Decode reads each weight from memory once a step, so int8 storage
    halves the bytes of a bf16 tree. The serving paths dequantise one
    weight at a time where it is used; no full-precision copy is kept.
    Idempotent."""
    def q(name, leaf):
        if isinstance(leaf, Q8Weight):
            return Q8Weight(leaf.q8.clone(), leaf.scale.clone(), leaf.dt)
        if leaf.dim() < 2:
            return leaf.detach().clone()
        return Q8Weight(*_quantize(leaf.detach()), leaf.dtype)
    return _rebuild(params, q)


def _dequantize_weights(params):
    """The inverse of quantize_weights_int8: a new TransformerLM holding
    every weight dequantised, in its dtype (a full-precision tree)."""
    return _rebuild(params, lambda name, leaf: _w(leaf).detach().clone())


_NP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}


def numpy_to_tensor(arr, dtype, device):
    """A numpy array (float64/32, or the bfloat16 numpy type JAX arrays
    convert to) as a tensor of ``dtype`` on ``device``."""
    arr = np.array(arr)                 # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def flatten_tree(tree):
    """{parameter name: leaf} of a JAX-shaped tree ({"embed", "pos",
    "ln_f", "layers": [{...}, ...]}), named as ``named_parameters()``
    names them ("embed", "layers.0.wq", ...)."""
    flat = {n: leaf for n, leaf in tree.items() if n != "layers"}
    for i, sub in enumerate(tree["layers"]):
        flat.update(("layers.%d.%s" % (i, n), leaf) for n, leaf in sub.items())
    return flat


def unflatten_tree(flat):
    """The inverse of :func:`flatten_tree`."""
    tree = {"layers": []}
    for name, leaf in flat.items():
        parts = name.split(".")
        if parts[0] != "layers":
            tree[name] = leaf
            continue
        i = int(parts[1])
        tree["layers"] += [{} for _ in range(i + 1 - len(tree["layers"]))]
        tree["layers"][i][parts[2]] = leaf
    return tree


def _q8_dtype(dt):
    """The weight dtype a q8 leaf's ``dt`` names: a (zero-size) array of
    that dtype, or its numpy name."""
    name = dt if isinstance(dt, str) else np.asarray(dt).dtype.name
    return _NP_DTYPES[name]


def load_numpy_tree(model, tree):
    """Copy a JAX-shaped parameter tree of numpy arrays into ``model``,
    checking names and shapes. A q8 leaf ({"q8", "scale", "dt"}, as the
    JAX package's ``quantize_weights_int8`` makes it; ``dt`` a zero-size
    array of the weight's dtype or its name) becomes a :class:`Q8Weight`
    in place of that parameter."""
    if len(tree["layers"]) != len(model.layers):
        raise ValueError("tree has %d layers, model %d"
                         % (len(tree["layers"]), len(model.layers)))
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError("tree keys do not match the model's: %s"
                         % sorted(set(flat) ^ set(params)))
    with torch.no_grad():
        for name, arr in flat.items():
            param = params[name]
            shape = np.shape(arr["q8"] if isinstance(arr, dict) else arr)
            if tuple(shape) != tuple(param.shape):
                raise ValueError("shape %s does not match parameter %s %s"
                                 % (shape, name, tuple(param.shape)))
            if isinstance(arr, dict):
                _set_leaf(model, name, Q8Weight(
                    numpy_to_tensor(arr["q8"], torch.int8, param.device),
                    numpy_to_tensor(arr["scale"], torch.float32,
                                    param.device),
                    _q8_dtype(arr["dt"])))
                continue
            param.copy_(numpy_to_tensor(arr, param.dtype, param.device))
    return model


def init_params(cfg, seed=0, device=None):
    """Seeded random parameters as a :class:`TransformerLM` — the same
    numpy ``RandomState`` draws, in the same order, as the JAX package's
    ``init_params``, so one seed gives the same weights in both."""
    rng = np.random.RandomState(seed)
    d, h, kvh = cfg.d_model, cfg.n_heads, _kvh(cfg)
    hd = d // h

    def dense(*shape):
        scale = 1.0 / np.sqrt(shape[0] if len(shape) == 2 else d)
        return rng.randn(*shape) * scale

    def layer():
        p = {"ln1": np.ones(d), "ln2": np.ones(d),
             "wq": dense(d, h, hd), "wk": dense(d, kvh, hd),
             "wv": dense(d, kvh, hd), "wo": dense(h, hd, d)}
        if cfg.n_experts:
            e = cfg.n_experts
            p["gate"] = dense(d, e)
            p["w1"] = rng.randn(e, d, cfg.d_ff) / np.sqrt(d)
            p["w2"] = rng.randn(e, cfg.d_ff, d) / np.sqrt(cfg.d_ff)
        else:
            p["w1"] = dense(d, cfg.d_ff)
            p["w2"] = dense(cfg.d_ff, d)
        return p

    tree = {"embed": rng.randn(cfg.vocab_size, d) * 0.02,
            "ln_f": np.ones(d),
            "layers": [layer() for _ in range(cfg.n_layers)]}
    if not cfg.rope:
        tree["pos"] = rng.randn(cfg.max_len, d) * 0.02
    return load_numpy_tree(TransformerLM(cfg, device), tree)


def _pp_size(cfg, mesh):
    return _size(mesh, cfg.pp_axis)


def shard_params(params, cfg, mesh):
    """This rank's block of every parameter under ``param_specs(cfg)``,
    on the mesh's device: heads and FFN columns over tp, experts over ep;
    under pp, only the layers of this rank's stage (stage-major, as
    ``pipeline.stack_stage_params`` groups them). An int8 tree shards
    too: the codes take the weight's spec, and the fp32 scale is sliced
    along every dimension past the first that the spec splits (the
    scale's first dimension is 1), so each rank's scale matches its
    codes. Raises when tp does not divide the KV heads, as JAX does."""
    tp = _size(mesh, cfg.tp_axis)
    if _kvh(cfg) % tp:
        raise ValueError(
            "tp axis of size %d cannot shard %d KV heads "
            "(n_kv_heads must be a multiple of the tp width; "
            "lower tp, raise n_kv_heads, or replicate KV by "
            "setting tp_axis=None)" % (tp, _kvh(cfg)))
    specs = flatten_tree(param_specs(cfg))

    def local(spec):
        return P(*(e if e in _axes(mesh, e) else None for e in spec))

    def place(name, leaf):
        parts = name.split(".")
        key = ".".join(parts[:1] + ["0"] + parts[2:]) \
            if parts[0] == "layers" else name
        spec = local(specs[key])
        if isinstance(leaf, Q8Weight):
            return Q8Weight(shard(leaf.q8, spec, mesh),
                            shard(leaf.scale, P(None, *spec[1:]), mesh),
                            leaf.dt)
        return shard(leaf.detach(), spec, mesh)

    stage = stack_stage_params(range(len(params.layers)),
                               _pp_size(cfg, mesh))[_index(mesh, cfg.pp_axis)]
    return _rebuild(params, place, cfg, stage)


def _check_blocks(params, cfg, mesh):
    """Raise unless ``params`` are this mesh's blocks (:func:`shard_params`):
    its stage's layers under pp, its heads under tp. Whole parameters
    under such a mesh would run every layer in every stage, or count
    every head tp times."""
    stages, tp = _pp_size(cfg, mesh), _size(mesh, cfg.tp_axis)
    if len(params.layers) * stages != cfg.n_layers \
            or params.layers[0].wq.shape[1] * tp != cfg.n_heads:
        raise ValueError("the parameters are not this rank's blocks for the "
                         "mesh %s: pass shard_params(params, cfg, mesh)"
                         % (mesh.shape,))


def _rms_norm(x, g):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * g


def _qkv(x, p):
    q = torch.einsum("btd,dhk->bthk", x, _w(p.wq))
    k = torch.einsum("btd,dhk->bthk", x, _w(p.wk))    # KVH heads under GQA
    v = torch.einsum("btd,dhk->bthk", x, _w(p.wv))
    return q, k, v


def _repeat_kv(x, g):
    """[.., T, KVH, D] -> [.., T, H, D], each KV head repeated over its
    query group."""
    return x if g == 1 else torch.repeat_interleave(x, g, dim=2)


def _rope(x, positions, base):
    """Rotary position encoding on [..., T, H, Dh] (or [..., H, Dh] with
    scalar / [B] positions): rotate feature pairs (half-split convention)
    by position-dependent angles, in fp32, cast back to x's dtype."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(
            "rope needs an even head dim, got d_model/n_heads = %d" % dh)
    half = dh // 2
    freqs = torch.pow(1.0 / base, torch.arange(half, dtype=torch.float32,
                                               device=x.device) / half)
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions.float()[..., None] * freqs
    if positions.dim() >= 1:
        # positions carry a T (or batch) axis that aligns with x's -3
        # axis; insert the broadcast head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def _ffn(x, p, cfg, mesh=None):
    """The FFN of one layer over x [B, T, D], the same on every rank of tp
    and ep. Under a mesh each rank holds its FFN columns (tp) and its
    experts (ep), and the partial outputs are all-reduced over them; the
    gates are computed whole and each rank takes its experts' share."""
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.n_experts:
        # dense top-all dispatch: every token weighted over every expert
        gates = torch.softmax(torch.einsum("btd,de->bte", x, _w(p.gate)),
                              dim=-1)
        axes = _axes(mesh, cfg.ep_axis, cfg.tp_axis)
        x, gates = pvary(x, axes, mesh), pvary(gates, axes, mesh)
        e = p.w1.shape[0]
        e0 = _index(mesh, cfg.ep_axis) * e
        h = F.gelu(torch.einsum("btd,edf->betf", x, _w(p.w1)),
                   approximate="tanh")
        y = torch.einsum("betf,efd->betd", h, _w(p.w2))
        return all_reduce(torch.einsum("betd,bte->btd", y,
                                       gates[..., e0:e0 + e]), axes, mesh=mesh)
    axes = _axes(mesh, cfg.tp_axis)
    h = F.gelu(torch.einsum("btd,df->btf", pvary(x, axes, mesh), _w(p.w1)),
               approximate="tanh")
    return all_reduce(torch.einsum("btf,fd->btd", h, _w(p.w2)), axes,
                      mesh=mesh)


def _out(o, eq, p, cfg, mesh=None):
    """The attention output projection ``einsum(eq, o, wo)``, all-reduced
    over tp when each rank holds its heads."""
    return all_reduce(torch.einsum(eq, o, _w(p.wo)), _axes(mesh, cfg.tp_axis),
                      mesh=mesh)


def _causal_attention(q, k, v, cfg, out_dtype):
    """Causal attention over [B, T, H, D]: the flash kernels (forward,
    and the flash backward under autograd) whenever
    ``cfg.use_flash_kernel``, at every T; else the dense masked
    softmax."""
    if cfg.use_flash_kernel:
        return flash_attention(q, k, v, causal=True).to(out_dtype)
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, v.float()).to(out_dtype)


def _pos_rows(table, pos):
    """Rows of the position table at [B] positions; a position outside
    the table gives a NaN row, as ``jnp.take`` fills it."""
    n = table.shape[0]
    valid = (pos >= 0) & (pos < n)
    rows = _rows(table, pos.long().clamp(0, n - 1))
    return torch.where(valid[:, None], rows, float("nan"))


# ----------------------------------------------------------- training ---

def _attention(x, p, cfg, mesh=None, start=0):
    """Attention of a layer over x [B, T, D], whose first row sits at
    global position ``start`` (a rank's sequence offset under a mesh).
    Under a mesh each rank attends with its tp heads; over an sp axis the
    attention is ring attention, or with ``use_ring_attention=False`` the
    whole sequence gathered over sp, attended by _causal_attention (the
    flash kernels with ``use_flash_kernel``), of which the rank keeps its
    rows."""
    x = pvary(x, _axes(mesh, cfg.tp_axis), mesh)
    q, k, v = _qkv(x, p)
    if cfg.rope:
        positions = start + torch.arange(x.shape[1], device=x.device)
        q = _rope(q, positions, cfg.rope_base)
        k = _rope(k, positions, cfg.rope_base)
    # training attends with the repeated view, as the JAX package does
    g = cfg.n_heads // _kvh(cfg)
    k, v = _repeat_kv(k, g), _repeat_kv(v, g)
    sp = _axes(mesh, cfg.sp_axis)
    if sp and cfg.use_ring_attention:
        o = ring_attention(q, k, v, axis_name=cfg.sp_axis, causal=True,
                           use_flash_kernel=cfg.use_flash_kernel, mesh=mesh)
    elif sp and mesh.axis_size(sp) > 1:
        t = q.shape[1]
        o = _causal_attention(*(all_gather(z, sp[0], axis=1, mesh=mesh)
                                for z in (q, k, v)), cfg, x.dtype)
        o = o[:, start:start + t]
    else:
        o = _causal_attention(q, k, v, cfg, x.dtype)
    return _out(o, "bthk,hkd->btd", p, cfg, mesh)


def _layer(p, x, cfg, mesh=None, start=0):
    x = x + _attention(_rms_norm(x, p.ln1), p, cfg, mesh, start)
    return x + _ffn(_rms_norm(x, p.ln2), p, cfg, mesh)


def _tokens(tokens, device):
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def _forward_local(params, tokens, cfg, mesh):
    """Logits of this rank's block of the global tokens [B, T] (all of
    them without a mesh): [B_local, T_local, vocab]. Under pp the layers
    run as the pipeline's ticks over this rank's stage."""
    _check_mesh(cfg, mesh)
    if mesh is not None:
        _check_blocks(params, cfg, mesh)
    (b0, b1), (t0, t1) = _shard_spans(cfg, mesh, tokens.shape)
    x = _rows(params.embed, tokens[b0:b1, t0:t1])
    if not cfg.rope:
        x = x + _rows(params.pos, slice(t0, t1))

    def layer_fn(p, x):
        if cfg.remat_layers:
            return checkpoint(_layer, p, x, cfg, mesh, t0,
                              use_reentrant=False)
        return _layer(p, x, cfg, mesh, t0)

    if _pp_size(cfg, mesh) > 1:
        x = spmd_pipeline(layer_fn, list(params.layers), x, mesh,
                          axis_name=cfg.pp_axis,
                          num_microbatches=cfg.num_microbatches or None)
    else:
        for p in params.layers:
            x = layer_fn(p, x)
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("btd,vd->btv", x, _w(params.embed))


def forward(params, tokens, cfg, mesh=None):
    """tokens [B, T] int -> logits [B, T, vocab]. With
    ``cfg.remat_layers`` each layer is checkpointed: backward re-runs it
    from its input instead of keeping its activations. Under ``mesh``
    every rank passes the global tokens and gets the global logits."""
    tokens = _tokens(tokens, params.device)
    logits = _forward_local(params, tokens, cfg, mesh)
    for name, dim in ((cfg.sp_axis, 1), (cfg.dp_axis, 0)):
        if _axes(mesh, name):
            logits = all_gather(logits, name, axis=dim, mesh=mesh)
    return logits


def loss_fn(params, tokens, cfg, mesh=None):
    """Next-token cross entropy (mean over B, T-1), as a 0-dim fp32
    tensor: the sum of the losses of this rank's tokens (all of them
    without a mesh), all-reduced over dp x sp under ``mesh``, over the
    global count, so every rank returns the global mean. The all-reduce
    passes its gradient through: each rank's gradients are those of its
    own tokens, which the train step sums over dp x sp."""
    tokens = _tokens(tokens, params.device)
    logits = _forward_local(params, tokens, cfg, mesh)
    (b0, b1), (t0, t1) = _shard_spans(cfg, mesh, tokens.shape)
    # the next token of each local position; the global last has none
    targets = tokens[b0:b1, t0 + 1:t1 + 1]
    logp = torch.log_softmax(logits[:, :targets.shape[1]].float(), dim=-1)
    total = -logp.gather(-1, targets[..., None])[..., 0].sum()
    total = all_reduce(total, _axes(mesh, cfg.dp_axis, cfg.sp_axis),
                       mesh=mesh)
    b, t = tokens.shape
    return total / (b * (t - 1))


def init_momentum(params):
    """Zero fp32 momentum for every parameter, by parameter name."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.named_parameters()}


def make_train_step(cfg, mesh=None, lr=1e-2, guard=False):
    """The training step: ``step(params, momentum, tokens)`` ->
    ``(params, momentum, loss)``, SGD with momentum 0.9 as the JAX
    package's ``make_train_step``: m = 0.9 m + g in fp32, then
    p = p - lr * m cast to p's dtype. ``params`` and ``momentum`` (as
    :func:`init_momentum` makes it) are updated in place, where the JAX
    step donates them, and returned.

    The learning rate is taken in the parameters' dtype, as JAX rounds
    its weakly typed Python ``lr`` to bf16 before the bf16 product.

    Under ``mesh`` every rank calls the step with the global tokens and
    its block of the parameters (:func:`shard_params`); the gradients of
    each rank's tokens are summed over dp x sp by
    ``parallel.bucketed_all_reduce`` (last layers first, in 25 MB
    buckets; nothing to sum where dp and sp have size 1), so every rank
    updates its block with the gradient of the global loss.

    With ``guard=True`` the step returns a fourth output ``skipped`` (a
    0-dim bool tensor on the device) and, when the loss or any gradient
    is not finite, leaves params and momentum untouched; the select runs
    on the device, with no host sync. Under a mesh the flag is
    all-reduced over every axis, so all ranks skip together."""
    def step(params, momentum, tokens):
        if _is_q8(params):
            raise ValueError("an int8 weight tree is a serving artifact: "
                             "quantisation discards the weights SGD needs")
        names, ps = zip(*params.named_parameters())
        for p in ps:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, tokens, cfg, mesh)
            grads = torch.autograd.grad(loss, ps)
        finally:
            for p in ps:
                p.requires_grad_(False)
        with torch.no_grad():
            loss = loss.detach()
            axes = _axes(mesh, cfg.dp_axis, cfg.sp_axis)
            if axes:
                grads = bucketed_all_reduce(grads[::-1], axes,
                                            mesh=mesh)[::-1]
            if guard:
                ok = torch.isfinite(loss)
                for g in grads:
                    ok = ok & torch.isfinite(g).all()
                if mesh is not None:
                    ok = all_reduce((~ok).float(), mesh.axis_names, op="max",
                                    mesh=mesh) == 0
            lrs = {}
            for name, p, g in zip(names, ps, grads):
                m = momentum[name]
                if p.dtype not in lrs:
                    lrs[p.dtype] = torch.tensor(lr, dtype=p.dtype)
                new_m = 0.9 * m + g
                new_p = p - lrs[p.dtype] * new_m.to(p.dtype)
                if guard:
                    new_m = torch.where(ok, new_m, m)
                    new_p = torch.where(ok, new_p, p)
                m.copy_(new_m)
                p.copy_(new_p)
        if guard:
            return params, momentum, loss, ~ok
        return params, momentum, loss

    return step


# ------------------------------------------------------------- decode ---

def _cache_leaves(cfg, shape, device):
    """One layer's zeroed cache leaves of ``shape`` [..., KVH, D]: k and v
    of cfg.dtype, or under kv_cache_int8 int8 codes k, v and fp32 scale
    planes ks, vs [..., KVH]."""
    if cfg.kv_cache_int8:
        codes = dict(dtype=torch.int8, device=device)
        scales = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, **codes),
                "ks": torch.zeros(shape[:-1], **scales),
                "v": torch.zeros(shape, **codes),
                "vs": torch.zeros(shape[:-1], **scales)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_cache(cfg, batch, device=None):
    """Zeroed per-layer K/V caches [batch, max_len, KVH, D] of cfg.dtype;
    under kv_cache_int8, int8 codes plus fp32 scales [batch, max_len,
    KVH] ("ks", "vs")."""
    device = resolve_device(device)
    shape = (batch, cfg.max_len, _kvh(cfg), cfg.d_model // cfg.n_heads)
    return [_cache_leaves(cfg, shape, device) for _ in range(cfg.n_layers)]


def _cache_rows(k, v, cfg):
    """The leaves a cache write stores for fresh k/v [..., KVH, D]: the
    rows themselves, or under kv_cache_int8 their codes and scales."""
    if cfg.kv_cache_int8:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        return {"k": kq, "ks": ks, "v": vq, "vs": vs}
    return {"k": k, "v": v}


def _cache_write_rows(layer_cache, k, v, start, cfg):
    """Write k/v [B, C, KVH, D] into cache positions [start, start+C), in
    place, quantised on the way in under kv_cache_int8. A start past the
    end clamps so the rows fit, as ``dynamic_update_slice`` does."""
    c = k.shape[1]
    start = min(max(int(start), 0), layer_cache["k"].shape[1] - c)
    for name, new in _cache_rows(k, v, cfg).items():
        layer_cache[name][:, start:start + c] = new
    return layer_cache


def _where_rows(valid, new, old):
    """``new`` where the [B] mask ``valid`` holds, else ``old``, row by
    row, in ``old``'s dtype."""
    valid = valid.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(valid, new.to(old.dtype), old)


def _cache_write_ragged(layer_cache, k_new, v_new, pos, cfg):
    """Row i writes its k/v [B, KVH, D] at pos[i], in place, quantised on
    the way in under kv_cache_int8. A position past the cache is dropped,
    as JAX's scatter drops it."""
    t = layer_cache["k"].shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    valid = (pos >= 0) & (pos < t)
    at = pos.long().clamp(0, t - 1)
    for name, new in _cache_rows(k_new, v_new, cfg).items():
        leaf = layer_cache[name]
        leaf[rows, at] = _where_rows(valid, new, leaf[rows, at])
    return layer_cache


def _decode_attention(q, layer_cache, pos, cfg):
    """q [B, H, D] vs cache [B, Tmax, KVH, D], attending positions <= pos
    (an int, or [B] for ragged decode)."""
    if cfg.kv_cache_int8:
        return _decode_attention_int8(q, layer_cache, pos, cfg)
    cache_k, cache_v = layer_cache["k"], layer_cache["v"]
    if cfg.use_flash_kernel:
        return flash_decode(q, cache_k, cache_v, pos + 1)
    b, h, d = q.shape
    kvh = cache_k.shape[2]
    g = h // kvh
    # grouped contraction: the KVH-head cache is read once per group
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), cache_k.float()) \
        / math.sqrt(d)
    t_pos = torch.arange(cache_k.shape[1], device=q.device)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)
    mask = t_pos[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", a.to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(b, h, d).to(q.dtype)


def _decode_attention_int8(q, layer_cache, pos, cfg):
    """Decode as the C=1 case of ``_int8_cache_attention``."""
    b, h, d = q.shape
    kvh = layer_cache["k"].shape[2]
    t_pos = torch.arange(layer_cache["k"].shape[1], device=q.device)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)
    mask = (t_pos[None, :] <= pos[:, None])[:, None, :]        # [B|1, 1, T]
    o = _int8_cache_attention(q.reshape(b, 1, kvh, h // kvh, d), layer_cache,
                              mask, q.dtype)
    return o.reshape(b, h, d)


def prefill(params, cache, tokens, cfg, mesh=None):
    """Process the whole prompt tokens [B, Tp] in one forward pass,
    filling cache positions [0, Tp). Returns (last_logits [B, vocab],
    cache). Under kv_cache_int8 it is ``prefill_chunk`` at start 0: the
    prompt's own attention then reads its rows through the quantiser, as
    decode and the batcher's admission do."""
    b, t_p = tokens.shape
    if cfg.kv_cache_int8:
        return prefill_chunk(params, cache, tokens, 0, cfg,
                             logits_row=t_p - 1, attend_limit=t_p,
                             mesh=mesh)
    tokens = tokens.long()
    x = _rows(params.embed, tokens)
    if not cfg.rope:
        x = x + _rows(params.pos, slice(None, t_p))
    positions = torch.arange(t_p, device=x.device)
    g = cfg.n_heads // _kvh(cfg)
    for p, layer_cache in zip(params.layers, cache):
        h = _rms_norm(x, p.ln1)
        q, k, v = _qkv(h, p)
        if cfg.rope:
            # keys are cached rotated: decode never rotates the cache again
            q = _rope(q, positions, cfg.rope_base)
            k = _rope(k, positions, cfg.rope_base)
        _cache_write_rows(layer_cache, k, v, 0, cfg)
        o = _causal_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), cfg,
                              x.dtype)
        x = x + _out(o, "bthk,hkd->btd", p, cfg, mesh)
        x = x + _ffn(_rms_norm(x, p.ln2), p, cfg, mesh)
    x = _rms_norm(x[:, -1], params.ln_f)
    return torch.einsum("bd,vd->bv", x, _w(params.embed)), cache


def _chunk_attention(qg, att, mask, cfg, out_dtype):
    """The chunk contraction of prefill_chunk and the verify windows: qg
    [B, C, KVH, G, D] against cache leaves [B, T, KVH, D], attending where
    mask [B|1, C, T] holds: the masked grouped softmax with the
    probabilities cast to the cache dtype and PV in fp32, or under
    kv_cache_int8 ``_int8_cache_attention``. Returns [B, C, KVH, G, D] in
    ``out_dtype``."""
    if cfg.kv_cache_int8:
        return _int8_cache_attention(qg, att, mask, out_dtype)
    ck, cv = att["k"], att["v"]
    s = torch.einsum("bckgd,btkd->bckgt", qg.float(), ck.float()) \
        / math.sqrt(qg.shape[-1])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bckgt,btkd->bckgd", a.to(cv.dtype).float(),
                        cv.float()).to(out_dtype)


def prefill_chunk(params, cache, tokens, start, cfg, logits_row=None,
                  attend_limit=None, mesh=None):
    """Process a chunk tokens [B, C] beginning at position ``start``,
    writing its K/V into the cache. Returns the logits after every chunk
    position ([B, C, vocab]) — or, with ``logits_row``, only that row's
    [B, vocab] — and the cache. Row i attends cache positions
    <= start+i; ``attend_limit`` restricts the contraction to the first
    ``attend_limit`` positions (exact when start+C <= attend_limit)."""
    b, c = tokens.shape
    start = int(start)
    if start < 0 or start + c > cfg.max_len:
        raise ValueError("chunk [%d, %d) overruns max_len %d"
                         % (start, start + c, cfg.max_len))
    x = _rows(params.embed, tokens.long())
    chunk_pos = start + torch.arange(c, device=x.device)
    if not cfg.rope:
        x = x + _rows(params.pos, slice(start, start + c))
    for p, layer_cache in zip(params.layers, cache):
        h = _rms_norm(x, p.ln1)
        q, k, v = _qkv(h, p)
        if cfg.rope:
            q = _rope(q, chunk_pos, cfg.rope_base)
            k = _rope(k, chunk_pos, cfg.rope_base)
        _cache_write_rows(layer_cache, k, v, start, cfg)
        # this rank's heads under a mesh: H / tp and KVH / tp
        n_h, kvh, dh = q.shape[2], k.shape[2], q.shape[-1]
        qg = q.reshape(b, c, kvh, n_h // kvh, dh)
        att = layer_cache if attend_limit is None else \
            {name: leaf[:, :attend_limit] for name, leaf in layer_cache.items()}
        t_pos = torch.arange(att["k"].shape[1], device=x.device)
        mask = (t_pos[None, :] <= chunk_pos[:, None])[None]      # [1, C, T]
        o = _chunk_attention(qg, att, mask, cfg, x.dtype)
        o = o.reshape(b, c, n_h, dh)
        x = x + _out(o, "bchk,hkd->bcd", p, cfg, mesh)
        x = x + _ffn(_rms_norm(x, p.ln2), p, cfg, mesh)
    x = _rms_norm(x, params.ln_f)
    if logits_row is not None:
        return torch.einsum("bd,vd->bv", x[:, int(logits_row)],
                            _w(params.embed)), cache
    return torch.einsum("bcd,vd->bcv", x, _w(params.embed)), cache


def _step_qkv(x, p, pos, cfg):
    """The decode step's q, k, v [B, H|KVH, D] of one layer, q and k
    rotated at ``pos`` (an int or [B]) under cfg.rope."""
    h = _rms_norm(x, p.ln1)
    q = torch.einsum("bd,dhk->bhk", h, _w(p.wq))
    k = torch.einsum("bd,dhk->bhk", h, _w(p.wk))
    v = torch.einsum("bd,dhk->bhk", h, _w(p.wv))
    if cfg.rope:
        q = _rope(q, pos, cfg.rope_base)
        k = _rope(k, pos, cfg.rope_base)
    return q.contiguous(), k, v


def decode_step(params, cache, tokens, pos, cfg, mesh=None):
    """One autoregressive step: tokens [B] at position ``pos`` (an int,
    or an int [B] tensor for ragged decode, each row at its own
    position). Returns (logits [B, vocab] for the next token, cache)."""
    device = params.device
    x = _rows(params.embed, tokens.long())
    ragged = torch.is_tensor(pos) and pos.dim() == 1
    if ragged:
        pos = pos.to(device)
        if not cfg.rope:
            x = x + _pos_rows(params.pos, pos)
    else:
        pos = int(pos)
        if not cfg.rope:
            # dynamic_index_in_dim clamps the position into the table
            x = x + _rows(params.pos, min(max(pos, 0), cfg.max_len - 1))
    for p, layer_cache in zip(params.layers, cache):
        q, k_new, v_new = _step_qkv(x, p, pos, cfg)
        if ragged:
            _cache_write_ragged(layer_cache, k_new, v_new, pos, cfg)
        else:
            _cache_write_rows(layer_cache, k_new[:, None], v_new[:, None],
                              pos, cfg)
        o = _decode_attention(q, layer_cache, pos, cfg)
        x = x + _out(o, "bhk,hkd->bd", p, cfg, mesh)
        x = x + _ffn(_rms_norm(x, p.ln2)[:, None], p, cfg, mesh)[:, 0]
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bd,vd->bv", x, _w(params.embed)), cache


# ------------------------------------------------------- paged decode ---
# The KV cache split into fixed-size blocks: one per-layer pool
# [num_blocks, block_size, KVH, D] shared by every lane (under
# kv_cache_int8 int8 codes plus fp32 scale planes [num_blocks,
# block_size, KVH], so a block carries its own scales), and per-lane
# int32 block tables [B, max_len // block_size] mapping positions
# [j*bs, (j+1)*bs) to a pool block. Block 0 is the null block:
# unallocated entries point at it, and writes past a lane's allocation
# land there, never attended by a live request.

def init_paged_cache(cfg, num_blocks, block_size, device=None):
    """Zeroed per-layer block pools [num_blocks, block_size, KVH, D]
    (codes and scale planes under kv_cache_int8)."""
    if num_blocks < 2:
        raise ValueError("need >= 2 blocks (block 0 is the null block)")
    device = resolve_device(device)
    shape = (num_blocks, block_size, _kvh(cfg), cfg.d_model // cfg.n_heads)
    return [_cache_leaves(cfg, shape, device) for _ in range(cfg.n_layers)]


def paged_cache_nbytes(cfg, num_blocks, block_size):
    """Byte size of the pools :func:`init_paged_cache` would build."""
    hd = cfg.d_model // cfg.n_heads
    cells = num_blocks * block_size * _kvh(cfg)
    if cfg.kv_cache_int8:
        per_layer = 2 * cells * hd * 1 + 2 * cells * 4   # k/v + ks/vs
    else:
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        per_layer = 2 * cells * hd * itemsize
    return int(per_layer * cfg.n_layers)


def _paged_write_ragged(layer_pool, k_new, v_new, tables, pos, cfg):
    """Row i writes its k/v [B, KVH, D] into block tables[i, pos[i]//bs]
    at offset pos[i] % bs, in place, quantised on the way in under
    kv_cache_int8. A position past the table is dropped: JAX's
    ``take_along_axis`` fills such a table index with INT_MIN and its
    scatter drops the write. An unallocated entry is the null block."""
    bs = layer_pool["k"].shape[1]
    nb = tables.shape[1]
    idx = torch.div(pos, bs, rounding_mode="floor").long()
    valid = (idx >= 0) & (idx < nb)
    blk = tables.gather(1, idx.clamp(0, nb - 1)[:, None])[:, 0].long()
    off = torch.remainder(pos, bs).long()
    for name, new in _cache_rows(k_new, v_new, cfg).items():
        leaf = layer_pool[name]
        leaf[blk, off] = _where_rows(valid, new, leaf[blk, off])
    return layer_pool


def decode_step_paged(params, pool, tables, tokens, pos, cfg):
    """One ragged autoregressive step through the block tables.

    tokens [B] int, pos [B] int32, tables [B, max_len//bs] int32. Returns
    (logits [B, vocab], pool); the tables are read-only here. Attention
    reads the pool through the tables with the paged kernel (its int8
    mode for an int8 pool) on CUDA tensors, and with its plain version on
    the CPU."""
    pos = pos.to(device=params.device, dtype=torch.int32)
    x = _rows(params.embed, tokens.long())
    if not cfg.rope:
        x = x + _pos_rows(params.pos, pos)
    for p, layer_pool in zip(params.layers, pool):
        q, k_new, v_new = _step_qkv(x, p, pos, cfg)
        _paged_write_ragged(layer_pool, k_new, v_new, tables, pos, cfg)
        o = paged_attention(q[:, None], layer_pool, tables, pos)[:, 0]
        x = x + _out(o, "bhk,hkd->bd", p, cfg)
        x = x + _ffn(_rms_norm(x, p.ln2)[:, None], p, cfg)[:, 0]
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bd,vd->bv", x, _w(params.embed)), pool


def grow_paged_cache(pool, extra_blocks):
    """The pool with ``extra_blocks`` zero blocks appended to every leaf's
    block axis. Existing blocks keep their ids and values, so block tables
    stay valid and the allocator extends its free list with the new ids
    (new tensors: the pools passed in are left as they are)."""
    if extra_blocks <= 0:
        return pool
    return [{name: torch.cat([leaf, leaf.new_zeros((extra_blocks,)
                                                   + tuple(leaf.shape[1:]))])
             for name, leaf in layer.items()} for layer in pool]


# ----------------------------------------------------- batched verify ---
# The ragged-chunk forward of batched speculative decoding: C tokens per
# lane, lane b's window anchored at its own position pos[b]. Row (b, i)
# carries the stream token at position pos[b] + i, writes its K/V there,
# attends positions <= pos[b] + i, and its logits predict position
# pos[b] + i + 1. Stale K/V of rejected drafts heals by position: the next
# round's window starts at the first rejected position and rewrites every
# stale position before any row attends it.

def _window(params, tokens, pos, cfg):
    """(embedded window [B, C, D], positions [B, C] int64) of a verify
    window at per-lane positions ``pos`` [B]. Rows past the position
    table take its last row: JAX's ``take`` fills them with NaN, which the
    paged path would write into the null block, while the port keeps a
    coasting row's garbage finite (its writes drop, or land in the null
    block, and its tokens are never credited)."""
    device = params.device
    c = tokens.shape[1]
    positions = pos.to(device=device, dtype=torch.long)[:, None] \
        + torch.arange(c, device=device)[None]
    x = _rows(params.embed, tokens.to(device).long())
    if not cfg.rope:
        x = x + _rows(params.pos, positions.clamp(0, cfg.max_len - 1))
    return x, positions


def _window_layer(x, p, cfg, positions, attend):
    """One layer over a verify window: q/k/v (rotated under cfg.rope),
    ``attend(q, k, v)`` -> [B, C, H, D] writing the window's K/V and
    attending, then the output projection and the FFN."""
    h = _rms_norm(x, p.ln1)
    q, k, v = _qkv(h, p)
    if cfg.rope:
        q = _rope(q, positions, cfg.rope_base)
        k = _rope(k, positions, cfg.rope_base)
    o = attend(q, k, v)
    x = x + _out(o, "bchk,hkd->bcd", p, cfg)
    return x + _ffn(_rms_norm(x, p.ln2), p, cfg)


def _cache_write_ragged_chunk(layer_cache, k_new, v_new, positions, cfg):
    """Row b writes its C fresh k/v [B, C, KVH, D] at its own positions[b]
    (the C > 1 case of ``_cache_write_ragged``), in place, quantised on
    the way in under kv_cache_int8. Positions past the cache are dropped,
    as JAX's scatter with mode="drop" drops them, so a window running
    past max_len never touches an earlier row. Written as one scatter
    with every index inside the cache: a dropped row aims at the last
    position with the value that position gets anyway (the window's own
    row there, or what the cache holds), so duplicate indices always
    carry equal values."""
    t = layer_cache["k"].shape[1]
    b, c = positions.shape
    rows = torch.arange(b, device=positions.device)[:, None]
    at = positions.clamp(0, t - 1)
    src = (at - positions[:, :1]).clamp(0, c - 1)
    own = at >= positions[:, :1]          # `at` lies in the row's window
    for name, new in _cache_rows(k_new, v_new, cfg).items():
        leaf = layer_cache[name]
        tail = (1,) * (new.dim() - 2)
        picked = new.gather(1, src.reshape((b, c) + tail).expand_as(new))
        leaf[rows, at] = torch.where(own.reshape((b, c) + tail),
                                     picked.to(leaf.dtype), leaf[rows, at])
    return layer_cache


def verify_chunk(params, cache, tokens, pos, cfg):
    """A ragged chunk against the dense cache: tokens [B, C], lane b's
    window starting at its own position pos[b] ([B] int tensor). Returns
    (logits [B, C, vocab], cache). The batched generalisation of
    prefill_chunk (whose start is one scalar) and the target pass of
    batched speculative decoding: the [B, k+1] window [tok, d_1..d_k]
    gives every lane's verification targets in one pass. Plain torch
    ops, as the JAX function is a plain einsum (int8 through
    ``_int8_cache_attention``); windows past max_len drop their
    writes."""
    b, c = tokens.shape
    x, positions = _window(params, tokens, pos, cfg)
    kvh = _kvh(cfg)
    g = cfg.n_heads // kvh
    t_pos = torch.arange(cfg.max_len, device=x.device)
    mask = t_pos[None, None, :] <= positions[:, :, None]        # [B, C, T]
    for p, layer_cache in zip(params.layers, cache):
        def attend(q, k, v, layer_cache=layer_cache):
            _cache_write_ragged_chunk(layer_cache, k, v, positions, cfg)
            qg = q.reshape(b, c, kvh, g, q.shape[-1])
            o = _chunk_attention(qg, layer_cache, mask, cfg, x.dtype)
            return o.reshape(b, c, cfg.n_heads, q.shape[-1])
        x = _window_layer(x, p, cfg, positions, attend)
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bcd,vd->bcv", x, _w(params.embed)), cache


def _paged_write_ragged_chunk(layer_pool, k_new, v_new, tables, positions,
                              cfg):
    """Window scatter through the block tables: row b writes its C fresh
    k/v at positions[b], each routed to block tables[b, position // bs]
    at offset position % bs, in place, quantised on the way in under
    kv_cache_int8. Positions past the table go to the null block, not
    clamped: a near-budget lane's window can overrun while its last block
    is still attended. Unallocated entries are the null block too."""
    bs = layer_pool["k"].shape[1]
    nb = tables.shape[1]
    idx = torch.div(positions, bs, rounding_mode="floor")
    blk = tables.gather(1, idx.clamp(0, nb - 1)).long()
    blk = torch.where((idx >= 0) & (idx < nb), blk, 0)
    off = torch.remainder(positions, bs)
    for name, new in _cache_rows(k_new, v_new, cfg).items():
        leaf = layer_pool[name]
        leaf[blk, off] = new.to(leaf.dtype)
    return layer_pool


def verify_chunk_paged(params, pool, tables, tokens, pos, cfg):
    """verify_chunk through the block tables: the same ragged windows,
    their K/V scattered into the pool, attention read through the tables
    by the paged kernel at span C (its int8 mode for an int8 pool) on
    CUDA tensors, and by its plain version on the CPU, which is the JAX
    function's gather path. Tables are read-only here; allocation,
    including the speculative over-reserve and its release on reject, is
    the batcher's. Returns (logits [B, C, vocab], pool)."""
    pos = pos.to(device=params.device, dtype=torch.int32)
    x, positions = _window(params, tokens, pos, cfg)
    for p, layer_pool in zip(params.layers, pool):
        def attend(q, k, v, layer_pool=layer_pool):
            _paged_write_ragged_chunk(layer_pool, k, v, tables, positions,
                                      cfg)
            return paged_attention(q.contiguous(), layer_pool, tables, pos)
        x = _window_layer(x, p, cfg, positions, attend)
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bcd,vd->bcv", x, _w(params.embed)), pool


# ----------------------------------------------------------- sampling ---
# The port's random source is its own: torch's and JAX's generators never
# agree, so sampling draws Gumbel noise from a counter-based hash of
# (request seed, token counter, row, vocab index), written in int64 torch
# ops that give the same bits on the CPU and the card. A chain mirrors
# generate()'s key chain: counter 0 draws the token chosen from the
# prefill logits, counter t the t-th decode token; a batcher lane is row
# 0 of a batch-1 chain, so a request's sampled stream equals its solo
# generate(seed=...) at any lane, chunk size and pipeline depth.

_M32 = 0xFFFFFFFF
_VOCAB_WORDS = {}        # (device, vocab) -> hashed vocab indices [V]


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant
    c < 2^32, in 16-bit halves so no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    xl, xh = x & 0xFFFF, x >> 16
    return (xl * lo + (((xh * lo + xl * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit mixer (xor-shift-multiply) on int64 values in
    [0, 2^32); the shifts are logical since every value is >= 0."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _vocab_words(vocab, device):
    key = (str(device), int(vocab))
    if key not in _VOCAB_WORDS:
        j = torch.arange(vocab, dtype=torch.int64, device=device)
        _VOCAB_WORDS[key] = _mix32((j + 0x9E3779B9) & _M32)
    return _VOCAB_WORDS[key]


def _gumbel_bits(seeds, counters, rows, vocab, device):
    """[N, V] int64 words in [0, 2^32): a pure function of (seeds[n]
    taken as a 64-bit word, counters[n], rows[n], vocab index)."""
    s = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    c = torch.as_tensor(counters, dtype=torch.int64, device=device)
    r = torch.as_tensor(rows, dtype=torch.int64, device=device)
    key = _mix32((s & _M32) ^ 0x2545F491)
    key = _mix32(key ^ ((s >> 32) & _M32))
    key = _mix32(key ^ (c & _M32))
    key = _mix32(key ^ (r & _M32))
    return _mix32(key[:, None] ^ _vocab_words(vocab, device)[None, :])


def _gumbel(seeds, counters, rows, vocab, device):
    """Gumbel noise [N, V] fp32 for the draws (seeds[n], counters[n],
    rows[n]): u = (23 hashed bits + 0.5) / 2^23, exact in fp32, then
    -log(-log(u))."""
    bits = _gumbel_bits(seeds, counters, rows, vocab, device)
    u = ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def _sample_logits(logits, noise, temperature, top_k, top_p):
    """One sampling step over [B, V] logits, step for step the JAX
    package's ``_sample_logits``: fp32 logits over the temperature,
    top-k masking everything below the kth value (ties at it are kept),
    top-p keeping every token whose preceding cumulative mass is under
    ``top_p`` (thresholded at the smallest kept logit), then
    ``argmax(filtered + noise)``, which is ``jax.random.categorical``
    with Gumbel ``noise``. Returns int32 [B]."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                          cum[..., :-1] < top_p], dim=-1)
        thresh = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, float("-inf"), logits)
    # torch.argmax takes the first maximum, as jnp.argmax does
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def _resolve_greedy(greedy, temperature, top_k, top_p):
    """generate()'s rule: greedy unless a sampling control is given;
    greedy=False alone is pure ancestral sampling; greedy=True with a
    control is a contradiction."""
    sampling_requested = (temperature != 1.0 or top_k is not None
                          or top_p is not None)
    if greedy is None:
        return not sampling_requested
    if greedy and sampling_requested:
        raise ValueError(
            "greedy=True ignores temperature/top_k/top_p — pass "
            "greedy=False (or omit greedy) to sample")
    return bool(greedy)


def _choose_tokens(logits, controls, seeds, counters, rows):
    """The next token of each [B, V] logits row under ``controls``
    (greedy, temperature, top_k, top_p): the argmax, or a sample drawn
    with the noise of (seeds, counters, rows) ([B] each)."""
    greedy, temperature, top_k, top_p = controls
    if greedy:
        # torch.argmax takes the first maximum, as jnp.argmax does
        return torch.argmax(logits, dim=-1).to(torch.int32)
    noise = _gumbel(seeds, counters, rows, logits.shape[-1], logits.device)
    return _sample_logits(logits, noise, temperature, top_k, top_p)


def _seed_word(seed):
    """A Python int seed as the int64 of its low 64 bits."""
    return (int(seed) + 2 ** 63) % 2 ** 64 - 2 ** 63


# ----------------------------------------------------------- generate ---

def _check_params_device(params, device):
    if params.device != device:
        raise ValueError("parameters lie on %s, not on %s: build them with "
                         "init_params(..., device=%s)"
                         % (params.device, device, device))


def _generate_core(params, prompt, cache, n_new, cfg, controls, seed,
                   mesh=None, row0=0):
    """Prefill, then decode steps as a Python loop; token t (0 from the
    prefill logits) is chosen with counter t of row b's chain, rows
    numbered from ``row0`` (this rank's first under dp)."""
    b, t_prompt = prompt.shape
    total = t_prompt + n_new
    device = prompt.device
    buf = torch.zeros((b, total), dtype=torch.int32, device=device)
    buf[:, :t_prompt] = prompt
    seeds = torch.full((b,), _seed_word(seed), dtype=torch.int64,
                       device=device)
    rows = row0 + torch.arange(b, dtype=torch.int64, device=device)

    def choose(logits, t):
        counters = torch.full((b,), t, dtype=torch.int64, device=device)
        return _choose_tokens(logits, controls, seeds, counters, rows)

    last_logits, cache = prefill(params, cache, prompt, cfg, mesh)
    buf[:, t_prompt] = choose(last_logits, 0)
    for pos in range(t_prompt, total - 1):
        logits, cache = decode_step(params, cache, buf[:, pos], pos, cfg,
                                    mesh)
        buf[:, pos + 1] = choose(logits, pos + 1 - t_prompt)
    return buf


def _cache_pspec(cfg, x):
    """The serving cache's layout: batch over dp, KV heads over tp, the
    sequence whole, truncated to the leaf's rank (int8 scale planes are
    [B, T, KVH])."""
    return P(*P(cfg.dp_axis, None, cfg.tp_axis, None)[:x.dim()])


def shard_cache(cache, cfg, mesh):
    """This rank's block of each KV cache leaf (codes and int8 scale
    planes alike): its dp rows and its tp heads, matching the wq/wk/wv
    head shards, the whole sequence. Attention then needs no traffic;
    only wo's output and the FFN all-reduce over tp."""
    def local(spec):
        return P(*(e if e in _axes(mesh, e) else None for e in spec))
    return [{name: shard(leaf, local(_cache_pspec(cfg, leaf)), mesh)
             for name, leaf in layer.items()} for layer in cache]


def _serve_setup(params, prompt, cfg, mesh, device):
    """(device, the global prompt as int32 on it, this rank's dp rows
    (b0, b1)) of a generate() or beam_search() call."""
    if mesh is not None:
        _check_mesh(cfg, mesh, ("dp_axis",))
        _check_blocks(params, cfg, mesh)
        if device is None:
            device = mesh.device
    device = resolve_device(device)
    _check_params_device(params, device)
    if not torch.is_tensor(prompt):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.int32)
    rows = _shard_spans(cfg, mesh, prompt.shape)[0]
    return device, prompt, rows


def _local_cache(cfg, b, device, mesh):
    cache = init_cache(cfg, b, device)
    return cache if mesh is None else shard_cache(cache, cfg, mesh)


@torch.no_grad()
def generate(params, prompt, n_new, cfg, greedy=None, seed=0,
             temperature=1.0, top_k=None, top_p=None, mesh=None,
             device=None):
    """Autoregressive generation: prompt [B, Tp] int -> int32 [B,
    Tp+n_new] on ``device`` (the current CUDA device by default; raises
    when there is none). The prompt is prefilled in one forward pass,
    then each token is one :func:`decode_step`.

    Decoding is greedy unless ``temperature`` (!= 1.0), ``top_k`` or
    ``top_p`` is given, or ``greedy=False`` (pure ancestral sampling);
    greedy=True with a sampling control raises. Samples come from the
    port's counter-based noise for ``seed`` (not ``jax.random``'s): row
    b's token t uses counter t of row b.

    With ``mesh`` (on the mesh's device) every rank passes the global
    prompt and its :func:`shard_params` block of the parameters; it
    decodes its dp rows with its tp heads of the cache
    (:func:`shard_cache`), all-reducing wo's output and the FFN over tp,
    and every rank returns the global tokens."""
    controls = (_resolve_greedy(greedy, temperature, top_k, top_p),
                float(temperature), top_k, top_p)
    device, prompt, (b0, b1) = _serve_setup(params, prompt, cfg, mesh,
                                            device)
    t_prompt = prompt.shape[1]
    total = t_prompt + n_new
    if total > cfg.max_len:
        raise ValueError("prompt+n_new %d exceeds max_len %d"
                         % (total, cfg.max_len))
    if n_new == 0:
        return prompt
    cache = _local_cache(cfg, prompt.shape[0], device, mesh)
    out = _generate_core(params, prompt[b0:b1], cache, n_new, cfg, controls,
                         seed, mesh, b0)
    if _axes(mesh, cfg.dp_axis):
        out = all_gather(out, cfg.dp_axis, mesh=mesh)
    return out


# -------------------------------------------------- speculative decode ---

def _spec_core(params, draft_params, prompt, cfg, dcfg, k, n_new):
    """Prefill both models, then rounds of k draft steps and one verify
    window of the big model, with the acceptance test and the masked
    window write into the token buffer on the device. The JAX function
    is one device program; here the rounds are a host loop over device
    tensors, and a round's positions stay tensors, so nothing of a round
    is read back except the one scalar that decides whether another
    round runs. Returns (buffer [max_len + k + 1], acceptances
    [max_len], rounds)."""
    device = prompt.device
    t_prompt = prompt.shape[1]
    total = t_prompt + n_new
    cache = init_cache(cfg, 1, device)
    dcache = init_cache(dcfg, 1, device)
    logits, cache = prefill(params, cache, prompt, cfg)
    _, dcache = prefill(draft_params, dcache, prompt, dcfg)
    # padded so the fixed-width (k + 1) window write near the budget edge
    # stays in bounds; emissions past `total` are masked
    buf = torch.zeros((cfg.max_len + k + 1,), dtype=torch.int32,
                      device=device)
    buf[:t_prompt] = prompt[0]
    buf[t_prompt] = torch.argmax(logits[0]).to(torch.int32)
    acc_log = torch.zeros((cfg.max_len,), dtype=torch.int32, device=device)
    n = torch.full((1,), t_prompt + 1, dtype=torch.int64, device=device)
    slots = torch.arange(k + 1, device=device)
    rounds = 0
    while int(n) < total:            # the one host read of a round
        tok = buf[n - 1]
        at = (n - 1).to(torch.int32)
        drafts = []
        for i in range(k):
            dlogits, dcache = decode_step(draft_params, dcache, tok, at + i,
                                          dcfg)
            tok = torch.argmax(dlogits, dim=-1).to(torch.int32)
            drafts.append(tok)
        drafts = torch.cat(drafts)
        # the k + 1 window rows are the contexts ending at buf[n - 1], d1,
        # ..., dk: row i predicts position n + i (row k is the bonus after
        # a full acceptance)
        window = torch.cat([buf[n - 1], drafts])[None]
        vlogits, cache = verify_chunk(params, cache, window, at, cfg)
        target = torch.argmax(vlogits[0], dim=-1).to(torch.int32)
        accepted = torch.cumprod((drafts == target[:k]).to(torch.int64),
                                 dim=0).sum()
        emit = torch.minimum(accepted + 1, total - n)
        idx = n + slots
        buf[idx] = torch.where(slots < emit, target, buf[idx])
        acc_log[rounds] = accepted
        n = n + emit
        rounds += 1
    return buf, acc_log, rounds


@torch.no_grad()
def speculative_generate(params, draft_params, prompt, n_new, cfg, draft_cfg,
                         k_draft=4, return_stats=False, device=None):
    """Greedy speculative decoding: the draft model proposes ``k_draft``
    tokens a round, the big model verifies them all in one window
    (:func:`verify_chunk`), and the longest agreeing prefix is accepted
    with the big model's own next token. Every emitted token is the big
    model's greedy argmax, so the stream is generate()'s up to
    reduction-order ties between the window and the stepped decode.
    Batch 1. k is clamped near max_len so every write stays inside both
    caches. Returns [1, Tp+n_new] int32 on ``device`` (the current CUDA
    device by default); with ``return_stats`` also {"acceptances": per
    round, "big_model_launches": 1 + rounds}. Draft steps go through
    :func:`decode_step` (the flash-decode kernel under the draft's
    ``use_flash_kernel``). Both configs must share vocab_size."""
    device = resolve_device(device)
    _check_params_device(params, device)
    _check_params_device(draft_params, device)
    if not torch.is_tensor(prompt):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.int32)
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding serves batch=1")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share the vocab")
    t_prompt = int(prompt.shape[1])
    total = t_prompt + n_new
    if total > min(cfg.max_len, draft_cfg.max_len):
        raise ValueError("prompt+n_new exceeds a model's max_len")
    if n_new < 1:
        raise ValueError("n_new must be >= 1")
    # the deepest in-round write is position n-1+k with n <= total-1
    k = max(1, min(int(k_draft), cfg.max_len - total + 1,
                   draft_cfg.max_len - total + 1))
    buf, acc_log, rounds = _spec_core(params, draft_params, prompt, cfg,
                                      draft_cfg, k, n_new)
    out = buf[None, :total]
    if return_stats:
        return out, {"acceptances": acc_log[:rounds].tolist(),
                     "big_model_launches": 1 + rounds}
    return out


# -------------------------------------------------------- beam search ---

def _beam_core(params, prompt, cache, n_new, k, length_penalty, cfg,
               mesh=None):
    """Prefill, the first expansion, then one decode_step a token with the
    surviving beams' parents re-gathered (see beam_search)."""
    b, t_prompt = prompt.shape
    total = t_prompt + n_new
    vocab = cfg.vocab_size
    device = prompt.device
    last_logits, cache = prefill(params, cache, prompt, cfg, mesh)
    logp0 = torch.log_softmax(last_logits.float(), dim=-1)
    # the top-k tokens of the last prompt position seed the beams; each
    # row of the cache is repeated per beam (rows grouped b0's k beams,
    # then b1's, ...)
    scores, tok0 = torch.topk(logp0, k, dim=-1)                  # [B, k]
    cache = [{n: leaf.repeat_interleave(k, dim=0) for n, leaf in layer.items()}
             for layer in cache]
    buf = torch.zeros((b * k, total), dtype=torch.int32, device=device)
    buf[:, :t_prompt] = prompt.repeat_interleave(k, dim=0)
    buf[:, t_prompt] = tok0.reshape(-1).to(torch.int32)
    first = torch.arange(b, device=device)[:, None] * k
    for pos in range(t_prompt, total - 1):
        logits, cache = decode_step(params, cache, buf[:, pos], pos, cfg,
                                    mesh)
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = scores.reshape(b, k, 1) + logp.reshape(b, k, vocab)
        scores, flat = torch.topk(cand.reshape(b, k * vocab), k, dim=-1)
        row = (first + torch.div(flat, vocab, rounding_mode="floor")) \
            .reshape(-1)
        cache = [{n: leaf.index_select(0, row) for n, leaf in layer.items()}
                 for layer in cache]
        buf = buf.index_select(0, row)
        buf[:, pos + 1] = torch.remainder(flat, vocab).reshape(-1) \
            .to(torch.int32)
    if length_penalty:
        scores = scores / (float(total) ** length_penalty)
    # beams come out sorted, best first (topk's order)
    return buf.reshape(b, k, total), scores


@torch.no_grad()
def beam_search(params, prompt, n_new, cfg, beam=4, length_penalty=0.0,
                mesh=None, device=None):
    """Beam-search decoding over the KV cache: prompt [B, Tp] ->
    (sequences [B, beam, Tp+n_new] int32, scores [B, beam] fp32), beams
    sorted best first by total log-probability, divided by
    (Tp+n_new)^length_penalty when it is set. The cache rides at batch
    width B*beam and each step re-gathers the surviving beams' parents'
    rows; each token is one :func:`decode_step` (the flash-decode kernel
    under ``cfg.use_flash_kernel``). beam=1 is greedy generate() exactly.
    Runs on ``device`` (the current CUDA device by default). With
    ``mesh`` each rank searches its dp rows with its tp heads of the
    expanded cache, as :func:`generate` decodes, and every rank returns
    the global sequences and scores."""
    device, prompt, (b0, b1) = _serve_setup(params, prompt, cfg, mesh,
                                            device)
    t_prompt = prompt.shape[1]
    total = t_prompt + n_new
    if total > cfg.max_len:
        raise ValueError("prompt+n_new %d exceeds max_len %d"
                         % (total, cfg.max_len))
    if n_new < 1:
        raise ValueError("beam search needs n_new >= 1")
    if not 1 <= beam <= cfg.vocab_size:
        raise ValueError("beam width %d must be in [1, vocab_size=%d]"
                         % (beam, cfg.vocab_size))
    cache = _local_cache(cfg, prompt.shape[0], device, mesh)
    seqs, scores = _beam_core(params, prompt[b0:b1], cache, n_new, int(beam),
                              float(length_penalty), cfg, mesh)
    if _axes(mesh, cfg.dp_axis):
        seqs = all_gather(seqs, cfg.dp_axis, mesh=mesh)
        scores = all_gather(scores, cfg.dp_axis, mesh=mesh)
    return seqs, scores


def make_decode_step(cfg):
    """``step(params, cache, tokens, pos)`` -> :func:`decode_step`'s
    (logits, cache), the cache updated in place (the JAX function jits the
    step and donates the cache)."""
    def step(params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos, cfg)
    return step


# checkpoints of this stack live in models/checkpoint.py; re-exported here
# so the flagship's whole train/serve/persist surface is reachable from
# one module, as in the JAX package
from .checkpoint import (save_checkpoint, load_checkpoint,  # noqa: E402
                         restore_train_state, resume_from_latest,
                         CheckpointCorrupt, wait_for_pending_save,
                         install_emergency_checkpoint,
                         uninstall_emergency_checkpoint)
