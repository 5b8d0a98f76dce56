"""The transformer language model's serving path in PyTorch (port of
``mxnet_tpu/models/transformer.py``): config, seeded parameters, prompt
prefill, dense-cache and paged decode steps, and greedy ``generate()``.

Function names, argument order and numerics follow the JAX module, so a
reader finds each counterpart and one seed gives the same weights in
both packages. The op order that decides rounding is kept: scores
accumulate in fp32 and are divided by sqrt(D) after the dot, the
normalised probabilities are cast to the cache dtype before PV, and
``_rms_norm`` casts before it scales. Caches and pools are updated in
place (the JAX functions return new arrays); each function still returns
the cache it wrote, so call sites read the same.

Two decode-attention kernels carry the path on the GPU: the paged kernel
in ``decode_step_paged`` (always, on CUDA tensors) and the dense-cache
flash-decode kernel in ``decode_step`` when ``cfg.use_flash_kernel``.

Not ported yet; each raises NotImplementedError where it would be asked
for: RoPE, int8 KV, MoE, pipeline stages, int8 weight trees, sampling,
speculative verification, and the flash prefill kernel.
"""

import dataclasses
import math
import os

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..context import resolve_device
from ..kernels.common import NEG_INF
from ..kernels.flash_attention import flash_decode
from ..kernels.paged_decode import paged_attention

__all__ = ["TransformerConfig", "TransformerLM", "init_params",
           "init_cache", "prefill", "prefill_chunk", "decode_step",
           "init_paged_cache", "paged_cache_nbytes", "decode_step_paged",
           "generate"]


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    # grouped-query attention: KV heads (None = n_heads, i.e. MHA)
    n_kv_heads: int = None
    n_layers: int = 2
    d_ff: int = 128
    n_experts: int = 0          # MoE: not ported yet
    max_len: int = 128
    dtype: torch.dtype = torch.float32
    pp_axis: str = None         # pipeline stages: not ported yet
    rope: bool = False          # rotary positions: not ported yet
    # decode_step reads the dense cache through the flash-decode kernel
    use_flash_kernel: bool = False
    kv_cache_int8: bool = False  # not ported yet


# config fields this slice does not carry, and the slice that brings each
_LATER = (
    ("rope", "RoPE arrives with the RoPE slice"),
    ("kv_cache_int8", "int8 KV caches arrive with the int8-KV slice"),
    ("n_experts", "the MoE FFN arrives with the training slice"),
    ("pp_axis", "pipeline stages arrive with the parallel slice"),
)


def _check_supported(cfg):
    for name, later in _LATER:
        if getattr(cfg, name):
            raise NotImplementedError("%s=%r: %s" % (name, getattr(cfg, name),
                                                      later))


def _kvh(cfg):
    kvh = cfg.n_kv_heads or cfg.n_heads
    if cfg.n_heads % kvh:
        raise ValueError(
            "n_heads=%d must be a multiple of n_kv_heads=%d"
            % (cfg.n_heads, kvh))
    return kvh


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
        self.w1, self.w2 = p(d, cfg.d_ff), p(cfg.d_ff, d)


class TransformerLM(nn.Module):
    """The decoder LM's parameters: ``embed [V, D]``, ``pos [max_len, D]``,
    ``ln_f [D]`` and ``layers``, named and shaped as the JAX package's
    parameter tree. The model functions of this module take it where the
    JAX functions take ``params``. Inference only: no parameter requires
    a gradient."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                            device=device),
                                requires_grad=False)

        self.embed = p(cfg.vocab_size, d)
        self.pos = p(cfg.max_len, d)
        self.ln_f = p(d)
        self.layers = nn.ModuleList(TransformerLayer(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self):
        return self.embed.device


def numpy_to_tensor(arr, dtype, device):
    """A numpy array (float64/32, or the bfloat16 numpy type JAX arrays
    convert to) as a tensor of ``dtype`` on ``device``."""
    arr = np.array(arr)                 # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def load_numpy_tree(model, tree):
    """Copy a JAX-shaped parameter tree of numpy arrays ({"embed", "pos",
    "ln_f", "layers": [{...}, ...]}) into ``model``, checking names and
    shapes."""
    if len(tree["layers"]) != len(model.layers):
        raise ValueError("tree has %d layers, model %d"
                         % (len(tree["layers"]), len(model.layers)))
    pairs = [(getattr(model, n), tree[n]) for n in ("embed", "pos", "ln_f")]
    for layer, sub in zip(model.layers, tree["layers"]):
        if set(sub) != {n for n, _ in layer.named_parameters()}:
            raise ValueError("layer keys %s do not match the model's"
                             % sorted(sub))
        pairs += [(getattr(layer, n), sub[n]) for n in sub]
    with torch.no_grad():
        for param, arr in pairs:
            if isinstance(arr, dict):
                raise NotImplementedError(
                    "int8 weight trees arrive with the int8-weights slice")
            if tuple(np.shape(arr)) != tuple(param.shape):
                raise ValueError("shape %s does not match parameter %s"
                                 % (np.shape(arr), tuple(param.shape)))
            param.copy_(numpy_to_tensor(arr, param.dtype, param.device))
    return model


def init_params(cfg, seed=0, device=None):
    """Seeded random parameters as a :class:`TransformerLM` — the same
    numpy ``RandomState`` draws, in the same order, as the JAX package's
    ``init_params``, so one seed gives the same weights in both."""
    _check_supported(cfg)
    rng = np.random.RandomState(seed)
    d, h, kvh = cfg.d_model, cfg.n_heads, _kvh(cfg)
    hd = d // h

    def dense(*shape):
        scale = 1.0 / np.sqrt(shape[0] if len(shape) == 2 else d)
        return rng.randn(*shape) * scale

    def layer():
        return {"ln1": np.ones(d), "ln2": np.ones(d),
                "wq": dense(d, h, hd), "wk": dense(d, kvh, hd),
                "wv": dense(d, kvh, hd), "wo": dense(h, hd, d),
                "w1": dense(d, cfg.d_ff), "w2": dense(cfg.d_ff, d)}

    tree = {"embed": rng.randn(cfg.vocab_size, d) * 0.02,
            "ln_f": np.ones(d),
            "layers": [layer() for _ in range(cfg.n_layers)]}
    tree["pos"] = rng.randn(cfg.max_len, d) * 0.02
    return load_numpy_tree(TransformerLM(cfg, device), tree)


def _rms_norm(x, g):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * g


def _qkv(x, p):
    q = torch.einsum("btd,dhk->bthk", x, p.wq)
    k = torch.einsum("btd,dhk->bthk", x, p.wk)    # KVH heads under GQA
    v = torch.einsum("btd,dhk->bthk", x, p.wv)
    return q, k, v


def _repeat_kv(x, g):
    """[.., T, KVH, D] -> [.., T, H, D], each KV head repeated over its
    query group."""
    return x if g == 1 else torch.repeat_interleave(x, g, dim=2)


def _ffn(x, p, cfg):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(torch.einsum("btd,df->btf", x, p.w1), approximate="tanh")
    return torch.einsum("btf,fd->btd", h, p.w2)


def _flash_min_seq():
    """Sequence length from which the JAX package routes prefill through
    its flash kernel (MXNET_FLASH_MIN_SEQ, default 8192)."""
    try:
        return int(os.environ.get("MXNET_FLASH_MIN_SEQ", "8192"))
    except ValueError:
        return 8192


def _causal_attention(q, k, v, cfg, out_dtype):
    """Causal attention over [B, T, H, D] by the dense masked softmax."""
    T = q.shape[1]
    if cfg.use_flash_kernel and T >= _flash_min_seq():
        raise NotImplementedError(
            "prefill of %d >= MXNET_FLASH_MIN_SEQ tokens needs the flash "
            "attention kernel, which arrives with the training slice" % T)
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
    rows = table[pos.long().clamp(0, n - 1)]
    return torch.where(valid[:, None], rows, float("nan"))


# ------------------------------------------------------------- decode ---

def init_cache(cfg, batch, device=None):
    """Zeroed per-layer K/V caches [batch, max_len, KVH, D] of cfg.dtype."""
    _check_supported(cfg)
    device = resolve_device(device)
    shape = (batch, cfg.max_len, _kvh(cfg), cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _cache_write_rows(layer_cache, k, v, start, cfg):
    """Write k/v [B, C, KVH, D] into cache positions [start, start+C), in
    place. A start past the end clamps so the rows fit, as
    ``dynamic_update_slice`` does."""
    c = k.shape[1]
    start = min(max(int(start), 0), layer_cache["k"].shape[1] - c)
    for name, new in (("k", k), ("v", v)):
        layer_cache[name][:, start:start + c] = new
    return layer_cache


def _cache_write_ragged(layer_cache, k_new, v_new, pos, cfg):
    """Row i writes its k/v [B, KVH, D] at pos[i], in place. A position
    past the cache is dropped, as JAX's scatter drops it."""
    t = layer_cache["k"].shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    valid = ((pos >= 0) & (pos < t))[:, None, None]
    at = pos.long().clamp(0, t - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = layer_cache[name]
        leaf[rows, at] = torch.where(valid, new.to(leaf.dtype),
                                     leaf[rows, at])
    return layer_cache


def _decode_attention(q, layer_cache, pos, cfg):
    """q [B, H, D] vs cache [B, Tmax, KVH, D], attending positions <= pos
    (an int, or [B] for ragged decode)."""
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


def prefill(params, cache, tokens, cfg):
    """Process the whole prompt tokens [B, Tp] in one forward pass,
    filling cache positions [0, Tp). Returns (last_logits [B, vocab],
    cache)."""
    _check_supported(cfg)
    b, t_p = tokens.shape
    tokens = tokens.long()
    x = params.embed[tokens] + params.pos[:t_p]
    g = cfg.n_heads // _kvh(cfg)
    for p, layer_cache in zip(params.layers, cache):
        h = _rms_norm(x, p.ln1)
        q, k, v = _qkv(h, p)
        _cache_write_rows(layer_cache, k, v, 0, cfg)
        o = _causal_attention(q, _repeat_kv(k, g), _repeat_kv(v, g), cfg,
                              x.dtype)
        x = x + torch.einsum("bthk,hkd->btd", o, p.wo)
        x = x + _ffn(_rms_norm(x, p.ln2), p, cfg)
    x = _rms_norm(x[:, -1], params.ln_f)
    return torch.einsum("bd,vd->bv", x, params.embed), cache


def prefill_chunk(params, cache, tokens, start, cfg, logits_row=None,
                  attend_limit=None):
    """Process a chunk tokens [B, C] beginning at position ``start``,
    writing its K/V into the cache. Returns the logits after every chunk
    position ([B, C, vocab]) — or, with ``logits_row``, only that row's
    [B, vocab] — and the cache. Row i attends cache positions
    <= start+i; ``attend_limit`` restricts the contraction to the first
    ``attend_limit`` positions (exact when start+C <= attend_limit)."""
    _check_supported(cfg)
    b, c = tokens.shape
    start = int(start)
    if start < 0 or start + c > cfg.max_len:
        raise ValueError("chunk [%d, %d) overruns max_len %d"
                         % (start, start + c, cfg.max_len))
    x = params.embed[tokens.long()] + params.pos[start:start + c]
    g = cfg.n_heads // _kvh(cfg)
    kvh = _kvh(cfg)
    for p, layer_cache in zip(params.layers, cache):
        h = _rms_norm(x, p.ln1)
        q, k, v = _qkv(h, p)
        _cache_write_rows(layer_cache, k, v, start, cfg)
        dh = q.shape[-1]
        qg = q.reshape(b, c, kvh, g, dh)
        ck, cv = layer_cache["k"], layer_cache["v"]
        if attend_limit is not None:
            ck, cv = ck[:, :attend_limit], cv[:, :attend_limit]
        t_pos = torch.arange(ck.shape[1], device=x.device)
        chunk_pos = start + torch.arange(c, device=x.device)
        mask = (t_pos[None, :] <= chunk_pos[:, None])[None]      # [1, C, T]
        s = torch.einsum("bckgd,btkd->bckgt", qg.float(), ck.float()) \
            / math.sqrt(dh)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bckgt,btkd->bckgd", a.to(cv.dtype).float(),
                         cv.float()).to(x.dtype).reshape(b, c, cfg.n_heads,
                                                         dh)
        x = x + torch.einsum("bchk,hkd->bcd", o, p.wo)
        x = x + _ffn(_rms_norm(x, p.ln2), p, cfg)
    x = _rms_norm(x, params.ln_f)
    if logits_row is not None:
        return torch.einsum("bd,vd->bv", x[:, int(logits_row)],
                            params.embed), cache
    return torch.einsum("bcd,vd->bcv", x, params.embed), cache


def decode_step(params, cache, tokens, pos, cfg):
    """One autoregressive step: tokens [B] at position ``pos`` (an int,
    or an int [B] tensor for ragged decode, each row at its own
    position). Returns (logits [B, vocab] for the next token, cache)."""
    _check_supported(cfg)
    device = params.device
    x = params.embed[tokens.long()]
    ragged = torch.is_tensor(pos) and pos.dim() == 1
    if ragged:
        pos = pos.to(device)
        x = x + _pos_rows(params.pos, pos)
    else:
        pos = int(pos)
        # dynamic_index_in_dim clamps the position into the table
        x = x + params.pos[min(max(pos, 0), cfg.max_len - 1)]
    for p, layer_cache in zip(params.layers, cache):
        h = _rms_norm(x, p.ln1)
        q = torch.einsum("bd,dhk->bhk", h, p.wq).contiguous()
        k_new = torch.einsum("bd,dhk->bhk", h, p.wk)
        v_new = torch.einsum("bd,dhk->bhk", h, p.wv)
        if ragged:
            _cache_write_ragged(layer_cache, k_new, v_new, pos, cfg)
        else:
            _cache_write_rows(layer_cache, k_new[:, None], v_new[:, None],
                              pos, cfg)
        o = _decode_attention(q, layer_cache, pos, cfg)
        x = x + torch.einsum("bhk,hkd->bd", o, p.wo)
        x = x + _ffn(_rms_norm(x, p.ln2)[:, None], p, cfg)[:, 0]
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bd,vd->bv", x, params.embed), cache


# ------------------------------------------------------- paged decode ---
# The KV cache split into fixed-size blocks: one per-layer pool
# [num_blocks, block_size, KVH, D] shared by every lane, and per-lane
# int32 block tables [B, max_len // block_size] mapping positions
# [j*bs, (j+1)*bs) to a pool block. Block 0 is the null block:
# unallocated entries point at it, and writes past a lane's allocation
# land there, never attended by a live request.

def init_paged_cache(cfg, num_blocks, block_size, device=None):
    """Zeroed per-layer block pools [num_blocks, block_size, KVH, D]."""
    _check_supported(cfg)
    if num_blocks < 2:
        raise ValueError("need >= 2 blocks (block 0 is the null block)")
    device = resolve_device(device)
    shape = (num_blocks, block_size, _kvh(cfg), cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def paged_cache_nbytes(cfg, num_blocks, block_size):
    """Byte size of the pools :func:`init_paged_cache` would build."""
    _check_supported(cfg)
    hd = cfg.d_model // cfg.n_heads
    cells = num_blocks * block_size * _kvh(cfg)
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return int(2 * cells * hd * itemsize * cfg.n_layers)


def _paged_write_ragged(layer_pool, k_new, v_new, tables, pos, cfg):
    """Row i writes its k/v [B, KVH, D] into block tables[i, pos[i]//bs]
    at offset pos[i] % bs, in place. A position past the table is
    dropped: JAX's ``take_along_axis`` fills such a table index with
    INT_MIN and its scatter drops the write. An unallocated entry is the
    null block."""
    bs = layer_pool["k"].shape[1]
    nb = tables.shape[1]
    idx = torch.div(pos, bs, rounding_mode="floor").long()
    valid = ((idx >= 0) & (idx < nb))[:, None, None]
    blk = tables.gather(1, idx.clamp(0, nb - 1)[:, None])[:, 0].long()
    off = torch.remainder(pos, bs).long()
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = layer_pool[name]
        leaf[blk, off] = torch.where(valid, new.to(leaf.dtype),
                                     leaf[blk, off])
    return layer_pool


def decode_step_paged(params, pool, tables, tokens, pos, cfg):
    """One ragged autoregressive step through the block tables.

    tokens [B] int, pos [B] int32, tables [B, max_len//bs] int32. Returns
    (logits [B, vocab], pool); the tables are read-only here. Attention
    reads the pool through the tables with the paged kernel on CUDA
    tensors, and with its plain version on the CPU."""
    _check_supported(cfg)
    pos = pos.to(device=params.device, dtype=torch.int32)
    x = params.embed[tokens.long()] + _pos_rows(params.pos, pos)
    for p, layer_pool in zip(params.layers, pool):
        h = _rms_norm(x, p.ln1)
        q = torch.einsum("bd,dhk->bhk", h, p.wq)
        k_new = torch.einsum("bd,dhk->bhk", h, p.wk)
        v_new = torch.einsum("bd,dhk->bhk", h, p.wv)
        _paged_write_ragged(layer_pool, k_new, v_new, tables, pos, cfg)
        o = paged_attention(q[:, None].contiguous(), layer_pool, tables,
                            pos)[:, 0]
        x = x + torch.einsum("bhk,hkd->bd", o, p.wo)
        x = x + _ffn(_rms_norm(x, p.ln2)[:, None], p, cfg)[:, 0]
    x = _rms_norm(x, params.ln_f)
    return torch.einsum("bd,vd->bv", x, params.embed), pool


# ----------------------------------------------------------- generate ---

def _check_greedy(greedy, temperature, top_k, top_p):
    """generate()'s rule for the decoding controls; only greedy decoding
    is ported."""
    sampling_requested = (temperature != 1.0 or top_k is not None
                          or top_p is not None)
    if greedy and sampling_requested:
        raise ValueError(
            "greedy=True ignores temperature/top_k/top_p — pass "
            "greedy=False (or omit greedy) to sample")
    if sampling_requested or greedy is False:
        raise NotImplementedError(
            "sampling arrives with the sampling slice; only greedy "
            "decoding is ported")


def _check_params_device(params, device):
    if params.device != device:
        raise ValueError("parameters lie on %s, not on %s: build them with "
                         "init_params(..., device=%s)"
                         % (params.device, device, device))


def _generate_core(params, prompt, cache, n_new, cfg):
    """Prefill, then greedy decode steps, as a Python loop."""
    b, t_prompt = prompt.shape
    total = t_prompt + n_new
    buf = torch.zeros((b, total), dtype=torch.int32, device=prompt.device)
    buf[:, :t_prompt] = prompt
    last_logits, cache = prefill(params, cache, prompt, cfg)
    # torch.argmax takes the first maximum, as jnp.argmax does
    buf[:, t_prompt] = torch.argmax(last_logits, dim=-1).to(torch.int32)
    for pos in range(t_prompt, total - 1):
        logits, cache = decode_step(params, cache, buf[:, pos], pos, cfg)
        buf[:, pos + 1] = torch.argmax(logits, dim=-1).to(torch.int32)
    return buf


@torch.no_grad()
def generate(params, prompt, n_new, cfg, greedy=None, temperature=1.0,
             top_k=None, top_p=None, device=None):
    """Greedy generation: prompt [B, Tp] int -> int32 [B, Tp+n_new] on
    ``device`` (the current CUDA device by default; raises when there is
    none). The prompt is prefilled in one forward pass, then each token
    is one :func:`decode_step`."""
    _check_supported(cfg)
    _check_greedy(greedy, temperature, top_k, top_p)
    device = resolve_device(device)
    _check_params_device(params, device)
    if not torch.is_tensor(prompt):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.int32)
    b, t_prompt = prompt.shape
    total = t_prompt + n_new
    if total > cfg.max_len:
        raise ValueError("prompt+n_new %d exceeds max_len %d"
                         % (total, cfg.max_len))
    if n_new == 0:
        return prompt
    cache = init_cache(cfg, b, device)
    return _generate_core(params, prompt, cache, n_new, cfg)
