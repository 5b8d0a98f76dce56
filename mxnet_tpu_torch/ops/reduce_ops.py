"""Reduction / broadcast-family operators (port of
``mxnet_tpu/ops/reduce_ops.py``).

Axis, keepdims and ``exclude`` follow the reference
(broadcast_reduce_op.h). Dtypes follow the JAX package: an integer sum
or product (``sum``, ``prod``, ``nansum``, ``nanprod``) accumulates as
``jnp.sum`` does — bool, int8 and int16 as int32, uint8 and uint16 as
uint32, int32 and uint32 in their own type, wrapping as 32-bit integers
do — where torch would keep a narrow type or widen to int64; a mean of
integers, and ``moments``, are float32; ``argmax``/``argmin`` return
float32 positions. ``max``/``min`` divide the gradient among ties, as JAX does
(``torch.amax``/``amin``).
"""

import torch

from . import register


def _norm_axes(axis, ndim, exclude=False):
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


# the type jnp.sum and jnp.prod give an integer input
_INT_ACC = {torch.bool: torch.int32, torch.int8: torch.int32,
            torch.int16: torch.int32, torch.int32: torch.int32,
            torch.uint8: torch.uint32, torch.uint16: torch.uint32,
            torch.uint32: torch.uint32}


def _int_reduce(fn, x):
    """``fn`` over an integer or bool ``x`` in JAX's accumulation type:
    summed in int64 (torch has no uint32 sum), whose low 32 bits are the
    wrapped 32-bit result; None for a float ``x``."""
    if x.dtype.is_floating_point:
        return None
    return fn(x.to(torch.int64)).to(_INT_ACC.get(x.dtype, x.dtype))


def _over_last(fn, x, axes, keepdims):
    """Apply a one-axis reduction ``fn(x, dim)`` over several axes: move
    them last, flatten them, reduce, and restore kept dims."""
    rest = [a for a in range(x.dim()) if a not in axes]
    y = x.permute(rest + list(axes)).reshape(
        [x.shape[a] for a in rest] + [-1])
    y = fn(y, -1)
    if keepdims:
        y = y.reshape([1 if a in axes else x.shape[a]
                       for a in range(x.dim())])
    return y


def _sum(x, axes, keepdims):
    def fn(y):
        return torch.sum(y, dim=axes, keepdim=keepdims)
    out = _int_reduce(fn, x)
    return fn(x) if out is None else out


def _mean(x, axes, keepdims):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    def fn(y):
        return _over_last(lambda z, d: torch.prod(z, dim=d), y, axes,
                          keepdims)
    out = _int_reduce(fn, x)
    return fn(x) if out is None else out


def _max(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims)


def _min(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims)


def _nansum(x, axes, keepdims):
    if not x.dtype.is_floating_point:
        return _sum(x, axes, keepdims)
    return torch.nansum(x, dim=axes, keepdim=keepdims)


def _nanprod(x, axes, keepdims):
    if x.dtype.is_floating_point:
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


for _n, _f in [
    ("sum", _sum), ("mean", _mean), ("prod", _prod),
    ("max", _max), ("min", _min),
    ("nansum", _nansum), ("nanprod", _nanprod),
]:
    def _mk(n=_n, f=_f):
        aliases = ("sum_axis",) if n == "sum" else ()

        @register(name=n, aliases=aliases)
        def _op(data, axis=None, keepdims=False, exclude=False):
            axes = _norm_axes(axis, data.dim(), exclude)
            if not axes and data.dim():
                # no axis left (``exclude`` of every axis) reduces nothing,
                # as in JAX; torch reads dim=() as every axis
                return f(data.unsqueeze(-1), (data.dim(),), False)
            return f(data, axes, keepdims)
    _mk()


@register(name="norm")
def norm(data, ord=2, axis=None, keepdims=False):
    axes = _norm_axes(axis, data.dim())
    if ord == 1:
        return torch.sum(torch.abs(data), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        return fn(data.reshape(-1)).to(torch.float32)
    r = fn(data, dim=axis, keepdim=keepdims)
    return r.to(torch.float32)


@register(name="argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register(name="argmin", differentiable=False)
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register(name="argmax_channel", differentiable=False)
def argmax_channel(data):
    """Argmax over the last axis, as float32."""
    return torch.argmax(data, dim=-1).to(torch.float32)


@register(name="pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """broadcast_reduce_op_index.cc pick: ``data`` at ``index`` along
    ``axis``, the index clipped or wrapped into range."""
    ax = axis % data.dim()
    idx = index.to(torch.int32).to(torch.int64)
    n = data.shape[ax]
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    picked = torch.gather(data, ax, idx.unsqueeze(ax))
    return picked if keepdims else picked.squeeze(ax)


@register(name="broadcast_to")
def broadcast_to(data, shape=()):
    # MXNet semantics: 0 in the target shape keeps the source dim
    tgt = tuple(s if s != 0 else data.shape[i] for i, s in enumerate(shape))
    return data.expand(tgt)


@register(name="broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la % lhs.dim()] = rhs.shape[ra % rhs.dim()]
    return lhs.expand(tuple(tgt))


@register(name="broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a % data.dim()] = s
    return data.expand(tuple(tgt))


@register(name="L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError("unknown mode %s" % mode)
    n = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                   + eps)
    return data / n


@register(name="moments", num_outputs=2)
def moments(data, axes=None, keepdims=False):
    """Mean and population variance over ``axes`` (nn/moments.cc)."""
    ax = _norm_axes(axes, data.dim())
    if not data.dtype.is_floating_point:
        data = data.to(torch.float32)
    mean = torch.mean(data, dim=ax, keepdim=keepdims)
    centered = data - torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean(torch.square(centered), dim=ax, keepdim=keepdims)
    return mean, var


@register(name="khatri_rao")
def khatri_rao(*args):
    """Column-wise Khatri-Rao product (contrib/krprod.cc)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out
