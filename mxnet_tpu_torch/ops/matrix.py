"""Matrix / shape-manipulation / indexing operators (port of
``mxnet_tpu/ops/matrix.py``).

Out-of-range indices follow the JAX package where an op defines them:
``take`` and ``pick`` clip or wrap by ``mode``; ``take`` in any other
mode fills an out-of-range position as ``jnp.take`` does (NaN for
floats, the most negative value for signed integers). Creation ops
take the ``device`` to allocate on (the dispatcher passes the context's).
``shuffle`` draws from the device's generator (``random.generator``).
"""

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from . import register


# ------------------------------------------------------------------ dot --
def _swap_last(x):
    return x.transpose(-1, -2)


@register(name="dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """dot-inl.h: contracts the last axis of lhs with the first of rhs."""
    a = _swap_last(lhs) if transpose_a else lhs
    b = _swap_last(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register(name="batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = _swap_last(lhs) if transpose_a else lhs
    b = _swap_last(rhs) if transpose_b else rhs
    return torch.matmul(a, b)


# ---------------------------------------------------------------- shape --
@register(name="Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False):
    """Reshape with MXNet's special codes: 0 copy dim, -1 infer, -2 copy
    rest, -3 merge two, -4 split."""
    if not shape:
        return data
    src = list(data.shape[::-1]) if reverse else list(data.shape)
    spec = list(shape[::-1]) if reverse else list(shape)
    out = []
    i = 0
    j = 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = spec[j + 1], spec[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


@register(name="reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register(name="Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register(name="transpose")
def transpose(data, axes=None):
    if axes is None or axes == ():
        return data.permute(*reversed(range(data.dim())))
    return data.permute(*axes)


@register(name="expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register(name="squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register(name="swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


@register(name="depth_to_space")
def depth_to_space(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register(name="space_to_depth")
def space_to_depth(data, block_size=2):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------- slice --
def _slice_axis(x, ax, b, e, s):
    """x[..., b:e:s, ...] on axis ``ax``; a negative step (which torch
    slicing lacks) selects the positions Python's slice gives."""
    if s is not None and s < 0:
        idx = list(range(*slice(b, e, s).indices(x.shape[ax])))
        return x.index_select(ax, torch.tensor(idx, dtype=torch.int64,
                                               device=x.device))
    key = [slice(None)] * x.dim()
    key[ax] = slice(b, e, s)
    return x[tuple(key)]


@register(name="slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    out = data
    for i in range(data.dim()):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] not in (None, 0) else None
        if (b, e, s) != (None, None, None):
            out = _slice_axis(out, i, b, e, s)
    return out


@register(name="slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    return _slice_axis(data, axis % data.dim(), begin, end, None)


@register(name="slice_like")
def slice_like(data, shape_like, axes=()):
    axes = axes or tuple(range(min(data.dim(), shape_like.dim())))
    key = [slice(None)] * data.dim()
    for a in axes:
        key[a % data.dim()] = slice(0, shape_like.shape[a % shape_like.dim()])
    return data[tuple(key)]


def _split_equal(data, sections, axis):
    n = data.shape[axis]
    if n % sections:
        raise ValueError("array split does not result in an equal "
                         "division: %d into %d" % (n, sections))
    return torch.split(data, n // sections, dim=axis)


@register(name="SliceChannel", aliases=("split",), num_outputs="n")
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    parts = _split_equal(data, num_outputs, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register(name="Concat", aliases=("concat",))
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@register(name="stack")
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register(name="tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register(name="repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register(name="reverse", aliases=("flip",))
def reverse(data, axis=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axes)


def _pad_index(n, before, after, mode, device):
    pos = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return pos.clamp(0, n - 1)
    # reflect: mirror about the edge elements without repeating them
    pos = torch.where(pos < 0, -pos, pos)
    return torch.where(pos > n - 1, 2 * (n - 1) - pos, pos)


@register(name="Pad", aliases=("pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """pad.cc: ``pad_width`` is MXNet's flat (before, after) pairs."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    pw += [(0, 0)] * (data.dim() - len(pw))
    if mode == "constant":
        flat = [p for b, a in reversed(pw) for p in (b, a)]
        return F.pad(data, flat, mode="constant", value=constant_value)
    if mode not in ("edge", "reflect"):
        raise KeyError(mode)
    out = data
    for ax, (b, a) in enumerate(pw):
        if b or a:
            out = out.index_select(ax, _pad_index(data.shape[ax], b, a,
                                                  mode, data.device))
    return out


# ------------------------------------------------------------- indexing --
def _index(indices):
    """An index array as int64, its values truncated toward zero as the
    JAX package's ``astype('int32')`` does."""
    return indices.to(torch.int32).to(torch.int64)


def _fill_value(dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


def _take_axis(a, idx, axis):
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register(name="take")
def take(a, indices, axis=0, mode="clip"):
    """indexing_op.cc take."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = _index(indices)
    if mode == "wrap":
        return _take_axis(a, torch.remainder(idx, n), axis)
    if mode == "clip":
        return _take_axis(a, idx.clamp(0, n - 1), axis)
    # jnp.take's default: negative positions count from the end, and
    # what still lies out of range is filled
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = _take_axis(a, torch.where(valid, idx, 0), axis)
    shape = [1] * axis + list(idx.shape) + [1] * (a.dim() - axis - 1)
    return torch.where(valid.reshape(shape), out,
                       torch.full((), _fill_value(a.dtype), dtype=a.dtype,
                                  device=a.device))


@register(name="batch_take")
def batch_take(a, indices):
    idx = _index(indices).clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx[:, None])[:, 0]


@register(name="Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """indexing_op.cc Embedding: rows of ``weight``, indices clipped."""
    idx = _index(data).clamp(0, weight.shape[0] - 1)
    return _take_axis(weight, idx, 0)


@register(name="one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """An index outside [0, depth) gives a row of off_value, as
    jax.nn.one_hot does."""
    idx = _index(indices)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(
        torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def _nd_key(indices):
    idx = _index(indices)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register(name="gather_nd")
def gather_nd(data, indices):
    return data[_nd_key(indices)]


@register(name="scatter_nd")
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_key(indices), data)


@register(name="_scatter_set_nd")
def scatter_set_nd(lhs, indices, rhs, shape=()):
    return lhs.index_put(_nd_key(indices), rhs)


@register(name="where")
def where(condition, x, y):
    cond = condition if condition.dtype == torch.bool else condition != 0
    return torch.where(cond, x, y)


@register(name="boolean_mask_dense")
def boolean_mask_dense(data, mask):
    """Zeroes the rows where ``mask`` is 0 and keeps the input shape."""
    m = (mask != 0).to(data.dtype)
    return data * m.reshape(tuple(m.shape) + (1,) * (data.dim() - m.dim()))


@register(name="_contrib_boolean_mask")
def boolean_mask(data, index, axis=0):
    """contrib boolean_mask: the rows where ``index`` != 0 (the output's
    shape depends on the data)."""
    idx = torch.nonzero(index != 0).reshape(-1)
    return data.index_select(axis, idx)


# ------------------------------------------------------------- ordering --
@register(name="sort")
def sort(data, axis=-1, is_ascend=True):
    r = torch.sort(data, dim=axis, stable=True).values
    return r if is_ascend else torch.flip(r, dims=(axis,))


@register(name="argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    r = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        r = torch.flip(r, dims=(axis,))
    return r.to(torch_dtype(dtype))


@register(name="topk", differentiable=False, num_outputs="n")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """ordering_op.cc topk; ties keep the lower position first, as
    lax.top_k does."""
    ax = axis % data.dim() if axis is not None else data.dim() - 1
    d = data.movedim(ax, -1)
    vals, idxs = torch.sort(d, dim=-1, descending=not is_ascend,
                            stable=True)
    vals, idxs = vals[..., :k], idxs[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(d).scatter(-1, idxs, 1)
        return mask.movedim(-1, ax)
    vals = vals.movedim(-1, ax)
    idxs = idxs.movedim(-1, ax).to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idxs
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    raise ValueError(ret_typ)


@register(name="shuffle", aliases=("_shuffle",),
          differentiable=False, stateful_rng=True)
def shuffle(data, generator=None):
    """A random permutation of the rows, drawn from ``generator``."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


# ----------------------------------------------------------------- init --
@register(name="_zeros", differentiable=False)
def zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register(name="_ones", differentiable=False)
def ones(shape=(), dtype="float32", device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register(name="_full", differentiable=False)
def full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=device)


def arange_tensor(start, stop, step, repeat, dtype, device):
    if stop is None:
        start, stop = 0, start
    r = torch.arange(start, stop, step, dtype=dtype, device=device)
    return torch.repeat_interleave(r, repeat) if repeat > 1 else r


def linspace_tensor(start, stop, num, endpoint, dtype, device):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=dtype, device=device)
    return torch.linspace(start, stop, num + 1, dtype=dtype,
                          device=device)[:num]


def eye_tensor(n, m, k, dtype, device):
    m = m or n
    rows = torch.arange(n, device=device)[:, None]
    return (rows + k == torch.arange(m, device=device)[None, :]).to(dtype)


@register(name="_arange", differentiable=False)
def arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
           device=None):
    return arange_tensor(start, stop, step, repeat, torch_dtype(dtype),
                         device)


@register(name="_linspace", differentiable=False)
def linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
             device=None):
    return linspace_tensor(start, stop, num, endpoint, torch_dtype(dtype),
                           device)


@register(name="_eye", differentiable=False)
def eye(N=1, M=0, k=0, dtype="float32", device=None):
    return eye_tensor(int(N), int(M), int(k), torch_dtype(dtype), device)


@register(name="zeros_like", differentiable=False)
def zeros_like(data):
    return torch.zeros_like(data)


@register(name="ones_like", differentiable=False)
def ones_like(data):
    return torch.ones_like(data)


# shape_array/size_array ask for int64; the JAX package, with 64-bit
# types off, returns int32, and so does the port
@register(name="shape_array", differentiable=False)
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register(name="size_array", differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register(name="histogram", aliases=("_histogram",),
          differentiable=False, num_outputs=2)
def histogram(data, bins=10, range=None):
    """Counts (float32) and edges, binned as jnp.histogram does: bins
    closed on the left, the last one on both sides; the edges in the
    input's float dtype (float32 for integers), and the data binned
    against those rounded edges."""
    x = data.reshape(-1).to(torch.float32)
    if range is None:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(range[0]), float(range[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    dtype = data.dtype if data.dtype.is_floating_point else torch.float32
    out_edges = torch.linspace(lo, hi, bins + 1, device=x.device).to(dtype)
    edges = out_edges.to(torch.float32)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, device=x.device).index_add_(
        0, idx, torch.ones_like(x))
    return counts[1:-1], out_edges


@register(name="diag")
def diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register(name="UpSampling")
def upsampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat"):
    """nn/upsampling.cc: nearest, or bilinear with half-pixel centres."""
    x = data[0]
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(x, scale, dim=2), scale, dim=3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register(name="GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """grid_generator.cc, affine only; float32 whatever ``data``'s
    dtype, as JAX's einsum promotes it against its float32 grid."""
    h, w = target_shape
    data = data.to(torch.float32)
    ys = torch.linspace(-1.0, 1.0, h, device=data.device)
    xs = torch.linspace(-1.0, 1.0, w, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)], dim=0)
    theta = data.reshape(-1, 2, 3)
    out = torch.einsum("nij,jk->nik", theta, grid)
    return out.reshape(-1, 2, h, w)


@register(name="BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=False):
    """bilinear_sampler.cc: sample NCHW ``data`` at ``grid`` locations
    in [-1, 1]; taps outside the image count as 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    x1 = x0 + 1
    y0 = torch.floor(gy)
    y1 = y0 + 1
    wx1 = gx - x0
    wx0 = 1.0 - wx1
    wy1 = gy - y0
    wy0 = 1.0 - wy1
    flat = data.reshape(n, c, h * w)

    def sample(yy, xx):
        valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xc = xx.clamp(0, w - 1).to(torch.int64)
        yc = yy.clamp(0, h - 1).to(torch.int64)
        lin = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        g = torch.gather(flat, 2, lin).reshape((n, c) + tuple(xx.shape[1:]))
        return g * valid[:, None].to(data.dtype)

    return (sample(y0, x0) * (wy0 * wx0)[:, None]
            + sample(y0, x1) * (wy0 * wx1)[:, None]
            + sample(y1, x0) * (wy1 * wx0)[:, None]
            + sample(y1, x1) * (wy1 * wx1)[:, None])


# ------------------------------------------------------------ sequence --
@register(name="SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """sequence_mask.cc: data is (seq, batch, ...) for axis=0."""
    if not use_sequence_length or sequence_length is None:
        return data
    slen = data.shape[axis]
    shape = [1] * data.dim()
    shape[axis] = slen
    pos = torch.arange(slen, device=data.device).reshape(shape)
    batch_axis = 1 - axis
    lshape = [1] * data.dim()
    lshape[batch_axis] = data.shape[batch_axis]
    mask = pos < sequence_length.reshape(lshape)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register(name="SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    lens = (_index(sequence_length) - 1).clamp(0, data.shape[axis] - 1)
    d = data.movedim(axis, 0)
    idx = lens.reshape((1, -1) + (1,) * (d.dim() - 2)).expand(
        (1,) + tuple(d.shape[1:]))
    return torch.gather(d, 0, idx)[0]


@register(name="SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    slen = data.shape[axis]
    pos = torch.arange(slen, device=data.device)[:, None]
    lens = _index(sequence_length)[None, :]
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    d = data.movedim(axis, 0)
    idx = rev.reshape(tuple(rev.shape) + (1,) * (d.dim() - 2)).expand(
        d.shape)
    return torch.gather(d, 0, idx).movedim(0, axis)


# ------------------------------------------------- reference-parity ops --
@register(name="_split_v2", num_outputs="n")
def split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    """matrix_op.cc ``_split_v2``: equal sections, or section-START
    boundaries ``indices`` (leading 0 included)."""
    ax = axis % data.dim()
    if sections and sections > 0:
        parts = _split_equal(data, sections, ax)
    else:
        bounds = list(indices) + [data.shape[ax]]
        parts = [data.narrow(ax, bounds[i], bounds[i + 1] - bounds[i])
                 for i in range(len(indices))]
    if squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


def _region(begin, end, step, shape):
    key = []
    for i in range(len(shape)):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] not in (None, 0) else None
        key.append(slice(b, e, s))
    return tuple(key)


@register(name="_slice_assign", aliases=("_crop_assign",))
def slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``x[begin:end:step] = y`` as a pure op: a new array."""
    out = lhs.clone()
    out[_region(begin, end, step, lhs.shape)] = rhs
    return out


@register(name="_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_region(begin, end, step, data.shape)] = scalar
    return out


@register(name="_ravel_multi_index", aliases=("ravel_multi_index",),
          differentiable=False)
def ravel_multi_index(data, shape=()):
    """ravel.cc: data is (ndim, N) coordinates."""
    strides = []
    acc = 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    strides = torch.tensor(strides[::-1], dtype=data.dtype,
                           device=data.device).reshape(-1, 1)
    return torch.sum(data * strides, dim=0, dtype=data.dtype)


@register(name="_unravel_index", aliases=("unravel_index",),
          differentiable=False)
def unravel_index(data, shape=()):
    idx = data.to(torch.int64)
    coords = []
    for d in reversed(shape):
        coords.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    return torch.stack([c.to(data.dtype) for c in reversed(coords)], dim=0)


@register(name="_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    """Forwards lhs; rhs only pins shape and storage type."""
    return lhs


@register(name="_zeros_without_dtype", differentiable=False)
def zeros_without_dtype(shape=(), ctx=None, dtype=None, device=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt = torch.float32 if dtype in (None, -1) else torch_dtype(dtype)
    return torch.zeros(shape, dtype=dt, device=device)


@register(name="_rnn_param_concat")
def rnn_param_concat(*data, dim=0, num_args=None):
    """Concatenates 1-D parameter packs (matrix_op.cc)."""
    return torch.cat([d.reshape(-1) for d in data], dim=0)


@register(name="cast_storage", differentiable=False)
def cast_storage_op(data, stype="default"):
    """Every array is dense here; storage casts are the identity."""
    return data


@register(name="_sparse_retain")
def sparse_retain(data, indices):
    """Keeps the listed rows and zeroes the rest (dense emulation)."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[_index(indices)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))
