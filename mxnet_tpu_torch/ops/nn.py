"""Neural-network operators (port of ``mxnet_tpu/ops/nn.py``): the ops a
ResNet runs — ``Convolution``, ``Pooling``, ``FullyConnected``,
``BatchNorm`` (alias ``BatchNorm_v1``), ``Activation``, the softmax
family (``softmax``, ``log_softmax``, ``softmin``, ``SoftmaxActivation``,
``SoftmaxOutput`` with its alias ``Softmax``, ``softmax_cross_entropy``)
and ``Dropout``. The JAX module's other names stay queued (``_queued.py``,
ROADMAP item A6).

The JAX package computes all of these with XLA ops, not Pallas; here
they are torch ops (cuDNN and cuBLAS on the card), in MXNet's ``NCHW`` /
``OIHW`` layouts. The numeric conventions of the reference are kept:

  * ``Activation(act_type="relu")`` has gradient 0 at x == 0
    (``torch.relu``'s, the reference's relu-mask default), unlike the
    elementwise ``relu``, which splits a tie in half as ``jnp.maximum``;
  * max pooling sends a tied window's whole cotangent to its first
    maximum in scan order (torch's max-pool keeps the first strictly
    greater element, as XLA's select-and-scatter does); the ``full``
    convention pads the high side explicitly, and avg pooling without
    ``count_include_pad`` divides by the count of real elements;
  * ``BatchNorm`` in training takes single-pass statistics shifted by
    the detached running mean, summed in fp32, with the centred value
    kept in a bf16 stream's dtype; it returns ``(out, batch_mean,
    batch_var)`` and the caller folds the running statistics;
  * ``SoftmaxOutput``'s gradient is ``(p - onehot)`` scaled, whatever the
    head gradient.

The TPU memory levers of the reference (``MXNET_INT8_RESIDUAL``,
``MXNET_POOL_INDEX_RESIDUAL``, and the switches of the bf16 BN residual
and of the relu mask) are not ported: their defaults are the behaviour.
``Dropout`` draws its mask from the ``generator`` it is given (the
device's ``random.generator`` in ``nd``, the executor's in a graph).
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from . import register
from .elemwise import _abs


def _tuplize(v, n):
    if v is None or v == ():
        return (1,) * n if n else ()
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) == 1:
        return v * n
    return v


# ---------------------------------------------------------- convolution --
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register(name="Convolution")
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=1, num_group=1, no_bias=False,
                layout=None, workspace=1024, cudnn_tune=None, cudnn_off=False):
    """N-D convolution, NC[DHW] data and OI[DHW] weights; a bf16
    convolution returns bf16. ``workspace``/``cudnn_*``/``layout`` are
    accepted for source compatibility and ignored, as in the reference."""
    nd = data.dim() - 2
    out = _CONV[nd](data, weight, None, _tuplize(stride, nd),
                    _tuplize(pad if pad != () else 0, nd),
                    _tuplize(dilate, nd), num_group)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# -------------------------------------------------------------- pooling --
def _window_reduce(data, kernel, stride, pads, combine, init_val):
    """Reduce over sliding windows, one strided slice per kernel offset,
    in the reference's order (``ops/nn.py`` ``_window_reduce``). ``data``
    is NC<spatial>, or bare <spatial> for a numpy array; ``pads`` is
    [(lo, hi)] per spatial dim."""
    nsp = len(kernel)
    nbatch = data.ndim - nsp
    if isinstance(data, np.ndarray):
        padded = np.pad(data, [(0, 0)] * nbatch + list(pads),
                        constant_values=init_val)
    else:
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        padded = F.pad(data, flat, value=init_val) if any(flat) else data
    out_len = [(padded.shape[nbatch + d] - kernel[d]) // stride[d] + 1
               for d in range(nsp)]
    acc = None
    for off in itertools.product(*[range(k) for k in kernel]):
        sl = (slice(None),) * nbatch + tuple(
            slice(off[d], off[d] + (out_len[d] - 1) * stride[d] + 1,
                  stride[d]) for d in range(nsp))
        piece = padded[sl]
        acc = piece if acc is None else combine(acc, piece)
    return acc


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _max_pool(data, kernel, stride, pads):
    """Windowed max whose gradient goes to each window's first maximum.
    Symmetric pads of at most half the kernel go to torch's own padding;
    others (the ``full`` convention's high side) are padded with -inf."""
    nd = len(kernel)
    if not data.dtype.is_floating_point:
        init = torch.iinfo(data.dtype).min
        return _window_reduce(data, kernel, stride, pads, torch.maximum,
                              init)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return _MAX_POOL[nd](data, kernel, stride, [lo for lo, _ in pads])
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return _MAX_POOL[nd](F.pad(data, flat, value=float("-inf")), kernel,
                         stride)


@register(name="Pooling")
def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            count_include_pad=True, layout=None, p_value=2):
    """max/avg/sum/lp pooling, valid and full conventions, global pooling."""
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=axes, keepdim=True)
        if pool_type == "lp":
            return torch.pow(torch.pow(_abs(data), p_value).sum(
                dim=axes, keepdim=True), 1.0 / p_value)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride, nd)
    pad = _tuplize(pad if pad != () else 0, nd)
    for i in range(nd):
        if pooling_convention != "full" and \
                kernel[i] > data.shape[2 + i] + 2 * pad[i]:
            raise ValueError(
                "Pooling kernel %s exceeds padded input %s on axis %d "
                "(valid convention); shrink the kernel, pad, or use "
                "global_pool" % (kernel, tuple(data.shape[2:]), i))
    pads = []
    for i in range(nd):
        lo = hi = pad[i]
        if pooling_convention == "full":
            # ceil convention (pooling-inl.h): pad extra on the high side
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem != 0:
                hi += stride[i] - rem
        pads.append((lo, hi))
    if pool_type == "max":
        return _max_pool(data, kernel, stride, pads)
    if pool_type == "lp":
        s = _window_reduce(torch.pow(_abs(data), p_value), kernel, stride,
                           pads, torch.add, 0)
        return torch.pow(s, 1.0 / p_value)
    s = _window_reduce(data, kernel, stride, pads, torch.add, 0)
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / torch.tensor(float(np.prod(kernel)), dtype=data.dtype)
    # denominators depend only on static shapes: computed on the host
    cnt = _window_reduce(np.ones(tuple(data.shape[2:]), np.float32), kernel,
                         stride, pads, np.add, 0)
    return s / torch.as_tensor(cnt, device=data.device).to(data.dtype)


# ------------------------------------------------------ fully-connected --
@register(name="FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=1, no_bias=False,
                    flatten=True):
    """y = x W^T + b, with x flattened to (batch, -1) by default."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    y = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        y = y + bias
    return y


# ------------------------------------------------------------ batch norm --
@register(name="BatchNorm", aliases=("BatchNorm_v1",), num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, is_train=False):
    """Returns (out, batch_mean, batch_var); the caller folds the running
    statistics ``moving = momentum * moving + (1 - momentum) * batch``
    (the Gluon layer eagerly, the executor in a graph). In training the
    statistics are E[x - s] and E[(x - s)^2] of one pass, s the detached
    running mean, summed in fp32 (float64 for a float64 stream); for a
    bf16 stream the centred value stays bf16. The output is ``x * scale +
    bias`` in x's dtype, with the per-channel scale and bias formed in
    fp32 (float64 for a float64 stream)."""
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    acc = torch.promote_types(data.dtype, torch.float32)
    if is_train and not use_global_stats:
        shift = moving_mean.detach().to(acc).reshape(shape)
        if data.dtype == torch.bfloat16:
            centered = data - shift.to(data.dtype)
        else:
            centered = data.to(acc) - shift
        mean_c = centered.mean(dim=red, dtype=acc)
        var = (centered * centered).mean(dim=red, dtype=acc) \
            - mean_c * mean_c
        var = torch.maximum(var, var.new_zeros(()))
        mean = (mean_c + shift.reshape(-1)).to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var.to(acc) + eps)
    g_acc = g.to(acc)
    scale = (g_acc * inv).to(data.dtype)
    bias = (beta.to(acc) - g_acc * mean.to(acc) * inv).to(data.dtype)
    out = data * scale.reshape(shape) + bias.reshape(shape)
    return out.to(data.dtype), mean, var


# ------------------------------------------------------------ activation --
@register(name="Activation")
def activation(data, act_type="relu"):
    """relu (gradient 0 at 0), sigmoid, tanh, softrelu, softsign."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, data.new_zeros(()))
    if act_type == "softsign":
        return data / (1 + _abs(data))
    raise ValueError("unknown act_type %s" % act_type)


# --------------------------------------------------------------- softmax --
def _scaled(data, temperature):
    return data / temperature if temperature not in (None, 1.0, 0.0) \
        else data


def _cast(out, dtype):
    return out if dtype is None else out.to(torch_dtype(dtype))


@register(name="softmax")
def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    x = _scaled(data, temperature)
    if use_length and length is not None:
        shape = [1] * x.dim()
        shape[axis % x.dim()] = x.shape[axis]
        pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        mask = pos < length.reshape([-1] + [1] * (x.dim() - 1))
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
    return _cast(torch.softmax(x, dim=axis), dtype)


@register(name="log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    return _cast(torch.log_softmax(_scaled(data, temperature), dim=axis),
                 dtype)


@register(name="softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register(name="SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward (p - onehot(label)), smoothed, masked and
    scaled as configured, ignoring the head gradient; zeros for the
    label."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        grad_scale, ignore_label, multi_output, use_ignore, normalization, \
            smooth_alpha = cfg
        axis = 1 if (multi_output and data.dim() > 2) else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, multi_output, use_ignore, normalization, \
            smooth_alpha = ctx.cfg
        axis = (1 if (multi_output and out.dim() > 2) else -1) % out.dim()
        nclass = out.shape[axis]
        lbl = label.to(torch.int32)
        shape = [1] * out.dim()
        shape[axis] = nclass
        classes = torch.arange(nclass, device=out.device).reshape(shape)
        oh = (lbl.unsqueeze(axis) == classes).to(out.dtype)
        if smooth_alpha:
            oh = oh * (1.0 - smooth_alpha - smooth_alpha / (nclass - 1)) \
                + smooth_alpha / (nclass - 1)
        grad = out - oh
        if use_ignore:
            keep = (lbl != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = (lbl != int(ignore_label)).to(out.dtype).sum()
            grad = grad / torch.maximum(valid, valid.new_ones(()))
        return grad * scale, torch.zeros_like(label), None


@register(name="SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward; its gradient is (p - onehot(label)) scaled, the
    classic fused softmax + cross-entropy gradient."""
    lbl = label if label.dtype.is_floating_point else label.to(torch.float32)
    return _SoftmaxOutput.apply(data, lbl, (
        grad_scale, ignore_label, multi_output, use_ignore, normalization,
        smooth_alpha))


@register(name="softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Cross-entropy summed over the batch."""
    logp = torch.log_softmax(data, dim=-1)
    lbl = label.to(torch.int32).to(torch.int64).reshape(-1)
    return -logp.gather(-1, lbl[:, None]).sum()


# --------------------------------------------------------------- dropout --
@register(name="Dropout", stateful_rng=True)
def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            generator=None, is_train=False):
    """Inverted dropout: kept values scaled by 1 / (1 - p), the mask drawn
    from ``generator``; the identity outside training (unless ``mode``
    is "always"), at p <= 0, or without a generator."""
    if (not is_train and mode != "always") or p <= 0.0 or generator is None:
        return data
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = (torch.rand(shape, generator=generator, device=data.device)
            < keep).to(data.dtype)
    return data * mask / keep
