"""Neural-network operators (port of ``mxnet_tpu/ops/nn.py``): the whole
module. ``Convolution``, ``Deconvolution``, ``Pooling``,
``FullyConnected``, ``BatchNorm`` (alias ``BatchNorm_v1``) and
``_contrib_SyncBatchNorm``, ``LayerNorm``, ``GroupNorm``,
``InstanceNorm``, ``LRN``, ``Activation``, ``LeakyReLU``, the softmax
family (``softmax``, ``log_softmax``, ``softmin``, ``SoftmaxActivation``,
``SoftmaxOutput`` with its alias ``Softmax``, ``softmax_cross_entropy``),
``Dropout``, the regression and SVM outputs,
``IdentityAttachKLSparseReg``, ``SpatialTransformer``, ``ROIPooling``,
``CTCLoss`` (alias ``ctc_loss``) and the fused ``RNN``.

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
    head gradient, and so are the regression, SVM and KL-sparsity
    outputs' own backward functions (``torch.autograd.Function``);
  * the layer, group and instance norms use the biased variance and
    ``rsqrt(var + eps)``; ``LeakyReLU``'s gelu is the exact erf form.

The TPU memory levers of the reference (``MXNET_INT8_RESIDUAL``,
``MXNET_POOL_INDEX_RESIDUAL``, and the switches of the bf16 BN residual
and of the relu mask) are not ported: their defaults are the behaviour.
The random ops (``Dropout``, rrelu, ``RNN``'s inter-layer dropout) draw
from the ``generator`` they are given (the device's
``random.generator`` in ``nd``, the executor's in a graph).
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


# -------------------------------------------------------- deconvolution --
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register(name="Deconvolution")
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=1, num_group=1,
                  no_bias=True, layout=None, workspace=1024, cudnn_tune=None,
                  cudnn_off=False):
    """Transposed convolution, NC[DHW] data and (C_in, C_out / groups,
    *kernel) weights, as torch's. A ``target_shape`` replaces pad and adj
    by the reference's derivation (deconvolution-inl.h InferPad): the
    zero-pad output stride*(in-1) + dilated kernel must reach the target,
    and the excess splits into pad = ceil(excess/2), adj = excess % 2.
    ``adj`` pads the high side; where torch's output_padding cannot take
    it (not below stride or dilation), the full output is cropped."""
    nd = data.dim() - 2
    stride = _tuplize(stride, nd)
    dilate = _tuplize(dilate, nd)
    pad = _tuplize(pad if pad != () else 0, nd)
    adj = _tuplize(adj if adj != () else 0, nd)
    kshape = weight.shape[2:]
    if target_shape not in ((), None) and any(target_shape):
        target_shape = _tuplize(target_shape, nd)
        pad, adj = [], []
        for i in range(nd):
            k = (kshape[i] - 1) * dilate[i] + 1
            natural = (data.shape[2 + i] - 1) * stride[i] + k
            if int(target_shape[i]) > natural:
                raise ValueError(
                    "too big target shape: target_shape[%d]=%d exceeds "
                    "the zero-pad output %d (= stride*(in-1) + "
                    "dilated_kernel)" % (i, target_shape[i], natural))
            excess = natural - int(target_shape[i])
            adj.append(excess % 2)
            pad.append((excess + 1) // 2)
        pad, adj = tuple(pad), tuple(adj)
    b = None if no_bias else bias
    if all(a < max(s, d) and p >= 0
           for a, s, d, p in zip(adj, stride, dilate, pad)):
        return _CONV_T[nd](data, weight, b, stride, pad, adj, num_group,
                           dilate)
    full = _CONV_T[nd](data, weight, b, stride, 0, 0, num_group, dilate)
    flat = []
    for i in reversed(range(nd)):
        # output [pad, natural - pad + adj): crop low, crop or zero-pad high
        flat += [-pad[i], adj[i] - pad[i]]
    return F.pad(full, flat)


# ------------------------------------------------------------ norms --
class _WorldSum(torch.autograd.Function):
    """Sum over the ranks of the world, forward and backward: a value
    that each rank's loss reads after the sum owes every rank's input
    the sum of the cotangents (the global batch's gradient)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out)
        return out


@register(name="_contrib_SyncBatchNorm", num_outputs=3)
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    output_mean_var=False, ndev=1, key="", is_train=False):
    """BatchNorm whose training statistics are the global batch's: over a
    ``torch.distributed`` world of more than one rank (each holding its
    part of the batch, on its own device) the shifted sums that
    ``batch_norm`` accumulates in fp32, with their counts, are
    all-reduced over the world, and their backward all-reduces the
    cotangents, so the gradients are the global batch's too (the JAX
    package gets the same from GSPMD's psum over the data-parallel
    axis). The ``(out, batch_mean, batch_var)`` contract is BatchNorm's;
    on a world of one the op is ``batch_norm``. ``ndev`` and ``key`` are
    accepted for signature parity."""
    from ..parallel import device_count
    world = device_count()
    if not (is_train and not use_global_stats) or world == 1:
        return batch_norm(
            data, gamma, beta, moving_mean, moving_var, eps=eps,
            momentum=momentum, fix_gamma=fix_gamma,
            use_global_stats=use_global_stats,
            output_mean_var=output_mean_var, is_train=is_train)
    red = tuple(i for i in range(data.dim()) if i != 1)
    shape = [1] * data.dim()
    shape[1] = data.shape[1]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    acc = torch.promote_types(data.dtype, torch.float32)
    shift = moving_mean.detach().to(acc).reshape(shape)
    if data.dtype == torch.bfloat16:
        centered = data - shift.to(data.dtype)
    else:
        centered = data.to(acc) - shift
    count = data.numel() // data.shape[1]
    local = torch.stack([centered.sum(dim=red, dtype=acc),
                         (centered * centered).sum(dim=red, dtype=acc)])
    sums = _WorldSum.apply(local)
    n = float(count * world)
    mean_c = sums[0] / n
    var = sums[1] / n - mean_c * mean_c
    var = torch.maximum(var, var.new_zeros(()))
    mean = (mean_c + shift.reshape(-1)).to(moving_mean.dtype)
    var = var.to(moving_var.dtype)
    inv = torch.rsqrt(var.to(acc) + eps)
    g_acc = g.to(acc)
    scale = (g_acc * inv).to(data.dtype)
    bias = (beta.to(acc) - g_acc * mean.to(acc) * inv).to(data.dtype)
    out = data * scale.reshape(shape) + bias.reshape(shape)
    return out.to(data.dtype), mean, var


def _normalized(x, red, eps):
    """(x - mean) * rsqrt(var + eps) over ``red``, the variance biased."""
    mean = x.mean(dim=red, keepdim=True)
    var = ((x - mean) * (x - mean)).mean(dim=red, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


@register(name="LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    ax = axis % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    return _normalized(data, ax, eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


@register(name="GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
               output_mean_var=False):
    """NC... input, the statistics over each group of channels and the
    spatial axes."""
    n, c = data.shape[:2]
    rest = tuple(data.shape[2:])
    x = data.reshape((n, num_groups, c // num_groups) + rest)
    xhat = _normalized(x, tuple(range(2, x.dim())), eps).reshape(data.shape)
    shape = (1, c) + (1,) * len(rest)
    return xhat * gamma.reshape(shape) + beta.reshape(shape)


@register(name="InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    shape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return _normalized(data, tuple(range(2, data.dim())), eps) * \
        gamma.reshape(shape) + beta.reshape(shape)


@register(name="LRN")
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Cross-channel local response norm: the window sum over channels
    as shifted slices of the zero-padded squares."""
    sq = data * data
    half = nsize // 2
    padded = F.pad(sq, [0, 0] * (data.dim() - 2) + [half, half])
    c = data.shape[1]
    s = None
    for off in range(nsize):
        piece = padded[:, off:off + c]
        s = piece if s is None else s + piece
    return data / torch.pow(knorm + alpha / nsize * s, beta)


# ----------------------------------------------------------- leaky relu --
_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register(name="LeakyReLU", stateful_rng=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, generator=None,
               is_train=False):
    """leaky, prelu, elu, selu, gelu (the exact erf form) and rrelu: in
    training rrelu's slopes are drawn uniformly from [lower_bound,
    upper_bound) with ``generator``; otherwise it takes their mean."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim():
            shape = [1] * data.dim()
            if g.numel() > 1 and data.dim() > 1:
                shape[1] = g.numel()
            g = g.reshape(shape)
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(pos, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        if is_train and generator is not None:
            r = lower_bound + (upper_bound - lower_bound) * torch.rand(
                data.shape, generator=generator, device=data.device,
                dtype=torch.float32).to(data.dtype)
        else:
            r = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, r * data)
    raise ValueError("unknown act_type %s" % act_type)


# ------------------------------------- outputs with their own backward --
class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``bwd(data, label) * grad_scale /
    outputs per sample``, whatever the head gradient; zeros for the
    label (regression_output-inl.h:201-207)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return torch.sigmoid(data) if kind == "logistic" else data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        lbl = label.reshape(data.shape)
        if ctx.kind == "linear":
            grad = data - lbl
        elif ctx.kind == "mae":
            grad = torch.sign(data - lbl)
        else:
            grad = torch.sigmoid(data) - lbl
        num_output = data.numel() // data.shape[0] if data.dim() else 1
        return (grad * (ctx.grad_scale / num_output),
                torch.zeros_like(label), None, None)


@register(name="LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward (data - label) scaled."""
    return _RegressionOutput.apply(data, label, "linear", grad_scale)


@register(name="MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward sign(data - label) scaled."""
    return _RegressionOutput.apply(data, label, "mae", grad_scale)


@register(name="LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    """Sigmoid forward; backward (sigmoid(data) - label) scaled."""
    return _RegressionOutput.apply(data, label, "logistic", grad_scale)


class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the multiclass hinge gradient (L2-SVM,
    or L1 with ``use_linear``), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.cfg
        lab = label.reshape(-1).to(torch.int64)
        x_y = data.gather(1, lab[:, None])
        z = margin - x_y + data                  # (N, C); margin at y
        onehot = F.one_hot(lab, data.shape[1]).to(data.dtype)
        if use_linear:
            viol = ((z > 0) & (onehot == 0)).to(data.dtype)
        else:
            viol = torch.where(onehot == 0, 2.0 * torch.clamp(z, min=0.0),
                               torch.zeros((), dtype=data.dtype,
                                           device=data.device))
        grad = reg_coef * (viol - onehot * viol.sum(dim=1, keepdim=True))
        return grad, torch.zeros_like(label), None, None, None


@register(name="SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the gradient of KL(rho || rho_hat)
    toward ``sparseness_target``, rho_hat the batch mean of each unit
    (the reference's momentum-smoothed state is not kept)."""

    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.cfg = (sparseness_target, penalty)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        t, penalty = ctx.cfg
        rho_hat = torch.clamp(data.mean(dim=0, keepdim=True), 1e-6,
                              1.0 - 1e-6)
        kl_grad = penalty * (-t / rho_hat + (1.0 - t) / (1.0 - rho_hat))
        return g + kl_grad * torch.ones_like(data) / data.shape[0], None, None


@register(name="IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


# ------------------------------------------------ spatial transformer --
@register(name="SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """GridGenerator (affine) then BilinearSampler."""
    from .matrix import bilinear_sampler, grid_generator
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


@register(name="ROIPooling")
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max over each ROI's grid cells. The corners are rounded (half to
    even); cell (py, px) covers rows [floor(y1 + py*bh), ceil(y1 +
    (py+1)*bh)) and likewise columns; an empty cell gives 0. Ties share
    the gradient, as a max reduction's do."""
    n, c, h, w = data.shape
    ph, pw = pooled_size
    scaled = torch.round(rois[:, 1:5] * spatial_scale)
    x1, y1, x2, y2 = (scaled[:, i].reshape(-1, 1, 1, 1, 1)
                      for i in range(4))
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    dev = data.device
    # a tensor divisor: CUDA turns ``x / python_number`` into a product
    # with the reciprocal, which moves a cell's edge across an integer
    bh = rh / torch.tensor(float(ph), device=dev)
    bw = rw / torch.tensor(float(pw), device=dev)
    ys = torch.arange(h, device=dev).reshape(1, 1, 1, h, 1)
    xs = torch.arange(w, device=dev).reshape(1, 1, 1, 1, w)
    py = torch.arange(ph, device=dev).reshape(1, ph, 1, 1, 1)
    px = torch.arange(pw, device=dev).reshape(1, 1, pw, 1, 1)
    mask = ((ys >= torch.floor(y1 + py * bh))
            & (ys < torch.ceil(y1 + (py + 1) * bh))
            & (xs >= torch.floor(x1 + px * bw))
            & (xs < torch.ceil(x1 + (px + 1) * bw)))     # (R, ph, pw, h, w)
    img = data[rois[:, 0].to(torch.int64)]             # (R, C, h, w)
    masked = torch.where(mask[:, None], img[:, :, None, None],
                         torch.full((), float("-inf"), dtype=data.dtype,
                                    device=dev))
    pooled = masked.amax(dim=(4, 5))
    return torch.where(torch.isfinite(pooled), pooled,
                       torch.zeros((), dtype=data.dtype, device=dev))


# ------------------------------------------------------------- ctc loss --
_NINF = -1e30


def _logsumexp_masked(parts):
    """log(sum(exp(parts))) where the largest part is above -1e30, else
    -1e30 (the reference's logsumexp3). Where every part is -1e30 the sum
    is taken as 1 inside the log, so that no 0/0 reaches the gradient:
    the reference's takes log(0) there, and its gradient is NaN on every
    frame that holds such a lattice position (ROADMAP §C)."""
    m = parts[0]
    for p in parts[1:]:
        m = torch.maximum(m, p)
    dead = m == _NINF
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = None
    for p in parts:
        e = torch.exp(p - m_safe)
        s = e if s is None else s + e
    s = torch.where(dead, torch.ones_like(s), s)
    return torch.where(dead, torch.full_like(m, _NINF), m_safe + torch.log(s))


@register(name="CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC's forward algorithm in log space, -1e30 for minus infinity,
    over (seq, batch, alphabet) activations and (batch, L) labels. A
    label counts where it is not the blank and is >= 0, unless
    ``label_lengths`` is given; the gradient comes by autograd through
    the recursion."""
    seq_len, batch, alphabet = data.shape
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    blank = 0 if blank_label == "first" else alphabet - 1
    lab = label.to(torch.int32).to(torch.int64)
    L = lab.shape[1]
    ext_len = 2 * L + 1
    dev = data.device
    ext = torch.full((batch, ext_len), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    if use_label_lengths and label_lengths is not None:
        lab_lens = label_lengths.to(torch.int64)
    else:
        lab_lens = ((lab != blank) & (lab >= 0)).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        dat_lens = data_lengths.to(torch.int64)
    else:
        dat_lens = torch.full((batch,), seq_len, dtype=torch.int64,
                              device=dev)
    # a negative label wraps, as numpy's take does; past the alphabet the
    # emission is NaN (JAX's fill); neither is read at a label's end
    idx = torch.where(ext < 0, ext + alphabet, ext)
    inside = (idx >= 0) & (idx < alphabet)
    emit = logp.gather(2, idx.clamp(0, alphabet - 1)[None].expand(
        seq_len, batch, ext_len))
    emit = torch.where(inside[None], emit,
                       torch.full((), float("nan"), device=dev))
    same = torch.cat([torch.zeros((batch, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    ninf1 = torch.full((batch, 1), _NINF, device=dev)
    ninf2 = torch.full((batch, 2), _NINF, device=dev)
    alpha = torch.cat([
        emit[0, :, :1],
        torch.where(lab_lens[:, None] > 0, emit[0, :, 1:2], ninf1),
        torch.full((batch, ext_len - 2), _NINF, device=dev)], dim=1)
    for t in range(1, seq_len):
        shift1 = torch.cat([ninf1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(same, torch.full_like(alpha, _NINF),
                             torch.cat([ninf2, alpha[:, :-2]], dim=1))
        new = _logsumexp_masked((alpha, shift1, shift2)) + emit[t]
        alpha = torch.where((t < dat_lens)[:, None], new, alpha)
    a1 = alpha.gather(1, (2 * lab_lens)[:, None])[:, 0]
    a2 = alpha.gather(1, torch.clamp(2 * lab_lens - 1, min=0)[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    m_safe = torch.where(m == _NINF, torch.zeros_like(m), m)
    ll = m_safe + torch.log(torch.exp(a1 - m_safe) + torch.exp(a2 - m_safe))
    return (-ll).to(data.dtype)


# ------------------------------------------------------------------ rnn --
def _gates(mode):
    return {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}[mode]


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Length of the fused RNN's flat parameter vector."""
    ng = _gates(mode)
    d = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * d
        total += d * ng * state_size * (isz + state_size + 2)
    return total


def _unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                       bidirectional):
    """MXNet's flat RNN parameter vector (rnn-inl.h): every layer's and
    direction's (W_x, W_h) first, layer-major, then every (b_x, b_h)."""
    ng = _gates(mode)
    d = 2 if bidirectional else 1
    ws, bs = [], []
    off = 0

    def take(n, shape):
        nonlocal off
        piece = params[off:off + n].reshape(shape)
        off += n
        return piece

    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * d
        for _ in range(d):
            wx = take(ng * state_size * isz, (ng * state_size, isz))
            wh = take(ng * state_size * state_size,
                      (ng * state_size, state_size))
            ws.append((wx, wh))
    for layer in range(num_layers):
        for _ in range(d):
            bx = take(ng * state_size, (ng * state_size,))
            bh = take(ng * state_size, (ng * state_size,))
            bs.append((bx, bh))
    return ws, bs


def _rnn_direction(xs, h, c, wx, wh, bx, bh, mode):
    """One direction of one layer over time: (outputs, h_T, c_T). The
    input projection of every step is one matmul; gates in the
    reference's order (lstm i, f, g, o; gru r, z, n)."""
    proj = torch.matmul(xs, wx.t()) + bx              # (T, B, ng * H)
    ys = []
    for t in range(xs.shape[0]):
        hp = torch.matmul(h, wh.t()) + bh
        if mode == "lstm":
            i, f, g, o = torch.chunk(proj[t] + hp, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            xr, xz, xn = torch.chunk(proj[t], 3, dim=-1)
            hr, hz, hn = torch.chunk(hp, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            pre = proj[t] + hp
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        ys.append(h)
    return torch.stack(ys, dim=0), h, c


@register(name="RNN", num_outputs="n", stateful_rng=True)
def rnn(data, parameters, state=None, state_cell=None, state_size=1,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, sequence_length=None, generator=None,
        is_train=False):
    """The fused multi-layer (bidirectional) rnn_relu / rnn_tanh / lstm /
    gru over (seq, batch, input) data, a Python loop over time with torch
    matmuls. Omitted initial states are zeros. In training, dropout of
    rate ``p`` between layers draws its masks from ``generator``.
    Returns (out, h_n) and for lstm (out, h_n, c_n)."""
    seq_len, batch, input_size = data.shape
    d = 2 if bidirectional else 1
    ws, bs = _unpack_rnn_params(parameters, mode, num_layers, input_size,
                                state_size, bidirectional)
    if state is None:
        state = data.new_zeros((num_layers * d, batch, state_size))
    c0 = state_cell if mode == "lstm" else None
    if mode == "lstm" and c0 is None:
        c0 = torch.zeros_like(state)
    x = data
    h_last, c_last = [], []
    for layer in range(num_layers):
        outs = []
        for dr in range(d):
            li = layer * d + dr
            xs = torch.flip(x, dims=(0,)) if dr == 1 else x
            ys, h_t, c_t = _rnn_direction(
                xs, state[li], c0[li] if c0 is not None else None,
                *ws[li], *bs[li], mode)
            h_last.append(h_t)
            c_last.append(c_t)
            outs.append(torch.flip(ys, dims=(0,)) if dr == 1 else ys)
        x = torch.cat(outs, dim=-1) if d == 2 else outs[0]
        if p > 0.0 and is_train and layer < num_layers - 1 \
                and generator is not None:
            keep = (torch.rand(x.shape, generator=generator,
                               device=x.device) < 1.0 - p).to(x.dtype)
            x = x * keep / (1.0 - p)
    h_n = torch.stack(h_last, dim=0)
    if mode == "lstm":
        return x, h_n, torch.stack(c_last, dim=0)
    return x, h_n
