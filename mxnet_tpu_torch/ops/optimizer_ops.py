"""Optimizer update operators (port of ``mxnet_tpu/ops/optimizer_ops.py``;
reference: src/operator/optimizer_op.cc and contrib/adamw.cc).

sgd, momentum, NAG, sign, Adam, AdamW (and its multi-precision form),
RMSProp, RMSPropAlex, FTRL, FTML, the fused ``multi_*`` and
``preloaded_multi_*`` SGD families, the ``mp_*`` families, sparse Adagrad
and group Adagrad, as torch ops. None is differentiable, so the
dispatcher runs them without a graph.

State follows the reference's FMutateInputs contract: the state inputs
(mom, mean, var, weight32, ...) are advanced in place by the dispatcher
(``mutate_inputs``), and the op's declared output is the new weight, so
``nd.sgd_mom_update(w, g, mom, out=w, ...)`` leaves both ``w`` and
``mom`` advanced.

Hyperparameters arrive as Python numbers, which keep the weight's dtype
(as JAX's weakly typed scalars do); the preloaded ops' ``lrs``/``wds``
and AdamW's ``rescale_grad`` arrive as fp32 tensors, and a bf16 weight
updated with them is computed in fp32, as JAX promotes it.
"""

import ast

import torch

from . import register


def _rescaled(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


# --------------------------------------------------------------- plain --
@register(name="sgd_update", differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register(name="sgd_mom_update", differentiable=False,
          mutate_inputs=("mom",))
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * (g + wd * weight)
    return weight + mom, mom


@register(name="nag_mom_update", differentiable=False,
          mutate_inputs=("mom",))
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    mom = momentum * mom + g
    return weight - lr * (momentum * mom + g), mom


@register(name="signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register(name="signum_update", differentiable=False,
          mutate_inputs=("mom",))
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    w = weight - lr * torch.sign(-mom)
    if wd_lh > 0:
        w = w - lr * wd_lh * weight
    return w, mom


@register(name="adam_update", differentiable=False,
          mutate_inputs=("mean", "var"))
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    # the reference's order: rescale and decay first, then clip the sum
    g = grad * rescale_grad + wd * weight
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * g
    var = beta2 * var + (1.0 - beta2) * g * g
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def _adamw_math(w32, grad, mean, var, scale, lr, beta1, beta2, epsilon, wd,
                eta, clip_gradient):
    g = grad.to(torch.float32) * scale
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean = beta1 * mean + (1.0 - beta1) * g
    var = beta2 * var + (1.0 - beta2) * g * g
    # decoupled decay, not scaled by lr:
    #   w -= eta * (lr * m / (sqrt(v) + eps) + wd * w)    (adamw.cc:73)
    w32 = w32 - eta * (lr * mean / (torch.sqrt(var) + epsilon) + wd * w32)
    return w32, mean, var


@register(name="_contrib_adamw_update",
          aliases=("_adamw_update", "adamw_update"),
          differentiable=False, mutate_inputs=("mean", "var"))
def adamw_update(weight, grad, mean, var, rescale_grad=None, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay; ``rescale_grad`` arrives as a tensor (the
    AMP loss scale), ``eta`` is the schedule multiplier."""
    scale = rescale_grad if rescale_grad is not None else 1.0
    w, mean, var = _adamw_math(weight, grad, mean, var, scale, lr, beta1,
                               beta2, epsilon, wd, eta, clip_gradient)
    return w.to(weight.dtype), mean, var


@register(name="_contrib_mp_adamw_update", aliases=("_mp_adamw_update",),
          differentiable=False,
          mutate_inputs=("mean", "var", "weight32"))
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=None,
                    lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, clip_gradient=-1.0):
    """The multi-precision AdamW: the fp32 master ``weight32`` carries
    the update; the declared output is its cast to the weight's dtype."""
    scale = rescale_grad if rescale_grad is not None else 1.0
    w32, mean, var = _adamw_math(weight32, grad, mean, var, scale, lr,
                                 beta1, beta2, epsilon, wd, eta,
                                 clip_gradient)
    return w32.to(weight.dtype), mean, var, w32


@register(name="rmsprop_update", differentiable=False,
          mutate_inputs=("n",))
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    n = gamma1 * n + (1.0 - gamma1) * g * g
    w = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n


@register(name="rmspropalex_update", differentiable=False,
          mutate_inputs=("n", "g", "delta"))
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    n = gamma1 * n + (1.0 - gamma1) * gr * gr
    g = gamma1 * g + (1.0 - gamma1) * gr
    delta = gamma2 * delta - lr * gr / torch.sqrt(n - g * g + epsilon)
    w = weight + delta
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n, g, delta


@register(name="ftrl_update", differentiable=False,
          mutate_inputs=("z", "n"))
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
    z = z + g - sigma * weight
    n = n + g * g
    w = torch.where(
        torch.abs(z) > lamda1,
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd),
        torch.zeros((), dtype=z.dtype, device=z.device))
    return w, z, n


@register(name="ftml_update", differentiable=False,
          mutate_inputs=("d", "v", "z"))
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                t=1):
    # the reference's order (FTMLKernel): rescale and decay, then clip
    g = grad * rescale_grad + wd * weight
    if clip_grad is not None and clip_grad >= 0:
        g = torch.clamp(g, -clip_grad, clip_grad)
    v = beta2 * v + (1.0 - beta2) * g * g
    d_t = (1.0 - beta1 ** t) / lr * \
        (torch.sqrt(v / (1.0 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    z = beta1 * z + (1.0 - beta1) * g - sigma * weight
    return -z / d_t, d_t, v, z


# --------------------------------------------- fused multi-weight SGD --
def _promoted(ts, by):
    """``ts`` in the dtype JAX gives them beside the fp32 tensor ``by``."""
    if not isinstance(by, torch.Tensor):
        return ts
    return [t.to(torch.promote_types(t.dtype, by.dtype)) for t in ts]


def _multi_sgd(arrays, num_weights, lrs, wds, momentum, rescale_grad,
               clip_gradient, has_mom):
    """``arrays`` is the reference's interleaved layout [w0, g0, (m0,)?
    w1, g1, (m1,)? ...]; returns the new weights, then the new moms."""
    stride = 3 if has_mom else 2
    assert len(arrays) == stride * num_weights, \
        "expected %d arrays for %d weights" % (stride * num_weights,
                                               num_weights)
    new_weights, new_moms = [], []
    for i in range(num_weights):
        w = arrays[i * stride]
        g = _rescaled(arrays[i * stride + 1], rescale_grad, clip_gradient)
        if has_mom:
            m = momentum * arrays[i * stride + 2]
            w, g, m = _promoted((w, g, m), lrs[i])
            mom = m - lrs[i] * (g + wds[i] * w)
            new_weights.append(w + mom)
            new_moms.append(mom)
        else:
            w, g = _promoted((w, g), lrs[i])
            new_weights.append(w - lrs[i] * (g + wds[i] * w))
    return new_weights + new_moms


def _parse_list(value, n):
    if isinstance(value, str):
        value = ast.literal_eval(value)
    if not isinstance(value, (list, tuple)):
        value = (value,) * n
    return [float(v) for v in value]


@register(name="multi_sgd_update", differentiable=False, num_outputs="n")
def multi_sgd_update(*arrays, lrs=(0.01,), wds=(0.0,), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    return _multi_sgd(list(arrays), num_weights,
                      _parse_list(lrs, num_weights),
                      _parse_list(wds, num_weights),
                      0.0, rescale_grad, clip_gradient, has_mom=False)


def _mom_slots(attrs):
    n = int(attrs.get("num_weights", 1))
    return tuple(3 * i + 2 for i in range(n))


@register(name="multi_sgd_mom_update", differentiable=False,
          num_outputs="n", mutate_inputs=_mom_slots)
def multi_sgd_mom_update(*arrays, lrs=(0.01,), wds=(0.0,), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """The updated weights; the momentum inputs advance in place."""
    return _multi_sgd(list(arrays), num_weights,
                      _parse_list(lrs, num_weights),
                      _parse_list(wds, num_weights),
                      momentum, rescale_grad, clip_gradient, has_mom=True)


@register(name="preloaded_multi_sgd_update", differentiable=False,
          num_outputs="n")
def preloaded_multi_sgd_update(*arrays, rescale_grad=1.0,
                               clip_gradient=-1.0, num_weights=1):
    """``multi_sgd_update`` with lrs and wds as the trailing two tensors
    (the reference preloads them on the device)."""
    lrs, wds = arrays[-2], arrays[-1]
    return _multi_sgd(list(arrays[:-2]), num_weights, lrs, wds, 0.0,
                      rescale_grad, clip_gradient, has_mom=False)


@register(name="preloaded_multi_sgd_mom_update", differentiable=False,
          num_outputs="n", mutate_inputs=_mom_slots)
def preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    lrs, wds = arrays[-2], arrays[-1]
    return _multi_sgd(list(arrays[:-2]), num_weights, lrs, wds, momentum,
                      rescale_grad, clip_gradient, has_mom=True)


# ------------------------------------------------- multi-precision (mp_) --
# The fp32 master ``weight32`` carries the update; the declared output is
# the weight's dtype. weight32 (and mom) advance in place.
def _mp_sgd_math(weight, grad, weight32, lr, wd, rescale_grad, clip_gradient):
    g = _rescaled(grad.to(torch.float32), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


@register(name="mp_sgd_update", differentiable=False,
          mutate_inputs=("weight32",))
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    return _mp_sgd_math(weight, grad, weight32, lr, wd, rescale_grad,
                        clip_gradient)


@register(name="mp_sgd_mom_update", differentiable=False,
          mutate_inputs=("mom", "weight32"))
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _rescaled(grad.to(torch.float32), rescale_grad, clip_gradient)
    mom = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register(name="mp_nag_mom_update", differentiable=False,
          mutate_inputs=("mom", "weight32"))
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad.to(torch.float32), rescale_grad, clip_gradient) \
        + wd * weight32
    mom = momentum * mom + g
    w32 = weight32 - lr * (momentum * mom + g)
    return w32.to(weight.dtype), mom, w32


def _mp_w32_slots(attrs):
    n = int(attrs.get("num_weights", 1))
    return tuple(3 * i + 2 for i in range(n))


@register(name="multi_mp_sgd_update", differentiable=False,
          num_outputs="n", mutate_inputs=_mp_w32_slots)
def multi_mp_sgd_update(*arrays, lrs=(0.01,), wds=(0.0,), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """Interleaved [w0, g0, w32_0, w1, g1, w32_1, ...]."""
    lrs = _parse_list(lrs, num_weights)
    wds = _parse_list(wds, num_weights)
    outs, w32s = [], []
    for i in range(num_weights):
        w, g, w32 = arrays[3 * i], arrays[3 * i + 1], arrays[3 * i + 2]
        lo, hi = _mp_sgd_math(w, g, w32, lrs[i], wds[i], rescale_grad,
                              clip_gradient)
        outs.append(lo)
        w32s.append(hi)
    return outs + w32s


def _mp_mom_slots(attrs):
    n = int(attrs.get("num_weights", 1))
    return tuple(4 * i + j for i in range(n) for j in (2, 3))


@register(name="multi_mp_sgd_mom_update", differentiable=False,
          num_outputs="n", mutate_inputs=_mp_mom_slots)
def multi_mp_sgd_mom_update(*arrays, lrs=(0.01,), wds=(0.0,), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """Interleaved [w0, g0, mom0, w32_0, ...]; mom and w32 advance in
    place."""
    lrs = _parse_list(lrs, num_weights)
    wds = _parse_list(wds, num_weights)
    outs, states = [], []
    for i in range(num_weights):
        w, g, mom, w32 = arrays[4 * i:4 * i + 4]
        gg = _rescaled(g.to(torch.float32), rescale_grad, clip_gradient)
        mom = momentum * mom - lrs[i] * (gg + wds[i] * w32)
        w32 = w32 + mom
        outs.append(w32.to(w.dtype))
        states.extend([mom, w32])
    return outs + states


# ------------------------------------------------------------- adagrad --
@register(name="_sparse_adagrad_update", differentiable=False,
          mutate_inputs=("history",))
def sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """history += g^2; w -= lr * g / sqrt(history + eps). A dense
    gradient touches every row, so the reference's row_sparse laziness
    changes nothing here."""
    if wd:
        # the reference fails fast (optimizer_op-inl.h:2206)
        raise ValueError("sparse adagrad_update does not support wd.")
    g = _rescaled(grad, rescale_grad, clip_gradient)
    history = history + g * g
    return weight - lr * g / torch.sqrt(history + epsilon), history


@register(name="_contrib_group_adagrad_update", differentiable=False,
          mutate_inputs=("history",))
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """One accumulator per row: history_r += mean_j(g_rj^2);
    w_rj -= lr * g_rj / sqrt(history_r + eps)."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    row = g.reshape(g.shape[0], -1)
    history = history + (row * row).mean(dim=1).reshape(history.shape)
    denom = torch.sqrt(history + epsilon).reshape(
        (g.shape[0],) + (1,) * (g.dim() - 1))
    return weight - lr * g / denom, history
