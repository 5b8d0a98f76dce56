"""Image operators — nd.image.* / sym.image.* (port of
``mxnet_tpu/ops/image_ops.py``).

Reference: src/operator/image/image_random.cc (registers _image_to_tensor,
_image_normalize, flips, brightness/contrast/saturation/hue jitter,
lighting), resize.cc (_image_resize), crop.cc (_image_crop). These back the
Gluon vision transforms so that the transforms stay hybridizable: every op
exists in both the ndarray and symbol namespaces.

Layout follows the reference: to_tensor consumes HWC (or NHWC) input and
produces CHW (NCHW) float32; normalize consumes CHW/NCHW; the others take
HWC or NHWC. Each random op is its draw, from the ``generator`` the
dispatcher passes (the device's ``random.generator`` in ``nd``, the
executor's in a graph), as ``Dropout`` draws, followed by a deterministic
body (``flip_body``, ``brightness_body``, ...), which takes the drawn
value; the JAX package draws with a threefry key instead, so the two
agree on a body given the same draw. ``_image_resize`` computes
``jax.image.resize``'s triangle-kernel weights (antialiased when it
shrinks) as one matrix per axis, in float32, and truncates to an integer
input's dtype as ``astype`` does.
"""

import math

import numpy as np
import torch

from . import register

# ITU-R BT.601 luma weights, (R, G, B)
_LUMA = (0.299, 0.587, 0.114)
_T_YIQ = ((0.299, 0.587, 0.114),
          (0.596, -0.274, -0.321),
          (0.211, -0.523, 0.311))
_T_RGB = ((1.0, 0.956, 0.621),
          (1.0, -0.272, -0.647),
          (1.0, -1.107, 1.705))
# PCA lighting noise over the ImageNet eigen-basis (AlexNet augmentation;
# reference image_random-inl.h AdjustLighting / RandomLighting)
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


def _is_batched(x, rank):
    return x.dim() == rank + 1


def _const(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _uniform(generator, device, lo, hi):
    """One draw from U[lo, hi), a 0-dim float32 tensor on ``device``."""
    u = torch.rand((), generator=generator, device=device)
    return lo + (hi - lo) * u


@register(name="_image_to_tensor", aliases=("image_to_tensor",))
def image_to_tensor(x):
    """HWC (or NHWC) [0,255] -> CHW (NCHW) float32 [0,1]."""
    perm = (0, 3, 1, 2) if _is_batched(x, 3) else (2, 0, 1)
    # a 0-dim divisor: CUDA turns `t / 255.0` into a product with the
    # reciprocal, which rounds otherwise
    return x.permute(perm).to(torch.float32) / torch.tensor(
        255.0, device=x.device)


@register(name="_image_normalize", aliases=("image_normalize",))
def image_normalize(x, mean=0.0, std=1.0):
    """Channel-wise (x - mean) / std on CHW or NCHW float input."""
    mean = _const(mean, x).reshape(-1, 1, 1)
    std = _const(std, x).reshape(-1, 1, 1)
    return (x - mean) / std


@register(name="_image_flip_left_right", aliases=("image_flip_left_right",))
def image_flip_left_right(x):
    """Flip HWC (or NHWC) image along width."""
    return torch.flip(x, (-2,))


@register(name="_image_flip_top_bottom", aliases=("image_flip_top_bottom",))
def image_flip_top_bottom(x):
    return torch.flip(x, (-3,))


def flip_body(x, flip, axis):
    """``x`` flipped along ``axis`` where the 0-dim bool ``flip`` holds."""
    return torch.where(flip, torch.flip(x, (axis,)), x)


def _coin(generator, device):
    return torch.rand((), generator=generator, device=device) < 0.5


@register(name="_image_random_flip_left_right",
          aliases=("image_random_flip_left_right",), stateful_rng=True)
def image_random_flip_left_right(x, generator=None):
    return flip_body(x, _coin(generator, x.device), -2)


@register(name="_image_random_flip_top_bottom",
          aliases=("image_random_flip_top_bottom",), stateful_rng=True)
def image_random_flip_top_bottom(x, generator=None):
    return flip_body(x, _coin(generator, x.device), -3)


def resize_weights(in_size, out_size):
    """The [out_size, in_size] float32 matrix that ``jax.image.resize``'s
    bilinear method applies along one axis: the triangle kernel at the
    sample points (i + 0.5) * in / out - 0.5, widened by in / out when
    shrinking (antialias), each row normalised by its sum, and zero where
    the point lies outside the input. Made on the host in numpy float32,
    the reference's arithmetic step for step (a Python-float scale, its
    inverse rounded to float32, every array op in float32), so every
    device applies the same matrix."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    grid = np.arange(in_size, dtype=f32)
    dist = np.abs(sample[None, :] - grid[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * 2.0 ** -23),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T


def nearest_index(in_size, out_size):
    """The reference's nearest source rows: floor((i + 0.5) * in / out)
    in float32 (numpy's division, correctly rounded as XLA's is)."""
    f32 = np.float32
    pos = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(in_size) \
        / f32(out_size)
    return np.floor(pos).astype(np.int64)


@register(name="_image_resize", aliases=("image_resize",))
def image_resize(x, size=None, keep_ratio=False, interp=1):
    """Resize HWC (or NHWC) to ``size`` (int or (w, h)); bilinear when
    interp=1, nearest when interp=0. keep_ratio scales the short side to
    ``size`` (static-shape variant of the reference's resize_short)."""
    h, w = x.shape[-3], x.shape[-2]
    if isinstance(size, int):
        if keep_ratio:
            if h < w:
                new_h, new_w = size, max(1, int(round(w * size / h)))
            else:
                new_h, new_w = max(1, int(round(h * size / w))), size
        else:
            new_h = new_w = size
    else:
        new_w, new_h = size  # reference order: (w, h)
    out = x.to(torch.float32)
    for axis, n_in, n_out in ((-3, h, new_h), (-2, w, new_w)):
        if n_in == n_out:
            continue
        if interp == 0:
            idx = torch.from_numpy(nearest_index(n_in, n_out))
            out = torch.index_select(out, out.dim() + axis,
                                     idx.to(x.device))
        else:
            # contract H, then W, each axis that changes with its matrix
            mat = torch.from_numpy(resize_weights(n_in, n_out)).to(x.device)
            out = torch.movedim(torch.tensordot(
                out, mat, dims=([out.dim() + axis], [1])), -1, axis)
    if not x.dtype.is_floating_point:
        return out.to(x.dtype)      # truncates, as astype does
    return out


@register(name="_image_crop", aliases=("image_crop",))
def image_crop(x, x0=0, y0=0, width=0, height=0):
    """Static crop of HWC (or NHWC): rows [y0, y0+height), cols
    [x0, x0+width)."""
    if _is_batched(x, 3):
        return x[:, y0:y0 + height, x0:x0 + width, :]
    return x[y0:y0 + height, x0:x0 + width, :]


def _alpha(alpha, x):
    return torch.as_tensor(alpha, dtype=torch.float32, device=x.device)


def _blend(a, b, alpha):
    # a float32 draw promotes a narrower input, as a jnp array does
    a = a.to(torch.promote_types(a.dtype, alpha.dtype))
    return a * alpha + b * (1.0 - alpha)


def _grayscale(x):
    # luma over the channel axis of HWC/NHWC, in x's dtype
    return torch.sum(x * _const(_LUMA, x), dim=-1, keepdim=True)


def brightness_body(x, alpha):
    alpha = _alpha(alpha, x)
    return x.to(torch.promote_types(x.dtype, alpha.dtype)) * alpha


def contrast_body(x, alpha):
    return _blend(x, torch.mean(_grayscale(x)), _alpha(alpha, x))


def saturation_body(x, alpha):
    return _blend(x, _grayscale(x), _alpha(alpha, x))


def hue_body(x, alpha):
    """Hue rotation by ``alpha`` half-turns via the YIQ approximation the
    reference uses (image_random-inl.h RandomHue)."""
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device) * math.pi
    u, w = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -w]),
                       torch.stack([zero, w, u])])
    m = _const(_T_RGB, x) @ rot @ _const(_T_YIQ, x)
    return torch.einsum("...c,dc->...d", x, m)


@register(name="_image_random_brightness",
          aliases=("image_random_brightness",), stateful_rng=True)
def image_random_brightness(x, max_brightness=0.0, generator=None):
    alpha = 1.0 + _uniform(generator, x.device, -max_brightness,
                           max_brightness)
    return brightness_body(x, alpha)


@register(name="_image_random_contrast",
          aliases=("image_random_contrast",), stateful_rng=True)
def image_random_contrast(x, max_contrast=0.0, generator=None):
    alpha = 1.0 + _uniform(generator, x.device, -max_contrast, max_contrast)
    return contrast_body(x, alpha)


@register(name="_image_random_saturation",
          aliases=("image_random_saturation",), stateful_rng=True)
def image_random_saturation(x, max_saturation=0.0, generator=None):
    alpha = 1.0 + _uniform(generator, x.device, -max_saturation,
                           max_saturation)
    return saturation_body(x, alpha)


@register(name="_image_random_hue", aliases=("image_random_hue",),
          stateful_rng=True)
def image_random_hue(x, max_hue=0.0, generator=None):
    return hue_body(x, _uniform(generator, x.device, -max_hue, max_hue))


def color_jitter_draws(generator, device, brightness=0.0, contrast=0.0,
                       saturation=0.0, hue=0.0):
    """The four draws of ``_image_random_color_jitter``: the brightness,
    contrast and saturation alphas (1 + U(-a, a)) and the hue angle
    (U(-hue, hue)), always all four, in that order."""
    return [1.0 + _uniform(generator, device, -brightness, brightness),
            1.0 + _uniform(generator, device, -contrast, contrast),
            1.0 + _uniform(generator, device, -saturation, saturation),
            _uniform(generator, device, -hue, hue)]


def color_jitter_body(x, draws, brightness=0.0, contrast=0.0,
                      saturation=0.0, hue=0.0):
    """The jitters whose strength is nonzero, in the reference's order,
    each with its draw."""
    kb, kc, ks, kh = draws
    if brightness:
        x = brightness_body(x, kb)
    if contrast:
        x = contrast_body(x, kc)
    if saturation:
        x = saturation_body(x, ks)
    if hue:
        x = hue_body(x, kh)
    return x


@register(name="_image_random_color_jitter",
          aliases=("image_random_color_jitter",), stateful_rng=True)
def image_random_color_jitter(x, brightness=0.0, contrast=0.0,
                              saturation=0.0, hue=0.0, generator=None):
    draws = color_jitter_draws(generator, x.device, brightness, contrast,
                               saturation, hue)
    return color_jitter_body(x, draws, brightness, contrast, saturation, hue)


@register(name="_image_adjust_lighting", aliases=("image_adjust_lighting",))
def image_adjust_lighting(x, alpha=(0.0, 0.0, 0.0)):
    val = _const(_EIGVAL, x) * torch.as_tensor(alpha, dtype=x.dtype,
                                               device=x.device)
    return x + _const(_EIGVEC, x) @ val


@register(name="_image_random_lighting",
          aliases=("image_random_lighting",), stateful_rng=True)
def image_random_lighting(x, alpha_std=0.05, generator=None):
    alpha = torch.randn((3,), generator=generator, device=x.device,
                        dtype=x.dtype) * alpha_std
    return image_adjust_lighting(x, alpha)
