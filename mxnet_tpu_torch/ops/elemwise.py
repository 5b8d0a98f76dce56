"""Elementwise unary/binary operators (port of ``mxnet_tpu/ops/elemwise.py``).

Each op is one torch function, or a few. Where torch's gradient at a
tie or a kink differs from JAX's, the op computes JAX's:

  * ``abs`` at 0 has gradient 1 (JAX: ``select(x >= 0, g, -g)``);
  * ``maximum``/``minimum`` (and ``relu``, ``clip``, ``hard_sigmoid``,
    which JAX builds from them) give each side half the gradient at a
    tie (``_Extremum``).

``mod`` is floor-mod with the sign of the divisor, computed as JAX does
(``fmod``, then the divisor added where the signs differ); ``round`` is
half-to-even (``torch.round``).
"""

import torch

from ..base import torch_dtype
from . import register


def _check_same_shape(a, b, name):
    if a.shape != b.shape:
        raise ValueError("%s requires identical shapes, got %s vs %s"
                         % (name, tuple(a.shape), tuple(b.shape)))


def _sum_to(grad, shape):
    """Reduce a broadcast gradient back to ``shape``."""
    if tuple(grad.shape) == tuple(shape):
        return grad
    lead = grad.dim() - len(shape)
    grad = grad.sum(dim=tuple(range(lead))) if lead else grad
    dims = tuple(i for i, s in enumerate(shape) if s == 1
                 and grad.shape[i] != 1)
    return grad.sum(dim=dims, keepdim=True) if dims else grad


class _Extremum(torch.autograd.Function):
    """maximum/minimum with JAX's gradient: each side takes the cotangent
    where it wins and half of it at a tie."""

    @staticmethod
    def forward(ctx, a, b, is_max):
        ctx.save_for_backward(a, b)
        ctx.is_max = is_max
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        wins = (a > b) if ctx.is_max else (a < b)
        share = torch.where(a == b, 0.5, wins.to(g.dtype)).to(g.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(g * share, a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _sum_to(g * (1 - share), b.shape).to(b.dtype)
        return ga, gb, None


def _scalar_like(x, scalar):
    """A 0-dim tensor for a Python scalar operand: it takes part in type
    promotion as JAX's weakly typed scalar does."""
    return torch.as_tensor(scalar, device=x.device)


def _promote(a, b):
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def maximum(a, b):
    a, b = _promote(a, b)
    if a.dtype.is_floating_point and torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad):
        return _Extremum.apply(a, b, True)
    return torch.maximum(a, b)


def minimum(a, b):
    a, b = _promote(a, b)
    if a.dtype.is_floating_point and torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad):
        return _Extremum.apply(a, b, False)
    return torch.minimum(a, b)


class _Abs(torch.autograd.Function):
    """abs with JAX's gradient: +g where x >= 0 (so 1 at 0), -g else."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    if x.dtype.is_floating_point and torch.is_grad_enabled() \
            and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


def _mod(a, b):
    """Floor-mod with the divisor's sign (jnp.mod); an integer mod by
    zero is 0, as in JAX (torch would raise)."""
    b = b if isinstance(b, torch.Tensor) else _scalar_like(a, b)
    zero = None
    if not (a.dtype.is_floating_point or b.dtype.is_floating_point):
        zero = b == 0
        b = torch.where(zero, torch.ones_like(b), b)
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    r = torch.where(fix, r + b, r)
    return r if zero is None else torch.where(zero, torch.zeros_like(r), r)


def _float(x):
    """x itself if it is a float tensor, else as float32: the ops JAX
    computes in floating point promote integers so."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


def _hypot(a, b):
    return torch.hypot(*_promote(_float(a), _float(b)))


def _cmp(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _clip(x, lo, hi):
    if lo is not None:
        x = maximum(x, _scalar_like(x, lo))
    if hi is not None:
        x = minimum(x, _scalar_like(x, hi))
    return x


# ---------------------------------------------------------------- binary --
def _binary(name, fn):
    @register(name=name)
    def _op(lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    return _op


for _n, _f in [
    ("broadcast_add", torch.add), ("broadcast_sub", torch.sub),
    ("broadcast_mul", torch.mul), ("broadcast_div", torch.div),
    ("broadcast_mod", _mod), ("broadcast_power", torch.pow),
    ("broadcast_maximum", maximum), ("broadcast_minimum", minimum),
    ("broadcast_hypot", _hypot),
    ("broadcast_equal", _cmp(torch.eq)),
    ("broadcast_not_equal", _cmp(torch.ne)),
    ("broadcast_greater", _cmp(torch.gt)),
    ("broadcast_greater_equal", _cmp(torch.ge)),
    ("broadcast_lesser", _cmp(torch.lt)),
    ("broadcast_lesser_equal", _cmp(torch.le)),
    ("broadcast_logical_and",
     lambda a, b: torch.logical_and(a != 0, b != 0).to(a.dtype)),
    ("broadcast_logical_or",
     lambda a, b: torch.logical_or(a != 0, b != 0).to(a.dtype)),
    ("broadcast_logical_xor",
     lambda a, b: torch.logical_xor(a != 0, b != 0).to(a.dtype)),
]:
    _binary(_n, _f)

# elemwise_* versions: strict same shape
for _n, _f in [
    ("elemwise_add", torch.add), ("elemwise_sub", torch.sub),
    ("elemwise_mul", torch.mul), ("elemwise_div", torch.div),
]:
    def _mk(n=_n, f=_f):
        @register(name=n, aliases=("_" + n.split("_")[1],))
        def _op(lhs, rhs):
            _check_same_shape(lhs, rhs, n)
            return f(lhs, rhs)
    _mk()


# ---------------------------------------------------------------- scalar --
# The scalar operand is a static attr.
for _n, _f in [
    ("_plus_scalar", lambda x, s: x + s),
    ("_minus_scalar", lambda x, s: x - s),
    ("_rminus_scalar", lambda x, s: s - x),
    ("_mul_scalar", lambda x, s: x * s),
    ("_div_scalar", lambda x, s: x / s),
    ("_rdiv_scalar", lambda x, s: s / x),
    ("_mod_scalar", lambda x, s: _mod(x, s)),
    ("_rmod_scalar", lambda x, s: _mod(_scalar_like(x, s), x)),
    ("_power_scalar", lambda x, s: torch.pow(x, s)),
    ("_rpower_scalar", lambda x, s: torch.pow(s, x)),
    ("_maximum_scalar", lambda x, s: maximum(x, _scalar_like(x, s))),
    ("_minimum_scalar", lambda x, s: minimum(x, _scalar_like(x, s))),
    ("_equal_scalar", lambda x, s: (x == s).to(x.dtype)),
    ("_not_equal_scalar", lambda x, s: (x != s).to(x.dtype)),
    ("_greater_scalar", lambda x, s: (x > s).to(x.dtype)),
    ("_greater_equal_scalar", lambda x, s: (x >= s).to(x.dtype)),
    ("_lesser_scalar", lambda x, s: (x < s).to(x.dtype)),
    ("_lesser_equal_scalar", lambda x, s: (x <= s).to(x.dtype)),
    ("_hypot_scalar",
     lambda x, s: _hypot(x, torch.as_tensor(s, dtype=x.dtype,
                                            device=x.device))),
]:
    def _mks(n=_n, f=_f):
        @register(name=n)
        def _op(data, scalar=0.0):
            return f(data, scalar)
    _mks()


# ----------------------------------------------------------------- unary --
def _cbrt(x):
    return torch.sign(x) * _abs(x).pow(1.0 / 3.0)


def _softrelu(x):
    # log(1+exp(x)), numerically stable (mshadow_op.h softrelu)
    x = _float(x)
    return torch.logaddexp(x, torch.zeros_like(x))


_UNARY = [
    ("negative", torch.neg), ("reciprocal", torch.reciprocal),
    ("abs", _abs), ("sign", torch.sign),
    ("round", torch.round), ("rint", lambda x: torch.round(_float(x))),
    ("ceil", torch.ceil),
    ("floor", torch.floor), ("trunc", torch.trunc), ("fix", torch.trunc),
    ("square", torch.square), ("sqrt", torch.sqrt),
    ("rsqrt", torch.rsqrt), ("cbrt", _cbrt),
    ("rcbrt", lambda x: 1.0 / _cbrt(x)),
    ("exp", torch.exp), ("log", torch.log), ("log10", torch.log10),
    ("log2", torch.log2), ("log1p", torch.log1p), ("expm1", torch.expm1),
    ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
    ("arcsin", torch.asin), ("arccos", torch.acos), ("arctan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
    ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
    ("arctanh", torch.atanh),
    ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
    ("erf", torch.erf), ("erfinv", torch.erfinv),
    ("gamma", lambda x: torch.exp(torch.lgamma(x))),
    ("gammaln", torch.lgamma),
    ("sigmoid", torch.sigmoid),
    ("hard_sigmoid",
     lambda x, alpha=0.2, beta=0.5: _clip(alpha * x + beta, 0.0, 1.0)),
    ("relu", lambda x: maximum(x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))),
    ("softsign", lambda x: x / (1 + _abs(x))),
    ("logical_not", lambda x: (x == 0).to(x.dtype)),
    ("isfinite", lambda x: torch.isfinite(x).to(torch.float32)),
    ("isnan", lambda x: torch.isnan(x).to(torch.float32)),
    ("isinf", lambda x: torch.isinf(x).to(torch.float32)),
]

for _n, _f in _UNARY:
    def _mku(n=_n, f=_f):
        @register(name=n)
        def _op(data, **kw):
            return f(data, **kw) if kw else f(data)
    _mku()


@register(name="smooth_l1")
def smooth_l1(data, scalar=1.0):
    """f(x) = 0.5 (sx)^2 for |x| < 1/s^2, |x| - 0.5/s^2 otherwise."""
    sigma2 = scalar * scalar
    a = _abs(data)
    return torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * data * data,
                       a - 0.5 / sigma2)


@register(name="softrelu")
def softrelu(data):
    return _softrelu(data)


@register(name="clip")
def clip(data, a_min=0.0, a_max=1.0):
    """matrix_op.cc clip: minimum(maximum(x, a_min), a_max), as jnp.clip."""
    return _clip(data, a_min, a_max)


@register(name="_copy", aliases=("identity", "stop_gradient_identity"))
def _copy(data):
    return data


@register(name="BlockGrad", aliases=("stop_gradient",), differentiable=False)
def block_grad(data):
    return data.detach()


@register(name="make_loss")
def make_loss(data, grad_scale=1.0):
    """Identity forward, ``grad_scale`` times the cotangent backward."""
    if grad_scale == 1.0:
        return data
    return data * grad_scale - (data * (grad_scale - 1.0)).detach()


@register(name="Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register(name="amp_cast")
def amp_cast(data, dtype="float16"):
    """AMP narrowing cast; float16 requests map to bfloat16, as in the
    JAX package."""
    return data.to(torch.bfloat16 if str(dtype) == "float16"
                   else torch_dtype(dtype))


@register(name="amp_multicast", num_outputs="n")
def amp_multicast(*data, num_outputs=1):
    widest = data[0].dtype
    for d in data[1:]:
        widest = torch.promote_types(widest, d.dtype)
    return tuple(d.to(widest) for d in data)


@register(name="add_n", aliases=("ElementWiseSum",))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
