"""Random sampling operators (port of ``mxnet_tpu/ops/random_ops.py``;
reference: src/operator/random/ — sample_op.cc, multisample_op.cc,
pdf_op.cc).

Every sampler draws from the ``torch.Generator`` it is given (the
per-device generator of ``random.generator``, which ``random.seed``
resets), on the device it is given or its parameters' device. PyTorch's
Philox streams never agree with JAX's threefry keys, so a sampler is held
against the JAX package by its shape, dtype, support and distribution,
never by value; the pdf ops are deterministic and held by value.

Dtypes follow the port's rule: ``float16`` gives bfloat16 and a 64-bit
request its 32-bit type (JAX's ``astype("int64")`` with 64-bit types off
gives int32 too). Floating draws are made in float32 and cast.

The negative binomials are gamma–Poisson mixtures, as in JAX; the pdf
ops are closed forms differentiated by torch.autograd (``torch.lgamma``
for the log-gamma terms).
"""

import math

import torch

from ..base import dtype_name, torch_dtype
from . import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dtype(dtype):
    name = dtype_name(dtype)
    return torch_dtype("bfloat16" if name == "float16" else name)


def _tail(t, n):
    """``t`` with ``n`` trailing unit axes (a parameter tensor against
    its draws)."""
    return t.reshape(tuple(t.shape) + (1,) * n)


def _rand(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (float32)."""
    return torch._standard_gamma(alpha.to(torch.float32), generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam.to(torch.float32), generator=gen)


def _full(value, shape, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


# ------------------------------------------------- scalar-parameter draws --
@register(name="_random_uniform", aliases=("uniform", "random_uniform"),
          differentiable=False, stateful_rng=True)
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                   generator=None, device=None):
    u = _rand(_shape(shape), generator, device)
    return (low + (high - low) * u).to(_dtype(dtype))


@register(name="_random_normal", aliases=("normal", "random_normal"),
          differentiable=False, stateful_rng=True)
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                  generator=None, device=None):
    z = torch.randn(_shape(shape), generator=generator, device=device)
    return (loc + scale * z).to(_dtype(dtype))


@register(name="_random_gamma", aliases=("gamma_sample", "random_gamma"),
          differentiable=False, stateful_rng=True)
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                 generator=None, device=None):
    g = _gamma(_full(alpha, _shape(shape), device), generator)
    return (beta * g).to(_dtype(dtype))


@register(name="_random_exponential",
          aliases=("random_exponential", "exponential"),
          differentiable=False, stateful_rng=True)
def random_exponential(lam=1.0, shape=(), dtype="float32", generator=None,
                       device=None):
    e = torch.empty(_shape(shape), device=device).exponential_(
        1.0, generator=generator)
    return (e / lam).to(_dtype(dtype))


@register(name="_random_poisson", aliases=("random_poisson", "poisson"),
          differentiable=False, stateful_rng=True)
def random_poisson(lam=1.0, shape=(), dtype="float32", generator=None,
                   device=None):
    p = _poisson(_full(lam, _shape(shape), device), generator)
    return p.to(_dtype(dtype))


@register(name="_random_negative_binomial",
          aliases=("random_negative_binomial",),
          differentiable=False, stateful_rng=True)
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                             generator=None, device=None):
    lam = _gamma(_full(k, _shape(shape), device), generator) * (
        (1 - p) / p)
    return _poisson(lam, generator).to(_dtype(dtype))


@register(name="_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",),
          differentiable=False, stateful_rng=True)
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                            generator=None, device=None):
    g = _gamma(_full(1.0 / alpha, _shape(shape), device), generator) * (
        alpha * mu)
    return _poisson(g, generator).to(_dtype(dtype))


@register(name="_random_randint", aliases=("randint",), differentiable=False,
          stateful_rng=True)
def random_randint(low=0, high=1, shape=(), dtype="int32", generator=None,
                   device=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator, device=device,
                         dtype=_dtype(dtype))


@register(name="_sample_multinomial",
          aliases=("sample_multinomial", "multinomial"),
          differentiable=False, stateful_rng=True)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       generator=None):
    """Draws of category indices from the unnormalised probabilities of
    ``data``'s last axis, ``data.shape[:-1] + shape`` of them;
    ``get_prob`` is accepted and ignored, as in JAX."""
    s = _shape(shape)
    n = max(math.prod(s), 1)
    rows = data.reshape(-1, data.shape[-1]).to(torch.float32)
    out = torch.multinomial(rows, n, replacement=True, generator=generator)
    return out.reshape(tuple(data.shape[:-1]) + s).to(_dtype(dtype))


@register(name="_sample_unique_zipfian", differentiable=False,
          stateful_rng=True)
def sample_unique_zipfian(range_max=1, shape=(), generator=None,
                          device=None):
    """Log-uniform (zipfian) candidates, unique within each row
    (sample_op.cc SampleUniqueZipfian): positions holding a value seen
    earlier in the row's sorted order are drawn again, for at most 64
    rounds, as in JAX's bounded loop."""
    shp = _shape(shape)
    n = shp[-1] if shp else 1
    full = tuple(shp[:-1]) + (n,)
    log_range = math.log(range_max + 1.0)

    def draw(size):
        return (torch.exp(_rand(size, generator, device) * log_range)
                - 1.0).to(torch.int32)

    def dup_mask(v):
        sv, order = torch.sort(v, dim=-1, stable=True)
        dups = torch.cat([torch.zeros(sv.shape[:-1] + (1,), dtype=torch.bool,
                                      device=sv.device),
                          sv[..., 1:] == sv[..., :-1]], dim=-1)
        return torch.zeros_like(dups).scatter(-1, order, dups)

    v = draw(full)
    if v.device.type == "meta":
        return v.reshape(shp)
    mask = dup_mask(v)
    for _ in range(64):
        if not bool(mask.any()):
            break
        v = torch.where(mask, draw(full), v)
        mask = dup_mask(v)
    return v.reshape(shp)


# -------------------------------- draws of one set per parameter element --
@register(name="sample_uniform", aliases=("_sample_uniform",),
          differentiable=False, stateful_rng=True)
def sample_uniform(low, high, shape=(), dtype="float32", generator=None):
    s = _shape(shape)
    u = _rand(tuple(low.shape) + s, generator, low.device)
    return (_tail(low, len(s)) + _tail(high - low, len(s)) * u).to(
        _dtype(dtype))


@register(name="sample_normal", aliases=("_sample_normal",),
          differentiable=False, stateful_rng=True)
def sample_normal(mu, sigma, shape=(), dtype="float32", generator=None):
    s = _shape(shape)
    z = torch.randn(tuple(mu.shape) + s, generator=generator,
                    device=mu.device)
    return (_tail(mu, len(s)) + _tail(sigma, len(s)) * z).to(_dtype(dtype))


@register(name="sample_gamma", aliases=("_sample_gamma",),
          differentiable=False, stateful_rng=True)
def sample_gamma(alpha, beta, shape=(), dtype="float32", generator=None):
    s = _shape(shape)
    a = _tail(alpha, len(s)).expand(tuple(alpha.shape) + s)
    return (_gamma(a, generator) * _tail(beta, len(s))).to(_dtype(dtype))


@register(name="sample_exponential", aliases=("_sample_exponential",),
          differentiable=False, stateful_rng=True)
def sample_exponential(lam, shape=(), dtype="float32", generator=None):
    s = _shape(shape)
    e = torch.empty(tuple(lam.shape) + s, device=lam.device).exponential_(
        1.0, generator=generator)
    return (e / _tail(lam, len(s))).to(_dtype(dtype))


@register(name="sample_poisson", aliases=("_sample_poisson",),
          differentiable=False, stateful_rng=True)
def sample_poisson(lam, shape=(), dtype="float32", generator=None):
    s = _shape(shape)
    rates = _tail(lam, len(s)).expand(tuple(lam.shape) + s)
    return _poisson(rates, generator).to(_dtype(dtype))


@register(name="sample_negative_binomial",
          aliases=("_sample_negative_binomial",),
          differentiable=False, stateful_rng=True)
def sample_negative_binomial(k, p, shape=(), dtype="float32",
                             generator=None):
    s = _shape(shape)
    kk = _tail(k, len(s)).expand(tuple(k.shape) + s)
    pp = _tail(p, len(s)).to(torch.float32)
    lam = _gamma(kk, generator) * ((1 - pp) / pp)
    return _poisson(lam, generator).to(_dtype(dtype))


@register(name="sample_generalized_negative_binomial",
          aliases=("_sample_generalized_negative_binomial",),
          differentiable=False, stateful_rng=True)
def sample_gen_negative_binomial(mu, alpha, shape=(), dtype="float32",
                                 generator=None):
    s = _shape(shape)
    m = _tail(mu, len(s)).to(torch.float32)
    a = _tail(alpha, len(s)).to(torch.float32)
    g = _gamma((1.0 / a).expand(tuple(mu.shape) + s), generator) * (a * m)
    return _poisson(g, generator).to(_dtype(dtype))


# --------------------------------------------------------------- pdf ops --
# Reference: src/operator/random/pdf_op.{cc,h}: the per-sample (log-)density
# under a leading batch of distribution parameters. Parameter tensors have
# shape (s...); a sample may add a trailing draws axis (s..., m).
def _pbc(parm, sample):
    """A parameter tensor against the sample's trailing draw axis."""
    return parm[..., None] if sample.dim() > parm.dim() else parm


@register(name="_random_pdf_uniform", aliases=("pdf_uniform",))
def pdf_uniform(sample, low, high, is_log=False):
    low, high = _pbc(low, sample), _pbc(high, sample)
    inside = (sample >= low) & (sample <= high)
    out = torch.where(inside, 1.0 / (high - low),
                      torch.zeros((), dtype=sample.dtype,
                                  device=sample.device))
    return torch.log(out) if is_log else out


@register(name="_random_pdf_normal", aliases=("pdf_normal",))
def pdf_normal(sample, mu, sigma, is_log=False):
    mu, sigma = _pbc(mu, sample), _pbc(sigma, sample)
    logp = -0.5 * torch.square((sample - mu) / sigma) - torch.log(
        sigma * math.sqrt(2 * math.pi))
    return logp if is_log else torch.exp(logp)


@register(name="_random_pdf_gamma", aliases=("pdf_gamma",))
def pdf_gamma(sample, alpha, beta, is_log=False):
    a, b = _pbc(alpha, sample), _pbc(beta, sample)
    logp = a * torch.log(b) + (a - 1) * torch.log(sample) - b * sample \
        - torch.lgamma(a)
    return logp if is_log else torch.exp(logp)


@register(name="_random_pdf_exponential", aliases=("pdf_exponential",))
def pdf_exponential(sample, lam, is_log=False):
    lam = _pbc(lam, sample)
    logp = torch.log(lam) - lam * sample
    return logp if is_log else torch.exp(logp)


@register(name="_random_pdf_poisson", aliases=("pdf_poisson",))
def pdf_poisson(sample, lam, is_log=False):
    lam = _pbc(lam, sample)
    logp = sample * torch.log(lam) - lam - torch.lgamma(sample + 1)
    return logp if is_log else torch.exp(logp)


def _negbin_logpdf(x, limit, prob):
    """lgamma(x+l) - lgamma(x+1) - lgamma(l) + l*log(p) + x*log(1-p); ``prob``
    is the failure probability, as in the reference kernel."""
    lg = torch.lgamma
    return (lg(x + limit) - lg(x + 1) - lg(limit)
            + limit * torch.log(prob) + x * torch.log(1 - prob))


@register(name="_random_pdf_negative_binomial",
          aliases=("pdf_negative_binomial",))
def pdf_negative_binomial(sample, k, p, is_log=False):
    logp = _negbin_logpdf(sample, _pbc(k, sample), _pbc(p, sample))
    return logp if is_log else torch.exp(logp)


@register(name="_random_pdf_generalized_negative_binomial",
          aliases=("pdf_generalized_negative_binomial",))
def pdf_gen_negative_binomial(sample, mu, alpha, is_log=False):
    mu, alpha = _pbc(mu, sample), _pbc(alpha, sample)
    logp = _negbin_logpdf(sample, 1.0 / alpha, 1.0 / (mu * alpha + 1.0))
    return logp if is_log else torch.exp(logp)


@register(name="_random_pdf_dirichlet", aliases=("pdf_dirichlet",))
def pdf_dirichlet(sample, alpha, is_log=False):
    """alpha: (s..., k); sample: (s..., [m,] k): the density over the
    last axis."""
    a = alpha[..., None, :] if sample.dim() > alpha.dim() else alpha
    logp = torch.sum((a - 1) * torch.log(sample), dim=-1) \
        + torch.lgamma(torch.sum(a, dim=-1)) - torch.sum(torch.lgamma(a),
                                                          dim=-1)
    return logp if is_log else torch.exp(logp)
