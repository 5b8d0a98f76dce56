"""Optimizers (port of ``mxnet_tpu/optimizer.py``; reference:
python/mxnet/optimizer/optimizer.py).

``Optimizer`` with its registry, the update rules SGD, NAG, Signum, FTML,
DCASGD, LBSGD, SGLD, Adam, AdaGrad, AdaDelta, RMSProp, Ftrl, Adamax,
Nadam, Test and ccSGD, and ``Updater``/``get_updater``. Each rule is torch
arithmetic on the NDArrays' tensors, run without a graph.

The reference's dtypes are kept:

  * the rules that the reference jit-compiles with fp32 scalars
    (``_flt``: SGD, NAG, LBSGD and Adam) compute in fp32, so a bf16
    weight without ``multi_precision`` is updated in fp32 and written
    back in bf16, and its momentum state, made bf16, comes back fp32
    after the first step; the other rules take Python scalars and keep
    the weight's dtype;
  * ``multi_precision`` keeps an fp32 master for bf16 weights only.

A weight is written in place (``_assign``: its tensor, a Parameter's
leaf, keeps its identity); states are rebound to new tensors. The TPU
placement helpers of the reference (``_align_update_devices``) have no
counterpart, nor has its row-sparse path: sparse storage (``sparse.py``)
waits for ROADMAP A9, so every gradient is dense.
SGLD draws its noise from the device's generator (``random.generator``).
"""

import math
import pickle

import torch

from . import ndarray as nd
from . import random as _random

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "FTML", "DCASGD", "LBSGD",
           "SGLD", "Adam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "Adamax", "Nadam", "Test", "Updater", "get_updater", "create",
           "register"]

_OPT_REGISTRY = {}


def register(klass):
    """Optimizer.register decorator (optimizer.py:93)."""
    name = klass.__name__.lower()
    _OPT_REGISTRY[name] = klass
    return klass


def create(name, **kwargs):
    """mx.optimizer.create (optimizer.py:139)."""
    if name.lower() not in _OPT_REGISTRY:
        raise ValueError("Cannot find optimizer %s" % name)
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _f32(t):
    """``t`` as JAX computes it beside an fp32 scalar array: bf16 is
    promoted to fp32."""
    return t if t.dtype == torch.float32 else \
        t.to(torch.promote_types(t.dtype, torch.float32))


def _assign(arr, value):
    """Write ``value`` into ``arr``'s own tensor, in ``arr``'s dtype."""
    with torch.no_grad():
        arr._own_buffer().copy_(value)


class Optimizer(object):
    """Base optimizer (optimizer.py:48): lr/wd multipliers resolved per
    param index, gradient rescale + clip, update-count tracking for
    schedulers and bias correction."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        assert param_idx2name is None or isinstance(param_idx2name, dict)
        self.__dict__.update(
            rescale_grad=rescale_grad, lr=learning_rate,
            lr_scheduler=lr_scheduler, wd=wd,
            begin_num_update=begin_num_update,
            num_update=begin_num_update, _index_update_count={},
            clip_gradient=clip_gradient,
            multi_precision=multi_precision, aggregate_num=0,
            idx2name=dict(param_idx2name or {}),
            sym_info=(sym.attr_dict(), sym.list_arguments())
            if sym is not None else (),
            param_dict=param_dict or {})
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)
    opt_registry = _OPT_REGISTRY

    @staticmethod
    def register(klass):
        return register(klass)

    def _take(self, **hyper):
        """Bind rule hyperparameters as attributes in one shot."""
        self.__dict__.update(hyper)

    # ------------------------------------------------------------ state --
    def create_state(self, index, weight):
        return None

    def _zeros_like(self, weight, dtype=None):
        """A fresh state buffer shaped and placed like the weight."""
        return nd.zeros(weight.shape, weight.context,
                        dtype=dtype or weight._data.dtype)

    def create_state_multi_precision(self, index, weight):
        """An fp32 master copy for bf16 weights (optimizer.py:278)."""
        if self.multi_precision and weight._data.dtype == torch.bfloat16:
            master = weight.astype("float32")
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """One step: advance the index's step count, resolve the
        scheduled and multiplied hyperparameters, and apply the
        subclass's ``_apply_rule``. A subclass may override ``update``
        whole (the reference's extension contract)."""
        self._update_count(index)
        self._apply_rule(self._index_update_count[index],
                         self._get_lr(index), self._get_wd(index),
                         weight, grad, state)

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight._data.dtype == torch.bfloat16:
            weight_master_copy, original_state = state
            grad32 = grad.astype("float32")
            self.update(index, weight_master_copy, grad32, original_state)
            _assign(weight, weight_master_copy._data)
        else:
            # the weight keeps its dtype: a rule computing in fp32 writes
            # a bf16 weight back in bf16
            wdtype = weight._data.dtype
            self.update(index, weight, grad, state)
            if weight._data.dtype != wdtype:
                weight._set_data(weight._data.detach().to(wdtype))

    # -------------------------------------------------------- lr/wd mult --
    @property
    def learning_rate(self):
        """Current base lr (optimizer.py learning_rate property)."""
        return self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined; setting lr directly would "
                              "be overridden at the next update")
        self.lr = lr

    def _sym_multipliers(self, attr_key):
        """Per-name multipliers declared as symbol attributes
        (``__lr_mult__`` / ``__wd_mult__``) when the optimizer was built
        from a Symbol."""
        if not self.sym_info:
            return {}
        attrs, arg_names = self.sym_info
        found = ((name, attrs.get(name, {}).get(attr_key))
                 for name in arg_names)
        return {name: float(mult) for name, mult in found
                if mult is not None}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_multipliers("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # decay applies to weights and BN gammas; every other named
        # param (bias, beta, moving stats) defaults to no decay
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_multipliers("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        indices = index if isinstance(index, (list, tuple)) else (index,)
        for idx in indices:
            seen = self._index_update_count.get(idx,
                                                self.begin_num_update) + 1
            self._index_update_count[idx] = seen
            if seen > self.num_update:
                self.num_update = seen

    def _scaled_hyper(self, indices, base, which):
        """``base`` scaled by each param's multiplier. Precedence: the
        Parameter object's own mult (param_dict), then an explicit
        per-index entry, then the index's resolved name in the mult
        table; absent everywhere = 1."""
        table = getattr(self, which + "_mult")
        out = []
        for index in indices:
            if index in self.param_dict:
                mult = getattr(self.param_dict[index], which + "_mult")
            elif index in table:
                mult = table[index]
            else:
                mult = table.get(self.idx2name.get(index), 1.0)
            out.append(base * mult)
        return out

    def _get_lrs(self, indices):
        base = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return self._scaled_hyper(indices, base, "lr")

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        return self._scaled_hyper(indices, self.wd, "wd")

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def _preprocess_grad(self, grad):
        g = grad._data.detach() * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


# --------------------------------------------------------------- rules ---
# The reference's jit-compiled rules, which take lr, wd and the betas as
# fp32 scalar arrays: they compute in fp32.

def _sgd_update(w, g, lr, wd):
    w, g = _f32(w), _f32(g)
    return w - lr * (g + wd * w)


def _sgd_mom_update(w, g, mom, lr, wd, momentum):
    w, g, mom = _f32(w), _f32(g), _f32(mom)
    mom = momentum * mom - lr * (g + wd * w)
    return w + mom, mom


def _nag_mom_update(w, g, mom, lr, wd, momentum):
    w, g, mom = _f32(w), _f32(g), _f32(mom)
    g = g + wd * w
    mom = momentum * mom + g
    return w - lr * (momentum * mom + g), mom


def _adam_update(w, g, m, v, lr, wd, beta1, beta2, eps):
    w, g, m, v = _f32(w), _f32(g), _f32(m), _f32(v)
    g = g + wd * w
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    return w - lr * m / (torch.sqrt(v) + eps), m, v


def _w(arr):
    return arr._data.detach()


@register
class SGD(Optimizer):
    """SGD with momentum and optional multi-precision (optimizer.py:479;
    kernels sgd_update/sgd_mom_update). ``lazy_update`` applies only to
    row_sparse gradients, so it changes nothing here."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self._take(momentum=momentum, lazy_update=lazy_update)

    def create_state(self, index, weight):
        return self._zeros_like(weight) if self.momentum else None

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        if state is not None:
            new_w, new_mom = _sgd_mom_update(_w(weight), g, state._data,
                                             lr, wd, self.momentum)
            state._set_data(new_mom)
            _assign(weight, new_w)
        else:
            _assign(weight, _sgd_update(_w(weight), g, lr, wd))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (optimizer.py:1137)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self._take(momentum=momentum)

    def create_state(self, index, weight):
        return self._zeros_like(weight) if self.momentum else None

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        if state is not None:
            new_w, new_mom = _nag_mom_update(_w(weight), g, state._data,
                                             lr, wd, self.momentum)
            state._set_data(new_mom)
            _assign(weight, new_w)
        else:
            _assign(weight, _sgd_update(_w(weight), g, lr, wd))


@register
class Signum(Optimizer):
    """signSGD / Signum (optimizer.py:699): steps by the sign of the
    (momentum) gradient."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(momentum=momentum, wd_lh=wd_lh)

    def create_state(self, index, weight):
        return self._zeros_like(weight) if self.momentum else None

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        w = _w(weight)
        if state is not None:
            mom = self.momentum * state._data - \
                (1 - self.momentum) * (g + wd * w)
            _assign(weight, (1 - lr * self.wd_lh) * w + lr * torch.sign(mom))
            state._set_data(mom)
        else:
            _assign(weight, (1 - lr * (self.wd_lh + wd)) * w
                    - lr * torch.sign(g))


@register
class FTML(Optimizer):
    """Follow the Moving Leader (optimizer.py:636)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self._take(beta1=beta1, beta2=beta2, epsilon=epsilon)

    def create_state(self, index, weight):
        return (self._zeros_like(weight),     # prev_d
                self._zeros_like(weight),     # prev_v
                self._zeros_like(weight))     # prev_z

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        prev_d, prev_v, prev_z = state
        v = self.beta2 * prev_v._data + (1 - self.beta2) * g * g
        d = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(v / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d - self.beta1 * prev_d._data
        z = self.beta1 * prev_z._data + (1 - self.beta1) * g - sigma * w
        _assign(weight, -z / d)
        prev_d._set_data(d)
        prev_v._set_data(v)
        prev_z._set_data(z)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (optimizer.py:769)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self._take(momentum=momentum, lamda=lamda, weight_previous={})

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (self._zeros_like(weight), weight.copy())

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        w = _w(weight)
        mon, previous_weight = state
        comp = g + wd * w + self.lamda * g * g * (w - previous_weight._data)
        if mon is not None:
            mon._set_data(self.momentum * mon._data - lr * comp)
            delta = mon._data
        else:
            delta = -lr * comp
        previous_weight._set_data(w.clone())
        _assign(weight, w + delta)


@register
class LBSGD(Optimizer):
    """Large-batch SGD with a LARS-style layer-wise adaptive rate
    (optimizer.py:860): the warmup strategies reduce to 'linear'; the
    adaptive ratio is ||w|| / ||g||, as in the reference."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self._take(momentum=momentum, warmup_strategy=warmup_strategy,
                   warmup_epochs=warmup_epochs, batch_scale=batch_scale,
                   updates_per_epoch=updates_per_epoch,
                   init_updates=begin_epoch * updates_per_epoch,
                   num_epochs=num_epochs,
                   adaptive=warmup_strategy.startswith("lars"))

    def create_state(self, index, weight):
        return self._zeros_like(weight) if self.momentum else None

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        w = _w(weight)
        if self.adaptive:
            wnorm = torch.linalg.vector_norm(w)
            gnorm = torch.linalg.vector_norm(g)
            ratio = torch.where(gnorm > 0,
                                wnorm / (gnorm + wd * wnorm + 1e-9),
                                torch.ones((), dtype=wnorm.dtype,
                                           device=wnorm.device))
            lr = _f32(lr * torch.clamp(ratio, 0.0, 10.0))
        if state is not None:
            new_w, new_mom = _sgd_mom_update(w, g, state._data, lr, wd,
                                             self.momentum)
            state._set_data(new_mom)
            _assign(weight, new_w)
        else:
            _assign(weight, _sgd_update(w, g, lr, wd))


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (optimizer.py:1599)."""

    def _noise(self, weight, lr):
        """N(0, lr) fp32 noise shaped like ``weight``, from the device's
        generator."""
        dev = weight._data.device
        return torch.randn(weight.shape, generator=_random.generator(dev),
                           device=dev) * math.sqrt(lr)

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        w = _w(weight)
        noise = self._noise(weight, lr)
        _assign(weight, w - lr / 2 * (g + wd * w) + noise.to(w.dtype))


@register
class Adam(Optimizer):
    """Adam (optimizer.py:1181; kernel adam_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(beta1=beta1, beta2=beta2, epsilon=epsilon,
                   lazy_update=lazy_update)

    def create_state(self, index, weight):
        return (self._zeros_like(weight), self._zeros_like(weight))

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        g = self._preprocess_grad(grad)
        mean, var = state
        new_w, new_m, new_v = _adam_update(
            _w(weight), g, mean._data, var._data, lr, wd, self.beta1,
            self.beta2, self.epsilon)
        mean._set_data(new_m)
        var._set_data(new_v)
        _assign(weight, new_w)


@register
class AdaGrad(Optimizer):
    """AdaGrad (optimizer.py:1369)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self._take(float_stable_eps=eps)

    def create_state(self, index, weight):
        return self._zeros_like(weight)

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        state._set_data(state._data + g * g)
        _assign(weight, w - lr * g / (torch.sqrt(state._data)
                                      + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """AdaDelta (optimizer.py:1467)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self._take(rho=rho, epsilon=epsilon)

    def create_state(self, index, weight):
        return (self._zeros_like(weight), self._zeros_like(weight))

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        acc_g, acc_delta = state
        acc_g._set_data(self.rho * acc_g._data + (1. - self.rho) * g * g)
        delta = torch.sqrt(acc_delta._data + self.epsilon) / \
            torch.sqrt(acc_g._data + self.epsilon) * g
        acc_delta._set_data(self.rho * acc_delta._data
                            + (1. - self.rho) * delta * delta)
        _assign(weight, w - delta)


@register
class RMSProp(Optimizer):
    """RMSProp, non-centered (Hinton) and centered (Graves)
    (optimizer.py:1270)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(gamma1=gamma1, gamma2=gamma2, centered=centered,
                   epsilon=epsilon, clip_weights=clip_weights)

    def create_state(self, index, weight):
        if self.centered:
            return (self._zeros_like(weight), self._zeros_like(weight),
                    self._zeros_like(weight))
        return (self._zeros_like(weight),)

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        if self.centered:
            n, gmean, delta = state
            n._set_data((1 - self.gamma1) * g * g + self.gamma1 * n._data)
            gmean._set_data((1 - self.gamma1) * g
                            + self.gamma1 * gmean._data)
            delta._set_data(self.gamma2 * delta._data - lr * g / torch.sqrt(
                n._data - gmean._data * gmean._data + self.epsilon))
            w = w + delta._data
        else:
            (n,) = state
            n._set_data((1 - self.gamma1) * g * g + self.gamma1 * n._data)
            w = w - lr * g / torch.sqrt(n._data + self.epsilon)
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        _assign(weight, w)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (optimizer.py:1518)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(lamda1=lamda1, beta=beta)

    def create_state(self, index, weight):
        return (self._zeros_like(weight),  # z
                self._zeros_like(weight))  # n

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        g = self._preprocess_grad(grad)
        w = _w(weight)
        z, n = state
        sigma = (torch.sqrt(n._data + g * g) - torch.sqrt(n._data)) / lr
        z._set_data(z._data + g - sigma * w)
        n._set_data(n._data + g * g)
        _assign(weight, torch.where(
            torch.abs(z._data) <= self.lamda1, torch.zeros_like(w),
            -(z._data - torch.sign(z._data) * self.lamda1) /
            ((self.beta + torch.sqrt(n._data)) / lr + wd)))


@register
class Adamax(Optimizer):
    """AdaMax (optimizer.py:1613)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(beta1=beta1, beta2=beta2)

    def create_state(self, index, weight):
        return (self._zeros_like(weight), self._zeros_like(weight))

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        lr /= (1. - self.beta1 ** t)
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        m_t, u_t = state
        m_t._set_data(self.beta1 * m_t._data + (1. - self.beta1) * g)
        u_t._set_data(torch.maximum(self.beta2 * u_t._data, torch.abs(g)))
        _assign(weight, w - lr * m_t._data / (u_t._data + 1e-12))


@register
class Nadam(Optimizer):
    """Nesterov Adam (optimizer.py:1660)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self._take(beta1=beta1, beta2=beta2, epsilon=epsilon,
                   schedule_decay=schedule_decay, m_schedule=1.)

    def create_state(self, index, weight):
        return (self._zeros_like(weight), self._zeros_like(weight))

    def _apply_rule(self, t, lr, wd, weight, grad, state):
        w = _w(weight)
        g = self._preprocess_grad(grad) + wd * w
        momentum_t = self.beta1 * (1. - 0.5 * (
            pow(0.96, t * self.schedule_decay)))
        momentum_t_1 = self.beta1 * (1. - 0.5 * (
            pow(0.96, (t + 1) * self.schedule_decay)))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t._set_data(self.beta1 * m_t._data + (1. - self.beta1) * g)
        v_t._set_data(self.beta2 * v_t._data + (1. - self.beta2) * g * g)
        grad_prime = g / (1. - self.m_schedule)
        m_t_prime = m_t._data / (1. - m_schedule_next)
        v_t_prime = v_t._data / (1. - pow(self.beta2, t))
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        _assign(weight, w - lr * m_t_bar / (torch.sqrt(v_t_prime)
                                            + self.epsilon))


@register
class Test(Optimizer):
    """Test optimizer that stores the weight in its state
    (optimizer.py:437)."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        _assign(weight, _w(weight) + grad._data.detach() * self.rescale_grad)
        state._set_data(_w(weight).clone())


# ccSGD, the deprecated alias of SGD in MXNet 1.x
_OPT_REGISTRY["ccsgd"] = SGD


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples
    (optimizer.py get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        batched = isinstance(index, (list, tuple))
        triples = zip(index, grad, weight) if batched \
            else ((index, grad, weight),)
        for i, g, w in triples:
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
                self.states_synced[i] = True
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        payload = (self.states, self.optimizer) if dump_optimizer \
            else self.states
        return pickle.dumps(payload)

    def set_states(self, states):
        loaded = pickle.loads(states)
        # two wire formats: the bare state dict, or (states, optimizer)
        # when the sender dumped its optimizer too
        if isinstance(loaded, tuple) and len(loaded) == 2:
            self.states, self.optimizer = loaded
        else:
            self.states = loaded
        self.states_synced = {i: False for i in self.states}


def get_updater(optimizer):
    """mx.optimizer.get_updater (optimizer.py end)."""
    return Updater(optimizer)


@register
class ccSGD(SGD):
    """The deprecated reference alias of SGD (optimizer.py ccSGD)."""
