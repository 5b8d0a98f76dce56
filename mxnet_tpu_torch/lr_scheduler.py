"""Learning-rate schedules (port of ``mxnet_tpu/lr_scheduler.py``, a
copy of its plain Python; reference: python/mxnet/lr_scheduler.py).

``LRScheduler`` with linear or constant warmup, and the Factor,
MultiFactor, Poly and Cosine schedules. Each schedule is a closed-form
map ``num_update -> lr``, so it replays from any step. ``Optimizer``
sets ``base_lr`` from its learning rate, so ``base_lr`` stays a public,
writable attribute.
"""

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler(object):
    """Base: warmup ramp for ``num_update < warmup_steps``, then decay."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_steps < 0:
            raise ValueError("warmup_steps cannot be negative")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError(
                "warmup_mode must be 'linear' or 'constant', got %r"
                % (warmup_mode,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr + \
            (self.warmup_final_lr - self.warmup_begin_lr) * frac

    def decay(self, num_update):
        """The post-warmup schedule; subclasses override."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.decay(num_update)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^k, k = completed `step`-sized periods.

    Closed form of the reference's counter loop: period k is entered when
    ``num_update`` exceeds ``k * step``, and the result is floored at
    `stop_factor_lr`.
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be at least 1, got %r" % (step,))
        if factor > 1.0:
            raise ValueError(
                "a decay factor > 1 would grow the lr; got %r" % (factor,))
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def decay(self, num_update):
        periods = max(0, (num_update - 1) // self.step)
        if self.factor == 0.0:
            lr = self.base_lr if periods == 0 else 0.0
        else:
            lr = self.base_lr * self.factor ** periods
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr = base_lr * factor^(milestones passed).

    `step` is a strictly increasing list of update counts; the lr drops by
    `factor` once `num_update` moves past each one.
    """

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        previous = 0
        for milestone in step:
            if milestone < 1:
                raise ValueError(
                    "milestones must be at least 1, got %r" % (milestone,))
            if milestone <= previous and previous:
                raise ValueError("milestones must be strictly increasing")
            previous = milestone
        if factor > 1.0:
            raise ValueError(
                "a decay factor > 1 would grow the lr; got %r" % (factor,))
        self.step = step
        self.factor = factor

    def decay(self, num_update):
        passed = sum(1 for milestone in self.step if num_update > milestone)
        return self.base_lr * self.factor ** passed


class _SpanScheduler(LRScheduler):
    """Decays from base_lr to final_lr over the span after warmup."""

    def __init__(self, max_update, base_lr, final_lr,
                 warmup_steps, warmup_begin_lr, warmup_mode):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError(
                "max_update must be at least 1, got %r" % (max_update,))
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def shape(self, progress):
        """Decay profile on [0, 1] -> [1, 0]; subclasses override."""
        raise NotImplementedError

    def decay(self, num_update):
        progress = (num_update - self.warmup_steps) / float(self.max_steps)
        progress = min(progress, 1.0)
        return self.final_lr + \
            (self.base_lr - self.final_lr) * self.shape(progress)


class PolyScheduler(_SpanScheduler):
    """Polynomial profile (1 - t)^pwr down to final_lr at max_update."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr,
                         warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr

    def shape(self, progress):
        return (1.0 - progress) ** self.power


class CosineScheduler(_SpanScheduler):
    """Half-cosine profile down to final_lr at max_update."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr,
                         warmup_steps, warmup_begin_lr, warmup_mode)

    def shape(self, progress):
        return (1.0 + math.cos(math.pi * progress)) / 2.0
