"""Evaluation metrics with device-side batch statistics (port of
``mxnet_tpu/metric.py``; reference: python/mxnet/metric.py): the
EvalMetric hierarchy, the registry, CompositeEvalMetric, every concrete
metric and the ``np`` factory.

Each concrete metric declares a *stat kernel*: torch arithmetic mapping
one (label, pred) batch to a few sufficient statistics, run on the
prediction's device. Its scalars come to the host in one fetch a batch
(one ``tolist`` of their stack, in float64, which holds an fp32 value or
an integer count exactly), where the JAX package jit-compiles the same
arithmetic and fetches each scalar with ``float``. Host-side state is the
running reduction of those statistics. CustomMetric and PCC run on the
host, as there.
"""

import math

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *aliases):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    for a in aliases:
        _METRIC_REGISTRY[a.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """mx.metric.create — resolve str / callable / list / instance."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for child in metric:
            out.add(create(child, *args, **kwargs))
        return out
    if isinstance(metric, str):
        klass = _METRIC_REGISTRY.get(metric.lower())
        if klass is None:
            raise ValueError(
                "metric %r is not registered and not callable" % metric)
        return klass(*args, **kwargs)
    raise TypeError("metric should be callable, str, EvalMetric or list")


def _on_device(x, device=None):
    """One update() argument as a tensor, on ``device`` when given."""
    t = x._data.detach() if isinstance(x, NDArray) \
        else torch.as_tensor(_np.asarray(x))
    return t if device is None else t.to(device)


def _fetch(stats):
    """The stat kernel's scalars on the host, in one transfer."""
    dev = next((v.device for v in stats if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        return [float(v) for v in stats]
    return torch.stack([torch.as_tensor(v, device=dev).to(torch.float64)
                        .reshape(()) for v in stats]).tolist()


def _to_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise when label/pred lists (or shapes, with shape=True) disagree."""
    a = labels.shape if shape else len(labels)
    b = preds.shape if shape else len(preds)
    if a != b:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(a, b))
    if wrap:
        if isinstance(labels, (NDArray, _np.ndarray)):
            labels = [labels]
        if isinstance(preds, (NDArray, _np.ndarray)):
            preds = [preds]
    return labels, preds


class EvalMetric(object):
    """Base metric: running (sum_metric, num_inst) with local+global views."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = kwargs.pop("has_global_stats", False)
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self._has_global_stats:
            if self.global_num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.global_sum_metric / self.global_num_inst)
        return self.get()

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        if self._has_global_stats:
            name, value = self.get_global()
            if not isinstance(name, list):
                name = [name]
            if not isinstance(value, list):
                value = [value]
            return list(zip(name, value))
        return self.get_name_value()

    def _inc(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


class CompositeEvalMetric(EvalMetric):
    """Fans update() out to children; get() concatenates their results."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            raise ValueError("Metric index {} is out of range 0 and {}"
                             .format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {k: v for k, v in labels.items() if k in self.label_names}
        if self.output_names is not None:
            preds = {k: v for k, v in preds.items() if k in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def reset_local(self):
        for metric in getattr(self, "metrics", []):
            metric.reset_local()

    def _gather(self, getter):
        names, values = [], []
        for metric in self.metrics:
            name, value = getter(metric)
            names.extend([name] if isinstance(name, str) else name)
            values.extend(
                [value] if isinstance(value, (float, int, _np.generic))
                else value)
        return names, values

    def get(self):
        return self._gather(lambda m: m.get())

    def get_global(self):
        return self._gather(lambda m: m.get_global())

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [m.get_config() for m in self.metrics]})
        return config


class _KernelMetric(EvalMetric):
    """A metric driven by a device-side stat kernel.

    Subclasses implement `batch_stats(label, pred) -> tuple of scalars`
    in torch; `update` runs it on the prediction's device and folds the
    fetched scalars into host accumulators via `accumulate`.
    """

    def _stats(self, label, pred):
        pred = _on_device(pred)
        return _fetch(self.batch_stats(_on_device(label, pred.device), pred))

    def batch_stats(self, label, pred):
        raise NotImplementedError()

    def check_shapes(self, label, pred):
        """Host-side shape validation before the kernel; override to add."""

    def accumulate(self, stats):
        # default: stats == (metric_sum, instance_count)
        s, n = stats
        self._inc(float(s), int(n))

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.check_shapes(label, pred)
            self.accumulate(self._stats(label, pred))


@register
class Accuracy(_KernelMetric):
    """Fraction of rows whose argmax (along `axis`) equals the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        self.axis = axis
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def check_shapes(self, label, pred):
        pred_shape = tuple(pred.shape)
        if len(pred_shape) > len(tuple(label.shape)):
            axis = self.axis % len(pred_shape)
            pred_shape = pred_shape[:axis] + pred_shape[axis + 1:]
        if int(_np.prod(pred_shape)) != int(_np.prod(label.shape)):
            raise ValueError(
                "Shape of labels {} does not match shape of predictions {}"
                .format(tuple(label.shape), tuple(pred.shape)))

    def batch_stats(self, label, pred):
        if pred.dim() > label.dim():
            pred = torch.argmax(pred, dim=self.axis)
        label = label.reshape(-1).to(torch.int32)
        pred = pred.reshape(-1).to(torch.int32)
        return torch.sum(pred == label), label.numel()


@register
class TopKAccuracy(_KernelMetric):
    """Label appears among the k largest scores (ties to the lower
    index, as lax.top_k orders them)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        self.top_k = top_k
        assert top_k > 1, "Please use Accuracy if top_k is no more than 1"
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.name += "_%d" % top_k

    def batch_stats(self, label, pred):
        if pred.dim() == 1:
            # reference parity: a 1-D pred is ranked (argsort) and the
            # resulting ordering indices are compared against the label
            ranked = torch.argsort(pred, stable=True).to(torch.int32)
            hit = ranked == label.to(torch.int32)
            return torch.sum(hit), label.numel()
        assert pred.dim() == 2, "Predictions should be no more than 2 dims"
        k = min(self.top_k, pred.shape[1])
        # the label is among lax.top_k's k when fewer than k scores rank
        # before it: the larger ones, and the equal ones at a lower index
        # (torch.topk orders ties differently on each device)
        label = label.reshape(-1, 1).to(torch.int64)
        mine = torch.gather(pred, 1, label)
        cols = torch.arange(pred.shape[1], device=pred.device)
        before = (pred > mine) | ((pred == mine) & (cols < label))
        return torch.sum(before.sum(dim=1) < k), pred.shape[0]


class _ConfusionMetric(_KernelMetric):
    """Shared machinery for binary-confusion metrics (F1, MCC).

    The kernel reduces a batch to the 4 confusion counts on device; the
    derived score is computed on host from the running counts.  `average`
    follows the reference: 'macro' re-derives the score per batch and
    averages; anything else ('micro') scores the pooled counts.
    """

    def __init__(self, name, average, output_names=None, label_names=None):
        self.average = average
        self._counts = _np.zeros(4)   # tp, fp, fn, tn
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def batch_stats(self, label, pred):
        if pred.dim() > 1:
            hard = torch.argmax(pred, dim=1)
        else:
            hard = (pred > 0.5).to(torch.int32)
        hard = hard.reshape(-1).to(torch.bool)
        truth = label.reshape(-1).to(torch.bool)
        tp = torch.sum(hard & truth)
        fp = torch.sum(hard & ~truth)
        fn = torch.sum(~hard & truth)
        tn = torch.sum(~hard & ~truth)
        return tp, fp, fn, tn

    def score(self, tp, fp, fn, tn):
        raise NotImplementedError()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            lbl = _to_numpy(label)
            if len(_np.unique(lbl.astype("int32"))) > 2:
                raise ValueError(
                    "%s currently only supports binary classification."
                    % self.__class__.__name__)
            self._counts += _np.array(self._stats(lbl, pred))
        if self.average == "macro":
            self.sum_metric += self.score(*self._counts)
            self.global_sum_metric += self.score(*self._counts)
            self.num_inst += 1
            self.global_num_inst += 1
            self._counts[:] = 0
        else:
            total = self._counts.sum()
            self.sum_metric = self.score(*self._counts) * total
            self.global_sum_metric = self.sum_metric
            self.num_inst = total
            self.global_num_inst = total

    def reset(self):
        super().reset()
        if hasattr(self, "_counts"):
            self._counts[:] = 0

    def reset_local(self):
        self.reset()


@register
class F1(_ConfusionMetric):
    """Harmonic mean of precision and recall over binary predictions."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, average, output_names, label_names)

    def score(self, tp, fp, fn, tn):
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)


@register
class MCC(_ConfusionMetric):
    """Matthews correlation coefficient from the confusion counts."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, average, output_names, label_names)

    def score(self, tp, fp, fn, tn):
        if tp + fp + fn + tn == 0:
            return 0.0
        denom = 1.0
        for term in (tp + fp, tp + fn, tn + fp, tn + fn):
            if term != 0.0:
                denom *= term
        return (tp * tn - fp * fn) / math.sqrt(denom)


@register
class Perplexity(_KernelMetric):
    """exp(mean NLL of the prob the model assigns to the label)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        self.ignore_label = ignore_label
        self.axis = axis
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)

    def batch_stats(self, label, pred):
        flat = label.reshape(-1).to(torch.int64)
        probs = torch.gather(pred.reshape(-1, pred.shape[-1]), -1,
                             flat[:, None])[:, 0].to(torch.float32)
        count = flat.numel()
        if self.ignore_label is not None:
            keep = flat != self.ignore_label
            probs = torch.where(keep, probs, probs.new_ones(()))
            count = torch.sum(keep)
        nll = -torch.sum(torch.log(torch.clamp(probs, min=1e-10)))
        return nll, count

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name,
                math.exp(self.global_sum_metric / self.global_num_inst))


class _RegressionMetric(_KernelMetric):
    """Per-batch mean of an elementwise error; num_inst counts batches."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def elem_error(self, diff):
        raise NotImplementedError()

    def finalize(self, mean_err):
        return mean_err

    def batch_stats(self, label, pred):
        label = label.reshape(label.shape[0], -1).to(torch.float32)
        pred = pred.reshape(pred.shape[0], -1).to(torch.float32)
        return (torch.mean(self.elem_error(label - pred)), 1)

    def accumulate(self, stats):
        self._inc(self.finalize(stats[0]), 1)


@register
class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def elem_error(self, diff):
        return torch.abs(diff)


@register
class MSE(_RegressionMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def elem_error(self, diff):
        return diff * diff


@register
class RMSE(_RegressionMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def elem_error(self, diff):
        return diff * diff

    def finalize(self, mean_err):
        return math.sqrt(mean_err)


class _LabelProbMetric(_KernelMetric):
    """Sum of -log(prob at the true label) over rows."""

    def __init__(self, eps, name, output_names=None, label_names=None):
        self.eps = eps
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def batch_stats(self, label, pred):
        flat = label.reshape(-1).to(torch.int64)
        probs = torch.gather(pred, -1, flat[:, None])[:, 0]
        nll = -torch.sum(torch.log(probs.to(torch.float32) + self.eps))
        return nll, flat.numel()


@register
class CrossEntropy(_LabelProbMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class NegativeLogLikelihood(_LabelProbMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class PearsonCorrelation(_KernelMetric):
    """Pearson r between flattened label and pred (one torch.corrcoef)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def batch_stats(self, label, pred):
        assert label.shape == pred.shape, (label.shape, pred.shape)
        x = pred.reshape(-1).to(torch.float32)
        y = label.reshape(-1).to(torch.float32)
        return torch.corrcoef(torch.stack([x, y]))[0, 1], 1

    def accumulate(self, stats):
        self._inc(float(stats[0]), 1)


@register
class Loss(_KernelMetric):
    """Running mean of a loss output (no labels involved)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            self._inc(_fetch([torch.sum(_on_device(pred))])[0],
                      int(_np.prod(pred.shape)))


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wraps a user feval(label_np, pred_np) -> value or (sum, count).

    User fevals are arbitrary numpy: this metric runs on the host.
    """

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names,
                         has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            result = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(result, tuple):
                self._inc(*result)
            else:
                self._inc(result, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


# registry aliases matching the reference's registered names
register(Accuracy, "acc")
register(CrossEntropy, "ce")
register(NegativeLogLikelihood, "nll_loss")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """mx.metric.np — build a CustomMetric from a numpy feval."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation from a KxK confusion matrix (the
    multiclass generalization of MCC; reference metric.py PCC):

        pcc = (N * tr(C) - sum_k t_k p_k)
              / (sqrt(N^2 - sum t_k^2) * sqrt(N^2 - sum p_k^2))

    with t = true counts per class, p = predicted counts per class —
    the discrete Pearson correlation of the label/prediction indicator
    vectors. The confusion matrix grows lazily as new class ids appear."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        self._conf = _np.zeros((1, 1), dtype=_np.float64)    # local
        self._gconf = _np.zeros((1, 1), dtype=_np.float64)   # epoch-global
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    @staticmethod
    def _grown(conf, k):
        if k <= conf.shape[0]:
            return conf
        c = _np.zeros((k, k), _np.float64)
        c[:conf.shape[0], :conf.shape[0]] = conf
        return c

    def _grow(self, k):
        self._conf = self._grown(self._conf, k)
        self._gconf = self._grown(self._gconf, k)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            lab = _np.asarray(label.asnumpy()).reshape(-1).astype(_np.int64)
            p = _np.asarray(pred.asnumpy())
            if p.ndim > 1 and p.shape[-1] > 1:
                p = p.reshape(-1, p.shape[-1]).argmax(axis=-1)
            else:
                p = (p.reshape(-1) > 0.5)
            p = p.astype(_np.int64)
            n = min(len(lab), len(p))
            self._grow(int(max(lab.max(initial=0), p.max(initial=0))) + 1)
            _np.add.at(self._conf, (lab[:n], p[:n]), 1.0)
            _np.add.at(self._gconf, (lab[:n], p[:n]), 1.0)
            self.num_inst += n
            self.global_num_inst += n

    @staticmethod
    def _pcc_of(c):
        n = c.sum()
        if n == 0:
            return 0.0
        t = c.sum(axis=1)
        pr = c.sum(axis=0)
        cov = n * _np.trace(c) - t @ pr
        d1 = n * n - t @ t
        d2 = n * n - pr @ pr
        if d1 <= 0 or d2 <= 0:
            return 0.0
        return float(cov / math.sqrt(d1 * d2))

    @property
    def sum_metric(self):
        return self._pcc_of(self._conf) * self.num_inst

    @sum_metric.setter
    def sum_metric(self, v):
        pass            # derived from the confusion matrix

    @property
    def global_sum_metric(self):
        return self._pcc_of(self._gconf) * self.global_num_inst

    @global_sum_metric.setter
    def global_sum_metric(self, v):
        pass

    def reset(self):
        self._conf = _np.zeros((1, 1), _np.float64)
        self._gconf = _np.zeros((1, 1), _np.float64)
        self.num_inst = 0
        self.global_num_inst = 0

    def reset_local(self):
        """Clears only the per-interval stats (Speedometer auto_reset);
        the epoch-global confusion matrix survives."""
        self._conf = _np.zeros((1, 1), _np.float64)
        self.num_inst = 0
