"""Gluon losses (port of ``mxnet_tpu/gluon/loss.py``; reference:
python/mxnet/gluon/loss.py).

The ``Loss`` base and its 13 losses, written against the ``F`` namespace
so that each runs imperatively (``nd``) and hybridized (``sym``). The
per-class weighting and the mean over the non-batch axes live once in
``_ElementwiseLoss``; the binary cross-entropies use
softplus(x) - x*z, as the reference module does.
"""

import numpy as np

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]

from .block import HybridBlock


class Loss(HybridBlock):
    """Base loss: holds the global weight and the batch axis."""

    def __init__(self, weight, batch_axis, **kwargs):
        super(Loss, self).__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            self.__class__.__name__, self._batch_axis, self._weight)

    def _scale(self, F, loss, sample_weight):
        """Per-sample weighting then the constant loss weight."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        if self._weight is not None:
            assert isinstance(self._weight, (int, float)), \
                "weight must be a number"
            loss = loss * self._weight
        return loss

    def _finish(self, F, loss, sample_weight):
        """Shared tail of every loss: weighting, then the mean over all
        non-batch axes."""
        weighted = self._scale(F, loss, sample_weight)
        return F.mean(weighted, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _ElementwiseLoss(Loss):
    """Losses of the shape mean_over_non_batch(scale * residual(...)).

    Subclasses implement `residual(F, pred, label)`; everything else —
    label reshape, sample weighting, the non-batch mean — is shared here
    instead of repeated per class.
    """

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        return self._finish(F, self.residual(F, pred, label),
                            sample_weight)

    def residual(self, F, pred, label):
        raise NotImplementedError


class L2Loss(_ElementwiseLoss):
    """0.5 * w * (pred - label)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super(L2Loss, self).__init__(weight, batch_axis, **kwargs)

    def residual(self, F, pred, label):
        return 0.5 * F.square(label - pred)


class L1Loss(_ElementwiseLoss):
    """w * |pred - label|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super(L1Loss, self).__init__(weight, batch_axis, **kwargs)

    def residual(self, F, pred, label):
        return F.abs(label - pred)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE over logits (default) or probabilities (from_sigmoid=True)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super(SigmoidBinaryCrossEntropyLoss, self).__init__(
            weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                # -z*log σ(x) - (1-z)*log σ(-x)  ==  softplus(x) - x*z
                loss = F.softrelu(pred) - pred * label
            else:
                # positive term reweighted: x - x*z + (1+(pw-1)z)*softplus(-x)
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * F.softrelu(-pred)
        else:
            eps = 1e-12
            pos_term = F.log(pred + eps) * label
            if pos_weight is not None:
                pos_term = F.broadcast_mul(pos_term, pos_weight)
            loss = -(pos_term + F.log(1.0 - pred + eps) * (1.0 - label))
        return self._finish(F, loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """log-softmax + NLL; labels sparse class ids or dense distributions."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super(SoftmaxCrossEntropyLoss, self).__init__(
            weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            label = F.reshape_like(label, logp)
            loss = -F.sum(logp * label, axis=self._axis, keepdims=True)
        return self._finish(F, loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(_ElementwiseLoss):
    """label * (log label - log pred); pred already log-prob by default."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super(KLDivLoss, self).__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def residual(self, F, pred, label):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        return label * (F.log(label + 1e-12) - pred)


class CTCLoss(Loss):
    """Connectionist temporal classification over the framework CTC op."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        assert layout in ("NTC", "TNC"), \
            "pred layout must be 'NTC' or 'TNC', got: %s" % layout
        assert label_layout in ("NT", "TN"), \
            "label layout must be 'NT' or 'TN', got: %s" % label_layout
        self._layout = layout
        self._label_layout = label_layout
        super(CTCLoss, self).__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return self._scale(F, loss, sample_weight)


class HuberLoss(_ElementwiseLoss):
    """Quadratic inside |err| <= rho, linear outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super(HuberLoss, self).__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def residual(self, F, pred, label):
        err = F.abs(label - pred)
        return F.where(err > self._rho,
                       err - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(err))


class HingeLoss(_ElementwiseLoss):
    """max(0, margin - pred*label) for signed labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super(HingeLoss, self).__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def residual(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(_ElementwiseLoss):
    """max(0, margin - pred*label)^2 for signed labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super(SquaredHingeLoss, self).__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def residual(self, F, pred, label):
        return F.square(F.relu(self._margin - pred * label))


class LogisticLoss(_ElementwiseLoss):
    """BCE over logits with 'signed' (±1) or 'binary' (0/1) labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super(LogisticLoss, self).__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(
                "label_format can only be signed or binary, recieved %s."
                % label_format)
        self._label_format = label_format

    def residual(self, F, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0       # map {-1,1} -> {0,1}
        return F.softrelu(pred) - pred * label


class TripletLoss(Loss):
    """max(0, ||a-p||^2 - ||a-n||^2 + margin) per anchor."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super(TripletLoss, self).__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        gap = F.sum(F.square(positive - pred) - F.square(negative - pred),
                    axis=self._batch_axis, exclude=True)
        return self._scale(F, F.relu(gap + self._margin), sample_weight)


class PoissonNLLLoss(Loss):
    """NLL under Poisson; optional Stirling correction for large targets."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super(PoissonNLLLoss, self).__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = F.reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            # log(k!) ~ k log k - k + 0.5 log(2 pi k), applied where k > 1
            stirling = target * F.log(target) - target + \
                0.5 * F.log(2 * np.pi * target)
            loss = loss + F.where(target > 1, stirling,
                                  F.zeros_like(stirling))
        loss = self._scale(F, loss, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """1 - cos(a, b) for label 1, max(0, cos(a, b) - margin) for label -1."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super(CosineEmbeddingLoss, self).__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = F.reshape_like(input1, input2)
        dot = F.sum(input1 * input2, axis=-1).reshape((-1, 1))
        norms = F.norm(input1, axis=-1).reshape((-1, 1)) * \
            F.norm(input2, axis=-1).reshape((-1, 1))
        cos_sim = dot / F.broadcast_maximum(
            norms, F.ones_like(norms) * 1e-12)
        label = label.reshape((-1, 1)) if hasattr(label, "reshape") else label
        loss = F.where(label == 1, 1.0 - cos_sim,
                       F.relu(cos_sim - self._margin))
        return self._scale(F, loss, sample_weight)
