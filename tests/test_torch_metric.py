"""The port's metrics (``mxnet_tpu_torch.metric``) against the JAX
package's on the CPU: every registered metric, by each name it is
registered under, over three seeded batches (``get``, ``get_global`` and
``get_name_value``, after ``reset_local`` too), ``CompositeEvalMetric``,
``create`` from a name, a list, a callable or an instance, ``np``,
``CustomMetric``, ``update_dict`` with output and label names,
``get_config``, and the shape errors.

Tolerances: Accuracy, TopKAccuracy, F1 and MCC count integers, and
their values are JAX's bitwise (the counts, and the same float64
arithmetic on them); PCC and CustomMetric run the same numpy code on the
host, bitwise too. Perplexity, CrossEntropy, NegativeLogLikelihood, MAE,
MSE, RMSE, PearsonCorrelation and Loss reduce fp32 tensors in another
order than XLA does: within rtol 1e-5 (atol 1e-6 for values near 0)."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
N, C = 12, 5


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _batch(kind, seed):
    """(labels, preds) as numpy lists for one batch of a metric kind."""
    rng = np.random.RandomState(seed)
    if kind == "class":
        return ([rng.randint(0, C, N).astype(np.float32)],
                [_softmax(rng.randn(N, C))])
    if kind == "binary":
        return ([rng.randint(0, 2, N).astype(np.float32)],
                [_softmax(rng.randn(N, 2))])
    if kind == "binary1d":
        return ([rng.randint(0, 2, N).astype(np.float32)],
                [rng.uniform(0, 1, N).astype(np.float32)])
    if kind == "seq":
        return ([rng.randint(0, C, (3, 4)).astype(np.float32)],
                [_softmax(rng.randn(3, 4, C))])
    if kind == "regress":
        return ([rng.randn(N, 3).astype(np.float32)],
                [rng.randn(N, 3).astype(np.float32)])
    if kind == "multi":
        return ([rng.randint(0, C, N).astype(np.float32),
                 rng.randint(0, C, N).astype(np.float32)],
                [_softmax(rng.randn(N, C)), _softmax(rng.randn(N, C))])
    raise ValueError(kind)


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(-1)).sum()), label.size


# registered name -> (constructor kwargs, batch kind, exact)
CASES = {
    "accuracy": ({}, "class", True),
    "acc": ({}, "multi", True),
    "topkaccuracy": ({"top_k": 3}, "class", True),
    "top_k_accuracy": ({"top_k": 2}, "multi", True),
    "top_k_acc": ({"top_k": 4}, "class", True),
    "f1": ({}, "binary", True),
    "mcc": ({}, "binary1d", True),
    "perplexity": ({"ignore_label": 1}, "seq", False),
    "mae": ({}, "regress", False),
    "mse": ({}, "regress", False),
    "rmse": ({}, "regress", False),
    "crossentropy": ({}, "class", False),
    "ce": ({"eps": 1e-8}, "multi", False),
    "negativeloglikelihood": ({}, "class", False),
    "nll_loss": ({}, "class", False),
    "pearsoncorrelation": ({}, "regress", False),
    "loss": ({}, "regress", False),
    "torch": ({}, "regress", False),
    "caffe": ({}, "regress", False),
    "custommetric": ({"feval": _feval}, "class", True),
    "pcc": ({}, "class", True),
}


def test_every_registered_name_has_a_case():
    assert sorted(jmx.metric._METRIC_REGISTRY) == sorted(CASES)
    assert sorted(mt.metric._METRIC_REGISTRY) == sorted(CASES)
    assert mt.metric.__all__ == jmx.metric.__all__


def _drive(mx, name, kwargs, kind, extra=()):
    m = mx.metric.create(name, **kwargs)
    views = []
    for seed in range(3):
        labels, preds = _batch(kind, seed)
        m.update([mx.nd.array(x) for x in labels],
                 [mx.nd.array(x) for x in preds])
        views.append((m.get(), m.get_global(), m.get_name_value()))
        if seed == 1:
            m.reset_local()
    return m, views


def _same(t, j, exact):
    if isinstance(t, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b, exact)
    elif isinstance(t, str):
        assert t == j
    elif exact:
        assert float(t) == float(j) or (np.isnan(t) and np.isnan(j))
    else:
        np.testing.assert_allclose(float(t), float(j), **FLOAT_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_registered_metric_matches_jax(name):
    kwargs, kind, exact = CASES[name]
    tm, tv = _drive(mt, name, kwargs, kind)
    jm, jv = _drive(jmx, name, kwargs, kind)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    _same(tv, jv, exact)
    assert tm.num_inst == jm.num_inst
    if name != "custommetric":
        assert tm.get_config() == jm.get_config()


def test_top_k_breaks_ties_as_jax_does():
    """Equal scores rank by index, lower first, as lax.top_k orders
    them: the count is JAX's whatever the device's topk does."""
    pred = np.array([[0.2, 0.2, 0.2, 0.2, 0.2],
                     [0.1, 0.3, 0.3, 0.3, 0.0],
                     [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    for label in ([0, 1, 2], [4, 3, 3], [2, 2, 3], [3, 0, 1]):
        got = []
        for mx in (mt, jmx):
            m = mx.metric.TopKAccuracy(top_k=3)
            m.update([mx.nd.array(np.array(label, np.float32))],
                     [mx.nd.array(pred)])
            got.append((m.sum_metric, m.num_inst))
        assert got[0] == got[1], (label, got)


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("name", ["f1", "mcc"])
def test_confusion_metrics_average(name, average):
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        m = mx.metric.create(name, average=average)
        for seed in range(3):
            labels, preds = _batch("binary", seed)
            m.update([mx.nd.array(x) for x in labels],
                     [mx.nd.array(x) for x in preds])
        got[key] = (m.get(), m.sum_metric, m.num_inst)
    _same(got["port"], got["jax"], True)


def test_composite_create_np_and_update_dict():
    labels, preds = _batch("class", 7)
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        comp = mx.metric.create(["acc", "ce", mx.metric.TopKAccuracy(3)])
        assert isinstance(comp, mx.metric.CompositeEvalMetric)
        comp.add(mx.metric.np(_feval, name="l1"))
        comp.update_dict({"softmax_label": mx.nd.array(labels[0])},
                         {"softmax_output": mx.nd.array(preds[0])})
        named = mx.metric.Accuracy(output_names=["b"], label_names=["y"])
        named.update_dict({"y": mx.nd.array(labels[0]),
                           "x": mx.nd.array(np.zeros(N, np.float32))},
                          {"a": mx.nd.array(preds[0][::-1].copy()),
                           "b": mx.nd.array(preds[0])})
        custom = mx.metric.create(_feval)
        custom.update([mx.nd.array(labels[0])], [mx.nd.array(preds[0])])
        got[key] = (comp.get(), comp.get_global(), named.get(),
                    custom.get(), comp.get_metric(1).name)
        with pytest.raises(ValueError):
            comp.get_metric(9)
    _same(got["port"][0][0], got["jax"][0][0], True)
    _same(got["port"][0][1][0::2], got["jax"][0][1][0::2], True)
    np.testing.assert_allclose(got["port"][0][1][1], got["jax"][0][1][1],
                               **FLOAT_TOL)
    _same(got["port"][2:], got["jax"][2:], True)


def test_shape_errors_and_unknown_names():
    for mx in (mt, jmx):
        with pytest.raises(ValueError, match="does not match"):
            mx.metric.Accuracy().update([mx.nd.array(np.zeros(3))],
                                        [mx.nd.array(np.zeros((4, 2)))])
        with pytest.raises(ValueError, match="does not match"):
            mx.metric.check_label_shapes([1, 2], [1])
        with pytest.raises(ValueError, match="not registered"):
            mx.metric.create("no_such_metric")
        with pytest.raises(TypeError):
            mx.metric.create(3)
        with pytest.raises(ValueError, match="binary"):
            mx.metric.F1().update([mx.nd.array(np.arange(3.0))],
                                  [mx.nd.array(np.ones((3, 2)))])
        with pytest.raises(AssertionError):
            mx.metric.TopKAccuracy(top_k=1)


def test_register_adds_a_name():
    @mt.metric.register
    class Ones(mt.metric.EvalMetric):
        def __init__(self):
            super().__init__("ones")

        def update(self, labels, preds):
            self._inc(1.0, 1)

    try:
        m = mt.metric.create("ones")
        m.update([], [])
        assert m.get() == ("ones", 1.0)
    finally:
        del mt.metric._METRIC_REGISTRY["ones"]
