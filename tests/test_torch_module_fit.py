"""``entry.module_fit``, the port's counterpart of
``examples/image_classification/train_imagenet.py --benchmark 1``
through ``common.fit``, against the JAX package's ``Module.fit`` on the
CPU: the example's ResNet-18 CIFAR branch (3 x 32^2, 10 classes), batch
4, two batches of ``common.synthetic_iter``'s data (the same RandomState
draw and the same shuffle), SGD at lr 0.1 with momentum 0.9, wd 1e-4 and
the recipe's MultiFactorScheduler, from the reference's Xavier draw
passed to both as numpy ``arg_params``/``aux_params``.

Tolerance (fp32): the parameters' change over the two updates (all
parameters together) within a relative L2 of 1e-2 of JAX's; the
auxiliary states' change (every BatchNorm's moving mean and variance)
within 1e-4 of JAX's (1.5e-6 here; the nudge below moves JAX's own by
7.5e-7), and the fitted modules' eval-mode softmax on the first batch
within a relative L2 of 1e-4 (1.5e-6 here; both near-saturated, as two
steps at lr 0.1 from scratch leave them). ResNet's
two SGD steps at lr 0.1 from Xavier's start are chaotic: a 1e-7
relative perturbation of the reference's own start moves its change by
~1e-3 (the first gradients of the two packages agree within 5.2e-6,
each within 5.1e-6 of a float64 run of the same graph), and the test
asserts that spread under half the limit. Damping each unit's bn2 gamma
to 0.01, as tests/test_torch_trainer.py does for Gluon, would not help:
it makes the reference's own first gradient ill-conditioned here, 6.5e-4
from the float64 run, where the port's is 3.5e-7."""

import importlib.util
import os

import numpy as np

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import entry
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_LIMIT = 1e-2
AUX_LIMIT = 1e-4
EVAL_LIMIT = 1e-4


def _example_resnet():
    spec = importlib.util.spec_from_file_location(
        "example_resnet_symbols", os.path.join(
            ROOT, "examples", "image_classification", "symbols",
            "resnet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nds(mx, params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _arrays(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _data(spec):
    """common.synthetic_iter's draw: (x, y) as numpy arrays."""
    shape = (3, spec["image_size"], spec["image_size"])
    rng = np.random.RandomState(0)
    n = spec["batch"] * spec["num_batches"]
    x = rng.uniform(-1, 1, (n,) + shape).astype(np.float32)
    y = rng.randint(0, spec["classes"], (n,)).astype(np.float32)
    return x, y


def _jax_fit(ex, arg, aux, spec):
    """JAX's Module.fit as common.fit calls it, from numpy parameters."""
    shape = (3, spec["image_size"], spec["image_size"])
    x, y = _data(spec)
    np.random.seed(0)
    it = jmx.io.NDArrayIter(x, y, batch_size=spec["batch"], shuffle=True,
                            label_name="softmax_label")
    steps = [max(1, e * (1281167 // spec["batch"])) for e in (30, 60, 80)]
    mod = jmx.mod.Module(ex.get_symbol(spec["classes"], 18, shape),
                         context=jmx.cpu())
    mod.fit(it, eval_metric="acc", kvstore="device", optimizer="sgd",
            optimizer_params={
                "learning_rate": 0.1, "wd": 1e-4, "momentum": 0.9,
                "lr_scheduler": jmx.lr_scheduler.MultiFactorScheduler(
                    step=steps, factor=0.1, base_lr=0.1)},
            initializer=jmx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2),
            arg_params=_nds(jmx, arg), aux_params=_nds(jmx, aux),
            num_epoch=1,
            batch_end_callback=[jmx.callback.Speedometer(spec["batch"],
                                                         20)])
    return mod


def _change_rel_l2(a, b, start):
    num = np.sqrt(sum(((a[k] - b[k]).astype(np.float64) ** 2).sum()
                      for k in b))
    den = np.sqrt(sum(((b[k] - start[k]).astype(np.float64) ** 2).sum()
                      for k in b))
    return num / den


def test_module_fit_resnet18_matches_jax():
    spec = dict(batch=4, image_size=32, classes=10, num_batches=2)
    ex = _example_resnet()
    shape = (3, 32, 32)
    probe = jmx.mod.Module(ex.get_symbol(10, 18, shape), context=jmx.cpu())
    probe.bind([("data", (4,) + shape)], [("softmax_label", (4,))])
    probe.init_params(jmx.init.Xavier(rnd_type="gaussian",
                                      factor_type="in", magnitude=2))
    arg, aux = (_arrays(p) for p in probe.get_params())
    jax_mod = _jax_fit(ex, arg, aux, spec)
    want, want_aux = (_arrays(p) for p in jax_mod.get_params())
    np.random.seed(0)
    with mt.cpu():
        mod = entry.module_fit(batch=4, image_size=32, num_layers=18,
                               classes=10, num_batches=2, ctx=mt.cpu(),
                               arg_params=_nds(mt, arg),
                               aux_params=_nds(mt, aux))
    assert mod._kvstore is None and not mod._update_on_kvstore
    got, got_aux = (_arrays(p) for p in mod.get_params())
    err = _change_rel_l2(got, want, arg)
    rng = np.random.RandomState(9)
    nudged = {k: (v * (1 + 1e-7 * rng.randn(*v.shape))).astype(np.float32)
              for k, v in arg.items()}
    spread = _change_rel_l2(
        _arrays(_jax_fit(ex, nudged, aux, spec).get_params()[0]), want, arg)
    assert spread < RESNET_LIMIT / 2, spread
    assert err < RESNET_LIMIT, (err, spread)
    assert sorted(got_aux) == sorted(want_aux)
    aux_err = _change_rel_l2(got_aux, want_aux, aux)
    assert aux_err < AUX_LIMIT, aux_err
    x = _data(spec)[0][:4]
    jax_mod.forward(jmx.io.DataBatch([jmx.nd.array(x)], None),
                    is_train=False)
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], None),
                is_train=False)
    j, t = (m.get_outputs()[0].asnumpy() for m in (jax_mod, mod))
    assert np.linalg.norm(t - j) / np.linalg.norm(j) < EVAL_LIMIT
