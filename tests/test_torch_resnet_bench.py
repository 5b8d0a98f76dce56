"""The port's ``entry.build_train_step`` against the JAX package's
``bench.build_train_step``, both in the default fold-cast layout (a bf16
graph on persistent bf16 weights, fp32 masters, SGD with momentum 0.9,
lr 0.1), after one step of ResNet-50 v1 with 10 classes on a seeded
batch of 2 x 3 x 64^2.

The JAX step's initial masters and running statistics are copied into
the port's by name (the graphs' names differ only in the top block's
automatic prefix), so the parameters are drawn once.

The start. At its Xavier initialisation the net's gradient explodes
backward through the 16 bottlenecks (a float64 step's gradient norm is
~1e4 here; fp32 is 8% from float64), and a bf16 step's gradient is
noise: the reference's own moves by a relative L2 of ~1.3 when its bf16
weights round toward zero instead of to nearest, more than a zero
gradient's 1.0, so no bound can tell a right port from a wrong one
there. The comparison therefore starts from the same masters with each
bottleneck's last BatchNorm gamma set to ``LAST_GAMMA`` = 0.01: the
near-zero residual start of Goyal et al. (2017), which GluonCV calls
``last_gamma`` and torchvision ``zero_init_residual``, left above zero
so that every branch still gets a gradient. The net then starts
shallow: the gradient norm is ~40, the reference's own spread is small
for the loss and the running statistics and about a quarter for the
gradients. That quarter is bf16 itself: a training-mode BatchNorm's
input gradient subtracts the channel means of its output gradient,
which after the global pool is near constant over a channel, so the
sum cancels in bf16 at every depth.

The gates, each a relative L2 from the reference's step; each part
first asserts that the reference's own spread (the same step on bf16
weights rounded toward zero) is under half its limit, so no gate can
quietly become vacuous, and each limit is under the distance that a
zero gradient or an unmoved state gives:

- the loss: ``LIMITS["loss"]``;
- the running statistics: ``LIMITS["aux"]`` (unmoved: ~0.09);
- the momentum (the gradient, from zero momentum) and the masters'
  step (new masters minus the start, lr times the momentum), per group
  of parameters: the dense layer, where the spread is ~0.02, at
  ``LIMITS["dense"]``; the convolution weights, the BatchNorm gammas
  and the BatchNorm betas, where it is ~0.2-0.3, at ``LIMITS["grad"]``
  (a zero gradient: 1.0).

The mechanics are checked exactly (momentum = the gradient, masters =
start - 0.1 momentum in fp32, bf16 weights = the masters rounded to
nearest, running statistics back in fp32), and the graph's numerics are
held at fp32 in ``test_torch_resnet.py``.

Why 64^2: at 32^2 the last stage's BatchNorms see 2 values a channel
(1 x 1 maps of a batch of 2); the reference's own first step at Xavier
then has gradient norms near 1e10 and its second step is NaN.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import entry
from mxnet_tpu_torch.gluon.model_zoo import vision
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH, SIZE, CLASSES, LR = 2, 64, 10, 0.1
LAST_GAMMA = 0.01
LIMITS = {"loss": 0.01, "aux": 0.01, "dense": 0.1, "grad": 0.75}
GROUPS = {"dense": lambda k: k.startswith("dense"),
          "conv weights": lambda k: k.startswith(("conv", "stage"))
          and k.endswith("_weight"),
          "gammas": lambda k: k.endswith("_gamma"),
          "betas": lambda k: k.endswith("_beta")}


def _unprefixed(name):
    return re.sub(r"^resnetv1\d+_", "", name)


def _numpy(tree):
    return {_unprefixed(k): np.asarray(v, np.float32) for k, v in tree.items()}


def _rel_l2(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    a = np.concatenate([np.ravel(got[k]) for k in keys]).astype(np.float64)
    b = np.concatenate([np.ravel(want[k]) for k in keys]).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _last_gammas():
    """Each bottleneck's last BatchNorm gamma, by unprefixed name."""
    net = vision.resnet50_v1(classes=CLASSES)
    return [_unprefixed(blk.body[-1].gamma.name)
            for stage in list(net.features)[4:8] for blk in stage]


@pytest.fixture(scope="module")
def steps():
    """(start, the reference's step, the reference's step with its bf16
    weights rounded toward zero, the port's step), as numpy dicts keyed
    by the name without the top prefix. The reference's parameters are
    drawn from its generator reseeded here: a module fixture is set up
    before the per-test seeding fixture, so the draw would otherwise
    depend on the tests that ran before in the process."""
    mx.random.seed(0)
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (BATCH, 3, SIZE, SIZE)).astype(np.float32)
    y = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    jstep, jstate, _, jaux = bench.build_train_step(
        BATCH, image_size=SIZE, classes=CLASSES, lr=LR)
    names = {_unprefixed(k): k for k in jstate[0]}
    start = {"masters": _numpy(jstate[0]), "aux": _numpy(jaux)}
    last = _last_gammas()
    assert len(last) == 16 and all(k in start["masters"] for k in last)
    for k in last:
        start["masters"][k] = np.full_like(start["masters"][k], LAST_GAMMA)

    def jax_step(bf16_of):
        w32 = {names[k]: jnp.asarray(v) for k, v in start["masters"].items()}
        w16 = {names[k]: jnp.asarray(bf16_of(v)).astype(jnp.bfloat16)
               for k, v in start["masters"].items()}
        mom = {k: jnp.zeros(v.shape, jnp.float32) for k, v in w32.items()}
        aux = {k: jnp.asarray(v) for k, v in jaux.items()}
        (new32, _), mom, aux, loss = jstep((w32, w16), mom, aux, x, y)
        return {"loss": float(loss), "masters": _numpy(new32),
                "momentum": _numpy(mom), "aux": _numpy(aux)}

    nearest = jax_step(lambda v: v)
    toward_zero = jax_step(
        lambda v: (v.view(np.uint32) & np.uint32(0xFFFF0000))
        .view(np.float32))

    with mt.cpu():
        step, state, mom, aux = entry.build_train_step(
            BATCH, image_size=SIZE, classes=CLASSES, lr=LR)
    for tensors, values in ((state[0], start["masters"]),
                            (state[1], start["masters"]),
                            (aux, start["aux"])):
        assert sorted(map(_unprefixed, tensors)) == sorted(values)
        for k, t in tensors.items():
            t.copy_(torch.tensor(values[_unprefixed(k)]))
    (t32, t16), tmom, taux, tloss = step(state, mom, aux,
                                         torch.from_numpy(x),
                                         torch.from_numpy(y))
    assert all(v.dtype == torch.bfloat16 for v in t16.values())
    assert all(v.dtype == torch.float32 for v in taux.values())

    def plain(d):
        return {_unprefixed(k): v.float().numpy() for k, v in d.items()}
    port = {"loss": float(tloss), "masters": plain(t32),
            "momentum": plain(tmom), "aux": plain(taux), "bf16": plain(t16)}
    return start, nearest, toward_zero, port


def _within(got, floor, unmoved, limit, what):
    assert np.isfinite(got), what
    assert floor < limit / 2, ("the reference's own spread", what, floor)
    assert limit < unmoved, ("a limit a zero gradient meets", what, limit,
                             unmoved)
    assert got <= limit, (what, got, limit, floor)


@pytest.mark.parametrize("part", ["loss", "masters", "momentum", "aux"])
def test_one_step_within_the_references_own_bf16_spread(steps, part):
    """The loss, the running statistics, and by group of parameters the
    momentum and the masters' step from the start (a zero gradient gives
    1.0 there)."""
    start, ref, moved, port = steps
    if part == "loss":
        floor = abs(moved["loss"] - ref["loss"]) / abs(ref["loss"])
        got = abs(port["loss"] - ref["loss"]) / abs(ref["loss"])
        _within(got, floor, np.inf, LIMITS["loss"], "loss")
        return
    assert sorted(port[part]) == sorted(ref[part])
    if part == "aux":
        _within(_rel_l2(port["aux"], ref["aux"]),
                _rel_l2(moved["aux"], ref["aux"]),
                _rel_l2(start["aux"], ref["aux"]), LIMITS["aux"],
                "running statistics")
        return
    if part == "masters":
        ref, moved, port = ({k: v - start["masters"][k]
                             for k, v in r["masters"].items()}
                            for r in (ref, moved, port))
    else:
        ref, moved, port = (r[part] for r in (ref, moved, port))
    for group, member in GROUPS.items():
        keys = sorted(k for k in ref if member(k))
        assert keys, group
        zero = {k: np.zeros_like(ref[k]) for k in keys}
        _within(_rel_l2(port, ref, keys), _rel_l2(moved, ref, keys),
                _rel_l2(zero, ref, keys),
                LIMITS["dense" if group == "dense" else "grad"],
                (part, group))


def test_fold_cast_update_mechanics(steps):
    """From zero momentum: momentum = the gradient (fp32), masters =
    start - lr * momentum in fp32, the bf16 weights the masters rounded
    to nearest; the running statistics moved."""
    start, _, _, port = steps
    for k, w0 in start["masters"].items():
        m = port["momentum"][k]
        np.testing.assert_array_equal(port["masters"][k],
                                      w0 - np.float32(LR) * m)
        np.testing.assert_array_equal(
            port["bf16"][k],
            torch.from_numpy(port["masters"][k]).bfloat16().float().numpy())
    moved = [k for k in start["aux"]
             if not np.array_equal(port["aux"][k], start["aux"][k])]
    assert len(moved) == len(start["aux"])
