"""The port's optimizer update ops (``mxnet_tpu_torch/ops/optimizer_ops.py``)
against the JAX package's: each of the 26 registered names and aliases
on the same numpy inputs (seeded), fp32 and bf16, called as
``nd.<op>(weight, grad, *states, out=weight, ...)`` so that the weight
and every state input are advanced in place (the FMutateInputs
contract), and once without ``out``.

Tolerances: fp32 at rtol 1e-5 with an atol of 1e-6 times the largest
magnitude; bf16 at 2^-6 of the largest magnitude (one or two bf16
roundings: JAX rounds a Python hyperparameter to bf16 before it
multiplies, torch keeps it in fp32, and XLA may skip an intermediate
rounding). The fp32 master copies of the ``mp_`` ops are held at the fp32
tolerance in both cases."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import dtype_name
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (4, 5)
HYPER = dict(rescale_grad=0.5, clip_gradient=0.3)

# name -> (input kinds, attrs). Kinds: w weight, g gradient, s a state of
# any sign and p a positive one (both in the weight's dtype), s32/p32 fp32
# states, m32 the weight's fp32 master, lr/wd preloaded fp32 vectors,
# rs AdamW's rescale tensor (a keyword input)
CASES = {
    "sgd_update": ("wg", dict(lr=0.1, wd=0.01, **HYPER)),
    "sgd_mom_update": (("w", "g", "s"), dict(lr=0.1, momentum=0.9, wd=0.01,
                                             **HYPER)),
    "nag_mom_update": (("w", "g", "s"), dict(lr=0.1, momentum=0.9, wd=0.01,
                                             **HYPER)),
    "signsgd_update": ("wg", dict(lr=0.1, wd=0.01, **HYPER)),
    "signum_update": (("w", "g", "s"), dict(lr=0.1, momentum=0.9, wd=0.01,
                                            wd_lh=0.01, **HYPER)),
    "adam_update": (("w", "g", "s", "p"), dict(lr=0.01, wd=0.01, **HYPER)),
    "adamw_update": (("w", "g", "s32", "p32", "rs"), dict(lr=0.01, wd=0.01,
                                                          eta=0.5)),
    "_adamw_update": (("w", "g", "s32", "p32", "rs"), dict(lr=0.01, wd=0.01,
                                                           eta=0.5)),
    "_contrib_adamw_update": (("w", "g", "s32", "p32", "rs"),
                              dict(lr=0.01, wd=0.01, eta=0.5,
                                   clip_gradient=0.3)),
    "_mp_adamw_update": (("w", "g", "s32", "p32", "m32", "rs"),
                         dict(lr=0.01, wd=0.01, eta=0.5)),
    "_contrib_mp_adamw_update": (("w", "g", "s32", "p32", "m32", "rs"),
                                 dict(lr=0.01, wd=0.01, eta=0.5,
                                      clip_gradient=0.3)),
    "rmsprop_update": (("w", "g", "p"), dict(lr=0.01, wd=0.01,
                                             clip_weights=0.6, **HYPER)),
    "rmspropalex_update": (("w", "g", "p", "s", "s"),
                           dict(lr=0.01, wd=0.01, **HYPER)),
    "ftrl_update": (("w", "g", "s", "p"), dict(lr=0.1, lamda1=0.01, wd=0.01,
                                               **HYPER)),
    "ftml_update": (("w", "g", "p", "p", "s"), dict(lr=0.01, wd=0.01, t=2,
                                                    rescale_grad=0.5,
                                                    clip_grad=0.3)),
    "multi_sgd_update": (("w", "g", "w", "g"),
                         dict(lrs=(0.1, 0.2), wds=(0.01, 0.0), num_weights=2,
                              **HYPER)),
    "multi_sgd_mom_update": (("w", "g", "s", "w", "g", "s"),
                             dict(lrs="(0.1, 0.2)", wds="[0.01, 0.0]",
                                  momentum=0.9, num_weights=2, **HYPER)),
    "preloaded_multi_sgd_update": (("w", "g", "w", "g", "lr", "wd"),
                                   dict(num_weights=2, **HYPER)),
    "preloaded_multi_sgd_mom_update": (
        ("w", "g", "s", "w", "g", "s", "lr", "wd"),
        dict(momentum=0.9, num_weights=2, **HYPER)),
    "mp_sgd_update": (("w", "g", "m32"), dict(lr=0.1, wd=0.01, **HYPER)),
    "mp_sgd_mom_update": (("w", "g", "s32", "m32"),
                          dict(lr=0.1, momentum=0.9, wd=0.01, **HYPER)),
    "mp_nag_mom_update": (("w", "g", "s32", "m32"),
                          dict(lr=0.1, momentum=0.9, wd=0.01, **HYPER)),
    "multi_mp_sgd_update": (("w", "g", "m32", "w", "g", "m32"),
                            dict(lrs=(0.1, 0.2), wds=(0.01, 0.0),
                                 num_weights=2, **HYPER)),
    "multi_mp_sgd_mom_update": (("w", "g", "s32", "m32", "w", "g", "s32",
                                 "m32"),
                                dict(lrs=(0.1, 0.2), wds=(0.01, 0.0),
                                     momentum=0.9, num_weights=2, **HYPER)),
    "_sparse_adagrad_update": (("w", "g", "p"), dict(lr=0.1, **HYPER)),
    "_contrib_group_adagrad_update": (("w", "g", "p"), dict(lr=0.1,
                                                           **HYPER)),
}


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _host(kinds, dtype, seed):
    """numpy values and dtype names of each input, the weights rounded to
    ``dtype`` first so that a master copy equals its weight."""
    rs = np.random.RandomState(seed)
    vals = []
    last_w = None
    for k in kinds:
        if k in ("lr", "wd"):
            v = np.array([0.1, 0.2] if k == "lr" else [0.01, 0.0],
                         np.float32)
            vals.append((v, "float32"))
            continue
        if k == "rs":
            vals.append((np.array([0.5], np.float32), "float32"))
            continue
        v = rs.uniform(-1, 1, SHAPE).astype(np.float32)
        if k.startswith("p"):
            v = np.abs(v) + 0.5
        if k == "m32":
            vals.append((last_w, "float32"))
            continue
        dt = "float32" if k.endswith("32") else dtype
        if dt == "bfloat16":
            v = np.asarray(jmx.nd.array(v, dtype="bfloat16").asnumpy(),
                           np.float32)
        if k == "w":
            last_w = v
        vals.append((v, dt))
    return vals


def _call(mx, name, kinds, attrs, host, use_out=True):
    """Run op ``name`` of package ``mx``; (returned, inputs after)."""
    nd = mx.nd
    arrs = [nd.array(v, dtype=dt) for v, dt in host]
    kw = dict(attrs)
    pos = []
    for k, a in zip(kinds, arrs):
        if k == "rs":
            kw["rescale_grad"] = a
        else:
            pos.append(a)
    weights = [a for k, a in zip(kinds, pos) if k == "w"]
    if group_adagrad(name):
        pos[2] = nd.array(host[2][0][:, 0], dtype=host[2][1])
        arrs[2] = pos[2]
    if use_out:
        kw["out"] = weights if len(weights) > 1 else weights[0]
    got = getattr(nd, name)(*pos, **kw)
    return got, arrs


def group_adagrad(name):
    return name == "_contrib_group_adagrad_update"


def _close(t, j, what, tol):
    assert dtype_name(t.dtype) == np.dtype(j.dtype).name, what
    tv = np.asarray(t.asnumpy(), np.float64)
    jv = np.asarray(j.asnumpy(), np.float64)
    scale = max(1.0, np.abs(jv).max())
    np.testing.assert_allclose(tv, jv, rtol=tol[0], atol=tol[1] * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_update_op_matches_jax(name, dtype):
    kinds, attrs = CASES[name]
    host = _host(kinds, dtype, seed=len(name))
    _, jarrs = _call(jmx, name, kinds, attrs, host)
    _, tarrs = _call(mt, name, kinds, attrs, host)
    for k, t, j in zip(kinds, tarrs, jarrs):
        fp32 = dtype == "float32" or k.endswith("32") or k in ("lr", "wd")
        tol = (1e-5, 1e-6) if fp32 else (2.0 ** -6, 2.0 ** -6)
        _close(t, j, "%s input %s" % (name, k), tol)


def test_update_without_out_returns_the_weight_and_advances_state():
    kinds, attrs = CASES["mp_sgd_mom_update"]
    host = _host(kinds, "bfloat16", seed=3)
    jgot, jarrs = _call(jmx, "mp_sgd_mom_update", kinds, attrs, host,
                        use_out=False)
    tgot, tarrs = _call(mt, "mp_sgd_mom_update", kinds, attrs, host,
                        use_out=False)
    # the weight is untouched, mom and the master advanced, the returned
    # weight is the master's cast
    np.testing.assert_array_equal(tarrs[0].asnumpy(), host[0][0])
    assert dtype_name(tgot.dtype) == "bfloat16"
    _close(tgot, jgot, "returned weight", (2.0 ** -6, 2.0 ** -6))
    for k, t, j in zip(kinds[2:], tarrs[2:], jarrs[2:]):
        _close(t, j, "state " + k, (1e-5, 1e-6))
    assert not np.array_equal(tarrs[2].asnumpy(), host[2][0])


def test_sparse_adagrad_refuses_weight_decay_as_jax_does():
    host = _host("wgp", "float32", seed=1)
    for mx in (jmx, mt):
        with pytest.raises(ValueError, match="wd"):
            _call(mx, "_sparse_adagrad_update", "wgp", dict(lr=0.1, wd=0.1),
                  host)
