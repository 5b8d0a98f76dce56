"""ResNet through the port (model zoo, ``utils.functionalize_block``,
``executor.build_graph_fn``, ``entry``) against the JAX package, in
fp32 on the CPU.

Parameters are drawn once, from numpy with a seed, by the names and
shapes of the JAX package's traced graph; the JAX graph function takes
them as arrays and the port's through
``models.convert.graph_params_from_numpy``. Both nets are built under an
explicit prefix, so the graphs' names agree. Each output, gradient and
new running statistic agrees to a relative L2 error of 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.executor import build_graph_fn as jax_graph_fn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import entry
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.models.convert import graph_params_from_numpy
from mxnet_tpu_torch.utils import functionalize_block
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _draw(symbol, shape, seed):
    """Seeded parameters by graph name: weights uniform at Xavier's
    scale, gamma near 1, beta and running means near 0, running
    variances near 1."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=shape)
    args = {}
    for name, s in zip(symbol.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("weight"):
            fan = (s[0] + s[1]) * np.prod(s[2:]) / 2.0
            bound = np.sqrt(3.0 / fan)
            args[name] = rs.uniform(-bound, bound, s)
        elif name.endswith("gamma"):
            args[name] = rs.uniform(0.5, 1.5, s)
        else:
            args[name] = rs.uniform(-0.1, 0.1, s)
    aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("var")
               else rs.uniform(-0.1, 0.1, s))
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return cast(args), cast(aux)


def _both(make, shape, is_train, seed):
    """The JAX graph function and the port's of the same net, with the
    same seeded parameters (numpy, and the port's tensors)."""
    jnet = make(jvision)
    _, jsym = jnet._get_graph(jmx.nd.zeros(shape))
    args, aux = _draw(jsym, shape, seed)
    tnet = make(tvision)
    tnet.initialize()
    tfn, data_names, targs, taux = functionalize_block(
        tnet, mt.nd.zeros(shape), is_train=is_train)
    assert data_names == ["data"]
    assert sorted(targs) == sorted(args) and sorted(taux) == sorted(aux)
    targs, taux = graph_params_from_numpy(args, aux, "cpu")
    return jax_graph_fn(jsym, is_train=is_train), args, aux, tfn, targs, taux


def test_resnet18_thumbnail_step_matches_jax():
    """resnet18_v1(thumbnail=True) at 2 x 3 x 32^2 in training mode: the
    logits, every parameter's gradient of sum(logits * head) and the new
    running statistics."""
    shape = (2, 3, 32, 32)
    rs = np.random.RandomState(7)
    x = rs.uniform(0, 1, shape).astype(np.float32)
    head = rs.uniform(-1, 1, (2, 10)).astype(np.float32)
    jfn, args, aux, tfn, targs, taux = _both(
        lambda v: v.resnet18_v1(thumbnail=True, classes=10, prefix="r18_"),
        shape, True, 8)

    def jloss(a):
        inp = dict(a)
        inp["data"] = jnp.asarray(x)
        outs, new_aux = jfn(inp, {k: jnp.asarray(v) for k, v in aux.items()},
                            jax.random.PRNGKey(0))
        return jnp.sum(outs[0] * head), (outs[0], new_aux)

    (_, (jlogits, jaux)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in args.items()})

    leaves = {k: v.requires_grad_(True) for k, v in targs.items()}
    inp = dict(leaves)
    inp["data"] = torch.from_numpy(x)
    outs, tnew = tfn(inp, taux)
    tgrads = torch.autograd.grad((outs[0] * torch.from_numpy(head)).sum(),
                                 list(leaves.values()))
    assert _rel_l2(outs[0].detach(), jlogits) < REL_L2
    for (k, _), g in zip(leaves.items(), tgrads):
        assert _rel_l2(g, jgrads[k]) < REL_L2, k
    assert sorted(tnew) == sorted(jaux) == sorted(aux)
    for k in jaux:
        assert _rel_l2(tnew[k], jaux[k]) < REL_L2, k


def test_resnet50_forward_matches_jax():
    """resnet50_v1 in inference mode at 1 x 3 x 64^2."""
    shape = (1, 3, 64, 64)
    x = np.random.RandomState(9).uniform(0, 1, shape).astype(np.float32)
    jfn, args, aux, tfn, targs, taux = _both(
        lambda v: v.resnet50_v1(classes=10, prefix="r50_"), shape, False, 10)
    inp = {k: jnp.asarray(v) for k, v in args.items()}
    inp["data"] = jnp.asarray(x)
    (jlogits,), _ = jax.jit(jfn)(inp, {k: jnp.asarray(v)
                                       for k, v in aux.items()},
                                 jax.random.PRNGKey(0))
    tinp = dict(targs)
    tinp["data"] = torch.from_numpy(x)
    with torch.no_grad():
        (tlogits,), tnew = tfn(tinp, taux)
    assert tnew == {}
    assert tuple(tlogits.shape) == (1, 10)
    assert _rel_l2(tlogits, jlogits) < REL_L2


def test_entry_on_the_cpu():
    """entry() at a small size: fn(args, aux, x) -> logits of
    (batch, 1000), the example input drawn by a seeded generator."""
    fn, (args, aux, x) = entry.entry(batch=2, image_size=32, ctx=mt.cpu())
    assert tuple(x.shape) == (2, 3, 32, 32) and x.device.type == "cpu"
    assert len(args) == 161 and len(aux) == 106
    assert not any(t.requires_grad for t in list(args.values()) +
                   list(aux.values()))
    logits = fn(args, aux, x)
    assert tuple(logits.shape) == (2, 1000)
    assert torch.isfinite(logits).all()
    _, (_, _, x2) = entry.entry(batch=2, image_size=32, ctx=mt.cpu())
    torch.testing.assert_close(x2, x, rtol=0, atol=0)
    # inference mode: the running statistics do not move
    before = {k: v.clone() for k, v in aux.items()}
    fn(args, aux, x)
    assert all(torch.equal(before[k], aux[k]) for k in aux)


def test_entry_needs_a_gpu_by_default():
    with mt.gpu(0):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists: the default context runs")
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            entry.entry(batch=1, image_size=32)
