"""Parity of the port's op registry (``mxnet_tpu_torch.ops``) with the JAX
package's, op by op, for ``ops/elemwise.py``, ``ops/reduce_ops.py`` and
``ops/matrix.py``.

Each op has one parametrised case. Where ``tests/test_op_coverage.py``'s
``CASES`` has a case for the op, its inputs are reused: the case runs
against the JAX ``nd`` with the call to the op recorded, and the same
call is replayed through the port. Every other op takes seeded inputs
from ``OWN`` below. Values, dtypes and shapes are compared at fp32
rtol = atol = 1e-6 unless a case states its own tolerance
(``test_torch_op_grads.py`` holds the gradients of the same cases). The
ties and kinks where torch's own gradient differs from JAX's are pinned
here, and so are JAX's dtypes on integer and bf16 inputs: an integer sum
or product accumulates as ``jnp.sum`` does (bool, int8 and int16 as
int32, uint8 and uint16 as uint32, int32 as int32, wrapping), the ops
JAX computes in floating point promote integers to float32, and an
integer mod by zero is 0. A gate fails if an op of those modules in the
JAX registry is missing from the port's, or has no case.
"""

import numpy as np
import pytest

import test_op_coverage as cov
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu import ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.base import dtype_name
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODULES = ("elemwise", "reduce_ops", "matrix")
# ops/nn.py, ops/optimizer_ops.py, ops/image_ops.py, ops/random_ops.py and
# ops/control_flow_ops.py, each ported whole; their cases are in
# test_torch_nn_ops.py, test_torch_nn_ops_rest.py,
# test_torch_optimizer_ops.py, test_torch_image.py, test_torch_random.py
# and test_torch_control_flow.py
NN_PORTED = {n for n, op in jops._REGISTRY.items()
             if op.fn.__module__.split(".")[-1] in (
                 "nn", "optimizer_ops", "image_ops", "random_ops",
                 "control_flow_ops")}
TOL = (1e-6, 1e-6)                  # (rtol, atol) at fp32


def _jax_ops():
    return sorted(n for n, op in jops._REGISTRY.items()
                  if op.fn.__module__.split(".")[-1] in MODULES)


def U(shape, seed=0, lo=-1.0, hi=1.0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape)).astype(dtype)


def F(values):
    return np.asarray(values, dtype=np.float32)


X34 = U((3, 4), 1)
POS = U((3, 4), 2, 0.2, 2.0)

# op -> (inputs, attrs[, (rtol, atol)]): seeded inputs of the ops that
# test_op_coverage.CASES has no case for
OWN = {
    "BilinearSampler": ([U((1, 2, 4, 5), 3),
                         U((1, 2, 3, 3), 4, -1.1, 1.1)], {}),
    "BlockGrad": ([X34], {}),
    "Cast": ([X34], {"dtype": "bfloat16"}),
    "Concat": ([X34, U((3, 2), 3)], {"dim": 1}),
    "Embedding": ([F([[0, 3], [5, 1]]), U((4, 3), 3)],
                  {"input_dim": 4, "output_dim": 3}),
    "Flatten": ([U((2, 3, 4), 1)], {}),
    "GridGenerator": ([U((2, 6), 5)], {"target_shape": (3, 4)}),
    "L2Normalization": ([U((2, 3, 4), 1)], {"mode": "channel"}),
    "Pad": ([U((1, 2, 3, 4), 1)], {"mode": "reflect",
                                   "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "Reshape": ([U((2, 3, 4), 1)], {"shape": (-1, 0), "reverse": True}),
    "SequenceLast": ([U((4, 3, 2), 1), F([2, 4, 1])],
                     {"use_sequence_length": True}),
    "SequenceMask": ([U((4, 3, 2), 1), F([2, 4, 1])],
                     {"use_sequence_length": True, "value": -1.0}),
    "_arange": ([], {"start": 2.0, "stop": 11.0, "step": 1.5, "repeat": 2}),
    "_contrib_boolean_mask": ([X34, F([1, 0, 1])], {}),
    "_copy": ([X34], {}),
    "_eye": ([], {"N": 3, "M": 5, "k": 1}),
    "_full": ([], {"shape": (2, 3), "value": 2.5}),
    "_identity_with_attr_like_rhs": ([X34, U((3, 4), 2)], {}),
    "_linspace": ([], {"start": -1.0, "stop": 2.0, "num": 7,
                       "endpoint": False}),
    "_ones": ([], {"shape": (2, 3), "dtype": "int32"}),
    "_ravel_multi_index": ([F([[1, 2, 0], [3, 0, 4]])], {"shape": (3, 5)}),
    "_rnn_param_concat": ([U((2, 3), 1), U((4,), 2)], {"dim": 0}),
    "_slice_assign": ([U((4, 5), 1), U((2, 2), 2)],
                      {"begin": (1, 0), "end": (3, 4), "step": (1, 2)}),
    "_slice_assign_scalar": ([U((4, 5), 1)],
                             {"scalar": 7.0, "begin": (0, 1),
                              "end": (4, 3)}),
    "_sparse_retain": ([U((4, 2), 1), F([0, 2])], {}),
    "_split_v2": ([U((6, 4), 1)], {"indices": (0, 1, 4), "axis": 0}),
    "_unravel_index": ([F([7, 3, 14])], {"shape": (3, 5)}),
    "_zeros": ([], {"shape": (2, 3)}),
    "abs": ([X34], {}),
    "arcsinh": ([U((3, 4), 1, -3, 3)], {}),
    "arctan": ([U((3, 4), 1, -3, 3)], {}),
    "argmax": ([U((3, 5), 4)], {"axis": 1, "keepdims": True}),
    "batch_dot": ([U((2, 3, 4), 1), U((2, 5, 4), 2)],
                  {"transpose_b": True}),
    "broadcast_add": ([X34, U((1, 4), 2)], {}),
    "broadcast_axis": ([U((3, 1), 1)], {"axis": 1, "size": 4}),
    "broadcast_div": ([X34, U((3, 1), 2, 0.5, 2.0)], {}),
    "broadcast_hypot": ([X34, U((1, 4), 2)], {}),
    "broadcast_mul": ([X34, U((1, 4), 2)], {}),
    "broadcast_power": ([POS, U((1, 4), 3, -2, 2)], {}),
    "broadcast_sub": ([X34, U((3, 1), 2)], {}),
    "broadcast_to": ([U((3, 1), 1)], {"shape": (0, 4)}),
    "cast_storage": ([X34], {"stype": "default"}),
    "cbrt": ([U((3, 4), 1, -8, 8)], {}),
    "ceil": ([U((3, 4), 1, -3, 3)], {}),
    "clip": ([U((3, 4), 1, -2, 2)], {"a_min": -0.5, "a_max": 0.75}),
    "cos": ([U((3, 4), 1, -3, 3)], {}),
    "degrees": ([X34], {}),
    "depth_to_space": ([U((1, 8, 2, 3), 1)], {"block_size": 2}),
    "dot": ([U((3, 4), 1), U((4, 5), 2)], {"transpose_a": False}),
    "elemwise_add": ([X34, U((3, 4), 2)], {}),
    "erf": ([U((3, 4), 1, -2, 2)], {}),
    "exp": ([U((3, 4), 1, -3, 3)], {}),
    "expand_dims": ([X34], {"axis": -1}),
    "expm1": ([U((3, 4), 1, -2, 2)], {}),
    "fix": ([U((3, 4), 1, -3, 3)], {}),
    "floor": ([U((3, 4), 1, -3, 3)], {}),
    "gamma": ([U((3, 4), 1, 0.3, 4.0)], {}),
    "gammaln": ([U((3, 4), 1, 0.3, 4.0)], {}),
    "histogram": ([U((20,), 1)], {"bins": 5}),
    "isfinite": ([F([1.0, np.inf, -np.inf, np.nan])], {}),
    "isnan": ([F([1.0, np.inf, -np.inf, np.nan])], {}),
    "log": ([POS], {}),
    "log1p": ([POS], {}),
    "make_loss": ([X34], {"grad_scale": 2.0}),
    "max": ([U((2, 3, 4), 1)], {"axis": (0, 2), "keepdims": True}),
    "mean": ([U((2, 3, 4), 1)], {"axis": 1, "exclude": True}),
    "min": ([U((2, 3, 4), 1)], {"axis": 1}),
    "nansum": ([F([[1.0, np.nan, 2.0], [np.nan, 4.0, 0.5]])], {"axis": 0}),
    "negative": ([X34], {}),
    "norm": ([U((2, 3, 4), 1)], {"ord": 2, "axis": (1, 2)}),
    "one_hot": ([F([0, 2, 5, -1])], {"depth": 4, "on_value": 3.0,
                                     "off_value": -1.0}),
    "ones_like": ([X34], {}),
    "pick": ([X34, F([0, 5, -1])], {"axis": 1, "mode": "wrap"}),
    "prod": ([U((2, 3, 4), 1, 0.5, 1.5)], {"axis": (0, 2)}),
    "reciprocal": ([POS], {}),
    "relu": ([X34], {}),
    "repeat": ([U((2, 3), 1)], {"repeats": 2, "axis": 1}),
    "reverse": ([U((2, 3, 4), 1)], {"axis": (0, 2)}),
    "round": ([F([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4, -0.6])], {}),
    "rsqrt": ([POS], {}),
    "shuffle": ([U((6, 3), 1)], {}),
    "sigmoid": ([U((3, 4), 1, -4, 4)], {}),
    "sign": ([F([-2.0, 0.0, 3.0, -0.5])], {}),
    "sin": ([U((3, 4), 1, -3, 3)], {}),
    "slice": ([U((4, 5), 1)], {"begin": (3, 1), "end": (0, 5),
                               "step": (-1, 2)}),
    "slice_axis": ([U((4, 5), 1)], {"axis": 1, "begin": 1, "end": 4}),
    "smooth_l1": ([U((3, 4), 1, -2, 2)], {"scalar": 1.5}),
    "softrelu": ([U((3, 4), 1, -4, 4)], {}),
    "softsign": ([X34], {}),
    "sort": ([U((3, 5), 4)], {"axis": 1, "is_ascend": False}),
    "sqrt": ([POS], {}),
    "square": ([X34], {}),
    "stack": ([X34, U((3, 4), 2)], {"axis": 1}),
    "sum": ([U((2, 3, 4), 1)], {"axis": (0, 2)}),
    "swapaxes": ([U((2, 3, 4), 1)], {"dim1": 0, "dim2": 2}),
    "take": ([X34, F([[0, 2], [1, 0]])], {"axis": 1, "mode": "clip"}),
    "tanh": ([U((3, 4), 1, -3, 3)], {}),
    "tile": ([U((2, 3), 1)], {"reps": (2, 1, 2)}),
    "topk": ([U((3, 5), 4)], {"axis": 1, "k": 2, "ret_typ": "both"}),
    "transpose": ([U((2, 3, 4), 1)], {"axes": (1, 0, 2)}),
    "where": ([F([[1, 0, 1, 0]] * 3), X34, U((3, 4), 2)], {}),
    "zeros_like": ([X34], {}),
}
# ops that compute with transcendental or reordered arithmetic, where
# the two packages' CPU kernels round differently in the last places
LOOSE = {"gamma": (1e-5, 1e-6), "gammaln": (1e-5, 1e-6),
         "erfinv": (1e-5, 1e-6), "BilinearSampler": (1e-5, 1e-6),
         "GridGenerator": (1e-5, 1e-6), "broadcast_power": (1e-5, 1e-6),
         "_rpower_scalar": (1e-5, 1e-6), "_power_scalar": (1e-5, 1e-6),
         "rcbrt": (1e-5, 1e-6), "cbrt": (1e-5, 1e-6)}


class _Recorder:
    """Stands in for the JAX ``nd`` in test_op_coverage and records the
    calls to one op."""

    def __init__(self, name):
        self._name = name
        self.calls = []

    def __getattr__(self, attr):
        fn = getattr(jnd, attr)
        if attr != self._name:
            return fn

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((args, kwargs))
            return out
        return call


def _to_np(v):
    return v.asnumpy() if isinstance(v, (jnd.NDArray, tnd.NDArray)) else v


def _case(name, monkeypatch):
    """(inputs, attrs, tol): inputs are numpy arrays (or None for a
    non-array positional), attrs the op's other arguments."""
    if name in OWN:
        inputs, attrs = OWN[name][:2]
        return list(inputs), dict(attrs), LOOSE.get(name, TOL)
    rec = _Recorder(name)
    monkeypatch.setattr(cov, "nd", rec)
    cov.CASES[name]()
    assert rec.calls, "CASES[%r] never calls nd.%s" % (name, name)
    args, kwargs = rec.calls[0]
    inputs = [_to_np(a) for a in args]
    attrs = {k: _to_np(v) for k, v in kwargs.items()}
    return inputs, attrs, LOOSE.get(name, TOL)


def _call(nd, name, inputs, attrs, ctx):
    args = [nd.array(a, ctx=ctx, dtype=a.dtype)
            if isinstance(a, np.ndarray) else a for a in inputs]
    kw = {k: nd.array(v, ctx=ctx, dtype=v.dtype)
          if isinstance(v, np.ndarray) else v for k, v in attrs.items()}
    if not inputs and "ctx" not in kw and ctx is not None:
        kw["ctx"] = ctx
    return getattr(nd, name)(*args, **kw), args


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jdt(x):
    return np.dtype(x.dtype).name


def _compare(name, jout, tout, tol):
    jouts, touts = _outs(jout), _outs(tout)
    assert len(jouts) == len(touts), name
    for j, t in zip(jouts, touts):
        assert _jdt(j) == dtype_name(t.dtype), (name, _jdt(j), t.dtype)
        assert tuple(j.shape) == tuple(t.shape), (name, j.shape, t.shape)
        np.testing.assert_allclose(t.asnumpy().astype(np.float64),
                                   j.asnumpy().astype(np.float64),
                                   rtol=tol[0], atol=tol[1], err_msg=name)


def _grads(nd, ag, name, inputs, attrs, ctx, cot_seed=11):
    """Gradients of sum(out * cotangent) with respect to each float32
    input; None when the port's output is not differentiable."""
    args = [nd.array(a, ctx=ctx, dtype=a.dtype)
            if isinstance(a, np.ndarray) else a for a in inputs]
    leaves = [a for a, x in zip(args, inputs)
              if isinstance(x, np.ndarray) and x.dtype == np.float32]
    kw = {k: nd.array(v, ctx=ctx, dtype=v.dtype)
          if isinstance(v, np.ndarray) else v for k, v in attrs.items()}
    for a in leaves:
        a.attach_grad()
    with ag.record():
        outs = _outs(getattr(nd, name)(*args, **kw))
    heads = [o for o in outs if o._requires_tape()]
    if not heads:
        return None
    cots = [nd.array(U(o.shape, cot_seed + k), ctx=ctx, dtype=o.dtype)
            for k, o in enumerate(heads)]
    ag.backward(heads, cots)
    return [a.grad.asnumpy() for a in leaves]


def test_gate_every_op_of_the_three_modules_is_ported_and_cased():
    jax_ops = _jax_ops()
    # the nn subset has its cases in test_torch_nn_ops.py
    port = set(tops.list_ops()) - {"_index"} - NN_PORTED
    assert port == set(jax_ops)
    for alias, real in jops._ALIAS.items():
        if real in jax_ops:
            assert tops._ALIAS.get(alias) == real, alias
    uncased = [n for n in jax_ops if n not in OWN and n not in cov.CASES]
    assert not uncased, uncased


def test_gate_other_jax_ops_raise_naming_their_queue_item():
    """Every JAX op outside MODULES, ``ops/nn.py``,
    ``ops/optimizer_ops.py``, ``ops/image_ops.py``, ``ops/random_ops.py``
    and ``ops/control_flow_ops.py`` is queued, and its ``nd`` function,
    its registry entry and a Gluon layer over it raise naming the queue
    item."""
    names = {n for n, op in jops._REGISTRY.items()
             if op.fn.__module__.split(".")[-1] not in MODULES
             and n not in NN_PORTED and n != "_index"}
    names |= {a for a, r in jops._ALIAS.items() if r in names}
    assert names == set(tops._queued.QUEUED)
    assert all(tops.exists(n) for n in NN_PORTED)
    assert {n for n in jops._ALIAS if jops._ALIAS[n] in NN_PORTED} <= \
        set(tops._ALIAS)
    for name, item in (("MultiBoxPrior", "A9"), ("_contrib_quantize", "A9"),
                       ("linalg_gemm2", "A9"), ("_npi_uniform", "A9")):
        with pytest.raises(mt.MXNetError, match=item):
            getattr(tnd, name)(tnd.zeros((2,), ctx=mt.cpu()))
        with pytest.raises(mt.MXNetError, match=item):
            tops.get(name)
    with mt.cpu():
        layer = mt.gluon.nn.HybridLambda(
            lambda F, x: F.linalg_gemm2(x, x))
        layer.initialize()
        with pytest.raises(mt.MXNetError, match="A9"):
            layer(tnd.zeros((1, 2, 3, 3)))


@pytest.mark.parametrize("name", _jax_ops())
def test_op_parity(name, monkeypatch):
    inputs, attrs, tol = _case(name, monkeypatch)
    cpu = mt.cpu()
    if name == "shuffle":
        # torch's and JAX's streams differ: the result is a permutation
        out, _ = _call(tnd, name, inputs, attrs, cpu)
        got = out.asnumpy()
        assert sorted(map(tuple, got)) == sorted(map(tuple, inputs[0]))
        return
    jout, _ = _call(jnd, name, inputs, attrs, None)
    tout, _ = _call(tnd, name, inputs, attrs, cpu)
    _compare(name, jout, tout, tol)


# (op, input, attrs): points where torch's own gradient is not JAX's
KINKS = [
    ("abs", F([0.0, -1.0, 2.0]), {}),
    ("relu", F([0.0, -1.0, 2.0]), {}),
    ("clip", F([-0.5, 0.75, 0.0, 1.0, -1.0]), {"a_min": -0.5,
                                               "a_max": 0.75}),
    # alpha, beta whose products are exact: XLA's fused multiply-add and
    # torch's two roundings land on the same edge
    ("hard_sigmoid", F([-2.0, 2.0, 0.0]), {"alpha": 0.25, "beta": 0.5}),
    ("_maximum_scalar", F([0.5, 0.0, 1.0]), {"scalar": 0.5}),
    ("_minimum_scalar", F([0.5, 0.0, 1.0]), {"scalar": 0.5}),
    ("max", F([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]]), {"axis": 1}),
    ("min", F([[1.0, 1.0, 3.0], [2.0, 2.0, 2.0]]), {}),
    ("smooth_l1", F([0.0, 1.0, -1.0]), {"scalar": 1.0}),
]


@pytest.mark.parametrize("name, x, attrs", KINKS, ids=[k[0] for k in KINKS])
def test_gradient_at_ties_and_kinks_follows_jax(name, x, attrs):
    want = _grads(jnd, jag, name, [x], attrs, None)
    got = _grads(tnd, tag, name, [x], attrs, mt.cpu())
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("name", ["broadcast_maximum", "broadcast_minimum"])
def test_binary_extremum_splits_a_tie(name):
    a, b = F([[1.0, 2.0, 3.0]]), F([[1.0], [2.0]])
    for nd, ag, ctx in ((jnd, jag, None), (tnd, tag, mt.cpu())):
        xa, xb = nd.array(a, ctx=ctx), nd.array(b, ctx=ctx)
        xa.attach_grad()
        xb.attach_grad()
        with ag.record():
            y = getattr(nd, name)(xa, xb)
        y.backward()
        if nd is jnd:
            want = (xa.grad.asnumpy(), xb.grad.asnumpy())
        else:
            got = (xa.grad.asnumpy(), xb.grad.asnumpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0.5 in got[0]


def test_mod_is_floor_mod_and_round_is_half_even():
    a, b = F([-7.0, 7.0, -7.5, 7.5, 0.0]), F([3.0, -3.0, 2.0, -2.0, 3.0])
    with mt.cpu():
        got = tnd.broadcast_mod(tnd.array(a), tnd.array(b)).asnumpy()
        np.testing.assert_array_equal(got, np.mod(a, b))
        np.testing.assert_array_equal(
            got, jnd.broadcast_mod(jnd.array(a), jnd.array(b)).asnumpy())
        r = F([0.5, 1.5, 2.5, -0.5, -2.5])
        np.testing.assert_array_equal(tnd.round(tnd.array(r)).asnumpy(),
                                      F([0.0, 2.0, 2.0, -0.0, -2.0]))


def test_infer_shape_runs_on_meta_tensors():
    import torch
    (shape, dtype), = tops.infer_shape("dot", ((8, 3), torch.float32),
                                       ((3, 5), torch.float32))
    assert shape == (8, 5) and dtype == torch.float32
    (shape, dtype), = tops.infer_shape("argmax", ((4, 6), torch.float32),
                                       axis=1)
    assert shape == (4,) and dtype == torch.float32


def _narrow(dtype, seed):
    """[4, 100] of one narrow integer (or bool) dtype: its largest
    positive value then seeded values, so sums and products overflow the
    input type."""
    if dtype == "bool":
        x = np.random.RandomState(seed).rand(4, 100) > 0.3
        x[0] = True
        return x
    info = np.iinfo(dtype)
    x = np.random.RandomState(seed).randint(info.min, info.max + 1,
                                             (4, 100), dtype=np.int64)
    x[0] = info.max
    return x.astype(dtype)


@pytest.mark.parametrize("name", ["sum", "prod", "nansum"])
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16",
                                   "bool"])
@pytest.mark.parametrize("axis", [1, None])
def test_narrow_integer_reduction_accumulates_as_jax(name, dtype, axis):
    """Narrow integer and bool sums and products take JAX's dtype and
    its exact (wrapped 32-bit) value."""
    x = _narrow(dtype, seed=len(name) + 7 * len(dtype))
    jout, _ = _call(jnd, name, [x], {"axis": axis}, None)
    tout, _ = _call(tnd, name, [x], {"axis": axis}, mt.cpu())
    assert dtype_name(tout.dtype) == _jdt(jout)
    assert _jdt(jout) in ("int32", "uint32")
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())


I32 = np.arange(-5, 7, dtype=np.int32).reshape(3, 4)
# (op, inputs, attrs): integer inputs to float-valued ops, JAX's integer
# mod by zero, and the dtypes GridGenerator and histogram return
INT_CASES = [
    ("moments", [I32], {"axes": (1,)}),
    ("broadcast_hypot", [I32, I32[:, :1]], {}),
    ("_hypot_scalar", [I32], {"scalar": 2.5}),
    ("softrelu", [I32], {}),
    ("rint", [I32], {}),
    ("broadcast_mod", [np.array([[5, -7, 0], [3, 4, -2]], np.int32),
                       np.array([[0, 2, 3], [-2, 0, 5]], np.int32)], {}),
    ("_mod_scalar", [I32], {"scalar": 0}),
    ("_rmod_scalar", [I32], {"scalar": 3}),
    ("GridGenerator", [np.arange(12, dtype=np.int32).reshape(2, 6)],
     {"target_shape": (3, 4)}),
    ("GridGenerator", [U((2, 6), 5)], {"target_shape": (3, 4), "bf16": 1}),
    ("histogram", [U((40,), 6, -1.3, 2.7)], {"bins": 5, "bf16": 1}),
    ("histogram", [I32], {"bins": 3}),
]


@pytest.mark.parametrize("name, inputs, attrs", INT_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(INT_CASES)])
def test_integer_and_bf16_inputs_take_jax_dtypes(name, inputs, attrs):
    """JAX's output dtypes, and its values at the fp32 tolerance; bf16
    histogram edges within one bf16 ulp (2^-7 of a value): JAX rounds its
    linspace to bf16 after each operation, the port once."""
    attrs = dict(attrs)
    if attrs.pop("bf16", 0):
        inputs = [jnd.array(x).astype("bfloat16").asnumpy() for x in inputs]
    jout, _ = _call(jnd, name, inputs, attrs, None)
    tout, _ = _call(tnd, name, inputs, attrs, mt.cpu())
    if name == "histogram" and _jdt(inputs[0]) == "bfloat16":
        (jc, je), (tc, te) = jout, tout
        assert (_jdt(je), dtype_name(te.dtype)) == ("bfloat16", "bfloat16")
        np.testing.assert_array_equal(tc.asnumpy(), jc.asnumpy())
        np.testing.assert_allclose(te.asnumpy().astype(np.float64),
                                   je.asnumpy().astype(np.float64),
                                   rtol=2.0 ** -7, atol=0)
        return
    _compare(name, jout, tout, TOL)


@pytest.mark.parametrize("name", ["sum", "mean", "prod", "max", "min",
                                  "nansum", "nanprod"])
def test_reduce_excluding_every_axis_reduces_nothing(name):
    """``exclude=True`` over every axis leaves no axis to reduce: the
    value comes back as it is (the batch-wise mean of a 1-d loss), as in
    JAX; torch reads an empty dim list as every axis."""
    x = U((4,), 3)
    for keepdims in (False, True):
        want = getattr(jnd, name)(jnd.array(x), axis=0, exclude=True,
                                  keepdims=keepdims)
        with mt.cpu():
            got = getattr(tnd, name)(tnd.array(x), axis=0, exclude=True,
                                     keepdims=keepdims)
        assert got.shape == want.shape == (4,)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
