"""The port's training flash attention held against the JAX package, on
the CPU.

On CPU tensors ``flash_attention`` and its backward run their plain
versions (``dense_attention_with_lse``, ``dense_attention_bwd``); these
tests hold them, and the ``_FlashAttention`` autograd wiring around
them, against the JAX package's Pallas flash kernels run in interpret
mode, as ``tests/test_kernels.py`` runs them, and against ``jax.grad``.
The CUDA kernels are held against the same plain versions on the GPU by
``chip_smoke.py``.

Tolerances: fp32 at rtol 2e-4 / atol 2e-5, the bound the JAX package's
own flash backward test uses (the same fp32 products summed in another
order); lse at atol 1e-5 (fp32, values ~4 here).
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.kernels import common as jax_common
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

fa = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
jax_flash = importlib.import_module("mxnet_tpu.kernels.flash_attention")

RTOL, ATOL = 2e-4, 2e-5


def _inputs(seed, b, tq, tk, h, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(dtype) for t in (tq, tk, tk)]


def _bh(x):
    """[B, T, H, D] numpy -> [B*H, T, D]."""
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _t(x, requires_grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(requires_grad)


# (causal, tq, tk, block_q, block_k) of the JAX kernel: causal square
# lengths (the training shape's class), and non-causal cross lengths
# (the gradient check below adds causal cross lengths). Every test uses
# these shapes at B = H = 2, D = 16, so the interpret-mode kernels compile
# once per case for the whole file.
CASES = [(True, 64, 64, 16, 16), (False, 32, 96, 16, 32)]


@pytest.mark.parametrize("causal, tq, tk, bq, bk", CASES)
def test_forward_and_lse_match_jax_kernel(causal, tq, tk, bq, bk):
    q, k, v = (_bh(x) for x in _inputs(0, 2, tq, tk, 2, 16))
    jo, jlse = jax_flash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, bq, bk, True)
    o, lse = fa.dense_attention_with_lse(_t(q), _t(k), _t(v), causal)
    assert o.dtype == torch.float32 and lse.shape == (4, tq)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=0, atol=1e-5)
    # on CPU tensors the wrapper is its plain version
    o2, lse2 = fa.flash_attention_with_lse(_t(q), _t(k), _t(v), causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("causal, tq, tk, bq, bk", CASES)
def test_backward_matches_jax_kernel(causal, tq, tk, bq, bk):
    """dense_attention_bwd against the Pallas dQ and dK/dV kernels on the
    same (q, k, v, o, lse, dO)."""
    q, k, v = (_bh(x) for x in _inputs(1, 2, tq, tk, 2, 16))
    do = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    o, lse = fa.dense_attention_with_lse(_t(q), _t(k), _t(v), causal)
    lanes = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                             lse.shape + (jax_common.STAT_LANES,))
    want = jax_flash._flash_bwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(o.numpy()),
                                lanes, jnp.asarray(do), causal, bq, bk, True)
    got = fa.dense_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _dense_jax(q, k, v, causal):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = jnp.arange(tq)[:, None] >= jnp.arange(tk)[None, :]
        s = jnp.where(mask[None, None], s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("causal, tq, tk, bq, bk", CASES)
def test_autograd_matches_jax_grad(causal, tq, tk, bq, bk):
    """flash_attention over [B, T, H, D] and its gradients through
    _FlashAttention against jax.grad through dense attention, for the
    loss sum(o * cos(o)). (tests/test_torch_training.py holds the same
    autograd function against jax.grad through the JAX package's
    flash_attention, its custom vjp over the Pallas kernels, inside the
    model.)"""
    q, k, v = _inputs(3, 2, tq, tk, 2, 16)
    tq_, tk_, tv_ = (_t(x, True) for x in (q, k, v))
    out = fa.flash_attention(tq_, tk_, tv_, causal=causal)
    (out * torch.cos(out)).sum().backward()
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    # jax.grad of sum(o cos o), as a vjp with d/do = cos o - o sin o
    want_o, vjp = jax.vjp(jax.jit(lambda a, b, c: _dense_jax(a, b, c,
                                                             causal)), *args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=RTOL, atol=ATOL)
    grads = vjp(jnp.cos(want_o) - want_o * jnp.sin(want_o))
    for name, g, w in zip("qkv", (tq_, tk_, tv_), grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="d" + name)


def test_bf16_matches_jax_kernel():
    """bfloat16 in, through both forwards: each upcasts to fp32,
    computes, and rounds o to bf16 once, so the two may land one bf16 ulp
    apart where their fp32 sums differ in the last bits: rtol 2^-7 (one
    ulp is at most 2^-7 of a value), atol 1e-4 for values near zero; lse
    stays fp32 (atol 1e-5)."""
    q, k, v = (_bh(x) for x in _inputs(4, 2, 64, 64, 2, 16))
    jo, jlse = jax_flash._flash_fwd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, 16, 16,
        True)
    o, lse = fa.dense_attention_with_lse(*(_t(x).bfloat16()
                                           for x in (q, k, v)), True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal, tq, tk", [(False, 5, 7), (True, 6, 6),
                                            (True, 7, 4)])
def test_gradcheck_float64(causal, tq, tk):
    """The flash backward's formulas (P from the saved lse, delta from
    the saved o) are the gradient of the forward: torch.autograd.gradcheck
    of _FlashAttention in float64 at a tiny size."""
    rng = np.random.RandomState(6)
    args = [torch.from_numpy(rng.randn(3, t, 4)).requires_grad_(True)
            for t in (tq, tk, tk)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, causal), args)


def test_kernel_entries_refuse_what_they_do_not_take():
    """The kernel entries never fall back to the plain version: a head
    dim or dtype the kernels are not built for, or a CPU tensor handed
    straight to a backward kernel, raises."""
    x = torch.zeros(2, 8, 64)
    stats = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_bwd_dq(x, x, x, x, stats, stats, True)
    with pytest.raises(ValueError, match="D in"):
        fa._check_flash_inputs((torch.zeros(2, 8, 32),))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_flash_inputs((torch.zeros(2, 8, 64, dtype=torch.float16),))
    with pytest.raises(ValueError, match="q must be"):
        fa.flash_attention_with_lse(x, torch.zeros(2, 8, 32), x)
