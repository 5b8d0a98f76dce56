"""The port's ``rtc`` (B6) on the CPU: ``PallasModule``'s ref-body route
(its plain version) against the JAX package's, the slice as a whole at a
small size, and everything of ``CudaModule``/``CudaKernel`` that runs
before a launch: the signature parser, the argument checks and the
buffer a written argument gets. The CUDA and Triton routes themselves run
on the card, in ``chip_smoke.py``'s rtc phase."""

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu import rtc as jrtc

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import rtc
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def saxpy_kernel(x_ref, y_ref, o_ref):
    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]


def test_saxpy_ref_body_in_both_packages():
    """tests/test_kernels.py's saxpy body, unchanged, through both
    packages' PallasModule."""
    x = np.arange(8.0, dtype=np.float32)
    y = np.ones(8, dtype=np.float32)
    jmod = jrtc.PallasModule(saxpy=(
        saxpy_kernel, lambda a, b: jax.ShapeDtypeStruct(a.shape, a.dtype)))
    want = jmod.get_kernel("saxpy").launch([jnd.array(x), jnd.array(y)])
    tmod = rtc.PallasModule(saxpy=(
        saxpy_kernel, lambda a, b: rtc.ShapeDtypeStruct(a.shape, a.dtype)))
    before = dict(kernels.launches)
    got = tmod.get_kernel("saxpy").launch([tnd.array(x), tnd.array(y)])
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), 2.0 * x + 1.0)
    assert dict(kernels.launches) == before     # the plain version


LR, MOMENTUM = 0.5, 0.9


def momentum_body(w_ref, m_ref, g_ref, w_out, m_out):
    """sgd_mom_update at wd 0 as a ref body: the same code in both
    packages."""
    m = MOMENTUM * m_ref[...] - LR * g_ref[...]
    m_out[...] = m
    w_out[...] = w_ref[...] + m


def _head_steps(nd, ag, rtc_mod, shape_struct, h, w0, labels, steps=3):
    """The rtc slice at a small size: the head's loss through nd and
    autograd, its gradient, and the momentum update as a ref body."""
    mod = rtc_mod.PallasModule(upd=(momentum_body, lambda w, m, g: [
        shape_struct(w.shape, w.dtype), shape_struct(m.shape, m.dtype)]))
    w, mom = nd.array(w0), nd.zeros(w0.shape)
    w.attach_grad()
    out = []
    for _ in range(steps):
        with ag.record():
            logits = nd.dot(nd.array(h), w)
            top = nd.max(logits, axis=1, keepdims=True)
            lse = nd.log(nd.sum(nd.exp(logits - top), axis=1,
                                keepdims=True)) + top
            loss = nd.mean(lse.reshape((-1,))
                           - nd.pick(logits, nd.array(labels), axis=1))
        loss.backward()
        new_w, new_mom = mod.get_kernel("upd").launch([w, mom, w.grad])
        out.append((float(loss.asscalar()), w.grad.asnumpy().copy(),
                    np.asarray(new_w).copy()))
        w = nd.array(np.asarray(new_w))
        w.attach_grad()
        mom = nd.array(np.asarray(new_mom))
    return out


def test_slice_as_a_whole_at_a_small_size():
    rs = np.random.RandomState(4)
    h = rs.randn(16, 8).astype(np.float32)
    w0 = (rs.randn(8, 12) / np.sqrt(8)).astype(np.float32)
    labels = rs.randint(0, 12, 16).astype(np.int32)
    want = _head_steps(jnd, jag, jrtc, jax.ShapeDtypeStruct, h, w0, labels)
    got = _head_steps(tnd, tag, rtc, rtc.ShapeDtypeStruct, h, w0, labels)
    for (lj, gj, wj), (lt, gt, wt) in zip(want, got):
        assert abs(lj - lt) <= 1e-5 * abs(lj)
        np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-6)
    assert got[-1][0] < got[0][0]


def test_pallas_module_errors():
    mod = rtc.PallasModule(saxpy=(
        saxpy_kernel, lambda a, b: rtc.ShapeDtypeStruct(a.shape, a.dtype)))
    kern = mod.get_kernel("saxpy")
    args = [tnd.ones((4,)), tnd.ones((4,))]
    with pytest.raises(mt.MXNetError, match="block_dims"):
        kern.launch(args, block_dims=(32, 1, 1))
    with pytest.raises(mt.MXNetError, match="shared_mem"):
        kern.launch(args, shared_mem=1024)
    with pytest.raises(mt.MXNetError, match="grid"):
        kern.launch(args, grid_dims=(2,))
    with pytest.raises(mt.MXNetError, match="not found"):
        mod.get_kernel("nope")

    # a ref body is the plain version: on tensors off the host (meta
    # tensors stand in for CUDA ones here) it raises, as no kernel would run
    def body(x_ref, y_ref, o_ref):
        raise AssertionError("a ref body ran on tensors off the host")
    off = rtc.PallasModule(k=(body, lambda a, b:
                              rtc.ShapeDtypeStruct(a.shape, a.dtype)))
    meta = [torch.ones(4, device="meta"), torch.ones(4, device="meta")]
    with pytest.raises(mt.MXNetError, match="CPU tensors only"):
        off.get_kernel("k").launch(meta)

    class JITFunction:      # what @triton.jit makes, by its module
        __module__ = "triton.runtime.jit"

        def __getitem__(self, grid):
            raise AssertionError("a Triton body ran on CPU tensors")

    tri = rtc.PallasModule(k=(JITFunction(), lambda a, b:
                              rtc.ShapeDtypeStruct(a.shape, a.dtype)))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        tri.get_kernel("k").launch(args, grid_dims=(1,))


def test_cuda_signature_parser():
    assert rtc.parse_signature("const float *x, float *y, float alpha") == [
        (True, True, "float"), (True, False, "float"),
        (False, False, "float")]
    assert rtc.parse_signature(
        "const __half* a,int8_t *b, int64_t n, char c,double d") == [
        (True, True, "__half"), (True, False, "int8_t"),
        (False, False, "int64_t"), (False, False, "char"),
        (False, False, "double")]
    for bad in ("float x y", "const, float *x", "long *x", "float **x"):
        with pytest.raises(mt.MXNetError):
            rtc.parse_signature(bad)


def test_cuda_module_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="CUDA device"):
        rtc.CudaModule("__global__ void k(){}")


def test_cuda_kernel_argument_checks_and_a_written_argument_owns_its_buffer():
    kern = rtc.CudaKernel(None, "axpy",
                          rtc.parse_signature("const float *x, float *y, "
                                              "float alpha, int n"))
    x, y = tnd.ones((4,)), tnd.zeros((4,))
    ctx = mt.cpu()
    with pytest.raises(mt.MXNetError, match="GPU"):
        kern.launch([x, y, 2.0, 4], ctx, (1, 1, 1), (4, 1, 1))
    with pytest.raises(mt.MXNetError, match="expects 4 arguments"):
        kern._marshal([x, y, 2.0], ctx)
    with pytest.raises(mt.MXNetError, match="float32"):
        kern._marshal([tnd.ones((4,), dtype="int32"), y, 2.0, 4], ctx)
    with pytest.raises(mt.MXNetError, match="NDArray"):
        kern._marshal([x, 3.0, 2.0, 4], ctx)
    with pytest.raises(mt.MXNetError, match="number"):
        kern._marshal([x, y, x, 4], ctx)
    with pytest.raises(mt.MXNetError, match="lies on"):
        kern._marshal([x, y, 2.0, 4], mt.Context("cpu", 1))
    with pytest.raises(mt.MXNetError, match="3 positive"):
        rtc._dims((4, 1), "grid_dims")

    src = tnd.array(np.arange(8, dtype=np.float32))
    view = src.reshape((2, 4))
    held = kern._marshal([x, view, np.float32(2.0), 8], ctx)
    assert held[2][1].value == 2.0 and held[3][1].value == 8
    written = held[1][0]
    assert written.data_ptr() == held[1][1].value == view._data.data_ptr()
    written.add_(1.0)                      # what the kernel would write
    np.testing.assert_array_equal(src.asnumpy(), np.arange(8))
    np.testing.assert_array_equal(view.asnumpy().reshape(-1),
                                  np.arange(8) + 1)
    half = rtc.CudaKernel(None, "h", rtc.parse_signature("__half a"))
    (_, value), = half._marshal([1.5], ctx)
    assert value.value == np.float16(1.5).view(np.uint16)

    # integer scalars: whole numbers inside the C type's range only
    (_, n), = rtc.CudaKernel(None, "n", rtc.parse_signature("int n"))._marshal(
        [np.float32(8.0)], ctx)
    assert n.value == 8
    for sig, bad in (("int n", 2 ** 31), ("int32_t n", -2 ** 31 - 1),
                     ("uint8_t n", -1), ("int8_t n", 128),
                     ("int64_t n", 2 ** 63)):
        with pytest.raises(mt.MXNetError, match="range"):
            rtc.CudaKernel(None, "n", rtc.parse_signature(sig))._marshal(
                [bad], ctx)
    with pytest.raises(mt.MXNetError, match="whole number"):
        rtc.CudaKernel(None, "n", rtc.parse_signature("int n"))._marshal(
            [4.5], ctx)

    # half pointers: float16 requests make bfloat16 here
    bf = tnd.array(np.ones(4, dtype=np.float16), dtype="float16")
    assert bf.dtype == "bfloat16" and bf._data.dtype == torch.bfloat16
    with pytest.raises(mt.MXNetError, match="__nv_bfloat16"):
        rtc.CudaKernel(None, "h", rtc.parse_signature(
            "const __half *x"))._marshal([bf], ctx)
    with pytest.raises(mt.MXNetError, match="float32 here"):
        rtc.CudaKernel(None, "d", rtc.parse_signature(
            "const double *x"))._marshal([x], ctx)
    (t, ptr), (_, s) = rtc.CudaKernel(None, "b", rtc.parse_signature(
        "const __nv_bfloat16 *x, __nv_bfloat16 s"))._marshal([bf, 1.5], ctx)
    assert t.dtype == torch.bfloat16 and ptr.value == t.data_ptr()
    assert s.value == 0x3FC0             # bf16 bits of 1.5
