"""Runtime-compiled kernels (port of ``mxnet_tpu/rtc.py``; kernel B6).

The JAX package's ``PallasModule.get_kernel().launch`` (``rtc.py:63``)
wraps a user's kernel body in ``pl.pallas_call``; its ``CudaModule`` is
a stub, as a TPU has no NVRTC. On the GPU both launchers are real:

``CudaModule(source, options, exports)`` is upstream MXNet's
``mx.rtc.CudaModule``: CUDA C++ source compiled at runtime by NVRTC to a
cubin for the device (``sm_90a`` on an H100), loaded once per device
through libcuda (``cuModuleLoadData``) and launched with
``cuLaunchKernel`` on PyTorch's current stream, so that a launch is
ordered with torch's work. ``get_kernel(name, signature)`` takes a C
parameter list (``"const float *x, float *y, float alpha"``); template
kernels are named through ``exports`` (``"axpy<float>"``). Argument
count, dtypes and a GPU context are checked before a launch, and every
failure raises ``MXNetError``, an NVRTC compile error with NVRTC's log.
Both libraries are bound with ``ctypes``: ``libnvrtc`` from
``$CUDA_HOME/lib64`` or PyTorch's ``nvidia/cuda_nvrtc/lib``, and
``libcuda.so.1``. A ``const`` pointer is read-only to the
kernel; a pointer without ``const`` may be written, so its NDArray is
first given a buffer of its own (``NDArray._own_buffer``): a write never
shows through another NDArray. NVRTC contracts ``a*x+y`` into an FMA by
default, so a kernel's result may differ from torch's in the last bit.

``PallasModule(name=(kernel_fn, out_shape_fn))`` keeps the JAX API.
``out_shape_fn(*args)`` returns a ``ShapeDtypeStruct`` or a list of
them; the outputs are allocated fresh on the inputs' device, and
``launch`` returns them as tensors, as ``pallas_call`` returns arrays.
The body is either

  * a ``@triton.jit`` function, called as ``kernel_fn[grid](*args,
    *outputs)`` with ``grid_dims`` (default ``(1,)``) as the grid; it
    runs on CUDA tensors only, and raises for CPU ones; or
  * a Pallas-style body over whole-array refs (``o_ref[...] =
    2.0 * x_ref[...]``), called with the tensors themselves: the plain
    version, which runs on CPU tensors only, raises for CUDA ones (no
    kernel would run) and takes no grid.

Every launch of a CUDA or Triton kernel adds one to
``kernels.launches["rtc:<name>"]``. Nothing here imports ``triton`` or
loads NVRTC before a kernel is built.
"""

import ctypes
import glob
import os
import re
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .kernels._build import launches
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "ShapeDtypeStruct"]

# C type -> (NDArray dtype, ctypes type of a scalar argument); the table
# of upstream python/mxnet/rtc.py, plus __nv_bfloat16 (cuda_bf16.h), the
# type a float16 request makes here; half types pass their 16 bits
_DTYPE_CPP = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}
# (pointer type, the dtype the port makes instead) -> (why, what to declare)
_NARROWED = {
    ("__half", torch.bfloat16): ("a float16 request makes bfloat16 here",
                                 "__nv_bfloat16 * (cuda_bf16.h)"),
    ("double", torch.float32): ("a float64 request makes float32 here",
                                "float *"),
}
_ARG_RE = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
_SHARED_DEFAULT = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_LOCK = threading.Lock()
_LIBS = {}


def parse_signature(signature):
    """[(is_pointer, is_const, C type)] of a C parameter list."""
    params = []
    for arg in signature.split(","):
        m = _ARG_RE.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError("invalid kernel signature %r at %r"
                             % (signature, arg))
        is_const, ctype, pointer, _ = m.groups()
        if ctype not in _DTYPE_CPP:
            raise MXNetError("unsupported kernel argument type %r; the "
                             "types are %s" % (ctype, ", ".join(_DTYPE_CPP)))
        params.append((pointer is not None, is_const is not None, ctype))
    return params


# ------------------------------------------------------------ libraries --
def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _open_first(patterns, what):
    for pattern in patterns:
        for path in sorted(glob.glob(pattern), reverse=True):
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    raise MXNetError("%s not found (looked for %s)"
                     % (what, ", ".join(patterns)))


def _bind(lib, name, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def _nvrtc():
    """The NVRTC library, bound: $CUDA_HOME/lib64, then PyTorch's own
    nvidia/cuda_nvrtc/lib."""
    with _LOCK:
        if "nvrtc" in _LIBS:
            return _LIBS["nvrtc"]
        torch_nvidia = os.path.join(os.path.dirname(os.path.dirname(
            torch.__file__)), "nvidia", "cuda_nvrtc", "lib")
        lib = _open_first([os.path.join(_cuda_home(), "lib64", "libnvrtc.so*"),
                           os.path.join(torch_nvidia, "libnvrtc.so*")],
                          "libnvrtc (NVRTC, the CUDA runtime compiler)")
        p, vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.POINTER(ctypes.c_size_t)
        cp = ctypes.c_char_p
        _bind(lib, "nvrtcGetErrorString", [ctypes.c_int], cp)
        _bind(lib, "nvrtcCreateProgram",
              [vp, cp, cp, ctypes.c_int, p, p])
        _bind(lib, "nvrtcAddNameExpression", [p, cp])
        _bind(lib, "nvrtcCompileProgram",
              [p, ctypes.c_int, ctypes.POINTER(cp)])
        _bind(lib, "nvrtcGetProgramLogSize", [p, sz])
        _bind(lib, "nvrtcGetProgramLog", [p, cp])
        _bind(lib, "nvrtcGetLoweredName", [p, cp, ctypes.POINTER(cp)])
        _bind(lib, "nvrtcGetCUBINSize", [p, sz])
        _bind(lib, "nvrtcGetCUBIN", [p, cp])
        _bind(lib, "nvrtcDestroyProgram", [vp])
        _LIBS["nvrtc"] = lib
        return lib


def _libcuda():
    """libcuda.so.1, bound."""
    with _LOCK:
        if "cuda" in _LIBS:
            return _LIBS["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as exc:
            raise MXNetError("libcuda.so.1 is not loadable: %s" % exc)
        p, vp, u = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.c_uint
        _bind(lib, "cuInit", [u])
        _bind(lib, "cuGetErrorString",
              [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)])
        _bind(lib, "cuDeviceGet", [ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_int])
        _bind(lib, "cuDevicePrimaryCtxRetain", [vp, ctypes.c_int])
        _bind(lib, "cuCtxGetCurrent", [vp])
        _bind(lib, "cuCtxSetCurrent", [p])
        _bind(lib, "cuModuleLoadData", [vp, p])
        _bind(lib, "cuModuleGetFunction", [vp, p, ctypes.c_char_p])
        _bind(lib, "cuFuncSetAttribute", [p, ctypes.c_int, ctypes.c_int])
        _bind(lib, "cuLaunchKernel", [p, u, u, u, u, u, u, u, p, vp, vp])
        _LIBS["cuda"] = lib
        return lib


def _check_nvrtc(lib, status, what):
    if status != 0:
        raise MXNetError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(status).decode()))


def _check_cuda(lib, status, what):
    if status != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(status, ctypes.byref(msg))
        raise MXNetError("%s failed: CUDA error %d (%s)" % (
            what, status, msg.value.decode() if msg.value else "unknown"))


_PRIMARY = {}


def _make_current(lib, device_index):
    """Make the device's primary context (the one PyTorch uses) current
    on this thread."""
    torch.cuda.init()
    want = _PRIMARY.get(device_index)
    if want is None:
        _check_cuda(lib, lib.cuInit(0), "cuInit")
        dev = ctypes.c_int()
        _check_cuda(lib, lib.cuDeviceGet(ctypes.byref(dev), device_index),
                    "cuDeviceGet")
        want = ctypes.c_void_p()
        _check_cuda(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(want),
                                                      dev.value),
                    "cuDevicePrimaryCtxRetain")
        _PRIMARY[device_index] = want
    cur = ctypes.c_void_p()
    _check_cuda(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)),
                "cuCtxGetCurrent")
    if cur.value != want.value:
        _check_cuda(lib, lib.cuCtxSetCurrent(want), "cuCtxSetCurrent")


def _arch(device_index):
    major, minor = torch.cuda.get_device_capability(device_index)
    # the "a" targets (sm_90a, ...) carry the architecture's own features
    return "sm_%d%d%s" % (major, minor, "a" if major >= 9 else "")


def _compile(source, options, exports, arch):
    """(cubin bytes, {export: lowered name}) of ``source``."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
        opts = ["--gpu-architecture=" + arch]
        include = os.path.join(_cuda_home(), "include")
        if os.path.isdir(include):
            opts.append("--include-path=" + include)
        opts += list(options)
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        status = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        size = ctypes.c_size_t()
        if status != 0:
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value + 1)
            lib.nvrtcGetProgramLog(prog, log)
            log = log.value.decode(errors="replace")
            raise MXNetError("CudaModule: NVRTC could not compile the "
                             "source (%s, options %s):\n%s" % (
                                 lib.nvrtcGetErrorString(status).decode(),
                                 opts, log))
        lowered = {}
        for name in exports:
            low = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(low)),
                "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = low.value.decode()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


# ------------------------------------------------------------ CudaModule --
class CudaModule:
    """CUDA C++ source compiled at runtime with NVRTC (upstream
    ``mx.rtc.CudaModule``).

    ``source`` is the module's source; ``options`` are extra NVRTC
    options (``--gpu-architecture`` is the device's, ``sm_90a`` on an
    H100); ``exports`` are the name expressions of template kernels,
    such as ``"axpy<float>"``. A kernel that is not a template is
    declared ``extern "C"``. Raises ``MXNetError`` without a CUDA
    device, without NVRTC, or when the source does not compile."""

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule needs a CUDA device: NVRTC compiles "
                             "for the GPU, and there is none")
        options = (options,) if isinstance(options, str) else tuple(options)
        self._exports = (exports,) if isinstance(exports, str) \
            else tuple(exports)
        device = torch.cuda.current_device()
        self.arch = _arch(device)
        start = time.perf_counter()
        self._cubin, self._lowered = _compile(
            source, options, self._exports, self.arch)
        self.compile_seconds = time.perf_counter() - start
        self._modules = {}       # device index -> CUmodule
        self._functions = {}     # (device index, name) -> [CUfunction, smem]
        self._lock = threading.Lock()

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with the C parameter list ``signature``."""
        return CudaKernel(self, name, parse_signature(signature))

    def _function(self, device_index, name):
        key = (device_index, name)
        with self._lock:
            entry = self._functions.get(key)
            if entry is not None:
                return entry
            lib = _libcuda()
            _make_current(lib, device_index)
            module = self._modules.get(device_index)
            if module is None:
                module = ctypes.c_void_p()
                _check_cuda(lib, lib.cuModuleLoadData(
                    ctypes.byref(module), self._cubin), "cuModuleLoadData")
                self._modules[device_index] = module
            fn = ctypes.c_void_p()
            symbol = self._lowered.get(name, name)
            _check_cuda(lib, lib.cuModuleGetFunction(
                ctypes.byref(fn), module, symbol.encode()),
                "cuModuleGetFunction(%s)" % symbol)
            entry = self._functions[key] = [fn, _SHARED_DEFAULT]
            return entry


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1:
        raise MXNetError("%s must be 3 positive integers, got %r"
                         % (what, dims))
    return dims


_INT_TYPES = {ctypes.c_uint8, ctypes.c_int8, ctypes.c_int32, ctypes.c_int64}


def _integral(arg, ctype, scalar, i, name):
    """``arg`` as a Python int, checked against the range of ``ctype``:
    ctypes would wrap an out-of-range value without a word."""
    if isinstance(arg, (float, np.floating)):
        if not float(arg).is_integer():
            raise MXNetError("argument %d of %s is a %s, so it must be a "
                             "whole number, not %r" % (i, name, ctype, arg))
    elif not isinstance(arg, (int, np.integer)):
        raise MXNetError("argument %d of %s is a %s, so it must be an "
                         "integer, not %s" % (i, name, ctype, type(arg)))
    value = int(arg)
    bits = 8 * ctypes.sizeof(scalar)
    lo, hi = (0, 2 ** bits - 1) if scalar is ctypes.c_uint8 else \
        (-2 ** (bits - 1), 2 ** (bits - 1) - 1)
    if not lo <= value <= hi:
        raise MXNetError("argument %d of %s is a %s, whose range is "
                         "[%d, %d]; %d is outside it"
                         % (i, name, ctype, lo, hi, value))
    return value


class CudaKernel:
    """A kernel of a ``CudaModule`` (upstream ``mx.rtc.CudaKernel``)."""

    def __init__(self, module, name, params):
        self._module = module
        self._name = name
        self._params = params

    def _marshal(self, args, ctx):
        """Check ``args`` against the signature and return the ctypes
        holders of each argument's value, in order."""
        if len(args) != len(self._params):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got %d"
                             % (self._name, len(self._params), len(args)))
        holders = []
        for i, (arg, (pointer, const, ctype)) in enumerate(
                zip(args, self._params)):
            dtype, scalar = _DTYPE_CPP[ctype]
            if pointer:
                if not isinstance(arg, NDArray):
                    raise MXNetError("argument %d of %s is %s *, so it must "
                                     "be an NDArray, not %s"
                                     % (i, self._name, ctype, type(arg)))
                if (ctype, arg._data.dtype) in _NARROWED:
                    raise MXNetError(
                        "argument %d of %s is %s *, but the NDArray is %s: "
                        "%s, as in the JAX package, so declare the parameter "
                        "%s" % ((i, self._name, ctype, arg._data.dtype)
                                + _NARROWED[ctype, arg._data.dtype]))
                if arg._data.dtype != dtype:
                    raise MXNetError("argument %d of %s is %s *: the NDArray "
                                     "must be %s, not %s" % (
                                         i, self._name, ctype, dtype,
                                         arg._data.dtype))
                if arg.context != ctx:
                    raise MXNetError("argument %d of %s lies on %s, not on "
                                     "%s" % (i, self._name, arg.context, ctx))
                t = arg._data.detach().contiguous() if const \
                    else arg._own_buffer()
                holders.append((t, ctypes.c_void_p(t.data_ptr())))
            else:
                if not isinstance(arg, (int, float, np.generic)):
                    raise MXNetError("argument %d of %s is a %s, so it must "
                                     "be a number, not %s"
                                     % (i, self._name, ctype, type(arg)))
                if ctype == "__half":
                    value = scalar(int(np.float16(arg).view(np.uint16)))
                elif ctype == "__nv_bfloat16":
                    bits = torch.tensor([float(arg)], dtype=torch.bfloat16)
                    value = scalar(int(bits.view(torch.int16).item())
                                   & 0xFFFF)
                elif scalar in _INT_TYPES:
                    value = scalar(_integral(arg, ctype, scalar, i,
                                             self._name))
                else:
                    value = scalar(arg)
                holders.append((None, value))
        return holders

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``grid_dims`` blocks of
        ``block_dims`` threads and ``shared_mem`` bytes of dynamic shared
        memory, on PyTorch's current stream of that device."""
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError("a CUDA kernel launches on a GPU context, not "
                             "on %r" % (ctx,))
        device = ctx.torch_device
        grid, block = _dims(grid_dims, "grid_dims"), \
            _dims(block_dims, "block_dims")
        holders = self._marshal(args, ctx)
        entry = self._module._function(device.index, self._name)
        lib = _libcuda()
        _make_current(lib, device.index)
        if shared_mem > entry[1]:
            _check_cuda(lib, lib.cuFuncSetAttribute(
                entry[0], _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute(max dynamic shared "
                "memory %d)" % shared_mem)
            entry[1] = int(shared_mem)
        params = (ctypes.c_void_p * max(len(holders), 1))()
        for i, (_, value) in enumerate(holders):
            params[i] = ctypes.addressof(value)
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_cuda(lib, lib.cuLaunchKernel(
            entry[0], *grid, *block, int(shared_mem),
            ctypes.c_void_p(stream), params, None),
            "cuLaunchKernel(%s)" % self._name)
        launches["rtc:" + self._name] += 1


# ---------------------------------------------------------- PallasModule --
class ShapeDtypeStruct:
    """Shape and dtype of a kernel output (jax.ShapeDtypeStruct)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return "ShapeDtypeStruct(shape=%s, dtype=%s)" % (self.shape,
                                                         self.dtype)


def _is_triton(kernel_fn):
    return type(kernel_fn).__module__.split(".")[0] == "triton"


class _PallasKernel:
    def __init__(self, name, kernel_fn, out_shape_fn):
        self._name = name
        self._kernel_fn = kernel_fn
        self._out_shape_fn = out_shape_fn

    def launch(self, args, ctx=None, grid_dims=None, block_dims=None,
               shared_mem=0):
        if block_dims is not None or shared_mem:
            raise MXNetError(
                "block_dims/shared_mem are not applicable to a PallasModule "
                "kernel; use CudaModule for a CUDA launch configuration")
        datas = [a._data.detach() if isinstance(a, NDArray) else a
                 for a in args]
        tensors = [d for d in datas if isinstance(d, torch.Tensor)]
        device = tensors[0].device if tensors else \
            (ctx or current_context()).torch_device
        shapes = self._out_shape_fn(*datas)
        single = isinstance(shapes, ShapeDtypeStruct)
        outs = [torch.empty(s.shape, dtype=s.dtype, device=device)
                for s in ([shapes] if single else shapes)]
        if _is_triton(self._kernel_fn):
            if not all(t.is_cuda for t in tensors + outs):
                raise MXNetError(
                    "PallasModule kernel %s is a Triton body, which runs on "
                    "CUDA tensors only; its inputs lie on %s"
                    % (self._name, sorted({str(t.device) for t in tensors})))
            grid = (1,) if grid_dims is None else tuple(grid_dims)
            datas = [d.contiguous() if isinstance(d, torch.Tensor) else d
                     for d in datas]
            with torch.cuda.device(device):
                self._kernel_fn[grid](*datas, *outs)
            launches["rtc:" + self._name] += 1
        else:
            if grid_dims is not None:
                raise MXNetError(
                    "PallasModule kernel %s is a ref body, which runs once "
                    "over whole arrays and takes no grid (pl.program_id is "
                    "JAX's); write a Triton body for a grid" % self._name)
            if any(t.device.type != "cpu" for t in tensors + outs):
                raise MXNetError(
                    "PallasModule kernel %s is a ref body, the plain "
                    "version, which runs on CPU tensors only; on the GPU "
                    "write it as a @triton.jit body, or as CUDA source "
                    "through CudaModule" % self._name)
            with torch.no_grad():
                self._kernel_fn(*datas, *outs)
        return outs[0] if single else type(shapes)(outs)


class PallasModule:
    """Kernel bodies to launch, mirroring ``CudaModule.get_kernel``.

    ``kernels``: name -> (kernel_fn, out_shape_fn), where kernel_fn is a
    ``@triton.jit`` function or a ref body, and ``out_shape_fn(*args)``
    returns the ``ShapeDtypeStruct`` (or list) of the outputs."""

    def __init__(self, **kernels):
        self._kernels = kernels

    def get_kernel(self, name, signature=None):
        if name not in self._kernels:
            raise MXNetError("kernel %s not found; have %s"
                             % (name, sorted(self._kernels)))
        return _PallasKernel(name, *self._kernels[name])
