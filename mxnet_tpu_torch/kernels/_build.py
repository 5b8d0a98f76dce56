"""Build and load the port's CUDA sources at first use.

Every ``mxnet_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/mxnet_tpu_torch/`` at the root of the checkout, named by the hash
of its source, of every ``csrc/`` header it includes, and of the flags,
so an edited source or header rebuilds and an unchanged one loads at
once. The libraries are loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds. Nothing here runs at
import time: this module imports on a machine without ``nvcc``.

``launches`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a caller can zero the
counts, drive a path, and see which kernels that path reached.
"""

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

launches = collections.Counter()

_c_int, _ptr, _c_float = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# argument types of each C entry point, by source name
SIGNATURES = {
    "decode_attention": {
        # dtype, q, kpool, vpool, tables, pos, out, scratch,
        # b, kvh, d, bs, nbl, span, g, splits, chunk, stream
        "paged_decode": [_c_int] + [_ptr] * 7 + [_c_int] * 9 + [_ptr],
        # dtype, q, kpool, vpool, ks, vs, tables, pos, out, scratch,
        # b, kvh, d, bs, nbl, span, g, splits, chunk, stream
        "paged_decode_int8": [_c_int] + [_ptr] * 9 + [_c_int] * 9 + [_ptr],
        # dtype, q, k, v, lengths, out, lse, scratch,
        # b, kvh, tmax, d, g, splits, chunk, stream
        "flash_decode": [_c_int] + [_ptr] * 7 + [_c_int] * 7 + [_ptr],
    },
    "flash_attention": {
        # dtype, q, k, v, o, lse, bh, tq, tk, d, causal, scale, stream
        "flash_fwd": [_c_int] + [_ptr] * 5 + [_c_int] * 5
                     + [_c_float, _ptr],
        # dtype, q, k, v, o_in, m_in, l_in, o_out, m_out, l_out,
        # bh, tq, tk, d, q_offset, kv_offset, causal, scale, stream
        "flash_carry": [_c_int] + [_ptr] * 9 + [_c_int] * 7
                       + [_c_float, _ptr],
        # dtype, q, k, v, do, lse, delta, dq,
        # bh, tq, tk, d, causal, scale, stream
        "flash_bwd_dq": [_c_int] + [_ptr] * 7 + [_c_int] * 5
                        + [_c_float, _ptr],
        # dtype, q, k, v, do, lse, delta, dk, dv,
        # bh, tq, tk, d, causal, scale, stream
        "flash_bwd_dkv": [_c_int] + [_ptr] * 8 + [_c_int] * 5
                         + [_c_float, _ptr],
    },
}

_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or the first ``nvcc`` on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels are built from source at first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name):
    """csrc/<name>.cu and every csrc/ file it includes with ``#include
    "..."``, directly or through another such file, in include order."""
    found, todo = [], [CSRC / (name + ".cu")]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes()) if (CSRC / inc.decode()).is_file()]
    return found


def library_path(name):
    """Where the library of csrc/<name>.cu lands for its current source
    and headers."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s_%s.so" % (name, digest.hexdigest()[:16]))


def _start_build(name):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process or None, library path, temporary output path)."""
    lib = library_path(name)
    if lib.exists():
        return None, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.%d.tmp" % os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp),
                                        str(CSRC / (name + ".cu"))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def _finish_build(name, proc, lib, tmp):
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for csrc/%s.cu (exit %d):\n%s"
                           % (name, proc.returncode, out))
    os.replace(tmp, lib)


def _open(name, lib):
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def build_all(names=None):
    """Build every source in csrc/ (or the ``names`` given) at once (one
    nvcc each, started together) and load them. Returns {name: ctypes
    library}."""
    with _LOCK:
        names = [n for n in (names or SIGNATURES) if n not in _LIBS]
        started = [(n,) + _start_build(n) for n in names]
        for n, proc, lib, tmp in started:
            _finish_build(n, proc, lib, tmp)
        for n, _, lib, _ in started:
            _LIBS[n] = _open(n, lib)
        return dict(_LIBS)


def load(name):
    """The ctypes library of csrc/<name>.cu, building that source if
    needed."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]


def check(status, kernel):
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (kernel, status))


def current_stream_ptr(device):
    """The raw cudaStream_t of ``device``'s current stream, as an int (a
    ctypes ``c_void_p`` argument takes it): read without building a
    ``torch.cuda.Stream``, which costs a wrapper call microseconds."""
    return torch._C._cuda_getCurrentRawStream(device.index)
