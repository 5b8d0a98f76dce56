"""Loader for the native (C++) IO components under ``src/io/`` (port of
``mxnet_tpu/_native.py``).

The repo's sources ``src/io/recordio_scan.cc`` (the whole-file RecordIO
scan and the thread-pool scatter reader), ``libsvm_scan.cc`` (the LibSVM
parser) and ``im2rec_pack.cc`` (the im2rec packer, over OpenCV's C++
library) compile unchanged with ``g++`` at first use into
``build/mxnet_tpu_torch/`` at the root of the checkout, beside the CUDA
kernels of ``kernels/_build.py``, and are bound through ctypes. A library
is named by the hash of its source, so an edited source rebuilds. Each
build writes a file of its own process and ``os.replace``s it into place,
so data-loader workers that start together can build at once.

Every entry point returns None where its library cannot be built or
loaded, and its caller falls back to pure Python, as in the reference
(a host without a compiler). ``recordio_lib`` says so on stderr once.
The reference's ``MXNET_NATIVE_CACHE`` has no counterpart: the libraries
build into ``BUILD_DIR``, inside the checkout.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SRC_DIR = _ROOT / "src" / "io"
BUILD_DIR = _ROOT / "build" / "mxnet_tpu_torch"

_lock = threading.Lock()
# tag -> the loaded library, or None when it could not be built
_libs = {}


def _build(source_path, tag, extra_flags=()):
    with open(source_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / ("lib%s_%s.so" % (tag, digest))
    if out.exists():
        return str(out)
    # a file of this process: concurrent builds (data-loader workers)
    # must not write into one file; os.replace makes the last one win
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(source_path)] + list(extra_flags) + ["-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


def _load(tag, extra_flags, declare, notice):
    with _lock:
        if tag in _libs:
            return _libs[tag]
        try:
            lib = ctypes.CDLL(_build(SRC_DIR / (tag + ".cc"), tag,
                                     extra_flags))
        except (OSError, subprocess.CalledProcessError) as exc:
            if notice:
                print("mxnet_tpu_torch: native %s unavailable (%s); using "
                      "the pure-Python path" % (notice, exc),
                      file=sys.stderr)
            _libs[tag] = None
            return None
        declare(lib)
        _libs[tag] = lib
        return lib


def _declare_recordio(lib):
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.mxtpu_recordio_scan.restype = ctypes.c_int64
    lib.mxtpu_recordio_scan.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(p64), ctypes.POINTER(p64)]
    lib.mxtpu_recordio_free.restype = None
    lib.mxtpu_recordio_free.argtypes = [p64]
    lib.mxtpu_recordio_read.restype = ctypes.c_int64
    lib.mxtpu_recordio_read.argtypes = [
        ctypes.c_char_p, p64, p64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int]


def recordio_lib():
    """The compiled RecordIO scanner and reader, or None when
    unavailable."""
    return _load("recordio_scan", (), _declare_recordio, "recordio")


def recordio_scan(path):
    """(header_offsets, payload_lengths) int64 arrays of the logical
    records of a .rec file, or None when the native path is unavailable
    or the file is malformed (the caller falls back to Python)."""
    lib = recordio_lib()
    if lib is None:
        return None
    offs = ctypes.POINTER(ctypes.c_int64)()
    lens = ctypes.POINTER(ctypes.c_int64)()
    n = lib.mxtpu_recordio_scan(os.fsencode(path), ctypes.byref(offs),
                                ctypes.byref(lens))
    if n < 0:
        return None
    try:
        offsets = np.ctypeslib.as_array(offs, shape=(n,)).copy() if n \
            else np.zeros(0, np.int64)
        lengths = np.ctypeslib.as_array(lens, shape=(n,)).copy() if n \
            else np.zeros(0, np.int64)
    finally:
        if n:
            lib.mxtpu_recordio_free(offs)
            lib.mxtpu_recordio_free(lens)
    return offsets, lengths


def recordio_read(path, offsets, lengths, num_threads=4):
    """Payload bytes of the records at ``offsets`` (a list of bytes),
    read by the native thread pool; None: the caller falls back."""
    lib = recordio_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    total = int(lengths.sum())
    buf = ctypes.create_string_buffer(max(total, 1))
    p64 = ctypes.POINTER(ctypes.c_int64)
    got = lib.mxtpu_recordio_read(
        os.fsencode(path), offsets.ctypes.data_as(p64),
        lengths.ctypes.data_as(p64), len(offsets), buf, int(num_threads))
    if got != total:
        return None
    view = memoryview(buf)
    out = []
    pos = 0
    for n in lengths:
        out.append(bytes(view[pos:pos + int(n)]))
        pos += int(n)
    return out


def _declare_libsvm(lib):
    pf = ctypes.POINTER(ctypes.c_float)
    lib.libsvm_count_rows.restype = ctypes.c_int64
    lib.libsvm_count_rows.argtypes = [ctypes.c_char_p]
    lib.libsvm_parse_dense.restype = ctypes.c_int64
    lib.libsvm_parse_dense.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, pf, pf, ctypes.c_int64]
    lib.libsvm_parse_file.restype = ctypes.c_int64
    lib.libsvm_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(pf),
        ctypes.POINTER(pf)]
    lib.libsvm_free.restype = None
    lib.libsvm_free.argtypes = [ctypes.c_void_p]


def libsvm_lib():
    """The compiled LibSVM parser, or None when unavailable."""
    return _load("libsvm_scan", (), _declare_libsvm, None)


def libsvm_parse(path, dim):
    """A LibSVM file as (data [rows, dim] float32, labels [rows]) from ONE
    read of the file (``libsvm_parse_file`` allocates; copied, then
    freed), or None when the native parser is unavailable or rejects the
    file (the caller falls back to the Python parser)."""
    lib = libsvm_lib()
    if lib is None:
        return None
    data_p = ctypes.POINTER(ctypes.c_float)()
    labels_p = ctypes.POINTER(ctypes.c_float)()
    rows = lib.libsvm_parse_file(os.fsencode(path), dim,
                                 ctypes.byref(data_p),
                                 ctypes.byref(labels_p))
    if rows < 0:
        return None
    try:
        data = np.ctypeslib.as_array(data_p, shape=(rows, dim)).copy() \
            if rows else np.zeros((0, dim), np.float32)
        labels = np.ctypeslib.as_array(labels_p, shape=(rows,)).copy() \
            if rows else np.zeros((0,), np.float32)
    finally:
        lib.libsvm_free(data_p)
        lib.libsvm_free(labels_p)
    return data, labels


_OPENCV_FLAGS = ("-I/usr/include/opencv4", "-lopencv_imgcodecs",
                 "-lopencv_imgproc", "-lopencv_core")


def _declare_im2rec(lib):
    lib.mxtpu_im2rec_pack.restype = ctypes.c_int64
    lib.mxtpu_im2rec_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]


def im2rec_lib():
    """The compiled im2rec packer (needs OpenCV's C++ library), or
    None."""
    return _load("im2rec_pack", _OPENCV_FLAGS, _declare_im2rec, None)


def im2rec_pack(list_path, root, rec_path, idx_path, resize=0,
                quality=95, color=1, num_threads=4, use_png=False,
                quiet=False):
    """Pack the .lst entries into rec/idx natively; the packed count, or
    None when the native packer is unavailable (the caller falls back to
    the Python loop)."""
    lib = im2rec_lib()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(256)
    n = lib.mxtpu_im2rec_pack(
        os.fsencode(list_path), os.fsencode(root), os.fsencode(rec_path),
        os.fsencode(idx_path or ""), int(resize), int(quality), int(color),
        int(num_threads), int(bool(use_png)), int(bool(quiet)), err, 256)
    if n < 0:
        print("mxnet_tpu_torch: native im2rec failed (%s); using the "
              "Python packer" % err.value.decode(), file=sys.stderr)
        return None
    return int(n)
