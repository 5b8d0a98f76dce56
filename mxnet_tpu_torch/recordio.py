"""RecordIO — binary record container + indexed variant + image records
(port of ``mxnet_tpu/recordio.py``).

Reference: python/mxnet/recordio.py:37,216,344 (MXRecordIO,
MXIndexedRecordIO, IRHeader/pack/unpack) over dmlc-core's C++ recordio
writer; src/io/image_recordio.h:110 (IRHeader layout).

This module owns the on-disk format (kMagic-delimited, length+content,
4-byte aligned) in Python, byte for byte the JAX package's, so each
package reads the other's files; the hot paths — whole-file index scans
and batched scatter reads — dispatch to the native library built from
src/io/recordio_scan.cc (``_native``: ctypes, GIL-released thread pool)
with a pure-Python fallback. It is host code: no tensor is made here.
``crc`` (default on) replaces the reference's ``MXNET_RECORDIO_CRC``.
"""

import numbers
import os
import struct
import zlib
from collections import namedtuple

import numpy as np

from .observability import chaos as _chaos

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "RecordCorrupt",
           "pack", "unpack", "pack_img", "unpack_img"]

_kMagic = 0xced7230a


class RecordCorrupt(IOError):
    """A record failed its integrity check (bad magic or CRC mismatch).

    Subclasses IOError so the io.py retry path (``io._retry_read``)
    treats it as transient first: a bit flipped in the page cache or by
    injected chaos recovers on re-read, while a flip ON DISK exhausts
    the retries and surfaces this error naming the file and record.
    """

    def __init__(self, path, record_index, detail=""):
        self.path = path
        self.record_index = record_index
        msg = "corrupt record %s in %s" % (record_index, path)
        if detail:
            msg += ": %s" % detail
        super().__init__(msg)


def _crc_path(uri):
    return str(uri) + ".crc"


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(rec):
    return (rec >> 29) & 7, rec & ((1 << 29) - 1)


class MXRecordIO(object):
    """Sequential record reader/writer (recordio.py:37).

    Format per record: uint32 magic | uint32 lrec (3-bit cflag, 29-bit
    len) | payload | pad to 4-byte boundary. cflag 0 = whole record;
    1/2/3 = begin/middle/end of a split record (records > 2^29 bytes).

    Integrity (``crc``, default on; off writes and checks no
    sidecar, which reference tooling ignores anyway): writers emit a
    ``<uri>.crc`` sidecar of offset -> crc32(payload); readers verify
    each record against it and the frame magic, raising
    ``RecordCorrupt(path, record_index)`` — an IOError, so the io.py
    retry path re-reads once before the error surfaces.
    """

    def __init__(self, uri, flag, crc=True):
        self.uri = uri
        self.flag = flag
        self.crc = crc
        self.pid = None
        self.fio = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fio = open(self.uri, "wb")
            self.writable = True
            self._crc_entries = [] if self.crc else None
            self._crc = None
        elif self.flag == "r":
            self.fio = open(self.uri, "rb")
            self.writable = False
            self._crc_entries = None
            self._crc = self._load_crc()
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self._read_count = 0
        self._pending_index = None
        self.pid = os.getpid()

    def _load_crc(self):
        """offset -> crc32 of the logical payload, from the sidecar."""
        if not self.crc or not os.path.isfile(_crc_path(self.uri)):
            return None
        table = {}
        with open(_crc_path(self.uri)) as fin:
            for line in fin:
                parts = line.strip().split("\t")
                if len(parts) == 2:
                    table[int(parts[0])] = int(parts[1], 16)
        return table or None

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_mx_rec = type(self).__name__ == "MXRecordIO"
        if not is_mx_rec:
            raise RuntimeError("Only MXRecordIO is picklable.")
        d = dict(self.__dict__)
        d["fio"] = None
        d["pid"] = None
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.open()

    def _check_pid(self, allow_reset=False):
        # fork safety (recordio.py:107): child must reopen its own handle
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in a forked process")

    def close(self):
        if self.fio is not None and not self.fio.closed:
            if self.writable and self._crc_entries:
                with open(_crc_path(self.uri), "w") as fout:
                    for off, crc in self._crc_entries:
                        fout.write("%d\t%08x\n" % (off, crc))
            self.fio.close()
        self.fio = None
        self.pid = None

    @property
    def is_open(self):
        return self.fio is not None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid(allow_reset=False)
        if self._crc_entries is not None:
            self._crc_entries.append(
                (self.fio.tell(), zlib.crc32(buf) & 0xFFFFFFFF))
        self.fio.write(struct.pack("<II", _kMagic,
                                   _encode_lrec(0, len(buf))))
        self.fio.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.fio.write(b"\x00" * pad)

    def tell(self):
        return self.fio.tell()

    def read_all(self, num_threads=4):
        """Every record's payload in file order, as sequential ``read()``
        calls give them, from one native whole-file scan and one threaded
        scatter read, each checked against the CRC sidecar; None when the
        native library is unavailable or rejects the file (the caller
        then reads record by record)."""
        assert not self.writable, "read_all requires read mode"
        from . import _native
        scanned = _native.recordio_scan(self.uri)
        if scanned is None:
            return None
        offsets, lengths = scanned
        return self._native_read(range(len(offsets)), offsets, lengths,
                                 num_threads)

    def _native_read(self, keys, offsets, lengths, num_threads):
        """The payloads at ``offsets`` from the native scatter reader, or
        None when it is unavailable or rejects the file. The reader
        bypasses ``read()``, so each payload is checked against the
        sidecar here, and a mismatch names its record's ``keys`` entry."""
        from . import _native
        out = _native.recordio_read(self.uri, offsets, lengths, num_threads)
        if out is not None and self._crc:
            for key, off, payload in zip(keys, offsets, out):
                want = self._crc.get(int(off))
                if want is not None and \
                        zlib.crc32(payload) & 0xFFFFFFFF != want:
                    raise RecordCorrupt(self.uri, key,
                                        "crc mismatch on batched read")
        return out

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=True)
        index = self._pending_index if self._pending_index is not None \
            else self._read_count
        self._pending_index = None
        start = self.fio.tell()
        parts = []
        while True:
            head = self.fio.read(8)
            if len(head) < 8:
                if parts:
                    break
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                raise RecordCorrupt(
                    self.uri, index,
                    "bad magic 0x%08x (want 0x%08x)" % (magic, _kMagic))
            cflag, length = _decode_lrec(lrec)
            data = self.fio.read(length)
            pad = (4 - (length % 4)) % 4
            if pad:
                self.fio.read(pad)
            parts.append(data)
            if cflag in (0, 3):  # whole record or end-of-split
                break
        self._read_count += 1
        data = b"".join(parts)
        if _chaos.enabled():
            # in-memory bit flip AFTER the read: a retried read sees
            # the clean on-disk bytes (the transient-SDC scenario)
            data = _chaos.corrupt_bytes("recordio.read", data,
                                        path=self.uri, record=index)
        want = self._crc.get(start) if self._crc else None
        if want is not None:
            got = zlib.crc32(data) & 0xFFFFFFFF
            if got != want:
                # rewind so a retry re-reads the same record
                self.fio.seek(start)
                self._read_count -= 1
                raise RecordCorrupt(
                    self.uri, index,
                    "crc %08x != sidecar %08x" % (got, want))
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records keyed by an .idx file (recordio.py:216)."""

    def __init__(self, idx_path, uri, flag, key_type=int, crc=True):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag, crc)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self._native_lengths = None
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.fio is None:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def __getstate__(self):
        raise RuntimeError("MXIndexedRecordIO is not picklable.")

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.fio.seek(self.idx[idx])
        self._pending_index = idx  # name THIS key in corruption errors

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos

    def build_index(self, write=True):
        """(Re)build the key -> offset table by scanning the .rec file —
        covers files produced without an .idx sidecar. The scan runs in
        the native library (src/io/recordio_scan.cc) when available,
        falling back to a Python frame walk."""
        assert not self.writable, \
            "build_index requires read mode (close the writer first: its " \
            "buffered tail would be missing from the scan)"
        from . import _native
        scanned = _native.recordio_scan(self.uri)
        if scanned is not None:
            offsets = [int(o) for o in scanned[0]]
        else:
            offsets = []
            with open(self.uri, "rb") as f:
                pos = 0
                while True:
                    head = f.read(8)
                    if len(head) < 8:
                        break
                    magic, lrec = struct.unpack("<II", head)
                    if magic != _kMagic:
                        raise RecordCorrupt(
                            self.uri, len(offsets),
                            "bad magic 0x%08x during index scan" % magic)
                    cflag, length = _decode_lrec(lrec)
                    if cflag in (0, 1):       # logical record start
                        offsets.append(pos)
                    pos += 8 + length + (4 - length % 4) % 4
                    f.seek(pos)
        self.keys = [self.key_type(i) for i in range(len(offsets))]
        self.idx = dict(zip(self.keys, offsets))
        if write:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        return self.keys

    def read_batch(self, indices, num_threads=4):
        """Payloads of many records in one call. Uses the native
        scatter-reader thread pool when available; otherwise sequential
        read_idx calls."""
        assert not self.writable, \
            "read_batch requires read mode (close the writer and reopen)"
        from . import _native
        offsets = [self.idx[i] for i in indices]
        length_of = getattr(self, "_native_lengths", None)
        if length_of is None and _native.recordio_lib() is not None:
            scanned = _native.recordio_scan(self.uri)
            if scanned is not None:
                off_arr, len_arr = scanned
                length_of = dict(zip((int(o) for o in off_arr),
                                     (int(n) for n in len_arr)))
            self._native_lengths = length_of or {}
        if length_of:
            try:
                lengths = [length_of[o] for o in offsets]
            except KeyError:
                lengths = None
            if lengths is not None:
                out = self._native_read(indices, offsets, lengths,
                                        num_threads)
                if out is not None:
                    return out
        return [self.read_idx(i) for i in indices]


# image record header (src/io/image_recordio.h:110 / recordio.py:344)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a label header + byte payload into one record (recordio.py:355)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    """Unpack a record into header + payload (recordio.py:388)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack to (header, image ndarray) — decodes jpg/png payloads
    (recordio.py:415). .npy payloads load with numpy; others through PIL,
    imported here (a host without PIL reads .npy records only)."""
    header, s = unpack(s)
    img = _imdecode(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (recordio.py:451) through PIL: JPEG for
    ``img_fmt`` ".jpg"/".jpeg", PNG for any other. Without PIL the
    payload is a raw .npy (not interchange-compatible), as in the
    reference; a caller that wants .npy records on every host packs
    ``np.save``'s bytes with ``pack``."""
    encoded = _imencode(img, quality, img_fmt)
    return pack(header, encoded)


def _imencode(img, quality, img_fmt):
    try:
        from PIL import Image
        import io as _io
        buf = _io.BytesIO()
        Image.fromarray(np.asarray(img).astype(np.uint8)).save(
            buf, format="JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG",
            quality=quality)
        return buf.getvalue()
    except ImportError:
        # fallback: raw .npy serialization (not interchange-compatible)
        import io as _io
        buf = _io.BytesIO()
        np.save(buf, np.asarray(img))
        return buf.getvalue()


def _imdecode(s, iscolor=-1):
    if s[:6] == b"\x93NUMPY":
        import io as _io
        return np.load(_io.BytesIO(s))
    try:
        from PIL import Image
        import io as _io
        img = np.asarray(Image.open(_io.BytesIO(s)))
        return img
    except ImportError:
        raise RuntimeError("No image decoder available (PIL missing and "
                           "payload is not npy)")
