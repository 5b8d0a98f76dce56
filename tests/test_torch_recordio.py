"""The port's RecordIO (``mxnet_tpu_torch.recordio``) and native IO
library (``mxnet_tpu_torch._native``) against the JAX package's, on the
same records made from a seed: the .rec, .idx and .crc sidecar bytes are
identical, each package reads the other's files, the CRC check and the
chaos hook raise ``RecordCorrupt`` as in JAX, and the native scan, batch
read, whole-file read (the port's ``read_all``, against JAX's sequential
reads), index rebuild, LibSVM parse and im2rec packer give JAX's results.
Tolerance: exact everywhere (bytes and integer offsets; float32 LibSVM
values parsed by the same C++ source)."""

import os

import numpy as np
import pytest

from mxnet_tpu import _native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu.observability import chaos as jchaos

from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.observability import chaos as tchaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RS = np.random.RandomState(3)
# payload lengths around the 4-byte padding: 0 to 3 pad bytes each
PAYLOADS = [RS.bytes(n) for n in (0, 1, 2, 3, 4, 5, 17, 255, 1024)]
LABELS = [1.0, [2.0, 3.5], 0.25, [7.0], 4.0, 5.0, [1.0, 2.0, 3.0], 6.0, 9.5]


def _write(mod, d, crc=True):
    rec, idx = os.path.join(d, "a.rec"), os.path.join(d, "a.idx")
    kw = {} if mod is jrec else {"crc": crc}
    w = mod.MXIndexedRecordIO(idx, rec, "w", **kw)
    for i, (label, body) in enumerate(zip(LABELS, PAYLOADS)):
        w.write_idx(i, mod.pack(mod.IRHeader(0, label, i, 0), body))
    w.close()
    return rec, idx


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def files(tmp_path):
    out = {}
    for name, mod in (("jax", jrec), ("port", trec)):
        d = tmp_path / name
        d.mkdir()
        out[name] = _write(mod, str(d))
    return out


def test_written_bytes_are_the_references(files):
    (jr, ji), (tr, ti) = files["jax"], files["port"]
    assert _bytes(tr) == _bytes(jr)
    assert _bytes(ti) == _bytes(ji)
    assert _bytes(tr + ".crc") == _bytes(jr + ".crc")


@pytest.mark.parametrize("writer,reader", [("jax", trec), ("port", jrec)])
def test_each_package_reads_the_others_files(files, writer, reader):
    rec, idx = files[writer]
    seq = reader.MXRecordIO(rec, "r")
    got = []
    while True:
        buf = seq.read()
        if buf is None:
            break
        got.append(buf)
    seq.close()
    indexed = reader.MXIndexedRecordIO(idx, rec, "r")
    for i in reversed(range(len(PAYLOADS))):
        header, body = reader.unpack(indexed.read_idx(i))
        assert body == PAYLOADS[i] and header.id == i
        np.testing.assert_array_equal(np.atleast_1d(header.label),
                                      np.atleast_1d(LABELS[i]))
        assert got[i] == indexed.read_idx(i)
    indexed.close()


def test_unpack_headers_and_images_match(tmp_path):
    img = RS.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    for label in (3.0, [1.0, 2.0]):
        header = (0, label, 7, 9)
        assert trec.pack(header, b"xy") == jrec.pack(header, b"xy")
        for fmt in (".jpg", ".png"):
            assert trec.pack_img(header, img, img_fmt=fmt) == \
                jrec.pack_img(header, img, img_fmt=fmt)
        packed = trec.pack_img(header, img, img_fmt=".png")
        (th, ti), (jh, ji) = trec.unpack_img(packed), jrec.unpack_img(packed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti, img)   # PNG is lossless
        assert th.id == jh.id and th.flag == jh.flag


@pytest.mark.parametrize("mod", [jrec, trec], ids=["jax", "port"])
def test_crc_and_chaos_raise_record_corrupt(files, mod, tmp_path):
    rec, idx = files["port"]
    raw = bytearray(_bytes(rec))
    off = int(_bytes(idx).decode().splitlines()[7].split("\t")[1])
    raw[off + 8 + 100] ^= 0x10         # inside record 7's payload
    bad = str(tmp_path / "bad.rec")
    with open(bad, "wb") as f:
        f.write(raw)
    with open(bad + ".crc", "wb") as f:
        f.write(_bytes(rec + ".crc"))
    reader = mod.MXIndexedRecordIO(idx, bad, "r")
    with pytest.raises(mod.RecordCorrupt, match="record 7 in") as err:
        reader.read_idx(7)
    assert isinstance(err.value, IOError) and err.value.record_index == 7
    with pytest.raises(mod.RecordCorrupt):
        reader.read_batch([6, 7])
    reader.close()
    chaos = jchaos if mod is jrec else tchaos
    chaos.install("recordio.read:bitflip:at=2:elem=40:bit=3")
    try:
        reader = mod.MXRecordIO(rec, "r")
        assert reader.read() is not None and reader.read() is not None
        with pytest.raises(mod.RecordCorrupt, match="record 2"):
            reader.read()
        assert reader.read() is not None      # the re-read is clean
        reader.close()
    finally:
        chaos.reset()


def test_crc_off_writes_and_checks_no_sidecar(tmp_path):
    rec, idx = _write(trec, str(tmp_path), crc=False)
    assert not os.path.exists(rec + ".crc")
    ref = tmp_path / "ref"
    ref.mkdir()
    jr, _ = _write(jrec, str(ref))
    assert _bytes(rec) == _bytes(jr)
    with open(rec + ".crc", "wb") as f:             # a stale sidecar
        f.write(_bytes(jr + ".crc").replace(b"\t", b"\t0"))
    reader = trec.MXIndexedRecordIO(idx, rec, "r", crc=False)
    assert trec.unpack(reader.read_idx(6))[1] == PAYLOADS[6]


def test_native_scan_batch_read_and_index_match_jax(files, tmp_path):
    rec, idx = files["port"]
    assert tnative.recordio_lib() is not None
    (to, tl), (jo, jl) = tnative.recordio_scan(rec), \
        jnative.recordio_scan(rec)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tl, jl)
    keys = [7, 0, 3, 8, 1]
    treader = trec.MXIndexedRecordIO(idx, rec, "r")
    jreader = jrec.MXIndexedRecordIO(idx, rec, "r")
    assert treader.read_batch(keys, num_threads=3) == \
        jreader.read_batch(keys, num_threads=3) == \
        [treader.read_idx(k) for k in keys]
    # the index rebuilt by the native scan, and by the Python walk
    for name, native in (("native", True), ("python", False)):
        tidx, jidx = str(tmp_path / ("t%s.idx" % name)), \
            str(tmp_path / ("j%s.idx" % name))
        if not native:
            lib = tnative.recordio_lib()
            tnative._libs["recordio_scan"] = None
        try:
            tkeys = trec.MXIndexedRecordIO(tidx, rec, "r").build_index()
        finally:
            if not native:
                tnative._libs["recordio_scan"] = lib
        jkeys = jrec.MXIndexedRecordIO(jidx, rec, "r").build_index()
        assert tkeys == jkeys
        assert _bytes(tidx) == _bytes(jidx) == _bytes(idx)
    assert tnative.recordio_read(rec, to[:0], tl[:0]) == []


def test_read_all_matches_sequential_reads_and_checks_crc(files, tmp_path):
    rec, idx = files["port"]
    jreader = jrec.MXRecordIO(rec, "r")
    want = [r for r in iter(jreader.read, None)]
    jreader.close()
    reader = trec.MXRecordIO(rec, "r")
    assert reader.read_all(num_threads=3) == want and len(want) == 9
    reader.close()
    lib = tnative.recordio_lib()
    tnative._libs["recordio_scan"] = None          # no library: None
    try:
        assert trec.MXRecordIO(rec, "r").read_all() is None
    finally:
        tnative._libs["recordio_scan"] = lib
    raw = bytearray(_bytes(rec))
    off = int(_bytes(idx).decode().splitlines()[7].split("\t")[1])
    raw[off + 8 + 100] ^= 0x10         # inside record 7's payload
    bad = str(tmp_path / "bad.rec")
    with open(bad, "wb") as f:
        f.write(raw)
    with open(bad + ".crc", "wb") as f:
        f.write(_bytes(rec + ".crc"))
    with pytest.raises(trec.RecordCorrupt, match="record 7 in"):
        trec.MXRecordIO(bad, "r").read_all()
    assert trec.MXRecordIO(bad, "r", crc=False).read_all()[7] != want[7]


def test_native_libsvm_parse_matches_jax(tmp_path):
    rs = np.random.RandomState(8)
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        for r in range(12):
            cols = sorted(rs.choice(10, 4, replace=False))
            f.write("%d %s\n" % (r % 3, " ".join(
                "%d:%.6g" % (c, rs.randn()) for c in cols)))
    (td, tl), (jd, jl) = tnative.libsvm_parse(path, 10), \
        jnative.libsvm_parse(path, 10)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)
    assert td.shape == (12, 10) and td.dtype == np.float32


def test_native_im2rec_pack_matches_jax(tmp_path):
    import cv2
    rs = np.random.RandomState(4)
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(3):
        name = "im%d.png" % i
        cv2.imwrite(str(root / name),
                    rs.randint(0, 256, (20 + i, 24, 3)).astype(np.uint8))
        lines.append("%d\t%d\t%s" % (i, i % 2, name))
    lst = str(tmp_path / "a.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = {}
    for name, mod in (("jax", jnative), ("port", tnative)):
        rec, idx = str(tmp_path / (name + ".rec")), \
            str(tmp_path / (name + ".idx"))
        n = mod.im2rec_pack(lst, str(root), rec, idx, resize=16,
                            num_threads=2, quiet=True)
        assert n == 3
        out[name] = (_bytes(rec), _bytes(idx))
    assert out["port"] == out["jax"]
