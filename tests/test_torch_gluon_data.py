"""The port's ``gluon.data`` (datasets, samplers, the DataLoader's
serial, thread and process tiers), ``gluon.data.vision`` (datasets read
from local files, transforms), ``contrib.io.DataLoaderIter`` and
``entry.real_data`` against the JAX package's, on the same arrays and
files made from a seed, with Python's ``random`` and numpy's global state
seeded alike.

Exact everywhere (items, batches, labels, dtypes) but the hybridized
transforms, held at rtol = atol = 1e-6 against JAX's (float32 divisions
in another order). The process pool (spawned workers, shared-memory
batches) must give the serial loader's batches, through an early break,
bf16 and pinned memory; a worker's error and a worker that cannot start
must raise. ``real_data`` runs bench.py's --real-data leg at batch 2 x
64^2 (at 32^2 the reference's own step 2 is NaN) under ``with cpu():``:
its loss is finite and its first fed batch is the JAX
``ImageRecordIter``'s on the same file and seed."""

import gzip
import operator
import os
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import entry
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data import vision as tvision
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jdata = jmx.gluon.data
RS = np.random.RandomState(12)
X = RS.rand(14, 3, 2).astype(np.float32)
Y = np.arange(14, dtype=np.float32)
IMGS = RS.randint(0, 256, (10, 12, 14, 3)).astype(np.uint8)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _seed(s=0):
    random.seed(s)
    np.random.seed(s)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_datasets_and_samplers_match_jax():
    for pkg in (tdata, jdata):
        _seed()
        ds = pkg.ArrayDataset(X, Y)
        out = [ds[3], len(ds), list(ds.take(4)),
               list(ds.filter(lambda item: item[1] % 3 == 0)),
               [ds.transform(lambda x, y: (x * 2, y + 1))[i]
                for i in range(3)],
               list(ds.transform_first(lambda x: x.sum(), lazy=False)),
               pkg.SimpleDataset(list(range(5)))[2],
               list(pkg.SequentialSampler(5)), list(pkg.RandomSampler(9))]
        bs = pkg.BatchSampler(pkg.SequentialSampler(7), 3, "rollover")
        out += [list(bs), len(bs), list(bs)]
        for last in ("keep", "discard"):
            b = pkg.BatchSampler(pkg.SequentialSampler(7), 3, last)
            out += [list(b), len(b)]
        if pkg is tdata:
            port = out
    _same(port, out)
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(4), 3, "bad"))
    nd1 = tdata.ArrayDataset(mt.nd.array(Y))
    assert isinstance(nd1[2], np.float32)      # a 1-D NDArray goes numpy


def _write_png_rec(d):
    rec, idx = os.path.join(d, "img.rec"), os.path.join(d, "img.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(IMGS[:5]):
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    return rec


def _write_mnist(d, gz):
    imgs, labels = IMGS[:6, :, :, 0], np.arange(6, dtype=np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with op(os.path.join(d, "train-images-idx3-ubyte" + suffix), "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 12, 14) + imgs.tobytes())
    with op(os.path.join(d, "train-labels-idx1-ubyte" + suffix), "wb") as f:
        f.write(struct.pack(">II", 2049, 6) + labels.tobytes())


def _write_cifar(d, files, rec_len):
    for n, name in enumerate(files):
        rows = RS.randint(0, 256, (3, rec_len)).astype(np.uint8)
        rows[:, 0] = n
        rows.tofile(os.path.join(d, name))


def test_vision_datasets_match_jax(tmp_path):
    import cv2
    d = str(tmp_path)
    rec = _write_png_rec(d)
    folder = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        (folder / cls).mkdir(parents=True)
        cv2.imwrite(str(folder / cls / "a.png"), IMGS[c])
        np.save(str(folder / cls / "b.npy"), IMGS[c + 2])
    (folder / "notes.txt").write_text("not a class")
    for sub, gz in (("mnist", True), ("fashion", False)):
        os.makedirs(os.path.join(d, sub))
        _write_mnist(os.path.join(d, sub), gz)
    os.makedirs(os.path.join(d, "c10"))
    _write_cifar(os.path.join(d, "c10"),
                 ["data_batch_%d.bin" % i for i in range(1, 6)], 3073)
    os.makedirs(os.path.join(d, "c100"))
    _write_cifar(os.path.join(d, "c100"), ["train.bin"], 3074)

    def items(v):
        out = []
        for ds in (v.ImageRecordDataset(rec),
                   v.ImageRecordDataset(rec, flag=0,
                                        transform=lambda x, y: (x, y * 2)),
                   v.ImageFolderDataset(str(folder)),
                   v.MNIST(root=os.path.join(d, "mnist")),
                   v.FashionMNIST(root=os.path.join(d, "fashion")),
                   v.CIFAR10(root=os.path.join(d, "c10")),
                   v.CIFAR100(root=os.path.join(d, "c100"), fine_label=True)):
            out.append([len(ds)] + [ds[i] for i in (0, len(ds) - 1)])
        return out
    with pytest.warns(UserWarning):
        port = items(tvision)
    _same(port, items(jdata.vision))
    raw = tdata.RecordFileDataset(rec)
    assert jrec.unpack(raw[1])[0].id == 1 and len(raw) == 5
    with pytest.raises(IOError, match="not downloaded"):
        tvision.MNIST(root=str(tmp_path / "empty"))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, last_batch="discard"),
    dict(batch_size=4, last_batch="rollover", shuffle=True),
    dict(batch_size=3, shuffle=True, num_workers=2, thread_pool=True)],
    ids=["keep", "discard", "rollover-shuffle", "threads"])
def test_serial_and_thread_loaders_match_jax(kw):
    runs = []
    for pkg in (tdata, jdata):
        _seed(2)
        loader = pkg.DataLoader(pkg.ArrayDataset(X, Y), **kw)
        runs.append([list(loader), list(loader), len(loader)])
    _same(*runs)
    # a pool thread makes its batch on the epoch's context, not gpu(0)
    assert runs[0][0][0][0].context == mt.cpu()


def _serial(ds, **kw):
    return [_np(b) for b in tdata.DataLoader(ds, batch_size=4, **kw)]


def test_process_loader_matches_serial_through_break_bf16_and_pinning():
    ds = tdata.ArrayDataset(mt.nd.array(X), mt.nd.array(Y))
    want = _serial(ds)
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2,
                              pin_memory=True)
    for i, batch in enumerate(loader):
        assert batch[0].context == mt.cpu()
        if i == 1:
            break                                  # an early break
    _same([_np(b) for b in loader], want)          # the pool lives on
    it = iter(loader)
    next(it)
    with pytest.raises(mt.MXNetError, match="concurrent"):
        next(iter(loader))
    it.close()
    bf = tdata.ArrayDataset(mt.nd.array(X).astype("bfloat16"), Y)
    got = list(tdata.DataLoader(bf, batch_size=4, num_workers=2))
    _same([_np(b) for b in got], _serial(bf))
    assert "bfloat16" in str(got[0][0].dtype)


def test_process_loader_worker_error_propagates():
    ds = tdata.ArrayDataset(["0", "1", "2", "3", "4", "poison", "6",
                             "7"]).transform(float)
    with pytest.raises(mt.MXNetError, match="(?s)worker failed.*poison"):
        list(tdata.DataLoader(ds, batch_size=4, num_workers=2))


class _Unbuildable:
    """Pickles to a call that raises where it is rebuilt (the worker)."""

    def __reduce__(self):
        return (operator.truediv, (1, 0))


def test_process_loader_worker_startup_failure_raises():
    loader = tdata.DataLoader(tdata.SimpleDataset([_Unbuildable()] * 4),
                              batch_size=2, num_workers=1)
    with pytest.raises(mt.MXNetError, match="failed to start|died"):
        list(loader)


def _transforms(T):
    return [T.Cast("float16"), T.ToTensor(),
            T.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
            T.Resize(8), T.Resize((9, 7)), T.Resize(8, keep_ratio=True),
            T.CropResize(1, 2, 6, 5, size=4), T.CenterCrop(6),
            T.RandomResizedCrop(6), T.RandomFlipLeftRight(),
            T.RandomFlipTopBottom(), T.RandomBrightness(0.3),
            T.RandomContrast(0.3), T.RandomSaturation(0.3), T.RandomHue(0.2),
            T.RandomColorJitter(0.2, 0.2, 0.2, 0.1), T.RandomLighting(0.1),
            T.RandomGray(0.5)]


def test_transforms_on_numpy_and_ndarray_match_jax():
    img = IMGS[0]
    chw = img.transpose(2, 0, 1).astype(np.float32) / 255
    for i, name in enumerate(type(t).__name__
                             for t in _transforms(tvision.transforms)):
        x = chw if name == "Normalize" else img
        for as_nd in (False, True):
            out = []
            for pkg in (mt, jmx):
                _seed(i)
                t = _transforms(pkg.gluon.data.vision.transforms)[i]
                src = pkg.nd.array(x, dtype=x.dtype) if as_nd else x
                out.append([t(src) for _ in range(3)])
            _same(*out)


def test_hybridized_transforms_match_jax():
    outs = []
    for pkg in (mt, jmx):
        T = pkg.gluon.data.vision.transforms
        seq = T.Compose([T.ToTensor(),
                         T.Normalize((0.485, 0.456, 0.406),
                                     (0.229, 0.224, 0.225))])
        x = pkg.nd.array(IMGS[:3], dtype="uint8")
        eager = seq(x).asnumpy()
        seq.hybridize()
        outs.append((eager, seq(x).asnumpy(), T.Cast("float16")(x)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[0][0], rtol=1e-6, atol=1e-6)
    _same(outs[0][2], outs[1][2])


def test_dataloader_iter_matches_jax():
    runs = []
    for pkg, cio in ((tdata, mt.contrib.io), (jdata, jmx.contrib.io)):
        it = cio.DataLoaderIter(pkg.DataLoader(pkg.ArrayDataset(X, Y),
                                               batch_size=5))
        descs = [tuple(d) for d in it.provide_data + it.provide_label]
        batches = [(b.data, b.label, b.pad) for b in it]
        it.reset()
        runs.append([descs, batches, len(list(it))])
    _same(runs[0][1], runs[1][1])
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2] == 3


def test_real_data_slice_matches_jax_first_batch(tmp_path):
    run = entry.real_data(batch=2, image_size=64, steps=2,
                          directory=str(tmp_path))
    assert run["loss_finite"] and run["records"] == 64
    assert run["native_read"]
    assert run["fed_img_s"] > 0 and run["syn_img_s"] > 0
    np.random.seed(entry.SEED)
    it = jio.ImageRecordIter(
        path_imgrec=str(tmp_path / "train.rec"),
        path_imgidx=str(tmp_path / "train.idx"), data_shape=(3, 64, 64),
        batch_size=2, shuffle=True, rand_crop=True, rand_mirror=True)
    want = it.next()
    _same(run["first_data"], want.data[0])
    _same(run["first_label"], want.label[0])
    assert run["first_data"].context == mt.cpu()
