"""The port's image ops (``mxnet_tpu_torch.ops.image_ops``) and image
pipeline (``mxnet_tpu_torch.image``) against the JAX package's, on the
same seeded inputs.

* The ``_image_*`` ops: every deterministic op within rtol = atol = 1e-5
  (the resize's float32 contractions sum in another order; an integer
  input's resize, truncated as ``astype`` does, is exact), and every
  random op's body on JAX's own draw replayed into it (its threefry key
  gives the alpha, angle, coin or lighting vector the port's body takes)
  within the same tolerance (atol 1e-4 for the hue rotation, whose
  3x3 products cancel to near 0); the port's draws, from the device
  generator, are checked for their ranges.
* The helpers and every augmenter, on numpy and NDArray images, with
  Python's ``random`` and numpy's global state seeded alike: exact.
* ``ImageIter`` and ``ImageDetIter`` over a JPEG .rec written by the JAX
  package and over image files, shuffled and augmented under the same
  seeds: every batch, label and pad exact, and the threaded decode equal
  to the synchronous one.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu.ops import image_ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.ops import image_ops as tops
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
RS = np.random.RandomState(11)
HWC = (RS.rand(17, 23, 3) * 255).astype(np.float32)
NHWC = (RS.rand(2, 9, 14, 3) * 255).astype(np.float32)
CHW = RS.rand(3, 9, 14).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), **(tol or TOL))


DETERMINISTIC = [
    ("image_to_tensor", HWC.astype(np.uint8), {}),
    ("image_to_tensor", NHWC, {}),
    ("image_normalize", CHW, dict(mean=(0.4, 0.5, 0.6),
                                  std=(0.2, 0.3, 0.25))),
    ("image_normalize", CHW[None], dict(mean=0.5, std=2.0)),
    ("image_flip_left_right", HWC, {}),
    ("image_flip_top_bottom", NHWC, {}),
    ("image_resize", HWC, dict(size=(9, 7))),                  # shrink
    ("image_resize", HWC, dict(size=(40, 31))),                # enlarge
    ("image_resize", NHWC, dict(size=(30, 5))),                # mixed
    ("image_resize", HWC, dict(size=10, keep_ratio=True)),
    ("image_resize", HWC.T.copy().T, dict(size=12)),
    ("image_resize", HWC, dict(size=(9, 31), interp=0)),       # nearest
    ("image_resize", HWC.astype(np.uint8), dict(size=(9, 7))),
    ("image_resize", HWC.astype(np.uint8), dict(size=(46, 34))),
    ("image_resize", NHWC.astype(np.uint8), dict(size=(5, 20), interp=0)),
    ("image_crop", HWC, dict(x0=3, y0=2, width=9, height=11)),
    ("image_crop", NHWC, dict(x0=1, y0=0, width=5, height=4)),
    ("image_adjust_lighting", HWC, dict(alpha=(0.1, -0.2, 0.05))),
]


@pytest.mark.parametrize("name,x,kw", DETERMINISTIC,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(DETERMINISTIC)])
def test_deterministic_op_matches_jax(name, x, kw):
    want = np.asarray(getattr(jops, name)(jnp.asarray(x), **kw))
    got = getattr(tops, name)(torch.from_numpy(x), **kw)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want)
    _close(got, want)


def test_ops_through_nd_and_sym_namespaces():
    x = mt.nd.array(HWC)
    np.testing.assert_array_equal(mt.nd.image.flip_left_right(x).asnumpy(),
                                  HWC[:, ::-1])
    assert mt.nd.image.resize(x, size=8).shape == (8, 8, 3)
    assert mt.nd.image_to_tensor is not None
    assert mt.nd.image.imdecode is timg.imdecode      # the image module
    s = mt.sym.image.normalize(mt.sym.Variable("x"), mean=(0.5,),
                               std=(0.5,))
    assert "image_normalize" in s.tojson()


def _uniform(key, m):
    return jax.random.uniform(key, minval=-m, maxval=m)


# (op, its kwargs, the body on the port's side given JAX's key)
RANDOM = [
    ("image_random_brightness", dict(max_brightness=0.4),
     lambda x, k: tops.brightness_body(x, 1.0 + float(_uniform(k, 0.4)))),
    ("image_random_contrast", dict(max_contrast=0.4),
     lambda x, k: tops.contrast_body(x, 1.0 + float(_uniform(k, 0.4)))),
    ("image_random_saturation", dict(max_saturation=0.4),
     lambda x, k: tops.saturation_body(x, 1.0 + float(_uniform(k, 0.4)))),
    ("image_random_hue", dict(max_hue=0.3),
     lambda x, k: tops.hue_body(x, float(_uniform(k, 0.3)))),
    ("image_random_color_jitter",
     dict(brightness=0.3, contrast=0.2, saturation=0.1, hue=0.2),
     lambda x, k: tops.color_jitter_body(
         x, [1.0 + float(_uniform(s, m)) if i < 3 else float(_uniform(s, m))
             for i, (s, m) in enumerate(zip(jax.random.split(k, 4),
                                            (0.3, 0.2, 0.1, 0.2)))],
         0.3, 0.2, 0.1, 0.2)),
    ("image_random_color_jitter", dict(contrast=0.5),
     lambda x, k: tops.color_jitter_body(
         x, [1.0, 1.0 + float(_uniform(jax.random.split(k, 4)[1], 0.5)),
             1.0, 0.0], contrast=0.5)),
    ("image_random_lighting", dict(alpha_std=0.1),
     lambda x, k: tops.image_adjust_lighting(
         x, np.asarray(jax.random.normal(k, (3,), jnp.float32)) * 0.1)),
    ("image_random_flip_left_right", {},
     lambda x, k: tops.flip_body(
         x, torch.tensor(bool(jax.random.bernoulli(k))), -2)),
    ("image_random_flip_top_bottom", {},
     lambda x, k: tops.flip_body(
         x, torch.tensor(bool(jax.random.bernoulli(k))), -3)),
]


@pytest.mark.parametrize("name,kw,body", RANDOM,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(RANDOM)])
def test_random_op_body_on_jax_draw(name, kw, body):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        for x in (HWC, NHWC):
            want = np.asarray(getattr(jops, name)(jnp.asarray(x), rng_key=key,
                                                  **kw))
            _close(body(torch.from_numpy(x), key), want,
                   rtol=1e-5, atol=1e-4 if "hue" in name or "jitter" in name
                   else 1e-5)


def test_random_ops_draw_in_range_from_the_device_generator():
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(HWC)
    ratios = [float(tops.image_random_brightness(x, 0.3, generator=gen).sum()
                    / x.sum()) for _ in range(200)]
    assert 0.7 - 1e-5 <= min(ratios) < 0.75 and 1.25 < max(ratios) <= 1.3
    flips = [bool(torch.equal(tops.image_random_flip_left_right(
        x, generator=gen), x)) for _ in range(200)]
    assert 60 < sum(flips) < 140
    draws = torch.stack([torch.stack(tops.color_jitter_draws(
        gen, "cpu", 0.2, 0.3, 0.4, 0.1)) for _ in range(500)])
    for col, m, centre in ((0, 0.2, 1), (1, 0.3, 1), (2, 0.4, 1),
                           (3, 0.1, 0)):
        d = draws[:, col] - centre
        assert -m <= float(d.min()) < -0.9 * m < 0.9 * m < float(d.max()) \
            <= m
    # lighting: eigvec @ (eigval * 0.1 N(0, 1) draws), whose channel i
    # has std sqrt(sum_j (eigvec_ij eigval_j 0.1)^2)
    light = torch.stack([tops.image_random_lighting(
        torch.zeros(3), 0.1, generator=gen) for _ in range(400)])
    want = np.sqrt(((np.array(tops._EIGVEC) * np.array(tops._EIGVAL) * 0.1)
                    ** 2).sum(1))
    np.testing.assert_allclose(light.std(0).numpy(), want, rtol=0.15)
    # the same generator state gives the same draw
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(tops.image_random_hue(x, 0.2, generator=g1),
                       tops.image_random_hue(x, 0.2, generator=g2))


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _both(fn):
    """(port, jax) results of fn(module) with the same seeds."""
    out = []
    for mod in (timg, jimg):
        _seed(3)
        out.append(fn(mod))
    return out


def _val(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


IMG8 = (RS.rand(30, 40, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("fn", [
    lambda m: m.imresize(IMG8, 20, 15),
    lambda m: m.resize_short(IMG8, 16),
    lambda m: m.fixed_crop(IMG8, 3, 4, 20, 10, size=(8, 8)),
    lambda m: m.random_crop(IMG8, (16, 12))[0],
    lambda m: m.center_crop(IMG8, (16, 12))[0],
    lambda m: m.random_size_crop(IMG8, (16, 16), (0.3, 1.0),
                                 (0.75, 1.33))[0],
    lambda m: m.color_normalize(IMG8, np.array([1.0, 2.0, 3.0]),
                                np.array([2.0, 2.0, 4.0])),
    lambda m: m.copyMakeBorder(IMG8, 1, 2, 3, 4, values=7),
    lambda m: m.scale_down((40, 30), (50, 20)),
    lambda m: m.imdecode(jrec._imencode(IMG8, 95, ".png")),
], ids=["imresize", "resize_short", "fixed_crop", "random_crop",
        "center_crop", "random_size_crop", "color_normalize",
        "copyMakeBorder", "scale_down", "imdecode"])
def test_helpers_match_jax(fn):
    got, want = _both(fn)
    np.testing.assert_array_equal(_val(got), _val(want))


def _augmenters(m):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return [m.ResizeAug(20), m.ForceResizeAug((24, 18)),
            m.RandomCropAug((16, 12)), m.CenterCropAug((16, 12)),
            m.RandomSizedCropAug((16, 16), (0.1, 1.0), (0.75, 1.33)),
            m.HorizontalFlipAug(0.5), m.CastAug(),
            m.BrightnessJitterAug(0.3), m.ContrastJitterAug(0.3),
            m.SaturationJitterAug(0.3), m.HueJitterAug(0.2),
            m.ColorJitterAug(0.2, 0.2, 0.2),
            m.LightingAug(0.1, eigval, eigvec),
            m.ColorNormalizeAug(np.array([120.0, 110.0, 100.0]),
                                np.array([60.0, 55.0, 50.0])),
            m.RandomGrayAug(0.5),
            m.SequentialAug([m.CastAug(), m.HorizontalFlipAug(1.0)]),
            m.RandomOrderAug([m.BrightnessJitterAug(0.1),
                              m.ContrastJitterAug(0.1)])]


def test_every_augmenter_matches_jax_on_numpy_and_ndarray():
    img = IMG8.astype(np.float32)
    for i in range(len(_augmenters(timg))):
        for trial in range(3):
            got, want = _both(lambda m: [_augmenters(m)[i](img)
                                         for _ in range(trial + 1)][-1])
            np.testing.assert_array_equal(got, want)
        got, want = _both(lambda m: _augmenters(m)[i](
            m.nd.array(IMG8, dtype="uint8")))
        assert isinstance(got, mt.nd.NDArray) and got.context == mt.cpu()
        np.testing.assert_array_equal(_val(got), _val(want))
        try:
            want = _augmenters(jimg)[i].dumps()
        except TypeError:       # numpy kwargs: neither package's json
            with pytest.raises(TypeError):
                _augmenters(timg)[i].dumps()
        else:
            assert _augmenters(timg)[i].dumps() == want


def test_create_augmenter_lists_match():
    kw = dict(resize=20, rand_crop=True, rand_resize=True, rand_mirror=True,
              mean=True, std=True, brightness=0.1, contrast=0.1,
              saturation=0.1, hue=0.1, pca_noise=0.1, rand_gray=0.2)
    t = timg.CreateAugmenter((3, 16, 16), **kw)
    j = jimg.CreateAugmenter((3, 16, 16), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    assert [a.dumps() for a in t[:-1]] == [a.dumps() for a in j[:-1]]
    t = timg.CreateDetAugmenter((3, 16, 16), rand_crop=0.5, rand_pad=0.5,
                                rand_mirror=True, mean=True, std=True)
    j = jimg.CreateDetAugmenter((3, 16, 16), rand_crop=0.5, rand_pad=0.5,
                                rand_mirror=True, mean=True, std=True)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]


@pytest.fixture(scope="module")
def jpeg_rec(tmp_path_factory):
    """A JPEG .rec written by the JAX package: 10 images of 36 x 44."""
    d = tmp_path_factory.mktemp("jpeg")
    rec, idx = str(d / "img.rec"), str(d / "img.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(21)
    for i in range(10):
        img = (rs.rand(36, 44, 3) * 255).astype(np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 4), i, 0),
                                     img, quality=90))
    w.close()
    return rec, idx


def _epochs(it, n=2):
    out = []
    for epoch in range(n):
        if epoch:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        np.testing.assert_array_equal(la, lb)
        assert da.dtype == db.dtype == np.float32
        np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True, mean=True,
         std=True, brightness=0.2, contrast=0.2, saturation=0.2),
    dict(resize=40, rand_resize=True, rand_crop=True, hue=0.1,
         pca_noise=0.1, rand_gray=0.3, last_batch_handle="roll_over"),
    dict(last_batch_handle="discard", inter_method=1),
], ids=["photometric", "resize-rollover", "discard"])
def test_image_iter_matches_jax(jpeg_rec, kw):
    rec, idx = jpeg_rec
    runs = []
    for mod in (timg, jimg):
        _seed(5)
        it = mod.ImageIter(4, (3, 24, 24), path_imgrec=rec, **kw)
        runs.append(_epochs(it))
    _same_batches(*runs)
    assert runs[0][0][0].shape == (4, 3, 24, 24)


def test_image_iter_threaded_decode_equals_sync_and_jax(jpeg_rec):
    rec, idx = jpeg_rec
    runs = []
    for mod, threads in ((timg, 0), (timg, 2), (jimg, 2)):
        _seed(6)
        it = mod.ImageIter(3, (3, 24, 24), path_imgrec=rec, shuffle=True,
                           rand_crop=True, rand_mirror=True,
                           preprocess_threads=threads)
        runs.append(_epochs(it))
    _same_batches(runs[0], runs[1])
    _same_batches(runs[1], runs[2])


@pytest.fixture(scope="module")
def det_files(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("det")
    imglist = []
    for i in range(5):
        img = (np.random.RandomState(i).rand(40, 60, 3) * 255) \
            .astype(np.uint8)
        cv2.imwrite(str(d / ("im%d.png" % i)), img)
        objs = [[i % 3, 0.1, 0.2, 0.5, 0.6]]
        if i % 2:
            objs.append([1, 0.4, 0.3, 0.9, 0.8])
        imglist.append(([2, 5] + [v for o in objs for v in o],
                        "im%d.png" % i))
    return str(d), imglist


@pytest.mark.parametrize("threads", [0, 2])
def test_image_det_iter_matches_jax(det_files, threads):
    root, imglist = det_files
    runs = []
    for mod in (timg, jimg):
        _seed(8)
        it = mod.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                              imglist=list(imglist), path_root=root,
                              shuffle=True, rand_crop=0.5, rand_pad=0.5,
                              rand_mirror=True, mean=True, std=True,
                              preprocess_threads=threads)
        assert it.provide_label[0].shape == (2, 2, 5)
        runs.append(_epochs(it))
    _same_batches(*runs)
    t = timg.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                          imglist=list(imglist)[:1], path_root=root)
    big = timg.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                            imglist=list(imglist), path_root=root)
    big.sync_label_shape(t)
    assert t.provide_label[0].shape == (2, 2, 5)


def test_det_augmenters_match_jax():
    label = np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.8],
                      [-1, -1, -1, -1, -1]], np.float32)
    for make in (lambda m: m.DetHorizontalFlipAug(0.5),
                 lambda m: m.DetRandomCropAug(0.1, (0.75, 1.33), (0.3, 1.0)),
                 lambda m: m.DetRandomPadAug(),
                 lambda m: m.DetRandomSelectAug([m.DetHorizontalFlipAug(1.0)],
                                                0.5),
                 lambda m: m.DetBorrowAug(m.ForceResizeAug((20, 16)))):
        for trial in range(3):
            got, want = _both(lambda m: [make(m)(IMG8, label.copy())
                                         for _ in range(trial + 1)][-1])
            np.testing.assert_array_equal(_val(got[0]), _val(want[0]))
            np.testing.assert_array_equal(got[1], want[1])
