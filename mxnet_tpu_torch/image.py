"""mx.image — image IO, processing and augmentation pipeline (port of
``mxnet_tpu/image.py``).

Reference: python/mxnet/image/image.py (2504 LoC Python-side pipeline)
and the C++ augmenters (src/io/image_aug_default.cc:565). Decode and
augmentation stay on the host in numpy and OpenCV (cv2, imported at
first use: a host without it decodes nothing here). ``ImageIter`` and
``ImageDetIter`` stack a batch's HWC rows on the host and make ONE
host-to-device copy of the stack, in its own dtype (uint8 for decoded
images), then cast to float32 and permute to NCHW on the device of the
context current where the batch is made. The device-side normalize and
flips are also the ops of ``ops/image_ops.py``. Random augmenters draw
from Python's ``random`` and numpy's global state, as the reference's
do, so the same seeds give the same images in both packages.
"""

import math
import os
import random as pyrandom

import numpy as np
import torch

from . import ndarray as nd
from .base import MXNetError
from .context import current_context
from .io import DataIter, DataBatch, DataDesc

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "scale_down", "copyMakeBorder",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "CastAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "HorizontalFlipAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "CreateAugmenter",
           "ImageIter"]


def _cv2():
    try:
        import cv2
    except ImportError:
        raise MXNetError("cv2 (OpenCV) is required for image decode ops")
    return cv2


def _as_np(img):
    return img.asnumpy() if isinstance(img, nd.NDArray) else np.asarray(img)


def _like(src, arr):
    """Return `arr` in the container type of `src` (an NDArray on src's
    context): the public API is NDArray-in/NDArray-out (reference
    image.py), but the iterator hot loop feeds plain numpy through the
    augmenter chain, since a per-image NDArray costs a device copy each."""
    if isinstance(src, nd.NDArray):
        return nd.array(arr, ctx=src.context, dtype=arr.dtype.name)
    return arr


def _imdecode_np(buf, flag=1, to_rgb=True):
    """cv2-only decode to an HWC uint8 numpy array — safe on worker
    threads (no tensor is made)."""
    cv2 = _cv2()
    if isinstance(buf, (bytes, bytearray)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    img = cv2.imdecode(buf, int(flag))
    if img is None:
        raise MXNetError("Decoding failed. Invalid image buffer.")
    if to_rgb and img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to an HWC uint8 NDArray
    (reference imdecode: python/mxnet/image/image.py:imdecode)."""
    return nd.array(_imdecode_np(buf, flag, to_rgb), dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    img = _cv2().resize(_as_np(src), (w, h), interpolation=int(interp))
    if img.ndim == 2:
        img = img[:, :, None]
    return _like(src, img)


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    h, w = _as_np(src).shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def copyMakeBorder(src, top, bot, left, right, border_type=0, values=0):
    img = _cv2().copyMakeBorder(_as_np(src), top, bot, left, right,
                             border_type, value=values)
    return _like(src, img)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = _as_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        arr = _as_np(imresize(arr, *size, interp=interp))
    return _like(src, arr)


def random_crop(src, size, interp=2):
    h, w = _as_np(src).shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = _as_np(src).shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = _as_np(src).shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    arr = _as_np(src).astype(np.float32)
    out = arr - np.asarray(_as_np(mean), np.float32)
    if std is not None:
        out = out / np.asarray(_as_np(std), np.float32)
    return _like(src, out)




def _nchw_f32(batch_np, device):
    """(B, H, W, C) host stack -> (B, C, H, W) float32 tensor on
    ``device``: the stack is copied in its own dtype (a uint8 stack moves
    4x fewer bytes than float32), then cast and permuted there in one
    copy into a contiguous NCHW tensor."""
    host = torch.from_numpy(np.ascontiguousarray(batch_np))
    return host.to(device).permute(0, 3, 1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)


def _np_safe_aug(aug):
    """True when an augmenter (and everything it wraps) is defined in
    this module — such chains are type-preserving, so the iterator can
    feed plain numpy through them (no per-image device_put). User
    subclasses fall back to the NDArray contract."""
    if type(aug).__module__ != __name__:
        return False
    children = []
    for attr in ("ts", "aug_list"):
        children.extend(getattr(aug, attr, ()) or ())
    if getattr(aug, "augmenter", None) is not None:
        children.append(aug.augmenter)
    return all(_np_safe_aug(c) for c in children)


# ----------------------------------------------------------- augmenters --
class Augmenter(object):
    """Image augmenter base (image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super(SequentialAug, self).__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super(RandomOrderAug, self).__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super(ResizeAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super(ForceResizeAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, *self.size, interp=self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super(RandomCropAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super(RandomSizedCropAug, self).__init__(size=size, area=area,
                                                 ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super(CenterCropAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super(HorizontalFlipAug, self).__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            # copy: downstream cv2 augs reject negative-stride views
            return _like(src, np.ascontiguousarray(_as_np(src)[:, ::-1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super(CastAug, self).__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        if isinstance(src, nd.NDArray):
            return src.astype(self.typ)
        return np.asarray(src).astype(self.typ)


# ITU-R BT.601 luma weights, shared by the photometric jitter family
_LUMA = np.array([[[0.299, 0.587, 0.114]]], np.float32)


class _PhotometricJitterAug(Augmenter):
    """Shared machinery: blend the image toward a reference signal by a
    random strength drawn from U(1-jitter, 1+jitter)."""

    def __init__(self, jitter, **kwargs):
        super(_PhotometricJitterAug, self).__init__(**kwargs)
        self.jitter = jitter

    def reference(self, arr):
        """The signal to blend toward at alpha -> 0; subclasses override."""
        raise NotImplementedError

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.jitter, self.jitter)
        arr = _as_np(src).astype(np.float32)
        return _like(src, arr * alpha + self.reference(arr) * (1.0 - alpha))


class BrightnessJitterAug(_PhotometricJitterAug):
    """Blend toward black."""

    def __init__(self, brightness):
        super(BrightnessJitterAug, self).__init__(brightness,
                                                  brightness=brightness)
        self.brightness = brightness

    def reference(self, arr):
        return 0.0


class ContrastJitterAug(_PhotometricJitterAug):
    """Blend toward the image's mean luma (a flat gray)."""

    def __init__(self, contrast):
        super(ContrastJitterAug, self).__init__(contrast, contrast=contrast)
        self.contrast = contrast

    def reference(self, arr):
        return (arr * _LUMA).sum() * (3.0 / arr.size)


class SaturationJitterAug(_PhotometricJitterAug):
    """Blend toward the per-pixel luma (desaturate)."""

    def __init__(self, saturation):
        super(SaturationJitterAug, self).__init__(saturation,
                                                  saturation=saturation)
        self.saturation = saturation

    def reference(self, arr):
        return (arr * _LUMA).sum(axis=2, keepdims=True)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super(HueJitterAug, self).__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]])
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]])
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        arr = _as_np(src).astype(np.float32)
        return _like(src, np.dot(arr, t).astype(np.float32))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super(ColorJitterAug, self).__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super(LightingAug, self).__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _like(src, _as_np(src) + rgb.astype(np.float32))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super(ColorNormalizeAug, self).__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super(RandomGrayAug, self).__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _like(src, np.dot(_as_np(src).astype(np.float32),
                                     self._mat))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter list factory (image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image iterator over .rec files or path-imglist with augmenters
    (reference python/mxnet/image/image.py ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", last_batch_handle="pad",
                 **kwargs):
        super(ImageIter, self).__init__()
        from . import recordio
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            idx_path = path_imgidx or \
                os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                     "r")
            self.seq = list(self.imgrec.keys)
            if not self.seq:
                # a wrong/missing .idx silently yields an empty epoch —
                # fail loudly instead (tools/im2rec writes 'name.idx'
                # next to 'name.rec'; MXIndexedRecordIO(w) with an
                # explicit idx path may have put it elsewhere)
                raise MXNetError(
                    "record index %r has no entries — wrong or missing "
                    ".idx for %r? (pass path_imgidx explicitly)"
                    % (idx_path, path_imgrec))
        else:
            if path_imglist:
                imglist = {}
                with open(path_imglist) as fin:
                    for line in fin:
                        line = line.strip().split("\t")
                        label = np.array(line[1:-1], dtype=np.float32)
                        imglist[int(line[0])] = (label, line[-1])
            else:
                imglist = {i: (np.array(item[0], dtype=np.float32)
                               if not np.isscalar(item[0])
                               else np.array([item[0]], dtype=np.float32),
                               item[1])
                           for i, item in enumerate(imglist)}
            self.imglist = imglist
            self.seq = list(imglist.keys())
        self.path_root = path_root
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        self.preprocess_threads = int(kwargs.pop("preprocess_threads", 0))
        self.auglist = aug_list if aug_list is not None \
            else CreateAugmenter(data_shape, **kwargs)
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + data_shape, "float32")]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name,
                                           (batch_size, label_width),
                                           "float32")]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,),
                                           "float32")]
        self.last_batch_handle = last_batch_handle
        self._cache = []
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle:
            pyrandom.shuffle(self.seq)
        self.cur = 0
        if getattr(self, "_pending", None):
            self._pending = []

    def next_sample(self):
        from . import recordio
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            s = self.imgrec.read_idx(idx)
            header, img = recordio.unpack(s)
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root or "", fname), "rb") as f:
            return label, f.read()

    def _next_raw_decoded(self):
        """Next (label, decoded HWC uint8 array). With
        preprocess_threads > 0 the JPEG decode (the dominant cost; cv2
        releases the GIL) runs on a thread pool a batch ahead — the
        reference ImageRecordIter's threaded decode loop
        (iter_image_recordio_2.cc:76,146). Augmenters stay on the
        calling thread: their random draws must come in sample order.
        Shared by ImageIter and ImageDetIter (whose augmenters also
        transform labels)."""
        if self.preprocess_threads > 0:
            if getattr(self, "_pool", None) is None:
                import concurrent.futures as _cf
                # our pool replaces OpenCV's internal one: concurrent
                # cv2 calls from several threads deadlock its global
                # worker pool otherwise (same reason the reference pins
                # OMP threads around its decode loop)
                _cv2().setNumThreads(0)
                self._pool = _cf.ThreadPoolExecutor(self.preprocess_threads)
                self._pending = []
            depth = max(self.batch_size, 2 * self.preprocess_threads)
            try:
                while len(self._pending) < depth:
                    label, s = self.next_sample()
                    self._pending.append(
                        (label, self._pool.submit(_imdecode_np, s)))
            except StopIteration:
                pass
            if not self._pending:
                raise StopIteration
            label, fut = self._pending.pop(0)
            return label, fut.result()
        label, s = self.next_sample()
        return label, _imdecode_np(s)

    def _augs_np_fast(self):
        flag = getattr(self, "_np_fast", None)
        if flag is None:
            flag = all(_np_safe_aug(a) for a in self.auglist)
            self._np_fast = flag
        return flag

    def _decoded_sample(self):
        """Next (HWC array, label row), from the rollover cache first.
        Built-in augmenter chains run entirely in numpy; user augmenters
        get the reference's NDArray-in/NDArray-out contract (at
        per-image wrapping cost). Plain float32 CastAugs are deferred to
        the batched device-side conversion (every built-in augmenter
        upcasts internally as needed)."""
        if self._cache:
            return self._cache.pop(0)
        label, arr = self._next_raw_decoded()
        if self._augs_np_fast():
            img = arr
            for aug in self.auglist:
                if type(aug) is CastAug and aug.typ == "float32":
                    continue
                img = aug(img)
        else:
            img = nd.array(arr, dtype="uint8")
            for aug in self.auglist:
                img = aug(img)
        return _as_np(img), label

    def _label_batch_shape(self):
        """Trailing label dims of one batch row — (label_width,) here;
        ImageDetIter overrides with its (max_objects, object_width)."""
        return (self.label_width,)

    def _assemble(self, rows, pad):
        """Stack HWC rows on the host and make ONE copy of the stack to
        the current context's device, where the cast to float32 and the
        NCHW permute run (``_nchw_f32``), in place of per-image float
        casts and strided CHW copies on the host."""
        batch_np = np.stack([r[0] for r in rows])
        batch_label = np.zeros((self.batch_size,)
                               + self._label_batch_shape(), np.float32)
        for i, (_, label) in enumerate(rows):
            batch_label[i] = label
        label_out = batch_label[:, 0] if batch_label.ndim == 2 \
            and self.label_width == 1 else batch_label
        ctx = current_context()
        data = nd.NDArray(_nchw_f32(batch_np, ctx.torch_device), ctx)
        return DataBatch(data=[data], label=[nd.array(label_out, ctx=ctx)],
                         pad=pad)

    def next(self):
        rows = []
        try:
            while len(rows) < self.batch_size:
                rows.append(self._decoded_sample())
        except StopIteration:
            if not rows:
                raise
            if self.last_batch_handle == "discard":
                raise
            if self.last_batch_handle == "roll_over":
                self._cache = rows  # ragged remainder joins next epoch
                raise StopIteration
            # 'pad': fill with real samples wrapped from the epoch start
            # (reference ImageIter semantics) — pad stays set so aware
            # consumers can discard them
            pad = self.batch_size - len(rows)
            self.cur = 0
            while len(rows) < self.batch_size:
                if self.cur >= len(self.seq):
                    self.cur = 0  # dataset smaller than the pad: keep cycling
                rows.append(self._decoded_sample())
            self.cur = len(self.seq)  # next() must still end the epoch
            if getattr(self, "_pending", None):
                # drop samples the pad-fill prefetched past the epoch
                # boundary: leftovers would keep next() serving forever
                self._pending = []
            return self._assemble(rows, pad)
        return self._assemble(rows, pad=self.batch_size - len(rows))


# ---------------------------------------------------------- detection --
# Reference: python/mxnet/image/detection.py — the SSD-style pipeline
# where every augmentation transforms the image AND its box labels.
# Label wire format (im2rec detection packing): [header_width A,
# object_width B, <extra header>, obj0[B], obj1[B], ...] with each
# object [cls_id, xmin, ymin, xmax, ymax] in normalized coordinates.

class DetAugmenter(object):
    """Base detection augmenter: __call__(src, label) -> (src, label)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline (labels
    pass through — only photometric/normalize augs are safe to borrow)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly apply exactly one of aug_list (or none, with skip_prob)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = _like(src, np.ascontiguousarray(_as_np(src)[:, ::-1]))
            out = label.copy()
            valid = out[:, 0] >= 0
            xmin = out[valid, 1].copy()
            out[valid, 1] = 1.0 - out[valid, 3]
            out[valid, 3] = 1.0 - xmin
            label = out
        return src, label


def _box_overlap_frac(boxes, crop):
    """Fraction of each box's area inside crop (x0, y0, x1, y1)."""
    ix = np.maximum(0.0, np.minimum(boxes[:, 3], crop[2])
                    - np.maximum(boxes[:, 1], crop[0]))
    iy = np.maximum(0.0, np.minimum(boxes[:, 4], crop[3])
                    - np.maximum(boxes[:, 2], crop[1]))
    inter = ix * iy
    area = np.maximum(1e-12, (boxes[:, 3] - boxes[:, 1])
                      * (boxes[:, 4] - boxes[:, 2]))
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained to keep objects reasonably covered
    (reference python/mxnet/image/detection.py:237-269: sample up to
    max_attempts crops in the area/aspect ranges; a candidate is
    accepted only when the MINIMUM coverage over all overlapping valid
    objects exceeds min_object_covered; min_eject_coverage then applies
    to the ACCEPTED crop's label update, dropping objects whose
    remaining coverage is at or below it)."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _as_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, math.sqrt(area * ratio))
            ch = min(1.0, math.sqrt(area / ratio))
            x0 = pyrandom.uniform(0, 1 - cw)
            y0 = pyrandom.uniform(0, 1 - ch)
            crop = (x0, y0, x0 + cw, y0 + ch)
            valid = label[:, 0] >= 0
            if not valid.any():
                break
            cov = _box_overlap_frac(label[valid], crop)
            # acceptance: min coverage over ALL overlapping objects must
            # exceed min_object_covered (reference
            # _check_satisfy_constraints: np.amin(coverages) >
            # min_object_covered over coverages > 0) — crops that
            # partially lose any object beyond the threshold are retried
            overlapping = cov[cov > 0]
            if overlapping.size == 0 or \
                    np.amin(overlapping) <= self.min_object_covered:
                continue
            # label update of the accepted crop: eject objects whose
            # coverage is at or below min_eject_coverage (reference
            # _update_labels: valid &= coverage > min_eject_coverage)
            keep = cov > self.min_eject_coverage
            if not keep.any():
                continue
            out = np.full_like(label, -1.0)
            kept = label[valid][keep].copy()
            # clip to the crop window and renormalize
            kept[:, 1] = (np.clip(kept[:, 1], x0, crop[2]) - x0) / cw
            kept[:, 3] = (np.clip(kept[:, 3], x0, crop[2]) - x0) / cw
            kept[:, 2] = (np.clip(kept[:, 2], y0, crop[3]) - y0) / ch
            kept[:, 4] = (np.clip(kept[:, 4], y0, crop[3]) - y0) / ch
            out[:len(kept)] = kept
            px0, py0 = int(x0 * w), int(y0 * h)
            px1, py1 = int(math.ceil(crop[2] * w)), \
                int(math.ceil(crop[3] * h))
            return _like(src, arr[py0:py1, px0:px1].copy()), out
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Place the image on a larger canvas (zoom-out) and rescale boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _as_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            ch = math.sqrt(area / ratio)
            cw = math.sqrt(area * ratio)
            if ch < 1.0 or cw < 1.0:
                continue
            nh, nw = int(h * ch), int(w * cw)
            y0 = pyrandom.randint(0, nh - h)
            x0 = pyrandom.randint(0, nw - w)
            canvas = np.empty((nh, nw, arr.shape[2]), arr.dtype)
            canvas[...] = np.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = arr
            out = label.copy()
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * w + x0) / nw
            out[valid, 3] = (out[valid, 3] * w + x0) / nw
            out[valid, 2] = (out[valid, 2] * h + y0) / nh
            out[valid, 4] = (out[valid, 4] * h + y0) / nh
            return _like(src, canvas), out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0., rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation pipeline (reference
    CreateDetAugmenter): geometric det-augs + borrowed photometric augs
    + final forced resize to data_shape."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.814],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is not None or std is not None:
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(CastAug()))
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: batches (data, padded object labels).

    Labels parse from the im2rec detection header [A, B, ...extra,
    objects...]; every batch emits (batch, max_objects, object_width)
    padded with -1 (reference ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        # split kwargs: iterator options go to ImageIter, the rest are
        # detection-augmenter parameters
        parent_keys = ("part_index", "num_parts", "preprocess_threads")
        parent_kw = {k: kwargs.pop(k) for k in parent_keys if k in kwargs}
        super(ImageDetIter, self).__init__(
            batch_size=batch_size, data_shape=data_shape,
            path_imgrec=path_imgrec, path_imglist=path_imglist,
            path_root=path_root, path_imgidx=path_imgidx,
            shuffle=shuffle, aug_list=[] if aug_list is None else aug_list,
            imglist=imglist, data_name=data_name, label_name=label_name,
            last_batch_handle=last_batch_handle, **parent_kw)
        if aug_list is None:
            self.auglist = CreateDetAugmenter(data_shape, **kwargs)
        elif kwargs:
            raise TypeError(
                "unexpected keyword arguments with an explicit aug_list: "
                "%s" % sorted(kwargs))
        # scan labels once for (max_objects, object_width)
        max_obj, owidth = 1, 5
        for idx in self.seq:
            lab = self._raw_label(idx)
            parsed = self._parse_det_label(lab)
            max_obj = max(max_obj, parsed.shape[0])
            owidth = parsed.shape[1]
        self._max_objects = max_obj
        self._object_width = owidth
        self.provide_label = [DataDesc(
            label_name, (batch_size, max_obj, owidth), "float32")]

    def _label_batch_shape(self):
        return (self._max_objects, self._object_width)

    def _raw_label(self, idx):
        from . import recordio
        if self.imgrec is not None:
            header, _ = recordio.unpack(self.imgrec.read_idx(idx))
            return np.asarray(header.label, dtype=np.float32)
        return self.imglist[idx][0]

    @staticmethod
    def _parse_det_label(label):
        """[A, B, extra..., obj0[B]...] -> (num_obj, B) array; raw flat
        object lists (no header) fall back to width 5."""
        label = np.asarray(label, dtype=np.float32).ravel()
        if label.size >= 2 and 1 <= label[0] <= 16 and \
                2 <= label[1] <= 16:
            a, b = int(label[0]), int(label[1])
            body = label[a:]
        else:
            b = 5
            body = label
        n = body.size // b
        return body[:n * b].reshape(n, b).copy()

    def _decoded_sample(self):
        # decode via the shared (optionally threaded) prefetch path;
        # label parsing and the label-transforming det augmenters run on
        # the calling thread
        if self._cache:
            return self._cache.pop(0)
        label, arr = self._next_raw_decoded()
        img = arr if self._augs_np_fast() else nd.array(arr, dtype="uint8")
        parsed = self._parse_det_label(label)
        padded = np.full((self._max_objects, self._object_width), -1.0,
                         np.float32)
        padded[:len(parsed)] = parsed
        for aug in self.auglist:
            img, padded = aug(img, padded)
        return _as_np(img), padded

    def reshape(self, data_shape=None, label_shape=None):
        """Change batch shapes between bindings (reference reshape)."""
        if data_shape is not None:
            self.data_shape = data_shape
            self.provide_data = [DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + data_shape, "float32")]
        if label_shape is not None:
            self._max_objects, self._object_width = label_shape
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + tuple(label_shape), "float32")]

    def sync_label_shape(self, it, verbose=False):
        """Grow both iterators to the common max label shape (reference
        sync_label_shape, used to align train and val iterators)."""
        assert isinstance(it, ImageDetIter)
        mo = max(self._max_objects, it._max_objects)
        ow = max(self._object_width, it._object_width)
        self.reshape(label_shape=(mo, ow))
        it.reshape(label_shape=(mo, ow))
        return it
