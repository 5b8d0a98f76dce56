"""Gluon vision transforms (port of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Reference: python/mxnet/gluon/data/vision/transforms.py. Host-side
transforms (decode/resize/crop) run in numpy/cv2; the pure-math ones
(Cast, ToTensor, Normalize) are HybridBlocks over the ``_image_*`` ops
(``F.image.*``), so they also hybridize, and take a numpy array
through in numpy, as DataLoader workers give them.
"""

import random as pyrandom

import numpy as np

from .... import image as _image
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CropResize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray"]


class Compose(Sequential):
    """Sequentially composes transforms."""

    def __init__(self, transforms):
        super(Compose, self).__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super(Cast, self).__init__()
        self._dtype = dtype

    def forward(self, x):
        # numpy passthrough: DataLoader workers stay in numpy
        if isinstance(x, np.ndarray):
            return x.astype(self._dtype)
        return super(Cast, self).forward(x)

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] via the _image_to_tensor op
    (handles NHWC batches too; rank is resolved at trace time)."""

    def forward(self, x):
        # numpy passthrough: DataLoader workers stay in numpy
        if isinstance(x, np.ndarray):
            out = x.astype(np.float32) / 255.0
            axes = (2, 0, 1) if out.ndim == 3 else (0, 3, 1, 2)
            return out.transpose(axes)
        return super(ToTensor, self).forward(x)

    def hybrid_forward(self, F, x):
        return F.image.to_tensor(x)


class Normalize(HybridBlock):
    """(x - mean) / std on CHW (or NCHW) float input via _image_normalize
    — an op available in both nd and sym namespaces, so hybridize works."""

    def __init__(self, mean=0.0, std=1.0):
        super(Normalize, self).__init__()
        self._mean = tuple(np.atleast_1d(np.asarray(mean, np.float32)))
        self._std = tuple(np.atleast_1d(np.asarray(std, np.float32)))
        # per-image hot loop constants (numpy passthrough path)
        self._mean_np = np.asarray(self._mean, np.float32).reshape(-1, 1, 1)
        self._std_np = np.asarray(self._std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        if isinstance(x, np.ndarray):  # CHW or NCHW float
            return (x.astype(np.float32) - self._mean_np) / self._std_np
        return super(Normalize, self).forward(x)

    def hybrid_forward(self, F, x):
        return F.image.normalize(x, mean=self._mean, std=self._std)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super(Resize, self).__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                return _image.resize_short(x, self._size, self._interp)
            return _image.imresize(x, self._size, self._size, self._interp)
        return _image.imresize(x, self._size[0], self._size[1],
                               self._interp)


class CropResize(Block):
    """Fixed-window crop at (x, y, w, h), optionally resized to `size`
    (reference transforms.py CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super(CropResize, self).__init__()
        self._x = x
        self._y = y
        self._w = width
        self._h = height
        self._size = size
        self._interp = interpolation

    def forward(self, x):
        size = None
        if self._size is not None:
            size = (self._size, self._size) \
                if isinstance(self._size, int) else tuple(self._size)
        return _image.fixed_crop(x, self._x, self._y, self._w, self._h,
                                 size, self._interp)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super(CenterCrop, self).__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        return _image.center_crop(x, self._size, self._interp)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super(RandomResizedCrop, self).__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        return _image.random_size_crop(x, self._size, self._scale,
                                       self._ratio, self._interp)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if pyrandom.random() < 0.5:
            arr = _image._as_np(x)[:, ::-1]
            return _image._like(x, np.ascontiguousarray(arr))
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if pyrandom.random() < 0.5:
            arr = _image._as_np(x)[::-1]
            return _image._like(x, np.ascontiguousarray(arr))
        return x


class _JitterBlock(Block):
    aug_cls = None

    def __init__(self, amount):
        super(_JitterBlock, self).__init__()
        self._aug = self.aug_cls(amount)

    def forward(self, x):
        return self._aug(x)


class RandomBrightness(_JitterBlock):
    aug_cls = _image.BrightnessJitterAug


class RandomContrast(_JitterBlock):
    aug_cls = _image.ContrastJitterAug


class RandomSaturation(_JitterBlock):
    aug_cls = _image.SaturationJitterAug


class RandomHue(_JitterBlock):
    aug_cls = _image.HueJitterAug


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super(RandomColorJitter, self).__init__()
        self._aug = _image.ColorJitterAug(brightness, contrast, saturation)
        self._hue = _image.HueJitterAug(hue) if hue else None

    def forward(self, x):
        x = self._aug(x)
        if self._hue:
            x = self._hue(x)
        return x


class RandomLighting(Block):
    def __init__(self, alpha):
        super(RandomLighting, self).__init__()
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        self._aug = _image.LightingAug(alpha, eigval, eigvec)

    def forward(self, x):
        return self._aug(x)


class RandomGray(Block):
    def __init__(self, p=0.5):
        super(RandomGray, self).__init__()
        self._aug = _image.RandomGrayAug(p)

    def forward(self, x):
        return self._aug(x)
