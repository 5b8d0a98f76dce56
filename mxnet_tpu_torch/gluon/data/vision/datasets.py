"""Gluon vision datasets (port of
``mxnet_tpu/gluon/data/vision/datasets.py``).

Reference: python/mxnet/gluon/data/vision/datasets.py (MNIST,
FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset).
As in the JAX package, datasets read from `root` only (the reference's
on-disk formats: MNIST idx-ubyte, CIFAR binary batches) and raise a
clear error when absent instead of downloading. Images are NDArrays on
the context current where the dataset is made.
"""

import gzip
import os
import struct
import warnings

import numpy as np

from .... import ndarray as nd
from .... import image as _image_mod
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        super(_DownloadedDataset, self).__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError()


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise IOError(
        "%s not found. Datasets are not downloaded — place the dataset "
        "files under the dataset root yourself." % path)


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files under `root` (no auto-download)."""

    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super(MNIST, self).__init__(root, transform)

    def _get_data(self):
        image_file, label_file = (os.path.join(self._root, f)
                                  for f in self._files[self._train])
        with _open_maybe_gz(label_file) as fin:
            magic, num = struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(num), dtype=np.uint8) \
                .astype(np.int32)
        with _open_maybe_gz(image_file) as fin:
            magic, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(num * rows * cols),
                                 dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._data = nd.array(data, dtype="uint8")
        self._label = label


class FashionMNIST(MNIST):
    """FashionMNIST — same idx format as MNIST, different root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super(FashionMNIST, self).__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the binary batch files under `root`."""

    _train_files = ["data_batch_%d.bin" % i for i in range(1, 6)]
    _test_files = ["test_batch.bin"]
    _rec_len = 3073

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super(CIFAR10, self).__init__(root, transform)

    def _read_batch(self, filename):
        with _open_maybe_gz(filename) as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, self._rec_len)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        data, label = zip(*[self._read_batch(os.path.join(self._root, f))
                            for f in files])
        self._data = nd.array(np.concatenate(data), dtype="uint8")
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR100 binary format; fine_label selects the 100-class label."""

    _train_files = ["train.bin"]
    _test_files = ["test.bin"]
    _rec_len = 3074

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super(CIFAR100, self).__init__(root, train, transform)

    def _read_batch(self, filename):
        with _open_maybe_gz(filename) as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, self._rec_len)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a RecordIO file (recordio.pack_img)."""

    def __init__(self, filename, flag=1, transform=None):
        super(ImageRecordDataset, self).__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        record = super(ImageRecordDataset, self).__getitem__(idx)
        header, img = recordio.unpack(record)
        img = _image_mod.imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """root/category/image.ext layout; label = sorted folder index."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path,
                              stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn(
                        "Ignoring %s of type %s. Only support %s" % (
                            filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        filename, label = self.items[idx]
        if filename.endswith(".npy"):
            img = nd.array(np.load(filename))
        else:
            img = _image_mod.imread(filename, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
