"""Vision datasets (``mxnet_tpu/gluon/data/vision/datasets.py``'s
counterpart): MNIST, FashionMNIST, CIFAR10 and CIFAR100.

Each loads its standard local files from ``root`` (MNIST's idx files,
gzipped or not; CIFAR's binary batches). There is no download. When
the files are absent and ``synthetic_fallback`` is on (the default),
a deterministic synthetic set of the right shapes takes their place:
the JAX package's, array for array (the same seeded numpy draws). A
sample is ``(image, label)``: an HWC ``uint8`` numpy image and an
``int32`` label, or what ``transform(image, label)`` makes of them.
``ImageRecordDataset`` reads packed images from an indexed RecordIO
file (``image, header.label``) and ``ImageFolderDataset`` a
``root/class/image`` tree (``image, class index``); their images are
decoded HWC numpy arrays (``image.imdecode``'s codecs: PIL, or ``NPY0``
records and ``.npy`` files).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ..dataset import Dataset

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform, synthetic_fallback=True):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._synthetic = synthetic_fallback
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic(seed, n, nclass, shape, base_sd, noise_sd, offset):
    """Class-dependent images: a per-class pattern plus noise around
    ``offset``, clipped to [0, 1] and scaled to uint8."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, nclass, n).astype(np.int32)
    base = rng.normal(0, base_sd, (nclass,) + shape)
    noise = rng.normal(0, noise_sd, (n,) + shape)
    data = np.clip(base[label] + noise + offset, 0, 1)
    return (data * 255).astype(np.uint8), label


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (``train-images-idx3-ubyte(.gz)``,
    ...); 28 x 28 x 1 images, 10 classes. Synthetic: 6000 train or
    1000 test samples."""

    _shape = (28, 28, 1)
    _nclass = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic_fallback=True):
        self._train = train
        super().__init__(root, transform, synthetic_fallback)

    def _file_names(self):
        if self._train:
            return "train-images-idx3-ubyte", "train-labels-idx1-ubyte"
        return "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"

    def _get_data(self):
        img_name, lbl_name = self._file_names()
        img_path = self._find(img_name)
        lbl_path = self._find(lbl_name)
        if img_path is None or lbl_path is None:
            if not self._synthetic:
                raise MXNetError(f"MNIST files not found under {self._root} "
                                 f"and there is no download")
            n = 6000 if self._train else 1000
            # noise is drawn after the labels and bases, as the JAX one
            self._data, self._label = _synthetic(
                42 + int(self._train), n, self._nclass, self._shape, 0.05,
                0.1, 0.1307)
            return
        self._label = _read_idx(lbl_path).astype(np.int32)
        self._data = _read_idx(img_path).reshape(-1, 28, 28, 1)

    def _find(self, name):
        for cand in (name, name + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.isfile(p):
                return p
        return None


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, dims = struct.unpack(">HBB", f.read(4))
        shape = tuple(struct.unpack(">I", f.read(4))[0] for _ in range(dims))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class FashionMNIST(MNIST):
    """FashionMNIST: MNIST's files and shapes under another root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic_fallback=True):
        super().__init__(root, train, transform, synthetic_fallback)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its binary batches (``data_batch_1.bin``, ...,
    ``test_batch.bin``, under ``root`` or ``root/cifar-10-batches-bin``);
    32 x 32 x 3 images. Synthetic: 5000 train or 1000 test samples."""

    _shape = (32, 32, 3)
    _nclass = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None, synthetic_fallback=True):
        self._train = train
        super().__init__(root, transform, synthetic_fallback)

    def _synthetic_data(self):
        if not self._synthetic:
            raise MXNetError(f"{type(self).__name__} files not found under "
                             f"{self._root}")
        n = 5000 if self._train else 1000
        self._data, self._label = _synthetic(
            1234 + int(self._train), n, self._nclass, self._shape, 0.08,
            0.15, 0.45)

    def _get_data(self):
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] \
            if self._train else ["test_batch.bin"]
        paths = []
        for f in files:
            for cand in (os.path.join(self._root, f),
                         os.path.join(self._root, "cifar-10-batches-bin", f)):
                if os.path.isfile(cand):
                    paths.append(cand)
                    break
        if len(paths) != len(files):
            self._synthetic_data()
            return
        data_list, label_list = [], []
        for p in paths:
            with open(p, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
            raw = raw.reshape(-1, 3073)
            label_list.append(raw[:, 0].astype(np.int32))
            data_list.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                             .transpose(0, 2, 3, 1))
        self._label = np.concatenate(label_list)
        self._data = np.concatenate(data_list)


class CIFAR100(CIFAR10):
    """CIFAR-100 from ``train.bin``/``test.bin``; coarse labels unless
    ``fine_label``. The synthetic set has 100 classes."""

    _nclass = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None,
                 synthetic_fallback=True):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic_fallback)

    def _get_data(self):
        fname = "train.bin" if self._train else "test.bin"
        path = None
        for cand in (os.path.join(self._root, fname),
                     os.path.join(self._root, "cifar-100-binary", fname)):
            if os.path.isfile(cand):
                path = cand
                break
        if path is None:
            self._synthetic_data()
            return
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8).reshape(-1, 3074)
        self._label = raw[:, 1 if self._fine_label else 0].astype(np.int32)
        self._data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


class ImageRecordDataset(Dataset):
    """Packed images of an indexed RecordIO file (``recordio.pack_img``):
    sample ``i`` is ``(image, label)``."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio
        header, img_bytes = recordio.unpack(self._record[idx])
        img = image._decode_np(img_bytes)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """Images arranged ``root/<class>/<image>`` (``.jpg``, ``.jpeg``,
    ``.png``, ``.npy``); classes in sorted folder order (``synsets``),
    sample ``i`` is ``(image, class index)``."""

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
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            with open(path, "rb") as f:
                img = image._decode_np(f.read())
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
