"""Image loading and augmentation (python/mxnet/image analog).

Port of ``mxnet_tpu/image.py`` (numpy; PIL or ``NPY0`` records for the
codecs, ``recordio.image_codec``). The reference pipeline
(``src/io/image_aug_default.cc`` + ``iter_image_recordio_2.cc``)
decodes, resizes, crops, flips, jitters and normalizes on the host;
here the augmenter chain is numpy, and each batch lands on the
iterator's context (the card unless the caller asks for the CPU) in one
host-to-device copy for the data and one for the labels. Every
augmenter draws from ``np.random`` in the JAX package's order, so a
seeded run gives the JAX package's batches.

The image functions (``imdecode``, ``imresize``, ``resize_short``,
``fixed_crop``, ``center_crop``, ``random_crop``,
``color_normalize``) return NDArrays on the CPU, as the reference's
do; the iterators and augmenters keep numpy between the steps.
"""
from __future__ import annotations

import numpy as np

from . import recordio as _recordio
from .context import cpu, current_context
from .io.io import DataBatch, DataDesc, DataIter
from .ndarray import array as _nd_array

__all__ = [
    "imresize", "imdecode", "resize_short", "fixed_crop", "center_crop",
    "random_crop", "color_normalize", "HorizontalFlipAug", "CastAug",
    "ColorNormalizeAug", "ForceResizeAug", "ResizeAug", "CenterCropAug",
    "RandomCropAug", "RandomSizedCropAug", "CreateAugmenter", "Augmenter",
    "ImageIter",
    "ImageRecordIterPy", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "HueJitterAug", "LightingAug", "RandomGrayAug",
    "RandomOrderAug", "ColorJitterAug",
]


def _as_nd(source, ctx=None):
    """An NDArray of ``source`` on ``ctx`` (the CPU by default)."""
    return _nd_array(source, ctx=ctx if ctx is not None else cpu())


def _np(src):
    return src.asnumpy() if hasattr(src, "asnumpy") else np.asarray(src)


def _nd_typed(a):
    """``a`` in the type an NDArray of it holds (float64 as float32):
    the augmenters that pass an image function's NDArray on in the JAX
    package give these values."""
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _decode_np(buf):
    raw = np.frombuffer(buf, dtype=np.uint8) \
        if isinstance(buf, (bytes, bytearray)) else buf
    img = _recordio._decode_image(raw)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img


def imdecode(buf, to_rgb=1, **kwargs):
    return _as_nd(_decode_np(buf))


def imresize(src, w, h, interp=1):
    return _as_nd(_resize_np(_np(src), w, h))


def _resize_np(img, w, h):
    """Bilinear resize in numpy (no OpenCV in the TPU image)."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img.copy()
    ys = np.linspace(0, ih - 1, h)
    xs = np.linspace(0, iw - 1, w)
    y0 = np.floor(ys).astype(int); y1 = np.minimum(y0 + 1, ih - 1)
    x0 = np.floor(xs).astype(int); x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def _resize_short_np(img, size):
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize_np(img, new_w, new_h)


def resize_short(src, size, interp=2):
    return _as_nd(_resize_short_np(_np(src), size))


def _fixed_crop_np(img, x0, y0, w, h, size=None):
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[0], size[1])
    return out


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    return _as_nd(_fixed_crop_np(_np(src), x0, y0, w, h, size))


def _center_crop_np(img, size):
    h, w = img.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    return (_fixed_crop_np(img, x0, y0, min(new_w, w), min(new_h, h), size),
            (x0, y0, new_w, new_h))


def center_crop(src, size, interp=2):
    out, box = _center_crop_np(_np(src), size)
    return _as_nd(out), box


def _random_crop_np(img, size):
    h, w = img.shape[:2]
    new_w, new_h = size
    x0 = np.random.randint(0, max(1, w - new_w + 1))
    y0 = np.random.randint(0, max(1, h - new_h + 1))
    return (_fixed_crop_np(img, x0, y0, min(new_w, w), min(new_h, h), size),
            (x0, y0, new_w, new_h))


def random_crop(src, size, interp=2):
    out, box = _random_crop_np(_np(src), size)
    return _as_nd(out), box


def color_normalize(src, mean, std=None):
    img = _np(src).astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        img = img / np.asarray(std, np.float32)
    return _as_nd(img)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        img = np.asarray(src)
        return _resize_np(img, self.size[0], self.size[1])


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return _nd_typed(_resize_short_np(np.asarray(src), self.size))


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return _nd_typed(_center_crop_np(np.asarray(src), self.size)[0])


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return _nd_typed(_random_crop_np(np.asarray(src), self.size)[0])


class RandomSizedCropAug(Augmenter):
    """Inception-style random area/aspect crop resized to ``size``
    (reference RandomSizedCropAug: area in [0.08, 1], aspect in
    [3/4, 4/3], 10 attempts then center-crop fallback)."""

    def __init__(self, size, area=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interp=2):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size = size
        self.area = area if isinstance(area, (tuple, list)) else (area, 1.0)
        self.ratio = ratio

    def __call__(self, src):
        img = np.asarray(src)
        h, w = img.shape[:2]
        src_area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self.area) * src_area
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            new_w = int(round(np.sqrt(target_area * aspect)))
            new_h = int(round(np.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h and new_w > 0 and new_h > 0:
                x0 = np.random.randint(0, w - new_w + 1)
                y0 = np.random.randint(0, h - new_h + 1)
                crop = img[y0:y0 + new_h, x0:x0 + new_w]
                return _resize_np(crop, self.size[0], self.size[1])
        return _nd_typed(_center_crop_np(img, self.size)[0])


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        img = np.asarray(src)
        if np.random.random() < self.p:
            img = img[:, ::-1]
        return img


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return np.asarray(src).astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=list(np.atleast_1d(mean)),
                         std=list(np.atleast_1d(std)))
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, src):
        return (np.asarray(src).astype(np.float32) - self.mean) / self.std


_GRAY_COEF = np.array([0.299, 0.587, 0.114], np.float32)


class BrightnessJitterAug(Augmenter):
    """Scale pixel values by 1 + U(-brightness, brightness)
    (reference BrightnessJitterAug)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.brightness, self.brightness)
        return np.asarray(src).astype(np.float32) * alpha


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (reference ContrastJitterAug)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.contrast, self.contrast)
        img = np.asarray(src).astype(np.float32)
        gray_mean = (img * _GRAY_COEF).sum(axis=-1).mean()
        return img * alpha + gray_mean * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray image (reference
    SaturationJitterAug)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.saturation, self.saturation)
        img = np.asarray(src).astype(np.float32)
        gray = (img * _GRAY_COEF).sum(axis=-1, keepdims=True)
        return img * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Rotate hue in YIQ space by U(-hue, hue) (reference HueJitterAug
    — same tyiq/ityiq matrix approximation)."""

    _TYIQ = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], np.float32)
    _ITYIQ = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = np.random.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], np.float32)
        t = self._ITYIQ @ rot @ self._TYIQ
        img = np.asarray(src).astype(np.float32)
        return img @ t.T


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference LightingAug):
    add eigvec @ (N(0, alphastd) * eigval) per image."""

    _EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alphastd):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = self._EIGVEC @ (alpha * self._EIGVAL)
        return np.asarray(src).astype(np.float32) + rgb


class RandomGrayAug(Augmenter):
    """With probability p replace the image by its 3-channel gray
    version (reference RandomGrayAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        img = np.asarray(src).astype(np.float32)
        if np.random.rand() < self.p:
            gray = (img * _GRAY_COEF).sum(axis=-1, keepdims=True)
            img = np.repeat(gray, 3, axis=-1)
        return img


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference
    RandomOrderAug — the ColorJitter composition uses it)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        """Nest the children (reference RandomOrderAug.dumps)."""
        import json
        return json.dumps([type(self).__name__,
                           [json.loads(t.dumps()) for t in self.ts]])

    def __call__(self, src):
        order = np.random.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Random-order brightness/contrast/saturation jitter (reference
    ColorJitterAug — a RandomOrderAug subclass, so isinstance checks
    ported from upstream keep working)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)
        self._kwargs = {"brightness": brightness, "contrast": contrast,
                        "saturation": saturation}


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter chain (python/mxnet/image
    CreateAugmenter), photometric jitters included in the reference's
    order: geometric -> cast -> color jitter -> hue -> lighting ->
    gray -> normalize."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        # reference: rand_resize implies random crop (area/aspect jitter)
        auglist.append(RandomSizedCropAug(crop_size, interp=inter_method))
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
        auglist.append(LightingAug(pca_noise))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Python-side image iterator over RecordIO or image list
    (python/mxnet/image/image.py ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32", ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist is not None
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.ctx = ctx or current_context()
        self.dtype = dtype
        self.data_name = data_name
        self.label_name = label_name
        self.imgrec = None
        self.seq = None
        self.imglist = {}
        if path_imgrec:
            if path_imgidx:
                self.imgrec = _recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = _recordio.MXRecordIO(path_imgrec, "r")
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
            self.path_root = path_root
        elif imglist is not None:
            for i, (label, path) in enumerate(imglist):
                self.imglist[i] = (
                    np.atleast_1d(np.asarray(label, np.float32)), path)
            self.seq = list(self.imglist.keys())
            self.path_root = path_root
        if num_parts > 1 and self.seq is not None:
            self.seq = self.seq[part_index::num_parts]
        self.shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter((data_shape[0], data_shape[1], data_shape[2]), **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "hue", "pca_noise", "rand_gray",
                         "inter_method")})
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape, self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape, self.dtype)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            np.random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = _recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(f"{self.path_root}/{fname}", "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = _recordio.unpack(s)
        return header.label, img

    def next(self):
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              dtype=self.dtype)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, raw = self.next_sample()
                img = _decode_np(raw)
                for aug in self.auglist:
                    img = aug(img)
                batch_data[i] = np.transpose(img, (2, 0, 1))  # HWC→CHW
                batch_label[i] = np.atleast_1d(
                    np.asarray(label, np.float32))[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        label_out = batch_label[:, 0] if self.label_width == 1 else batch_label
        return DataBatch(data=[_as_nd(batch_data, ctx=self.ctx)],
                         label=[_as_nd(label_out, ctx=self.ctx)], pad=pad)

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False


class ImageRecordIterPy(ImageIter):
    """``ImageRecordIter``'s Python pipeline (the reference C++
    iterator's keyword surface): records read by ``recordio``, decoded
    and augmented here, each batch one copy to ``ctx``. The JAX
    package reads the records through its native library when that
    builds (``io/native.py``), and through this same path when it does
    not; the port has no native reader (ROADMAP Queue 1, 'Long
    tail')."""

    def __init__(self, path_imgrec=None, path_imgidx=None, data_shape=None,
                 batch_size=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0, mean_g=0, mean_b=0,
                 std_r=1, std_g=1, std_b=1, num_parts=1, part_index=0,
                 preprocess_threads=4, prefetch_buffer=4, label_width=1,
                 resize=0, seed=0, ctx=None, data_name="data",
                 label_name="softmax_label", dtype="float32", **kwargs):
        mean = None
        std = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b], np.float32)
            std = np.array([std_r or 1, std_g or 1, std_b or 1], np.float32)
        aug = CreateAugmenter(
            (data_shape[0], data_shape[1], data_shape[2]),
            resize=resize, rand_crop=rand_crop, rand_mirror=rand_mirror,
            mean=mean, std=std,
            **{k: v for k, v in kwargs.items()
               if k in ("rand_resize", "brightness", "contrast",
                        "saturation", "hue", "pca_noise", "rand_gray",
                        "inter_method")})
        super().__init__(batch_size, data_shape, label_width=label_width,
                         path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                         shuffle=shuffle, num_parts=num_parts,
                         part_index=part_index, aug_list=aug, ctx=ctx,
                         data_name=data_name, label_name=label_name,
                         dtype=dtype)


# ----------------------------------------------------------------------
# Detection augmenters (python/mxnet/image/detection.py analog).
# Labels are MXNet detection format: (N, 5+) float rows
# [class_id, xmin, ymin, xmax, ymax, ...] with coordinates normalized
# to [0, 1]. Each augmenter maps (img, label) -> (img, label).
# ----------------------------------------------------------------------
class DetAugmenter:
    """Detection augmenter base (reference DetAugmenter)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only augmenter into the detection chain
    (geometry-preserving ops only — reference DetBorrowAug)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image AND box x-coordinates with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if np.random.rand() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping enough box overlap (simplified reference
    DetRandomCropAug: IOU-style constraint via min box coverage)."""

    def __init__(self, min_object_covered=0.5, min_crop_scale=0.5,
                 max_attempts=25):
        self.min_object_covered = min_object_covered
        self.min_crop_scale = min_crop_scale
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            s = np.random.uniform(self.min_crop_scale, 1.0)
            cw, ch = int(w * s), int(h * s)
            x0 = np.random.randint(0, w - cw + 1)
            y0 = np.random.randint(0, h - ch + 1)
            new_label = self._crop_boxes(label, x0 / w, y0 / h, cw / w, ch / h)
            if len(new_label):
                return src[y0:y0 + ch, x0:x0 + cw], new_label
        return src, label

    def _crop_boxes(self, label, cx, cy, cw, ch):
        out = []
        for row in label:
            xmin, ymin, xmax, ymax = row[1:5]
            ixmin, iymin = max(xmin, cx), max(ymin, cy)
            ixmax, iymax = min(xmax, cx + cw), min(ymax, cy + ch)
            iw, ih = max(ixmax - ixmin, 0.0), max(iymax - iymin, 0.0)
            area = (xmax - xmin) * (ymax - ymin)
            if area <= 0 or iw * ih / area < self.min_object_covered:
                continue
            new = row.copy()
            new[1] = (ixmin - cx) / cw
            new[2] = (iymin - cy) / ch
            new[3] = (ixmax - cx) / cw
            new[4] = (iymax - cy) / ch
            out.append(new)
        return np.asarray(out, label.dtype).reshape(-1, label.shape[1])


class DetRandomPadAug(DetAugmenter):
    """Random expand-pad; boxes shrink into the padded canvas
    (reference DetRandomPadAug)."""

    def __init__(self, max_pad_scale=2.0, pad_val=(127, 127, 127)):
        self.max_pad_scale = max_pad_scale
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w, c = src.shape
        s = np.random.uniform(1.0, self.max_pad_scale)
        nh, nw = int(h * s), int(w * s)
        y0 = np.random.randint(0, nh - h + 1)
        x0 = np.random.randint(0, nw - w + 1)
        canvas = np.empty((nh, nw, c), src.dtype)
        canvas[...] = np.asarray(self.pad_val, src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        label = label.copy()
        label[:, 1] = (label[:, 1] * w + x0) / nw
        label[:, 3] = (label[:, 3] * w + x0) / nw
        label[:, 2] = (label[:, 2] * h + y0) / nh
        label[:, 4] = (label[:, 4] * h + y0) / nh
        return canvas, label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter from a list (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if np.random.rand() >= self.skip_prob and self.aug_list:
            aug = self.aug_list[np.random.randint(len(self.aug_list))]
            return aug(src, label)
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       min_object_covered=0.5, max_pad_scale=2.0,
                       inter_method=2, **kwargs):
    """Build the detection augmenter chain (reference
    CreateDetAugmenter): geometric det augmenters + borrowed pixel
    augmenters + final resize to data_shape."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomCropAug(min_object_covered=min_object_covered)],
            skip_prob=1.0 - rand_crop))
    if rand_pad > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomPadAug(max_pad_scale=max_pad_scale)],
            skip_prob=1.0 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2], data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


__all__ += ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
            "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
            "CreateDetAugmenter"]


class ImageDetIter(ImageIter):
    """Detection data iterator (reference python/mxnet/image/detection.py
    ImageDetIter): images + variable-count box labels, batched with the
    label tensor padded to ``label_shape`` with -1 rows — exactly the
    (B, M, 5) format ``contrib.MultiBoxTarget`` consumes.

    Per-sample labels accept either the already-2D (N, obj_width) form
    or the im2rec flat detection packing ``[A, B, <A-2 extra header>,
    obj0 ... objN]`` where A is the header width and B the object width
    (reference ImageDetIter._parse_label).
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 label_shape=None, ctx=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_pad", "rand_mirror",
                         "mean", "std", "min_object_covered",
                         "max_pad_scale", "inter_method")})
        # detection augmenters run as (img, label) pairs in next();
        # pass an EMPTY pixel chain to the base iterator
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         ctx=ctx)
        self.det_auglist = aug_list
        if label_shape is None:
            label_shape = self._estimate_label_shape()
        self.label_shape = tuple(label_shape)

    @staticmethod
    def _parse_label(label):
        """Flat im2rec det packing or 2-D array -> (N, obj_width)."""
        arr = np.asarray(label, np.float32)
        if arr.ndim == 2:
            return arr
        raw = arr.ravel()
        if raw.size < 2:
            raise ValueError("invalid detection label (needs header)")
        a, b = int(raw[0]), int(raw[1])
        if b <= 0:
            raise ValueError(
                f"detection label: header object width {b} must be positive")
        if a < 2 or a > raw.size:
            # a == raw.size is a legal header-only label: a negative
            # sample with zero objects -> (0, b)
            raise ValueError(
                f"detection label: header width {a} out of range for a "
                f"label of {raw.size} values")
        objs = raw[a:]
        n = objs.size // b
        if n * b != objs.size:
            raise ValueError(
                f"detection label: {objs.size} values not divisible by "
                f"object width {b}")
        return objs[: n * b].reshape(n, b)

    def _estimate_label_shape(self):
        """Scan ALL samples for (max_objects, obj_width) — including
        the RecordIO path, where labels only surface through
        next_sample (reference _estimate_label_shape does the same
        full pass, then resets)."""
        max_n, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                parsed = self._parse_label(label)
                max_n = max(max_n, parsed.shape[0])
                width = max(width, parsed.shape[1])
        except StopIteration:
            pass
        self.reset()
        return (max(max_n, 1), width)

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self.label_shape, "float32")]

    def sync_label_shape(self, it, verbose=False):
        """Synchronize label padding with another ImageDetIter (train /
        val pairs must agree — reference sync_label_shape)."""
        shape = (max(self.label_shape[0], it.label_shape[0]),
                 max(self.label_shape[1], it.label_shape[1]))
        self.label_shape = shape
        it.label_shape = shape
        return it

    def next(self):
        bs = self.batch_size
        m, w = self.label_shape
        batch_data = np.zeros((bs,) + self.data_shape, dtype=self.dtype)
        batch_label = -np.ones((bs, m, w), np.float32)
        i = 0
        pad = 0
        try:
            while i < bs:
                label, raw = self.next_sample()
                img = _decode_np(raw).astype(np.float32)
                parsed = self._parse_label(label)
                for aug in self.det_auglist:
                    img, parsed = aug(img, parsed)
                if parsed.shape[1] > w:
                    raise ValueError(
                        f"ImageDetIter: sample object width "
                        f"{parsed.shape[1]} exceeds label_shape width {w} "
                        f"— pass label_shape=(M, {parsed.shape[1]})")
                if parsed.shape[0] > m:
                    raise ValueError(
                        f"ImageDetIter: sample has {parsed.shape[0]} "
                        f"objects but label_shape holds {m} — silently "
                        f"dropping ground truth would corrupt training; "
                        f"pass label_shape=({parsed.shape[0]}, {w})")
                n = parsed.shape[0]
                batch_data[i] = np.transpose(img, (2, 0, 1))
                batch_label[i, :n, :parsed.shape[1]] = parsed[:n]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = bs - i
        return DataBatch(data=[_as_nd(batch_data, ctx=self.ctx)],
                        label=[_as_nd(batch_label, ctx=self.ctx)], pad=pad)


__all__ += ["ImageDetIter"]
