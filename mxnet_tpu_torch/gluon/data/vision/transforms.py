"""Vision transforms (``mxnet_tpu/gluon/data/vision/transforms.py``'s
counterpart).

Each is a callable on one host image, a numpy array or a CPU torch
tensor, and gives a CPU torch tensor (the DataLoader stacks them and
moves the batch to its device). Images are HWC until ``ToTensor``
makes them CHW float32 in [0, 1]. The random ones draw from an
explicit ``rng`` (a ``numpy.random.Generator``; a new unseeded one
when None). Resizing is the JAX package's bilinear numpy resize
(``image._resize_np``), copied here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Cast", "CenterCrop", "Compose", "Normalize", "RandomBrightness",
           "RandomContrast", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomResizedCrop", "RandomSaturation", "Resize", "ToTensor"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


def _resize_np(img, w, h):
    """Bilinear resize of an HWC (or HW) image to (h, w)."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img.copy()
    ys = np.linspace(0, ih - 1, h)
    xs = np.linspace(0, iw - 1, w)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, ih - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def _size(size):
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


def _rng(rng):
    return np.random.default_rng() if rng is None else rng


class Compose:
    """The transforms in order."""

    def __init__(self, transforms):
        self._transforms = list(transforms)

    def __call__(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype

    def __call__(self, x):
        return _t(x).to(self._dtype)


class ToTensor:
    """HWC (or NHWC) uint8 [0, 255] -> CHW (NCHW) float32 [0, 1]."""

    def __call__(self, x):
        out = _t(x).to(torch.float32) / 255.0
        if out.ndim == 3:
            return out.permute(2, 0, 1)
        return out.permute(0, 3, 1, 2)


class Normalize:
    """``(x - mean) / std`` per channel of a CHW tensor."""

    def __init__(self, mean=0.0, std=1.0):
        self._mean = torch.tensor(np.asarray(mean, np.float32)
                                  .reshape(-1, 1, 1))
        self._std = torch.tensor(np.asarray(std, np.float32)
                                 .reshape(-1, 1, 1))

    def __call__(self, x):
        x = _t(x)
        return (x - self._mean.to(x.device)) / self._std.to(x.device)


class Resize:
    """Bilinear resize of an HWC image to ``size`` ((w, h) or one
    side)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = _size(size)

    def __call__(self, x):
        return _t(_resize_np(_np(x), self._size[0], self._size[1]))


class CenterCrop:
    """The centre ``size`` ((w, h)) of an HWC image, resized to it when
    the image is smaller."""

    def __init__(self, size, interpolation=1):
        self._size = _size(size)

    def __call__(self, x):
        img = _np(x)
        h, w = img.shape[:2]
        new_w, new_h = self._size
        x0, y0 = max(0, (w - new_w) // 2), max(0, (h - new_h) // 2)
        out = img[y0:y0 + min(new_h, h), x0:x0 + min(new_w, w)]
        if out.shape[:2] != (new_h, new_w):
            out = _resize_np(out, new_w, new_h)
        return _t(out)


class RandomResizedCrop:
    """A crop of random area share in ``scale`` and aspect ratio in
    ``ratio`` (up to 10 tries, else the whole image), resized to
    ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1, rng=None):
        self._size = _size(size)
        self._scale = scale
        self._ratio = ratio
        self._rng = _rng(rng)

    def __call__(self, x):
        img = _np(x)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = self._rng.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(self._rng.uniform(*log_ratio))
            new_w = int(round(np.sqrt(target_area * aspect)))
            new_h = int(round(np.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = int(self._rng.integers(0, w - new_w + 1))
                y0 = int(self._rng.integers(0, h - new_h + 1))
                img = img[y0:y0 + new_h, x0:x0 + new_w]
                break
        return _t(_resize_np(img, self._size[0], self._size[1]))


class RandomFlipLeftRight:
    """Flip an HWC image's width axis with probability 1/2."""

    def __init__(self, rng=None):
        self._rng = _rng(rng)

    def __call__(self, x):
        x = _t(x)
        return x.flip(1) if self._rng.random() < 0.5 else x


class RandomFlipTopBottom:
    """Flip an HWC image's height axis with probability 1/2."""

    def __init__(self, rng=None):
        self._rng = _rng(rng)

    def __call__(self, x):
        x = _t(x)
        return x.flip(0) if self._rng.random() < 0.5 else x


class _RandomColorJitterBase:
    def __init__(self, brightness, rng=None):
        self._jitter = brightness
        self._rng = _rng(rng)

    def _alpha(self):
        return 1.0 + self._rng.uniform(-self._jitter, self._jitter)


class RandomBrightness(_RandomColorJitterBase):
    """Scale by 1 + U(-b, b), clipped to [0, 255] (float32)."""

    def __call__(self, x):
        img = _t(x).to(torch.float32)
        return torch.clamp(img * self._alpha(), 0, 255)


class RandomContrast(_RandomColorJitterBase):
    """Scale the distance from the image's mean by 1 + U(-c, c)."""

    def __call__(self, x):
        img = _t(x).to(torch.float32)
        mean = img.mean()
        return torch.clamp((img - mean) * self._alpha() + mean, 0, 255)


class RandomSaturation(_RandomColorJitterBase):
    """Blend with the per-pixel gray (the channel mean) by 1 + U(-s,
    s)."""

    def __call__(self, x):
        img = _t(x).to(torch.float32)
        gray = img.mean(dim=-1, keepdim=True)
        a = self._alpha()
        return torch.clamp(img * a + gray * (1 - a), 0, 255)
