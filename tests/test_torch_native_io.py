"""The native RecordIO reader and image batcher (``io.native``) against
the JAX package's, on the CPU.

The JAX batcher reads, decodes (libjpeg) and resizes on C++ threads;
it is built here from ``src/cc`` with the JAX package's own ``_load``
into a copy of that directory under the test's temporary path (so
nothing is written into the JAX package). The port reads on its own
C++ threads (``io/csrc/recordio.cc``, built with ``g++`` into
``mxnet_tpu_torch/_build``) and, on the CPU, decodes with PIL and runs
the resize kernel's plain version. Both decoders are libjpeg-turbo with
its defaults here, so the batches agree bit for bit: the same records
in the same order (shuffled with one seed, split by ``num_parts``),
the same labels (the first of a multi-label record), the same records
skipped (a record that is no JPEG, one shorter than its header), and
the same pixels; likewise ``decode_jpeg``, the raw reader and the raw
batcher. The resize's plain version also equals ``ResizeBilinear`` on
pixels given directly: an image of the output size is copied.
"""
import contextlib
import importlib
import io
import os
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu.io.native as jnative
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.io import native as tnative
from mxnet_tpu_torch.ops import image as timage

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
smoke = importlib.import_module("chip_smoke")   # its seeded JPEG scenes


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``io.native`` built from a copy of ``src/cc``."""
    d = str(tmp_path_factory.mktemp("cc") / "cc")
    shutil.copytree(os.path.join(ROOT, "src", "cc"), d,
                    ignore=shutil.ignore_patterns("*.so", "test_io"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SRC_DIR", d)
        mp.setattr(jnative, "_LIB_PATH", os.path.join(d, "libmxtpu_io.so"))
        mp.setattr(jnative, "_LIB", None)
        jnative._load()
        yield jnative


@contextlib.contextmanager
def _quiet():
    """Both batchers warn when a batch lost a corrupt record."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _jpeg(img, quality=90):
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", quality=quality)
    return b.getvalue()


def write_records(path, n=30, seed=0, out=(20, 24)):
    """``n`` JPEG records of mixed sizes (some of the output size, one
    multi-label, one not a JPEG, one cut short of its header)."""
    rs = np.random.RandomState(seed)
    rec = tmx.recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(n):
        h, w = out if i % 5 == 0 else rs.randint(8, 60, 2)
        payload = _jpeg(smoke.jpeg_scene(rs, h, w),
                        quality=int(rs.randint(60, 96)))
        header = tmx.recordio.IRHeader(0, float(i % 7), i, 0)
        if i == 3:                               # multi-label
            header = tmx.recordio.IRHeader(0, [float(i), 9.0, 8.0], i, 0)
        if i == 7:
            payload = b"\x89PNG not a jpeg"
        raw = tmx.recordio.pack(header, payload)
        if i == 11:
            raw = raw[:10]                       # shorter than IRHeader
        rec.write_idx(i, raw)
    rec.close()
    return path + ".rec", path + ".idx"


@pytest.mark.parametrize("shuffle,parts", [(False, (1, 0)), (True, (1, 0)),
                                           (True, (3, 1))])
def test_image_batcher_equals_the_jax_batcher(jax_native, tmp_path, shuffle,
                                              parts):
    rec, idx = write_records(str(tmp_path / "img"))
    kw = dict(batch_size=4, data_shape=(3, 20, 24), shuffle=shuffle, seed=5,
              num_parts=parts[0], part_index=parts[1])
    jb = jax_native.NativeImageBatcher(rec, idx, **kw)
    tb = tnative.NativeImageBatcher(rec, idx, device="cpu", **kw)
    assert tb.num_batches == jb.num_batches
    for epoch in range(2):
        n = 0
        with _quiet():
            while True:
                want, got = jb.next(), tb.next()
                if want is None:
                    assert got is None
                    break
                assert got[0].dtype == torch.uint8
                np.testing.assert_array_equal(got[0].numpy(), want[0])
                np.testing.assert_array_equal(got[1].numpy(), want[1])
                n += 1
        assert n == jb.num_batches
        jb.reset()
        tb.reset()


def test_decode_jpeg_and_raw_readers_equal_the_jax_ones(jax_native,
                                                        tmp_path):
    rs = np.random.RandomState(1)
    for h, w, oh, ow in ((17, 23, 32, 48), (40, 30, 40, 30), (64, 64, 7, 9)):
        buf = _jpeg(smoke.jpeg_scene(rs, h, w))
        want = jax_native.decode_jpeg(buf, oh, ow)
        got = tnative.decode_jpeg(buf, oh, ow, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="corrupt"):
        tnative.decode_jpeg(b"not a jpeg", 4, 4, device="cpu")

    rec, idx = write_records(str(tmp_path / "raw"), n=13)
    jr, tr = jax_native.NativeRecordReader(rec), tnative.NativeRecordReader(rec)
    while True:
        a, b = jr.read(), tr.read()
        assert a == b
        if a is None:
            break
    kw = dict(batch_size=4, num_threads=3, shuffle=True, seed=2)
    jb = jax_native.NativeBatcher(rec, idx, **kw)
    tb = tnative.NativeBatcher(rec, idx, **kw)
    assert tb.num_batches == jb.num_batches == 4      # the last one short
    for _ in range(4):
        assert tb.next() == jb.next()
    assert tb.next() is None


def test_plain_resize_is_resize_bilinear_on_given_pixels():
    """The JAX ``ResizeBilinear`` in numpy float32 (each op rounded, in
    the C++ order) against the plain version; an image of the output
    size is copied."""
    rs = np.random.RandomState(3)

    def resize(src, oh, ow):
        h0, w0 = src.shape[:2]
        if (h0, w0) == (oh, ow):
            return src.transpose(2, 0, 1)
        f32 = np.float32
        out = np.empty((3, oh, ow), np.uint8)
        sx, sy = f32(w0) / f32(ow), f32(h0) / f32(oh)
        for y in range(oh):
            fy = (f32(y) + f32(0.5)) * sy - f32(0.5)
            y0 = max(0, int(fy))
            y1 = min(h0 - 1, y0 + 1)
            wy = max(f32(0), fy - f32(y0))
            for x in range(ow):
                fx = (f32(x) + f32(0.5)) * sx - f32(0.5)
                x0 = max(0, int(fx))
                x1 = min(w0 - 1, x0 + 1)
                wx = max(f32(0), fx - f32(x0))
                v = (src[y0, x0].astype(f32) * (f32(1) - wy) * (f32(1) - wx)
                     + src[y0, x1].astype(f32) * (f32(1) - wy) * wx
                     + src[y1, x0].astype(f32) * wy * (f32(1) - wx)
                     + src[y1, x1].astype(f32) * wy * wx)
                out[:, y, x] = (v + f32(0.5)).astype(np.uint8)
        return out

    imgs = [rs.randint(0, 256, s + (3,)).astype(np.uint8)
            for s in ((5, 7), (9, 4), (6, 6), (13, 11))]
    got = timage.resize_assemble([torch.tensor(i) for i in imgs], 6, 6)
    for g, i in zip(got, imgs):
        np.testing.assert_array_equal(g.numpy(), resize(i, 6, 6))


def test_image_record_iter_takes_the_native_batcher_as_the_jax_one(
        jax_native, tmp_path):
    rec, idx = write_records(str(tmp_path / "it"), n=20)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 20, 24),
              batch_size=5)
    with _quiet():
        jit = jmx.io.ImageRecordIter(**kw)
        tit = tmx.io.ImageRecordIter(ctx=tmx.cpu(), **kw)
        assert isinstance(jit, jmx.io.io.ImageRecordIterNative)
        assert isinstance(tit, tmx.io.ImageRecordIterNative)
        assert tit.provide_data[0].shape == (5, 3, 20, 24)
        for jb, tb in zip(jit, tit):
            np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                          jb.label[0].asnumpy())
    # an augmenter keeps the Python pipeline, in both packages
    aug = tmx.io.ImageRecordIter(ctx=tmx.cpu(), rand_mirror=True, **kw)
    assert type(aug).__name__ == "ImageRecordIterPy"
    with pytest.raises(IOError, match="cannot open"):
        tmx.io.ImageRecordIterNative(path_imgrec=str(tmp_path / "no.rec"),
                                     path_imgidx=idx, data_shape=(3, 8, 8),
                                     batch_size=2, ctx=tmx.cpu())
