"""The port's RecordIO, image augmenters, image iterators and record
datasets against the JAX package's, on the CPU.

- RecordIO: the same records written by each package give the same
  ``.rec`` and ``.idx`` bytes, and each package reads the other's files
  (``pack``/``unpack`` with scalar and vector labels, ``pack_img`` and
  ``unpack_img``, multi-part records, ``NPY0`` image records).
- Augmenters: every ``Augmenter`` and ``Det*Aug``, the chains of
  ``CreateAugmenter``/``CreateDetAugmenter`` and the image functions,
  each on the same image under the same ``np.random`` seed in both
  packages: equal outputs (and equal labels for the detection ones).
- Iterators: ``ImageDetIter`` (shuffled, random crop and pad, mirror,
  mean and std) and ``ImageRecordIterPy``/``io.ImageRecordIter``
  batches equal to the JAX package's under the same seed.
- Datasets: ``RecordFileDataset``, ``ImageRecordDataset`` and
  ``ImageFolderDataset`` give the JAX package's samples.
"""
import io
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trec

torch.set_num_threads(1)


def _img(rs, h=20, w=24):
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _npy0(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return b"NPY0" + buf.getvalue()


def _write(rec, tmp_path, tag, items):
    path, idx = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
    w = rec.MXIndexedRecordIO(idx, path, "w")
    for i, (label, payload) in enumerate(items):
        w.write_idx(i, rec.pack(rec.IRHeader(0, label, i, 0), payload))
    w.close()
    return path, idx


def _items(rs, n=5):
    out = []
    for i in range(n):
        label = float(i) if i % 2 else rs.rand(3).astype(np.float32)
        out.append((label, rs.bytes(rs.randint(1, 40))))
    return out


def test_recordio_bytes_and_both_directions(tmp_path):
    rs = np.random.RandomState(0)
    items = _items(rs)
    jp = _write(jrec, tmp_path, "jax", items)
    tp = _write(trec, tmp_path, "port", items)
    for a, b in zip(jp, tp):
        assert open(a, "rb").read() == open(b, "rb").read()
    for reader, (path, idx) in ((trec, jp), (jrec, tp)):
        r = reader.MXIndexedRecordIO(idx, path, "r")
        for i, (label, payload) in enumerate(items):
            h, s = reader.unpack(r.read_idx(i))
            assert s == payload and h.id == i
            np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                          np.asarray(label, np.float32))
        r.close()
    # a multi-part record (cflag 1, 2, 3) reads whole in both
    path = str(tmp_path / "parts.rec")
    with open(path, "wb") as f:
        for flag, part in ((1, b"ab"), (2, b"cde"), (3, b"f")):
            f.write(np.array([0xCED7230A, (flag << 29) | len(part)],
                             "<u4").tobytes())
            f.write(part + b"\0" * ((4 - len(part) % 4) % 4))
    for reader in (jrec, trec):
        assert reader.MXRecordIO(path, "r").read() == b"abcdef"


def test_image_records_and_codecs(tmp_path):
    rs = np.random.RandomState(1)
    img = _img(rs)
    header = (0, 3.0, 7, 0)
    assert trec.pack_img(header, img, img_fmt=".png") == \
        jrec.pack_img(header, img, img_fmt=".png")
    for packed in (jrec.pack_img(header, img, img_fmt=".png"),
                   trec.pack(header, _npy0(img))):
        for reader in (jrec, trec):
            h, got = reader.unpack_img(packed)
            np.testing.assert_array_equal(got, img)
            assert h.label == 3.0
    assert trec.image_codec() in ("PIL", "NPY0")
    np.testing.assert_array_equal(timage.imdecode(_npy0(img)).asnumpy(), img)


def _aug_pairs():
    mean, std = np.array([120.0, 110, 100]), np.array([50.0, 60, 55])
    return [
        ("ForceResizeAug", ((13, 9),)), ("ResizeAug", (14,)),
        ("CenterCropAug", ((12, 10),)), ("RandomCropAug", ((12, 10),)),
        ("RandomCropAug", ((30, 8),)), ("RandomSizedCropAug", ((11, 9),)),
        ("HorizontalFlipAug", (0.5,)), ("CastAug", ()),
        ("ColorNormalizeAug", (mean, std)), ("BrightnessJitterAug", (0.3,)),
        ("ContrastJitterAug", (0.3,)), ("SaturationJitterAug", (0.3,)),
        ("HueJitterAug", (0.2,)), ("LightingAug", (0.1,)),
        ("RandomGrayAug", (0.5,)), ("ColorJitterAug", (0.2, 0.3, 0.4)),
    ]


@pytest.mark.parametrize("name,args", _aug_pairs())
def test_augmenters(name, args):
    rs = np.random.RandomState(2)
    img = _img(rs).astype(np.float32)
    ja, ta = getattr(jimage, name)(*args), getattr(timage, name)(*args)
    assert json.loads(ta.dumps()) == json.loads(ja.dumps())
    for seed in range(3):
        np.random.seed(seed)
        want = np.asarray(ja(img))
        np.random.seed(seed)
        got = np.asarray(ta(img))
        np.testing.assert_array_equal(got, want)


def test_image_functions():
    rs = np.random.RandomState(3)
    img = _img(rs, 17, 23)
    for fn, args in (("imresize", (11, 7)), ("resize_short", (9,)),
                     ("fixed_crop", (2, 3, 8, 6, (5, 4))),
                     ("color_normalize", ((1.0, 2.0, 3.0), (2.0, 2.0, 4.0)))):
        got = getattr(timage, fn)(img, *args).asnumpy()
        want = getattr(jimage, fn)(jmx.nd.array(img), *args).asnumpy()
        np.testing.assert_array_equal(got, want)
    for fn in ("center_crop", "random_crop"):
        np.random.seed(4)
        want, jbox = getattr(jimage, fn)(jmx.nd.array(img), (10, 8))
        np.random.seed(4)
        got, tbox = getattr(timage, fn)(img, (10, 8))
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        assert tbox == jbox


def _det_label(rs, k):
    xy = rs.rand(k, 2) * 0.6
    wh = rs.rand(k, 2) * 0.35 + 0.05
    return np.concatenate([rs.randint(0, 3, (k, 1)), xy, xy + wh],
                          1).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("DetHorizontalFlipAug", (0.5,)), ("DetRandomCropAug", (0.5,)),
    ("DetRandomPadAug", ()), ("DetBorrowAug", ("CastAug",)),
])
def test_detection_augmenters(name, args):
    rs = np.random.RandomState(5)
    img, label = _img(rs).astype(np.float32), _det_label(rs, 3)

    def make(lib):
        if name == "DetBorrowAug":
            return lib.DetBorrowAug(getattr(lib, args[0])())
        aug = getattr(lib, name)(*args)
        return lib.DetRandomSelectAug([aug], skip_prob=0.3) \
            if name == "DetRandomPadAug" else aug

    ja, ta = make(jimage), make(timage)
    for seed in range(4):
        np.random.seed(seed)
        wi, wl = ja(img, label)
        np.random.seed(seed)
        gi, gl = ta(img, label)
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(gl, wl)


def test_augmenter_chains():
    rs = np.random.RandomState(6)
    img, label = _img(rs, 30, 26), _det_label(rs, 2)
    kw = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
              brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1,
              pca_noise=0.1, rand_gray=0.2)
    for create, kwargs in (
            ("CreateAugmenter", kw),
            ("CreateAugmenter", dict(resize=20, rand_resize=True)),
            ("CreateDetAugmenter",
             dict(resize=28, rand_crop=0.7, rand_pad=0.7, rand_mirror=True,
                  mean=True, std=True))):
        ja = getattr(jimage, create)((3, 16, 14), **kwargs)
        ta = getattr(timage, create)((3, 16, 14), **kwargs)
        assert [type(a).__name__ for a in ta] == \
            [type(a).__name__ for a in ja]
        for seed in range(3):
            outs = []
            for augs in (ja, ta):
                np.random.seed(seed)
                x, lab = img.astype(np.float32), label
                for a in augs:
                    if create == "CreateDetAugmenter":
                        x, lab = a(x, lab)
                    else:
                        x = a(x)
                outs.append((np.asarray(x), lab))
            np.testing.assert_array_equal(outs[1][0], outs[0][0])
            np.testing.assert_array_equal(outs[1][1], outs[0][1])


def _det_rec(rec, tmp_path, n=10):
    rs = np.random.RandomState(7)
    path, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    w = rec.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        k = 1 + i % 3
        lab = np.concatenate([[2, 5], _det_label(rs, k).ravel()])
        w.write_idx(i, rec.pack_img(rec.IRHeader(0, lab, i, 0),
                                    _img(rs, 28 + i, 32), img_fmt=".png"))
    w.close()
    return path, idx


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_image_det_iter_matches_jax(tmp_path):
    path, idx = _det_rec(jrec, tmp_path)
    kw = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=path,
              path_imgidx=idx, shuffle=True, rand_crop=0.5, rand_pad=0.5,
              rand_mirror=True, mean=True, std=True)
    res = []
    for lib, ctx in ((jimage, jmx.cpu()), (timage, tmx.cpu())):
        np.random.seed(8)
        it = lib.ImageDetIter(ctx=ctx, **kw)
        res.append((it.label_shape, _batches(it)))
        it.reset()
        res[-1][1].extend(_batches(it))
    assert res[0][0] == res[1][0] == (3, 5)
    _same_batches(res[1][1], res[0][1])
    assert res[1][1][-1][2] == 2          # 10 images: the last batch pads 2


def test_image_record_iter_matches_jax(tmp_path):
    rs = np.random.RandomState(9)
    path, idx = str(tmp_path / "cls.rec"), str(tmp_path / "cls.idx")
    w = jrec.MXIndexedRecordIO(idx, path, "w")
    for i in range(7):
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, float(i % 3), i, 0),
                                 _npy0(_img(rs, 20, 18))))
    w.close()
    kw = dict(path_imgrec=path, path_imgidx=idx, data_shape=(3, 16, 16),
              batch_size=3, rand_crop=True, rand_mirror=True, mean_r=120.0,
              mean_g=110.0, mean_b=100.0, std_r=50.0, std_g=55.0, std_b=60.0)
    np.random.seed(10)
    want = _batches(jimage.ImageRecordIterPy(ctx=jmx.cpu(), **kw))
    np.random.seed(10)
    got = _batches(tmx.io.ImageRecordIter(ctx=tmx.cpu(), **kw))
    _same_batches(got, want)
    assert got[0][0].shape == (3, 3, 16, 16) and got[-1][2] == 2


def test_record_datasets(tmp_path):
    path, idx = _det_rec(jrec, tmp_path, n=4)
    jd = jmx.gluon.data.RecordFileDataset(path)
    td = tmx.gluon.data.RecordFileDataset(path)
    assert len(td) == len(jd) == 4
    assert all(td[i] == jd[i] for i in range(4))
    jd = jmx.gluon.data.vision.ImageRecordDataset(path)
    td = tmx.gluon.data.vision.ImageRecordDataset(path)
    for i in range(4):
        (ti, tl), (ji, jl) = td[i], jd[i]
        np.testing.assert_array_equal(ti, ji.asnumpy())
        np.testing.assert_array_equal(tl, jl)
    rs = np.random.RandomState(11)
    for cls in ("cat", "dog"):
        (tmp_path / "folder" / cls).mkdir(parents=True)
        for j in range(2):
            np.save(tmp_path / "folder" / cls / f"{j}.npy", _img(rs, 6, 5))
    jf = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "folder"))
    tf = tmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "folder"))
    assert tf.synsets == jf.synsets and len(tf) == len(jf) == 4
    for i in range(4):
        np.testing.assert_array_equal(tf[i][0], jf[i][0].asnumpy())
        assert tf[i][1] == jf[i][1]


def test_filesystem_uris(tmp_path):
    """``memory://`` and ``file://`` through ``filesystem.open_uri``:
    ``nd.save``/``nd.load`` and RecordIO read and write there, and the
    JAX package reads the bytes the port wrote."""
    from mxnet_tpu_torch import filesystem

    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tmx.nd.save("memory://w.params", {"w": w})
    assert filesystem.exists("memory://w.params")
    assert torch.equal(tmx.nd.load("memory://w.params", ctx="cpu")["w"], w)
    path = "file://" + str(tmp_path / "w.params")
    tmx.nd.save(path, {"w": w})
    np.testing.assert_array_equal(
        jmx.nd.load(str(tmp_path / "w.params"))["w"].asnumpy(), w.numpy())
    rec = trec.MXRecordIO("memory://r.rec", "w")
    rec.write(b"abc")
    rec.close()
    assert trec.MXRecordIO("memory://r.rec", "r").read() == b"abc"
    assert filesystem.list_prefix("memory://r") == ["memory://r.rec"]
