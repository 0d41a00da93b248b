"""The port's ``.params`` format (``ndarray.serialization``) against the
JAX package's, on the CPU.

- ``nd.save`` of one array, a list and a dict, in every dtype code
  (float32, float64, float16, bfloat16, uint8, int32, int8, int64,
  bool), scalars (written as shape (1,) by both) and empty shapes
  included, gives the same bytes as the JAX package's ``nd.save`` of
  the same numpy data.
- Each package loads the other's file: values equal bit for bit, the
  types the same.
- V3 (int64 shapes) and V1 (no storage type) blobs load, from headers
  made by hand (no 2**31-element array is allocated).
- Bad magics and truncated files raise ``MXNetError``; the sharded
  files raise naming ROADMAP 'Multi-GPU'.
"""
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu.ndarray.serialization import save_bytes as jax_save_bytes
from mxnet_tpu_torch.ndarray import serialization

torch.set_num_threads(1)

DTYPES = ["float32", "float64", "float16", "bfloat16", "uint8", "int32",
          "int8", "int64", "bool"]
SHAPES = [(3, 4), (), (0, 3), (2, 1, 5)]


def _data(dtype, shape, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return np.asarray(rng.rand(*shape) > 0.5)
    if dtype in ("uint8", "int8", "int32", "int64"):
        info = np.iinfo(dtype)
        return rng.randint(max(info.min, -1000), min(info.max, 1000),
                           size=shape).astype(dtype)
    # float data as float32 (bfloat16 rounds from it on both sides)
    return np.asarray(rng.randn(*shape) * 3).astype(
        np.float32 if dtype == "bfloat16" else dtype)


def _both(dtype, shape, seed=0):
    x = _data(dtype, shape, seed)
    return mx.nd.array(x, dtype=dtype), tnd.array(x, ctx="cpu", dtype=dtype)


def _as_np(t):
    """A port array's values as numpy (bfloat16 as its raw words)."""
    npv, _ = tnd.ndarray.raw_numpy(t)
    return npv


def _jax_np(a):
    npv = a.asnumpy()
    return npv.view(np.uint16) if str(a.dtype) == "bfloat16" else npv


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_array_same_bytes_and_loads_both_ways(tmp_path, dtype, shape):
    ja, ta = _both(dtype, shape)
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    mx.nd.save(jf, ja)
    tnd.save(tf, ta)
    assert open(jf, "rb").read() == open(tf, "rb").read()
    got = tnd.load(jf, ctx="cpu")
    assert isinstance(got, list) and len(got) == 1
    assert isinstance(got[0], tnd.NDArray)
    # a scalar is written as shape (1,) by both packages
    assert got[0].dtype == ta.dtype and tuple(got[0].shape) == (shape or (1,))
    np.testing.assert_array_equal(_as_np(got[0]), _jax_np(ja))
    back = mx.nd.load(tf)
    assert str(back[0].dtype) == dtype
    np.testing.assert_array_equal(_jax_np(back[0]), _as_np(ta))


def test_list_and_dict_of_every_dtype_same_bytes(tmp_path):
    pairs = [_both(dt, (2, 3), seed=i) for i, dt in enumerate(DTYPES)]
    jl, tl = [p[0] for p in pairs], [p[1] for p in pairs]
    assert serialization.save_bytes(tl) == jax_save_bytes(jl)
    jd = {f"p{i}.{dt}": a for i, (dt, a) in enumerate(zip(DTYPES, jl))}
    td = {f"p{i}.{dt}": a for i, (dt, a) in enumerate(zip(DTYPES, tl))}
    assert serialization.save_bytes(td) == jax_save_bytes(jd)
    f = str(tmp_path / "d.params")
    mx.nd.save(f, jd)
    got = tnd.load(f, ctx="cpu")
    assert list(got) == list(td)
    for k, v in td.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(_as_np(got[k]), _as_np(v))


def test_float32_and_bfloat16_side_by_side(tmp_path):
    """One file with codes 0 and 12, as a bf16-cast ResNet's (BatchNorm
    stays float32)."""
    w = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    t = {"conv.weight": tnd.array(w, ctx="cpu", dtype="bfloat16"),
         "bn.gamma": tnd.array(w[0], ctx="cpu")}
    j = {"conv.weight": mx.nd.array(w, dtype="bfloat16"),
         "bn.gamma": mx.nd.array(w[0])}
    assert serialization.save_bytes(t) == jax_save_bytes(j)
    f = str(tmp_path / "mixed.params")
    tnd.save(f, t)
    back = mx.nd.load(f)
    assert str(back["conv.weight"].dtype) == "bfloat16"
    assert str(back["bn.gamma"].dtype) == "float32"
    raw = open(f, "rb").read()
    for code in (0, 12):
        assert struct.pack("<iii", 1, 0, code) in raw


def _blob(magic, shape, fmt, data, with_stype=True, code=0):
    b = struct.pack("<I", magic)
    if with_stype:
        b += struct.pack("<i", 0)
    b += struct.pack("<I", len(shape))
    for d in shape:
        b += struct.pack(fmt, d)
    return b + struct.pack("<iii", 1, 0, code) + data.tobytes()


def test_v3_and_v1_headers_load():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for magic, fmt, stype in ((serialization.NDARRAY_V3_MAGIC, "<q", True),
                              (serialization.NDARRAY_V1_MAGIC, "<I", False)):
        payload = struct.pack("<QQQ", serialization.LIST_MAGIC, 0, 1) \
            + _blob(magic, x.shape, fmt, x, stype) + struct.pack("<Q", 0)
        got = serialization.load_bytes(payload, ctx="cpu")
        np.testing.assert_array_equal(got[0].asnumpy(), x)
    # a dimension past 31 bits selects V3 on save (checked on the header,
    # not on a real array)
    assert serialization.NDARRAY_V3_MAGIC == 0xF993FACA


def test_bad_files_raise(tmp_path):
    good = serialization.save_bytes([tnd.zeros((2,), ctx="cpu")])
    with pytest.raises(MXNetError, match="magic"):
        serialization.load_bytes(b"\x00" * 24, ctx="cpu")
    with pytest.raises(MXNetError, match="truncated"):
        serialization.load_bytes(good[:-12], ctx="cpu")
    bad = bytearray(good)
    bad[24:28] = struct.pack("<I", 0x1234)
    with pytest.raises(MXNetError, match="magic"):
        serialization.load_bytes(bytes(bad), ctx="cpu")
    for fn in (lambda: tnd.serialization.save_sharded("p", {}),
               lambda: tnd.serialization.load_sharded("p")):
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            fn()
    with pytest.raises(NotImplementedError, match="filesystem"):
        tnd.save("s3://bucket/x.params", [tnd.zeros((1,), ctx="cpu")])


def test_load_places_on_the_current_context(tmp_path, monkeypatch):
    f = str(tmp_path / "x.params")
    tnd.save(f, {"w": tnd.ones((2,), ctx="cpu")})
    from mxnet_tpu_torch import cpu
    with cpu():
        assert tnd.load(f)["w"].context == cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnd.load(f)
