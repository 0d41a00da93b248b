"""``Block.save_parameters``/``load_parameters`` of the port against the
JAX package's, on the CPU, for the MNIST MLP, the word LM at small
widths, ``resnet18_v1`` (float32, and bfloat16-cast with float32
BatchNorm) and the BERT trunk at 2 layers:

- the JAX package's ``_collect_params_with_prefix()`` keys are the
  port's ``.params`` keys (``named_parameters()``);
- the JAX package saves, the port loads (deferred shapes taken from the
  file), and the forward agrees within the tolerance the model's
  parity test states (1e-5; ResNet 1e-5 of scale);
- the port saves the same bytes as the JAX file, and the JAX package
  loads the port's bytes back bit for bit;
- ``allow_missing``, ``ignore_extra``, ``cast_dtype``/``dtype_source``
  and the legacy full-name fallback (``ParameterDict.save``'s files),
  each against the JAX call.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import word_lm
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mlp(lib, **kw):
    net = lib.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.Flatten(), lib.Dense(256, activation="relu"),
                lib.Dense(128, activation="relu"), lib.Dense(10))
    return net


def _jax_word_lm():
    spec = importlib.util.spec_from_file_location(
        "jax_word_lm_example", ROOT / "example" / "word_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(name):
    """(jax net after a forward, port net, inputs, forward fns, tol)."""
    rs = np.random.RandomState(0)
    if name == "mlp":
        x = rs.rand(2, 1, 28, 28).astype(np.float32)
        jnet = _mlp(jnn)
        jnet.initialize(init=mx.initializer.Xavier())
        with tmx.cpu():
            tnet = _mlp(nn)                      # deferred widths
        return (jnet, tnet, lambda n: n(mx.nd.array(x)).asnumpy(),
                lambda n: n(torch.from_numpy(x)).numpy(), 1e-5)
    if name == "word_lm":
        x = rs.randint(0, 50, (3, 6)).astype(np.int32)
        jnet = _jax_word_lm().WordLM(50, 16, 16, 2, dropout=0.0)
        jnet.initialize(init=mx.initializer.Xavier())
        tnet = word_lm.WordLM(50, 16, 16, 2, dropout=0.0, device="cpu")

        def jfwd(n):
            out, st = n(mx.nd.array(x, dtype="int32"), n.begin_state(3, None))
            return np.concatenate([out.asnumpy().ravel(),
                                   st[0].asnumpy().ravel()])

        def tfwd(n):
            out, st = n(torch.from_numpy(x), n.begin_state(3, "cpu"))
            return np.concatenate([out.numpy().ravel(),
                                   st[0].numpy().ravel()])
        return jnet, tnet, jfwd, tfwd, 1e-5
    if name in ("resnet18_v1", "resnet18_v1_bf16"):
        x = rs.rand(1, 3, 16, 16).astype(np.float32)
        jnet = jvision.resnet18_v1(classes=10, thumbnail=True)
        jnet.initialize(init=mx.initializer.Xavier())
        jnet(mx.nd.array(x))
        tnet = vision.resnet18_v1(classes=10, thumbnail=True, device="cpu")
        if name.endswith("bf16"):
            jnet.cast("bfloat16")
            tnet.cast("bfloat16")
            return jnet, tnet, None, None, None
        return (jnet, tnet, lambda n: n(mx.nd.array(x)).asnumpy(),
                lambda n: n(torch.from_numpy(x)).numpy(), 1e-5)
    assert name == "bert"
    kw = dict(vocab_size=120, units=32, hidden_size=64, num_layers=2,
              num_heads=4, max_length=40, dropout=0.0, attention_dropout=0.0)
    tok = rs.randint(1, 120, (2, 9)).astype(np.int32)
    tt = (rs.rand(2, 9) < 0.5).astype(np.int32)
    jnet = JaxBERT(**kw)
    jnet.initialize(init=mx.initializer.Normal(0.02))
    tnet = BERTModel(device="cpu", **kw)

    def jfwd(n):
        seq, pooled = n(mx.nd.array(tok, dtype="int32"),
                        mx.nd.array(tt, dtype="int32"))
        return np.concatenate([seq.asnumpy().ravel(),
                               pooled.asnumpy().ravel()])

    def tfwd(n):
        seq, pooled = n(torch.from_numpy(tok), torch.from_numpy(tt))
        return np.concatenate([seq.numpy().ravel(), pooled.numpy().ravel()])
    return jnet, tnet, jfwd, tfwd, 1e-5


@pytest.mark.parametrize("name", ["mlp", "word_lm", "resnet18_v1",
                                  "resnet18_v1_bf16", "bert"])
def test_params_files_pass_both_ways(tmp_path, name):
    jnet, tnet, jfwd, tfwd, tol = _case(name)
    want = jfwd(jnet) if jfwd is not None else None
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(jfile)
    tnet.load_parameters(jfile)
    keys = list(jnet._collect_params_with_prefix())
    assert [k for k, _ in tnet.named_parameters()] == keys
    assert list(tmx.nd.load(jfile, ctx="cpu")) == keys
    if want is not None:
        got = tfwd(tnet)
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)
    tnet.save_parameters(tfile)
    assert open(tfile, "rb").read() == open(jfile, "rb").read()
    # the JAX package loads the port's bytes back, bit for bit
    jnet.load_parameters(tfile)
    for (k, jp), (_, tp) in zip(jnet._collect_params_with_prefix().items(),
                                tnet.named_parameters()):
        jv = jp.data().asnumpy()
        tv = tp.detach().float().numpy() if tp.dtype == torch.bfloat16 \
            else tp.detach().numpy()
        assert str(jp.data().dtype) == str(tp.dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(tv, jv.astype(tv.dtype), err_msg=k)


def _mlp_pair(tmp_path):
    jnet = _mlp(jnn, prefix="mlp_")
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(np.zeros((1, 1, 28, 28), np.float32)))
    with tmx.cpu():
        tnet = _mlp(nn, prefix="mlp_")
    f = str(tmp_path / "m.params")
    jnet.save_parameters(f)
    return jnet, tnet, f, mx.nd.load(f)


def _jax_raises(fn):
    with pytest.raises((AssertionError, mx.MXNetError)):
        fn()


def test_allow_missing_and_ignore_extra(tmp_path):
    jnet, tnet, f, arrays = _mlp_pair(tmp_path)
    missing = str(tmp_path / "missing.params")
    mx.nd.save(missing, {k: v for k, v in arrays.items() if k != "3.bias"})
    _jax_raises(lambda: jnet.load_parameters(missing))
    with pytest.raises(MXNetError, match="3.bias"):
        tnet.load_parameters(missing)
    jnet.load_parameters(missing, allow_missing=True)
    tnet.load_parameters(missing, allow_missing=True)
    extra = str(tmp_path / "extra.params")
    mx.nd.save(extra, dict(arrays, **{"9.weight": arrays["1.weight"]}))
    _jax_raises(lambda: jnet.load_parameters(extra))
    with pytest.raises(MXNetError, match="9.weight"):
        tnet.load_parameters(extra)
    jnet.load_parameters(extra, ignore_extra=True)
    tnet.load_parameters(extra, ignore_extra=True)
    for k, p in tnet.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      arrays[k].asnumpy())


def test_cast_dtype_and_dtype_source(tmp_path):
    jnet, tnet, f, arrays = _mlp_pair(tmp_path)
    f64 = str(tmp_path / "f64.params")
    mx.nd.save(f64, {k: v.astype("float64") for k, v in arrays.items()})
    jnet.load_parameters(f64, cast_dtype=True)
    tnet.load_parameters(f64, cast_dtype=True)
    for (k, jp), (_, tp) in zip(jnet._collect_params_with_prefix().items(),
                                tnet.named_parameters()):
        assert tp.dtype == torch.float32 and str(jp.data().dtype) == "float32"
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      jp.data().asnumpy())
    tnet.load_parameters(f64, cast_dtype=True, dtype_source="saved")
    assert all(p.dtype == torch.float64 for p in tnet.parameters())
    with pytest.raises(ValueError, match="dtype_source"):
        tnet.load_parameters(f64, cast_dtype=True, dtype_source="file")


def test_deferred_shapes_from_the_file_and_legacy_full_names(tmp_path):
    jnet, tnet, f, arrays = _mlp_pair(tmp_path)
    assert tnet.collect_params()["dense0_weight"].shape == (256, 0)
    legacy = str(tmp_path / "legacy.params")
    jnet.collect_params().save(legacy)           # full names, no "."
    assert all(k.startswith("mlp_") for k in mx.nd.load(legacy))
    tnet.load_parameters(legacy)
    assert tnet.collect_params()["dense0_weight"].shape == (256, 784)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            tnet.collect_params()[k[len("mlp_"):]].data().asnumpy(),
            p.data().asnumpy())
    # the port's ParameterDict writes the JAX dict's bytes
    ours = str(tmp_path / "ours.params")
    tnet.collect_params().save(ours)
    assert open(ours, "rb").read() == open(legacy, "rb").read()
    with tmx.cpu():
        fresh = _mlp(nn, prefix="mlp_")
    fresh.collect_params().load(legacy, ctx=tmx.cpu())
    assert fresh.collect_params()["dense2_bias"].shape == (10,)
    stranger = str(tmp_path / "stranger.params")
    mx.nd.save(stranger, {"other_weight": arrays["1.weight"]})
    with pytest.raises(MXNetError, match="other_weight"):
        fresh.load_parameters(stranger)
