"""The PyTorch port's BERT against the JAX package's, on the CPU.

A tiny JAX ``BERTModel`` (2 layers, 32 units, 4 heads, vocab 120,
max_length 40, no dropout) is initialized, its weights are carried
across with ``BERTModel.from_gluon_params``, and the same numpy inputs
go through both. The JAX side runs its Pallas kernels in interpret
mode or its plain composed path; the port's kernels take their plain
versions on CPU tensors. float32 tolerance 1e-5: the same math summed
in another order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.io.packing import pack_sequences, unpack_sequences
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

torch.set_num_threads(1)

VOCAB, UNITS, HEADS, LAYERS, MAXLEN = 120, 32, 4, 2, 40


def _jax_bert(use_pooler=True):
    mx.random.seed(6)
    net = JaxBERT(vocab_size=VOCAB, units=UNITS, hidden_size=64,
                  num_layers=LAYERS, num_heads=HEADS, max_length=MAXLEN,
                  dropout=0.0, attention_dropout=0.0, use_pooler=use_pooler)
    net.initialize(init=mx.initializer.Normal(0.02))
    one = mx.nd.array(np.ones((1, 3), np.int32), dtype="int32")
    net(one, mx.nd.zeros((1, 3), dtype="int32"))      # resolve shapes
    return net


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_bert()
    return jnet, BERTModel.from_gluon_params(_params(jnet), HEADS,
                                             device="cpu")


def _packed_inputs(seed=22):
    rs = np.random.RandomState(seed)
    seqs = [rs.randint(1, VOCAB, n).astype(np.int32)
            for n in (18, 13, 7, 26, 3)]
    packed = pack_sequences(seqs, MAXLEN)
    tt = (rs.rand(*packed.data.shape) < 0.5).astype(np.int32)
    return seqs, packed, tt


def _jax_out(jnet, *arrays):
    nd = [None if a is None else mx.nd.array(a, dtype="int32")
          for a in arrays]
    out = jnet(*nd)
    return [o.asnumpy() for o in out]


@pytest.mark.parametrize("jax_path", ["interpret", "plain"])
def test_packed_forward_matches_jax(monkeypatch, nets, jax_path):
    if jax_path == "interpret":
        monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    jnet, tnet = nets
    _, packed, tt = _packed_inputs()
    want = _jax_out(jnet, packed.data, tt, packed.valid_length, None,
                    packed.segment_ids, packed.positions)
    t = [torch.from_numpy(a) for a in (packed.data, tt, packed.valid_length,
                                       packed.segment_ids, packed.positions)]
    seq, pooled = tnet(t[0], t[1], t[2], None, t[3], t[4])
    np.testing.assert_allclose(seq.numpy(), want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), want[1], atol=1e-5,
                               rtol=1e-5)


def test_padded_forward_matches_jax(nets):
    jnet, tnet = nets
    rs = np.random.RandomState(3)
    ids = rs.randint(1, VOCAB, (3, 17)).astype(np.int32)
    tt = np.zeros_like(ids)
    vl = np.array([17, 9, 0], np.int32)      # a 0-length example too
    want = _jax_out(jnet, ids, tt, vl)
    seq, pooled = tnet(*(torch.from_numpy(a) for a in (ids, tt, vl)))
    np.testing.assert_allclose(seq.numpy(), want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), want[1], atol=1e-5,
                               rtol=1e-5)


def test_packed_slices_equal_unpacked_outputs(nets):
    _, tnet = nets
    seqs, packed, _ = _packed_inputs()
    t = [torch.from_numpy(a) for a in (packed.data, packed.valid_length,
                                       packed.segment_ids, packed.positions)]
    seq, _ = tnet(t[0], torch.zeros_like(t[0]), t[1], None, t[2], t[3])
    for s, got in zip(seqs, unpack_sequences(seq.numpy(),
                                             packed.placements)):
        one = torch.from_numpy(s[None])
        ref, _ = tnet(one, torch.zeros_like(one))
        np.testing.assert_allclose(got, ref[0].numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_mha_flash_matches_composed():
    rng = np.random.RandomState(21)
    b, s, c = 2, 24, 32
    attn = tnn.MultiHeadAttention(c, 4, device="cpu").initialize(seed=5)
    x = torch.from_numpy(rng.randn(b, s, c).astype(np.float32))
    seg = np.zeros((b, s), np.int32)
    seg[0, :10], seg[0, 10:20], seg[1, :16] = 1, 2, 1
    seg = torch.from_numpy(seg)
    flash = attn(x, None, None, seg)            # valid_length derived
    composed = attn(x, torch.zeros(b, 1, s, s), None, seg)
    np.testing.assert_allclose(flash.numpy(), composed.numpy(), atol=1e-5,
                               rtol=1e-5)
    # padding rows attend nothing: only the output projection's bias
    pad = (seg == 0)
    bias = attn.out_proj.bias.expand(int(pad.sum()), c)
    assert torch.equal(flash[pad], bias)


def test_from_gluon_params_refuses_bad_names_and_shapes(nets):
    jnet, _ = nets
    params = _params(jnet)
    # the Gluon prefix counts models built earlier in the process
    pre = jnet.prefix
    missing = dict(params)
    missing.pop(pre + "enc_layer1_attn_out_bias")
    with pytest.raises(KeyError, match="missing"):
        BERTModel.from_gluon_params(missing, HEADS, device="cpu")
    extra = dict(params)
    extra[pre + "enc_layer1_attn_extra_weight"] = np.ones(3)
    with pytest.raises(KeyError, match="extra"):
        BERTModel.from_gluon_params(extra, HEADS, device="cpu")
    foreign = dict(params, othernet0_weight=np.ones(3))
    with pytest.raises(KeyError, match="outside the model prefix"):
        BERTModel.from_gluon_params(foreign, HEADS, device="cpu")
    bad = dict(params)
    bad[pre + "enc_layer0_ffn_ln_gamma"] = np.ones(UNITS + 1)
    with pytest.raises(ValueError, match="ffn_ln_gamma"):
        BERTModel.from_gluon_params(bad, HEADS, device="cpu")


def test_max_length_errors(nets):
    _, tnet = nets
    long_ids = torch.ones(1, MAXLEN + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds max_length"):
        tnet(long_ids, torch.zeros_like(long_ids))
    ids = torch.ones(1, 8, dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None] + MAXLEN - 4
    with pytest.raises(ValueError, match="position table"):
        tnet(ids, torch.zeros_like(ids), None, None, None, pos)
    # a packed row longer than the table is fine while every id fits
    row = torch.ones(1, MAXLEN + 10, dtype=torch.int32)
    pos = torch.arange(MAXLEN + 10, dtype=torch.int32)[None] % 25
    seq, _ = tnet(row, torch.zeros_like(row), None, None, None, pos)
    assert seq.shape == (1, MAXLEN + 10, UNITS)


def test_seeded_weights_are_the_same_on_every_build():
    kw = dict(vocab_size=50, units=16, hidden_size=32, num_layers=1,
              num_heads=2, max_length=12, device="cpu")
    a = BERTModel(seed=3, **kw).gluon_params()
    b = BERTModel(seed=3, **kw).gluon_params()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_word_weight"],
                           BERTModel(seed=4, **kw).gluon_params()
                           ["embed_word_weight"])
