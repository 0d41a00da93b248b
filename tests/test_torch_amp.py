"""``contrib.amp`` of the PyTorch port against ``mxnet_tpu.contrib.amp``,
on the CPU.

- Every case of ``tests/test_amp.py`` in both packages: a target op
  runs in the half type, an fp32 op is pinned, mixed inputs of a
  widest-type op meet in the wider type, nothing casts when AMP is off,
  the casts ride a hybridized block and a bound executor, and a small
  classifier trains under ``init_trainer``/``scale_loss``.
- The built-in layers' eager outputs take the JAX layers' types under
  AMP (Dense, Embedding, Conv2D and LSTM in the half type; LayerNorm,
  BatchNorm in predict mode, InstanceNorm, GroupNorm and the losses in
  float32; BatchNorm in train mode keeps its input's type). An
  Embedding's float ids keep their type (the JAX hook rounds them).
- A one-layer BERT + MLM head (as ``tests/test_torch_trainer.py``
  builds it, the JAX kernels in interpret mode) under bfloat16 AMP:
  every child block's output type equals the JAX block's, the step-1
  loss is within 1e-2 relative and each gradient within 1e-2 of its
  largest JAX value (the products' biases 3e-2: each is a bfloat16 sum
  over the batch's rows of a cotangent). The products are bfloat16 on
  both sides, rounded once each but summed in another order (a
  kernel's tiles against XLA's), so the two runs differ by bfloat16
  rounding, not by float32's.
- A two-layer LSTM under bfloat16 AMP (the JAX package's fused kernels
  in interpret mode): output and states in bfloat16 on both sides,
  within 2e-2 of scale.
- Loss scaling in float16: a step made to overflow (the scale raised to
  2**40) leaves every weight as it was and halves the scale; the other
  steps update; ``unscale`` divides the gradients by the scale.
- A block hybridized before ``amp.init()`` captures anew after it and
  after ``disable()``; so does a bound executor.
- ``examples/bert_mlm.py`` trains under AMP and leaves it off;
  ``examples/word_lm.py --amp bfloat16`` ends within 2% of the float32
  run's perplexity.

AMP is process-wide: an autouse fixture turns it off in both packages
after every test and checks that neither is left on.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMHead as JaxMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.ndarray import register as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn, rnn
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMHead, BERTModel
from mxnet_tpu_torch.ndarray import register as treg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()
    jamp.disable()
    assert not amp.is_initialized() and not jamp.is_initialized()
    assert treg._DISPATCH_CAST_HOOK is None
    assert jreg._DISPATCH_CAST_HOOK is None


def _init(dtype="bfloat16"):
    amp.init(target_dtype=dtype)
    jamp.init(target_dtype=dtype)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _nd(a):
    return nd.array(a, ctx=tmx.cpu())


# -- tests/test_amp.py, in both packages --------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_target_op_runs_half(dtype):
    _init(dtype)
    j = jnd.FullyConnected(jnd.ones((2, 4)), jnd.ones((3, 4)), None,
                           num_hidden=3, no_bias=True)
    t = nd.FullyConnected(torch.ones(2, 4), torch.ones(3, 4), None,
                          num_hidden=3, no_bias=True)
    assert _name(t.dtype) == str(j.dtype) == dtype
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.asnumpy(), np.float32))


def test_fp32_op_pinned():
    _init()
    j = jnd.softmax(jnd.ones((2, 4), dtype="bfloat16"))
    t = nd.softmax(torch.ones(2, 4, dtype=torch.bfloat16))
    assert _name(t.dtype) == str(j.dtype) == "float32"


def test_widest_cast():
    _init()
    j = jnd.broadcast_add(jnd.ones((2, 2), dtype="bfloat16"),
                          jnd.ones((2, 2), dtype="float32"))
    t = nd.broadcast_add(torch.ones(2, 2, dtype=torch.bfloat16),
                         torch.ones(2, 2))
    assert _name(t.dtype) == str(j.dtype) == "float32"


def test_no_cast_when_disabled():
    j = jnd.FullyConnected(jnd.ones((2, 4)), jnd.ones((3, 4)), None,
                           num_hidden=3, no_bias=True)
    t = nd.FullyConnected(torch.ones(2, 4), torch.ones(3, 4), None,
                          num_hidden=3, no_bias=True)
    assert _name(t.dtype) == str(j.dtype) == "float32"


def test_amp_inside_hybridized_graph():
    _init()
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(8, in_units=4))
    jnet.initialize()
    jnet.hybridize()
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4, device="cpu"))
    net.hybridize()
    j = jnet(jnd.ones((2, 4)))
    t = net(torch.ones(2, 4))
    assert _name(t.dtype) == str(j.dtype) == "bfloat16"


def test_amp_symbolic_executor():
    _init()
    outs = []
    for m in (mx, tmx):
        s = m.sym.FullyConnected(m.sym.var("data"), num_hidden=4,
                                 no_bias=True, name="fc")
        ex = s.simple_bind(m.cpu(0), data=(2, 6), fc_weight=(4, 6))
        outs.append(ex.forward()[0])
    assert str(outs[0].dtype) == _name(outs[1].dtype) == "bfloat16"


def _classifier_data():
    rs = np.random.RandomState(0)
    n, d, c = 256, 10, 3
    w = rs.randn(d, c).astype(np.float32)
    x = rs.randn(n, d).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.float32), c


def test_amp_training_converges():
    """The JAX case's recipe in both packages, from the same weights
    (hybridized: the casts ride the graphs, and the JAX side compiles
    its step once)."""
    _init()
    x, y, c = _classifier_data()
    mx.random.seed(0)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(32, activation="relu", in_units=10),
             jgluon.nn.Dense(c, in_units=32))
    jnet.initialize(init=mx.initializer.Xavier())
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=10, device="cpu"),
            nn.Dense(c, in_units=32, device="cpu"))
    for tp, jp in zip(net.collect_params().values(),
                      jnet.collect_params().values()):
        tp.set_data(jp.data().asnumpy())
    jnet.hybridize()
    net.hybridize()
    accs = []
    for lib, m, netx, loss_fn in (
            ("jax", (jnd, jag), jnet, jgluon.loss.SoftmaxCrossEntropyLoss()),
            ("torch", (nd, ag), net, gluon.loss.SoftmaxCrossEntropyLoss())):
        mod, autograd = m
        trainer = (jgluon if lib == "jax" else gluon).Trainer(
            netx.collect_params(), "adam", {"learning_rate": 5e-3})
        (jamp if lib == "jax" else amp).init_trainer(trainer)
        arr = (lambda a: jnd.array(a)) if lib == "jax" else _nd
        for _ in range(25):
            for i in range(0, len(x), 64):
                xb, yb = arr(x[i:i + 64]), arr(y[i:i + 64])
                with autograd.record():
                    loss = loss_fn(netx(xb), yb)
                with (jamp if lib == "jax" else amp).scale_loss(
                        loss, trainer) as scaled:
                    scaled.backward()
                trainer.step(64)
        out = netx(arr(x))
        out = out.asnumpy() if lib == "jax" else out.float().numpy()
        accs.append((np.asarray(out, np.float32).argmax(1) == y).mean())
    assert min(accs) > 0.8, accs


# -- the built-in layers' eager outputs ---------------------------------------
def _carry(jblock, tblock):
    """The JAX block's weights into the port's, by structural order."""
    for tp, jp in zip(tblock.collect_params().values(),
                      jblock.collect_params().values()):
        tp.set_data(np.asarray(jp.data().asnumpy(), np.float32))


def _layer_cases():
    rs = np.random.RandomState(2)
    img = rs.randn(2, 4, 5, 5).astype(np.float32)
    vec = rs.randn(3, 6).astype(np.float32)
    ids = rs.randint(0, 7, (3, 5)).astype(np.float32)
    lab = rs.randint(0, 6, (3,)).astype(np.float32)
    cpu = {"device": "cpu"}
    return {
        "Dense": (lambda L: L.nn.Dense(5, in_units=6,
                                       **(cpu if L is gluon else {})),
                  (vec,), "predict"),
        "Embedding": (lambda L: L.nn.Embedding(7, 4,
                                               **(cpu if L is gluon else {})),
                      (ids,), "predict"),
        "LayerNorm": (lambda L: L.nn.LayerNorm(in_channels=6,
                                               **(cpu if L is gluon else {})),
                      (vec,), "predict"),
        "Conv2D": (lambda L: L.nn.Conv2D(3, 3, in_channels=4,
                                         **(cpu if L is gluon else {})),
                   (img,), "predict"),
        "BatchNorm-predict": (lambda L: L.nn.BatchNorm(
            in_channels=4, **(cpu if L is gluon else {})), (img,), "predict"),
        "BatchNorm-train": (lambda L: L.nn.BatchNorm(
            in_channels=4, **(cpu if L is gluon else {})), (img,), "train"),
        "InstanceNorm": (lambda L: L.nn.InstanceNorm(
            in_channels=4, **(cpu if L is gluon else {})), (img,), "predict"),
        "GroupNorm": (lambda L: L.nn.GroupNorm(
            2, in_channels=4, **(cpu if L is gluon else {})), (img,),
            "predict"),
        "SoftmaxCELoss": (lambda L: L.loss.SoftmaxCrossEntropyLoss(),
                          (vec, lab), "predict"),
        "L2Loss": (lambda L: L.loss.L2Loss(), (vec, vec[::-1].copy()),
                   "predict"),
    }


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layer_output_types_match_jax(case):
    make, inputs, mode = _layer_cases()[case]
    jblock, tblock = make(jgluon), make(gluon)
    if hasattr(jblock, "initialize") and jblock.collect_params():
        jblock.initialize(init=mx.initializer.Xavier())
        with jag.predict_mode():
            jblock(*(jnd.array(a) for a in inputs))
        _carry(jblock, tblock)
    _init()
    half = {"Dense", "Embedding", "Conv2D"}
    # the half-type inputs of the normalizations: what a product gives
    if case.startswith(("BatchNorm", "InstanceNorm", "GroupNorm",
                        "LayerNorm")):
        inputs = (inputs[0].astype("float32"),)
        jin = [jnd.array(inputs[0]).astype("bfloat16")]
        tin = [_t(inputs[0], torch.bfloat16)]
    else:
        jin = [jnd.array(a) for a in inputs]
        tin = [_t(a) for a in inputs]
    jscope = jag.train_mode() if mode == "train" else jag.predict_mode()
    tscope = ag.train_mode() if mode == "train" else ag.predict_mode()
    with jscope:
        j = jblock(*jin)
    with tscope:
        t = tblock(*tin)
    want = "bfloat16" if case in half or case == "BatchNorm-train" \
        else "float32"
    assert _name(t.dtype) == str(j.dtype) == want, case
    # both round a float32 (or wider) result to the output type once
    jv = np.asarray(j.asnumpy(), np.float32)
    tol = 2 ** -7 * max(1.0, np.abs(jv).max()) if want == "bfloat16" \
        else 1e-5 * max(1.0, np.abs(jv).max())
    np.testing.assert_allclose(t.float().detach().numpy(), jv, atol=tol,
                               rtol=0, err_msg=case)


def test_embedding_ids_keep_their_type_under_amp():
    """The table goes to bfloat16, the float ids do not (the JAX hook
    casts them too, which would turn id 257 into 256)."""
    _init()
    emb = nn.Embedding(1000, 4, device="cpu")
    ids = torch.tensor([[257.0, 999.0]])
    want = emb.weight.detach()[[257, 999]].to(torch.bfloat16)[None]
    for out in (emb(ids), nd.Embedding(ids, emb.weight, input_dim=1000,
                                       output_dim=4)):
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.detach(), want)


# -- BERT + MLM head under bfloat16 AMP ---------------------------------------
VOCAB, UNITS, HEADS = 120, 32, 4


def _bert_batch():
    rng = np.random.RandomState(8)
    lens = np.array([16, 9, 12], np.int32)
    ids = rng.randint(0, VOCAB, (3, 16)).astype(np.int32)
    pos = np.concatenate([r * 16 + np.arange(n)
                          for r, n in enumerate(lens)]).astype(np.int32)
    labels = rng.randint(0, VOCAB, len(pos)).astype(np.int32)
    return ids, lens, pos, labels


def _numpy_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _type_trace(blocks, register):
    """[(class, output type)] in the order the blocks finish."""
    seen = []

    def hook(block, inputs, output):
        out = output[0] if isinstance(output, (tuple, list)) else output
        seen.append((type(block).__name__, _name(out.dtype)))

    for b in blocks:
        register(b, hook)
    return seen


def _jax_blocks(block):
    out = [block]
    for child in block._children.values():
        out += _jax_blocks(child)
    return out


def test_tiny_bert_mlm_under_amp_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    mx.random.seed(5)
    net = JaxBERT(vocab_size=VOCAB, units=UNITS, hidden_size=64,
                  num_layers=1, num_heads=HEADS, max_length=40,
                  dropout=0.0, attention_dropout=0.0, use_pooler=False)
    head = JaxMLM(VOCAB, UNITS)
    for b in (net, head):
        b.initialize(init=mx.initializer.Normal(0.02))
    ids, lens, pos, labels = _bert_batch()
    j_ids, j_lens, j_pos, j_lab = (mx.nd.array(a, dtype="int32")
                                   for a in (ids, lens, pos, labels))
    j_tt = mx.nd.zeros(ids.shape, dtype="int32")
    with jag.predict_mode():
        head(net(j_ids, j_tt, j_lens))
    tnet = BERTModel.from_gluon_params(_numpy_params(net), HEADS,
                                       device="cpu")
    thead = BERTMLMHead.from_gluon_params(_numpy_params(head), device="cpu")
    t_ids, t_lens, t_pos, t_lab = (torch.from_numpy(a) for a in
                                   (ids, lens, pos, labels))
    t_tt = torch.zeros_like(t_ids)

    jseen = _type_trace(_jax_blocks(net) + _jax_blocks(head),
                        lambda b, h: b.register_forward_hook(h))
    tseen = _type_trace(list(tnet.modules()) + list(thead.modules()),
                        lambda b, h: b.register_forward_hook(h))
    _init()
    with jag.record():
        seq = net(j_ids, j_tt, j_lens)
        flat = mx.nd.take(seq.reshape((-1, UNITS)), j_pos)
        logits = head(flat)
        loss = mx.nd.softmax_cross_entropy(logits, j_lab)
    loss.backward()
    with ag.record():
        tseq = tnet(t_ids, t_tt, t_lens)
        tflat = tseq.reshape(-1, UNITS)[t_pos.long()]
        tlogits = thead(tflat)
        tloss = nd.softmax_cross_entropy(tlogits, t_lab)
    tloss.backward()
    assert tseen == jseen
    # the JAX package's types: encoder f32 (LayerNorm), logits bf16
    # (FullyConnected), loss f32 (softmax_cross_entropy)
    assert (str(seq.dtype), str(logits.dtype), str(loss.dtype)) == \
        ("float32", "bfloat16", "float32")
    assert (_name(tseq.dtype), _name(tlogits.dtype), _name(tloss.dtype)) \
        == ("float32", "bfloat16", "float32")
    np.testing.assert_allclose(tloss.item(), float(loss.asnumpy()[0]),
                               rtol=1e-2)
    jparams = {}
    for b in (net, head):
        jparams.update(b.collect_params())
    tparams = dict(tnet.collect_params().items())
    tparams.update(thead.collect_params().items())
    jnames = {name: jname for name in tparams for jname in jparams
              if jname.endswith(name)
              and jname[:-len(name)] in (net.prefix, head.prefix)}
    assert len(jnames) == len(tparams) == len(jparams)
    for name, p in tparams.items():
        g = p.grad().numpy()
        jg = np.asarray(jparams[jnames[name]].grad().asnumpy(), np.float32)
        assert g.dtype == np.float32 and jg.dtype == np.float32, name
        # a bias's gradient is a bfloat16 sum over the batch's 48 rows of
        # its product's cotangent, rounded in each side's own order
        tol = 3e-2 if name.endswith("_bias") and "_ln_" not in name \
            and not name.startswith("ln_") else 1e-2
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=tol * np.abs(jg).max(),
                                   err_msg=name)


# -- the LSTM under bfloat16 AMP ----------------------------------------------
def test_lstm_under_amp_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_LSTM", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    T, N, I, H = 5, 4, 12, 8
    mx.random.seed(11)
    jnet = jgluon.rnn.LSTM(H, num_layers=2, layout="NTC")
    jnet.initialize(init=mx.initializer.Xavier())
    with jag.predict_mode():
        jnet(jnd.zeros((N, T, I)))
    pre = jnet.prefix
    net = rnn.LSTM(H, num_layers=2, layout="NTC", input_size=I,
                   device="cpu")
    net.load_gluon_params({k[len(pre):]: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    rng = np.random.RandomState(6)
    x = rng.randn(N, T, I).astype(np.float32)
    states = [(rng.randn(2, N, H) * 0.5).astype(np.float32)
              for _ in range(2)]
    _init()
    jout, jst = jnet(jnd.array(x), [jnd.array(s) for s in states])
    tout, tst = net(_t(x), [_t(s) for s in states])
    for name, g, w in (("out", tout, jout), ("h", tst[0], jst[0]),
                       ("c", tst[1], jst[1])):
        assert _name(g.dtype) == str(w.dtype) == "bfloat16", name
        wv = np.asarray(w.asnumpy(), np.float32)
        np.testing.assert_allclose(g.float().numpy(), wv, rtol=0,
                                   atol=2e-2 * np.abs(wv).max(),
                                   err_msg=name)


# -- float16 loss scaling -----------------------------------------------------
def test_float16_loss_scaling_skips_an_overflowed_step():
    """Steps 0 and 2 run at scale 2**10 and update; step 1, at scale
    2**40, overflows the float16 products' cotangents: no weight moves
    and the scale halves, in both packages. (At the initial 2**16 this
    batch overflows already: each sample's head gradient is 1.)"""
    _init("float16")
    x, y, c = _classifier_data()
    x, y = x[:32], y[:32]
    mx.random.seed(1)
    jnet = jgluon.nn.Dense(c, in_units=10)
    jnet.initialize(init=mx.initializer.Xavier())
    net = nn.Dense(c, in_units=10, device="cpu")
    _carry(jnet, net)
    runs = {}
    for lib in ("jax", "torch"):
        is_jax = lib == "jax"
        m_amp, autograd = (jamp, jag) if is_jax else (amp, ag)
        block = jnet if is_jax else net
        G = jgluon if is_jax else gluon
        trainer = G.Trainer(block.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        m_amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        assert scaler.loss_scale == 2.0 ** 16
        arr = (lambda a: jnd.array(a)) if is_jax else _nd
        loss_fn = G.loss.SoftmaxCrossEntropyLoss()

        def weights():
            return [np.asarray(p.data().asnumpy(), np.float32).copy()
                    for p in block.collect_params().values()]

        scales, moved, losses = [], [], []
        for step in range(3):
            scaler._scale = 2.0 ** 40 if step == 1 else 2.0 ** 10
            before = weights()
            with autograd.record():
                loss = loss_fn(block(arr(x)), arr(y))
            with m_amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            used = scaler.loss_scale
            trainer.step(len(x))
            scales.append((used, scaler.loss_scale))
            moved.append([not np.array_equal(a, b)
                          for a, b in zip(before, weights())])
            lv = loss.asnumpy() if is_jax else loss.detach().numpy()
            losses.append(float(np.mean(lv)))
        runs[lib] = scales, moved, losses
        assert scales == [(2.0 ** 10, 2.0 ** 10), (2.0 ** 40, 2.0 ** 39),
                          (2.0 ** 10, 2.0 ** 10)], (lib, scales)
        assert moved == [[True, True], [False, False], [True, True]], \
            (lib, moved)
        assert np.all(np.isfinite(losses)), (lib, losses)
    np.testing.assert_allclose(runs["torch"][2], runs["jax"][2], rtol=1e-2)


def test_unscale_divides_the_gradients_by_the_scale():
    _init("float16")
    x, y, c = _classifier_data()
    mx.random.seed(2)
    jnet = jgluon.nn.Dense(c, in_units=10)
    jnet.initialize(init=mx.initializer.Xavier())
    net = nn.Dense(c, in_units=10, device="cpu")
    _carry(jnet, net)
    grads = {}
    for lib in ("jax", "torch"):
        is_jax = lib == "jax"
        m_amp, autograd = (jamp, jag) if is_jax else (amp, ag)
        block = jnet if is_jax else net
        G = jgluon if is_jax else gluon
        trainer = G.Trainer(block.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        m_amp.init_trainer(trainer)
        trainer._amp_loss_scaler._scale = 2.0 ** 10
        arr = (lambda a: jnd.array(a)) if is_jax else _nd
        with autograd.record():
            loss = G.loss.SoftmaxCrossEntropyLoss()(block(arr(x[:16])),
                                                    arr(y[:16]))
        with m_amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        scaled_g = [np.asarray(p.grad().asnumpy(), np.float32).copy()
                    for p in block.collect_params().values()]
        m_amp.unscale(trainer)
        grads[lib] = [np.asarray(p.grad().asnumpy(), np.float32)
                      for p in block.collect_params().values()]
        for s, g in zip(scaled_g, grads[lib]):
            np.testing.assert_allclose(g, s / 2.0 ** 10, rtol=1e-6)
    for g, w in zip(grads["torch"], grads["jax"]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-2 * np.abs(w).max())


def test_convert_model_casts_and_keeps_batchnorm_float32():
    _init()
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(4, in_units=3), jgluon.nn.BatchNorm(
        in_channels=4))
    jnet.initialize()
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3, device="cpu"),
            nn.BatchNorm(in_channels=4, device="cpu"))
    jamp.convert_model(jnet)
    amp.convert_model(net)
    assert [str(p.dtype) for p in jnet.collect_params().values()] == \
        [_name(p.dtype) for p in net.collect_params().values()]


# -- graphs keyed on the AMP state --------------------------------------------
def test_hybridized_block_recaptures_across_amp_switches():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4, device="cpu"))
    net.hybridize()
    x = torch.ones(2, 4)
    types = [net(x).dtype]
    amp.init()
    types.append(net(x).dtype)
    amp.disable()
    types.append(net(x).dtype)
    types.append(net(x).dtype)
    assert types == [torch.float32, torch.bfloat16, torch.float32,
                     torch.float32]
    # three AMP states, three entries; the fourth call reused the third
    assert len(net._cached_graph) == 3


def test_bound_executor_recaptures_across_amp_switches():
    s = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=4,
                               no_bias=True, name="fc")
    ex = s.simple_bind(tmx.cpu(0), data=(2, 6), fc_weight=(4, 6))
    types = [ex.forward()[0].dtype]
    amp.init()
    types.append(ex.forward()[0].dtype)
    amp.disable()
    types.append(ex.forward()[0].dtype)
    assert types == [torch.float32, torch.bfloat16, torch.float32]


# -- the AMP example scripts --------------------------------------------------
def test_bert_mlm_example_trains_under_amp_and_turns_it_off():
    from mxnet_tpu_torch.examples import bert_mlm

    losses = bert_mlm.main(["--device", "cpu", "--quick", "--steps", "4"])
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not amp.is_initialized()


def test_word_lm_example_under_amp_matches_float32_closely():
    """``--amp bfloat16`` against float32 on the quick corpus: the same
    perplexity within 2% after four epochs (bfloat16 products)."""
    from mxnet_tpu_torch.examples import word_lm

    ppl = word_lm.main(["--device", "cpu", "--quick", "--amp", "bfloat16"])
    assert not amp.is_initialized()
    ref = word_lm.main(["--device", "cpu", "--quick"])
    np.testing.assert_allclose(ppl, ref, rtol=2e-2)
