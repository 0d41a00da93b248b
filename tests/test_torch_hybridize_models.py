"""Hybridized models on the port against the JAX package's, on the CPU.

BERT at 2 layers and 64 units (4 heads, vocabulary 100): a hybridized
training step (trunk and MLM head, each its own CachedOp) gives the JAX
hybridized model's loss within 1e-5 relative and its gradients within
1e-4 of each parameter's largest gradient; ``bert_serving_entry(...,
hybridize=True)`` through ``ServingEngine`` answers as the JAX engine
does (within 1e-5, as ``test_torch_serving_engine.py``) with its
compile counts: the port's captures (``miss``) equal the JAX engine's
``miss + persistent_hit``, the replays its ``memory_hit``. A
``PagedCausalLM`` behind ``DecodeEngine`` (whose steps are keyed as
the card's graphs are) serves the greedy streams of its bodies called
directly and of the JAX engine token for token, and counts captures
and replays as the JAX engine counts compiles and hits. The JAX side
runs hybridized, its Pallas kernels in interpret mode
(``MXNET_TPU_PALLAS_INTERPRET=1``).
"""
import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMHead as JaxMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.gluon.model_zoo.bert import (
    bert_serving_entry as jax_serving_entry)
from mxnet_tpu.serving import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serving import PagedCausalLM as JaxLM
from mxnet_tpu.serving import ServingEngine as JaxEngine
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTMLMHead, BERTModel,
                                                  bert_serving_entry)
from mxnet_tpu_torch.serving import (DecodeEngine, PagedCausalLM,
                                     ServingEngine)

torch.set_num_threads(1)

VOCAB, UNITS, HEADS = 100, 64, 4


def _numpy_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _bert_pair():
    jmx.random.seed(5)
    jnet = JaxBERT(vocab_size=VOCAB, units=UNITS, hidden_size=128,
                   num_layers=2, num_heads=HEADS, max_length=32,
                   dropout=0.0, attention_dropout=0.0, use_pooler=False)
    jhead = JaxMLM(VOCAB, UNITS)
    for b in (jnet, jhead):
        b.initialize(init=jmx.initializer.Normal(0.02))
    one = jmx.nd.array(np.ones((1, 3), np.int32), dtype="int32")
    with jag.predict_mode():
        jhead(jnet(one, jmx.nd.zeros((1, 3), dtype="int32")))
    tnet = BERTModel.from_gluon_params(_numpy_params(jnet), HEADS,
                                       device="cpu")
    thead = BERTMLMHead.from_gluon_params(_numpy_params(jhead),
                                          device="cpu")
    return jnet, jhead, tnet, thead


def test_hybridized_bert_training_step_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    jnet, jhead, tnet, thead = _bert_pair()
    rng = np.random.RandomState(8)
    lens = np.array([32, 19, 7, 25], np.int32)
    ids = rng.randint(0, VOCAB, (4, 32)).astype(np.int32)
    pos = np.concatenate([r * 32 + np.arange(n)
                          for r, n in enumerate(lens)]).astype(np.int32)
    labels = rng.randint(0, VOCAB, len(pos)).astype(np.int32)
    for b in (jnet, jhead, tnet, thead):
        b.hybridize()
    j_ids, j_lens, j_pos, j_lab = (jmx.nd.array(a, dtype="int32")
                                   for a in (ids, lens, pos, labels))
    t_ids, t_lens, t_pos, t_lab = (torch.from_numpy(a)
                                   for a in (ids, lens, pos, labels))
    for _ in range(2):         # the second call replays
        with jag.record():
            seq = jnet(j_ids, jmx.nd.zeros(ids.shape, dtype="int32"),
                       j_lens)
            flat = jmx.nd.take(seq.reshape((-1, UNITS)), j_pos)
            jloss = jmx.nd.softmax_cross_entropy(jhead(flat), j_lab)
        with ag.record():
            seq = tnet(t_ids, torch.zeros_like(t_ids), t_lens)
            flat = seq.reshape(-1, UNITS)[t_pos.long()]
            tloss = nd.softmax_cross_entropy(thead(flat), t_lab)
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.asnumpy()[0]),
                               rtol=1e-5)
    jparams = {}
    for b in (jnet, jhead):
        jparams.update({k[len(b.prefix):]: p
                        for k, p in b.collect_params().items()})
    for block in (tnet, thead):
        for name, p in block.gluon_params().items():
            want = jparams[name].grad().asnumpy()
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
    assert len(tnet._cached_graph) == len(thead._cached_graph) == 1


def _serve(eng, reqs):
    # one request at a time, so the batches, and the shapes they
    # compile or capture, do not depend on timing
    with eng:
        return [eng.submit(t).result(timeout=300) for t in reqs], \
            eng.snapshot()["compile_cache"]


def test_hybridized_serving_entry_matches_the_jax_engine(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    jnet, _, tnet, _ = _bert_pair()
    rs = np.random.RandomState(7)
    reqs = [rs.randint(1, VOCAB, rs.randint(1, 31)).astype(np.int32)
            for _ in range(10)]
    kw = dict(bucket_lens=(16, 32), max_rows=4, pool="mean")
    want, jcc = _serve(JaxEngine(jax_serving_entry(jnet), **kw), reqs)
    got, tcc = _serve(ServingEngine(bert_serving_entry(tnet), device="cpu",
                                    **kw), reqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    assert tcc["miss"] == jcc["miss"] + jcc["persistent_hit"] > 0
    assert tcc["memory_hit"] == jcc["memory_hit"]
    assert tcc["persistent_hit"] == 0


GEOM = dict(vocab=64, units=32, layers=2, heads=4, max_len=128, seed=7)
ENGINE = dict(prefill_bucket_lens=(8, 16), max_rows=4, page_size=8,
              n_pages=24, max_new_tokens=6)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12],
           [3, 1, 4, 1, 5, 9, 2, 6], [13, 10, 7]]


def _decode(engine):
    with engine as eng:
        eng.warmup()
        warm = dict(eng.snapshot()["compile_cache"])
        futs = [eng.submit(p, max_new_tokens=7) for p in PROMPTS]
        streams = [f.result(timeout=300).tolist() for f in futs]
        return streams, warm, eng.snapshot()["compile_cache"]


def _eager(model):
    """``model`` with its steps' bodies called directly, outside the
    keyed step cache (graphs on the card): the eager reference."""
    def run(name, caches, arrays, body):
        return body(caches, *[torch.as_tensor(np.asarray(a, np.int64),
                                              device=model.device)
                              for a in arrays])

    model._run = run
    return model


def test_hybridized_decode_engine_matches_eager_and_jax():
    js, jwarm, jcc = _decode(JaxDecodeEngine(JaxLM(**GEOM), **ENGINE))
    es, ewarm, ecc = _decode(DecodeEngine(
        _eager(PagedCausalLM(device="cpu", **GEOM)), **ENGINE))
    hs, hwarm, hcc = _decode(DecodeEngine(
        PagedCausalLM(device="cpu", **GEOM), **ENGINE))
    assert hs == es == js
    # every warm-up shape is one capture (a JAX compile); traffic after
    # it only replays
    assert hwarm["miss"] == jwarm["miss"] + jwarm["persistent_hit"] > 0
    assert hcc["miss"] == hwarm["miss"]
    assert hcc["memory_hit"] - hwarm["memory_hit"] == \
        jcc["memory_hit"] - jwarm["memory_hit"] > 0
    assert ecc["miss"] == 0
