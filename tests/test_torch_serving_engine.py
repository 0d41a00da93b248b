"""The PyTorch port's encoder ``ServingEngine`` on the CPU, against the
JAX package's with the same tiny BERT weights and the same requests.

Results agree within 1e-5 (float32; the two engines may pack the same
requests into different batches, and packing keeps requests apart
exactly, so only summation order differs). Concurrent clients are held
against solo forwards, as tests/test_serving.py holds the JAX engine.
The admission errors, warmup and shutdown are the port's own checks.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.gluon.model_zoo.bert import (
    bert_serving_entry as jax_serving_entry)
from mxnet_tpu.serving import ServingEngine as JaxEngine
from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                  bert_serving_entry)
from mxnet_tpu_torch.serving import (ContinuousBatcher,
                                     DeadlineExceededError,
                                     EngineStoppedError, QueueFullError,
                                     RequestTooLongError, ServingEngine)

torch.set_num_threads(1)

BUCKETS, MAX_ROWS = (16, 40), 4


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(11)
    jnet = JaxBERT(vocab_size=120, units=32, hidden_size=64, num_layers=2,
                   num_heads=4, max_length=40, dropout=0.0,
                   attention_dropout=0.0, use_pooler=False)
    jnet.initialize(init=mx.initializer.Normal(0.02))
    one = mx.nd.array(np.ones((1, 3), np.int32), dtype="int32")
    jnet(one, mx.nd.zeros((1, 3), dtype="int32"))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    return jnet, BERTModel.from_gluon_params(params, 4, device="cpu")


def _requests(seed=7, n=14):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        toks = rs.randint(1, 120, rs.randint(1, 41)).astype(np.int32)
        tt = None
        if i % 2:                         # second half of token type 1
            tt = np.zeros(len(toks), np.int32)
            tt[len(toks) // 2:] = 1
        out.append((toks, tt))
    return out


def _serve(eng, reqs):
    with eng:
        futs = [eng.submit(t, tt) for t, tt in reqs]
        return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("pool", ["tokens", "mean", "cls"])
def test_results_match_the_jax_engine(nets, pool):
    jnet, tnet = nets
    reqs = _requests()
    want = _serve(JaxEngine(jax_serving_entry(jnet), bucket_lens=BUCKETS,
                            max_rows=MAX_ROWS, pool=pool), reqs)
    eng = ServingEngine(bert_serving_entry(tnet), device="cpu",
                        bucket_lens=BUCKETS, max_rows=MAX_ROWS, pool=pool)
    got = _serve(eng, reqs)
    for (toks, _), g, w in zip(reqs, got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    snap = eng.snapshot()
    assert snap["counters"]["completed"] == len(reqs)
    assert snap["device"] == "cpu"
    assert snap["costs"]["requests"] == len(reqs)


def test_concurrent_clients_match_solo_forwards(nets):
    _, tnet = nets
    eng = ServingEngine(bert_serving_entry(tnet), device="cpu",
                        bucket_lens=(16,), max_rows=4, max_queue_depth=128)
    lens = [3, 5, 8, 11, 13, 15]
    n_clients, per_client = 8, 4
    results, errors = {}, []

    def client(cid):
        rc = np.random.RandomState(100 + cid)
        try:
            for j in range(per_client):
                toks = rc.randint(1, 120, lens[(cid + j) % len(lens)]) \
                    .astype(np.int32)
                results[(cid, j)] = (toks, eng.infer(toks, timeout=300))
        except Exception as e:      # a lost response fails below
            errors.append((cid, e))

    with eng:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    assert not errors, errors
    assert len(results) == n_clients * per_client
    for (cid, j), (toks, out) in sorted(results.items()):
        one = torch.from_numpy(toks[None])
        solo = tnet(one, torch.zeros_like(one))[0].numpy()
        np.testing.assert_allclose(out, solo, atol=1e-5, rtol=1e-5,
                                   err_msg=f"client {cid} request {j}")
    c = eng.snapshot()["counters"]
    assert c["completed"] == c["submitted"] == n_clients * per_client
    assert eng.snapshot()["packing_efficiency"] is not None


class Stub:
    """Contract-shaped stand-in: out[b, s, 0] == ids[b, s]; records
    each forward's shape and can hold the worker inside a forward."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.started = threading.Event()
        self.shapes = []

    def __call__(self, ids, token_types, valid_length, segment_ids,
                 positions):
        self.started.set()
        if self.delay:
            time.sleep(self.delay)
        self.shapes.append(tuple(ids.shape))
        return ids.float()[..., None]


def test_warmup_runs_every_shape_of_the_universe():
    stub = Stub()
    eng = ServingEngine(stub, device="cpu", bucket_lens=(8, 32), max_rows=4)
    with eng:
        eng.warmup()
        universe = ContinuousBatcher((8, 32), 4).shape_universe()
        assert stub.shapes == universe
        warm = eng.cost_table()["buckets"]
        assert set(warm) == {"8", "32"}
        assert all(r["requests"] == 0 and r["batches"] == 3
                   for r in warm.values())
        assert eng.infer([5, 6, 7], timeout=30)[:, 0].tolist() == [5, 6, 7]
    assert eng.snapshot()["visited_shapes"] == len(universe)


def test_queue_full_deadline_and_oversize_errors():
    stub = Stub(delay=0.4)
    eng = ServingEngine(stub, device="cpu", bucket_lens=(16,), max_rows=1,
                        max_queue_depth=2)
    with eng:
        first = eng.submit([1])                 # drained into the worker
        assert stub.started.wait(10)
        late = eng.submit([2], deadline_ms=10)  # expires in the queue
        ok = eng.submit([3])
        with pytest.raises(QueueFullError):
            eng.submit([4])
        with pytest.raises(RequestTooLongError):
            eng.submit(list(range(17)))
        assert first.result(timeout=30)[0, 0] == 1
        assert ok.result(timeout=30)[0, 0] == 3
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=30)
    c = eng.snapshot()["counters"]
    assert (c["rejected_queue_full"], c["rejected_too_long"],
            c["expired"], c["completed"]) == (1, 1, 1, 2)


def test_stop_drains_or_aborts():
    stub = Stub(delay=0.02)
    eng = ServingEngine(stub, device="cpu", bucket_lens=(16,), max_rows=1,
                        max_queue_depth=64)
    eng.start()
    futs = [eng.submit([i + 1]) for i in range(8)]
    eng.stop(drain=True, timeout=60)            # returns once drained
    assert [f.result(timeout=0.1)[0, 0] for f in futs] == \
        list(range(1, 9))
    assert not eng.running
    with pytest.raises(EngineStoppedError):
        eng.submit([1])

    stub = Stub(delay=0.3)
    eng = ServingEngine(stub, device="cpu", bucket_lens=(16,), max_rows=1,
                        max_queue_depth=8)
    eng.start()
    f1 = eng.submit([1, 2])
    assert stub.started.wait(10)
    pending = [eng.submit([3]), eng.submit([4])]
    eng.stop(drain=False, timeout=60)
    assert f1.result(timeout=30).shape == (2, 1)    # in flight finishes
    for f in pending:
        with pytest.raises(EngineStoppedError):
            f.result(timeout=5)
    assert eng.stats.count("cancelled") == 2


def test_swap_model_warms_the_new_fn_over_visited_shapes():
    old, new = Stub(), Stub()
    eng = ServingEngine(old, device="cpu", bucket_lens=(8, 16), max_rows=2)
    with eng:
        eng.infer([1, 2, 3], timeout=30)
        eng.infer(list(range(1, 13)), timeout=30)
        eng.swap_model(new, version="v1")
        assert sorted(new.shapes) == [(1, 8), (1, 16)]
        assert eng.infer([9], timeout=30)[0, 0] == 9
    assert new.shapes[-1] == (1, 8)
    assert eng.snapshot()["models"] == {"default": "v1"}


def test_stopped_engine_is_collected():
    """``stop()`` unregisters every scrape-time function the engine set
    (queue depth, the WFQ depth of each tenant class): a stopped and
    dropped engine is collected, and ``reset_stats`` after ``stop``
    registers nothing that holds it."""
    import gc
    import weakref

    eng = ServingEngine(Stub(), device="cpu", bucket_lens=(8,), max_rows=2)
    eng.start()
    assert eng.infer([5, 6], timeout=30)[:, 0].tolist() == [5, 6]
    eng.stop(timeout=30)
    eng.reset_stats()
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
