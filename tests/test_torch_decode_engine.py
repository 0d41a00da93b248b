"""The PyTorch port's DecodeEngine against the JAX package's.

Same weights (same seed), same prompts, engines of the same geometry as
tests/test_decode.py's. Greedy streams must be byte-identical to the
JAX engine's solo runs: in a churning batch (join/leave solo parity),
with dense prefill instead of chunked, with prefix reuse, under pool
exhaustion (deferral), in static-cohort mode. Streamed parts must equal
``result()``.
"""
import threading
import time

import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
from mxnet_tpu_torch.serving import (DecodeEngine, EngineStoppedError,
                                     InvalidSamplingError, PagedCausalLM,
                                     RequestTooLongError,
                                     UnknownModelError)

torch.set_num_threads(1)

GEOM = dict(vocab=64, units=32, layers=2, heads=4, max_len=128, seed=7)
ENGINE = dict(prefill_bucket_lens=(8, 16), max_rows=4, page_size=8,
              n_pages=24, max_new_tokens=6)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12],
           [3, 1, 4, 1, 5, 9, 2, 6], [13, 10, 7],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]
NEWS = [8, 3, 6, 10, 4, 7, 5]


def _engine(**kw):
    return DecodeEngine(PagedCausalLM(device="cpu", **GEOM),
                        **dict(ENGINE, **kw))


@pytest.fixture(scope="module")
def jax_solo():
    """The JAX engine's solo greedy streams, one request at a time."""
    from mxnet_tpu.serving import DecodeEngine as JaxEngine
    from mxnet_tpu.serving import PagedCausalLM as JaxLM

    with JaxEngine(JaxLM(**GEOM), **ENGINE) as eng:
        return [eng.infer(p, max_new_tokens=n).tolist()
                for p, n in zip(PROMPTS, NEWS)]


def test_solo_streams_identical_to_jax(jax_solo):
    with _engine() as eng:
        eng.warmup()
        outs = [eng.infer(p, max_new_tokens=n).tolist()
                for p, n in zip(PROMPTS, NEWS)]
        eng.pool.check_isolated()
    assert outs == jax_solo


def test_join_leave_solo_parity(jax_solo):
    """Sequences joining/leaving a churning batch produce the JAX solo
    streams byte for byte, and streamed parts equal the result."""
    with _engine() as eng:
        futs = [None] * len(PROMPTS)

        def submit(i):
            time.sleep(0.003 * i)       # join at different iterations
            futs[i] = eng.submit(PROMPTS[i], max_new_tokens=NEWS[i],
                                 stream=True)

        threads = [threading.Thread(target=submit, args=(i,),
                                    name=f"pt_parity_{i}", daemon=True)
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, fut in enumerate(futs):
            parts = [p["token"] for p in fut.stream(timeout=60)]
            out = fut.result(timeout=0).tolist()
            assert out == jax_solo[i], (i, out, jax_solo[i])
            assert parts == out
            assert [p["index"] for p in fut.parts()] \
                == list(range(len(out)))
        snap = eng.snapshot()
        assert snap["decode"]["joins"] >= 2
        assert snap["decode"]["leaves"] >= 2
        eng.pool.check_isolated()
        assert eng.pool.occupancy()["pages_used"] == 0


def test_dense_prefill_matches_chunked(jax_solo):
    """``prefill_budget=0`` (whole-prompt dense prefill) gives the same
    streams as the chunked path."""
    with _engine(prefill_budget=0) as eng:
        outs = [eng.infer(p, max_new_tokens=n).tolist()
                for p, n in zip(PROMPTS, NEWS)]
        assert eng.snapshot()["decode"]["prefill_chunks"] == 0
    assert outs == jax_solo


def test_prefix_reuse_hits_and_stream_matches(jax_solo):
    long_prompt, n = PROMPTS[-1], NEWS[-1]
    with _engine() as eng:
        first = eng.infer(long_prompt, max_new_tokens=n).tolist()
        again = eng.infer(long_prompt, max_new_tokens=n).tolist()
        stats = eng.pool.prefix_stats()
        eng.pool.check_isolated()
    assert stats["hits"] >= 1 and stats["tokens_reused"] >= 8
    assert first == again == jax_solo[-1]


def test_exhausted_pool_defers_not_fails(jax_solo):
    # worst case per request: pages_for(5 + 6) = 2 pages; 4 pages in
    # all, so at most 2 sequences live at once
    with _engine(n_pages=4) as eng:
        futs = [eng.submit(PROMPTS[1], max_new_tokens=6)
                for _ in range(6)]
        outs = [f.result(timeout=120).tolist() for f in futs]
        assert eng.stats.count("completed") == 6
        assert eng.pool.occupancy()["pages_used"] == 0
    assert len({tuple(o) for o in outs}) == 1
    assert outs[0][:NEWS[1]] == jax_solo[1]


def test_static_cohort_mode(jax_solo):
    with _engine(iteration_level=False) as eng:
        futs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, NEWS)]
        outs = [f.result(timeout=120).tolist() for f in futs]
        snap = eng.snapshot()
    assert snap["iteration_level"] is False
    assert snap["counters"]["completed"] == len(PROMPTS)
    assert outs == jax_solo


def test_eos_and_max_tokens_leave(jax_solo):
    full = jax_solo[0]
    with _engine(eos_id=full[2]) as eng:
        out = eng.infer(PROMPTS[0], max_new_tokens=NEWS[0]).tolist()
        one = eng.infer([1, 2, 3], max_new_tokens=1)
        assert eng.costs.totals()["requests"] == 2
    assert out == full[:3]
    assert len(one) == 1


def test_seeded_sampling_replays_identically():
    kw = dict(temperature=0.9, top_p=0.9, seed=1234)
    with _engine() as eng:
        a = eng.infer(PROMPTS[1], max_new_tokens=8, **kw).tolist()
        # the same request beside a greedy neighbour
        f1 = eng.submit(PROMPTS[1], max_new_tokens=8, **kw)
        f2 = eng.submit(PROMPTS[4], max_new_tokens=8)
        b, _ = f1.result(timeout=60).tolist(), f2.result(timeout=60)
    assert a == b


def test_submit_refusals_are_typed():
    with _engine() as eng:
        with pytest.raises(InvalidSamplingError):
            eng.submit([1, 2], top_p=0.0)
        with pytest.raises(RequestTooLongError):
            eng.submit(list(range(1, 18)))
        with pytest.raises(UnknownModelError):
            eng.submit([1, 2], model_id="other")
    with pytest.raises(EngineStoppedError):
        eng.submit([1, 2])
    snap = eng.snapshot()
    assert snap["counters"]["rejected_too_long"] == 1
    assert snap["device"] == "cpu"


def test_snapshot_and_costs_surface():
    with _engine() as eng:
        eng.warmup()
        warm = eng.cost_table()["totals"]["compile_s"]
        eng.infer(PROMPTS[0], max_new_tokens=4)
        snap = eng.snapshot()
        costs = eng.cost_table()
        state = eng.scheduler_state()
    assert snap["decode"]["tokens"] == 4
    assert snap["decode"]["ttft"]["count"] == 1
    assert snap["kv"]["pages_total"] == ENGINE["n_pages"]
    assert costs["totals"]["requests"] == 1
    # the warm-up's step shapes are its captures (compiles); the request
    # after it captures nothing
    assert costs["totals"]["compile_s"] == warm > 0.0
    assert state["active"] == [] and state["prefilling"] == []


def test_stop_abort_fails_streams_loudly():
    """stop(drain=False) ends a live stream with the engine-stopped
    failure after the parts it already received."""
    eng = _engine()
    eng.start()
    fut = eng.submit(PROMPTS[0], max_new_tokens=120, stream=True)
    got = []
    with pytest.raises(EngineStoppedError):
        for part in fut.stream(timeout=30):
            got.append(part)
            if len(got) == 2:
                threading.Thread(target=eng.stop,
                                 kwargs={"drain": False},
                                 name="pt_abort", daemon=True).start()
    assert len(got) >= 2
    assert eng.pool.occupancy()["pages_used"] == 0


def test_stopped_engine_is_collected():
    """``stop()`` unregisters every scrape-time function the engine set
    (queue depth, the prefill/decode split, the WFQ depth of each tenant
    class): a stopped and dropped engine is collected with its pool,
    and ``reset_stats`` after ``stop`` registers nothing that holds
    it."""
    import gc
    import weakref

    eng = _engine()
    eng.start()
    assert len(eng.infer([1, 2, 3], max_new_tokens=2).tolist()) == 2
    eng.stop(timeout=30)
    eng.reset_stats()
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
