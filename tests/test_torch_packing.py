"""The PyTorch port's sequence packing and continuous batcher against
the JAX package's: on random request mixes, ``pack_sequences`` and
``ContinuousBatcher.plan`` give identical arrays, placements and
leftovers (both are numpy; the port keeps its own copy)."""
import numpy as np
import pytest

from mxnet_tpu.io import packing as jax_packing
from mxnet_tpu.serving import batcher as jax_batcher
from mxnet_tpu.serving.queue import Request as JaxRequest
from mxnet_tpu_torch.io import packing
from mxnet_tpu_torch.serving import batcher
from mxnet_tpu_torch.serving.queue import Request


def _mix(seed, n, hi):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(1, 500, rng.randint(1, hi + 1)).astype(np.int32)
            for _ in range(n)]
    tts = [(rng.rand(len(s)) < 0.5).astype(np.int32) for s in seqs]
    return seqs, tts


def _same_batch(a, b):
    for name in ("data", "segment_ids", "positions", "valid_length"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert [tuple(p) for p in a.placements] == \
        [tuple(p) for p in b.placements]
    assert len(a.extras) == len(b.extras)
    for x, y in zip(a.extras, b.extras):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed,n,hi,seq_len", [(0, 30, 40, 64),
                                               (1, 12, 64, 64),
                                               (2, 50, 7, 16),
                                               (3, 1, 9, 9)])
def test_pack_sequences_matches_jax(seed, n, hi, seq_len):
    seqs, tts = _mix(seed, n, hi)
    kw = dict(extras=[tts], pad_value=7, dtype=np.int32)
    got = packing.pack_sequences(seqs, seq_len, **kw)
    want = jax_packing.pack_sequences(seqs, seq_len, **kw)
    _same_batch(got, want)
    assert packing.packing_efficiency(got) == \
        jax_packing.packing_efficiency(want)
    for x, y in zip(packing.unpack_sequences(got.data, got.placements),
                    jax_packing.unpack_sequences(want.data,
                                                 want.placements)):
        assert np.array_equal(x, y)


def test_pack_sequences_refuses_like_jax():
    for bad in ([np.zeros(0, np.int32)], [np.ones(9, np.int32)]):
        with pytest.raises(ValueError):
            jax_packing.pack_sequences(bad, 8)
        with pytest.raises(ValueError):
            packing.pack_sequences(bad, 8)
    seqs = [np.ones(6, np.int32)] * 3
    with pytest.raises(ValueError):
        jax_packing.pack_sequences(seqs, 8, max_rows=2)
    with pytest.raises(ValueError):
        packing.pack_sequences(seqs, 8, max_rows=2)


@pytest.mark.parametrize("seed,n,hi,buckets,max_rows", [
    (0, 40, 60, (16, 64), 4),
    (1, 9, 300, (64, 256, 512), 8),
    (2, 70, 12, (8, 16), 2),
    (3, 5, 20, (32,), 8),
    (4, 24, 100, (64, 128), 3),          # max_rows not a power of two
])
def test_batcher_plan_matches_jax(seed, n, hi, buckets, max_rows):
    seqs, tts = _mix(seed, n, hi)
    with_tt = [tt if i % 2 else None for i, tt in enumerate(tts)]
    mine = batcher.ContinuousBatcher(bucket_lens=buckets, max_rows=max_rows)
    ref = jax_batcher.ContinuousBatcher(bucket_lens=buckets,
                                        max_rows=max_rows)
    assert mine.shape_universe() == ref.shape_universe()
    reqs = [Request(s, t) for s, t in zip(seqs, with_tt)]
    jreqs = [JaxRequest(s, t) for s, t in zip(seqs, with_tt)]
    while reqs:
        plan, left = mine.plan(reqs)
        jplan, jleft = ref.plan(jreqs)
        for name in ("data", "token_types", "segment_ids", "positions",
                     "valid_length"):
            x, y = getattr(plan, name), getattr(jplan, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert (plan.rows, plan.row_len, plan.valid_tokens,
                plan.pad_rows) == (jplan.rows, jplan.row_len,
                                   jplan.valid_tokens, jplan.pad_rows)
        assert plan.packing_efficiency == jplan.packing_efficiency
        assert [(reqs.index(r), tuple(p)) for r, p in plan.entries] == \
            [(jreqs.index(r), tuple(p)) for r, p in jplan.entries]
        assert [reqs.index(r) for r in left] == \
            [jreqs.index(r) for r in jleft]
        # every padding row holds one 1-token segment of valid length 1
        used = plan.rows - plan.pad_rows
        assert np.all(plan.segment_ids[used:, 0] == 1)
        assert np.all(plan.valid_length[used:] == 1)
        reqs = [r for r in reqs if r in left]
        jreqs = [r for r in jreqs if r in jleft]
    assert not jreqs


def test_batcher_unquantized_rows_match_jax():
    mine = batcher.ContinuousBatcher((16,), max_rows=5, quantize_rows=False)
    ref = jax_batcher.ContinuousBatcher((16,), max_rows=5,
                                        quantize_rows=False)
    assert mine.shape_universe() == ref.shape_universe()
    seqs, _ = _mix(5, 7, 15)
    plan, _ = mine.plan([Request(s) for s in seqs])
    jplan, _ = ref.plan([JaxRequest(s) for s in seqs])
    assert np.array_equal(plan.data, jplan.data) and plan.pad_rows == 0
