"""The PyTorch port's PagedCausalLM against the JAX package's.

Same weights (taken over with ``from_jax_params``, and made by the
port's own seeded init, which must give the same arrays), same
numpy-seeded inputs, on the CPU. Logits are compared with ``atol=1e-4``
(float32 across 2 layers, matrix products summed in another order),
cache contents with ``atol=1e-5``, and greedy tokens must be identical.
The JAX steps sample inside ``jit``; to read their logits the tests swap
the module's ``_sample_row`` for one that returns the logits' bits.

Seeded sampling is NOT compared bit for bit with JAX: ``jax.random`` and
``torch.Generator`` give different numbers from the same seed. The tests
hold the port to the properties instead: the draw depends only on
(seed, position), ``top_k=1`` is greedy, and the kept set follows
``_sample_row``'s rule, re-derived in numpy.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
from mxnet_tpu_torch.serving import PagedCausalLM, PagedKVPool
from mxnet_tpu_torch.serving import decode_model as tdm

torch.set_num_threads(1)

GEOM = dict(vocab=64, units=32, layers=2, heads=4, max_len=128, seed=7)
PS, NP = 8, 24


def _jax_model(monkeypatch=None):
    """A fresh JAX model; with ``monkeypatch`` its steps return logit
    bits instead of sampled tokens."""
    if monkeypatch is not None:
        import jax
        import jax.numpy as jnp
        import mxnet_tpu.serving.decode_model as jdm

        monkeypatch.setattr(
            jdm, "_sample_row", lambda logits, *a: jax.lax.
            bitcast_convert_type(logits.astype(jnp.float32), jnp.int32))
    from mxnet_tpu.serving import PagedCausalLM as JaxLM

    return JaxLM(**GEOM)


def _logits(bits):
    return np.asarray(bits).astype(np.int32).view(np.float32)


def _torch_model(jm=None):
    if jm is None:
        return PagedCausalLM(device="cpu", **GEOM)
    return PagedCausalLM.from_jax_params(
        {k: np.asarray(v) for k, v in jm.params.items()},
        heads=GEOM["heads"], device="cpu")


def _caches():
    """Zeroed JAX caches and torch caches of one geometry."""
    import jax.numpy as jnp

    shape = (NP + 1, GEOM["heads"], PS, GEOM["units"] // GEOM["heads"])
    return (tuple(jnp.zeros(shape, jnp.float32) for _ in range(4)),
            tuple(torch.zeros(shape) for _ in range(4)))


def _assert_caches(jc, tc, atol=1e-5):
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol)


def _torch_logit_steps(monkeypatch):
    monkeypatch.setattr(tdm, "_sample_row", lambda logits, *a: logits)


def test_seeded_init_equals_jax_weights():
    jm = _jax_model()
    a, b = _torch_model(jm), _torch_model()
    assert set(a.params) == set(jm.params) == set(b.params)
    for k in jm.params:
        np.testing.assert_array_equal(a.params[k].numpy(),
                                      np.asarray(jm.params[k]))
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.spec == jm.spec == b.spec


def test_prefill_matches_jax(monkeypatch):
    jm = _jax_model(monkeypatch)
    tm = _torch_model(jm)
    _torch_logit_steps(monkeypatch)
    rng = np.random.RandomState(0)
    ids = np.zeros(16, np.int32)
    ids[:11] = rng.randint(0, 64, 11)
    pages = np.asarray([3, 9], np.int32)
    pos = np.arange(16)
    phys = np.where(pos < 11, pages[np.minimum(pos // PS, 1)],
                    NP).astype(np.int32)
    off = (pos % PS).astype(np.int32)
    jc, tc = _caches()
    jl, jc = jm.prefill(jc, ids, 11, phys, off)
    tl, tc = tm.prefill(tc, ids, 11, phys, off)
    np.testing.assert_allclose(tl.numpy(), _logits(jl), atol=1e-4)
    _assert_caches(jc, tc)


def test_prefill_chunks_match_jax(monkeypatch):
    """Two chunks of one prompt through the paged path (front-aligned
    ids, padded table), as the engine's chunk scheduler cuts them."""
    jm = _jax_model(monkeypatch)
    tm = _torch_model(jm)
    _torch_logit_steps(monkeypatch)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 64, 13).astype(np.int32)
    table = np.full(4, NP, np.int32)
    table[:2] = [5, 2]
    jc, tc = _caches()
    for start, take in ((0, 8), (8, 5)):
        ids = np.zeros(8, np.int32)
        ids[:take] = prompt[start:start + take]
        jl, jc = jm.prefill_chunk(jc, ids, start, take, table)
        tl, tc = tm.prefill_chunk(tc, ids, start, take, table)
        np.testing.assert_allclose(tl.numpy(), _logits(jl), atol=1e-4)
        _assert_caches(jc, tc)


def test_decode_step_matches_jax(monkeypatch):
    jm = _jax_model(monkeypatch)
    tm = _torch_model(jm)
    rng = np.random.RandomState(2)
    jc, tc = _caches()
    # two rows with histories written by the dense prefill
    tables = np.asarray([[1, 4, NP], [7, NP, NP], [NP, NP, NP]], np.int32)
    lens = (11, 5)
    for r, n in enumerate(lens):
        ids = np.zeros(16, np.int32)
        ids[:n] = rng.randint(0, 64, n)
        pos = np.arange(16)
        phys = np.where(pos < n, tables[r][np.minimum(pos // PS, 2)],
                        NP).astype(np.int32)
        off = (pos % PS).astype(np.int32)
        _, jc = jm.prefill(jc, ids, n, phys, off)
        _, tc = tm.prefill(tc, ids, n, phys, off)
    ids = np.asarray([3, 60, 0], np.int32)
    positions = np.asarray([11, 5, 0], np.int32)   # row 3 is padding
    jl, jc = jm.decode_step(jc, ids, positions, tables)
    tl, tc = tm.decode_logits(tc, ids, positions, tables)
    np.testing.assert_allclose(tl.numpy(), _logits(jl), atol=1e-4)
    _assert_caches(jc, tc)


def test_greedy_tokens_identical_over_16_steps():
    jm = _jax_model()
    tm = _torch_model(jm)
    rng = np.random.RandomState(3)
    jc, tc = _caches()
    tables = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    toks = []
    for r, n in enumerate((6, 9)):
        ids = np.zeros(16, np.int32)
        ids[:n] = rng.randint(0, 64, n)
        pos = np.arange(16)
        phys = np.where(pos < n, tables[r][pos // PS], NP).astype(np.int32)
        off = (pos % PS).astype(np.int32)
        jt, jc = jm.prefill(jc, ids, n, phys, off)
        tt, tc = tm.prefill(tc, ids, n, phys, off)
        assert int(jt) == int(tt)
        toks.append(int(tt))
    positions = np.asarray([6, 9], np.int32)
    j_ids = t_ids = np.asarray(toks, np.int32)
    for _ in range(16):
        j_ids, jc = jm.decode_step(jc, j_ids, positions, tables)
        t_ids, tc = tm.decode_step(tc, t_ids, positions, tables)
        np.testing.assert_array_equal(np.asarray(j_ids), t_ids.numpy())
        j_ids, t_ids = np.asarray(j_ids), t_ids.numpy()
        positions = positions + 1


def _np_kept(logits, temp, top_k, top_p):
    """``_sample_row``'s kept set, re-derived in numpy."""
    lg = logits.astype(np.float32) / max(temp, 1e-6)
    order = np.argsort(-lg, kind="stable")
    ranks = np.argsort(order, kind="stable")
    kk = top_k if top_k > 0 else lg.size
    lg = np.where(ranks < kk, lg, -1e30)
    e = np.exp(lg - lg.max())
    probs = e / e.sum()
    sp = probs[order]
    keep = max(int(np.sum((np.cumsum(sp) - sp) < top_p)), 1)
    return ranks < keep


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.5), (0.5, 10, 0.9),
    (2.0, 1, 0.3), (1.0, 0, 1e-4)])
def test_kept_set_matches_numpy_rule(temp, top_k, top_p):
    rng = np.random.RandomState(4)
    logits = rng.randn(64).astype(np.float32) * 3
    got = tdm._filter_logits(torch.from_numpy(logits), temp, top_k, top_p)
    kept = (got > -1e29).numpy()
    np.testing.assert_array_equal(kept, _np_kept(logits, temp, top_k,
                                                 top_p))
    assert kept[np.argmax(logits)]      # the best token always survives


def test_seeded_draw_depends_only_on_seed_and_position():
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(64).astype(np.float32))
    draws = [int(tdm._sample_row(logits, 1.0, 0, 1.0, 11, 7))
             for _ in range(3)]
    assert len(set(draws)) == 1
    # different positions (or seeds) draw independently
    many = {int(tdm._sample_row(logits, 5.0, 0, 1.0, 11, p))
            for p in range(40)}
    assert len(many) > 1
    # top_k=1 is greedy, whatever the seed
    for s in range(5):
        assert int(tdm._sample_row(logits, 1.0, 1, 1.0, s, 3)) \
            == int(torch.argmax(logits))
    assert int(tdm._sample_row(logits, 0.0, 0, 1.0, 9, 3)) \
        == int(torch.argmax(logits))


def test_sampled_row_independent_of_batch_composition():
    """A sampled row draws the same token alone and beside others."""
    tm = _torch_model()
    pool = PagedKVPool(2, 4, 8, page_size=PS, n_pages=NP, device="cpu",
                       engine_id="pt_batch")
    for owner, n in (("a", 5), ("b", 9)):
        pool.ensure(owner, n + 1)
        phys, off = pool.scatter_indices(owner, n, 16)
        _, caches = tm.prefill(pool.caches, np.arange(16) % 64, n, phys,
                               off)
        pool.swap(caches)
    snapshot = [c.clone() for c in pool.caches]
    both = pool.padded_tables(["a", "b"], 2)
    toks_ab, _ = tm.decode_step(pool.caches, [1, 2], [5, 9], both,
                                temperatures=[0.9, 0.0],
                                top_ks=[0, 0], top_ps=[0.95, 1.0],
                                seeds=[42, 0])
    for c, s in zip(pool.caches, snapshot):
        c.copy_(s)
    alone, _ = tm.decode_step(pool.caches, [1], [5],
                              pool.padded_tables(["a"], 2),
                              temperatures=[0.9], top_ks=[0],
                              top_ps=[0.95], seeds=[42])
    assert int(alone[0]) == int(toks_ab[0])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedCausalLM(**GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVPool(2, 4, 8, page_size=PS, n_pages=4)
