"""The PyTorch port's PagedKVPool against the JAX package's.

The same call sequence runs on both pools; the host bookkeeping (tables,
occupancy, prefix index, refcounts, scatter coordinates, padded tables,
the isolation check) must agree exactly, and page contents must agree
exactly after copy-on-write copies.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
from mxnet_tpu_torch.serving import KVPagesExhaustedError, PagedKVPool

torch.set_num_threads(1)

_GEOM = dict(page_size=8, n_pages=12, prefix_pages=8)


def _pools(tag, **kw):
    from mxnet_tpu.serving import PagedKVPool as JaxPool

    args = dict(_GEOM, **kw)
    return (JaxPool(2, 4, 16, engine_id=f"jx_{tag}", **args),
            PagedKVPool(2, 4, 16, engine_id=f"pt_{tag}", device="cpu",
                        **args))


def _same_state(jp, tp, owners):
    for o in owners:
        assert jp.table(o) == tp.table(o), o
    assert jp.occupancy() == tp.occupancy()
    assert jp.prefix_stats() == tp.prefix_stats()
    assert jp.page_refcounts() == tp.page_refcounts()
    assert jp.check_isolated() and tp.check_isolated()


def _both(jp, tp, method, *args):
    """Call ``method`` on both pools; results (or raised types) agree."""
    outs = []
    for pool in (jp, tp):
        try:
            outs.append(("ok", getattr(pool, method)(*args)))
        except Exception as e:      # compared, never swallowed silently
            outs.append(("raised", type(e).__name__))
    a, b = outs
    if a[0] == "ok" and isinstance(a[1], tuple) \
            and any(isinstance(x, np.ndarray) for x in a[1]):
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)
    else:
        assert a == b, (method, a, b)
    return b[1]


def test_alloc_free_occupancy_match():
    jp, tp = _pools("alloc")
    assert tp.pages_for(1) == 1 and tp.pages_for(8) == 1
    assert tp.pages_for(9) == 2
    _both(jp, tp, "ensure", "a", 20)
    _both(jp, tp, "ensure", "b", 8)
    _both(jp, tp, "ensure", "a", 24)          # no growth
    _same_state(jp, tp, ["a", "b"])
    assert tp.owner_of(tp.table("a")[0]) == "a"
    _both(jp, tp, "release", "a")
    _both(jp, tp, "release", "a")             # idempotent
    _both(jp, tp, "ensure", "c", 16)          # LIFO reuse of a's pages
    _same_state(jp, tp, ["a", "b", "c"])
    assert tp.table("c") == jp.table("c")


def test_exhaustion_is_atomic_and_matches():
    jp, tp = _pools("exhaust", n_pages=4)
    _both(jp, tp, "ensure", "a", 24)          # 3 of 4 pages
    assert _both(jp, tp, "ensure", "b", 20) == "KVPagesExhaustedError"
    assert tp.table("b") == [] and tp.occupancy()["pages_free"] == 1
    with pytest.raises(KVPagesExhaustedError):
        tp.ensure("b", 20)
    _same_state(jp, tp, ["a", "b"])


def test_scatter_indices_and_padded_tables_match():
    jp, tp = _pools("scatter")
    _both(jp, tp, "ensure", "a", 20)
    _both(jp, tp, "ensure", "b", 5)
    _both(jp, tp, "scatter_indices", "a", 20, 32)
    _both(jp, tp, "scatter_indices", "a", 7, 8, 13)   # a chunk slice
    phys, off = tp.scatter_indices("a", 20, 32)
    assert np.all(phys[20:] == tp.scratch_page)
    for owners, width in ((["a", "b"], 4), (["b", "__pad__"], 2)):
        np.testing.assert_array_equal(jp.padded_tables(owners, width),
                                      tp.padded_tables(owners, width))
    assert _both(jp, tp, "scatter_indices", "b", 9) == "ValueError"
    assert _both(jp, tp, "padded_tables", ["a"], 2) == "ValueError"


def test_prefix_match_cow_and_page_contents_match():
    """A registered prompt's full pages are shared read-only by a
    same-prefix prompt, a mid-page divergence is copied on write, and
    the copied page contents agree across packages."""
    import jax.numpy as jnp

    jp, tp = _pools("prefix")
    rng = np.random.RandomState(0)
    data = [rng.randn(*tp.caches[0].shape).astype(np.float32)
            for _ in tp.caches]
    jp.swap(tuple(jnp.asarray(d) for d in data))
    for c, d in zip(tp.caches, data):
        c.copy_(torch.from_numpy(d))
    prompt = np.arange(1, 21, dtype=np.int32)          # 2.5 pages
    assert _both(jp, tp, "match_prefix", "x", prompt) == (0, [])
    _both(jp, tp, "ensure", "x", 20)
    _both(jp, tp, "register_prefix", "x", prompt)
    # same first page and a half, then diverges mid-page two
    other = np.concatenate([prompt[:12], np.int32([90, 91, 92, 93, 94])])
    matched, copies = _both(jp, tp, "match_prefix", "y", other)
    assert matched == 12 and len(copies) == 1
    _same_state(jp, tp, ["x", "y"])
    jp.copy_pages(copies)
    tp.copy_pages(copies)
    for jc, tc in zip(jp.caches, tp.caches):
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    src, dst = copies[0]
    assert torch.equal(tp.caches[0][dst], tp.caches[0][src])
    # a prompt ending inside the second indexed page: one page shared,
    # the tail COW-attached (its last token is always left to prefill)
    _both(jp, tp, "release", "x")
    _both(jp, tp, "ensure", "z", 17)
    matched, copies = _both(jp, tp, "match_prefix", "w", prompt[:16])
    assert matched == 15 and len(copies) == 1
    _both(jp, tp, "ensure", "w", 17)
    # writing into the shared, index-pinned first page copies it first
    cow = _both(jp, tp, "prepare_write", "w", 0)
    assert cow is not None and cow[0] != cow[1]
    _same_state(jp, tp, ["x", "y", "z", "w"])
    for owner in ("y", "z", "w"):
        _both(jp, tp, "release", owner)
    _same_state(jp, tp, ["y", "z", "w"])
    assert tp.occupancy()["pages_used"] == 0


def test_lru_eviction_matches():
    jp, tp = _pools("lru", prefix_pages=2)
    for i in range(3):
        toks = np.arange(16, dtype=np.int32) + 100 * i
        _both(jp, tp, "match_prefix", f"s{i}", toks)
        _both(jp, tp, "ensure", f"s{i}", 16)
        _both(jp, tp, "register_prefix", f"s{i}", toks)
        _both(jp, tp, "release", f"s{i}")
    _same_state(jp, tp, [])
    assert tp.prefix_stats()["evictions"] >= 2


def test_caches_are_zeroed_torch_tensors_on_the_device():
    tp = PagedKVPool(2, 4, 16, page_size=8, n_pages=6, device="cpu",
                     engine_id="pt_zero")
    assert len(tp.caches) == 4
    for c in tp.caches:
        assert isinstance(c, torch.Tensor)
        assert c.shape == (7, 4, 8, 16) and c.device.type == "cpu"
        assert c.dtype == torch.float32 and not c.any()
    assert tp.bytes_total == 4 * 7 * 4 * 8 * 16 * 4
    with pytest.raises(ValueError):
        tp.swap(tp.caches[:2])
