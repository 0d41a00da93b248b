"""The PyTorch port's paged attention against the JAX package's.

The same numpy inputs go through the JAX Pallas kernel (interpret
mode, as tests/test_decode.py runs it on the CPU), the JAX dense
reference, and the port's wrapper on CPU tensors (which takes its
plain version). float32 tolerance 1e-5: the same math, summed in a
different order. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda_kernels.py and
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)


def _case(seed, sq, kvls, p=10, h=4, psize=8, d=16, npg=3):
    rng = np.random.RandomState(seed)
    b = len(kvls)
    k = rng.randn(p, h, psize, d).astype(np.float32)
    v = rng.randn(p, h, psize, d).astype(np.float32)
    # non-contiguous PHYSICAL pages; slots past a row's pages are
    # arbitrary in-range ids (the chunk path's padding)
    table = rng.permutation(p)[:b * npg].reshape(b, npg).astype(np.int32)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, table, np.asarray(kvls, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [
    (1, (5, 17, 24)),          # steady-state decode, ragged lengths
    (1, (0, 1, 9)),            # a kv_len 0 row and a 1-token history
    (4, (9, 20, 4)),           # chunked prefill, causal within chunk
    (8, (8, 24, 16)),          # chunk spanning whole pages
    (8, (3, 12, 24)),          # chunk rows before the history starts
    (16, (24, 17, 20)),        # chunk longer than a page
]


@pytest.mark.parametrize("sq,kvls", CASES)
def test_plain_matches_jax_interpret_kernel(monkeypatch, sq, kvls):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.flash_attention import (
        paged_attention_reference, paged_flash_attention)

    q, k, v, table, kvl = _case(0, sq, kvls)
    want = np.asarray(paged_flash_attention(q, k, v, table, kvl,
                                            interpret=True))
    want_ref = np.asarray(paged_attention_reference(q, k, v, table, kvl))
    got = pa.paged_flash_attention(*_torch(q, k, v, table, kvl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sq,kvls", CASES)
def test_plain_matches_numpy_softmax(sq, kvls):
    """Against a from-scratch dense softmax over the gathered, causally
    masked history (independent of both packages' helpers)."""
    q, k, v, table, kvl = _case(1, sq, kvls)
    got = pa.paged_attention_reference(*_torch(q, k, v, table, kvl))
    got = got.numpy()
    d = q.shape[-1]
    for r in range(q.shape[0]):
        hist = np.concatenate([k[p] for p in table[r]], axis=1)
        vhist = np.concatenate([v[p] for p in table[r]], axis=1)
        for qi in range(sq):
            limit = kvl[r] - sq + qi + 1
            if limit <= 0:
                assert np.all(got[r, :, qi] == 0.0)
                continue
            s = np.einsum("hd,hkd->hk", q[r, :, qi] / np.sqrt(d),
                          hist[:, :limit])
            w = np.exp(s - s.max(-1, keepdims=True))
            w /= w.sum(-1, keepdims=True)
            o = np.einsum("hk,hkd->hd", w, vhist[:, :limit])
            np.testing.assert_allclose(got[r, :, qi], o, atol=1e-5,
                                       rtol=1e-5)


def test_zero_rows_and_table_padding():
    """kv_len 0 rows are exact zeros; table slots past a row's pages
    never contribute (widening the table changes nothing beyond the
    order of the plain version's sums)."""
    rng = np.random.RandomState(2)
    p, h, psize, d = 6, 2, 8, 16
    k = rng.randn(p, h, psize, d).astype(np.float32)
    v = rng.randn(p, h, psize, d).astype(np.float32)
    q = rng.randn(2, h, 1, d).astype(np.float32)
    kvl = np.asarray([0, 5], np.int32)
    narrow = np.asarray([[1, 0], [2, 0]], np.int32)
    wide = np.asarray([[1, 3, 4, 5], [2, 3, 4, 5]], np.int32)
    o1 = pa.paged_flash_attention(*_torch(q, k, v, narrow, kvl))
    o2 = pa.paged_flash_attention(*_torch(q, k, v, wide, kvl))
    assert torch.all(o1[0] == 0.0) and torch.all(o2[0] == 0.0)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_bf16_plain_matches_jax_reference():
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas.flash_attention import \
        paged_attention_reference

    q, k, v, table, kvl = _case(3, 4, (9, 20, 4))
    want = np.asarray(paged_attention_reference(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), table, kvl).astype(jnp.float32))
    tq, tk, tv, tt, tl = _torch(q, k, v, table, kvl)
    got = pa.paged_attention_reference(
        tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tt, tl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v, table, kvl = _case(4, 1, (5, 17, 24))
    before = launch_counts()["paged_attention"]
    args = _torch(q, k, v, table, kvl)
    assert torch.equal(pa.paged_flash_attention(*args),
                       pa.paged_attention_reference(*args))
    assert launch_counts()["paged_attention"] == before


@pytest.mark.parametrize("mutate,err", [
    (lambda a: a.update(k=a["k"][:, :2].contiguous()), ValueError),
    (lambda a: a.update(table=a["table"][:2]), ValueError),
    (lambda a: a.update(kvl=a["kvl"][:2]), ValueError),
    (lambda a: a.update(table=a["table"].long()), TypeError),
    (lambda a: a.update(q=a["q"].double(), k=a["k"].double(),
                        v=a["v"].double()), TypeError),
    (lambda a: a.update(k=a["k"].bfloat16()), TypeError),
    (lambda a: a.update(q=a["q"].transpose(2, 3)), ValueError),
    # any head dim, but the pool's must be q's
    (lambda a: a.update(k=a["k"].new_zeros(*a["k"].shape[:3], 264),
                        v=a["v"].new_zeros(*a["v"].shape[:3], 264)),
     ValueError),
])
def test_kernel_refuses_what_it_cannot_take(mutate, err):
    q, k, v, table, kvl = _torch(*_case(5, 4, (9, 20, 4)))
    args = {"q": q, "k": k, "v": v, "table": table, "kvl": kvl}
    mutate(args)
    with pytest.raises(err):
        pa._check(args["q"], args["k"], args["v"], args["table"],
                  args["kvl"])


def test_kernel_accepts_the_slice_shapes():
    q, k, v, table, kvl = _torch(*_case(6, 1, (5, 17, 24), d=64))
    pa._check(q, k, v, table, kvl)
    pa._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), table, kvl)


@pytest.mark.parametrize("d", [1, 24, 80, 256])
def test_kernel_accepts_any_head_dim_to_256(d):
    q, k, v, table, kvl = _torch(*_case(6, 1, (5, 17, 24), d=d))
    pa._check(q, k, v, table, kvl)
    pa._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), table, kvl)


@pytest.mark.parametrize("d", [264, 320, 512])
def test_kernel_accepts_head_dims_past_256(d):
    q, k, v, table, kvl = _torch(*_case(6, 1, (5, 17, 24), d=d))
    pa._check(q, k, v, table, kvl)
    pa._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), table, kvl)


@pytest.mark.parametrize("sq,d", [(1, 264), (4, 320)])
def test_plain_matches_jax_interpret_kernel_past_256(monkeypatch, sq, d):
    """Head dims past 256 (the kernel's output in chunks of 256 dims):
    decode and a 4-query chunk against the JAX kernel in interpret
    mode."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.flash_attention import paged_flash_attention

    q, k, v, table, kvl = _case(9, sq, (9, 20, 0), h=2, d=d)
    want = np.asarray(paged_flash_attention(q, k, v, table, kvl,
                                            interpret=True))
    got = pa.paged_flash_attention(*_torch(q, k, v, table, kvl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("sq,d", [(1, 80), (1, 96), (4, 256)])
def test_plain_matches_jax_reference_wide_heads_long_history(sq, d):
    """Head dims the kernel now takes beside the old ones, over
    histories of several hundred tokens (many pages, several of the
    kernel's 64-key chunks), against the JAX package's reference."""
    from mxnet_tpu.ops.pallas.flash_attention import \
        paged_attention_reference

    kvls = (300, 517, 0, 64)
    q, k, v, table, kvl = _case(7, sq, kvls, p=4 * 34 + 1, h=2, psize=16,
                                d=d, npg=34)
    want = np.asarray(paged_attention_reference(q, k, v, table, kvl))
    got = pa.paged_flash_attention(*_torch(q, k, v, table, kvl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0.0)


def test_plain_matches_jax_interpret_kernel_at_head_dim_80(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.flash_attention import paged_flash_attention

    q, k, v, table, kvl = _case(8, 4, (9, 20, 4), h=2, d=80)
    want = np.asarray(paged_flash_attention(q, k, v, table, kvl,
                                            interpret=True))
    got = pa.paged_flash_attention(*_torch(q, k, v, table, kvl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
