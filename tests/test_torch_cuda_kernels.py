"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import layer_norm as ln
from mxnet_tpu_torch.ops import lstm
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import softmax_xent as sx

CASES = [
    (1, (5, 17, 24)),          # steady-state decode, ragged lengths
    (1, (0, 1, 9)),            # a kv_len 0 row and a 1-token history
    (4, (9, 20, 4)),           # chunked prefill, causal within chunk
    (8, (3, 12, 24)),          # chunk rows before the history starts
    (20, (24, 21, 20)),        # two query tiles, the second ragged
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, sq, kvls, d, dev, dtype, p=10, h=4, psize=8, npg=3):
    rng = np.random.RandomState(seed)
    b = len(kvls)
    k = rng.randn(p, h, psize, d).astype(np.float32)
    v = rng.randn(p, h, psize, d).astype(np.float32)
    table = rng.permutation(p)[:b * npg].reshape(b, npg).astype(np.int32)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    f = [torch.tensor(x, dtype=dtype, device=dev) for x in (q, k, v)]
    i = [torch.tensor(x, dtype=torch.int32, device=dev)
         for x in (table, np.asarray(kvls, np.int32))]
    return f + i


@pytest.mark.cuda
@pytest.mark.parametrize("sq,kvls", CASES)
# d = 20 in bf16: rows of 40 bytes, read element by element
@pytest.mark.parametrize("d", [8, 16, 20, 24, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_matches_plain(cuda, sq, kvls, d, dtype,
                                              tol):
    args = _case(0, sq, kvls, d, cuda, dtype)
    before = launch_counts()["paged_attention"]
    got = pa.paged_flash_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for r, n in enumerate(kvls):
        if n == 0:
            assert got[r].abs().max().item() == 0.0


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_bad_operands(cuda):
    q, k, v, table, kvl = _case(1, 1, (5, 17, 24), 16, cuda,
                                torch.float32)
    with pytest.raises(TypeError):
        pa.paged_flash_attention(q, k, v, table.long(), kvl)
    with pytest.raises(ValueError):
        pa.paged_flash_attention(q, k.cpu(), v, table, kvl)
    # any head dim runs; a pool whose head dim is not q's does not
    q, k, v, table, kvl = _case(1, 1, (5, 17, 24), 264, cuda,
                                torch.float32)
    with pytest.raises(ValueError, match="page pool shape"):
        pa.paged_flash_attention(q, k[..., :256].contiguous(),
                                 v[..., :256].contiguous(), table, kvl)
    with pytest.raises(TypeError):
        pa.paged_flash_attention(q.half(), k.half(), v.half(), table, kvl)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,kvls", CASES)
@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_past_256(cuda, sq, kvls, d, dtype, tol):
    """Head dims past 256: the output in chunks of 256 dims, one block
    each, the scores over the whole head dim; the same bits on a second
    call."""
    args = _case(3, sq, kvls, d, cuda, dtype)
    before = launch_counts()["paged_attention"]
    got = pa.paged_flash_attention(*args)
    again = pa.paged_flash_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 2
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)
    for r, n in enumerate(kvls):
        if n == 0:
            assert got[r].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 64])
def test_paged_attention_past_256_across_chunks(cuda, sq):
    """Histories of several 64-key chunks at head dim 320: each output
    chunk's partials and tickets are its own."""
    args = _pool_case(12, sq, (70, 1024, 3000, 333), 16, cuda,
                      torch.float32, d=320)
    got = pa.paged_flash_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    for _ in range(2):
        assert torch.equal(pa.paged_flash_attention(*args), got)


def _pool_case(seed, sq, kvls, psize, dev, dtype, d=64, h=2, spare=1):
    """A pool holding every row's history on permuted pages, each row's
    table ``spare`` pages wider than its longest history needs (the
    spare slots point at other rows' pages)."""
    rng = np.random.RandomState(seed)
    b = len(kvls)
    width = -(-max(kvls) // psize) + spare
    p = b * width + 1
    k = rng.randn(p, h, psize, d).astype(np.float32)
    v = rng.randn(p, h, psize, d).astype(np.float32)
    table = rng.permutation(p)[:b * width].reshape(b, width)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    f = [torch.tensor(x, dtype=dtype, device=dev) for x in (q, k, v)]
    i = [torch.tensor(x, dtype=torch.int32, device=dev)
         for x in (table.astype(np.int32), np.asarray(kvls, np.int32))]
    return f + i


# histories up to 4096 keys: ending inside a page, on a page's edge, on a
# 64-key chunk's edge, past 32 chunks (128-key chunks); chunk rows before
# the history starts
LONG_CASES = [
    (1, 16, (1, 63, 64, 65, 1000, 1024, 4095, 4096)),
    (1, 8, (8, 200, 2048, 2049)),
    (1, 32, (31, 32, 640, 3000)),
    (4, 16, (4, 64, 67, 4096)),
    (64, 16, (64, 128, 129, 1500)),
    (64, 32, (10, 640, 2111)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,psize,kvls", LONG_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_across_chunks(cuda, sq, psize, kvls, dtype,
                                              tol):
    args = _pool_case(7, sq, kvls, psize, cuda, dtype)
    got = pa.paged_flash_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for r, n in enumerate(kvls):        # chunk rows before the history
        if sq > n:
            assert got[r, :, :sq - n].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_rows_are_independent(cuda, sq, dtype):
    """Each row of a mixed batch has the same bits as the row run alone
    with a table just wide enough for it (another grid, another
    scratch): the property the decode engine's solo parity leans on."""
    kvls = (0, 5, 64, 100, 1024, 2049, 4000, 17)
    psize = 16
    q, k, v, table, kvl = _pool_case(8, sq, kvls, psize, cuda, dtype,
                                     spare=3)
    batch = pa.paged_flash_attention(q, k, v, table, kvl)
    for r, n in enumerate(kvls):
        width = max(1, -(-n // psize))
        alone = pa.paged_flash_attention(
            q[r:r + 1].contiguous(), k, v,
            table[r:r + 1, :width].contiguous(), kvl[r:r + 1].contiguous())
        assert torch.equal(batch[r], alone[0]), (r, n)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 64])
def test_paged_attention_same_bits_every_run(cuda, sq):
    args = _pool_case(9, sq, (70, 1024, 3000, 333), 16, cuda,
                      torch.float32)
    first = pa.paged_flash_attention(*args)
    for _ in range(3):
        assert torch.equal(pa.paged_flash_attention(*args), first)


@pytest.mark.cuda
def test_paged_attention_calls_on_two_streams(cuda):
    """Calls that run at once on two streams of one device, over the
    same (row, head, tile) grid, keep their own ticket counters: each
    gives the bits it gives alone, within 1e-4 of the plain version."""
    kvls = (4000, 3000, 1024, 2049)
    cases = [_pool_case(11 + i, 1, kvls, 16, cuda, torch.float32)
             for i in range(2)]
    alone = [pa.paged_flash_attention(*a) for a in cases]
    want = [pa.paged_attention_reference(*a) for a in cases]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(main)
    got = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(pa.paged_flash_attention(*cases[i]))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    for i in range(2):
        assert (alone[i] - want[i]).abs().max().item() <= 1e-4
        for g in got[i]:
            assert torch.equal(g, alone[i])


@pytest.mark.cuda
def test_split_count_follows_the_table_only(cuda):
    assert pa.split_count(0, 16) == 1
    assert pa.split_count(4, 16) == 1
    assert pa.split_count(5, 16) == 2
    assert pa.split_count(64, 16) == 16
    assert pa.split_count(1024, 16) == 32


@pytest.mark.cuda
def test_paged_attention_kernel_reads_no_padding_slot(cuda):
    """Table slots past a row's pages may hold any id: pointing them at
    pages full of NaN changes nothing."""
    q, k, v, table, kvl = _pool_case(10, 1, (33, 64, 100), 16, cuda,
                                     torch.float32, spare=2)
    want = pa.paged_flash_attention(q, k, v, table, kvl)
    # the one page of the pool no table slot names
    poison = (set(range(k.shape[0])) - set(table.flatten().tolist())).pop()
    k2, v2 = k.clone(), v.clone()
    k2[poison] = float("nan")
    v2[poison] = float("nan")
    table2 = table.clone()
    for r, n in enumerate((33, 64, 100)):
        table2[r, -(-n // 16):] = poison
    got = pa.paged_flash_attention(q, k2, v2, table2, kvl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# -- K1: flash attention forward -------------------------------------------
# Kernel and plain version compute in float32 and round the output to
# its type once, so a 16-bit output may differ by one unit in the last
# place: 2**-7 of the value in bf16, 2**-10 in f16. On top of that an
# absolute float32 term for the different summation order.
ULP_REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}


def _within(got, want, abs_tol, rel_tol=0.0):
    """Every element within one output ulp of the plain version plus
    ``abs_tol + rel_tol * |want|``."""
    bound = want.float().abs() * (ULP_REL[got.dtype] + rel_tol) + abs_tol
    return bool(((got.float() - want.float()).abs() <= bound).all())


def _packed_rows(rng, b, s):
    """Segment ids of first-fit-packed rows with tail padding (id 0),
    and the used length of each row; row 0 is left empty."""
    seg = np.zeros((b, s), np.int32)
    used = np.zeros(b, np.int32)
    for r in range(1, b):
        pos, sid = 0, 1
        while True:
            n = int(rng.randint(1, max(2, s // 3)))
            if pos + n > s - int(rng.randint(0, 8)):
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
        used[r] = pos
    return seg, used


def _flash_case(seed, b, h, sq, skv, d, dev, dtype):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rng.randn(b, h, n, d).astype(np.float32),
                            dtype=dtype, device=dev)
               for n in (sq, skv, skv))
    return rng, q, k, v


@pytest.mark.cuda
# d = 20 in 16 bits: rows of 40 bytes, staged through registers
@pytest.mark.parametrize("d", [8, 16, 20, 32, 64, 128, 136, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", ["dense", "causal_offset", "kv_lens",
                                  "packed", "packed_long"])
def test_flash_attention_kernel_matches_plain(cuda, d, dtype, mode):
    sq = skv = 77                        # ragged against the 64 tiles
    kw = {}
    if mode == "packed_long":            # 5 tiles: whole-tile skips
        sq = skv = 300
    if mode == "causal_offset":
        sq, skv = 45, 130                # end-aligned: q_offset = 85
        kw = dict(causal=True, q_offset=skv - sq)
    rng, q, k, v = _flash_case(2, 3, 2, sq, skv, d, cuda, dtype)
    if mode == "kv_lens":
        kw["kv_lens"] = torch.tensor([0, 1, 70], dtype=torch.int32,
                                     device=cuda)
    if mode.startswith("packed"):
        seg, used = _packed_rows(rng, 3, sq)
        kw["segment_ids"] = torch.tensor(seg, device=cuda)
        kw["kv_lens"] = torch.tensor(used, device=cuda)
    before = launch_counts()["flash_attention"]
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert torch.isfinite(o.float()).all()
    assert _within(o, ro, 1e-4)
    assert (lse - rlse).abs().max().item() <= 1e-4
    empty = rlse <= -1e29                # rows with no visible key
    assert torch.equal(lse[empty], rlse[empty])
    if empty.any():
        assert o.float()[empty].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "causal", "kv_lens"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_same_bits_every_run(cuda, mode, dtype):
    rng, q, k, v = _flash_case(5, 3, 2, 300, 300, 64, cuda, dtype)
    kw = {"causal": True} if mode == "causal" else {
        "kv_lens": torch.tensor([300, 1, 150], dtype=torch.int32,
                                device=cuda)}
    if mode == "packed":
        seg, used = _packed_rows(rng, 3, 300)
        kw = {"segment_ids": torch.tensor(seg, device=cuda),
              "kv_lens": torch.tensor(used, device=cuda)}
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    for _ in range(3):
        o2, lse2 = fa.flash_attention_with_lse(q, k, v, **kw)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dense", "causal_offset", "kv_lens",
                                  "packed", "packed_long"])
def test_flash_attention_kernel_past_256(cuda, d, dtype, mode):
    """Head dims past 256: o in chunks of 128 columns, one block each,
    the scores over the whole head dim; lengths, causal and packed rows
    as below 256, the same tolerances, the same bits on a second call."""
    sq = skv = 77
    kw = {}
    if mode == "packed_long":
        sq = skv = 300
    if mode == "causal_offset":
        sq, skv = 45, 130
        kw = dict(causal=True, q_offset=skv - sq)
    rng, q, k, v = _flash_case(2, 3, 2, sq, skv, d, cuda, dtype)
    if mode == "kv_lens":
        kw["kv_lens"] = torch.tensor([0, 1, 70], dtype=torch.int32,
                                     device=cuda)
    if mode.startswith("packed"):
        seg, used = _packed_rows(rng, 3, sq)
        kw["segment_ids"] = torch.tensor(seg, device=cuda)
        kw["kv_lens"] = torch.tensor(used, device=cuda)
    before = launch_counts()["flash_attention"]
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    o2, lse2 = fa.flash_attention_with_lse(q, k, v, **kw)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 2
    assert torch.isfinite(o.float()).all()
    assert _within(o, ro, 1e-4)
    assert (lse - rlse).abs().max().item() <= 1e-4
    empty = rlse <= -1e29
    assert torch.equal(lse[empty], rlse[empty])
    if empty.any():
        assert o.float()[empty].abs().max().item() == 0.0
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_attention_kernel_takes_strided_heads(cuda):
    # q, k, v sliced out of one fused (B, S, 3, H, D) projection
    rng = np.random.RandomState(3)
    qkv = torch.tensor(rng.randn(2, 70, 3, 4, 32).astype(np.float32),
                       device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    ro, _ = fa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (o - ro).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_bad_operands(cuda):
    # any head dim runs; k and v of another head dim than q do not
    _, q, k, v = _flash_case(4, 2, 2, 16, 16, 264, cuda, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :256], v[..., :256])
    _, q, k, v = _flash_case(4, 2, 2, 16, 16, 16, cuda, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v, kv_lens=torch.ones(
            2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    # differentiable now: the backward kernel refuses mismatched operands
    o, lse = fa.flash_attention_with_lse(q, k, v)
    with pytest.raises(ValueError, match="o/do"):
        fa.flash_attention_backward(q, k, v, o, lse, o.bfloat16())
    with pytest.raises(TypeError, match="lse"):
        fa.flash_attention_backward(q, k, v, o, lse[:, :, :3], o)


# -- K3a: LayerNorm forward --------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("r,d", [(1, 32), (37, 768), (8 * 512, 768),
                                 (5, 1000), (3, 1024), (9, 7),
                                 # a block a row past 1024
                                 (3, 1025), (37, 2048), (5, 4099),
                                 (2, 12288)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_kernel_matches_plain(cuda, r, d, dtype, eps):
    rng = np.random.RandomState(5)
    # an offset mean: the centred variance must not cancel
    x = torch.tensor(rng.randn(r, d).astype(np.float32) * 0.5 + 3.0,
                     dtype=dtype, device=cuda)
    g = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    b = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    before = launch_counts()["layer_norm"]
    y, mu, rs = ln.layer_norm_fused(x, g, b, eps, return_stats=True)
    ry, rmu, rrs = ln.layer_norm_reference(x, g, b, eps, return_stats=True)
    torch.cuda.synchronize()
    assert launch_counts()["layer_norm"] == before + 1
    # the mean's rounding, times rstd |gamma|, does not shrink with |y|;
    # the rest of the f32 rounding grows with it
    assert _within(y, ry, 1e-5, 2.0 ** -20)
    assert (mu - rmu).abs().max().item() <= 1e-5
    assert ((rs - rrs).abs() / rrs).max().item() <= 1e-5
    assert torch.equal(ln.layer_norm_fused(x, g, b, eps), y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 766, 768, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_layer_norm_kernel_on_any_width_and_row_start(cuda, d, dtype,
                                                      offset):
    """Widths that are not a multiple of a 16-byte vector, and (offset
    1) the rows of ``x[1:]``, whose start is not 16-byte aligned when
    D * itemsize is not a multiple of 16 (766 f32: 8 bytes off)."""
    rng = np.random.RandomState(d)
    full = torch.tensor(rng.randn(65, d).astype(np.float32) * 0.5 + 3.0,
                        dtype=dtype, device=cuda)
    x = full[offset:]
    g = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    b = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    before = launch_counts()["layer_norm"]
    y, mu, rs = ln.layer_norm_fused(x, g, b, 1e-12, return_stats=True)
    ry, rmu, rrs = ln.layer_norm_reference(x, g, b, 1e-12,
                                           return_stats=True)
    torch.cuda.synchronize()
    assert launch_counts()["layer_norm"] == before + 1
    assert _within(y, ry, 1e-5, 2.0 ** -20)
    assert (mu - rmu).abs().max().item() <= 1e-5
    assert ((rs - rrs).abs() / rrs).max().item() <= 1e-5
    with torch.inference_mode():     # the serving path: no stats
        assert torch.equal(ln.layer_norm_fused(x, g, b, 1e-12), y)
    assert launch_counts()["layer_norm"] == before + 2


@pytest.mark.cuda
def test_layer_norm_kernel_refuses_bad_operands(cuda):
    x = torch.randn(4, 16, device=cuda)
    g = torch.ones(16, device=cuda)
    with pytest.raises(ValueError):              # an empty last axis
        ln.layer_norm_fused(torch.randn(2, 0, device=cuda),
                            torch.ones(0, device=cuda),
                            torch.zeros(0, device=cuda))
    with pytest.raises(TypeError):
        ln.layer_norm_fused(x, g.double(), g)
    with pytest.raises(ValueError):
        ln.layer_norm_fused(x.t(), torch.ones(4, device=cuda),
                            torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError, match="forward only"):
        ln.layer_norm_fused(x.requires_grad_(), g, g, return_stats=True)


# -- K2: flash attention backward --------------------------------------------
# Kernel and plain version take the same q, k, v, o, lse, do and delta,
# compute in float32 and round each gradient to its type once: one unit
# in the last place of a 16-bit gradient, plus an absolute float32 term
# for the summation order over up to 300 keys or queries.
def _flash_bwd_case(cuda, d, dtype, mode):
    sq = skv = 77                        # ragged against the 64 tiles
    kw = {}
    if mode == "packed_long":            # 5 tiles: whole-tile skips
        sq = skv = 300
    if mode == "causal_offset":
        sq, skv = 45, 130                # end-aligned: q_offset = 85
        kw = dict(causal=True, q_offset=skv - sq)
    if mode == "causal_rows_before_keys":
        sq, skv = 100, 40                # rows 0..59 see no key
        kw = dict(causal=True, q_offset=skv - sq)
    rng, q, k, v = _flash_case(7, 3, 2, sq, skv, d, cuda, dtype)
    if mode == "kv_lens":
        kw["kv_lens"] = torch.tensor([0, 1, 70], dtype=torch.int32,
                                     device=cuda)
    if mode.startswith("packed"):
        seg, used = _packed_rows(rng, 3, sq)
        kw["segment_ids"] = torch.tensor(seg, device=cuda)
        kw["kv_lens"] = torch.tensor(used, device=cuda)
    do = torch.tensor(rng.randn(*q.shape).astype(np.float32), dtype=dtype,
                      device=cuda)
    dlse = torch.tensor(rng.randn(*q.shape[:3]).astype(np.float32),
                        device=cuda)
    return q, k, v, kw, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 136, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", ["dense", "causal_offset",
                                  "causal_rows_before_keys", "kv_lens",
                                  "packed", "packed_long"])
def test_flash_attention_backward_kernel_matches_plain(cuda, d, dtype,
                                                       mode):
    q, k, v, kw, do, dlse = _flash_bwd_case(cuda, d, dtype, mode)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    before = launch_counts()["flash_attention_bwd"]
    got = fa.flash_attention_backward(q, k, v, o, lse, do, dlse=dlse, **kw)
    delta = (do.float() * o.float()).sum(-1) - dlse
    want = fa.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                 **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 1
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, what
        assert torch.isfinite(g.float()).all(), what
        assert _within(g, w, 1e-4, 1e-5), \
            (what, (g.float() - w.float()).abs().max().item())
    if mode == "causal_rows_before_keys":      # rows with no visible key
        assert got[0][:, :, :60].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dense", "causal_offset",
                                  "causal_rows_before_keys", "kv_lens",
                                  "packed", "packed_long"])
def test_flash_attention_backward_kernel_past_256(cuda, d, dtype, mode):
    """K2 past head dim 256: the one-pass kernel over 64-column chunks
    at Skv <= 128 (77 and 40 keys), the split pair over 128-column
    chunks past it (130 and 300 keys); the tolerances of the D <= 256
    test, the same bits on a second call."""
    q, k, v, kw, do, dlse = _flash_bwd_case(cuda, d, dtype, mode)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    before = launch_counts()["flash_attention_bwd"]
    got = fa.flash_attention_backward(q, k, v, o, lse, do, dlse=dlse, **kw)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, dlse=dlse,
                                        **kw)
    delta = (do.float() * o.float()).sum(-1) - dlse
    want = fa.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                 **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == before + 2
    assert fa.backward_path(k.shape[2], d) == (
        "fused" if k.shape[2] <= 128 else "split")
    for g, w, g2, what in zip(got, want, again, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, what
        assert torch.isfinite(g.float()).all(), what
        assert _within(g, w, 1e-4, 1e-5), \
            (what, (g.float() - w.float()).abs().max().item())
        assert torch.equal(g, g2), what
    if mode == "causal_rows_before_keys":
        assert got[0][:, :, :60].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_attention_autograd_on_strided_heads(cuda):
    """Forward K1 and backward K2 through the autograd Function on heads
    sliced out of one fused projection: the gradient of the projection
    equals the one the plain versions give on the CPU."""
    rng = np.random.RandomState(3)
    base = rng.randn(2, 70, 3, 4, 32).astype(np.float32)
    w = rng.randn(2, 4, 70, 32).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        qkv = torch.tensor(base, device=dev, requires_grad=True)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = fa.flash_attention(q, k, v, causal=True)
        (o * torch.tensor(w, device=dev)).sum().backward()
        grads[dev.type] = qkv.grad.cpu()
    assert (grads["cuda"] - grads["cpu"]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 17, 64, 65, 127, 128, 129, 512])
@pytest.mark.parametrize("mode", ["kv_lens", "causal", "packed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_backward_fused_and_split(cuda, s, mode, dtype):
    """K2 on both sides of its one-pass limit (128 keys at D = 64):
    ragged tiles, a row of no visible key (kv_len 0, packed padding),
    the same bits on a second call."""
    rng, q, k, v = _flash_case(s, 3, 2, s, s, 64, cuda, dtype)
    kw = {"causal": True} if mode == "causal" else {
        "kv_lens": torch.tensor([0, max(1, s // 2), s], dtype=torch.int32,
                                device=cuda)}
    if mode == "packed":
        seg, used = _packed_rows(rng, 3, s)
        kw = {"segment_ids": torch.tensor(seg, device=cuda),
              "kv_lens": torch.tensor(used, device=cuda)}
    do = torch.tensor(rng.randn(*q.shape).astype(np.float32), dtype=dtype,
                      device=cuda)
    assert fa.backward_path(s, 64) == ("fused" if s <= 128 else "split")
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    delta = (do.float() * o.float()).sum(-1)
    want = fa.flash_attention_backward_reference(q, k, v, lse, do, delta,
                                                 **kw)
    torch.cuda.synchronize()
    for g, w, g2, what in zip(got, want, again, ("dq", "dk", "dv")):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), what
        assert _within(g, w, 1e-4, 1e-5), \
            (what, (g.float() - w.float()).abs().max().item())
        assert torch.equal(g, g2), what          # no atomics: same bits
    if mode != "causal":                         # batch 0 sees no key
        assert all(g[0].abs().max().item() == 0.0 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [70, 200])
def test_flash_attention_backward_on_strided_heads_both_paths(cuda, s):
    """K2 on head views of one fused projection, one pass (S = 70) and
    split (S = 200): the same gradients as on contiguous copies."""
    rng = np.random.RandomState(s)
    qkv = torch.tensor(rng.randn(2, s, 3, 4, 64).astype(np.float32),
                       device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.tensor(rng.randn(2, 4, s, 64).astype(np.float32),
                      device=cuda)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_backward(
        *(t.contiguous() for t in (q, k, v, o)), lse, do, causal=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- K3b: LayerNorm backward -------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("r,d", [(1, 32), (37, 768), (8 * 1024, 768),
                                 (5, 1000), (3, 1024), (9, 7), (5000, 64),
                                 # a block a row past 1024; more rows
                                 # than its 512 blocks
                                 (3, 1025), (700, 2048), (5, 4099),
                                 (2, 12288)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_layer_norm_backward_kernel_matches_plain(cuda, r, d, dtype):
    rng = np.random.RandomState(6)
    x = torch.tensor(rng.randn(r, d).astype(np.float32) * 0.5 + 3.0,
                     dtype=dtype, device=cuda)
    g = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    dy = torch.tensor(rng.randn(r, d).astype(np.float32), dtype=dtype,
                      device=cuda)
    _, mu, rs = ln.layer_norm_fused(x, g, g, 1e-12, return_stats=True)
    before = launch_counts()["layer_norm_bwd"]
    dx, dg, db = ln.layer_norm_backward(x, g, mu, rs, dy)
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, g, mu, rs, dy)
    torch.cuda.synchronize()
    assert launch_counts()["layer_norm_bwd"] == before + 1
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    assert _within(dx, rdx, 1e-4, 1e-5)
    # dgamma, dbeta: sums over r rows in another order (per warp, per
    # block, then over <= 512 blocks): relative to the sum of |terms|
    xhat = (x.float() - mu[:, None]) * rs[:, None]
    for got, want, terms in ((dg, rdg, dy.float() * xhat),
                             (db, rdb, dy.float())):
        bound = 5e-5 * terms.abs().sum(0) + 1e-5
        assert ((got - want).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 770, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", [0, 1])
def test_layer_norm_backward_widths_and_same_bits(cuda, d, dtype, offset):
    """K3b on rows of whole 16-byte vectors (768; 2048 a block a row),
    on a width that is not (770), and (offset 1) on the rows of
    ``x[1:]``, whose start is not 16-byte aligned at 770: the tolerances
    above, and the same bits on a second call."""
    rng = np.random.RandomState(d + offset)
    r = 1000
    full = torch.tensor(rng.randn(r + 1, d).astype(np.float32) * 0.5 + 3.0,
                        dtype=dtype, device=cuda)
    x = full[offset:offset + r]
    dfull = torch.tensor(rng.randn(r + 1, d).astype(np.float32),
                         dtype=dtype, device=cuda)
    dy = dfull[offset:offset + r]
    g = torch.tensor(rng.randn(d).astype(np.float32), dtype=dtype,
                     device=cuda)
    _, mu, rs = ln.layer_norm_fused(x, g, g, 1e-12, return_stats=True)
    before = launch_counts()["layer_norm_bwd"]
    got = ln.layer_norm_backward(x, g, mu, rs, dy)
    again = ln.layer_norm_backward(x, g, mu, rs, dy)
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, g, mu, rs, dy)
    torch.cuda.synchronize()
    assert launch_counts()["layer_norm_bwd"] == before + 2
    dx, dg, db = got
    assert _within(dx, rdx, 1e-4, 1e-5)
    xhat = (x.float() - mu[:, None]) * rs[:, None]
    for gt, want, terms in ((dg, rdg, dy.float() * xhat),
                            (db, rdb, dy.float())):
        bound = 5e-5 * terms.abs().sum(0) + 1e-5
        assert ((gt - want).abs() <= bound).all()
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_layer_norm_autograd_runs_both_kernels(cuda):
    rng = np.random.RandomState(8)
    x = torch.tensor(rng.randn(6, 40, 96).astype(np.float32), device=cuda,
                     requires_grad=True)
    g = torch.tensor(rng.randn(96).astype(np.float32), device=cuda,
                     requires_grad=True)
    b = torch.zeros(96, device=cuda, requires_grad=True)
    before = launch_counts()
    y = ln.layer_norm_fused(x, g, b, 1e-12)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["layer_norm"] == before["layer_norm"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    assert b.grad.allclose(torch.full_like(b, 240.0))
    assert torch.isfinite(x.grad).all() and torch.isfinite(g.grad).all()


@pytest.mark.cuda
def test_layer_norm_backward_kernel_refuses_bad_operands(cuda):
    x = torch.randn(4, 16, device=cuda)
    g = torch.ones(16, device=cuda)
    mu, rs = torch.zeros(4, device=cuda), torch.ones(4, device=cuda)
    with pytest.raises(TypeError):
        ln.layer_norm_backward(x, g, mu.half(), rs, x)
    with pytest.raises(ValueError):
        ln.layer_norm_backward(x, g, mu, rs, x[:2])
    with pytest.raises(ValueError):
        ln.layer_norm_backward(x, g.cpu(), mu, rs, x)
    empty = torch.randn(2, 0, device=cuda)
    with pytest.raises(ValueError):
        ln.layer_norm_backward(empty, torch.ones(0, device=cuda),
                               mu[:2], rs[:2], empty)


# -- K4a/K4b: fused softmax cross-entropy ------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n,v", [(5, 7), (33, 513), (64, 1024),
                                 (300, 30522), (6144, 30522)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_softmax_xent_kernels_match_plain(cuda, n, v, dtype):
    rng = np.random.RandomState(9)
    x = torch.tensor(rng.randn(n, v).astype(np.float32) * 2.0, dtype=dtype,
                     device=cuda)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[0] = -1                       # outside [0, V): picks nothing
    lab = torch.tensor(labels, device=cuda)
    g = torch.tensor(rng.randn(n).astype(np.float32), device=cuda)
    before = launch_counts()
    loss, lse = sx.softmax_xent_forward(x, lab)
    dx = sx.softmax_xent_backward(x, lab, lse, g)
    rloss, rlse = sx.softmax_xent_reference(x, lab)
    rdx = sx.softmax_xent_backward_reference(x, lab, rlse, g)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["softmax_xent_fwd"] == before["softmax_xent_fwd"] + 1
    assert after["softmax_xent_bwd"] == before["softmax_xent_bwd"] + 1
    # f32 log-sum-exp over up to 30522 terms in another order
    assert ((loss - rloss).abs() <= 1e-5 + 1e-6 * rloss.abs()).all()
    assert ((lse - rlse).abs() <= 1e-5 + 1e-6 * rlse.abs()).all()
    assert loss[0].item() == lse[0].item()
    assert dx.dtype == dtype
    assert _within(dx, rdx, 1e-6, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [3, 30522, 30523])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", [0, 1])
def test_softmax_xent_backward_widths_and_same_bits(cuda, v, dtype, offset):
    """K4b on V below one 16-byte vector (3), the MLM vocabulary (rows
    8 bytes off a 16-byte boundary in f32), an odd V, and (offset 1)
    logits whose storage starts one element past dx's alignment (element
    by element); labels outside [0, V) pick nothing. The tolerance
    above, and the same bits on a second call."""
    rng = np.random.RandomState(v + offset)
    n = 37
    flat = torch.tensor(rng.randn(n * v + 1).astype(np.float32) * 2.0,
                        dtype=dtype, device=cuda)
    x = flat[offset:offset + n * v].view(n, v)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[0], labels[1] = -1, v
    lab = torch.tensor(labels, device=cuda)
    g = torch.tensor(rng.randn(n).astype(np.float32), device=cuda)
    _, lse = sx.softmax_xent_forward(x, lab)
    before = launch_counts()["softmax_xent_bwd"]
    dx = sx.softmax_xent_backward(x, lab, lse, g)
    again = sx.softmax_xent_backward(x, lab, lse, g)
    rdx = sx.softmax_xent_backward_reference(x, lab, lse, g)
    torch.cuda.synchronize()
    assert launch_counts()["softmax_xent_bwd"] == before + 2
    assert dx.dtype == dtype
    assert _within(dx, rdx, 1e-6, 1e-5)
    assert torch.equal(dx, again)


@pytest.mark.cuda
def test_softmax_xent_autograd_and_op(cuda):
    from mxnet_tpu_torch import ndarray as nd

    rng = np.random.RandomState(10)
    base = rng.randn(50, 999).astype(np.float32)
    labels = rng.randint(0, 999, 50)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.tensor(base, device=dev, requires_grad=True)
        loss = nd.softmax_cross_entropy(x, torch.tensor(labels, device=dev))
        loss.backward()
        out[dev.type] = (loss.item(), x.grad.cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_softmax_xent_kernels_refuse_bad_operands(cuda):
    x = torch.randn(4, 10, device=cuda)
    lab = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sx.softmax_xent_forward(x.double(), lab)
    with pytest.raises(TypeError):
        sx.softmax_xent_forward(x, lab.float())
    with pytest.raises(ValueError):
        sx.softmax_xent_forward(x, lab.cpu())
    with pytest.raises(ValueError):
        sx.softmax_xent_backward(x, lab, torch.zeros(3, device=cuda),
                                 torch.zeros(4, device=cuda))


# -- K6a/K6b: whole-sequence LSTM ---------------------------------------------
# Kernel and plain version run the same float32 recurrence and sum the
# products in another order. Float32: within 1e-5 of each tensor's
# scale (its largest magnitude, at least 1); dW sums T * N products.
# bf16: one bf16 ulp of the scale, as each side rounds every h it
# feeds back once.
def _lstm_case(t, n, h, dtype, dev, zero_state, seed=0):
    rng = np.random.RandomState(seed + t + n + h)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    gin = f(t, n, 4 * h) * 0.5
    w = f(4 * h, h) / np.sqrt(h)          # MXNet's (4H, H) layout
    h0, c0 = (np.zeros((n, h), np.float32),) * 2 if zero_state else (
        f(n, h) * 0.5, f(n, h) * 0.5)
    dout = f(t, n, h)
    dout[-1] += f(n, h)                    # the final h's cotangent
    dcseq = np.zeros((t, n, h), np.float32)
    dcseq[-1] = f(n, h)                    # the final c's cotangent
    to = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return to(gin), to(w).t(), to(h0), to(c0), to(dout), to(dcseq)


def _lstm_close(got, want, dtype, tol=1e-5):
    scale = max(want.float().abs().max().item(), 1.0)
    bound = tol * scale if dtype == torch.float32 \
        else 2.0 ** (math.floor(math.log2(scale)) - 7)
    return (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("h", [24, 200, 650])
@pytest.mark.parametrize("n", [1, 8, 32, 1024])
@pytest.mark.parametrize("t", [1, 7, 35])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_state", [True, False])
def test_lstm_kernels_match_plain(cuda, h, n, t, dtype, zero_state):
    gin, w, h0, c0, dout, dcseq = _lstm_case(t, n, h, dtype, cuda,
                                             zero_state)
    before = launch_counts()
    out, cseq, gates = lstm.lstm_forward(gin, w, h0, c0)
    want = lstm.lstm_forward_reference(gin, w, h0, c0)
    # the backward from the kernel's own forward, so each kernel is held
    # against its plain version on the same inputs
    got_b = lstm.lstm_backward(gates, cseq, out, w, h0, c0, dout, dcseq)
    want_b = lstm.lstm_backward_reference(gates, cseq, out, w, h0, c0,
                                          dout, dcseq)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["lstm_fwd"] == before["lstm_fwd"] + 1
    assert after["lstm_bwd"] == before["lstm_bwd"] + 1
    assert after["lstm_bwd_dw"] == before["lstm_bwd_dw"] + 1
    for name, g, r in zip(("out", "cseq", "gates"), (out, cseq, gates),
                          want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
        assert _lstm_close(g, r, dtype), name
    assert got_b[3].stride() == w.stride()       # dW in W's layout
    for name, g, r in zip(("dgin", "dh0", "dc0", "dw"), got_b, want_b):
        assert torch.isfinite(g.float()).all(), name
        assert _lstm_close(g, r, dtype), name


def _lstm_backward_matches(cuda, t, n, h, dtype, w_layout):
    """K6b's two kernels against the plain backward on the kernel
    forward's outputs; the same bits on a second run; each counter up
    by one a call."""
    gin, w, h0, c0, dout, dcseq = _lstm_case(t, n, h, dtype, cuda, False)
    if w_layout == "h4h":               # a contiguous (H, 4H) weight
        w = w.contiguous()
    out, cseq, gates = lstm.lstm_forward(gin, w, h0, c0)
    before = launch_counts()
    got = lstm.lstm_backward(gates, cseq, out, w, h0, c0, dout, dcseq)
    after = launch_counts()
    again = lstm.lstm_backward(gates, cseq, out, w, h0, c0, dout, dcseq)
    want = lstm.lstm_backward_reference(gates, cseq, out, w, h0, c0, dout,
                                        dcseq)
    torch.cuda.synchronize()
    assert after["lstm_bwd"] == before["lstm_bwd"] + 1
    assert after["lstm_bwd_dw"] == before["lstm_bwd_dw"] + 1
    assert got[3].stride() == w.stride()
    for name, g, r, g2 in zip(("dgin", "dh0", "dc0", "dw"), got, want,
                              again):
        assert torch.isfinite(g.float()).all(), name
        assert _lstm_close(g, r, dtype), name
        assert torch.equal(g, g2), name        # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("h", [24, 200, 650, 1056, 1500, 2112])
@pytest.mark.parametrize("n", [1, 17, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_layout", ["4hh", "h4h"])
def test_lstm_backward_kernels_on_ragged_m_tiles(cuda, h, n, dtype,
                                                 w_layout):
    """N not a multiple of the m16 tile, H up to 1056 (8 units a block
    on 132 SMs) and past it (1500, 2112: W's rows in device memory, but
    1500 in bf16), one step, both layouts of W."""
    _lstm_backward_matches(cuda, 1, n, h, dtype, w_layout)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [24, 200, 650, 1056, 1500, 2112])
@pytest.mark.parametrize("n", [1, 17, 33, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_layout", ["4hh", "h4h"])
def test_lstm_forward_kernel_on_its_grid(cuda, h, n, dtype, w_layout):
    """K6a over its unit groups x row groups: N not a multiple of the
    m16 tile, up to 8 row groups of one block (N=1024), H up to 1056 (8
    units a block) and past it (W's columns in device memory at 16
    units a block), both layouts of W, three steps (both h buffers
    written and read again); the same bits on a second run."""
    gin, w, h0, c0, _, _ = _lstm_case(3, n, h, dtype, cuda, False)
    if w_layout == "h4h":               # a contiguous (H, 4H) weight
        w = w.contiguous()
    before = launch_counts()["lstm_fwd"]
    got = lstm.lstm_forward(gin, w, h0, c0)
    again = lstm.lstm_forward(gin, w, h0, c0)
    want = lstm.lstm_forward_reference(gin, w, h0, c0)
    torch.cuda.synchronize()
    assert launch_counts()["lstm_fwd"] == before + 2
    for name, g, r, g2 in zip(("out", "cseq", "gates"), got, want, again):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
        assert _lstm_close(g, r, dtype), name
        assert torch.equal(g, g2), name        # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(3, 17), (7, 5), (2, 33), (35, 3)])
@pytest.mark.parametrize("h", [33, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_lstm_dw_kernel_on_ragged_depth(cuda, t, n, h, dtype):
    """T * N (the dW product's depth) not a multiple of its 16-deep
    step; H = 33 and 200 are not multiples of its 64-row tile, 4H not
    one of its 128 columns; at H = 33 a 16-bit dgin row is not a whole
    number of 16-byte groups (the recurrence's element-wise loads)."""
    _lstm_backward_matches(cuda, t, n, h, dtype, "4hh")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 32])
def test_lstm_kernels_past_one_unit_group_an_sm(cuda, n):
    """H = 2500 f32: 157 unit groups of 16 on at most one block an SM,
    so blocks walk several work blocks a step (W's rows in device
    memory); forward, the backward's recurrence and dW against their
    plain versions, and the same bits on a second call."""
    gin, w, h0, c0, dout, dcseq = _lstm_case(3, n, 2500, torch.float32,
                                             cuda, False)
    plan = lstm.lstm_plan(n, 2500, backward=True)
    assert plan["w_global"] and plan["walk"] >= 2
    assert plan["blocks"] <= plan["sms"] < plan["work_blocks"]
    before = launch_counts()
    got = lstm.lstm_forward(gin, w, h0, c0)
    want = lstm.lstm_forward_reference(gin, w, h0, c0)
    # the backward from the kernel's own forward (out, cseq, gates)
    got_b = lstm.lstm_backward(got[2], got[1], got[0], w, h0, c0, dout,
                               dcseq)
    want_b = lstm.lstm_backward_reference(got[2], got[1], got[0], w, h0,
                                          c0, dout, dcseq)
    again = lstm.lstm_forward(gin, w, h0, c0)
    again_b = lstm.lstm_backward(got[2], got[1], got[0], w, h0, c0, dout,
                                 dcseq)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["lstm_fwd"] == before["lstm_fwd"] + 2
    assert after["lstm_bwd"] == before["lstm_bwd"] + 2
    assert after["lstm_bwd_dw"] == before["lstm_bwd_dw"] + 2
    for name, g, r, g2 in zip(("out", "cseq", "gates", "dgin", "dh0", "dc0",
                               "dw"), (*got, *got_b), (*want, *want_b),
                              (*again, *again_b)):
        assert torch.isfinite(g.float()).all(), name
        assert _lstm_close(g, r, torch.float32), name
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_lstm_autograd_on_the_card_matches_the_cpu(cuda):
    rng = np.random.RandomState(12)
    args = [rng.randn(9, 5, 4 * 40).astype(np.float32) * 0.5,
            rng.randn(4 * 40, 40).astype(np.float32) / 7,
            rng.randn(5, 40).astype(np.float32),
            rng.randn(5, 40).astype(np.float32)]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in args]
        out, cseq = lstm.lstm_layer_fused(leaves[0], leaves[1].t(),
                                          *leaves[2:])
        (out.sum() + (cseq[-1] * cseq[-1]).sum()).backward()
        grads[dev.type] = [leaf.grad.cpu() for leaf in leaves]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _lstm_close(g, r, torch.float32)


@pytest.mark.cuda
def test_ops_raise_on_the_card_where_no_kernel_runs(cuda):
    """On the card an op never falls back to composed math for a call
    of its kernels' types: head dim 264 and an LSTM layer past one
    block an SM of 16 units (H = 16 SMs + 1) launch the kernels, and
    what no kernel takes (keys of another head dim than the queries, an
    initial state of the wrong width) raises before any launch."""
    from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn

    before = launch_counts()
    q = torch.zeros(1, 1, 4, 264, device=cuda)
    with pytest.raises(ValueError, match="do not match"):
        op_impl_nn.flash_attention_op(q, q[..., :256], q[..., :256])
    hid = 16 * lstm.device_numbers(cuda)[0] + 1
    size = op_impl_rnn.rnn_param_size(1, 4, hid, False, "lstm")
    state = torch.zeros(1, 1, hid, device=cuda)
    with pytest.raises(ValueError):
        op_impl_rnn.rnn(torch.zeros(2, 1, 4, device=cuda),
                        torch.zeros(size, device=cuda), state[..., 1:],
                        state, state_size=hid, num_layers=1,
                        bidirectional=False, mode="lstm")
    assert launch_counts() == before
    o = op_impl_nn.flash_attention_op(q, q, q)
    out = op_impl_rnn.rnn(torch.zeros(2, 1, 4, device=cuda),
                          torch.zeros(size, device=cuda), state, state,
                          state_size=hid, num_layers=1, bidirectional=False,
                          mode="lstm")
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["lstm_fwd"] == before["lstm_fwd"] + 1
    assert o.abs().max().item() == 0.0
    assert all(t.abs().max().item() == 0.0 for t in out)


@pytest.mark.cuda
def test_lstm_grid_and_what_cannot_fit(cuda):
    plan = lstm.lstm_plan(32, 650)
    assert plan["blocks"] * plan["units_per_block"] >= 650
    assert plan["blocks"] <= plan["blocks_per_sm"] * plan["sms"]
    assert plan["smem_bytes"] <= plan["smem_limit"]
    bplan = lstm.lstm_plan(1024, 650, backward=True)
    assert bplan["blocks"] <= bplan["blocks_per_sm"] * bplan["sms"]
    assert bplan == {**lstm.plan_grid(1024, 650, torch.float32,
                                      bplan["sms"], bplan["smem_limit"],
                                      backward=True),
                     "blocks_per_sm": bplan["blocks_per_sm"]}
    for n in (1, 33, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            for hid in (1056, 1500, 2112, 2500):
                lstm.lstm_plan(n, hid, dtype, backward=True)
                lstm.lstm_plan(n, hid, dtype)
    assert lstm.lstm_plan(32, 1500)["w_global"]
    # H = 4096: 256 work blocks walked by one block an SM
    wide = lstm.lstm_plan(8, 4096)
    assert wide["w_global"] and wide["blocks"] == wide["sms"]
    assert wide["work_blocks"] == 256
    # what cannot fit: W's rows past the device memory given
    with pytest.raises(ValueError, match="cannot run"):
        lstm.plan_grid(8, 4096, torch.float32, wide["sms"],
                       wide["smem_limit"], mem_limit=1 << 20)
    gin = torch.zeros(2, 8, 4 * 64, device=cuda)
    w = torch.zeros(64, 4 * 64, device=cuda)
    h0 = torch.zeros(8, 64, device=cuda)
    before = launch_counts()["lstm_fwd"]
    with pytest.raises(ValueError):
        lstm.lstm_forward(gin, w, h0.cpu(), h0)
    assert launch_counts()["lstm_fwd"] == before


# -- autograd semantics on the card ------------------------------------------
@pytest.mark.cuda
def test_grad_req_write_overwrites_on_the_card(cuda):
    """torch runs a CUDA backward in its own device threads; the
    ``write`` hook must still overwrite, ``add`` accumulate."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    layer = nn.Dense(3, in_units=4, device=cuda).initialize(seed=1)
    x = torch.randn(5, 4, device=cuda)
    for req, factor in (("write", 1.0), ("add", 2.0)):
        layer.collect_params().setattr("grad_req", req)
        layer.zero_grad()
        for _ in range(2):
            with autograd.record():
                y = layer(x)
            autograd.backward(y)
        want = torch.ones(5, 3, device=cuda).t() @ x
        assert torch.allclose(layer.weight.grad, factor * want, atol=1e-5)


# -- mx.nd.<op> on CUDA NDArrays: the registry reaches the same kernels ----
def _nd_vs_direct(cuda, dtype, case):
    """``(name, direct(tensors), registry(ndarrays), inputs, kernels)``:
    forward and backward through ``mx.nd.<op>`` on NDArrays and through
    the op function on plain tensors, from the same inputs and head."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn

    rng = np.random.RandomState(3)

    def t(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                            device=cuda)

    if case == "LayerNorm":
        args = [t((4, 33, 96)), t((96,), 0.5, 1.5), t((96,))]
        direct = lambda a: op_impl_nn.layer_norm(*a, eps=1e-12)  # noqa
        reg = lambda a: nd.LayerNorm(*a, axis=-1, eps=1e-12)  # noqa
        kernels = ("layer_norm", "layer_norm_bwd")
    elif case == "flash_attention":
        args = [t((2, 3, 40, 64)) for _ in range(3)]
        vl = torch.tensor([40, 17], dtype=torch.int32, device=cuda)
        direct = lambda a: op_impl_nn.flash_attention_op(*a, vl)  # noqa
        reg = lambda a: nd.flash_attention(  # noqa
            *a, vl.as_subclass(nd.NDArray))
        kernels = ("flash_attention", "flash_attention_bwd")
    elif case == "softmax_cross_entropy":
        args = [t((37, 1000))]
        lab = torch.tensor(rng.randint(0, 1000, 37), dtype=torch.int32,
                           device=cuda)
        direct = lambda a: op_impl_nn.softmax_cross_entropy(a[0], lab)  # noqa
        reg = lambda a: nd.softmax_cross_entropy(  # noqa
            a[0], lab.as_subclass(nd.NDArray))
        kernels = ("softmax_xent_fwd", "softmax_xent_bwd")
    else:                                                   # RNN
        tt, n, i, h = 5, 3, 16, 32
        size = op_impl_rnn.rnn_param_size(2, i, h, False, "lstm")
        args = [t((tt, n, i)), t((size,), -0.2, 0.2), t((2, n, h)),
                t((2, n, h))]
        kw = dict(state_size=h, num_layers=2, mode="lstm",
                  state_outputs=True)
        direct = lambda a: op_impl_rnn.rnn(*a, **kw)[0]  # noqa
        reg = lambda a: nd.RNN(*a, **kw)[0]  # noqa
        kernels = ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw")
    runs = []
    for fn in (direct, reg):
        xs = [a.clone() if fn is direct else
              a.clone().as_subclass(nd.NDArray) for a in args]
        for x in xs:
            x.requires_grad_(True)
        before = launch_counts()
        with autograd.record():
            out = fn(xs)
        head = torch.ones_like(out.detach().as_subclass(torch.Tensor))
        out.backward(head)
        torch.cuda.synchronize()
        after = launch_counts()
        runs.append((out.detach().as_subclass(torch.Tensor),
                     [x.grad.as_subclass(torch.Tensor) for x in xs],
                     {k: after[k] - before[k] for k in kernels}))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["LayerNorm", "flash_attention",
                                  "softmax_cross_entropy", "RNN"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_nd_registry_reaches_the_kernels_bit_for_bit(cuda, case, dtype):
    (out_d, g_d, n_d), (out_r, g_r, n_r) = _nd_vs_direct(cuda, dtype, case)
    assert n_r == n_d and all(v > 0 for v in n_d.values()), (n_d, n_r)
    assert torch.equal(out_r, out_d)
    for a, b in zip(g_r, g_d):
        assert torch.equal(a, b)


# -- CUDA graphs: every kernel captured in a hybridized block's graph -----
def _graph_case(cuda, dtype, case, seed):
    """``(inputs that take gradients, other inputs, fn, kernels)`` of
    one kernel's op at a small shape; every tensor the op reads is an
    input, so a replay with new inputs computes a new result."""
    from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn

    rng = np.random.RandomState(seed)

    def t(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                            device=cuda)

    if case == "layer_norm":
        return ([t((4, 33, 96)), t((96,), 0.5, 1.5), t((96,))], [],
                lambda x, g, b: op_impl_nn.layer_norm(x, g, b, eps=1e-12),
                ("layer_norm", "layer_norm_bwd"))
    if case == "flash_attention":
        vl = torch.tensor([40, 1 + seed % 39], dtype=torch.int32,
                          device=cuda)
        return ([t((2, 3, 40, 64)) for _ in range(3)], [vl],
                op_impl_nn.flash_attention_op,
                ("flash_attention", "flash_attention_bwd"))
    if case == "softmax_xent":
        lab = torch.tensor(rng.randint(0, 1000, 37), dtype=torch.int32,
                           device=cuda)
        return ([t((37, 1000))], [lab], op_impl_nn.softmax_cross_entropy,
                ("softmax_xent_fwd", "softmax_xent_bwd"))
    tt, n, i, h = 5, 3, 16, 32                              # lstm
    size = op_impl_rnn.rnn_param_size(2, i, h, False, "lstm")
    kw = dict(state_size=h, num_layers=2, mode="lstm", state_outputs=True)
    return ([t((tt, n, i)), t((size,), -0.2, 0.2), t((2, n, h)),
             t((2, n, h))], [],
            lambda *a: op_impl_rnn.rnn(*a, **kw)[0],
            ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw"))


def _op_block(fn):
    from mxnet_tpu_torch.gluon import HybridBlock

    class Op(HybridBlock):
        def forward(self, *xs):
            return fn(*xs)

    return Op(prefix="")


def _recorded_call(block, case):
    from mxnet_tpu_torch import autograd

    grad_in, const_in, _, kernels = case
    xs = [a.clone().requires_grad_(True) for a in grad_in]
    before = launch_counts()
    with autograd.record():
        out = block(*xs, *const_in)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    after = launch_counts()
    return (out.detach(), [x.grad for x in xs],
            {k: after[k] - before[k] for k in kernels})


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layer_norm", "flash_attention",
                                  "softmax_xent", "lstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_kernels_replay_as_eager(cuda, case, dtype):
    """A hybridized block around each kernel's op: forward and backward
    captured once, then replayed on new inputs; outputs, gradients and
    launch counts the same as the eager block's, to the bit (the
    kernels use no float atomics)."""
    fn = _graph_case(cuda, dtype, case, 0)[2]
    eager, graphed = _op_block(fn), _op_block(fn).hybridize()
    for seed in (1, 2, 3):
        c = _graph_case(cuda, dtype, case, seed)
        c = (c[0], c[1], fn, c[3])
        out_e, g_e, n_e = _recorded_call(eager, c)
        out_g, g_g, n_g = _recorded_call(graphed, c)
        assert n_g == n_e and all(v > 0 for v in n_e.values()), (n_e, n_g)
        assert torch.equal(out_g, out_e)
        for a, b in zip(g_g, g_e):
            assert torch.equal(a, b)
    (entry,) = graphed._cached_graph.values()
    assert len(entry.instances) == 1 and entry.instances[0].bwd is not None


@pytest.mark.cuda
def test_graph_paged_attention_replays_leave_tickets_at_zero(cuda):
    """K5 captured once and replayed 1000 times on new queries and
    histories: every replay equals the plain version, and the ticket
    counters of the capture stream stay 0 (the last block of a tile
    resets its ticket)."""
    from mxnet_tpu_torch import graphs

    q, k, v, table, kvl = _case(0, 1, (5, 17, 24), 64, cuda, torch.float32)
    rng = np.random.RandomState(5)
    pool = torch.cuda.graph_pool_handle()
    graph = graphs.capture(pa.paged_flash_attention, [q, k, v, table, kvl],
                           cuda, pool, "paged attention")
    out = graph.out
    assert graph.launches == {"paged_attention": 1}
    before = launch_counts()["paged_attention"]
    worst = 0.0
    for i in range(1000):
        q.copy_(torch.from_numpy(rng.randn(*q.shape).astype(np.float32)))
        kvl.copy_(torch.from_numpy(rng.randint(0, 25, 3).astype(np.int32)))
        graph.replay()
        want = pa.paged_attention_reference(q, k, v, table, kvl)
        worst = max(worst, (out - want).abs().max().item())
    assert launch_counts()["paged_attention"] == before + 1000
    assert worst <= 1e-4, worst
    stream = graphs.capture_stream(cuda)
    tickets = [b for (_, s), b in pa._TICKETS.items()
               if s == stream.cuda_stream]
    assert tickets and all(int(b.abs().sum()) == 0 for b in tickets)


@pytest.mark.cuda
def test_graph_paged_attention_survives_a_larger_ticket_buffer(cuda):
    """A K5 call captured at a few counters, then a call on the same
    stream that needs more than 4096 (a new ticket buffer) and an
    allocation of the size of the old one filled with non-zeros: the
    first graph's replay still equals the plain version (the counters it
    captured stay alive and zero), and so does the large call."""
    from mxnet_tpu_torch import graphs

    small = dict(p=24, h=4, psize=16, npg=8)
    q, k, v, table, kvl = _case(0, 1, (100, 120, 90), 64, cuda,
                                torch.float32, **small)
    pool = torch.cuda.graph_pool_handle()
    graph = graphs.capture(pa.paged_flash_attention, [q, k, v, table, kvl],
                           cuda, pool, "paged attention")
    assert pa.split_count(8, 16) > 1
    stream = graphs.capture_stream(cuda)
    big = _case(1, 160, (160, 170, 200, 250), 64, cuda, torch.float32,
                p=64, h=8, psize=16, npg=16)
    assert 4 * 8 * 160 > 4096
    with torch.cuda.stream(stream):
        got_big = pa.paged_flash_attention(*big)
        junk = torch.full((4096,), 7, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    want_big = pa.paged_attention_reference(*big)
    assert (got_big - want_big).abs().max().item() <= 1e-4
    rng = np.random.RandomState(6)
    for _ in range(3):
        q.copy_(torch.from_numpy(rng.randn(*q.shape).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(q, k, v, table, kvl)
        assert (graph.out - want).abs().max().item() <= 1e-4
    assert int(junk.ne(7).sum()) == 0
    tickets = [b for (_, s), b in pa._TICKETS.items()
               if s == stream.cuda_stream]
    assert tickets and all(int(b.abs().sum()) == 0 for b in tickets)


@pytest.mark.cuda
def test_graph_hybridized_bert_step_matches_eager(cuda):
    """A 2-layer BERT with the MLM head, hybridized: three recorded steps
    (forward graph, backward graph, Adam) give the eager model's losses
    and weights; the launches of each step are the eager step's."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMHead, BERTModel
    from mxnet_tpu_torch.ndarray import op_impl_nn

    def build():
        net = BERTModel(vocab_size=100, units=64, hidden_size=128,
                        num_layers=2, num_heads=4, max_length=32,
                        dropout=0.0, attention_dropout=0.0,
                        use_pooler=False, device=cuda, seed=1)
        head = BERTMLMHead(100, 64, device=cuda, seed=2)
        params = {**{"n" + k: p for k, p in net.collect_params().items()},
                  **{"h" + k: p for k, p in head.collect_params().items()}}
        tr = gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
        return net, head, tr

    rng = np.random.RandomState(0)
    ids = torch.tensor(rng.randint(0, 100, (4, 32)), device=cuda)
    tt = torch.zeros_like(ids)
    vl = torch.tensor([32, 20, 9, 31], dtype=torch.int32, device=cuda)
    lab = torch.tensor(rng.randint(0, 100, (4 * 32,)), dtype=torch.int32,
                       device=cuda)
    runs = []
    for hybrid in (False, True):
        net, head, tr = build()
        if hybrid:
            net.hybridize()
            head.hybridize()
        losses, counts = [], []
        for _ in range(3):
            before = launch_counts()
            with autograd.record():
                seq = net(ids, tt, vl)
                seq = seq[0] if isinstance(seq, (list, tuple)) else seq
                logits = head(seq).reshape(-1, 100)
                loss = op_impl_nn.softmax_cross_entropy(logits, lab)
            loss.backward()
            tr.step(1)
            torch.cuda.synchronize()
            after = launch_counts()
            losses.append(loss.detach().clone())
            counts.append({k: after[k] - before[k] for k in after
                           if after[k] != before[k]})
        runs.append((losses, counts, [p.detach().clone()
                                      for p in net.parameters()]))
    (le, ce, we), (lg, cg, wg) = runs
    assert cg == ce and ce[0]
    for a, b in zip(lg, le):
        assert torch.equal(a, b)
    for a, b in zip(wg, we):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_decode_engine_streams_match_eager(cuda):
    """``PagedCausalLM`` on the card (one graph per prefill, chunk and
    decode bucket, K5 inside) serves the greedy streams of its steps'
    bodies called directly token for token; every bucket of the
    warm-up is a capture, every later step a replay."""
    from mxnet_tpu_torch.serving import DecodeEngine, PagedCausalLM

    def eager(model):
        def run(name, caches, arrays, body):
            return body(caches, *[torch.as_tensor(np.asarray(a, np.int64),
                                                  device=model.device)
                                  for a in arrays])

        model._run = run
        return model

    geom = dict(vocab=64, units=32, layers=2, heads=4, max_len=128, seed=7)
    eng_kw = dict(prefill_bucket_lens=(8, 16), max_rows=4, page_size=8,
                  n_pages=24, max_new_tokens=6)
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12],
               [3, 1, 4, 1, 5, 9, 2, 6], [5, 6, 7, 8, 9, 10, 11, 12, 13]]
    streams, snaps = [], []
    for graphed in (False, True):
        model = PagedCausalLM(device=cuda, **geom)
        if not graphed:
            eager(model)
        with DecodeEngine(model, **eng_kw) as eng:
            eng.warmup()
            futs = [eng.submit(p, max_new_tokens=7) for p in prompts]
            streams.append([f.result(timeout=120).tolist() for f in futs])
            snaps.append(eng.snapshot()["compile_cache"])
    assert streams[1] == streams[0]
    assert snaps[0]["miss"] == 0 and snaps[1]["miss"] > 0
    assert snaps[1]["persistent_hit"] == 0


@pytest.mark.cuda
def test_graph_encoder_engine_answers_match_eager(cuda):
    """``bert_serving_entry(hybridize=True)``: one graph per (rows,
    row_len) bucket, K1 and K3a inside; answers equal the eager
    entry's to the bit, and traffic after the warm-up only replays.

    A request's answer takes its batch's shapes (the row count and
    length, its place in a packed row), and the engine batches what has
    arrived when its worker polls: both runs must batch the burst
    alike, so each lingers (``batch_wait_ms``) until the burst is in
    and serves it as one batch."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                      bert_serving_entry)
    from mxnet_tpu_torch.serving import ServingEngine

    net = BERTModel(vocab_size=120, units=64, hidden_size=128,
                    num_layers=2, num_heads=4, max_length=64, dropout=0.0,
                    attention_dropout=0.0, use_pooler=False, device=cuda,
                    seed=3)
    rng = np.random.RandomState(0)
    reqs = [rng.randint(1, 120, n).astype(np.int32)
            for n in (3, 9, 17, 30, 5, 12, 40, 7)]
    answers, snaps, batches = [], [], []
    for hybrid in (False, True):
        eng = ServingEngine(bert_serving_entry(net, hybridize=hybrid),
                            device=cuda, bucket_lens=(16, 64), max_rows=4,
                            pool="mean", batch_wait_ms=2000)
        with eng:
            eng.warmup()
            warm = eng.snapshot()["compile_cache"]
            b0 = eng.snapshot()["counters"].get("batches", 0)
            futs = [eng.submit(t) for t in reqs]
            answers.append([f.result(timeout=120) for f in futs])
            snap = eng.snapshot()
        batches.append((snap["counters"]["batches"] - b0,
                        snap["last_batch"]["requests"]))
        snaps.append((warm, snap["compile_cache"]))
        net.hybridize(False)
    assert batches == [(1, len(reqs))] * 2
    for a, b in zip(answers[1], answers[0]):
        assert np.array_equal(a, b)
    (_, eager), (warm, graphed) = snaps
    assert eager["miss"] == 0 and warm["miss"] > 0
    assert graphed["miss"] == warm["miss"]


@pytest.mark.cuda
def test_graph_chain_steps_match_single_steps(cuda):
    """``engine.chain_steps`` on the card: 4 momentum-SGD steps captured
    as one graph; two chained calls equal 8 single steps to the bit, a
    donated carry is updated in place."""
    from mxnet_tpu_torch.engine import chain_steps

    def step(w, b, mw, mb, x, y):
        w_, b_ = (w.detach().requires_grad_(True),
                  b.detach().requires_grad_(True))
        with torch.enable_grad():
            loss = ((x @ w_ + b_ - y) ** 2).mean()
            gw, gb = torch.autograd.grad(loss, (w_, b_))
        mw, mb = 0.9 * mw + gw, 0.9 * mb + gb
        return w - 0.05 * mw, b - 0.05 * mb, mw, mb, loss.detach()

    rng = np.random.RandomState(0)
    t = lambda *s: torch.tensor(rng.rand(*s), dtype=torch.float32,  # noqa
                                device=cuda)
    args = [t(64, 32), t(32), torch.zeros(64, 32, device=cuda),
            torch.zeros(32, device=cuda), t(128, 64), t(128, 32)]
    carry = [a.clone() for a in args[:4]]
    for _ in range(8):
        *carry, loss = step(*carry, *args[4:])
    chained = chain_steps(step, 4, donate_argnums=(0, 1, 2, 3))
    out = chained(*args)
    w_buf = out[0]
    out = chained(*out[:4], *args[4:])
    torch.cuda.synchronize()
    assert out[0] is w_buf
    for a, c in zip(out, (*carry, loss)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_graph_remat_resnet_matches_plain(cuda):
    """A small ResNet with ``remat_stages=(2, 3)``, hybridized on the
    card: the recompute is captured in the backward graph; loss,
    gradients and running statistics as the same model's without
    remat (1e-5 of scale: the recompute centres BatchNorm's variance
    on the updated running mean)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    rng = np.random.RandomState(1)
    x = torch.tensor(rng.rand(8, 3, 32, 32), dtype=torch.float32,
                     device=cuda)
    y = torch.tensor(rng.randint(0, 4, 8), dtype=torch.float32, device=cuda)
    runs = []
    for stages in ((), (2, 3)):
        net = resnet.ResNetV1(resnet.BasicBlockV1, [1, 1, 1, 1],
                              [8, 8, 16, 32, 64], classes=4,
                              remat_stages=stages, device=cuda)
        net.initialize(init="xavier", seed=3)
        net.hybridize()
        for _ in range(2):
            with autograd.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
            autograd.backward(loss)
        runs.append((loss.detach(), {n: (p.grad if p.requires_grad else p)
                                     .detach().clone()
                                     for n, p in net.gluon_params().items()}))
    (l0, g0), (l1, g1) = runs
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-6)
    for n in g0:
        scale = g0[n].abs().max().item() or 1.0
        assert (g1[n] - g0[n]).abs().max().item() <= 1e-5 * scale, n


@pytest.mark.cuda
def test_graph_dropout_draws_new_masks_and_follows_the_seed(cuda):
    """Dropout inside a graph: each replay draws a new mask, and
    ``mx.random.seed`` after the capture makes the replays repeat."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=64, device=cuda), nn.Dropout(0.5))
    net.initialize(seed=1)
    net.hybridize()
    x = torch.ones(16, 64, device=cuda)

    def masks(n):
        out = []
        for _ in range(n):
            with autograd.train_mode():
                out.append((net(x) == 0).clone())
        return out

    masks(1)                                   # the capture
    a = masks(3)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    mx.random.seed(7)
    b = masks(2)
    mx.random.seed(7)
    c = masks(2)
    assert all(torch.equal(u, v) for u, v in zip(b, c))


@pytest.mark.cuda
def test_graph_batchnorm_statistics_after_replays_equal_eager(cuda):
    """``HybridSequential(Dense, BatchNorm, Activation, Dense)``: after
    five recorded calls and two predict calls on new inputs, the
    running statistics updated inside the graph at every replay equal
    the eager block's write-backs to the bit, and so do the outputs."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    def build():
        net = nn.HybridSequential()
        net.add(nn.Dense(64, in_units=32, device=cuda),
                nn.BatchNorm(in_channels=64, device=cuda),
                nn.Activation("relu"), nn.Dense(8, in_units=64,
                                                device=cuda))
        net.initialize(seed=4)
        return net

    rng = np.random.RandomState(2)
    xs = [torch.tensor(rng.randn(16, 32), dtype=torch.float32,
                       device=cuda) for _ in range(7)]
    runs = []
    for graphed in (False, True):
        net = build()
        if graphed:
            net.hybridize()
        outs = []
        for i, x in enumerate(xs):
            if i < 5:
                with autograd.record():
                    out = net(x)
                out.backward(torch.ones_like(out))
            else:
                out = net(x)
            outs.append(out.detach().clone())
        bn = net[1]
        runs.append((outs, bn.running_mean.detach().clone(),
                     bn.running_var.detach().clone()))
    (oe, me, ve), (og, mg, vg) = runs
    assert not torch.equal(me, torch.zeros_like(me))
    assert torch.equal(mg, me) and torch.equal(vg, ve)
    for a, b in zip(og, oe):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_capture_keeps_other_threads_launches(cuda):
    """Another thread launches K3a eagerly, on its own stream, while this
    one warms up, captures and replays a hybridized K3a block: every
    launch of both counts once (the warm-up's and the capture's are not
    launches that ran)."""
    import threading

    from mxnet_tpu_torch.ndarray import op_impl_nn

    x = torch.randn(64, 256, device=cuda)
    g, b = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    block = _op_block(lambda x, g, b: op_impl_nn.layer_norm(x, g, b))
    block.hybridize()
    stop, theirs = threading.Event(), [0]

    def other():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            while not stop.is_set() or theirs[0] < 100:
                ln.layer_norm_fused(x, g, b)
                theirs[0] += 1
            torch.cuda.synchronize()

    before = launch_counts()["layer_norm"]
    t = threading.Thread(target=other)
    t.start()
    for _ in range(20):
        block(x, g, b)
    stop.set()
    t.join()
    torch.cuda.synchronize()
    (entry,) = block._cached_graph.values()
    assert entry.instances[0].fwd.launches == {"layer_norm": 1}
    assert launch_counts()["layer_norm"] - before == theirs[0] + 20


@pytest.mark.cuda
def test_graph_dropped_recorded_entry_frees_its_memory(cuda, monkeypatch):
    """With the bound at one recorded entry, a second training shape
    drops the first entry: the memory held afterwards is the second
    entry's alone, not both."""
    import gc

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import block as blk
    from mxnet_tpu_torch.gluon import nn

    monkeypatch.setattr(blk, "_RECORDED_KEYS", 1)
    net = nn.HybridSequential()
    for _ in range(4):
        net.add(nn.Dense(1024, in_units=1024, device=cuda),
                nn.Activation("tanh"))
    net.initialize(seed=1)
    net.hybridize()

    def held(rows):
        with autograd.record():
            out = net(torch.ones(rows, 1024, device=cuda))
        out.backward(torch.ones_like(out))
        del out
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(cuda)

    base = torch.cuda.memory_allocated(cuda)
    one = held(4096) - base
    two = held(4095) - base
    assert len(net._cached_graph) == 1
    # at least the four saved tanh outputs of 16 MiB each
    assert one > 4 * 4096 * 1024 * 4 and two < 1.5 * one, (one, two)


# -- the Wide&Deep / row_sparse slice (no port kernel: torch's own) ----------
def _sparse_calls(ctx, seed=0):
    """The sparse ops of ``ndarray.sparse`` and the local store on one
    context, at small widths; their results as CPU tensors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp

    rs = np.random.RandomState(seed)
    dense = np.zeros((300, 8), np.float32)
    dense[rs.choice(300, 90, replace=False)] = rs.randn(90, 8)
    batch = np.zeros((32, 500), np.float32)
    for r in range(32):
        batch[r, rs.choice(500, 6, replace=False)] = rs.rand(6) + 0.1
    out = {}
    with ctx:
        x = mx.nd.array(dense)
        rsp, csr = x.tostype("row_sparse"), x.tostype("csr")
        out["rsp_back"], out["csr_back"] = rsp.todense(), csr.todense()
        out["retain"] = sp.retain(rsp, np.arange(0, 300, 7)).todense()
        c = sp.csr_matrix(batch)
        out["dot"] = sp.dot(c, mx.nd.array(rs.randn(500, 3)))
        out["dot_t"] = sp.dot(c, mx.nd.array(rs.randn(32, 3)),
                              transpose_a=True)
        kv = mx.kv.create("local")
        kv.init("t", x)
        dst = sp.zeros("row_sparse", (300, 8))
        kv.row_sparse_pull("t", out=dst,
                           row_ids=mx.nd.array(rs.randint(0, 300, 200)))
        out["pull"] = dst.todense()
    return {k: v.detach().cpu() for k, v in out.items()}


@pytest.mark.cuda
def test_sparse_ops_on_the_card_match_the_cpu(cuda):
    card = _sparse_calls(_ctx(cuda))
    cpu = _sparse_calls(_ctx(None))
    again = _sparse_calls(_ctx(cuda))
    for k in card:
        assert torch.equal(card[k], again[k]), k
        if k.startswith("dot"):
            assert (card[k] - cpu[k]).abs().max() <= 1e-6 * \
                cpu[k].abs().max(), k
        else:
            assert torch.equal(card[k], cpu[k]), k


def _ctx(dev):
    import mxnet_tpu_torch as mx
    return mx.cpu() if dev is None else mx.gpu(dev.index or 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_states,kw", [
    ("sgd_update_rsp", 0, dict(lr=0.1, wd=0.01)),
    ("sgd_mom_update_rsp", 1, dict(lr=0.1, momentum=0.9)),
    ("adam_update_rsp", 2, dict(lr=0.01, wd=0.01)),
    ("adagrad_update_rsp", 1, dict(lr=0.1)),
])
def test_sparse_rsp_updates_on_the_card_match_the_cpu(cuda, name, n_states,
                                                      kw):
    from mxnet_tpu_torch.ndarray import sparse as sp

    rs = np.random.RandomState(1)
    w0 = rs.randn(1000, 16).astype(np.float32)
    states = [rs.rand(1000, 16).astype(np.float32) for _ in range(n_states)]
    rows = np.sort(rs.choice(1000, 300, replace=False))
    g = rs.randn(300, 16).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        w = torch.tensor(w0, device=dev)
        st = [torch.tensor(s, device=dev) for s in states]
        grad = sp.row_sparse_array((g, rows), shape=(1000, 16), ctx=dev)
        getattr(sp, name)(w, grad, *st, **kw)
        res.append([t.cpu() for t in [w] + st])
    for a, b in zip(*res):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    untouched = np.setdiff1d(np.arange(1000), rows)
    assert torch.equal(res[0][0][untouched], torch.tensor(w0[untouched]))


@pytest.mark.cuda
def test_sparse_segment_sum_repeats_bit_for_bit_under_collisions(cuda):
    """The tables' gradient: 8192 ids all on one row (torch's own
    embedding backward gives new bits each call there)."""
    from mxnet_tpu_torch.ndarray.op_impl_basic import segment_sum

    g = torch.randn(8192, 16, device=cuda)
    ids = torch.zeros(8192, dtype=torch.int64, device=cuda)
    first = segment_sum(g, ids, 2)
    for _ in range(5):
        assert torch.equal(segment_sum(g, ids, 2), first)
    want = g.double().sum(0)
    assert (first[0].double() - want).abs().max() <= 1e-3
    assert first[1].abs().max() == 0


@pytest.mark.cuda
def test_sparse_wide_deep_captured_step_matches_eager(cuda):
    """A Wide & Deep step hybridized (forward and backward graphs)
    against the same model eager: the same losses and weights to the bit
    over 4 Adam steps, one capture pair, no port kernel."""
    from mxnet_tpu_torch import graphs
    from mxnet_tpu_torch.examples import wide_deep as ex

    batch = ex.synthetic_batch(256, 2000, 300, 3, cuda)
    runs = []
    before = dict(launch_counts())
    for hybridize in (False, True):
        net, loss_fn, trainer = ex.build(cuda, 2000, 300, seed=3,
                                         hybridize=hybridize)
        c0 = graphs.captures()
        losses = [ex.train_step(net, loss_fn, trainer, batch)[1]
                  .double().mean().item() for _ in range(4)]
        runs.append((losses, {k: p.data().clone() for k, p in
                              net.collect_params().items()},
                     graphs.captures() - c0))
    (le, we, ce), (lg, wg, cg) = runs
    assert ce == 0 and cg == 2
    assert le == lg
    assert all(torch.equal(we[k], wg[k]) for k in we)
    assert dict(launch_counts()) == before


def _sym_lm(vocab, emb, hid, layers, bptt):
    """The symbolic word LM (``chip_smoke.py`` phase 17's graph):
    Embedding -> RNN (lstm) -> Reshape -> FullyConnected ->
    SoftmaxOutput, the final states as BlockGrad outputs."""
    import mxnet_tpu_torch as mx

    with mx.name.NameManager():
        e = mx.sym.Embedding(mx.sym.var("data"), input_dim=vocab,
                             output_dim=emb, name="embed")
        r = mx.sym.RNN(e, state_size=hid, num_layers=layers, mode="lstm",
                       state_outputs=True, name="lstm")
        flat = mx.sym.Reshape(r[0], shape=(-1, hid), name="flat")
        fc = mx.sym.FullyConnected(flat, num_hidden=vocab, name="decoder")
        out = mx.sym.SoftmaxOutput(fc, mx.sym.var("softmax_label"),
                                   grad_scale=1.0 / bptt, name="softmax")
        return mx.sym.Group([out, mx.sym.BlockGrad(r[1], name="h"),
                             mx.sym.BlockGrad(r[2], name="c")])


def _sym_lm_bind(cuda, seed=0, vocab=200, emb=32, hid=32, layers=2,
                 bptt=7, batch=4):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size

    sym = _sym_lm(vocab, emb, hid, layers, bptt)
    shapes = dict(data=(bptt, batch), softmax_label=(bptt * batch,),
                  lstm_parameters=(rnn_param_size(layers, emb, hid, False,
                                                  "lstm"),),
                  lstm_state=(layers, batch, hid),
                  lstm_state_cell=(layers, batch, hid))
    req = {n: ("null" if n in ("data", "softmax_label", "lstm_state",
                               "lstm_state_cell") else "write")
           for n in sym.list_arguments()}
    ex = sym.simple_bind(mx.gpu(0), grad_req=req, **shapes)
    rng = np.random.RandomState(seed)
    for n, a in ex.arg_dict.items():
        if req[n] == "write":
            a[:] = torch.tensor(rng.uniform(-0.1, 0.1, tuple(a.shape)),
                                dtype=torch.float32)
    return ex, req


def _sym_lm_batch(rng, vocab=200, bptt=7, batch=4):
    x = rng.randint(0, vocab, (bptt, batch)).astype(np.float32)
    y = rng.randint(0, vocab, (bptt * batch,)).astype(np.float32)
    return x, y


@pytest.mark.cuda
def test_symbol_lm_graphs_match_the_eager_walk(cuda, monkeypatch):
    """The symbolic word LM bound on the card: three SGD steps of its
    forward and backward graphs (the final states carried into the
    next step in place) against the eager walk
    (``MXNET_TPU_SYMBOLIC_JIT=0``) from the same weights: the same
    outputs, gradients and weights to the bit, 2 + 2 + 2 LSTM launches a
    step each way, one capture pair, in the first step only."""
    from mxnet_tpu_torch import graphs, optimizer

    runs = []
    for jit in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_SYMBOLIC_JIT", jit)
        ex, req = _sym_lm_bind(cuda)
        upd = optimizer.get_updater(optimizer.create("sgd",
                                                     learning_rate=0.5))
        rng = np.random.RandomState(1)
        outs, counts, caps = [], [], []
        for _ in range(3):
            x, y = _sym_lm_batch(rng)
            before, c0 = dict(launch_counts()), graphs.captures()
            o = ex.forward(is_train=True, data=torch.tensor(x),
                           softmax_label=torch.tensor(y))
            ex.backward()
            for i, n in enumerate(n for n in ex.arg_dict
                                  if req[n] == "write"):
                upd(i, ex.grad_dict[n], ex.arg_dict[n])
            ex.arg_dict["lstm_state"][:] = o[1]
            ex.arg_dict["lstm_state_cell"][:] = o[2]
            torch.cuda.synchronize()
            after = launch_counts()
            counts.append({k: after[k] - before[k] for k in after
                           if after[k] != before[k]})
            caps.append(graphs.captures() - c0)
            outs.append([t.clone() for t in o] +
                        [g.clone() for g in ex.grad_dict.values()])
        runs.append((outs, counts, caps,
                     {n: a.clone() for n, a in ex.arg_dict.items()}))
    (og, cg, capg, wg), (oe, ce, cape, we) = runs
    assert capg == [2, 0, 0] and cape == [0, 0, 0]
    assert cg == ce == [{"lstm_fwd": 2, "lstm_bwd": 2,
                         "lstm_bwd_dw": 2}] * 3
    for a, b in zip(og, oe):
        assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert all(torch.equal(wg[n], we[n]) for n in we)


@pytest.mark.cuda
def test_symbol_predict_batches_match_the_eager_walk(cuda, monkeypatch):
    """``Module.predict`` on the card over three batches, unmerged and
    merged: every batch's outputs (copies out of the predict graph's
    static buffers) equal the eager walk's forward on that batch."""
    import mxnet_tpu_torch as mx

    def module(jit):
        monkeypatch.setenv("MXNET_TPU_SYMBOLIC_JIT", jit)
        with mx.name.NameManager():
            net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16,
                                        name="fc1")
            net = mx.sym.Activation(net, act_type="relu", name="relu")
            net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
            sym = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (8, 12))],
                 label_shapes=[("softmax_label", (8,))], for_training=False)
        rs = np.random.RandomState(2)
        mod.init_params(arg_params={
            n: mx.nd.array(rs.randn(*a.shape).astype(np.float32))
            for n, a in mod._exec.arg_dict.items()
            if n in mod._param_names})
        return mod

    rs = np.random.RandomState(3)
    x = rs.randn(24, 12).astype(np.float32)
    y = rs.randint(0, 10, 24).astype(np.float32)
    graphed, eager = module("1"), module("0")
    with mx.gpu(0):
        it = mx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
        per_batch = graphed.predict(it, merge_batches=False)
        merged = graphed.predict(it)
        want = eager.predict(it, merge_batches=False)
    assert len(per_batch) == len(want) == 3
    for (a,), (b,) in zip(per_batch, want):
        assert torch.equal(a, b)
    assert torch.equal(merged, torch.cat([b for (b,) in want]))


@pytest.mark.cuda
def test_symbol_in_place_updates_reach_the_graphs(cuda, monkeypatch):
    """``Module.update`` and ``BucketingModule``'s shared arrays on the
    card: three momentum-SGD steps alternating two buckets of an
    unrolled ``mx.rnn.LSTMCell``, graphed against the eager walk, give
    the same outputs and weights to the bit (each bucket's graphs read
    the one storage the updates write in place)."""
    import mxnet_tpu_torch as mx

    def gen(seq_len):
        with mx.name.NameManager():
            cell = mx.rnn.LSTMCell(num_hidden=8, prefix="lstm_")
            outs, _ = cell.unroll(seq_len, mx.sym.var("data"),
                                  layout="NTC", merge_outputs=False)
            fc = mx.sym.FullyConnected(outs[-1], num_hidden=2, name="fc")
            return (mx.sym.SoftmaxOutput(fc, name="softmax"), ["data"],
                    ["softmax_label"])

    runs = []
    for jit in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_SYMBOLIC_JIT", jit)
        mod = mx.mod.BucketingModule(gen, default_bucket_key=6,
                                     context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (4, 6, 3))],
                 label_shapes=[("softmax_label", (4,))])
        mx.random.seed(0)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        rs = np.random.RandomState(4)
        outs = []
        for blen in (6, 4, 6, 4):
            x = rs.randn(4, blen, 3).astype(np.float32)
            y = rs.randint(0, 2, 4).astype(np.float32)
            batch = mx.io.DataBatch(
                data=[mx.nd.array(x, ctx=mx.gpu(0))],
                label=[mx.nd.array(y, ctx=mx.gpu(0))], bucket_key=blen,
                provide_data=[("data", (4, blen, 3))],
                provide_label=[("softmax_label", (4,))])
            mod.forward_backward(batch)
            mod.update()
            outs.append(mod.get_outputs()[0].clone())
        b = mod._buckets
        assert b[4]._exec.arg_dict["fc_weight"] is \
            b[6]._exec.arg_dict["fc_weight"]
        runs.append((outs, {n: a.clone() for n, a in
                            b[6]._exec.arg_dict.items()}))
    (og, wg), (oe, we) = runs
    assert all(torch.equal(a, b) for a, b in zip(og, oe))
    assert all(torch.equal(wg[n], we[n]) for n in we)


@pytest.mark.cuda
def test_symbol_registry_ops_match_nd(cuda):
    """``sym.LayerNorm``, ``sym.flash_attention`` and
    ``sym.softmax_cross_entropy`` in one graph bound on the card: its
    forward and backward give the ``nd`` calls' bits, with one launch
    of each kernel (K3a/K3b, K1/K2, K4a/K4b) each way."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    rng = np.random.RandomState(5)

    def t(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                            device=cuda)

    x, g, b = t((2, 16, 64)), t((64,), 0.5, 1.5), t((64,))
    q, k, v = (t((2, 4, 16, 16)) for _ in range(3))
    vl = torch.tensor([16, 9], dtype=torch.int32, device=cuda)
    logits = t((40, 100), -3, 3)
    lab = torch.tensor(rng.randint(0, 100, 40), dtype=torch.float32,
                       device=cuda)
    with mx.name.NameManager():
        v_ = {n: mx.sym.var(n) for n in ("x", "g", "b", "q", "k", "v", "vl",
                                         "logits", "lab")}
        sym = mx.sym.Group([
            mx.sym.LayerNorm(v_["x"], v_["g"], v_["b"], eps=1e-12,
                             name="ln"),
            mx.sym.flash_attention(v_["q"], v_["k"], v_["v"], v_["vl"],
                                   name="att"),
            mx.sym.softmax_cross_entropy(v_["logits"], v_["lab"],
                                         name="xent")])
    args = dict(x=x, g=g, b=b, q=q, k=k, v=v, vl=vl, logits=logits, lab=lab)
    req = {n: "null" if n in ("vl", "lab") else "write" for n in args}
    ex = sym.bind(mx.gpu(0), {n: a.clone().as_subclass(nd.NDArray)
                              for n, a in args.items()}, grad_req=req)
    heads = None
    for _ in range(2):                   # the capture, then a replay
        before = dict(launch_counts())
        outs = ex.forward(is_train=True)
        if heads is None:
            heads = [t(tuple(o.shape)) for o in outs]
        ex.backward(heads)
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k_: after[k_] - before[k_] for k_ in after
                if after[k_] != before[k_]} == {
            "layer_norm": 1, "layer_norm_bwd": 1, "flash_attention": 1,
            "flash_attention_bwd": 1, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}
    leaves = {n: a.clone().requires_grad_(req[n] == "write")
              for n, a in args.items()}
    with autograd.record():
        want = [nd.LayerNorm(leaves["x"], leaves["g"], leaves["b"],
                             eps=1e-12),
                nd.flash_attention(leaves["q"], leaves["k"], leaves["v"],
                                   leaves["vl"]),
                nd.softmax_cross_entropy(leaves["logits"], leaves["lab"])]
    torch.autograd.backward(want, heads)
    for o, w in zip(outs, want):
        assert torch.equal(o.as_subclass(torch.Tensor), w.detach())
    for n in args:
        if req[n] == "write":
            assert torch.equal(ex.grad_dict[n].as_subclass(torch.Tensor),
                               leaves[n].grad), n


# -- custom ops, GRU and vanilla RNN, CTC, the optimizers ---------------------
def _register_custom_sqr():
    import mxnet_tpu_torch as mx

    if "card_sqr" in mx.operator.get_all_registered_operators():
        return

    @mx.operator.register("card_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sqr(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.5 * out_grad[0] * in_data[0])

            return Sqr()

    @mx.operator.register("card_host_read")
    class HostProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Host(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    scale = float(in_data[0].asnumpy().max())
                    self.assign(out_data[0], req[0], in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])

            return Host()


@pytest.mark.cuda
def test_custom_op_hybridized_graphs_match_eager(cuda):
    """A hybridized block holding a ``Custom`` op: its forward and the
    user's backward captured into the block's graphs and replayed on
    new inputs give the eager block's outputs and gradients bit for
    bit; a callback that reads the host raises ``MXNetError`` naming
    the op type at capture."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    _register_custom_sqr()

    class Net(HybridBlock):
        def __init__(self, op_type, **kw):
            super().__init__(**kw)
            self.op_type = op_type
            with self.name_scope():
                self.fc = nn.Dense(16, in_units=8, device=cuda)

        def hybrid_forward(self, F, x):
            return F.Custom(self.fc(x), op_type=self.op_type)

    eager, graphed = Net("card_sqr"), Net("card_sqr")
    eager.initialize(seed=1)
    graphed.initialize(seed=1)
    graphed.hybridize()
    rng = np.random.RandomState(2)
    for _ in range(3):
        x = torch.tensor(rng.randn(4, 8).astype(np.float32), device=cuda)
        res = []
        for net in (eager, graphed):
            xx = x.clone().requires_grad_()
            net.zero_grad()
            with autograd.record():
                y = net(xx)
            (y * y).sum().backward()
            res.append((y.detach(), xx.grad, net.fc.weight.grad.clone()))
        for a, b in zip(*res):
            assert torch.equal(a, b)
    assert len(graphed._cached_graph) == 1
    host = Net("card_host_read")
    host.initialize(seed=1)
    host.hybridize()
    with pytest.raises(mx.MXNetError, match="card_host_read"):
        host(torch.ones(2, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gru", "rnn_tanh", "rnn_relu"])
# float32: cuDNN's cells differ from torch's CPU cells by up to ~3e-5 of
# scale (an H100, TF32 off), as phase 9 holds the LSTM LM within 1e-4
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_gru_and_vanilla_rnn_on_the_card_match_the_cpu(cuda, mode, dtype,
                                                       tol):
    """The ``RNN`` op's GRU and vanilla modes (cuDNN through torch), 2
    bidirectional layers: outputs, final states and every gradient on
    the card within ``tol`` of scale of the CPU's; a repeat bit for
    bit; no port kernel launched."""
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.ndarray import op_impl_rnn

    resolve_device(cuda)        # the port's precision: no TF32 in cuDNN
    t_, n_, i_, h_, l_ = 7, 5, 12, 16, 2
    rng = np.random.RandomState(3)
    size = op_impl_rnn.rnn_param_size(l_, i_, h_, True, mode)
    arrays = [rng.randn(t_, n_, i_), rng.randn(size) * 0.3,
              rng.randn(2 * l_, n_, h_) * 0.5]
    wo = rng.randn(t_, n_, 2 * h_)

    def run(device):
        leaves = [torch.tensor(a, dtype=dtype, device=device,
                               requires_grad=True) for a in arrays]
        out, h = op_impl_rnn.rnn(*leaves, state_size=h_, num_layers=l_,
                                 bidirectional=True, mode=mode)
        ((out * torch.tensor(wo, dtype=dtype, device=device)).sum()
         + (h * h).sum()).backward()
        return [t.detach().cpu() for t in (out, h)] + \
            [x.grad.cpu() for x in leaves]

    before = dict(launch_counts())
    got, again, want = run(cuda), run(cuda), run("cpu")
    assert launch_counts() == before
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert (a - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
def test_gru_layer_hybridized_matches_eager_bit_for_bit(cuda):
    """``gluon.rnn.GRU`` hybridized: the captured forward and backward
    (cuDNN's RNN inside the graphs) give the eager layer's output and
    gradients to the bit, over three calls."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import rnn

    nets = [rnn.GRU(32, num_layers=2, input_size=16, device=cuda)
            for _ in range(2)]
    for net in nets:
        net.initialize(seed=4)
    nets[1].hybridize()
    rng = np.random.RandomState(4)
    for _ in range(3):
        x = torch.tensor(rng.randn(6, 3, 16).astype(np.float32),
                         device=cuda)
        res = []
        for net in nets:
            net.zero_grad()
            with autograd.record():
                y = net(x)
            (y * y).sum().backward()
            res.append((y.detach(), net.l0_h2h_weight.grad.clone(),
                        net.l1_i2h_weight.grad.clone()))
        for a, b in zip(*res):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_on_the_card_matches_the_cpu(cuda, lengths):
    """``ctc_loss`` (the torch recursion) on the card: losses within
    1e-5 relative of the CPU's, the logits' gradients within 1e-4 of
    scale, an infeasible sample finite (~1e30)."""
    from mxnet_tpu_torch.ops import ctc

    rng = np.random.RandomState(5)
    t_, n_, c_, l_ = 30, 6, 20, 8
    logits = rng.randn(t_, n_, c_).astype(np.float32)
    labels = rng.randint(1, c_, (n_, l_)).astype(np.int32)
    labels[1, 5:] = 0
    labels[2, :] = [1, 1, 1, 1, 1, 1, 1, 1]
    in_lens = np.array([30, 28, 5, 30, 17, 30], np.int32)
    res = []
    for device in (cuda, "cpu"):
        x = torch.tensor(logits, device=device, requires_grad=True)
        kw = {}
        if lengths:
            kw = dict(input_lengths=torch.tensor(in_lens, device=device),
                      label_lengths=torch.tensor(
                          (labels > 0).sum(1), device=device))
        loss = ctc.ctc_loss(x, torch.tensor(labels, device=device), **kw)
        loss.sum().backward()
        res.append((loss.detach().cpu(), x.grad.cpu()))
    (lc, gc), (lh, gh) = res
    assert torch.isfinite(lc).all() and torch.isfinite(gc).all()
    assert ((lc - lh).abs() / lh.abs()).max().item() <= 1e-5
    assert (gc - gh).abs().max().item() <= 1e-4 * gh.abs().max().item()
    if lengths:
        assert lc[2].item() > 1e29


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9)), ("nag", dict(momentum=0.9)),
    ("adam", {}), ("adamw", {}), ("adagrad", {}), ("adadelta", {}),
    ("rmsprop", {}), ("rmsprop", dict(centered=True)), ("ftrl", {}),
    ("signum", dict(wd_lh=0.01)), ("lamb", {}),
    ("dcasgd", dict(momentum=0.9)), ("lbsgd", dict(momentum=0.9)),
    ("test", {}), ("sgd", dict(momentum=0.9, multi_precision=True)),
    ("adam", dict(multi_precision=True))])
def test_optimizer_updates_on_the_card_match_the_cpu(cuda, name, kw):
    """Three updates of two parameters through ``Updater.update_multi``
    on the card and the CPU: weights (float32 masters under
    ``multi_precision``, with bfloat16 weights) within 1e-6 of scale."""
    from mxnet_tpu_torch import optimizer

    mp = kw.get("multi_precision", False)
    dtype = torch.bfloat16 if mp else torch.float32
    rng = np.random.RandomState(6)
    shapes = ((24, 16), (40,))
    ws0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    out = []
    for device in (cuda, "cpu"):
        ws = [torch.tensor(w, device=device).to(dtype) for w in ws0]
        up = optimizer.get_updater(optimizer.create(
            name, learning_rate=0.01, wd=0.01, rescale_grad=0.5, **kw))
        for g in gs:
            up.update_multi([0, 1], [torch.tensor(x, device=device)
                                     .to(dtype) for x in g], ws)
        keep = [up.states[i][1] for i in range(2)] if mp else ws
        out.append([k.float().cpu() for k in keep])
    for a, b in zip(*out):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()


# ----------------------------------------------------------------------
# detection and vision contrib ops (no port kernel: torch ops on the card)
# ----------------------------------------------------------------------
def _anchors(device):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import ssd
    return ssd.anchors(mx, device)


def _smoke():
    """The repo root's ``chip_smoke.py``: SSD-300's seeded inputs
    (``multibox_labels``/``multibox_predictions``) and the detection
    ops' tie rule (``multibox_target_agree``/``nms_rows_agree``)."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


class _no_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any
    host read or synchronizing copy raises."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_detection_prior_and_iou_card_vs_cpu_without_host_reads(cuda):
    """SSD-300's 8732 anchors bit for bit; ``box_iou`` and
    ``bipartite_matching`` card against CPU; the prior and the IoU make
    no host read."""
    from mxnet_tpu_torch import nd
    cpu = _anchors(torch.device("cpu"))
    maps = [torch.zeros(1, 1, h, h, device=cuda) for h in (38, 19, 10)]
    with _no_sync():
        card = _anchors(cuda)
        nd.contrib.MultiBoxPrior(maps[0], sizes=(0.2, 0.3), clip=True)
    assert card.shape == (1, 8732, 4) and torch.equal(card.cpu(), cpu)
    lab = torch.tensor(_smoke().multibox_labels(3)[:, :, 1:])
    res = {}
    for dev in (cuda, torch.device("cpu")):
        a, l = cpu.to(dev), lab.to(dev)
        with _no_sync() if dev.type == "cuda" else contextlib.nullcontext():
            iou = nd.contrib.box_iou(a[0], l.reshape(-1, 4))
        rows, cols = nd.contrib.bipartite_matching(
            iou.reshape(-1, 32, 8)[:16].transpose(0, 1), threshold=0.1)
        res[dev.type] = (iou.cpu(), rows.cpu(), cols.cpu())
    assert torch.equal(res["cuda"][0], res["cpu"][0])
    assert torch.equal(res["cuda"][1], res["cpu"][1])
    assert torch.equal(res["cuda"][2], res["cpu"][2])


@pytest.mark.cuda
@pytest.mark.parametrize("mining", [3.0, -1.0])
def test_detection_multibox_target_card_vs_cpu(cuda, mining):
    """``MultiBoxTarget`` at SSD-300's training shapes (labels 32 x 8 x 5,
    class predictions 32 x 21 x 8732) card against CPU under the tie
    rule (``chip_smoke.multibox_target_agree``), no host read on the
    card."""
    from mxnet_tpu_torch import nd
    smoke = _smoke()
    cpu = torch.device("cpu")
    anchors = _anchors(cpu)
    lab = smoke.multibox_labels(4)
    logits, _ = smoke.multibox_predictions(4, anchors.shape[1])
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=mining,
              negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2))
    out = {}
    for dev in (cuda, cpu):
        args = [anchors.to(dev), torch.tensor(lab, device=dev),
                torch.tensor(logits, device=dev)]
        with _no_sync() if dev.type == "cuda" else contextlib.nullcontext():
            res = nd.contrib.MultiBoxTarget(*args, **kw)
        out[dev.type] = [r.cpu().numpy() for r in res]
    differ, ties, gap = smoke.multibox_target_agree(
        out["cuda"], out["cpu"], anchors.numpy(), lab)
    assert differ == ties and gap <= 1e-5
    assert (out["cpu"][2] > 0).sum() >= 32          # every image matched


@pytest.mark.cuda
def test_detection_stable_sorts_keep_ties_in_index_order(cuda):
    """Tied scores and tied hardness: the card's stable sorts rank as the
    CPU's (``box_nms`` topk and order, mining's ranks)."""
    from mxnet_tpu_torch import nd
    rs = np.random.RandomState(5)
    n = 3000
    xy = rs.rand(2, n, 2).astype(np.float32)
    boxes = np.concatenate([xy, xy + 0.05], -1)
    scores = (rs.randint(0, 4, (2, n, 1)) / 4).astype(np.float32)
    data = np.concatenate([np.zeros((2, n, 1), np.float32), scores, boxes],
                          -1)
    out = [nd.contrib.box_nms(torch.tensor(data, device=d), topk=500,
                              overlap_thresh=0.5).cpu()
           for d in (cuda, "cpu")]
    assert torch.equal(out[0], out[1])
    anchors = torch.tensor(boxes[:1])
    lab = torch.tensor([[[0, 0.1, 0.1, 0.3, 0.3]]], dtype=torch.float32)
    cls = torch.zeros(1, 3, n)            # every hardness the same
    res = [nd.contrib.MultiBoxTarget(anchors.to(d), lab.to(d), cls.to(d),
                                     negative_mining_ratio=3.0)[2].cpu()
           for d in (cuda, "cpu")]
    assert torch.equal(res[0], res[1])


@pytest.mark.cuda
@pytest.mark.parametrize("topk,images", [(400, 32), (-1, 4)])
def test_detection_multibox_detection_card_vs_cpu(cuda, topk, images):
    """``MultiBoxDetection`` at SSD-300's deploy settings (threshold 0.01,
    NMS 0.45) over 8732 anchors, top 400 and the full N (all valid
    rows, on 4 images: the CPU's reference takes ~1 s an image), card
    against CPU under the tie rule."""
    from mxnet_tpu_torch import nd
    smoke = _smoke()
    cpu = torch.device("cpu")
    anchors = _anchors(cpu)
    logits, loc = smoke.multibox_predictions(6, anchors.shape[1])
    prob = torch.softmax(torch.tensor(logits[:images]), 1)
    out = [nd.contrib.MultiBoxDetection(
        prob.to(d), torch.tensor(loc[:images], device=d), anchors.to(d),
        threshold=0.01, nms_threshold=0.45, nms_topk=topk).cpu().numpy()
        for d in (cuda, cpu)]
    _, gap = smoke.nms_rows_agree(out[0], out[1], 0.45)  # or raises
    kept = (out[1][:, :, 0] >= 0).sum(1)
    assert (kept > 0).all() and (topk < 0 or (kept <= topk).all())
    assert gap <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"id_index": 0, "topk": 50},
                                {"force_suppress": True,
                                 "in_format": "center",
                                 "out_format": "corner"}])
def test_detection_box_nms_card_vs_cpu(cuda, kw):
    from mxnet_tpu_torch import nd
    rs = np.random.RandomState(7)
    n = 2000
    xy = rs.rand(4, n, 2) * 0.8
    data = np.concatenate([rs.randint(0, 5, (4, n, 1)), rs.rand(4, n, 1),
                           xy, xy + rs.rand(4, n, 2) * 0.2 + 0.01],
                          -1).astype(np.float32)
    out = [nd.contrib.box_nms(torch.tensor(data, device=d),
                              overlap_thresh=0.4, **kw).cpu().numpy()
           for d in (cuda, "cpu")]
    differ, gap = _smoke().nms_rows_agree(out[0], out[1], 0.4)
    assert differ == 0 and gap == 0.0


def _detect_inputs(seed, images, device):
    """SSD-300's anchors with seeded class logits and box offsets for
    ``images`` images."""
    anchors = _anchors(device)
    logits, loc = _smoke().multibox_predictions(seed, anchors.shape[1])
    return (anchors, torch.tensor(logits[:images], device=device),
            torch.tensor(loc[:images], device=device))


@pytest.mark.cuda
def test_detection_hybridized_block_with_nms_runs_eagerly_on_the_card(cuda):
    """A hybridized block whose forward runs NMS (``MultiBoxDetection``
    and ``box_nms``, as GluonCV's SSD does at inference) on the card:
    its warm-up finds NMS's host reads, so no graph is captured and the
    key runs eagerly, equal bit for bit at every call to the same block
    not hybridized; a block without NMS still captures."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, graphs

    class Detect(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.head = gluon.nn.Dense(21, in_units=21, flatten=False)

        def hybrid_forward(self, F, cls, loc, anchors):
            logits = F.transpose(self.head(F.transpose(cls, (0, 2, 1))),
                                 (0, 2, 1))
            det = F.contrib.MultiBoxDetection(
                F.softmax(logits, axis=1), loc, anchors, threshold=0.01,
                nms_threshold=0.45, nms_topk=400)
            return det, F.contrib.box_nms(det, overlap_thresh=0.3,
                                          id_index=0, topk=100)

    anchors, logits, loc = _detect_inputs(9, 4, cuda)
    with mx.Context.of(cuda):
        net, ref = Detect(), Detect()
    for block in (net, ref):
        block.initialize()
    with torch.no_grad():
        for p, q in zip(net.parameters(), ref.parameters()):
            q.copy_(p)
    net.hybridize()
    c0 = graphs.captures()
    for scale in (1.0, 1.0, 0.5, 1.0):
        got = net(logits * scale, loc, anchors)
        want = ref(logits * scale, loc, anchors)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got[0][:, :, 0] >= 0).sum() > 0
    assert graphs.captures() == c0
    plain = gluon.nn.Dense(8, in_units=5, device=cuda)
    plain.initialize()
    plain.hybridize()
    plain(torch.ones(2, 5, device=cuda))
    assert graphs.captures() == c0 + 1


@pytest.mark.cuda
def test_detection_executor_binds_multibox_ops_on_the_card(cuda):
    """``mx.sym.contrib.MultiBoxPrior/Target/Detection`` and ``box_nms``
    bound on the card through the executor: the prior and the target
    (no host read) capture a graph, the detection group runs its walk
    eagerly (NMS); each equals ``nd``'s on the card bit for bit at every
    forward, and the CPU's binding under the tie rule."""
    from mxnet_tpu_torch import graphs, nd, sym

    smoke = _smoke()
    feat, lab, cls, loc = (sym.var(n) for n in ("feat", "label", "cls",
                                                "loc"))
    anchors = sym.contrib.MultiBoxPrior(feat, sizes=(0.2, 0.272),
                                        ratios=(1.0, 2.0, 0.5),
                                        steps=(8 / 300, 8 / 300))
    target = sym.Group(list(sym.contrib.MultiBoxTarget(
        anchors, lab, cls, negative_mining_ratio=3.0)))
    det = sym.contrib.MultiBoxDetection(sym.softmax(cls, axis=1), loc,
                                        anchors, nms_threshold=0.45,
                                        nms_topk=400)
    det = sym.Group([det, sym.contrib.box_nms(det, overlap_thresh=0.3,
                                              id_index=0, topk=100)])
    rs = np.random.RandomState(10)
    n = 38 * 38 * 4
    arrays = {"feat": np.zeros((1, 8, 38, 38), np.float32),
              "label": smoke.multibox_labels(10, b=4),
              "cls": (rs.randn(4, 21, n) * 2).astype(np.float32),
              "loc": (rs.randn(4, n * 4) * 0.5).astype(np.float32)}
    cpu = torch.device("cpu")
    outs = {}
    for dev in (cuda, cpu):
        args = {k: nd.array(v, ctx=dev) for k, v in arrays.items()}
        a = nd.contrib.MultiBoxPrior(args["feat"], sizes=(0.2, 0.272),
                                     ratios=(1.0, 2.0, 0.5),
                                     steps=(8 / 300, 8 / 300))
        t = nd.contrib.MultiBoxTarget(a, args["label"], args["cls"],
                                      negative_mining_ratio=3.0)
        d = nd.contrib.MultiBoxDetection(nd.softmax(args["cls"], axis=1),
                                         args["loc"], a, nms_threshold=0.45,
                                         nms_topk=400)
        d2 = nd.contrib.box_nms(d, overlap_thresh=0.3, id_index=0, topk=100)
        ex_t = target.bind(dev, {k: args[k] for k in ("feat", "label",
                                                      "cls")})
        ex_d = det.bind(dev, {k: args[k] for k in ("feat", "cls", "loc")})
        c0 = graphs.captures()
        for _ in range(2):
            got_t = [o.asnumpy() for o in ex_t.forward()]
            got_d = [o.asnumpy() for o in ex_d.forward()]
            for g, w in zip(got_t + got_d, [*t, d, d2]):
                np.testing.assert_array_equal(g, w.asnumpy())
        # the CPU's entries stand for one capture each; on the card the
        # target's entry captures and the detection's runs eagerly
        assert graphs.captures() - c0 == (1 if dev.type == "cuda" else 2)
        outs[dev.type] = (got_t, got_d)
    anc = nd.contrib.MultiBoxPrior(nd.array(arrays["feat"], ctx=cpu),
                                   sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5),
                                   steps=(8 / 300, 8 / 300)).asnumpy()
    differ, ties, gap = smoke.multibox_target_agree(
        outs["cuda"][0], outs["cpu"][0], anc, arrays["label"])
    assert differ == ties and gap <= 1e-5
    for g, w in zip(outs["cuda"][1], outs["cpu"][1]):
        smoke.nms_rows_agree(g, w, 0.45)            # or raises


def _vision_cases(rs):
    from mxnet_tpu_torch import nd
    c = nd.contrib
    x = rs.randn(2, 16, 20, 24).astype(np.float32)
    rois = np.concatenate([rs.randint(0, 2, (64, 1)), rs.rand(64, 2) * 14,
                           rs.rand(64, 2) * 14 + 8], 1).astype(np.float32)
    rois[:, 3:] = np.maximum(rois[:, 3:], rois[:, 1:3] + 1)
    off = (rs.randn(2, 18, 20, 24) * 1.5).astype(np.float32)
    w = (rs.randn(8, 16, 3, 3) * 0.2).astype(np.float32)
    ps = rs.randn(2, 2 * 9, 20, 24).astype(np.float32)
    boxes = rs.rand(2, 50, 4).astype(np.float32)
    anc = np.concatenate([rs.rand(1, 50, 2), rs.rand(1, 50, 2) + 1.0],
                         -1).astype(np.float32)
    return {
        "ROIAlign": (lambda d, r: c.ROIAlign(d, r, (7, 7), 0.5), [x, rois]),
        "BilinearResize2D": (lambda d: c.BilinearResize2D(d, 33, 17), [x]),
        "AdaptiveAvgPooling2D": (
            lambda d: c.AdaptiveAvgPooling2D(d, (5, 7)), [x]),
        "box_decode": (lambda d, a: c.box_decode(d, a, clip=4.0),
                       [boxes, anc]),
        "DeformableConvolution": (
            lambda d, o, k: c.DeformableConvolution(
                d, o, k, kernel=(3, 3), pad=(1, 1), num_filter=8,
                no_bias=True), [x, off, w]),
        # integer corners: bins whose ends land on whole cells
        "PSROIPooling": (lambda d, r: c.PSROIPooling(
            d, r, 0.5, output_dim=2, pooled_size=3), [ps, np.round(rois)]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ROIAlign", "BilinearResize2D",
                                  "AdaptiveAvgPooling2D", "box_decode",
                                  "DeformableConvolution", "PSROIPooling"])
def test_detection_vision_ops_card_vs_cpu_without_host_reads(cuda, name):
    """Each vision contrib op forward and backward on the card against
    the CPU within 1e-5 of scale; forward and backward make no host
    read on the card."""
    rs = np.random.RandomState(8)
    fn, arrays = _vision_cases(rs)[name]
    cot = None
    res = []
    for dev in (torch.device("cpu"), cuda):     # the CPU's shape gives cot
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in arrays]
        cot_d = None if cot is None else cot.to(dev)
        with _no_sync() if dev.type == "cuda" else contextlib.nullcontext():
            out = fn(*ts)
            if cot_d is None:
                cot = cot_d = torch.tensor(
                    rs.randn(*out.shape).astype(np.float32))
            (out * cot_d).sum().backward()
        # an input the output does not differentiate through (PSROI's
        # ROIs: rounded corners) has no gradient: zeros
        res.append([out.detach().cpu()] + [
            (t.grad if t.grad is not None else torch.zeros_like(t)).cpu()
            for t in ts])
    for want, got in zip(*res):
        scale = max(want.abs().max().item(), 1e-12)
        assert (got - want).abs().max().item() <= 1e-5 * scale


# -- deployment: export and import, int8, control flow -------------------------
def _rel(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.cuda
def test_export_resnet_imports_on_the_card_equal_the_gluon_model(cuda,
                                                                 tmp_path):
    """``resnet18_v1`` exported on the card, then imported through a
    hybridized ``SymbolBlock`` and a ``Module`` there and on the CPU:
    each within 1e-5 of scale of the Gluon model; the graph's replay
    equal to its first call bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet18_v1(classes=10, prefix="resnetv10_", device=cuda)
    net.initialize(init=mx.init.Xavier(), seed=1)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with mx.autograd.train_mode():
        net(x.to(cuda) * 2)             # running statistics moved
    ref = net(x.to(cuda))
    path = str(tmp_path / "r18")
    sym_file, params_file = net.export(path)
    for dev in (cuda, torch.device("cpu")):
        ctx = mx.Context.of(dev)
        block = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                             ctx=ctx)
        block.hybridize()
        got = [block(x.to(dev)) for _ in range(2)]
        assert torch.equal(got[0], got[1])
        assert _rel(got[0], ref) <= 1e-5
        with ctx:
            sym, args, auxs = mx.model.load_checkpoint(path, 0)
        mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                            context=ctx)
        mod.bind(data_shapes=[("data", tuple(x.shape))], for_training=False)
        mod.set_params(args, auxs)
        mod.forward(mx.io.DataBatch(data=[x.to(dev)]), is_train=False)
        assert _rel(mod.get_outputs()[0], ref) <= 1e-5


@pytest.mark.cuda
def test_export_bert_graph_replays_on_k1_and_k3a(cuda, tmp_path):
    """A 2-layer BERT's graph on ``data``, ``token_types`` and
    ``valid_length``, imported and hybridized on the card: every replay
    launches flash attention (K1) once a layer and LayerNorm (K3a) 2 x
    layers + 1 times, and gives the model zoo's outputs within 1e-5 of
    scale."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs
    from mxnet_tpu_torch.gluon.model_zoo import bert

    net = bert.BERTModel(vocab_size=100, units=64, hidden_size=128,
                         num_layers=2, num_heads=4, max_length=64,
                         prefix="bertmodel0_", device=cuda, seed=2)
    rs = np.random.RandomState(2)
    ids = torch.tensor(rs.randint(0, 100, (3, 40)), device=cuda)
    types = torch.tensor(rs.randint(0, 2, (3, 40)), device=cuda)
    vl = torch.tensor([40.0, 17.0, 1.0], device=cuda)
    ref = net(ids, types, vl)
    names = ["data", "token_types", "valid_length"]
    graph = mx.sym.Group(list(net(*[mx.sym.var(n) for n in names])))
    graph.save(str(tmp_path / "b-symbol.json"))
    mx.nd.save(str(tmp_path / "b-0000.params"),
               {f"arg:{net.prefix}{k}": v.detach()
                for k, v in net.gluon_params().items()})
    block = mx.gluon.SymbolBlock.imports(
        str(tmp_path / "b-symbol.json"), names,
        str(tmp_path / "b-0000.params"), ctx=mx.Context.of(cuda))
    block.hybridize()
    block(ids, types, vl)
    c0 = graphs.captures()
    for _ in range(2):
        before = launch_counts()
        got = block(ids, types, vl)
        after = launch_counts()
        assert after["flash_attention"] - before["flash_attention"] == 2
        assert after["layer_norm"] - before["layer_norm"] == 5
        for g, w in zip(got, ref):
            assert _rel(g, w) <= 1e-5
    assert graphs.captures() == c0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (16, 13, 3), (17, 147, 64),
                                   (200, 2048, 1000), (4096, 576, 128)])
def test_quant_int8_gemm_on_the_card_equals_the_cpu(cuda, m, k, n):
    """cuBLASLt's int8 GEMM through ``int8_gemm``'s zero padding: exact
    int32 sums at every shape, padded or not."""
    from mxnet_tpu_torch.ndarray import op_impl_quant as quant

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    got = quant.int8_gemm(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), quant.int8_gemm(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel,stride,pad,dilate,groups", [
    ((4, 3, 64, 64), 7, 2, 3, 1, 1), ((2, 64, 28, 28), 3, 1, 1, 1, 1),
    ((2, 256, 14, 14), 1, 2, 0, 1, 1), ((2, 8, 13, 11), 3, 1, 2, 2, 4)])
def test_quant_int8_conv_on_the_card_equals_the_cpu(cuda, shape, kernel,
                                                    stride, pad, dilate,
                                                    groups):
    from mxnet_tpu_torch.ndarray import op_impl_quant as quant

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (16, shape[1] // groups, kernel, kernel),
                      dtype=torch.int8, generator=g)
    args = ((stride,) * 2, (pad,) * 2, (dilate,) * 2, groups)
    got = quant.int8_conv(x.to(cuda), w.to(cuda), *args)
    assert torch.equal(got.cpu(), quant.int8_conv(x, w, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("s8", [False, True])
def test_quant_net_on_the_card_equals_the_cpu(cuda, s8):
    """A conv net (BatchNorm folded, a Dense) quantized on the card and on
    the CPU from the same float weights and calibration batch: the int8
    codes, scales and biases bit for bit, the ranges within 1e-6
    relative (float activations of cuDNN and of the CPU); with the
    CPU's parameters the card's outputs within 1e-6 of scale; the
    hybridized net equal to eager bit for bit (a CUDA graph: the
    dynamic-range choice and the int8 products need no host read)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.gluon import nn

    def build(dev):
        net = nn.HybridSequential(prefix="q_")
        with net.name_scope():
            net.add(nn.Conv2D(16, 3, padding=1, use_bias=False,
                              in_channels=3, device=dev),
                    nn.BatchNorm(in_channels=16, device=dev),
                    nn.Activation("relu"),
                    nn.Conv2D(16, 3, padding=1, in_channels=16, device=dev),
                    nn.BatchNorm(in_channels=16, device=dev),
                    nn.Activation("relu"),
                    nn.Conv2D(8, 1, in_channels=16, device=dev),
                    nn.Dense(10, in_units=8 * 16 * 16, device=dev))
        net.initialize(init=mx.init.Xavier(), seed=3)
        return net

    g = torch.Generator().manual_seed(3)
    x = torch.rand(4, 3, 16, 16, generator=g)
    calib = torch.rand(4, 3, 16, 16, generator=g)
    nets, floats = [], None             # the CPU's, then the card's
    for dev in (torch.device("cpu"), cuda):
        net = build(dev)
        with mx.autograd.train_mode():
            net(x.to(dev) * 3)
        if floats is None:
            floats = {k: v.detach().cpu().numpy().copy()
                      for k, v in net.gluon_params().items()}
        else:                           # the CPU net's float weights
            net.load_gluon_params(floats)
        nets.append(tq.quantize_net(
            net, calib_data=[(calib.to(dev),)], s8_interfaces=s8))
    cpu_p = nets[0].gluon_params()
    for name, t in nets[1].gluon_params().items():
        want = cpu_p[name].detach()
        if name.endswith("act_amax"):
            assert _rel(t, want) <= 1e-6, name
        else:
            assert torch.equal(t.detach().cpu(), want), name
    card = nets[1]
    card.load_gluon_params({k: v.detach().numpy()
                            for k, v in cpu_p.items()})
    eager = card(x.to(cuda))
    assert _rel(eager, nets[0](x)) <= 1e-6
    card.hybridize()
    for _ in range(2):
        assert torch.equal(card(x.to(cuda)), eager)


@pytest.mark.cuda
def test_control_flow_on_the_card(cuda):
    """``foreach``, ``while_loop`` and ``cond`` on the card against the
    CPU within 1e-5 of scale; a hybridized block calling ``foreach``
    captures one graph, equal to eager bit for bit; one calling
    ``cond`` reads its predicate, so its key runs eagerly (no
    capture), also eager's bits."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs, nd

    rs = np.random.RandomState(4)
    data, h0 = rs.randn(6, 4, 8).astype(np.float32), \
        rs.randn(4, 8).astype(np.float32)

    def run(dev):
        d, h = torch.tensor(data, device=dev), torch.tensor(h0, device=dev)
        outs, st = nd.contrib.foreach(
            lambda x, s: (nd.tanh(x + s[0]), [nd.tanh(x + s[0])]), d, [h])
        _, loop = nd.contrib.while_loop(
            lambda i, s: i.sum() < 3, lambda i, s: (None, [i + 1, s * 2]),
            [torch.zeros(1, device=dev), h], max_iterations=5)
        br = nd.contrib.cond(lambda a: a.sum() < 0, lambda a: a - 1,
                             lambda a: a + 1, [h])
        return [outs, st[0], loop[1], br]

    for a, b in zip(run(cuda), run(torch.device("cpu"))):
        assert _rel(a, b) <= 1e-5

    class Scan(mx.gluon.HybridBlock):
        def __init__(self, use_cond):
            super().__init__(prefix="scan_")
            self._cond = use_cond

        def hybrid_forward(self, F, x, h):
            if self._cond:
                return F.contrib.cond(lambda a: a.sum() > 0,
                                      lambda a: a * 2, lambda a: -a, [h])
            return F.contrib.foreach(lambda x, s: (x * s, x + s), x, h)[0]

    d, h = torch.tensor(data, device=cuda), torch.tensor(h0, device=cuda)
    for use_cond, captures in ((False, 1), (True, 0)):
        block = Scan(use_cond)
        want = block(d, h)
        block.hybridize()
        c0 = graphs.captures()
        for _ in range(2):
            assert torch.equal(block(d, h), want)
        assert graphs.captures() - c0 == captures


# -- contrib.amp on the card (the kernels' operand types under AMP) -----------
@pytest.fixture
def amp_off():
    from mxnet_tpu_torch.contrib import amp
    yield amp
    amp.disable()
    assert not amp.is_initialized()


@pytest.mark.cuda
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_amp_bert_step_sends_half_to_k1_k2_and_float32_to_k3_k4(cuda,
                                                                amp_off,
                                                                half):
    """A 2-layer BERT + MLM head step under AMP: K1/K2 launch on the half
    type, K3a/K3b/K4a/K4b on float32 (``chip_smoke.launch_dtypes``),
    one launch a layer each; gradients float32 and finite."""
    from mxnet_tpu_torch.examples.bert_mlm import (build, synthetic_batch,
                                                   train_step)
    smoke = _smoke()
    net, head, _, trainer = build(cuda, vocab_size=1000, units=128,
                                  hidden_size=256, num_layers=2,
                                  num_heads=2, max_length=64)
    amp_off.init(half)
    amp_off.init_trainer(trainer)
    trainer._amp_loss_scaler._scale = 2.0 ** 10 \
        if half == "float16" else 1.0
    batch = synthetic_batch(0, 4, 32, 1000, cuda)
    before = launch_counts()
    with smoke.launch_dtypes() as seen:
        loss = train_step(net, head, trainer, batch)
    after = launch_counts()
    smoke.check_launch_dtypes("AMP step", seen, smoke.bert_amp_types(half))
    assert {k: after[k] - before[k] for k in smoke.bert_amp_types(half)} \
        == {"flash_attention": 2, "flash_attention_bwd": 2,
            "layer_norm": 6, "layer_norm_bwd": 6, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}
    assert loss.dtype == torch.float32 and torch.isfinite(loss).all()
    for p in trainer._params:
        g = p.grad()
        assert g.dtype == torch.float32 and torch.isfinite(g).all()


@pytest.mark.cuda
def test_amp_lstm_sends_bfloat16_to_k6(cuda, amp_off):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import rnn
    smoke = _smoke()
    net = rnn.LSTM(96, num_layers=2, layout="NTC", input_size=48,
                   device=cuda)
    x = torch.randn(8, 12, 48, device=cuda)
    amp_off.init("bfloat16")
    with smoke.launch_dtypes() as seen:
        with autograd.record():
            out = net(x)
        out.float().sum().backward()
    assert out.dtype == torch.bfloat16
    smoke.check_launch_dtypes("AMP LSTM", seen, {
        k: torch.bfloat16 for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw")})


@pytest.mark.cuda
def test_amp_float16_overflowed_step_is_skipped(cuda, amp_off):
    """An overflowed float16 step moves no weight and halves the scale;
    the next step's SGD update (linear in the unscaled gradient) equals
    the update at scale 1 from the same weights within 1e-3 of its
    scale: a power-of-two scale moves float16 values by whole
    exponents, so only values subnormal at scale 1 could differ."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(10, in_units=32, device=cuda)
    amp_off.init("float16")
    params = list(net.collect_params().values())
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    amp_off.init_trainer(trainer)
    x = torch.randn(16, 32, device=cuda)
    y = torch.randint(0, 10, (16,), device=cuda).float()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(scale):
        trainer._amp_loss_scaler._scale = scale
        w0 = [p.data().clone() for p in params]
        with autograd.record():
            loss = loss_fn(net(x), y)
        with amp_off.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
        trainer.step(16)
        return w0, [p.data().double() - w.double()
                    for p, w in zip(params, w0)]

    _, moved = step(2.0 ** 40)
    assert all(not d.any() for d in moved)
    assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 39
    w0, scaled = step(2.0 ** 8)
    assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 8
    for p, w in zip(params, w0):
        p.set_data(w)
    _, unit = step(1.0)
    for a, b in zip(scaled, unit):
        assert b.abs().max() > 0
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


@pytest.mark.cuda
def test_amp_state_keys_cached_op_and_executor_graphs(cuda, amp_off):
    """A hybridized block and a bound executor capture a graph for each
    AMP state on the card, and replay each state's own graph."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4, device=cuda))
    net.hybridize()
    x = torch.ones(2, 4, device=cuda)
    s = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                              no_bias=True, name="fc")
    ex = s.simple_bind(mx.gpu(0), data=(2, 6), fc_weight=(4, 6))
    seen = []
    c0 = graphs.captures()
    for state in ("off", "bfloat16", "off", "bfloat16"):
        if state == "off":
            amp_off.disable()
        else:
            amp_off.init(state)
        seen.append((net(x).dtype, ex.forward()[0].dtype))
    assert [a for a, _ in seen] == [torch.float32, torch.bfloat16] * 2
    assert [b for _, b in seen] == [torch.float32, torch.bfloat16] * 2
    # every switch bumps the generation the keys carry: each of the four
    # states captures one graph for the block and one for the executor
    assert graphs.captures() - c0 == 8


# -- the NumPy frontend on the card (np-mode reaches the same kernels) --------
@pytest.fixture
def np_off():
    from mxnet_tpu_torch import numpy_extension as npx
    yield npx
    npx.reset_np()
    assert not npx.is_np_array()


@pytest.mark.cuda
def test_numpy_mode_bert_step_launches_and_bits_equal_classic(cuda, np_off):
    """A 2-layer BERT + MLM head step under ``npx.set_np()`` on ``mx.np``
    arrays: the loss is an ``mx.np.ndarray``, K1/K2/K3a/K3b/K4a/K4b
    launch as in the classic step (one a layer each), and the loss and
    every gradient equal the classic step's bit for bit."""
    from mxnet_tpu_torch.examples.bert_mlm import (build, on_device,
                                                   synthetic_arrays,
                                                   train_step)
    runs = {}
    for mode in ("classic", "np"):
        if mode == "np":
            np_off.set_np()
        net, head, params, trainer = build(cuda, vocab_size=1000, units=128,
                                           hidden_size=256, num_layers=2,
                                           num_heads=2, max_length=64)
        batch = on_device(synthetic_arrays(0, 4, 32, 1000), cuda,
                          as_np=mode == "np")
        before = launch_counts()
        loss = train_step(net, head, trainer, batch, update=False)
        torch.cuda.synchronize()
        after = launch_counts()
        runs[mode] = (loss, {k: after[k] - before[k] for k in after},
                      {k: p.grad().as_subclass(torch.Tensor).clone()
                       for k, p in params.items()})
    assert type(runs["np"][0]).__name__ == "ndarray"
    assert runs["np"][1] == runs["classic"][1]
    assert {k: v for k, v in runs["np"][1].items() if v} == {
        "flash_attention": 2, "flash_attention_bwd": 2, "layer_norm": 6,
        "layer_norm_bwd": 6, "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    assert torch.equal(runs["np"][0].as_subclass(torch.Tensor),
                       runs["classic"][0].as_subclass(torch.Tensor))
    for k, g in runs["np"][2].items():
        assert torch.equal(g, runs["classic"][2][k]), k


@pytest.mark.cuda
def test_numpy_npx_rnn_and_layer_norm_reach_k6a_and_k3a(cuda, np_off):
    """``npx.rnn`` (LSTM) and ``npx.layer_norm`` on ``mx.np`` arrays on
    the card: one K6a and one K3a launch, results the registry ops'
    (``nd.RNN``, ``nd.LayerNorm``) bit for bit and within 1e-5 of
    scale of the plain versions."""
    import torch.nn.functional as F

    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import numpy as mnp
    from mxnet_tpu_torch import numpy_extension as npx
    rs = np.random.RandomState(4)
    t, n, h = 7, 3, 32
    x0 = rs.randn(t, n, h).astype("float32")
    wi, wh = (rs.randn(4 * h, h).astype("float32") / h ** 0.5
              for _ in range(2))
    bi, bh = (rs.randn(4 * h).astype("float32") * 0.1 for _ in range(2))
    h0, c0 = (rs.randn(1, n, h).astype("float32") for _ in range(2))
    packed = np.concatenate([wi.ravel(), wh.ravel(), bi, bh])
    kw = dict(state_size=h, num_layers=1, mode="lstm", state_outputs=True)
    before = launch_counts()
    got = npx.rnn(*(mnp.array(a, ctx=cuda) for a in (x0, packed, h0, c0)),
                  **kw)
    assert launch_counts()["lstm_fwd"] == before["lstm_fwd"] + 1
    assert all(type(g).__name__ == "ndarray" for g in got)
    want = nd.RNN(*(nd.array(a, ctx=cuda) for a in (x0, packed, h0, c0)),
                  **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.as_subclass(torch.Tensor),
                           w.as_subclass(torch.Tensor))
    xt, wit, wht, bit, bht = (torch.tensor(a, device=cuda)
                              for a in (x0, wi, wh, bi, bh))
    ref = lstm.lstm_forward_reference(F.linear(xt, wit, bit) + bht,
                                      wht.t(), torch.tensor(h0[0],
                                                            device=cuda),
                                      torch.tensor(c0[0], device=cuda))[0]
    out = got[0].as_subclass(torch.Tensor)
    assert (out - ref).abs().max() <= 1e-5 * max(ref.abs().max(), 1.0)
    lx = rs.randn(64, 768).astype("float32")
    lg, lb = (rs.randn(768).astype("float32") for _ in range(2))
    before = launch_counts()["layer_norm"]
    y = npx.layer_norm(*(mnp.array(a, ctx=cuda) for a in (lx, lg, lb)),
                       axis=-1, eps=1e-12)
    assert launch_counts()["layer_norm"] == before + 1
    assert type(y).__name__ == "ndarray"
    ty = nd.LayerNorm(*(nd.array(a, ctx=cuda) for a in (lx, lg, lb)),
                      axis=-1, eps=1e-12)
    assert torch.equal(y.as_subclass(torch.Tensor),
                       ty.as_subclass(torch.Tensor))
    ry = ln.layer_norm_reference(*(torch.tensor(a, device=cuda)
                                   for a in (lx, lg, lb)), 1e-12)
    yt = y.as_subclass(torch.Tensor)
    assert (yt - ry).abs().max() <= 1e-5 * ry.abs().max()


@pytest.mark.cuda
def test_numpy_mode_hybridized_replay_equals_eager(cuda, np_off):
    """A 2-layer BERT trunk hybridized under ``npx.set_np()``: its
    replay gives ``mx.np.ndarray``s equal to the eager forward bit for
    bit, every launch from the replay."""
    from mxnet_tpu_torch import graphs
    from mxnet_tpu_torch.examples.bert_mlm import (build, on_device,
                                                   synthetic_arrays)
    np_off.set_np()
    net = build(cuda, vocab_size=1000, units=128, hidden_size=256,
                num_layers=2, num_heads=2, max_length=64)[0]
    ids, tt, lens = on_device(synthetic_arrays(1, 4, 32, 1000), cuda,
                              as_np=True)[:3]
    eager = net(ids, tt, lens)
    net.hybridize()
    net(ids, tt, lens)
    graphs.reset_replayed_launches()
    before = launch_counts()
    got = net(ids, tt, lens)
    torch.cuda.synchronize()
    after = launch_counts()
    made = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert type(got).__name__ == "ndarray"
    assert torch.equal(got.as_subclass(torch.Tensor),
                       eager.as_subclass(torch.Tensor))
    assert made == {"flash_attention": 2, "layer_norm": 5}
    assert {k: v for k, v in graphs.replayed_launches().items() if v} == made


@pytest.mark.cuda
def test_numpy_functions_on_the_card_match_the_cpu(cuda):
    """``einsum``, ``unique``, ``linalg.solve``/``svd`` and a few
    reductions on the card against the CPU: float32 products within
    1e-5 of scale, the solve within 1e-4 (n eps cond), exact results
    equal."""
    from mxnet_tpu_torch import numpy as mnp
    rs = np.random.RandomState(9)
    a, b = rs.randn(4, 16, 32).astype("f"), rs.randn(32, 8).astype("f")
    m = rs.randn(32, 32).astype("f")
    spd = (m @ m.T / 32 + np.eye(32)).astype("f")
    rhs = rs.randn(32, 3).astype("f")
    ids = rs.randint(0, 50, 500).astype("int32")

    def run(dev):
        A = {k: mnp.array(v, ctx=dev) for k, v in
             dict(a=a, b=b, spd=spd, rhs=rhs, ids=ids, m=m).items()}
        return [mnp.einsum("bij,jk->bik", A["a"], A["b"]),
                mnp.linalg.solve(A["spd"], A["rhs"]),
                mnp.linalg.svd(A["m"])[1], A["a"].std(axis=1),
                mnp.quantile(A["a"], 0.3, axis=2)], \
            [*mnp.unique(A["ids"], return_counts=True),
             mnp.argsort(A["ids"]), mnp.count_nonzero(A["ids"] > 20)]

    gf, ge = run(cuda)
    wf, we = run("cpu")
    for g, w, tol in zip(gf, wf, (1e-5, 1e-4, 1e-5, 1e-5, 1e-5)):
        g, w = g.as_subclass(torch.Tensor).cpu(), w.as_subclass(torch.Tensor)
        assert (g - w).abs().max() <= tol * w.abs().max()
    for g, w in zip(ge, we):
        assert torch.equal(g.as_subclass(torch.Tensor).cpu(),
                           w.as_subclass(torch.Tensor))


# -- the native image batcher's device side and ONNX (phase 23) -------------
@pytest.mark.cuda
@pytest.mark.parametrize("out_hw", [(224, 224), (31, 45), (7, 300)])
def test_image_resize_kernel_matches_plain_bit_for_bit(cuda, out_hw):
    """The resize-and-assemble kernel against its plain version on the
    same HWC images (mixed sizes, one of the output size: the copy
    path): bit for bit, one launch a batch."""
    from mxnet_tpu_torch.ops import image
    rs = np.random.RandomState(sum(out_hw))
    sizes = [out_hw, (1, 1), (500, 3), (17, 29), (300, 224)]
    imgs = [torch.tensor(rs.randint(0, 256, s + (3,)), dtype=torch.uint8,
                         device=cuda) for s in sizes]
    before = launch_counts()["image_resize"]
    got = image.resize_assemble(imgs, *out_hw)
    after = launch_counts()["image_resize"]
    want = torch.stack([image.resize_bilinear_reference(i, *out_hw)
                        for i in imgs])
    torch.cuda.synchronize()
    assert after - before == 1
    assert torch.equal(got, want)
    assert torch.equal(got[0], imgs[0].permute(2, 0, 1))


@pytest.mark.cuda
def test_nvjpeg_batches_against_the_pil_path(cuda, tmp_path):
    """``NativeImageBatcher`` on the card (nvJPEG, the kernel) against
    the CPU's (PIL, the plain version) on seeded photo-like JPEGs:
    labels equal, pixels within ``chip_smoke.DECODE_MEAN`` levels on
    the mean and at most ``DECODE_FAR_SHARE`` of them more than
    ``DECODE_FAR`` apart (libjpeg's fancy chroma upsampling, which
    nvJPEG does not do); a record that is no JPEG is skipped on both."""
    import io
    import warnings

    from PIL import Image

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import native
    c = _smoke()
    rs = np.random.RandomState(3)
    rec = mx.recordio.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                                        str(tmp_path / "a.rec"), "w")
    for i in range(24):
        buf = io.BytesIO()
        h, w = rs.randint(40, 200, 2)
        Image.fromarray(c.jpeg_scene(rs, h, w)).save(buf, format="JPEG")
        data = b"not a jpeg" if i == 5 else buf.getvalue()
        rec.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i), i, 0), data))
    rec.close()
    kw = dict(batch_size=8, data_shape=(3, 64, 48))
    card = native.NativeImageBatcher(str(tmp_path / "a.rec"),
                                     str(tmp_path / "a.idx"), device=cuda,
                                     **kw)
    host = native.NativeImageBatcher(str(tmp_path / "a.rec"),
                                     str(tmp_path / "a.idx"), device="cpu",
                                     **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            (g, gl), (h_, hl) = card.next(), host.next()
            assert g.device.type == "cuda" and g.shape == h_.shape
            assert torch.equal(gl.cpu(), hl)
            mean, far, _ = c.decode_gap(g, h_)
            assert mean <= c.DECODE_MEAN and far <= c.DECODE_FAR_SHARE
    assert card.next() is None and host.next() is None


@pytest.mark.cuda
def test_onnx_lm_replays_on_k6a_as_the_original_graph(cuda, tmp_path):
    """A 2-layer LSTM LM through ONNX, bound on the card: each imported
    ``LSTM`` node one K6a launch, the probabilities the original
    graph's bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size
    c = _smoke()
    V, E, H, L, T, N = 300, 32, 48, 2, 7, 4
    rs = np.random.RandomState(0)
    weights = {k: torch.tensor(v, device=cuda) for k, v in {
        "embed_weight": rs.randn(V, E).astype("f"),
        "lstm_parameters": rs.randn(rnn_param_size(L, E, H, False,
                                                   "lstm")).astype("f") * .2,
        "decoder_weight": rs.randn(V, H).astype("f") * .2,
        "decoder_bias": rs.randn(V).astype("f")}.items()}
    sym = c.onnx_wordlm(mx, V, E, H, L)
    isym, args, _, _, _, _ = c.onnx_round_trip(
        mx, sym, weights, {"data": (T, N)}, str(tmp_path / "lm.onnx"))
    feeds = {"data": torch.tensor(rs.randint(0, V, (T, N)), device=cuda,
                                  dtype=torch.float32),
             "lstm_state": torch.zeros(L, N, H, device=cuda),
             "lstm_state_cell": torch.zeros(L, N, H, device=cuda)}
    ctx = mx.gpu(cuda.index or 0)
    want = c.onnx_bind(mx, sym, ctx, weights, feeds).forward()[0]
    before = launch_counts()["lstm_fwd"]
    got = c.onnx_bind(mx, isym, ctx, args, feeds).forward()[0]
    torch.cuda.synchronize()
    assert launch_counts()["lstm_fwd"] - before == L
    assert torch.equal(got.as_subclass(torch.Tensor),
                       want.as_subclass(torch.Tensor))
