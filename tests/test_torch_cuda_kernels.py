"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
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
@pytest.mark.parametrize("d", [8, 16, 64, 128])
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
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 136, 200, 256])
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
    _, q, k, v = _flash_case(4, 2, 2, 16, 16, 200, cuda, torch.float32)
    _, q, k, v = _flash_case(4, 2, 2, 16, 16, 264, cuda, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)                     # D > 256
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
    of its kernels' types: past the kernels' shapes it raises before any
    launch (a head dim past 256; an LSTM layer past one block an SM of
    16 units, H = 2113 on an H100)."""
    from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn

    before = launch_counts()
    q = torch.zeros(1, 1, 4, 264, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        op_impl_nn.flash_attention_op(q, q, q)
    hid = 16 * lstm.device_numbers(cuda)[0] + 1
    size = op_impl_rnn.rnn_param_size(1, 4, hid, False, "lstm")
    state = torch.zeros(1, 1, hid, device=cuda)
    with pytest.raises(ValueError, match="cannot run"):
        op_impl_rnn.rnn(torch.zeros(2, 1, 4, device=cuda),
                        torch.zeros(size, device=cuda), state, state,
                        state_size=hid, num_layers=1, bidirectional=False,
                        mode="lstm")
    assert launch_counts() == before


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
            for hid in (1056, 1500, 2112):
                lstm.lstm_plan(n, hid, dtype, backward=True)
                lstm.lstm_plan(n, hid, dtype)
    assert lstm.lstm_plan(32, 1500)["w_global"]
    with pytest.raises(ValueError, match="cannot run"):
        lstm.lstm_plan(8, 4096)
    gin = torch.zeros(2, 8, 4 * 4096, device=cuda)
    w = torch.zeros(4096, 4 * 4096, device=cuda)
    h0 = torch.zeros(8, 4096, device=cuda)
    before = launch_counts()["lstm_fwd"]
    with pytest.raises(ValueError, match="cannot run"):
        lstm.lstm_forward(gin, w, h0, h0)
    assert launch_counts()["lstm_fwd"] == before
    with pytest.raises(ValueError):
        lstm.lstm_forward(gin[:, :, :64], w[:16, :64], h0[:, :16].cpu(),
                          h0[:, :16])


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
