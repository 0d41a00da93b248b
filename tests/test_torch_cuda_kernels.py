"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import layer_norm as ln
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
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
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
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)                     # D > 128
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
                                 (5, 1000), (3, 1024), (9, 7)])
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
def test_layer_norm_kernel_refuses_bad_operands(cuda):
    x = torch.randn(4, 16, device=cuda)
    g = torch.ones(16, device=cuda)
    with pytest.raises(ValueError):
        ln.layer_norm_fused(torch.randn(2, 2048, device=cuda),
                            torch.ones(2048, device=cuda),
                            torch.zeros(2048, device=cuda))
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
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
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


# -- K3b: LayerNorm backward -------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("r,d", [(1, 32), (37, 768), (8 * 1024, 768),
                                 (5, 1000), (3, 1024), (9, 7), (5000, 64)])
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
    big = torch.randn(2, 2048, device=cuda)
    with pytest.raises(ValueError):
        ln.layer_norm_backward(big, torch.ones(2048, device=cuda),
                               mu[:2], rs[:2], big)


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
