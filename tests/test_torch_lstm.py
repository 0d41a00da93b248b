"""The port's whole-sequence LSTM (K6a/K6b, ``ops/lstm.py``) against the
JAX package's ``lstm_layer_fused`` on the CPU.

The port's wrappers take their plain versions on CPU tensors, through
the same autograd Function the card uses; the JAX side runs its Pallas
kernels in interpret mode, and a ``lax.scan`` cell is the second
reference (``tests/test_pallas.py``'s golden, T=7, N=8, H=24). Forward
``out``/``cseq`` agree within 1e-5 (the same float32 math, summed in
another order); the gradients of gin, W, h0 and c0, with live
cotangents on every ``out``, on ``cseq[-1]`` and on ``out[-1]``,
within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.lstm import lstm_layer_fused as jax_lstm
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import lstm as tl

torch.set_num_threads(1)

T, N, H = 7, 8, 24


def _inputs(seed=21):
    rng = np.random.RandomState(seed)
    gin = (rng.randn(T, N, 4 * H) * 0.4).astype(np.float32)
    w = (rng.randn(H, 4 * H) * 0.3).astype(np.float32)
    h0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(N, H) * 0.5).astype(np.float32)
    wo = rng.randn(T, N, H).astype(np.float32)
    wc = rng.randn(N, H).astype(np.float32)
    return (gin, w, h0, c0), wo, wc


def _scan(gin, w, h0, c0):
    def step(carry, gx):
        h, c = carry
        i, f, g, o = jnp.split(gx + h @ w, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), (h, c)
    return jax.lax.scan(step, (h0, c0), gin)[1]


@pytest.fixture(scope="module")
def jax_refs():
    """{"interpret": ..., "scan": ...}: (out, cseq, grads of gin, w,
    h0, c0) as numpy."""
    args, wo, wc = _inputs()
    fns = {"interpret": lambda *a: jax_lstm(*a, True), "scan": _scan}
    refs = {}
    for name, fn in fns.items():
        def loss(*a, fn=fn):
            out, cseq = fn(*a)
            return (out * wo).sum() + (cseq[-1] * wc).sum() + out[-1].sum()
        jargs = [jnp.asarray(a) for a in args]
        out, cseq = fn(*jargs)
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
        refs[name] = [np.asarray(x) for x in (out, cseq, *grads)]
    return refs


def _port(args, wo, wc, w_layout="h4h"):
    """The port's forward and gradients; ``w_layout="4hh"`` hands the
    weight as the transpose view of an MXNet (4H, H) parameter."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    gin, w, h0, c0 = leaves
    if w_layout == "4hh":
        w = torch.from_numpy(args[1].T.copy()).requires_grad_()
        leaves[1] = w
        w = w.t()
    out, cseq = tl.lstm_layer_fused(gin, w, h0, c0)
    loss = (out * torch.from_numpy(wo)).sum() \
        + (cseq[-1] * torch.from_numpy(wc)).sum() + out[-1].sum()
    loss.backward()
    grads = [p.grad.numpy() for p in leaves]
    if w_layout == "4hh":
        grads[1] = grads[1].T
    return [out.detach().numpy(), cseq.detach().numpy(), *grads]


@pytest.mark.parametrize("ref", ["interpret", "scan"])
@pytest.mark.parametrize("w_layout", ["h4h", "4hh"])
def test_plain_path_matches_jax(jax_refs, ref, w_layout):
    args, wo, wc = _inputs()
    before = launch_counts()
    got = _port(args, wo, wc, w_layout)
    assert launch_counts() == before          # CPU tensors: plain path
    want = jax_refs[ref]
    for name, g, r in zip(("out", "cseq"), got[:2], want[:2]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
    for name, g, r in zip(("dgin", "dw", "dh0", "dc0"), got[2:], want[2:]):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_backward_matches_autograd_of_plain_forward():
    """K6b's plain version against autograd through K6a's plain loop,
    bf16 included (both round where the kernels do)."""
    args, wo, wc = _inputs(3)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        gin, w, h0, c0 = (torch.from_numpy(a).to(dtype).requires_grad_()
                          for a in args)
        out, cseq, gates = tl.lstm_forward_reference(gin, w, h0, c0)
        dout = torch.from_numpy(wo).to(dtype)
        dcseq = torch.zeros_like(cseq)
        dcseq[-1] = torch.from_numpy(wc).to(dtype)
        want = torch.autograd.grad((out, cseq), (gin, w, h0, c0),
                                   (dout, dcseq))
        got = tl.lstm_backward_reference(gates, cseq, out, w, h0, c0, dout,
                                         dcseq)
        for name, g, r in zip(("dgin", "dh0", "dc0", "dw"), got,
                              (want[0], want[2], want[3], want[1])):
            np.testing.assert_allclose(g.float().detach().numpy(),
                                       r.float().numpy(), rtol=tol,
                                       atol=tol, err_msg=f"{dtype} {name}")


def test_wrappers_check_their_operands():
    args, _, _ = _inputs()
    gin, w, h0, c0 = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="w must be"):
        tl.lstm_layer_fused(gin, w.t(), h0, c0)
    with pytest.raises(ValueError, match="h0 must be"):
        tl.lstm_layer_fused(gin, w, h0[:3], c0)
    with pytest.raises(TypeError, match="one dtype"):
        tl.lstm_layer_fused(gin, w.double(), h0, c0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tl.lstm_forward(gin.to("meta"), w.to("meta"), h0.to("meta"),
                        c0.to("meta"))
    empty = tl.lstm_forward(gin[:0], w, h0, c0)
    assert [tuple(t.shape) for t in empty] == [(0, N, H), (0, N, H),
                                               (0, N, 4 * H)]


# -- K6's grid plan and K6b's product arithmetic (no card needed) ------------
H100 = dict(sms=132, smem_limit=232448)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n,hid", [(32, 650), (1024, 650), (1, 1056),
                                   (33, 1056), (17, 24)])
def test_plan_fits_the_word_lm_and_h_up_to_1056_on_an_h100(n, hid,
                                                           backward):
    for dtype in (torch.float32, torch.bfloat16):
        plan = tl.plan_grid(n, hid, dtype, backward=backward, **H100)
        assert plan["blocks"] <= 132          # one block an SM
        assert plan["smem_bytes"] <= H100["smem_limit"]
        # unit groups of one or two n-tiles x row groups of m-tiles; W
        # rows padded to whole chunks of the product's depth, 64 B apart
        # in the banks
        item = 4 if dtype == torch.float32 else 2
        assert plan["units_per_block"] <= 16
        assert plan["unit_groups"] * plan["units_per_block"] >= hid
        assert plan["blocks"] == plan["unit_groups"] * plan["row_groups"]
        assert 1 <= plan["row_groups"] <= plan["m_tiles"]
        assert plan["m_tiles"] * 16 >= n
        assert plan["w_row"] >= (4 * hid if backward else hid)
        assert plan["w_row"] * item % 128 == 64
        if not backward:                      # h in whole 64-byte chunks
            assert plan["h_row"] >= hid and plan["h_row"] * item % 64 == 0


def test_plan_of_the_word_lm_shapes():
    # 41 groups of 16 units x 2 row groups at N=32, x 3 at N=1024. The
    # forward keeps the 64 gate columns of its units (164 KB at H=650 in
    # f32), the backward W's 16 rows (167 KB); at H=1056 f32 only 8
    # units fit: 132 groups of 8, one row group
    def grid(n, hid, dtype=torch.float32, backward=True):
        p = tl.plan_grid(n, hid, dtype, backward=backward, **H100)
        return (p["units_per_block"], p["unit_groups"], p["row_groups"],
                p["blocks"])
    for backward in (False, True):
        assert grid(32, 650, backward=backward) == (16, 41, 2, 82)
        assert grid(1024, 650, backward=backward) == (16, 41, 3, 123)
        assert grid(1, 650, backward=backward) == (16, 41, 1, 41)
        assert grid(1024, 1056, backward=backward) == (8, 132, 1, 132)
        assert grid(1024, 1056, torch.bfloat16, backward) == (16, 66, 2,
                                                              132)
        assert grid(33, 5, backward=backward) == (5, 1, 3, 3)
    fwd = tl.plan_grid(32, 650, torch.float32, **H100)
    assert (fwd["w_row"], fwd["h_row"], fwd["smem_bytes"]) == (656, 656,
                                                               200704)


@pytest.mark.parametrize("n,hid,dtype,w_global", [
    (32, 650, torch.float32, False), (1024, 650, torch.float32, False),
    (32, 1056, torch.float32, False), (1024, 1056, torch.bfloat16, False),
    (32, 1057, torch.float32, True), (32, 1500, torch.float32, True),
    (32, 1500, torch.bfloat16, False), (1024, 2112, torch.float32, True)])
def test_plan_keeps_w_in_shared_memory_where_it_fits(n, hid, dtype,
                                                     w_global):
    """Both directions on an H100: W's part in shared memory up to H =
    1056 in f32 (and H = 1500 in bf16); past that (``word_lm.py --nhid
    1500``) 16 units a work block with W's rows in a device-memory
    scratch of ``w_scratch`` elements (a slice a work block), shared
    memory for the partial sums only. One block a work block up to H =
    2112; at 2113 the 133 unit groups take 132 blocks, one walking two.
    What the plan refuses is a W scratch past the device memory given."""
    for backward in (False, True):
        plan = tl.plan_grid(n, hid, dtype, backward=backward, **H100)
        assert plan["w_global"] is w_global
        assert plan["blocks"] <= 132
        assert plan["blocks"] == plan["work_blocks"] and plan["walk"] == 1
        rows = (1 if backward else 4) * 16
        if w_global:
            assert plan["units_per_block"] == 16
            assert plan["w_scratch"] == plan["work_blocks"] * rows * \
                plan["w_row"]
            assert plan["smem_bytes"] == (8192 if backward else 32768)
        else:
            assert plan["w_scratch"] == 0
    past = tl.plan_grid(n, 2113, dtype, **H100)
    assert (past["unit_groups"], past["row_groups"], past["blocks"],
            past["walk"]) == (133, 1, 132, 2)
    item = torch.finfo(dtype).bits // 8
    with pytest.raises(ValueError, match=r"133 unit groups of 16 units x 1 "
                                         r"row groups on 132 blocks"):
        tl.plan_grid(n, 2113, dtype, mem_limit=past["w_scratch"] * item - 1,
                     **H100)


@pytest.mark.parametrize("backward", [False, True])
def test_plan_refuses_what_cannot_fit_with_its_numbers(backward):
    # H = 4096 runs (256 work blocks on 132 blocks); its W rows do not
    # fit a device memory of 64 MB
    with pytest.raises(ValueError, match=r"cannot run N=8, H=4096 "
                                         r"\(torch.float32\) on 132 SMs: "
                                         r".*limit 67108864 B"):
        tl.plan_grid(8, 4096, torch.float32, backward=backward,
                     mem_limit=64 << 20, **H100)
    # below the partial sums' bytes: W's rows in device memory do not help
    with pytest.raises(ValueError, match="limit 8000 B"):
        tl.plan_grid(8, 650, torch.float32, sms=132, smem_limit=8000,
                     backward=backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n,hid,groups,rg,walk", [
    (32, 2500, 157, 1, 2), (1, 2500, 157, 1, 2), (32, 4224, 264, 1, 2),
    (1024, 4224, 264, 1, 2), (8, 8448, 528, 1, 4)])
def test_plan_walks_work_blocks_past_one_an_sm(backward, n, hid, groups,
                                               rg, walk):
    """Past H = 2112 on an H100 (132 SMs, 232,448 B): 16 units a work
    block, W's rows in device memory, one block an SM walking
    ceil(work blocks / 132) of them; a pure function of its numbers."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = tl.plan_grid(n, hid, dtype, backward=backward, **H100)
        again = tl.plan_grid(n, hid, dtype, backward=backward, **H100)
        assert plan == again
        assert plan["w_global"] and plan["units_per_block"] == 16
        assert (plan["unit_groups"], plan["row_groups"]) == (groups, rg)
        assert plan["work_blocks"] == groups * rg
        assert plan["blocks"] == 132 and plan["walk"] == walk
        rows = (1 if backward else 4) * 16
        assert plan["w_scratch"] == plan["work_blocks"] * rows * \
            plan["w_row"]
        assert plan["smem_bytes"] == (8192 if backward else 32768)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: what ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz(x):
    """float64 to float32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _mma(c, a, b):
    """One tensor-core mma: c + a . b with exact products, the sum
    rounded toward zero to f32 (the tensor cores do not round their
    adds to nearest)."""
    return _rz(c.double() + a.double() @ b.double())


def _mma_product(a, b, terms, fresh=True):
    """a (M, K) . b (K, N) as K6b's kernels form it: chunks of 16 of the
    depth, each two k-steps of 8 of TF32 mma; ``terms=3`` splits each
    operand into TF32 hi + lo and sums a_lo b_hi + a_hi b_lo + a_hi
    b_hi, ``terms=1`` takes a_hi b_hi alone. ``fresh``: each chunk into
    a zero partial, added to the f32 sum rounded to nearest (the
    kernels); else the whole depth through the mma's own accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for c in range(0, a.shape[1], 16):
        part = torch.zeros_like(acc) if fresh else acc
        for k in (c, c + 8):
            s = slice(k, k + 8)
            for x, y in pairs:
                part = _mma(part, x[:, s], y[s])
        acc = acc + part if fresh else part
    return acc


def test_tf32_round_to_nearest_keeps_ten_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0 + 2.0 ** -9])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                 -1.0, 3.0 + 2.0 ** -9]


@pytest.mark.parametrize("depth", [64, 128])
def test_three_term_tf32_product_at_the_attention_backwards_depths(depth):
    """K2's products on the same tensor-core arithmetic: depth D = 64
    (s = q' k^T, dp = do v^T) and Skv = 128 (dq = ds k; dk, dv over a
    query tile of 64, twice). The 3-term split stays within 1e-5 of
    scale against float64; one TF32 term does not."""
    rng = np.random.RandomState(depth)
    a = torch.from_numpy(rng.randn(32, depth).astype(np.float32))
    b = torch.from_numpy(rng.randn(depth, 8).astype(np.float32))
    want = a.double() @ b.double()
    scale = max(want.abs().max().item(), 1.0)
    for terms, within in ((3, True), (1, False)):
        err = (_mma_product(a, b, terms).double() - want).abs().max().item()
        assert (err <= 1e-5 * scale) is within, (terms, err, scale)


@pytest.mark.parametrize("depth", [2600, 1120])
def test_three_term_tf32_product_keeps_f32_accuracy(depth):
    """K6b's products at the word LM's depths: 4H = 2600 (the
    recurrence, dgin . W^T) and T*N = 1120 (dW = h^T . dgin). The 3-term
    split, summed a chunk at a time into fresh partials, stays within
    1e-5 of the result's scale against float64, the tolerance the card
    tests hold K6b to. One TF32 product does not, which is why f32
    takes three. Carrying the whole depth through the mma's own
    accumulator, whose adds round toward zero, drifts (~depth x 2^-24:
    past 1e-5 at 2600 here, and on the card at both depths) an order of
    magnitude beyond the fresh partials."""
    rng = np.random.RandomState(depth)
    a = torch.from_numpy((rng.randn(32, depth) * 0.5 + 0.2)
                         .astype(np.float32))
    b = torch.from_numpy((rng.randn(depth, 8) / 25.5 + 0.01)
                         .astype(np.float32))
    want = a.double() @ b.double()
    scale = max(want.abs().max().item(), 1.0)

    def err(**kw):
        return (_mma_product(a, b, **kw).double() - want).abs().max().item()

    fresh = err(terms=3)
    assert fresh <= 1e-5 * scale, (fresh, scale)
    assert err(terms=1) > 1e-5 * scale, (err(terms=1), scale)
    assert err(terms=3, fresh=False) > 10 * fresh
