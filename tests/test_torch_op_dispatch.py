"""The port's fused ops on the calls the Queue of op faults named,
against the JAX package's ops on the CPU.

Each op decides from device, shape and type, before any launch,
whether its kernel takes a call, as the JAX op does: what the JAX op
computes with composed math on its accelerator (float64,
``output_mean_var``) takes the same math here; the kernels take the
rest, wide shapes included (LayerNorm D=2048, head dims of 256, an
LSTM of H=1500), which on the CPU means their plain versions. On the
CPU the JAX ops take their composed paths (no Pallas device, no
interpret mode): float32 within 1e-5 (sums in another order), float64
within 1e-10. No kernel counter moves on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
import jax
import jax.numpy as jnp
from mxnet_tpu.ndarray import op_impl_nn as jax_nn
from mxnet_tpu.ndarray.op_impl_rnn import rnn as jax_rnn
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.gluon.nn import MultiHeadAttention
from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn
from mxnet_tpu_torch.ops import launch_counts, lstm

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-10}
H100 = dict(sms=132, smem_limit=232448)


@pytest.mark.parametrize("d,dtype,mean_var", [(2048, np.float32, False),
                                              (64, np.float64, False),
                                              (96, np.float32, True)])
def test_layer_norm_off_the_kernel_matches_jax(d, dtype, mean_var):
    """D = 2048 (K3's rows of a block each; here its plain version),
    float64, and ``output_mean_var`` (out, mean, var with the axis
    squeezed) off the kernel."""
    rng = np.random.RandomState(d)
    x = (rng.randn(3, 5, d) * 0.5 + 2.0).astype(dtype)
    g, b = rng.randn(d).astype(dtype), rng.randn(d).astype(dtype)
    want = jax_nn.layer_norm(*(jnp.asarray(a) for a in (x, g, b)),
                             eps=1e-5, output_mean_var=mean_var)
    before = launch_counts()
    got = op_impl_nn.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)),
                                eps=1e-5, output_mean_var=mean_var)
    assert launch_counts() == before
    if not mean_var:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for gt, w in zip(got, want):
        assert gt.dtype == torch.from_numpy(x).dtype
        assert tuple(gt.shape) == w.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(w),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def _attention_case(seed, b, h, sq, skv, d, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(dtype)
    k, v = (rng.randn(b, h, skv, d).astype(dtype) for _ in range(2))
    return rng, q, k, v


@pytest.mark.parametrize("mode,d,dtype", [("valid_len", 256, np.float32),
                                          ("segments", 256, np.float32),
                                          ("causal", 256, np.float32),
                                          ("valid_len_causal", 32,
                                           np.float64),
                                          ("valid_len_causal", 264,
                                           np.float32)])
def test_attention_off_the_kernel_matches_jax(mode, d, dtype):
    """Head dims of 256 (K1's widest tiles) and past it (264: the
    kernels' head-dim chunks; here their plain versions, as the JAX op
    takes any head dim into its kernel), and off the kernel float64
    (the JAX op's float32 masked softmax): rows with no visible key
    exact zeros (a valid length of 0; causal rows before the first
    key), the result in the query's type."""
    sq, skv = (5, 9) if "causal" in mode else (8, 8)
    rng, q, k, v = _attention_case(d, 3, 2, sq, skv, d, dtype)
    kw = {}
    if "valid_len" in mode:
        kw["valid_len"] = np.array([0, 3, skv], np.int32)
    if mode == "segments":
        kw["segment_ids"] = np.array([[1, 1, 1, 2, 2, 0, 0, 0],
                                      [1] * 8,
                                      [1, 2, 2, 3, 3, 3, 4, 0]], np.int32)
    if "causal" in mode:
        kw["causal"] = True
    want = np.asarray(jax_nn.flash_attention_op(
        *(jnp.asarray(a) for a in (q, k, v)),
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}))
    before = launch_counts()
    got = op_impl_nn.flash_attention_op(
        *(torch.from_numpy(a) for a in (q, k, v)),
        **{n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    assert launch_counts() == before
    assert got.dtype == torch.from_numpy(q).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[np.float32],
                               rtol=TOL[np.float32])
    if "valid_len" in mode:                    # the empty example
        assert not got[0].any()


def test_ops_route_wide_calls_to_the_kernels(monkeypatch):
    """On tensors as the card has them (the meta device: shapes and
    types, no data), the ops send attention at head dim 512 and an LSTM
    layer of H = 2500 float32, past the kernels' old limits, to the
    kernels' entry points, and float64 to the composed math, deciding
    before any launch."""
    calls = []
    meta = torch.device("meta")
    monkeypatch.setattr(op_impl_nn._fa, "flash_attention", lambda q, *a:
                        calls.append(("attention", q.shape[-1])) or q)
    q = torch.empty(2, 2, 5, 512, device=meta)
    assert op_impl_nn.flash_attention_op(q, q, q).shape == q.shape
    out = op_impl_nn.flash_attention_op(q.double(), q.double(), q.double())
    assert out.dtype == torch.float64
    assert calls == [("attention", 512)]

    def fused(gin, w, h0, c0):
        calls.append(("lstm", h0.shape[-1], gin.dtype))
        t = gin.new_empty(gin.shape[0], *h0.shape)
        return t, t

    monkeypatch.setattr(op_impl_rnn._lstm, "lstm_layer_fused", fused)
    scan = op_impl_rnn._scan
    monkeypatch.setattr(op_impl_rnn, "_scan", lambda *a: (
        calls.append(("scan", a[0].dtype)) or scan(*a)))
    for dtype in (torch.float32, torch.float64):
        h = 2500
        size = op_impl_rnn.rnn_param_size(1, 8, h, False, "lstm")
        state = torch.empty(1, 3, h, dtype=dtype, device=meta)
        op_impl_rnn.rnn(torch.empty(2, 3, 8, dtype=dtype, device=meta),
                        torch.empty(size, dtype=dtype, device=meta), state,
                        state, state_size=h, num_layers=1, mode="lstm")
    assert calls[1:] == [("lstm", 2500, torch.float32),
                         ("scan", torch.float64)]


def test_multi_head_attention_with_heads_of_256_runs():
    """Two heads of 256 (units 512): the layer's attention takes the
    kernels' path (here their plain versions) and is differentiable
    through it."""
    mha = MultiHeadAttention(512, 2, device="cpu").initialize(seed=3)
    x = torch.randn(2, 7, 512, requires_grad=True)
    with autograd.record():
        out = mha(x, valid_length=torch.tensor([7, 4]))
    out.sum().backward()
    assert out.shape == (2, 7, 512) and torch.isfinite(x.grad).all()


def test_cross_entropy_with_float_labels_matches_jax():
    """Float32 labels, as ``example/mnist_gluon.py`` makes them: both
    JAX paths cast them to int32; so does the port's op, before its
    kernel (whose wrapper still refuses float labels)."""
    rng = np.random.RandomState(5)
    logits = rng.randn(6, 11).astype(np.float32)
    labels = rng.randint(0, 11, 6).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda x: jax_nn.softmax_cross_entropy(x, jnp.asarray(labels))[0])(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tnd.softmax_cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    assert got.shape == (1,)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["float64", "h1500_as_on_an_h100"])
def test_rnn_op_off_the_kernel_matches_jax_scan(monkeypatch, case):
    """The ``RNN`` op's LSTM on the two calls the op fault named:
    float64 (both directions), which the kernels do not take (the JAX
    op's scan cell a step at a time), and H = 1500 float32, one layer,
    which the kernels take as on an H100 (132 SMs: W's rows in device
    memory), here their plain versions. Forward and gradients."""
    if case == "float64":
        t, n, i, h, layers, bidir, dtype, tol = 4, 3, 5, 6, 1, True, \
            np.float64, 1e-10
    else:
        t, n, i, h, layers, bidir, dtype, tol = 2, 2, 4, 1500, 1, False, \
            np.float32, 1e-5
        assert lstm.plan_grid(n, h, torch.float32, **H100)["w_global"]
    # float64 never reaches the kernels' path, float32 always does
    scan = op_impl_rnn._scan
    monkeypatch.setattr(op_impl_rnn, "_scan", lambda *a: (
        scan(*a) if dtype == np.float64 else pytest.fail("scan taken")))
    d = 2 if bidir else 1
    rng = np.random.RandomState(8)
    size = op_impl_rnn.rnn_param_size(layers, i, h, bidir, "lstm")
    args = [a.astype(dtype) for a in (
        rng.randn(t, n, i), rng.randn(size) / np.sqrt(h),
        rng.randn(d * layers, n, h) * 0.5,
        rng.randn(d * layers, n, h) * 0.5)]
    wo = rng.randn(t, n, d * h).astype(dtype)
    kw = dict(state_size=h, num_layers=layers, bidirectional=bidir,
              mode="lstm")

    want, vjp = jax.vjp(lambda *a: jax_rnn(*a, **kw),
                        *(jnp.asarray(a) for a in args))
    # the cotangents of (out * wo).sum() + h.sum() + (c * c).sum()
    jgrads = vjp((jnp.asarray(wo), jnp.ones_like(want[1]), 2 * want[2]))
    want = [np.asarray(a) for a in want]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = launch_counts()
    got = op_impl_rnn.rnn(*leaves, **kw)
    out, hs, cs = got
    ((out * torch.from_numpy(wo)).sum() + hs.sum() + (cs * cs).sum()
     ).backward()
    assert launch_counts() == before
    for name, g, w in zip(("out", "h", "c"), got, want):
        assert g.dtype == torch.from_numpy(args[0]).dtype, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=name)
    for name, leaf, jg in zip(("dx", "dparams", "dh0", "dc0"), leaves,
                              jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=10 * tol, atol=10 * tol,
                                   err_msg=name)
