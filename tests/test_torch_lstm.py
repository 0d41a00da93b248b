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
