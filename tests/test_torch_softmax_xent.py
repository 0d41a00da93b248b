"""The PyTorch port's fused softmax cross-entropy (K4a forward, K4b
backward) against the JAX package's.

The same numpy logits and labels go through the JAX Pallas kernel in
interpret mode (``softmax_xent_fused(..., interpret=True)`` and
``jax.vjp`` of it) and through the port's autograd Function on CPU
tensors, which takes the plain versions: the wiring the card uses.
Vocabulary sizes are not multiples of 128 (the TPU's lane tile) except
one. float32 tolerance 1e-5 on the per-row loss (a log-sum-exp over up
to 1000 terms summed in another order) and 1e-6 on the gradient
(softmax probabilities below 1). bf16 logits are compared in float32
against the JAX kernel on the same bf16 logits: the loss is f32 on both
sides (1e-4: lse of ~7 from bf16 inputs), the gradient is rounded to
bf16 once on both sides (one bf16 ulp at |dx| < 1 is 2**-8).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import jax
import jax.numpy as jnp
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import softmax_xent as sx

torch.set_num_threads(1)


def _inputs(n, v, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 2.0).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    return logits, labels, g


def _jax(logits, labels, g, dtype=jnp.float32):
    from mxnet_tpu.ops.pallas.softmax_xent import softmax_xent_fused

    lab = jnp.asarray(labels)
    loss, vjp = jax.vjp(lambda x: softmax_xent_fused(x, lab, True),
                        jnp.asarray(logits, dtype))
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dx.astype(jnp.float32))


def _port(logits, labels, g, dtype=torch.float32):
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    before = launch_counts()
    loss = sx.softmax_xent_fused(x, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert launch_counts() == before          # plain versions, no launch
    assert loss.dtype == torch.float32 and x.grad.dtype == dtype
    return loss.detach().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("n,v", [(50, 1000), (33, 513), (64, 128),
                                 (7, 30522)])
def test_matches_jax_interpret_kernel(monkeypatch, n, v):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    logits, labels, g = _inputs(n, v, n + v)
    want_loss, want_dx = _jax(logits, labels, g)
    got_loss, got_dx = _port(logits, labels, g)
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_dx, want_dx, atol=1e-6, rtol=1e-5)


def test_bf16_logits_match_jax_in_float32(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    logits, labels, g = _inputs(24, 700, 3)
    logits = np.array(jnp.asarray(logits, jnp.bfloat16)
                        .astype(jnp.float32))  # exact in bf16
    want_loss, want_dx = _jax(logits, labels, g, jnp.bfloat16)
    got_loss, got_dx = _port(logits, labels, g, torch.bfloat16)
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-4, rtol=1e-5)
    bound = np.abs(want_dx) * 2.0 ** -8 + 1e-6
    assert (np.abs(got_dx - want_dx) <= bound).all()


def test_labels_outside_the_vocabulary_pick_nothing(monkeypatch):
    """No ignore label, as on the TPU: loss = lse, dx = softmax * g."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    logits, labels, g = _inputs(6, 300, 11)
    labels[1], labels[4] = -1, 3000
    want_loss, want_dx = _jax(logits, labels, g)
    got_loss, got_dx = _port(logits, labels, g)
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_dx, want_dx, atol=1e-6, rtol=1e-5)
    _, lse = sx.softmax_xent_reference(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    assert got_loss[1] == lse[1].item() and got_loss[4] == lse[4].item()


def test_softmax_cross_entropy_op_matches_jax(monkeypatch):
    """``nd.softmax_cross_entropy``: the sum of the per-row losses,
    shape (1,), and its gradient, against the JAX op on its kernel."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    logits, labels, _ = _inputs(40, 333, 5)
    data = mx.nd.array(logits)
    data.attach_grad()
    with mx.autograd.record():
        want = mx.nd.softmax_cross_entropy(data, mx.nd.array(
            labels, dtype="int32"))
    want.backward()
    x = torch.from_numpy(logits).requires_grad_()
    got = tnd.softmax_cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    assert got.shape == (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want.asnumpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), data.grad.asnumpy(),
                               atol=1e-6, rtol=1e-5)


def test_cpu_path_refuses_what_the_kernel_refuses():
    x = torch.zeros(4, 10)
    with pytest.raises(TypeError, match="labels"):
        sx.softmax_xent_fused(x, torch.zeros(4))
    with pytest.raises(TypeError, match="labels"):
        sx.softmax_xent_fused(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        sx.softmax_xent_fused(x.double(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="logits"):
        sx.softmax_xent_fused(torch.zeros(4), torch.zeros(4,
                                                           dtype=torch.int32))
    # meta tensors (mx.sym's shape inference) take the plain version:
    # the per-row loss's shape, nothing launched
    loss = sx.softmax_xent_fused(x.to("meta"), torch.zeros(
        4, dtype=torch.int32, device="meta"))
    assert loss.device.type == "meta" and tuple(loss.shape) == (4,)
