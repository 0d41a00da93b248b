"""The PyTorch port's LayerNorm (forward) against the JAX package's.

The same numpy inputs go through the JAX Pallas kernel in interpret
mode (``layer_norm_fused(..., interpret=True)``, and ``_ln_res`` for
the saved mean and rstd) and through the port's wrapper on CPU
tensors, which takes its plain version. float32 tolerance 1e-5
(relative 1e-5 on rstd, which is 1/std and large when the variance
is small). Inputs carry an offset mean, so a one-pass E[x^2] - mean^2
variance would show at eps 1e-12. The CUDA kernel itself is held
against the plain version on the card by
tests/test_torch_cuda_kernels.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
import jax.numpy as jnp
from mxnet_tpu_torch.ndarray import op_impl_nn
from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import layer_norm as ln

torch.set_num_threads(1)


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = (rng.randn(*shape) * 0.5 + 3.0).astype(np.float32)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("shape", [(7, 32), (3, 5, 32), (13, 768),
                                   (2, 9, 768)])
def test_plain_matches_jax_interpret_kernel(monkeypatch, shape, eps):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.layer_norm import _ln_res, layer_norm_fused

    x, g, b = _inputs(len(shape) * 100 + shape[-1], shape)
    jx, jg, jb = (jnp.asarray(a) for a in (x, g, b))
    want = np.asarray(layer_norm_fused(jx, jg, jb, eps, True))
    _, want_mu, want_rs = _ln_res(jx, jg, jb, eps, True)
    before = launch_counts()
    got, mu, rs = ln.layer_norm_fused(
        *(torch.from_numpy(a) for a in (x, g, b)), eps, return_stats=True)
    assert launch_counts() == before          # plain version, no launch
    assert got.shape == shape and mu.shape == (x.size // shape[-1],)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu)[:, 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rs.numpy(), np.asarray(want_rs)[:, 0],
                               rtol=1e-5)
    y = ln.layer_norm_fused(*(torch.from_numpy(a) for a in (x, g, b)), eps)
    assert torch.equal(y, got)


def test_bf16_input_matches_jax_in_float32(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.layer_norm import layer_norm_fused

    x, g, b = _inputs(1, (11, 768))
    want = np.asarray(layer_norm_fused(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, g, b)), 1e-12, True)
        .astype(jnp.float32))
    got = ln.layer_norm_fused(
        *(torch.from_numpy(a).bfloat16() for a in (x, g, b)), 1e-12)
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round the output to bf16 once: one bf16
    # ulp at |y| < 16 is 6.3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=6.3e-2)


@pytest.mark.parametrize("axis", [0, 1])
def test_non_last_axis_takes_the_plain_math(axis):
    import mxnet_tpu.ndarray.op_impl_nn as jax_nn

    x, _, _ = _inputs(4, (6, 10, 32))
    rng = np.random.RandomState(9)
    d = x.shape[axis]
    g, b = rng.randn(d).astype(np.float32), rng.randn(d).astype(np.float32)
    want = np.asarray(jax_nn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), axis=axis,
                                        eps=1e-5))
    before = launch_counts()
    got = op_impl_nn.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)),
                                axis=axis, eps=1e-5)
    assert launch_counts() == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_path_refuses_what_the_kernel_refuses():
    x = torch.zeros(2, 2048)
    with pytest.raises(ValueError, match="last axis"):
        ln.layer_norm_fused(x, torch.ones(2048), torch.zeros(2048))
    with pytest.raises(TypeError):
        ln.layer_norm_fused(torch.zeros(2, 8), torch.ones(8).double(),
                            torch.zeros(8))
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fused(torch.zeros(8, 4).t(), torch.ones(8),
                            torch.zeros(8))
