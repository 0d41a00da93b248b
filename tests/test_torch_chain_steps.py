"""``engine.chain_steps`` on the port against single steps and against
the JAX package's ``chain_steps``, on the CPU (where the port runs the
``k`` steps in a loop; on the card they are one CUDA graph, held there
by ``chip_smoke.py``).

The step is the JAX test's (``tests/test_engine_chain.py``): a linear
model's squared error, momentum SGD. k = 4 chained steps equal 4 single
steps exactly (the same arithmetic in the same order), and the JAX
package's within 1e-5 relative (float32; the two libraries' products
round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.engine import chain_steps as jax_chain_steps
from mxnet_tpu_torch.engine import chain_steps

torch.set_num_threads(1)

K = 4


def step(w, b, mw, mb, x, y):
    """One momentum-SGD step of ``((x @ w + b - y) ** 2).mean()``."""
    w_, b_ = w.detach().requires_grad_(True), b.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = ((x @ w_ + b_ - y) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, (w_, b_))
    mw, mb = 0.9 * mw + gw, 0.9 * mb + gb
    return w - 0.05 * mw, b - 0.05 * mb, mw, mb, loss.detach()


def jax_step(params, moms, x, y):
    def loss_fn(p):
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    loss, g = jax.value_and_grad(loss_fn)(params)
    moms = jax.tree_util.tree_map(lambda m, gg: 0.9 * m + gg, moms, g)
    params = jax.tree_util.tree_map(lambda p, m: p - 0.05 * m, params, moms)
    return params, moms, loss


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(4, 3).astype(np.float32), np.zeros(3, np.float32),
            rs.rand(8, 4).astype(np.float32), rs.rand(8, 3).astype(np.float32))


def test_chained_steps_equal_single_steps_and_jax():
    w, b, x, y = _data()
    args = [torch.from_numpy(a) for a in (w, b)] + \
        [torch.zeros(4, 3), torch.zeros(3)] + \
        [torch.from_numpy(a) for a in (x, y)]
    carry = args[:4]
    for _ in range(K):
        *carry, loss = step(*carry, *args[4:])
    got = chain_steps(step, K, donate_argnums=(0, 1, 2, 3))(*args)
    for a, c in zip(got, (*carry, loss)):
        assert torch.equal(a, c)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    moms = jax.tree_util.tree_map(jnp.zeros_like, params)
    jp, jm, jloss = jax_chain_steps(jax_step, K, donate_argnums=(0, 1))(
        params, moms, jnp.asarray(x), jnp.asarray(y))
    for a, c in zip(got, (jp["w"], jp["b"], jm["w"], jm["b"], jloss)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-6)


def test_chain_steps_checks_its_step():
    x = torch.ones(2)
    with pytest.raises(TypeError, match="carry"):
        chain_steps(lambda a: a * 2, 2)(x)
    with pytest.raises(TypeError, match="only 1 arguments"):
        chain_steps(lambda a: (a, a, a), 2)(x)
    with pytest.raises(ValueError, match="k must be"):
        chain_steps(step, 0)
