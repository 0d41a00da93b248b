"""The port's initializers against the JAX package's, on the CPU.

The JAX package draws from ``_np_rng()`` (a numpy generator derived
from its key chain); the test replaces that by
``np.random.default_rng(0)`` and hands the port a generator of the same
seed, so the draws are the same bits: every initializer is compared
exactly (the float64 draws and the float32 rounding are numpy's on both
sides).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu_torch import initializer as tinit

torch.set_num_threads(1)


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages draw from ``default_rng(0)``; returns the port's
    generator factory."""
    monkeypatch.setattr(jinit, "_np_rng", lambda: np.random.default_rng(0))
    return lambda: np.random.default_rng(0)


def _both(make, name, shape, rng):
    """``make(module)``'s initializer run on ``name`` in each package."""
    with jmx.cpu():
        jarr = jmx.nd.zeros(shape)
    make(jinit)(name, jarr)
    tarr = torch.zeros(shape)
    make(tinit)(name, tarr, rng())
    return tarr.numpy(), jarr.asnumpy()


INITS = {
    "orthogonal": lambda m: m.Orthogonal(),
    "orthogonal-normal": lambda m: m.Orthogonal(scale=0.5,
                                                rand_type="normal"),
    "msraprelu": lambda m: m.MSRAPrelu(),
    "msraprelu-in": lambda m: m.MSRAPrelu(factor_type="in", slope=0.1),
    "bilinear": lambda m: m.Bilinear(),
    "xavier": lambda m: m.Xavier(magnitude=2.0),
    "uniform": lambda m: m.Uniform(0.3),
}


SHAPES = [(6, 4), (4, 6), (3, 2, 3, 4), (2, 1, 5, 4)]


# Bilinear fills 4-D (filter) weights only, in both packages
@pytest.mark.parametrize("kind,shape", [
    (k, s) for k in sorted(INITS) for s in SHAPES
    if k != "bilinear" or len(s) == 4])
def test_initializer_matches_jax_exactly(same_draws, kind, shape):
    got, want = _both(INITS[kind], "fc_weight", shape, same_draws)
    np.testing.assert_array_equal(got, want)
    if kind.startswith("orthogonal"):
        flat = got.reshape(shape[0], -1).astype(np.float64)
        gram = flat @ flat.T if shape[0] <= flat.shape[1] else flat.T @ flat
        scale = 1.414 if kind == "orthogonal" else 0.5
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                                   atol=1e-5)


def test_bilinear_keeps_the_jax_row_formula():
    """``y = (i / shape[3]) % shape[2]`` with true division, as the JAX
    package computes it (not MXNet's integer division)."""
    arr = torch.zeros(1, 1, 2, 4)
    tinit.Bilinear()("up_weight", arr)
    f = np.ceil(4 / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = 5
    x, y = i % 4, (i / 4) % 2
    assert arr.reshape(-1)[i].item() == pytest.approx(
        (1 - abs(x / f - c)) * (1 - abs(y / f - c)))


def test_mixed_routes_by_pattern_as_jax(same_draws):
    """``Mixed`` gives each name the first initializer whose pattern
    matches; a name that matches none raises in both packages."""
    def make(m):
        return m.Mixed(["conv.*", "fc.*bias", ".*"],
                       [m.Constant(0.5), m.One(), m.Uniform(0.2)])

    for name in ("conv0_weight", "fc1_bias", "fc1_weight", "other_weight"):
        got, want = _both(make, name, (3, 4), same_draws)
        np.testing.assert_array_equal(got, want)
    only = tinit.Mixed(["conv.*"], [tinit.Zero()])
    jonly = jinit.Mixed(["conv.*"], [jinit.Zero()])
    with pytest.raises(ValueError, match="did not match"):
        only("fc_weight", torch.zeros(2), np.random.default_rng(0))
    with pytest.raises(ValueError, match="did not match"):
        jonly("fc_weight", jmx.nd.zeros((2,)))


@pytest.mark.parametrize("name", ["orthogonal", "msraprelu", "bilinear"])
def test_registry_and_dumps_round_trip(name):
    made = tinit.create(name)
    assert type(made).__name__ == type(jinit.create(name)).__name__
    again = tinit.create(made.dumps())
    assert type(again) is type(made) and again._kwargs == made._kwargs


def test_block_initialize_takes_the_new_initializers():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(4, in_units=6, device="cpu")
    net.initialize(tinit.Orthogonal(), seed=3)
    w = net.weight.detach().double().numpy()
    np.testing.assert_allclose(w @ w.T, 1.414 ** 2 * np.eye(4), atol=1e-5)
    net.initialize(tinit.MSRAPrelu(), seed=3, force_reinit=True)
    assert 0.1 < float(net.weight.detach().std()) < 1.0
