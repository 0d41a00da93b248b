"""The port's convolution, pooling and BatchNorm against the JAX
package's, on the CPU.

- ``convolution``: 1-, 2- and 3-D with stride, padding, dilation,
  groups and bias, forward and the input/weight/bias gradients (a JAX
  ``vjp`` against torch autograd).
- ``pooling``: max, avg and sum; ``"valid"`` and ``"full"`` (ceil mode,
  on shapes where torch's own ``ceil_mode`` keeps fewer windows or
  divides otherwise); ``count_include_pad`` both ways; global pooling.
- ``batch_norm`` (predict mode, float32 and bf16 data with float32
  statistics) and ``batch_norm_train``: the forward's out, mean and
  variance, and the input, gamma and beta gradients with cotangents on
  all three outputs, including a channel whose mean is ~1e3 times its
  deviation (shifted by a mean estimate) and ``fix_gamma``.
- The ``BatchNorm`` layer: running statistics after two train-mode
  calls, predict mode, the default initialization (running variance
  one), ``cast`` keeping float32.

Tolerance: 1e-5 of each output's largest magnitude (float32 sums taken
in another order, so an element near zero has no useful relative
error); bf16 outputs one bf16 unit (2**-8 of the value: both round the
same float32 result once, which may straddle a rounding boundary).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import jax
import jax.numpy as jnp
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import op_impl_nn as jax_nn
from mxnet_tpu_torch import autograd, initializer
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import op_impl_nn

torch.set_num_threads(1)


def close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want[np.isfinite(want)]).max(initial=0)), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


CONV = {
    "1d": dict(x=(2, 4, 11), w=(6, 2, 3), kernel=(3,), stride=(2,),
               dilate=(2,), pad=(2,), num_group=2),
    "2d": dict(x=(2, 6, 9, 8), w=(9, 2, 3, 2), kernel=(3, 2), stride=(2, 1),
               dilate=(1, 2), pad=(1, 0), num_group=3),
    "3d": dict(x=(1, 4, 5, 6, 5), w=(4, 2, 2, 3, 1), kernel=(2, 3, 1),
               stride=(1, 2, 1), dilate=(2, 1, 1), pad=(1, 1, 0),
               num_group=2),
    "2d-plain": dict(x=(2, 3, 8, 8), w=(5, 3, 3, 3), kernel=(3, 3),
                     stride=(1, 1), dilate=(1, 1), pad=(1, 1), num_group=1),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(case):
    c = CONV[case]
    rng = np.random.RandomState(len(case))
    x = rng.randn(*c["x"]).astype(np.float32)
    w = rng.randn(*c["w"]).astype(np.float32)
    b = rng.randn(c["w"][0]).astype(np.float32)
    args = {k: c[k] for k in ("kernel", "stride", "dilate", "pad",
                              "num_group")}

    def jax_fn(x_, w_, b_):
        return jax_nn.convolution(x_, w_, b_, num_filter=c["w"][0], **args)

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, w, b)))
    dy = rng.randn(*want.shape).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = op_impl_nn.convolution(*t, num_filter=c["w"][0], **args)
    close(got, want)
    got.backward(torch.from_numpy(dy))
    for g, ref in zip(t, vjp(jnp.asarray(dy))):
        close(g.grad, ref)
    # no_bias drops the bias as the JAX op does
    close(op_impl_nn.convolution(t[0], t[1], t[2], no_bias=True, **args),
          jax_nn.convolution(*map(jnp.asarray, (x, w, b)), no_bias=True,
                             **args))


# (input shape, kernel, stride, pad)
POOL_SHAPES = {
    "1d": ((2, 3, 9), (3,), (2,), (1,)),
    "2d": ((2, 3, 6, 5), (3, 2), (2, 2), (1, 1)),
    # a last "full" window that starts in the padding (torch drops it)
    "2d-edge": ((1, 2, 5, 5), (2, 2), (2, 2), (1, 1)),
    "2d-wide-pad": ((1, 2, 7, 7), (3, 3), (2, 2), (2, 2)),
    "3d": ((1, 2, 5, 6, 4), (2, 3, 2), (2, 2, 1), (1, 1, 0)),
}


@pytest.mark.parametrize("shape", sorted(POOL_SHAPES))
@pytest.mark.parametrize("mode", ["max", "sum", "avg-incl", "avg-excl"])
@pytest.mark.parametrize("convention", ["valid", "full"])
def test_pooling_matches_jax(shape, mode, convention):
    xs, k, s, p = POOL_SHAPES[shape]
    x = np.random.RandomState(len(xs)).randn(*xs).astype(np.float32)
    kw = dict(kernel=k, stride=s, pad=p, pooling_convention=convention,
              pool_type=mode.split("-")[0],
              count_include_pad=mode != "avg-excl")
    want = jax_nn.pooling(jnp.asarray(x), **kw)
    got = op_impl_nn.pooling(torch.from_numpy(x), **kw)
    close(got, want)


@pytest.mark.parametrize("mode", ["max", "sum", "avg"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_global_pooling_keeps_dims(mode, ndim):
    x = np.random.RandomState(ndim).randn(*(2, 3) + (4,) * ndim) \
        .astype(np.float32)
    want = jax_nn.pooling(jnp.asarray(x), global_pool=True, pool_type=mode)
    got = op_impl_nn.pooling(torch.from_numpy(x), global_pool=True,
                             pool_type=mode)
    assert tuple(got.shape) == (2, 3) + (1,) * ndim
    close(got, want)


def _bn_inputs(shape, ax, seed, shifted=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 1.5 + 0.3
    c = shape[ax]
    if shifted:                       # channel 0: mean ~1e3 x its std
        idx = [slice(None)] * len(shape)
        idx[ax] = 0
        x[tuple(idx)] = 1000.0 + rng.randn(*x[tuple(idx)].shape) \
            .astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    m = rng.randn(c).astype(np.float32) * 0.1
    v = rng.rand(c).astype(np.float32) + 0.5
    return x, g, b, m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_predict_matches_jax(dtype, fix_gamma):
    x, g, b, m, v = _bn_inputs((3, 4, 5, 5), 1, 7)
    xj = jnp.asarray(x).astype(dtype)
    want = jax_nn.batch_norm(xj, *map(jnp.asarray, (g, b, m, v)), eps=1e-3,
                             fix_gamma=fix_gamma)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = op_impl_nn.batch_norm(xt, *map(torch.from_numpy, (g, b, m, v)),
                                eps=1e-3, fix_gamma=fix_gamma)
    assert got.dtype == xt.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -8, atol=1e-6)
    else:
        close(got, want)


BN_TRAIN = {
    "nchw": ((4, 6, 5, 5), 1, False, False, False),
    "nchw-fix-gamma": ((4, 6, 5, 5), 1, False, True, False),
    "shifted-mean": ((8, 3, 4, 4), 1, True, False, True),
    "last-axis": ((5, 7, 6), 2, False, False, True),
}


@pytest.mark.parametrize("case", sorted(BN_TRAIN))
def test_batch_norm_train_and_vjp_match_jax(case):
    shape, ax, shifted, fix_gamma, use_shift = BN_TRAIN[case]
    x, g, b, m, _ = _bn_inputs(shape, ax, len(case), shifted)
    shift = np.asarray(m)
    if shifted:
        shift[0] = 999.5                  # a running mean near the batch's
    kw = dict(eps=1e-5, axis=ax, fix_gamma=fix_gamma)
    jshift = jnp.asarray(shift) if use_shift else None
    (want, vjp) = jax.vjp(
        lambda a, c, e: jax_nn.batch_norm_train(a, c, e, jshift, **kw),
        *map(jnp.asarray, (x, g, b)))
    rng = np.random.RandomState(11)
    cts = [rng.randn(*w.shape).astype(np.float32) for w in want]
    t = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    got = op_impl_nn.batch_norm_train(
        *t, torch.from_numpy(shift) if use_shift else None, **kw)
    for gt, w, what in zip(got, want, ("out", "mean", "var")):
        assert gt.dtype == torch.float32, what
        close(gt, w)
    torch.autograd.backward(list(got), [torch.from_numpy(c) for c in cts])
    for gt, w, what in zip(t, vjp(tuple(map(jnp.asarray, cts))),
                           ("dx", "dgamma", "dbeta")):
        close(gt.grad, w)
    if fix_gamma:
        assert not t[1].grad.any()


def test_batch_norm_train_shift_guards_the_variance():
    """The one-pass variance of a channel at 1e3 +- 1 is right when
    shifted by a mean estimate; the same math as JAX's either way."""
    x, g, b, _, _ = _bn_inputs((8, 3, 4, 4), 1, 3, shifted=True)
    shift = torch.tensor([999.5, 0.0, 0.0])
    _, _, var = op_impl_nn.batch_norm_train(
        *map(torch.from_numpy, (x, g, b)), shift)
    want = x.astype(np.float64).var(axis=(0, 2, 3))
    np.testing.assert_allclose(var.numpy(), want, rtol=1e-4)


def _jax_bn(c, **kw):
    layer = jnn.BatchNorm(in_channels=c, **kw)
    layer.initialize()
    return layer


def _jax_value(p):
    return p.data().asnumpy()


@pytest.mark.parametrize("scale,center", [(True, True), (False, False)])
def test_batchnorm_layer_running_stats_match_jax(scale, center):
    """Two train-mode calls (the running statistics take each batch's
    mean and biased variance at momentum 0.9), then predict mode."""
    rng = np.random.RandomState(4)
    xs = [rng.randn(4, 3, 5, 5).astype(np.float32) * 2 + 1 for _ in range(3)]
    ref = _jax_bn(3, momentum=0.9, scale=scale, center=center)
    layer = nn.BatchNorm(in_channels=3, momentum=0.9, scale=scale,
                         center=center, device="cpu")
    layer.initialize()
    for a in xs[:2]:
        with jag.record():
            want = ref(mx.nd.array(a))
        with autograd.record():
            got = layer(torch.from_numpy(a))
        close(got, want.asnumpy())
    for name in ("running_mean", "running_var"):
        close(getattr(layer, name), _jax_value(getattr(ref, name)), 1e-6)
    close(layer(torch.from_numpy(xs[2])), ref(mx.nd.array(xs[2])).asnumpy())
    reqs = {k: p.grad_req for k, p in layer.collect_params().items()}
    assert reqs == {"gamma": "write" if scale else "null",
                    "beta": "write" if center else "null",
                    "running_mean": "null", "running_var": "null"}


@pytest.mark.parametrize("init", [None, "xavier", "zeros"])
def test_initialize_starts_running_var_at_one(init):
    """The default fill (and any initializer) gives running means 0 and
    running variances 1, as the JAX layer's initializers."""
    net = nn.HybridSequential().add(
        nn.Conv2D(4, 3, in_channels=2, prefix="conv2d0_", device="cpu"),
        nn.BatchNorm(in_channels=4, prefix="batchnorm0_", device="cpu"))
    net.initialize(init=init, seed=3)
    p = net.gluon_params()
    assert torch.equal(p["batchnorm0_running_var"], torch.ones(4))
    assert torch.equal(p["batchnorm0_running_mean"], torch.zeros(4))
    assert torch.equal(p["batchnorm0_gamma"], torch.ones(4))
    assert torch.equal(p["batchnorm0_beta"], torch.zeros(4))
    if init != "zeros":
        assert p["conv2d0_weight"].abs().max() > 0


def test_initializer_dispatch_by_name_sets_running_stats():
    for name, want in (("x_running_var", 1.0), ("x_running_mean", 0.0),
                       ("x_moving_var", 1.0)):
        t = torch.full((3,), 7.0)
        initializer.Xavier()(name, t)
        assert torch.equal(t, torch.full((3,), want)), name


def test_batchnorm_cast_keeps_float32_and_normalises_bf16():
    net = nn.HybridSequential().add(
        nn.Conv2D(4, 3, padding=1, in_channels=2, prefix="conv2d0_",
                  device="cpu"),
        nn.BatchNorm(in_channels=4, prefix="batchnorm0_", device="cpu"))
    net.initialize(init="xavier")
    net.cast("bfloat16")
    p = net.gluon_params()
    assert p["conv2d0_weight"].dtype == torch.bfloat16
    assert all(p[f"batchnorm0_{k}"].dtype == torch.float32
               for k in ("gamma", "beta", "running_mean", "running_var"))
    x = torch.rand(2, 2, 6, 6).to(torch.bfloat16)
    with autograd.record():
        y = net(x)
    autograd.backward(y.float().sum())
    assert y.dtype == torch.bfloat16
    assert p["batchnorm0_gamma"].grad.dtype == torch.float32
    assert p["conv2d0_weight"].grad.dtype == torch.bfloat16
    assert not torch.equal(p["batchnorm0_running_mean"], torch.zeros(4))


def test_conv_and_pool_layers_match_jax_layers():
    """Gluon's layer arguments reach the ops as the JAX layers pass
    them (weights carried by name)."""
    rng = np.random.RandomState(9)
    x = rng.rand(2, 4, 9, 9).astype(np.float32)
    pairs = [
        (jnn.Conv2D(6, (3, 2), strides=2, padding=1, groups=2,
                    activation="relu", in_channels=4),
         nn.Conv2D(6, (3, 2), strides=2, padding=1, groups=2,
                   activation="relu", in_channels=4, device="cpu")),
        (jnn.Conv2D(3, 1, use_bias=False, in_channels=4),
         nn.Conv2D(3, 1, use_bias=False, in_channels=4, device="cpu")),
        (jnn.MaxPool2D(3, 2, 1), nn.MaxPool2D(3, 2, 1)),
        (jnn.MaxPool2D(2, ceil_mode=True), nn.MaxPool2D(2, ceil_mode=True)),
        (jnn.AvgPool2D(3, 2, 1, count_include_pad=False),
         nn.AvgPool2D(3, 2, 1, count_include_pad=False)),
        (jnn.GlobalAvgPool2D(), nn.GlobalAvgPool2D()),
        (jnn.GlobalMaxPool2D(), nn.GlobalMaxPool2D()),
        (jnn.Flatten(), nn.Flatten()),
    ]
    for ref, layer in pairs:
        ref.initialize(init=mx.initializer.Xavier())
        want = ref(mx.nd.array(x))
        params = {k[len(ref.prefix):]: v.data().asnumpy()
                  for k, v in ref.collect_params().items()}
        layer.load_gluon_params(params)
        close(layer(torch.from_numpy(x)), want.asnumpy())
    xs = rng.rand(2, 3, 10).astype(np.float32)
    for ref, layer in ((jnn.AvgPool1D(3, 2, ceil_mode=True),
                        nn.AvgPool1D(3, 2, ceil_mode=True)),
                       (jnn.GlobalAvgPool1D(), nn.GlobalAvgPool1D())):
        close(layer(torch.from_numpy(xs)), ref(mx.nd.array(xs)).asnumpy())


def test_sequential_lambda_identity_and_names():
    net = nn.Sequential().add(
        nn.Dense(5, in_units=4, prefix="dense0_", device="cpu"),
        nn.Identity(), nn.Lambda("relu"),
        nn.HybridLambda(lambda F, x: F.op_impl_nn.activation(x, "tanh")),
        nn.Dense(2, in_units=5, prefix="dense1_", device="cpu"))
    net.initialize(seed=1)
    assert list(net.gluon_params()) == ["dense0_weight", "dense0_bias",
                                        "dense1_weight", "dense1_bias"]
    assert len(net) == 5 and isinstance(net[1], nn.Identity)
    head = net[:1]
    assert isinstance(head, nn.Sequential) and len(head) == 1
    x = torch.randn(3, 4)
    h = torch.tanh(torch.relu(net[0](x)))
    torch.testing.assert_close(net(x), net[4](h))
    assert net.hybridize(static_alloc=True) is net
    assert net[0]._hybridize == (True, {"static_alloc": True})
    # children left without prefixes are named by the name manager
    # (dense0_, dense1_, ...); two given the empty prefix clash
    clash = nn.Sequential().add(
        nn.Dense(2, in_units=2, prefix="", device="cpu"),
        nn.Dense(2, in_units=2, prefix="", device="cpu"))
    with pytest.raises(ValueError, match="two parameters named"):
        clash.gluon_params()


def test_batch_norm_float64_data_computes_in_float64():
    """float64 data (outside the JAX package's types) normalises and
    takes its statistics in float64, where float32 and narrower data
    take float32."""
    x, g, b, m, v = (a.astype(np.float64) for a in _bn_inputs((6, 3, 4, 4),
                                                                1, 2))
    out, mean, var = op_impl_nn.batch_norm_train(
        *map(torch.from_numpy, (x, g, b)))
    assert out.dtype == mean.dtype == var.dtype == torch.float64
    np.testing.assert_allclose(var.numpy(), x.var(axis=(0, 2, 3)),
                               rtol=1e-12)
    np.testing.assert_allclose(mean.numpy(), x.mean(axis=(0, 2, 3)),
                               rtol=1e-12)
    pred = op_impl_nn.batch_norm(*map(torch.from_numpy, (x, g, b, m, v)),
                                 fix_gamma=False)
    want = (x - m.reshape(1, -1, 1, 1)) / np.sqrt(v.reshape(1, -1, 1, 1)
                                                  + 1e-5) \
        * g.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)
    np.testing.assert_allclose(pred.numpy(), want, rtol=1e-12, atol=1e-12)
