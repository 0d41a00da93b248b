"""The port's ResNets against the JAX package's, on the CPU.

- Names and shapes: the (name, shape) sets of ``resnet18_v1``,
  ``resnet50_v1``, ``resnet18_v2`` and ``resnet50_v2`` (model prefix
  stripped) are the JAX models' after a 32 x 32 forward: 299 names and
  25,629,032 elements for ``resnet50_v1``.
- ``resnet18_v1`` at 2 x 3 x 64 x 64, ``classes=10``, the JAX Xavier
  weights carried by name: the predict-mode forward, then one SGD
  step (lr 0.1, momentum 0.9, wd 1e-4) in train mode: its outputs and
  losses, then every weight and running statistic.
- A narrow ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128,
  256])`` and its V2 twin (bottleneck, downsample and pre-activation
  layers): one such step each, at the same size.
- ``SpaceToDepthStem`` against the plain 7x7 stride-2 stem on the same
  weight and against the JAX stem.

Why 64 x 64 and not 32 x 32: at 32 x 32 the last stage is 1 x 1, so
its BatchNorms normalise 2 values a channel, and the JAX op's one-pass
variance ``s2/n - mean**2`` (shifted by the running mean, which is
zero at the first step) cancels there in float32: the JAX model's own
float32 step-1 gradients are 10-30% away from the same math in
float64, so no float32 implementation that sums its convolutions in
another order can agree with it. At 64 x 64 (8 values a channel) the
JAX float32 gradients are within ~7e-5 of float64, and the port's
within 2e-5.

Tolerance: the forwards within 1e-5 (predict mode) and 1e-4 (train
mode) of scale of the JAX outputs. A training step is held three ways,
against the same math in float64 (the port's step run again with every
tensor in float64): the port's float32 step within 1e-4 of scale of
it; the JAX float32 step within 1e-2 of it (its own rounding: its sums
of squares and convolutions round otherwise, and at these shapes it
lands up to ~2e-3 of scale from the float64 math, most in the narrow
V1 net, where the port lands within 1e-5; a wiring fault moves results
by O(1)); and the port within the JAX step's own distance (+ 1e-4) of
it. So no float32 implementation could be held to 1e-4 of the JAX step
itself where that step is ~2e-3 off. The scale of a weight is its
largest magnitude; a tensor that starts at zero (biases, betas,
running means) holds after a step only what the step put there (lr x a
gradient that sums signed terms over the batch, or, for the
convolution biases that feed a BatchNorm, whose gradient is zero in
exact arithmetic, rounding noise ~1e-8), so such tensors take the
largest magnitude of all zero-started tensors of the model; a loss (in
nats) a scale of at least 1. Each JAX reference is computed once.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

torch.set_num_threads(1)

SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def close(got, want, tol, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = scale or max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _jax_params(net):
    return {k[len(net.prefix):]: v.data().asnumpy()
            for k, v in net.collect_params().items()}


def _data(classes, seed=0, size=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 3, size, size).astype(np.float32)
    y = rng.randint(0, classes, 2).astype(np.float32)
    return x, y


def _jax_run(net, x, y, steps):
    """Predict-mode forward (resolves the deferred shapes), then
    ``steps`` SGD steps in train mode; the JAX side of the parity."""
    xj, yj = mx.nd.array(x), mx.nd.array(y)
    with jag.predict_mode():
        pred = net(xj).asnumpy()
    start = _jax_params(net)
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    outs, losses = [], []
    for _ in range(steps):
        with jag.record():
            out = net(xj)
            loss = loss_fn(out, yj)
        loss.backward()
        trainer.step(x.shape[0])
        outs.append(out.asnumpy())
        losses.append(loss.asnumpy())
    return {"start": start, "pred": pred, "outs": outs, "losses": losses,
            "end": _jax_params(net)}


def _scales(ref):
    """Each compared tensor's scale (see the module docstring)."""
    zero = {k for k, v in ref["start"].items() if not v.any()}
    zero_scale = max(float(np.abs(ref["end"][k]).max()) for k in zero)
    out = {k: zero_scale if k in zero else float(np.abs(v).max())
           for k, v in ref["end"].items()}
    for i, (o, l) in enumerate(zip(ref["outs"], ref["losses"])):
        out[f"out{i}"] = float(np.abs(o).max())
        out[f"loss{i}"] = max(float(np.abs(l).max()), 1.0)
    return out


def _flat(run):
    """The compared results of a run: outputs and losses of each step,
    then every parameter."""
    out = dict(run["end"])
    for i, (o, l) in enumerate(zip(run["outs"], run["losses"])):
        out[f"out{i}"], out[f"loss{i}"] = o, l
    return out


def _check_steps(port32, port64, ref, tol=1e-4, ref_tol=1e-2):
    """The port's float32 run within ``tol`` of scale of the same math
    in float64; the JAX float32 run within ``ref_tol`` of that float64
    run (its own rounding; a wiring fault moves results by O(1)); and
    the port within the JAX run's own distance (+ ``tol``) of it.
    Returns the JAX run's largest distance, in units of scale."""
    scales = _scales(ref)
    got, exact, want = _flat(port32), _flat(port64), _flat(ref)
    assert set(got) == set(want)
    worst = 0.0
    for k, s in scales.items():
        e_port = np.abs(got[k] - exact[k]).max() / s
        e_ref = np.abs(want[k] - exact[k]).max() / s
        gap = np.abs(got[k] - want[k]).max() / s
        assert e_port <= tol, (k, e_port)
        assert e_ref <= ref_tol, (k, e_ref)
        assert gap <= e_ref + tol, (k, gap, e_ref)
        worst = max(worst, e_ref)
    return worst


def _port_run(make, ref, x, y, steps, dtype=torch.float32):
    """The JAX run's steps in the port, from its start weights, in
    ``dtype``; numpy results as ``_jax_run``'s."""
    net = make()
    net.load_gluon_params(ref["start"])
    net.cast(dtype)
    xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y)
    pred = net(xt)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    outs, losses = [], []
    for _ in range(steps):
        with autograd.record():
            out = net(xt)
            loss = loss_fn(out, yt)
        autograd.backward(loss)
        trainer.step(x.shape[0])
        outs.append(out.detach().double().numpy())
        losses.append(loss.detach().double().numpy())
    return {"pred": pred.detach().double().numpy(), "outs": outs,
            "losses": losses,
            "end": {k: p.detach().double().numpy()
                    for k, p in net.gluon_params().items()}}


@pytest.fixture(scope="module")
def resnet18_run():
    x, y = _data(10)
    mx.random.seed(0)
    net = jvision.resnet18_v1(classes=10)
    net.initialize(init=mx.initializer.Xavier())
    return x, y, _jax_run(net, x, y, steps=1)


def test_resnet18_v1_predict_forward_matches_jax(resnet18_run):
    x, y, ref = resnet18_run
    net = vision.resnet18_v1(classes=10, device="cpu")
    net.load_gluon_params(ref["start"])
    close(net(torch.from_numpy(x)), ref["pred"], 1e-5)


def test_resnet18_v1_sgd_steps_match_jax(resnet18_run):
    x, y, ref = resnet18_run

    def make():
        return vision.resnet18_v1(classes=10, device="cpu")

    port = _port_run(make, ref, x, y, steps=1)
    close(port["pred"], ref["pred"], 1e-5)
    close(port["outs"][0], ref["outs"][0], 1e-4)
    exact = _port_run(make, ref, x, y, steps=1, dtype=torch.float64)
    _check_steps(port, exact, ref)
    # every weight, bias, gamma, beta and running statistic moved
    assert all(not np.array_equal(v, ref["start"][k])
               for k, v in ref["end"].items())


@pytest.mark.parametrize("version", [1, 2])
def test_narrow_bottleneck_resnet_step_matches_jax(version):
    layers, channels = [1, 1, 1, 1], [16, 32, 64, 128, 256]
    jnet = getattr(jresnet, f"ResNetV{version}")(
        getattr(jresnet, f"BottleneckV{version}"), layers, channels,
        classes=10)
    mx.random.seed(version)
    jnet.initialize(init=mx.initializer.Xavier())
    x, y = _data(10, seed=version)
    ref = _jax_run(jnet, x, y, steps=1)

    def make():
        return getattr(resnet, f"ResNetV{version}")(
            getattr(resnet, f"BottleneckV{version}"), layers, channels,
            classes=10, device="cpu")

    port = _port_run(make, ref, x, y, steps=1)
    close(port["pred"], ref["pred"], 1e-5)
    close(port["outs"][0], ref["outs"][0], 1e-4)
    _check_steps(port, _port_run(make, ref, x, y, 1, torch.float64), ref)


@pytest.mark.parametrize("name,count,elements", [
    ("resnet18_v1", 102, 11699112), ("resnet50_v1", 299, 25629032),
    ("resnet18_v2", 98, 11695796), ("resnet50_v2", 259, 25595060)])
def test_names_and_shapes_match_jax(name, count, elements):
    jnet = getattr(jvision, name)(classes=1000)
    jnet.initialize()
    with jag.predict_mode():
        jnet(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    want = {(k[len(jnet.prefix):], tuple(v.shape))
            for k, v in jnet.collect_params().items()}
    net = getattr(vision, name)(classes=1000, device="cpu")
    got = {(k, tuple(p.shape)) for k, p in net.gluon_params().items()}
    assert got == want
    assert len(got) == count
    assert sum(int(np.prod(s)) for _, s in got) == elements
    reqs = {k: p.grad_req for k, p in net.collect_params().items()}
    assert {k for k, r in reqs.items() if r == "null"} == {
        k for k, p in jnet.collect_params().items()
        for k in [k[len(jnet.prefix):]] if p.grad_req == "null"}


def test_space_to_depth_stem_matches_plain_stem_and_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    w = rng.randn(16, 3, 7, 7).astype(np.float32)
    stem = resnet.SpaceToDepthStem(16, 3, device="cpu")
    stem.load_gluon_params({"weight": w})
    got = stem(torch.from_numpy(x))
    plain = torch.nn.functional.conv2d(torch.from_numpy(x),
                                       torch.from_numpy(w), stride=2,
                                       padding=3)
    close(got, plain.numpy(), 1e-5)
    jstem = jresnet.SpaceToDepthStem(16, in_channels=3)
    jstem.initialize()
    jstem(mx.nd.array(x))
    jstem.weight.set_data(mx.nd.array(w))
    close(got, jstem(mx.nd.array(x)).asnumpy(), 1e-5)
    with pytest.raises(ValueError, match="even H and W"):
        stem(torch.zeros(1, 3, 31, 32))
    # as a model's stem: the same output as the plain stem's model
    nets = [vision.resnet18_v2(classes=10, stem=s, device="cpu")
            for s in ("conv", "s2d")]
    nets[0].initialize(init="xavier", seed=2)
    params = {k.replace("conv2d0_", "spacetodepthstem0_")
              if k.startswith("conv2d0_") else k: p.detach().numpy()
              for k, p in nets[0].gluon_params().items()}
    nets[1].load_gluon_params(params)
    close(nets[1](torch.from_numpy(x)), nets[0](torch.from_numpy(x))
          .detach().numpy(), 1e-5)


def test_model_zoo_entry_points(tmp_path):
    net = vision.get_model("ResNet18_V1", classes=4, thumbnail=True,
                           device="cpu")
    net.initialize()
    assert tuple(net(torch.rand(1, 3, 8, 8)).shape) == (1, 4)
    assert "conv2d0_weight" in net.gluon_params() and \
        net.gluon_params()["conv2d0_weight"].shape == (64, 3, 3, 3)
    assert type(vision.get_model("mobilenet1.0", classes=4,
                                 device="cpu")).__name__ == "MobileNet"
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("resnet9000_v1")
    marked = vision.resnet18_v1(remat_stages=(3,), device="cpu")
    stages = [m for m in marked.features.children()
              if m.prefix.startswith("stage")]
    assert [all(b._remat for b in st.children()) for st in stages] == \
        [False, False, True, False]
    with pytest.raises(ValueError, match="names:bn_out"):
        vision.resnet18_v1(remat_stages=(3,), remat_policy="names:bn_out",
                           device="cpu")
    # the local model store never downloads: a miss names the way in
    with pytest.raises(MXNetError, match="publish_model_file"):
        vision.resnet18_v1(pretrained=True, root=str(tmp_path),
                           device="cpu")
    with pytest.raises(ValueError):
        vision.get_resnet(3, 18)


def test_resnet_bf16_cast_trains():
    """``cast("bfloat16")``: convolutions and the Dense in bf16,
    BatchNorm in float32; a recorded step gives finite bf16 logits and
    gradients of each parameter's own type."""
    net = vision.resnet18_v1(classes=10, thumbnail=True, device="cpu")
    net.initialize(init="xavier", seed=1)
    net.cast("bfloat16")
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", dict(SGD))
    x = torch.rand(2, 3, 8, 8).to(torch.bfloat16)
    with autograd.record():
        out = net(x)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, torch.tensor([1, 2]))
    autograd.backward(loss)
    trainer.step(2)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    for name, p in params.items():
        want = torch.float32 if "batchnorm" in name else torch.bfloat16
        assert p.dtype == want, name
        if p.grad_req != "null":
            assert p.grad().dtype == want and \
                bool(torch.isfinite(p.grad()).all()), name
