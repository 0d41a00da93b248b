"""The PyTorch port's autograd contract against the JAX package's.

Recording and train/predict mode are global autograd state, blocks
record only inside ``record()``, ``Dropout`` follows train mode, and
``grad_req`` keeps MXNet's meaning: two backwards with no ``zero_grad``
between them leave the second gradient under ``"write"``, the sum
under ``"add"`` and none under ``"null"``. Each is held against the
JAX package on the same numpy weights and inputs; gradients agree
within 1e-6 (float32 products of a few terms).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.base import MXNetError
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.base import MXNetError as TorchMXNetError
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(1)


def _scope_trace(mod):
    seen = [(mod.is_recording(), mod.is_training())]
    with mod.record():
        seen.append((mod.is_recording(), mod.is_training()))
        with mod.pause():
            seen.append((mod.is_recording(), mod.is_training()))
            with mod.train_mode():
                seen.append((mod.is_recording(), mod.is_training()))
        with mod.predict_mode():
            seen.append((mod.is_recording(), mod.is_training()))
        seen.append((mod.is_recording(), mod.is_training()))
    with mod.record(train_mode=False):
        seen.append((mod.is_recording(), mod.is_training()))
    seen.append((mod.is_recording(), mod.is_training()))
    return seen


def test_scopes_nest_as_in_the_jax_package():
    assert _scope_trace(ag) == _scope_trace(jag)


def test_blocks_record_only_inside_record():
    layer = tnn.Dense(3, in_units=4, device="cpu").initialize(seed=0)
    x = torch.randn(2, 4)
    assert not layer(x).requires_grad
    with ag.record():
        assert layer(x).requires_grad
        with ag.pause():
            assert not layer(x).requires_grad
    assert layer.weight.requires_grad          # grad_req "write"


def test_dropout_follows_train_mode():
    drop = tnn.Dropout(0.5)
    x = torch.ones(4000)
    assert torch.equal(drop(x), x)                 # predict mode
    with ag.record(train_mode=False):
        assert torch.equal(drop(x), x)
    for scope in (ag.record, ag.train_mode):
        with scope():
            y = drop(x)
        assert 1500 < int((y == 0).sum()) < 2500
        assert set(y.unique().tolist()) == {0.0, 2.0}


def _dense_pair(rng):
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jnet.weight.set_data(mx.nd.array(w))
    jnet.bias.set_data(mx.nd.array(b))
    tnet = tnn.Dense(3, in_units=4, device="cpu")
    tnet.load_gluon_params({"weight": w, "bias": b})
    return jnet, tnet


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_the_jax_package(req):
    rng = np.random.RandomState(0)
    jnet, tnet = _dense_pair(rng)
    jnet.collect_params().setattr("grad_req", req)
    tnet.collect_params().setattr("grad_req", req)
    for _ in range(2):                   # no zero_grad in between
        x = rng.randn(5, 4).astype(np.float32)
        w = rng.randn(5, 3).astype(np.float32)
        with jag.record():
            jl = (jnet(mx.nd.array(x)) * mx.nd.array(w)).sum()
        jl.backward()
        with ag.record():
            tl = (tnet(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
        if req == "null":         # no gradient path: a no-op, as in MXNet
            with pytest.warns(UserWarning, match="no gradient"):
                ag.backward(tl)
        else:
            tl.backward()
    for name in ("weight", "bias"):
        jp, tp = jnet.collect_params()[jnet.prefix + name], \
            tnet.collect_params()[name]
        assert tp.grad_req == req
        if req == "null":
            with pytest.raises(MXNetError):
                jp.grad()
            with pytest.raises(TorchMXNetError):
                tp.grad()
            continue
        np.testing.assert_allclose(tp.grad().numpy(), jp.grad().asnumpy(),
                                   rtol=1e-6, atol=1e-6)


def test_zero_grad_and_untouched_leaves_keep_mxnet_semantics():
    layer = tnn.Dense(2, in_units=3, device="cpu").initialize(seed=1)
    other = tnn.Dense(2, in_units=3, device="cpu").initialize(seed=2)
    x = torch.randn(4, 3)
    params = layer.collect_params()
    assert params["weight"].grad().abs().sum() == 0   # zeros before
    with ag.record():
        layer(x).sum().backward()
    first = params["weight"].grad().clone()
    with ag.record():
        other(x).sum().backward()       # does not reach ``layer``
    assert torch.equal(params["weight"].grad(), first)
    layer.zero_grad()
    assert params["weight"].grad().abs().sum() == 0
    assert layer.collect_params()["weight"] is params["weight"]


def test_backward_head_grads_and_grad_match_the_jax_package():
    rng = np.random.RandomState(1)
    jnet, tnet = _dense_pair(rng)
    x = rng.randn(5, 4).astype(np.float32)
    hg = rng.randn(5, 3).astype(np.float32)
    with jag.record():
        jy = jnet(mx.nd.array(x))
    jag.backward(jy, mx.nd.array(hg))
    with ag.record():
        ty = tnet(torch.from_numpy(x))
    ag.backward(ty, torch.from_numpy(hg))
    np.testing.assert_allclose(tnet.weight.grad.numpy(),
                               jnet.weight.grad().asnumpy(), rtol=1e-6,
                               atol=1e-6)
    # grad(): returned, and no .grad written
    before = tnet.weight.grad.clone()
    xv = torch.from_numpy(x).requires_grad_()
    with ag.record():
        ty = tnet(xv)
    (gx,) = ag.grad(ty, [xv], torch.from_numpy(hg))
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = jnet(jx)
    (jgx,) = jag.grad(jy, [jx], mx.nd.array(hg))
    np.testing.assert_allclose(gx.numpy(), jgx.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(tnet.weight.grad, before)
    assert xv.grad is None


def test_mark_variables_attaches_a_gradient():
    x = torch.arange(6.0).reshape(2, 3)
    ag.mark_variables([x], [torch.zeros_like(x)], "add")
    for _ in range(2):
        with ag.record():
            (x * x).sum().backward()
    assert torch.equal(x.grad, 4 * x.detach())
    with pytest.raises(ValueError, match="grad_req"):
        ag.set_grad_req(x, "sometimes")
