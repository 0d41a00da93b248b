"""The port's ``Context`` and ``NDArray`` against the JAX package's, on
the CPU.

- ``Context``: ``cpu``/``gpu`` identity, ``with ctx:`` scopes nesting,
  ``current_context()`` is ``gpu(0)`` outside any scope (never the
  CPU), and a constructor without ``ctx`` raises without a card
  outside a CPU scope.
- NDArray methods (``asnumpy``, ``asscalar``, ``context``,
  ``as_in_context``, ``copyto``, ``astype``, ``attach_grad``/``grad``,
  ``detach``, pickling) and the constructors against the JAX
  NDArray's on the same data: values equal.
- ``backward()`` of a vector head (MXNet's head gradient of ones)
  equals the JAX ``autograd`` gradient within 1e-6.
- The block boundary: NDArray in gives NDArray out (lists too), a
  tensor in gives a tensor out with the same bits as before.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn, rnn

torch.set_num_threads(1)


def test_context_identity_and_scopes():
    assert tmx.cpu() == tmx.Context("cpu", 0) != tmx.gpu(0)
    assert repr(tmx.gpu(1)) == repr(mx.gpu(1)) == "gpu(1)"
    assert tmx.gpu(1).torch_device == torch.device("cuda", 1)
    assert tmx.Context(tmx.gpu(2)) == tmx.gpu(2)
    assert hash(tmx.cpu(0)) == hash(tmx.Context("cpu"))
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
        assert tmx.current_context() == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.num_gpus() == torch.cuda.device_count()
    with pytest.raises(MXNetError, match="unknown device type"):
        tmx.Context("tpu")


def test_no_card_means_gpu_and_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.gpu(0)
    for make in (lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nn.Dense(2, in_units=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with tmx.cpu():
        assert nd.array([1.0]).context == tmx.cpu()
        assert nn.Dense(2, in_units=2).weight.device.type == "cpu"
    with pytest.raises(ValueError, match="one device"):
        tmx.context.resolve_device([tmx.cpu(), tmx.cpu(1)])


def test_constructors_match_jax():
    x = np.random.RandomState(0).randn(3, 4)
    with tmx.cpu():
        pairs = [(nd.array(x), mx.nd.array(x)),
                 (nd.array(x, dtype="float64"), mx.nd.array(x, dtype="float64")),
                 (nd.array([[1, 2], [3, 4]]), mx.nd.array([[1, 2], [3, 4]])),
                 (nd.zeros((2, 3)), mx.nd.zeros((2, 3))),
                 (nd.ones(4, dtype="int32"), mx.nd.ones(4, dtype="int32")),
                 (nd.full((2,), 7.5), mx.nd.full((2,), 7.5)),
                 (nd.empty((2, 2)), mx.nd.empty((2, 2))),
                 (nd.arange(5), mx.nd.arange(5)),
                 (nd.arange(1, 7, 2, repeat=2), mx.nd.arange(1, 7, 2,
                                                             repeat=2)),
                 (nd.zeros_like(nd.array(x)), mx.nd.zeros_like(mx.nd.array(x))),
                 (nd.ones_like(nd.array(x)), mx.nd.ones_like(mx.nd.array(x)))]
    for got, want in pairs:
        assert isinstance(got, nd.NDArray)
        assert got.shape == want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    nd.waitall()


def test_methods_match_jax():
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    j = mx.nd.array(x)
    with tmx.cpu():
        t = nd.array(x)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.context == tmx.cpu() and t.ctx == tmx.cpu()
    assert t.numel() == j.size == 6 and t.size() == (2, 3)
    assert t.sum().asscalar() == pytest.approx(j.sum().asscalar(), rel=1e-6)
    assert t[0, 1].item() == j[0, 1].asscalar()
    with pytest.raises(MXNetError, match="not a scalar"):
        t.asscalar()
    assert t.as_in_context(tmx.cpu()) is t
    c = t.copyto(tmx.cpu())
    assert isinstance(c, nd.NDArray) and c.data_ptr() != t.data_ptr()
    dst = nd.zeros((2, 3), ctx="cpu")
    assert t.copyto(dst) is dst
    np.testing.assert_array_equal(dst.asnumpy(), x)
    for dt in ("float16", "int32", "float64", "bfloat16"):
        np.testing.assert_array_equal(t.astype(dt).asnumpy(),
                                      j.astype(dt).asnumpy()
                                      .astype(np.float32 if dt == "bfloat16"
                                              else dt))
    assert t.astype("float32", copy=False) is t
    assert isinstance(t.copy(), nd.NDArray)
    t.wait_to_read()
    with tmx.cpu():
        back = pickle.loads(pickle.dumps(t))
        b16 = pickle.loads(pickle.dumps(t.astype("bfloat16")))
    assert isinstance(back, nd.NDArray) and back.context == tmx.cpu()
    np.testing.assert_array_equal(back.asnumpy(), x)
    assert b16.dtype == torch.bfloat16


def test_vector_backward_matches_jax():
    x = np.random.RandomState(2).randn(5).astype(np.float32)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = jx * jx * 3 + jx
    jy.backward()
    with tmx.cpu():
        tx = nd.array(x)
    tx.attach_grad()
    assert isinstance(tx.grad, nd.NDArray)
    np.testing.assert_array_equal(tx.grad.asnumpy(), np.zeros(5))
    with ag.record():
        ty = tx * tx * 3 + tx
    assert isinstance(ty, nd.NDArray)
    ty.backward()
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-6)
    # "write": a second backward overwrites
    with ag.record():
        (tx * 2).backward()
    np.testing.assert_array_equal(tx.grad.asnumpy(), np.full(5, 2.0))
    out_grad = nd.array(np.arange(5), ctx="cpu")
    with ag.record():
        (tx * 2).backward(out_grad, train_mode=False)
    np.testing.assert_array_equal(tx.grad.asnumpy(), 2 * np.arange(5))
    with ag.record():
        y = tx * 2
    with pytest.raises(MXNetError, match="detach"):
        y.attach_grad()
    y.detach().attach_grad()


def test_block_boundary_rule():
    with tmx.cpu():
        net = nn.Dense(3, in_units=4)
        net.initialize(seed=3)
        lstm = rnn.LSTM(5, input_size=4)
        lstm.initialize(seed=4)
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    plain = net(torch.from_numpy(x))
    assert type(plain) is torch.Tensor
    wrapped = net(nd.array(x, ctx="cpu"))
    assert type(wrapped) is nd.NDArray
    assert torch.equal(wrapped.as_subclass(torch.Tensor), plain)
    seq = np.random.RandomState(4).randn(3, 2, 4).astype(np.float32)
    states = lstm.begin_state(2)
    assert all(type(s) is nd.NDArray for s in states)
    out, new = lstm(torch.from_numpy(seq),
                    [s.as_subclass(torch.Tensor) for s in states])
    assert type(out) is torch.Tensor and type(new[0]) is torch.Tensor
    out2, new2 = lstm(nd.array(seq, ctx="cpu"), states)
    assert type(out2) is nd.NDArray and type(new2[1]) is nd.NDArray
    assert torch.equal(out2.as_subclass(torch.Tensor), out)
    # states alone as NDArrays (inside a list) also switch the rule on
    out3, _ = lstm(torch.from_numpy(seq), states)
    assert type(out3) is nd.NDArray
