"""The port's ``NDArray`` methods against the JAX package's ``NDArray``
on the same data (CPU): MXNet's meaning where torch's method of the
same name means something else (``flatten`` keeps the first axis,
``max(axis=)`` gives an array, ``reshape`` reads MXNet's codes,
``transpose(axes=)`` permutes, ``expand_dims`` exists, ``repeat``
repeats elements, ``split`` takes a number of outputs, ``take`` works
along axis 0, ``sort``/``topk`` give arrays). Float results within
1e-5, integer and ordering results exact. Torch's own code paths that
receive NDArrays (the gradient, optimizer states, ``torch.save``) keep
working."""
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd

torch.set_num_threads(1)

X = np.array([[1.0, 5.0], [3.0, 2.0]], np.float32)
RS = np.random.RandomState(11)
Y = RS.uniform(-1, 1, (2, 3, 4)).astype(np.float32)
IDX = np.array([1, 0, 1], np.float32)


def _like(x, vals):
    """An array of ``vals`` from ``x``'s package."""
    return (tnd if isinstance(x, tnd.NDArray) else jmx.nd).array(vals)


def _both(fn, data=Y):
    want = fn(jmx.nd.array(data))
    with tmx.cpu():
        got = fn(tnd.array(data))
    return got, want


def _np(x):
    return [_np(v) for v in x] if isinstance(x, (list, tuple)) \
        else x.asnumpy()


def _same(got, want, exact=False):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_np(g, w, exact)
    else:
        _same_np(got, want, exact)


def _same_np(got, want, exact):
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the faults: torch's meaning came through on the port's NDArray
def test_flatten_keeps_the_first_axis():
    got, want = _both(lambda x: x.flatten(), X)
    assert got.shape == (2, 2)
    _same(got, want)


def test_max_with_axis_gives_an_array():
    got, want = _both(lambda x: x.max(axis=1), X)
    assert isinstance(got, tnd.NDArray)
    _same(got, want)
    np.testing.assert_array_equal(got.asnumpy(), [5.0, 3.0])


def test_reshape_takes_mxnet_codes():
    got, want = _both(lambda x: x.reshape((0, -1)), X)
    _same(got, want)


def test_transpose_takes_axes():
    # MXNet's keyword; the JAX NDArray takes the axes positionally
    want = jmx.nd.array(X).transpose((1, 0))
    with tmx.cpu():
        got = tnd.array(X).transpose(axes=(1, 0))
    _same(got, want)
    np.testing.assert_array_equal(got.asnumpy(), X.T)


def test_expand_dims():
    got, want = _both(lambda x: x.expand_dims(axis=0), X)
    assert got.shape == (1, 2, 2)
    _same(got, want)


CASES = {
    "slice": lambda x: x.slice(begin=(0, 1, 0), end=(2, 3, 2)),
    "slice_axis": lambda x: x.slice_axis(axis=2, begin=1, end=3),
    "take": lambda x: x.take(_like(x, IDX)),
    "reshape_star": lambda x: x.reshape(6, 4),
    "reshape_kw": lambda x: x.reshape(shape=(-3, 0)),
    "transpose_star": lambda x: x.transpose(2, 0, 1),
    "transpose_none": lambda x: x.transpose(),
    "T": lambda x: x.T,
    "swapaxes": lambda x: x.swapaxes(0, 2),
    "flatten3": lambda x: x.flatten(),
    "squeeze": lambda x: x.expand_dims(1).squeeze(axis=1),
    "broadcast_to": lambda x: x.slice_axis(axis=0, begin=0, end=1)
    .broadcast_to((3, 0, 0)),
    "tile": lambda x: x.tile((1, 2, 1)),
    "repeat": lambda x: x.repeat(2, axis=1),
    "repeat_flat": lambda x: x.repeat(2),
    "flip": lambda x: x.flip(axis=2),
    "split": lambda x: x.split(2, axis=2),
    "split_squeeze": lambda x: x.split(2, axis=0, squeeze_axis=True),
    "sum": lambda x: x.sum(axis=(0, 2), keepdims=True),
    "nansum": lambda x: x.nansum(axis=1),
    "mean": lambda x: x.mean(),
    "max": lambda x: x.max(axis=2),
    "min": lambda x: x.min(axis=(1, 2)),
    "prod": lambda x: x.prod(axis=0),
    "norm": lambda x: x.norm(axis=1),
    "abs": lambda x: x.abs(),
    "exp": lambda x: x.exp(),
    "log": lambda x: x.abs().log(),
    "sqrt": lambda x: x.abs().sqrt(),
    "square": lambda x: x.square(),
    "sigmoid": lambda x: x.sigmoid(),
    "relu": lambda x: x.relu(),
    "softmax": lambda x: x.softmax(axis=1),
    "log_softmax": lambda x: x.log_softmax(),
    "tanh": lambda x: x.tanh(),
    "clip": lambda x: x.clip(-0.3, 0.4),
    "sign": lambda x: x.sign(),
    "dot": lambda x: x.reshape((6, 4)).dot(x.reshape((6, 4)),
                                           transpose_b=True),
    "zeros_like": lambda x: x.zeros_like(),
    "ones_like": lambda x: x.ones_like(),
    "sort": lambda x: x.sort(axis=1, is_ascend=False),
    "topk_value": lambda x: x.topk(axis=2, k=2, ret_typ="value"),
    "astype": lambda x: x.astype("float64"),
    "copy": lambda x: x.copy(),
}
EXACT = {
    "argmax": lambda x: x.argmax(axis=1),
    "argmin": lambda x: x.argmin(),
    "argsort": lambda x: x.argsort(axis=2),
    "topk": lambda x: x.topk(axis=2, k=2),
    "round": lambda x: (x * 4).round(),
    "floor": lambda x: (x * 4).floor(),
    "ceil": lambda x: (x * 4).ceil(),
    "one_hot": lambda x: x.slice_axis(axis=2, begin=0, end=1)
    .reshape((-1,)).abs().floor().one_hot(3),
    "pick": lambda x: x.reshape((6, 4)).pick(
        _like(x, [0, 3, 1, 2, 2, 0]), axis=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_matches_jax(name):
    got, want = _both(CASES[name])
    _same(got, want)


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_method_matches_jax(name):
    got, want = _both(EXACT[name])
    _same(got, want, exact=True)


def test_torch_style_reductions_still_read():
    with tmx.cpu():
        x = tnd.array(Y)
        np.testing.assert_allclose(x.sum(dim=1).asnumpy(), Y.sum(1),
                                   rtol=1e-6)
        np.testing.assert_allclose(x.mean(dim=0, keepdim=True).asnumpy(),
                                   Y.mean(0, keepdims=True), rtol=1e-6)
        assert x.size() == (2, 3, 4) and x.numel() == 24


def test_torch_internals_keep_working_on_ndarrays():
    """The gradient, torch.save/load, torch.testing and an optimizer step
    meet NDArrays whose methods now carry MXNet's meaning."""
    with tmx.cpu():
        w = tnd.array(Y)
        w.attach_grad()
        with tmx.autograd.record():
            loss = (w * w).sum()
        loss.backward()
        g = w.grad
        assert isinstance(g, tnd.NDArray)
        np.testing.assert_allclose(g.asnumpy(), 2 * Y, rtol=1e-6)
        torch.testing.assert_close(g, 2 * w.detach(), rtol=1e-6, atol=0)
        buf = io.BytesIO()
        torch.save({"w": w.detach()}, buf)
        buf.seek(0)
        back = torch.load(buf, weights_only=False)["w"]
        np.testing.assert_array_equal(np.asarray(back.asnumpy()), Y)
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.1})
        x = tnd.array(Y.reshape(6, 4))
        with tmx.autograd.record():
            out = net(x).sum()
        out.backward()
        w0 = net.weight.detach().clone()
        trainer.step(6)
        assert not torch.equal(net.weight.detach(), w0)
        assert np.isfinite(net.weight.detach().numpy()).all()
