"""``nd.contrib``'s control flow (``ops/control_flow.py``) and ``mx.viz``
against the JAX package, on the CPU.

The same numpy-seeded arrays go through both packages' ``foreach``,
``while_loop`` and ``cond`` with the same callbacks (written once over
``F``, either package's ``mx.nd``): results within 1e-6 of scale
(float32; the JAX loops run as ``lax.scan``/``while_loop``/``cond``,
one XLA program, the port's step by step), structures equal (a list of
states stays a list, ``while_loop`` gives ``(None, vars)``). A
hybridized block calling ``foreach`` goes through its CachedOp (on the
card, a CUDA graph: no host read), and one calling ``cond`` through
the CachedOp's eager key (the predicate's read, ``graphs.host_read``).
``print_summary`` of the same exported graph prints the JAX package's
table line for line and returns its parameter total, which is the
Gluon net's; ``plot_network`` draws every operator and hides the
weights (or, without graphviz, raises ``ImportError`` naming it).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, graphs, nd

torch.set_num_threads(1)


def close(got, want, tol=1e-6, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def both(fn):
    """``fn(mx, arrays)`` in each package on the same numpy arrays."""
    rs = np.random.RandomState(0)
    data = [rs.randn(5, 3, 4).astype(np.float32),
            rs.randn(3, 4).astype(np.float32)]
    with tmx.cpu():
        return (fn(jmx, [jmx.nd.array(a) for a in data]),
                fn(tmx, [tmx.nd.array(a) for a in data]))


def flat(x):
    if x is None:
        return [None]
    if isinstance(x, (list, tuple)):
        return [type(x).__name__] + [v for i in x for v in flat(i)]
    return [x.asnumpy()]


def same(j, t):
    fj, ft = flat(j), flat(t)
    assert len(fj) == len(ft)
    for a, b in zip(fj, ft):
        if isinstance(a, np.ndarray):
            close(b, a)
        else:
            assert a == b


def rnn_step(F):
    def body(x, states):
        h = F.tanh(x + states[0] * 0.5)
        return [h, h * 2], [h]
    return body


def test_foreach_equals_the_jax_package():
    same(*both(lambda mx, d: mx.nd.contrib.foreach(rnn_step(mx.nd), d[0],
                                                   [d[1]])))
    # a list of data stepped together, one array of states
    same(*both(lambda mx, d: mx.nd.contrib.foreach(
        lambda xs, s: (xs[0] * xs[1] + s, s + 1), [d[0], d[0] * 2], d[1])))


def test_while_loop_and_cond_equal_the_jax_package():
    def loop(mx, d):
        return mx.nd.contrib.while_loop(
            lambda i, s: i < 4, lambda i, s: (None, [i + 1, s * 1.5 + i]),
            [mx.nd.array([0.0]), d[1]], max_iterations=10)
    same(*both(loop))

    def capped(mx, d):
        return mx.nd.contrib.while_loop(
            lambda i, s: i < 100, lambda i, s: (None, (i + 1, s - 1)),
            [mx.nd.array([0.0]), d[1]], max_iterations=3)
    same(*both(capped))
    for sign in (1.0, -1.0):
        same(*both(lambda mx, d: mx.nd.contrib.cond(
            lambda a, b: (a.sum() * sign) > 0,
            lambda a, b: [a * 2, b], lambda a, b: [b - a, a],
            [d[1], d[1] + 1])))
    with pytest.raises(ValueError, match="max_iterations"):
        tmx.nd.contrib.while_loop(lambda i: i < 2, lambda i: (None, i + 1),
                                  [tmx.nd.array([0.0], ctx=tmx.cpu())])


class _Scan(gluon.HybridBlock):
    def __init__(self, use_cond):
        super().__init__(prefix="scan_")
        self._use_cond = use_cond

    def hybrid_forward(self, F, x, h):
        if self._use_cond:
            return F.contrib.cond(lambda a, b: a.sum() > 0,
                                  lambda a, b: a + b, lambda a, b: a - b,
                                  [x[0], h])
        outs, states = F.contrib.foreach(rnn_step(F), x, [h])
        return outs[0], states[0]


@pytest.mark.parametrize("use_cond", [False, True])
def test_hybridized_blocks_run_control_flow(use_cond):
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(4, 2, 3).astype(np.float32))
    h = torch.tensor(rs.randn(2, 3).astype(np.float32))
    net = _Scan(use_cond)
    eager = net(x, h)
    net.hybridize()
    reads = graphs._host_reads()
    for _ in range(2):
        hyb = net(x, h)
    for a, b in zip(eager if isinstance(eager, tuple) else [eager],
                    hyb if isinstance(hyb, tuple) else [hyb]):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert (graphs._host_reads() > reads) is use_cond


def test_print_summary_equals_the_jax_package(tmp_path):
    with tmx.cpu():
        tnet = gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                  prefix="resnetv10_")
        tfile, _ = tnet.export(str(tmp_path / "r18"))
    shape = {"data": (1, 3, 32, 32)}
    outs = []
    for mx in (jmx, tmx):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = mx.viz.print_summary(mx.sym.load(tfile), shape=shape)
        outs.append((total, buf.getvalue()))
    assert outs[1] == outs[0]
    assert outs[1][0] == sum(t.numel() for t in tnet.gluon_params().values())
    assert outs[1][1].count("(Convolution)") == 20
    try:
        import graphviz
    except ImportError:
        graphviz = None
    if graphviz is None:
        with pytest.raises(ImportError, match="graphviz"):
            tmx.viz.plot_network(tmx.sym.load(tfile))
    else:
        dot = tmx.viz.plot_network(tmx.sym.load(tfile))
        assert dot.source.count("Convolution") == 20
        assert "resnetv10_conv2d0_weight" not in dot.source
