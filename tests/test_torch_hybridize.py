"""``hybridize`` on the port against the JAX package's, on the CPU.

On the CPU the port's CachedOp keeps its keys, static input copies and
output structure and runs the eager body where the card would replay a
CUDA graph; the JAX side runs hybridized, as its own tests run it
(``tests/test_gluon.py``), its Pallas kernels in interpret mode. Same
weights in both (the port's, copied into the JAX model), numpy inputs
from seeds. Tolerances: outputs within 1e-5 relative, gradients within
1e-4 of each parameter's largest JAX gradient.

Cases: ``HybridSequential(Dense, BatchNorm, Activation, Dense)``
(predict outputs, training outputs under ``record``, the running
statistics after 3 calls, gradients); cache entries against JAX's
``_cached_graph``; a user ``hybrid_forward`` block; BERT at 2 layers and
64 units (a hybridized training step, and
``bert_serving_entry(hybridize=True)`` through ``ServingEngine``:
answers and capture counts against the JAX engine's compile counts); a
``DecodeEngine`` (greedy streams against its model's bodies called
directly and JAX's, counters against JAX's); ``functionalize``; remat
(gradients as without it, and a small ResNet with ``remat_stages=(2,
3)`` against JAX's). Also the capture count of a thread and the bound
on recorded entries, which the JAX package does not have.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import graphs, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import functionalize

torch.set_num_threads(1)

OUT_RTOL = 1e-5         # outputs, relative
GRAD_TOL = 1e-4         # gradients, of the largest JAX gradient


def close_out(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=OUT_RTOL,
                               atol=OUT_RTOL * float(np.abs(want).max()))


def close_grad(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                               err_msg=name)


def _copy_into_jax(tnet, jnet):
    """The port's weights into the JAX block (its names carry the
    JAX model's prefix)."""
    jp = jnet.collect_params()
    for name, p in tnet.gluon_params().items():
        # a copy: the JAX array may alias a numpy buffer, and the port
        # updates its running statistics in place
        jp[jnet.prefix + name].set_data(
            jmx.nd.array(p.detach().numpy().copy()))


def _mlp_pair():
    tnet = nn.HybridSequential(prefix="net_")
    with tnet.name_scope():
        # no bias before the BatchNorm: its gradient is 0 up to rounding
        tnet.add(nn.Dense(8, in_units=4, use_bias=False, device="cpu"),
                 nn.BatchNorm(in_channels=8, device="cpu"),
                 nn.Activation("relu"),
                 nn.Dense(3, in_units=8, device="cpu"))
    tnet.initialize(seed=3)
    jnet = jnn.HybridSequential(prefix="net_")
    with jnet.name_scope():
        jnet.add(jnn.Dense(8, in_units=4, use_bias=False),
                 jnn.BatchNorm(in_channels=8),
                 jnn.Activation("relu"), jnn.Dense(3, in_units=8))
    jnet.initialize()
    _copy_into_jax(tnet, jnet)
    return tnet, jnet


X = np.random.RandomState(0).randn(6, 4).astype(np.float32)
HEAD = np.random.RandomState(1).randn(6, 3).astype(np.float32)


def test_hybrid_sequential_matches_jax():
    """Predict outputs, training outputs under ``record``, the running
    statistics after 3 recorded calls and the gradients of the sum."""
    tnet, jnet = _mlp_pair()
    tnet.hybridize()
    jnet.hybridize()
    close_out(tnet(torch.from_numpy(X)), jnet(jmx.nd.array(X)).asnumpy())
    for _ in range(3):
        with ag.record():
            tout = tnet(torch.from_numpy(X))
        with jag.record():
            jout = jnet(jmx.nd.array(X))
        close_out(tout, jout.asnumpy())
    ag.backward(tout, torch.from_numpy(HEAD))
    jout.backward(jmx.nd.array(HEAD))
    jp = jnet.collect_params()
    for name, p in tnet.gluon_params().items():
        want = jp["net_" + name]
        if "running" in name:
            close_out(p, want.data().asnumpy())
        else:
            close_grad(p.grad, want.grad().asnumpy(), name)
    assert len(tnet._cached_graph) == 2      # predict; training recorded


def test_cache_entries_follow_jax_keys():
    """One entry a key, as JAX's ``_cached_graph``: the same shape twice
    gives 1, a new shape 2, train mode a third; ``cast`` empties the
    cache. The port's key also holds whether the call records (JAX
    replays its one training entry under ``record``)."""
    tnet, jnet = _mlp_pair()
    tnet.hybridize()
    jnet.hybridize()
    x2 = X[:2]
    sizes = []
    for x, mode in ((X, "predict"), (X, "predict"), (x2, "predict"),
                    (X, "train")):
        with ag.train_mode() if mode == "train" else ag.predict_mode():
            tnet(torch.from_numpy(x))
        with jag.train_mode() if mode == "train" else jag.predict_mode():
            jnet(jmx.nd.array(x))
        sizes.append((len(tnet._cached_graph), len(jnet._cached_graph)))
    assert sizes == [(1, 1), (1, 1), (2, 2), (3, 3)]
    with ag.record():
        tnet(torch.from_numpy(X))
    assert len(tnet._cached_graph) == 4
    tnet.cast("float64")
    jnet.cast("float16")
    assert len(tnet._cached_graph) == len(jnet._cached_graph) == 0


def test_captures_count_new_entries_and_failures_name_the_block():
    net = nn.Dense(3, in_units=4, device="cpu").initialize(seed=1)
    net.hybridize()
    before = graphs.captures()
    x = torch.from_numpy(X)
    net(x)
    net(x)
    assert graphs.captures() == before + 1
    with pytest.raises(MXNetError, match="hashable constants"):
        net(x, {1, 2})


def test_captures_count_the_calling_threads_own():
    """A capture made on another thread leaves this thread's count
    alone: an engine reads only its own worker's captures."""
    net = nn.Dense(3, in_units=4, device="cpu").initialize(seed=1)
    net.hybridize()
    theirs = []

    def other():
        b = graphs.captures()
        net(torch.from_numpy(X))
        theirs.append(graphs.captures() - b)

    before = graphs.captures()
    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert theirs == [1] and graphs.captures() == before
    net(torch.from_numpy(X))            # the entry exists: a replay
    assert graphs.captures() == before


def test_recorded_entries_are_bounded_least_recently_used_first():
    """At most four recorded entries (each holds its activations on the
    card); the least recently used goes, and captures again when its
    shape comes back. Predict entries are not bounded."""
    net = nn.Dense(3, in_units=4, device="cpu").initialize(seed=1)
    net.hybridize()

    def call(rows):
        with ag.record():
            net(torch.ones(rows, 4))

    def recorded():
        return sorted(e.static_in[0].shape[0]
                      for e in net._cached_graph.values() if e.grad)

    for rows in (1, 2, 3, 4):
        call(rows)
    for rows in (5, 6, 7, 8, 9):
        net(torch.ones(rows, 4))
    call(1)                             # now the most recently used
    assert recorded() == [1, 2, 3, 4]
    before = graphs.captures()
    call(5)
    assert recorded() == [1, 3, 4, 5] and graphs.captures() == before + 1
    call(2)
    assert recorded() == [1, 2, 4, 5] and graphs.captures() == before + 2
    assert len(net._cached_graph) == 4 + 5


def test_outputs_outlive_the_next_call():
    net = nn.Dense(3, in_units=4, device="cpu").initialize(seed=1)
    net.hybridize()
    first = net(torch.from_numpy(X))
    want = first.clone()
    net(torch.from_numpy(2 * X))
    assert torch.equal(first, want)


def _user_blocks(lib):
    class Net(lib.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = lib.gluon.nn.Dense(5, in_units=4)
                self.scale = self.params.get("scale", shape=(5,))

        def hybrid_forward(self, F, x, scale):
            h = F.Activation(self.dense(x), act_type="tanh")
            return F.broadcast_mul(h, F.reshape(scale, shape=(1, 5)))

    return Net


def test_user_hybrid_forward_block_matches_jax():
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        tnet = _user_blocks(tmx)(prefix="user_")
        tnet.initialize(seed=4)
    jnet = _user_blocks(jmx)(prefix="user_")
    jnet.initialize()
    _copy_into_jax(tnet, jnet)
    tnet.hybridize()
    jnet.hybridize()
    for _ in range(2):
        with ag.record():
            tout = tnet(nd.array(X, ctx=tmx.cpu()))
        with jag.record():
            jout = jnet(jmx.nd.array(X))
    assert isinstance(tout, nd.NDArray)
    close_out(tout.asnumpy(), jout.asnumpy())
    tout.backward()
    jout.backward()
    jp = jnet.collect_params()
    for name, p in tnet.gluon_params().items():
        close_grad(p.grad, jp["user_" + name].grad().asnumpy(), name)


def test_functionalize_matches_jax():
    """``(fn, params)``: the block as a function of its parameters,
    differentiable with torch's autograd, running statistics left alone
    (as the JAX one drops them)."""
    import jax

    tnet, jnet = _mlp_pair()
    fn, params = functionalize(tnet, training=True)
    jfn, jparams = jmx.gluon.block.functionalize(jnet, training=True)
    assert list(params) == [k[len("net_"):] for k in jparams]
    got = fn(params, None, torch.from_numpy(X))
    want = jfn(jparams, jax.random.PRNGKey(0), jmx.nd.array(X)._data)
    close_out(got, np.asarray(want))
    running = params["batchnorm0_running_mean"].clone()

    leaves = {k: v.clone().requires_grad_(v.dtype.is_floating_point)
              for k, v in params.items()}
    loss = (fn(leaves, 0, torch.from_numpy(X)) ** 2).sum()
    trained = [k for k, v in leaves.items() if "running" not in k]
    grads = dict(zip(trained, torch.autograd.grad(
        loss, [leaves[k] for k in trained])))
    jgrads = jax.grad(lambda p: (jfn(p, jax.random.PRNGKey(0),
                                     jmx.nd.array(X)._data) ** 2).sum())(
        jparams)
    for name, g in grads.items():
        close_grad(g, jgrads["net_" + name], name)
    assert torch.equal(params["batchnorm0_running_mean"], running)


def _remat_net(remat, child_only):
    net = nn.HybridSequential(prefix="r_")
    with net.name_scope():
        child = nn.HybridSequential(prefix="c_")
        with child.name_scope():
            child.add(nn.Dense(16, in_units=4, use_bias=False,
                               device="cpu"),
                      nn.BatchNorm(in_channels=16, device="cpu"),
                      nn.Activation("relu"))
        net.add(child, nn.Dense(3, in_units=16, device="cpu"))
    net.initialize(seed=6)
    if remat and child_only:
        child.hybridize(active=False, remat=True)
    net.hybridize(remat=(remat and not child_only) or None)
    return net, child


@pytest.mark.parametrize("child_only", [False, True])
def test_remat_gives_the_gradients_of_no_remat(child_only):
    """``hybridize(remat=True)`` on the root, or a child marked with
    ``hybridize(active=False, remat=True)`` under a hybridized parent:
    outputs, gradients and running statistics as without remat (the
    recompute writes no statistics), and the recompute runs."""
    import torch.utils.checkpoint as ckpt

    runs = []
    calls = []
    orig = ckpt.checkpoint

    def spy(fn, *a, **k):
        calls.append(1)
        return orig(fn, *a, **k)

    ckpt.checkpoint = spy
    try:
        for remat in (False, True):
            net, child = _remat_net(remat, child_only)
            assert (child if child_only else net)._remat is remat
            x = torch.from_numpy(X).requires_grad_(True)
            with ag.record():
                out = net(x)
            ag.backward((out * out).sum())
            runs.append((out.detach(), x.grad,
                         {n: (p.grad if p.requires_grad else p.detach())
                          for n, p in net.gluon_params().items()}))
    finally:
        ckpt.checkpoint = orig
    assert len(calls) == 1
    # the recompute centres BatchNorm's one-pass variance on the
    # updated running mean: the same math, rounded otherwise
    (o0, x0, p0), (o1, x1, p1) = runs
    close_out(o1, o0.numpy())
    close_grad(x1, x0.numpy())
    for name in p0:
        if "running" in name:
            assert torch.equal(p1[name], p0[name]), name
        else:
            close_grad(p1[name], p0[name].numpy(), name)


def test_remat_policies():
    from mxnet_tpu_torch.gluon.block import checkpoint_policy

    assert checkpoint_policy(None) is None
    assert checkpoint_policy("nothing_saveable") is None
    for name in ("everything_saveable", "dots_saveable", "checkpoint_dots",
                 "dots_with_no_batch_dims_saveable", "names:conv_out"):
        assert callable(checkpoint_policy(name))
    with pytest.raises(ValueError, match="offload_dot_with_no_batch_dims"):
        nn.Dense(2, in_units=2, device="cpu").hybridize(
            remat=True, remat_policy="offload_dot_with_no_batch_dims")


def test_resnet_remat_stages_match_jax():
    """A small ResNet V1 with ``remat_stages=(2, 3)`` and the
    ``names:conv_out`` policy: the port's hybridized model under
    ``record`` against the JAX model's functionalized training step (the
    path its benchmark runs remat on): the mean loss and its gradients."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.block import functionalize as jfunctionalize
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    # channels double at each strided stage, so every such block has
    # its downsampling residual
    layers, channels = [1, 1, 1, 1], [8, 8, 16, 32, 64]
    kw = dict(classes=4, thumbnail=True, remat_stages=(2, 3),
              remat_policy="names:conv_out")
    jnet = jresnet.ResNetV1(jresnet.BasicBlockV1, layers, channels, **kw)
    jmx.random.seed(2)
    jnet.initialize(init=jmx.initializer.Xavier())
    rng = np.random.RandomState(1)
    x = rng.rand(8, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 4, 8)
    with jag.predict_mode():
        jnet(jmx.nd.array(x))
    tnet = resnet.ResNetV1(resnet.BasicBlockV1, layers, channels,
                           device="cpu", **kw)
    tnet.load_gluon_params({k[len(jnet.prefix):]: v.data().asnumpy()
                            for k, v in jnet.collect_params().items()})
    fn, params = jfunctionalize(jnet, training=True)

    def jloss(p):
        logp = jax.nn.log_softmax(fn(p, jax.random.PRNGKey(0),
                                     jnp.asarray(x)), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    axis=-1).mean()

    want, jgrads = jax.value_and_grad(jloss)(params)
    tnet.hybridize()
    with ag.record():
        tloss = gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(torch.from_numpy(x)),
            torch.from_numpy(y.astype(np.float32))).mean()
    ag.backward(tloss)
    close_out(tloss, np.asarray(want))
    for name, p in tnet.gluon_params().items():
        if p.requires_grad:
            close_grad(p.grad, jgrads[jnet.prefix + name], name)


def test_sequential_hybridize_warns_and_stays_eager():
    net = nn.Sequential()
    net.add(nn.Dense(3, in_units=4, device="cpu"))
    net.initialize(seed=1)
    with pytest.warns(UserWarning, match="HybridSequential"):
        net.hybridize()
    assert not net._active and net[0]._active
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nn.HybridSequential().hybridize()
