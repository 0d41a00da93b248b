"""The PyTorch port's optimizer update ops, optimizers and learning-rate
schedulers against the JAX package's.

The same numpy weights, states and gradient sequences go through the
JAX package's ops / optimizers and the port's (which update in place).
Weights agree within 1e-6 absolute and relative over several steps:
the same float32 arithmetic in the same order (torch and XLA may fuse
a multiply-add differently, a rounding of 6e-8 per step). Adam is
MXNet's (bias correction folded into lr, wd on the gradient), not
``torch.optim.Adam``: the test with wd != 0 would tell them apart.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import jax.numpy as jnp
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import op_impl_optimizer as jops
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ndarray import op_impl_optimizer as tops

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)

OPS = {
    # name: (number of state tensors, keyword arguments)
    "sgd_update": (0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                           clip_gradient=0.8)),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01,
                               rescale_grad=0.5)),
    "adam_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                            wd=0.05, rescale_grad=2.0, clip_gradient=1.5)),
    "adamw_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                             wd=0.05, eta=0.7, rescale_grad=2.0)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_ops_match_the_jax_package(name):
    n_state, kw = OPS[name]
    rng = np.random.RandomState(len(name))
    w = rng.randn(7, 5).astype(np.float32)
    states = [np.zeros_like(w) if i == 0 else
              np.abs(rng.randn(7, 5)).astype(np.float32) * 0.1
              for i in range(n_state)]
    jw, jstates = jnp.asarray(w), [jnp.asarray(s) for s in states]
    tw = torch.from_numpy(w.copy())
    tstates = [torch.from_numpy(s.copy()) for s in states]
    for _ in range(4):
        g = rng.randn(7, 5).astype(np.float32)
        out = getattr(jops, name)(jw, jnp.asarray(g), *jstates, **kw)
        if n_state:
            jw, jstates = out[0], list(out[1:])
        else:
            jw = out
        ret = getattr(tops, name)(tw, torch.from_numpy(g), *tstates, **kw)
        assert ret is tw                         # in place
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    for t, j in zip(tstates, jstates):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_multi_sgd_ops_match_the_jax_package(momentum):
    rng = np.random.RandomState(4)
    ws = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 2))]
    gs = [rng.randn(*w.shape).astype(np.float32) for w in ws]
    moms = [rng.randn(*w.shape).astype(np.float32) for w in ws]
    kw = dict(lrs=[0.1, 0.2, 0.3], wds=[0.0, 0.01, 0.02], rescale_grad=0.5)
    tws = [torch.from_numpy(w.copy()) for w in ws]
    tgs = [torch.from_numpy(g) for g in gs]
    if momentum:
        args = [a for w, g, m in zip(ws, gs, moms)
                for a in (jnp.asarray(w), jnp.asarray(g),
                          jnp.asarray(m))]
        want = jops.multi_sgd_mom_update(*args, momentum=momentum,
                                         num_weights=3, **kw)[0::2]
        tmoms = [torch.from_numpy(m.copy()) for m in moms]
        tops.multi_sgd_mom_update(tws, tgs, tmoms, momentum=momentum, **kw)
    else:
        args = [a for w, g in zip(ws, gs)
                for a in (jnp.asarray(w), jnp.asarray(g))]
        want = jops.multi_sgd_update(*args, num_weights=3, **kw)
        tops.multi_sgd_update(tws, tgs, **kw)
    for t, j in zip(tws, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _schedulers(mod):
    return {
        "factor": lambda: mod.FactorScheduler(step=3, factor=0.5,
                                              base_lr=0.1, warmup_steps=4,
                                              warmup_begin_lr=0.01),
        "multifactor": lambda: mod.MultiFactorScheduler(
            step=[5, 9, 15], factor=0.3, base_lr=0.2),
        "poly": lambda: mod.PolyScheduler(max_update=30, base_lr=0.1,
                                          pwr=2, final_lr=0.001,
                                          warmup_steps=5),
        "cosine": lambda: mod.CosineScheduler(max_update=25, base_lr=0.1,
                                              final_lr=0.0,
                                              warmup_steps=3,
                                              warmup_mode="constant",
                                              warmup_begin_lr=0.02),
    }


@pytest.mark.parametrize("name", ["factor", "multifactor", "poly",
                                  "cosine"])
def test_lr_schedulers_match_the_jax_package(name):
    j, t = _schedulers(jsched)[name](), _schedulers(tsched)[name]()
    assert [t(n) for n in range(40)] == [j(n) for n in range(40)]


def _optimizer(mod, sched_mod, name):
    sched = sched_mod.FactorScheduler(step=2, factor=0.7, warmup_steps=2,
                                      warmup_begin_lr=0.001)
    kw = dict(learning_rate=0.05, wd=0.01, rescale_grad=0.25,
              lr_scheduler=sched)
    if name == "sgd":
        kw["momentum"] = 0.9
    if name in ("adam", "adamw"):
        kw.update(beta1=0.85, beta2=0.98, epsilon=1e-7)
    opt = mod.create(name, **kw)
    opt.set_lr_mult({1: 0.3})
    opt.set_wd_mult({2: 4.0})
    return opt


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizers_match_the_jax_package(name):
    """Five steps of three parameters through the Updater's multi-update
    (the Trainer's path): per-index update counts (Adam's bias
    correction), wd, lr_mult, wd_mult and an lr scheduler with warmup."""
    rng = np.random.RandomState(11)
    shapes = ((4, 3), (6,), (2, 5))
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jup = jopt.get_updater(_optimizer(jopt, jsched, name))
    tup = topt.get_updater(_optimizer(topt, tsched, name))
    jws = [mx.nd.array(w) for w in ws]
    tws = [torch.from_numpy(w.copy()) for w in ws]
    for step in range(5):
        gs = [rng.randn(*s).astype(np.float32) for s in shapes]
        idx = [0, 1, 2] if step != 2 else [0, 2]     # counts diverge
        jup.update_multi(idx, [mx.nd.array(gs[i]) for i in idx],
                         [jws[i] for i in idx])
        tup.update_multi(idx, [torch.from_numpy(gs[i]) for i in idx],
                         [tws[i] for i in idx])
        for t, j in zip(tws, jws):
            np.testing.assert_allclose(t.numpy(), j.asnumpy(), **TOL)
    assert tup.optimizer.num_update == jup.optimizer.num_update == 5
    assert tup.optimizer._index_update_count == \
        jup.optimizer._index_update_count


def test_adam_folds_bias_correction_into_lr():
    """MXNet's first Adam step moves every weight by lr * g / (|g| +
    eps * sqrt(1 - beta2)) (the corrected lr over the uncorrected
    sqrt); the wd term rides the gradient."""
    opt = topt.create("adam", learning_rate=0.1, epsilon=1e-8)
    w = torch.tensor([1.0, -2.0])
    g = torch.tensor([0.5, -0.25])
    topt.get_updater(opt)(0, g, w)
    want = torch.tensor([1.0, -2.0]) - 0.1 * g / (g.abs() + 1e-8 *
                                                  (1 - 0.999) ** 0.5)
    assert torch.allclose(w, want, atol=1e-7)


def test_registry_and_learning_rate_rules():
    assert isinstance(topt.create("SGD"), topt.SGD)
    assert isinstance(topt.create("adamw"), topt.AdamW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.create("lbfgs")
    opt = topt.create("sgd", learning_rate=0.5)
    opt.set_learning_rate(0.2)
    assert opt.learning_rate == 0.2
    sched = tsched.FactorScheduler(step=1)
    opt = topt.create("sgd", learning_rate=0.5, lr_scheduler=sched)
    assert sched.base_lr == 0.5
    with pytest.raises(Exception, match="lr_scheduler"):
        opt.set_learning_rate(0.1)
