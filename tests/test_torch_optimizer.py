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
    # name: (number of state tensors, keyword arguments); the first
    # state starts at zero, the others at small positive values
    "sgd_update": (0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                           clip_gradient=0.8)),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01,
                               rescale_grad=0.5)),
    "adam_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                            wd=0.05, rescale_grad=2.0, clip_gradient=1.5)),
    "adamw_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                             wd=0.05, eta=0.7, rescale_grad=2.0)),
    "adagrad_update": (1, dict(lr=0.1, epsilon=1e-6, wd=0.02,
                               rescale_grad=0.5, clip_gradient=1.0)),
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01,
                               rescale_grad=0.5, clip_gradient=0.9)),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, epsilon=1e-6, wd=0.01,
                               rescale_grad=2.0, clip_gradient=1.5,
                               clip_weights=1.2)),
    # n, g and delta: g starts at zero so that n - g * g stays positive
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   epsilon=1e-6, wd=0.01, rescale_grad=2.0,
                                   clip_weights=1.5)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.05, beta=1.0, wd=0.01,
                            rescale_grad=0.5)),
    "signsgd_update": (0, dict(lr=0.05, wd=0.01, rescale_grad=0.5,
                               clip_gradient=0.8)),
    "signum_update": (1, dict(lr=0.05, momentum=0.9, wd=0.01,
                              rescale_grad=0.5, wd_lh=0.02)),
    "adadelta_update": (2, dict(rho=0.9, epsilon=1e-5, wd=0.01,
                                rescale_grad=0.5, clip_gradient=1.0)),
}
_ZERO_STATES = {"rmspropalex_update": (0, 1)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_ops_match_the_jax_package(name):
    n_state, kw = OPS[name]
    rng = np.random.RandomState(len(name))
    w = rng.randn(7, 5).astype(np.float32)
    zero = _ZERO_STATES.get(name, (0,))
    states = [np.zeros_like(w) if i in zero else
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


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("multi", [False, True])
def test_mp_sgd_ops_match_the_jax_package(momentum, multi):
    """bfloat16 weights with float32 masters (``mp_sgd_*`` and
    ``multi_mp_sgd_*``), three steps: the masters and momenta within
    1e-6, the bfloat16 weights exactly (the same rounding of the same
    master)."""
    rng = np.random.RandomState(5)
    shapes = ((3, 4), (5,)) if multi else ((4, 6),)
    w32 = [rng.randn(*s).astype(np.float32) for s in shapes]
    moms = [np.zeros_like(w) for w in w32]
    lrs, wds = [0.1, 0.2][:len(shapes)], [0.01, 0.0][:len(shapes)]
    tw = [_bf16(w) for w in w32]
    tw32 = [torch.from_numpy(w.copy()) for w in w32]
    tm = [torch.from_numpy(m.copy()) for m in moms]
    jw = [jnp.asarray(w).astype(jnp.bfloat16) for w in w32]
    jw32 = [jnp.asarray(w) for w in w32]
    jm = [jnp.asarray(m) for m in moms]
    for _ in range(3):
        gs = [rng.randn(*s).astype(np.float32) for s in shapes]
        tg = [_bf16(g) for g in gs]
        jg = [jnp.asarray(g).astype(jnp.bfloat16) for g in gs]
        common = dict(rescale_grad=0.5, clip_gradient=0.9)
        if multi:
            n = len(shapes)
            if momentum:
                args = [a for q in zip(jw, jg, jm, jw32) for a in q]
                out = jops.multi_mp_sgd_mom_update(
                    *args, lrs=lrs, wds=wds, momentum=momentum,
                    num_weights=n, **common)
                jw, jm, jw32 = (list(out[0::3]), list(out[1::3]),
                                list(out[2::3]))
                tops.multi_mp_sgd_mom_update(tw, tg, tm, tw32, lrs=lrs,
                                             wds=wds, momentum=momentum,
                                             **common)
            else:
                args = [a for q in zip(jw, jg, jw32) for a in q]
                out = jops.multi_mp_sgd_update(*args, lrs=lrs, wds=wds,
                                               num_weights=n, **common)
                jw, jw32 = list(out[0::2]), list(out[1::2])
                tops.multi_mp_sgd_update(tw, tg, tw32, lrs=lrs, wds=wds,
                                         **common)
        else:
            kw = dict(lr=lrs[0], wd=wds[0], **common)
            if momentum:
                jw[0], jm[0], jw32[0] = jops.mp_sgd_mom_update(
                    jw[0], jg[0], jm[0], jw32[0], momentum=momentum, **kw)
                ret = tops.mp_sgd_mom_update(tw[0], tg[0], tm[0], tw32[0],
                                             momentum=momentum, **kw)
            else:
                jw[0], jw32[0] = jops.mp_sgd_update(jw[0], jg[0], jw32[0],
                                                    **kw)
                ret = tops.mp_sgd_update(tw[0], tg[0], tw32[0], **kw)
            assert ret is tw[0]
    for t, j in zip(tw32 + tm, jw32 + jm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    for t, j in zip(tw, jw):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("bounds", [(None, None), (0.5, 2.0)])
def test_lamb_phases_match_the_jax_package(bounds):
    """Phase 1 (moments in place, the direction returned), the norms on
    the device, phase 2: three steps."""
    rng = np.random.RandomState(8)
    w = rng.randn(6, 4).astype(np.float32)
    jw, jm, jv = jnp.asarray(w), jnp.zeros((6, 4)), jnp.zeros((6, 4))
    tw, tm, tv = (torch.from_numpy(w.copy()), torch.zeros(6, 4),
                  torch.zeros(6, 4))
    kw2 = {k: v for k, v in zip(("lower_bound", "upper_bound"), bounds)
           if v is not None}
    for t in range(1, 4):
        g = rng.randn(6, 4).astype(np.float32)
        kw = dict(beta1=0.9, beta2=0.99, epsilon=1e-6, t=t, wd=0.01,
                  rescale_grad=0.5)
        jd, jm, jv = jops.lamb_update_phase1(jw, jnp.asarray(g), jm, jv,
                                             **kw)
        jw = jops.lamb_update_phase2(jw, jd, jnp.linalg.norm(jw),
                                     jnp.linalg.norm(jd), lr=0.05, **kw2)
        td = tops.lamb_update_phase1(tw, torch.from_numpy(g), tm, tv, **kw)
        tops.lamb_update_phase2(tw, td, torch.linalg.vector_norm(tw),
                                torch.linalg.vector_norm(td), lr=0.05,
                                **kw2)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    for t, j in ((tw, jw), (tm, jm), (tv, jv)):
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


# optimizer name -> its own keyword arguments
OPTIMIZERS = {
    "sgd": dict(momentum=0.9),
    "nag": dict(momentum=0.9),
    "adam": dict(beta1=0.85, beta2=0.98, epsilon=1e-7),
    "adamw": dict(beta1=0.85, beta2=0.98, epsilon=1e-7),
    "adagrad": dict(eps=1e-6),
    "adadelta": dict(rho=0.85, epsilon=1e-5),
    "rmsprop": dict(gamma1=0.85, epsilon=1e-6, clip_weights=2.0),
    "rmsprop-centered": dict(gamma1=0.85, gamma2=0.8, epsilon=1e-6,
                             centered=True),
    "ftrl": dict(lamda1=0.01, beta=1.0),
    "signum": dict(momentum=0.8, wd_lh=0.01),
    "signum-nomom": dict(momentum=0.0),
    "lamb": dict(beta1=0.85, beta2=0.98, lower_bound=0.1, upper_bound=5.0),
    "dcasgd": dict(momentum=0.9, lamda=0.05),
    "dcasgd-nomom": dict(lamda=0.05),
    "lbsgd": dict(momentum=0.9),
    "test": dict(),
}


def _optimizer(mod, sched_mod, name, **extra):
    sched = sched_mod.FactorScheduler(step=2, factor=0.7, warmup_steps=2,
                                      warmup_begin_lr=0.001)
    kw = dict(learning_rate=0.05, wd=0.01, rescale_grad=0.25,
              lr_scheduler=sched)
    kw.update(OPTIMIZERS.get(name, {}))
    kw.update(extra)
    if kw.get("lr_scheduler", 1) is None:
        del kw["lr_scheduler"]
    opt = mod.create(name.split("-")[0], **kw)
    opt.set_lr_mult({1: 0.3})
    opt.set_wd_mult({2: 4.0})
    return opt


def _run_both(name, steps=5, dtype=np.float32, **extra):
    """``steps`` updates of three parameters through each package's
    Updater multi-update (the Trainer's path); yields after each step
    the two updaters and weights."""
    rng = np.random.RandomState(11)
    shapes = ((4, 3), (6,), (2, 5))
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jup = jopt.get_updater(_optimizer(jopt, jsched, name, **extra))
    tup = topt.get_updater(_optimizer(topt, tsched, name, **extra))
    jws = [mx.nd.array(w).astype(dtype) for w in ws]
    tdt = {np.float32: torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tws = [torch.from_numpy(w.copy()).to(tdt) for w in ws]
    for step in range(steps):
        gs = [rng.randn(*s).astype(np.float32) for s in shapes]
        idx = [0, 1, 2] if step != 2 else [0, 2]     # counts diverge
        jup.update_multi(idx, [mx.nd.array(gs[i]).astype(dtype)
                               for i in idx], [jws[i] for i in idx])
        tup.update_multi(idx, [torch.from_numpy(gs[i]).to(tdt)
                               for i in idx], [tws[i] for i in idx])
        yield jup, tup, jws, tws


@pytest.mark.parametrize("name", sorted(OPTIMIZERS) + ["lbsgd-nosched"])
def test_optimizers_match_the_jax_package(name):
    """Five steps of three parameters: per-index update counts (Adam's
    and LAMB's bias correction), wd, lr_mult, wd_mult and an lr
    scheduler with warmup (LBSGD's trust ratio scales the rate only
    without one: ``lbsgd-nosched``)."""
    extra = {"lr_scheduler": None} if name == "lbsgd-nosched" else {}
    for jup, tup, jws, tws in _run_both(name.replace("-nosched", ""),
                                        **extra):
        for t, j in zip(tws, jws):
            np.testing.assert_allclose(t.numpy(), j.asnumpy(), **TOL)
    # Test counts no updates, in both packages
    assert tup.optimizer.num_update == jup.optimizer.num_update == \
        (0 if name == "test" else 5)
    assert tup.optimizer._index_update_count == \
        jup.optimizer._index_update_count


@pytest.mark.parametrize("name", ["sgd", "adam", "nag", "lamb"])
def test_multi_precision_matches_the_jax_package(name):
    """``multi_precision=True`` on bfloat16 weights: float32 masters in
    the states, updated as float32 weights; the bfloat16 weights are
    the masters' rounding (exact), the masters within 1e-6."""
    for jup, tup, jws, tws in _run_both(name, steps=3, dtype="bfloat16",
                                        multi_precision=True):
        pass
    for i, t in enumerate(tws):
        jinner, jmaster = jup.states[i]
        tinner, tmaster = tup.states[i]
        assert tmaster.dtype == torch.float32 and t.dtype == torch.bfloat16
        np.testing.assert_allclose(tmaster.numpy(), jmaster.asnumpy(),
                                   **TOL)
        np.testing.assert_array_equal(t.float().numpy(),
                                      jws[i].astype("float32").asnumpy())
        assert torch.equal(t, tmaster.to(torch.bfloat16))


@pytest.mark.parametrize("name", ["adam", "lamb", "sgd"])
def test_begin_num_update_matches_the_jax_package(name):
    """Update counts start at ``begin_num_update`` (the bias correction
    and the scheduler read them)."""
    for jup, tup, jws, tws in _run_both(name, steps=3,
                                        begin_num_update=7):
        pass
    for t, j in zip(tws, jws):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), **TOL)
    assert tup.optimizer.num_update == jup.optimizer.num_update == 10
    assert tup.optimizer._index_update_count == \
        jup.optimizer._index_update_count


def test_sgld_step_variance_is_lr():
    """SGLD draws its noise from the device generator (not the JAX key
    chain), so it is held by property: with zero gradient and zero wd
    a step is normal noise of variance ``lr`` and mean 0."""
    torch.manual_seed(0)
    opt = topt.create("sgld", learning_rate=0.04)
    w = torch.zeros(400, 250)
    topt.get_updater(opt)(0, torch.zeros_like(w), w)
    assert abs(float(w.var()) - 0.04) < 0.04 * 0.03
    assert abs(float(w.mean())) < 0.002
    # the drift: lr / 2 * (g + wd * w) on top of the noise
    torch.manual_seed(1)
    noise = torch.randn(400, 250) * 0.2
    torch.manual_seed(1)
    w = torch.ones(400, 250)
    opt = topt.create("sgld", learning_rate=0.04, wd=0.5, rescale_grad=2.0)
    topt.get_updater(opt)(0, torch.full_like(w, 0.25), w)
    want = 1.0 - 0.02 * (0.5 + 0.5) + noise
    assert torch.allclose(w, want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS) + ["sgld"])
def test_states_pickle_round_trips(name):
    """``get_states``/``set_states`` carry every optimizer's states (and
    the optimizer with ``dump_optimizer``) through the ``.states``
    bytes: a second updater continues bit for bit."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(5, 4).astype(np.float32))
    gs = [torch.from_numpy(rng.randn(5, 4).astype(np.float32))
          for _ in range(4)]
    up = topt.get_updater(_optimizer(topt, tsched, name))
    for g in gs[:2]:
        up(0, g, w)
    blob = up.get_states(dump_optimizer=True)
    again = topt.get_updater(topt.create("sgd"))
    again.set_states(blob)
    assert type(again.optimizer) is type(up.optimizer)
    w2 = w.clone()
    torch.manual_seed(4)
    up(0, gs[2], w)
    torch.manual_seed(4)
    again(0, gs[2], w2)
    assert torch.equal(w, w2)


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
    for name in ("nag", "adadelta", "rmsprop", "ftrl", "signum", "lamb",
                 "sgld", "dcasgd", "lbsgd", "test"):
        jcls = type(jopt.create(name))
        assert type(topt.create(name)).__name__ == jcls.__name__
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


def test_trainer_passes_multi_precision_and_states_round_trip(tmp_path):
    """``Trainer(..., {"multi_precision": True})`` on a bfloat16 layer:
    each weight's state holds its float32 master, the weight is the
    master's rounding after a step, and ``save_states``/``load_states``
    carry the masters (a second trainer continues bit for bit)."""
    from mxnet_tpu_torch import autograd, gluon

    def make():
        net = gluon.nn.Dense(4, in_units=6, device="cpu")
        net.initialize(seed=2)
        net.cast("bfloat16")
        return net, gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9,
                                   "multi_precision": True})

    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    net, trainer = make()
    for _ in range(2):
        with autograd.record():
            loss = (net(x).float() ** 2).sum()
        loss.backward()
        trainer.step(5)
    assert trainer.optimizer.multi_precision
    for i, p in enumerate(trainer._params):
        mom, master = trainer._updater.states[i]
        assert master.dtype == torch.float32 and mom.dtype == torch.float32
        assert torch.equal(p.data(), master.to(torch.bfloat16))
    trainer.save_states(str(tmp_path / "mp.states"))
    net2, trainer2 = make()
    with torch.no_grad():
        for a, b in zip(net2.parameters(), net.parameters()):
            a.copy_(b)
    trainer2.load_states(str(tmp_path / "mp.states"))
    for n, t in ((net, trainer), (net2, trainer2)):
        with autograd.record():
            loss = (n(x).float() ** 2).sum()
        loss.backward()
        t.step(5)
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
