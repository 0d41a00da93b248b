"""The port's op registry (``mx.nd.<op>``) against the JAX package's on
the CPU, one case per registered op.

Each case feeds the same numpy-seeded inputs (integer indices as
float32 arrays, as MXNet passes them) and parameters to
``mxnet_tpu.nd.<op>`` and to the port's ``nd.<op>``: forward outputs
within 1e-5 (rtol and atol) in float32, integer, comparison and
ordering results exact; for differentiable ops the gradients through
``autograd.record``/``backward`` with a seeded head gradient within
1e-4. The random ops are held by seeded repeatability and by their
moments (their bits differ from ``jax.random`` by design). A coverage
test holds the port's registry to the JAX registry's names, less the
waiting list (``ndarray.WAITING``), each of which raises naming its
ROADMAP item.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import register as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray import op_impl_basic, register as treg
from nd_op_cases import I, OWN_TESTS, SPECS, U, rs_for

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _check(got, want, tol, exact, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=tol,
                                   atol=tol, err_msg=what)


def _run(pkg, nd_mod, name, arrays, params, grad, head):
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    fn = getattr(nd_mod, name)
    if grad is None:
        return _outs(fn(*xs, **params)), None
    idx = range(len(xs)) if grad == "all" else grad
    for i in idx:
        xs[i].attach_grad()
    with pkg.autograd.record():
        out = fn(*xs, **params)
    out.backward(pkg.nd.array(head(name, out.shape)))
    return [out], [xs[i].grad for i in idx]


def head_for(name, shape):
    return U(rs_for(name + "/head"), tuple(shape))


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX outputs and gradients, from one compiled
    forward and one compiled backward over all the cases: the JAX
    ops' own functions, called as ``mx.nd.<op>`` calls them
    (``register.call_op_fn``), the gradients by ``jax.vjp`` as its
    autograd records them. One compile instead of ~500 eager ones; a
    case that cannot be traced runs eagerly through ``mx.nd``."""
    import jax
    import jax.numpy as jnp

    cases = {n: (spec[0](rs_for(n)),) + spec[1:] for n, spec in SPECS.items()}
    eager = set()

    def call(name, arrays):
        _, params, _, _ = cases[name]
        return jreg.call_op_fn(jreg.get_op(name), list(arrays),
                               {k: jreg._parse_param(v)
                                for k, v in params.items()})

    def split(name, diff):
        arrays, _, grad, _ = cases[name]
        idx = range(len(arrays)) if grad == "all" else grad
        full = [jnp.asarray(a) for a in arrays]
        for i, d in zip(idx, diff):
            full[i] = d
        return full

    def forward(_):
        out = {}
        for n, (arrays, *_rest) in cases.items():
            try:
                out[n] = call(n, [jnp.asarray(a) for a in arrays])
            except Exception:       # not traceable: eager below
                eager.add(n)
        return out

    want = jax.jit(forward)(0)
    graded = [n for n, c in cases.items() if c[2] is not None
              and n not in eager]

    def backward(diffs, heads):
        def f(diffs):
            return {n: call(n, split(n, diffs[n])) for n in graded}
        _, vjp = jax.vjp(f, diffs)
        return vjp(heads)[0]

    diffs = {n: [jnp.asarray(cases[n][0][i]) for i in
                 (range(len(cases[n][0])) if cases[n][2] == "all"
                  else cases[n][2])] for n in graded}
    heads = {n: jnp.asarray(head_for(n, want[n].shape)) for n in graded}
    grads = jax.jit(backward)(diffs, heads)
    res = {n: (_outs(want[n]), grads.get(n)) for n in want}
    for n in eager:
        arrays, params, grad, _ = cases[n]
        res[n] = _run(jmx, jmx.nd, n, arrays, params, grad, head_for)
    return cases, res


@pytest.mark.parametrize("name", sorted(SPECS))
def test_op_matches_jax(name, jax_results):
    cases, res = jax_results
    arrays, params, grad, exact = cases[name]
    want, wgrads = res[name]
    with tmx.cpu():
        got, tgrads = _run(tmx, tnd, name, arrays, params, grad, head_for)
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        _check(g, w, FWD_TOL, exact, name)
    assert (tgrads is None) == (wgrads is None), name
    for i, (g, w) in enumerate(zip(tgrads or (), wgrads or ())):
        _check(g, w, GRAD_TOL, False, f"{name} grad {i}")


RESHAPES = [((2, 3, 4), (0, -1)), ((2, 3, 4), (-2,)), ((2, 3, 4), (-3, 4)),
            ((2, 3, 4), (0, -3)), ((2, 3, 4), (-4, 1, 2, -2)),
            ((2, 3, 4), (0, 0, -4, 2, -1)), ((6, 4), (-4, -1, 3, 0)),
            ((2, 3, 4), (4, -1)), ((2, 3, 4), (-1,)), ((1, 6), (0, 2, 3))]


@pytest.mark.parametrize("src,shape", RESHAPES)
def test_reshape_codes_match_jax(src, shape):
    x = np.arange(int(np.prod(src)), dtype=np.float32).reshape(src)
    want = jmx.nd.reshape(jmx.nd.array(x), shape=shape).asnumpy()
    with tmx.cpu():
        got = tnd.reshape(tnd.array(x), shape=shape).asnumpy()
        meth = tnd.array(x).reshape(shape).asnumpy()
    assert op_impl_basic.mx_shape(src, shape) == want.shape \
        or -1 in op_impl_basic.mx_shape(src, shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(meth, want)


@pytest.mark.parametrize("case", [
    ("sum", {"axis": (0, 2), "keepdims": True}),
    ("max", {"axis": 1, "exclude": True}),
    ("mean", {}),
    ("Activation", {"act_type": "gelu"}),
    ("LeakyReLU", {"act_type": "selu"}),
    ("softmax", {"temperature": 2.0}),
    ("topk", {"k": 2, "ret_typ": "mask", "axis": 0}),
    ("norm", {"ord": 1, "keepdims": True})])
def test_op_variants_match_jax(case):
    name, params = case
    x = U(rs_for(name + str(params)), (3, 4, 2) if name in ("sum", "max")
          else (3, 4))
    want = getattr(jmx.nd, name)(jmx.nd.array(x), **params).asnumpy()
    with tmx.cpu():
        got = getattr(tnd, name)(tnd.array(x), **params).asnumpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_softmax_length_and_dropout_batchnorm_wrappers_match_jax():
    rs = rs_for("wrappers")
    x, ln = U(rs, (2, 5)), I([3, 5])
    # the lengths ride positionally, bound by the signature (the
    # registry's rebinding: axis and temperature given by name)
    kw = dict(axis=-1, temperature=1.0, use_length=True)
    want = jmx.nd.softmax(jmx.nd.array(x), jmx.nd.array(ln, dtype="int32"),
                          **kw).asnumpy()
    with tmx.cpu():
        got = tnd.softmax(tnd.array(x), tnd.array(ln, dtype="int32"),
                          **kw).asnumpy()
        # predict mode: Dropout is the identity, as in the JAX wrapper
        np.testing.assert_array_equal(tnd.Dropout(tnd.array(x)).asnumpy(), x)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    data = U(rs, (4, 3, 2))
    g, b = U(rs, (3,), 0.5, 1.5), U(rs, (3,))
    mm, mv = U(rs, (3,)), U(rs, (3,), 0.5, 1.5)
    outs = {}
    for pkg, mod in ((jmx, jmx.nd), (tmx, tnd)):
        with (tmx.cpu() if pkg is tmx else jmx.cpu()):
            arrs = [pkg.nd.array(a) for a in (data, g, b, mm, mv)]
            with pkg.autograd.train_mode():
                train = mod.BatchNorm(*arrs, fix_gamma=False, momentum=0.8)
            pred = mod.BatchNorm(*arrs, fix_gamma=False)
            outs[pkg] = [train.asnumpy(), pred.asnumpy(), arrs[3].asnumpy(),
                         arrs[4].asnumpy()]
    for got, want in zip(outs[tmx], outs[jmx]):
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_rnn_op_matches_jax():
    rs = rs_for("RNN")
    t, n, i, h, layers = 3, 2, 4, 5, 2
    size = 4 * h * (i + h) + 4 * h * (h + h) + layers * 8 * h
    arrays = [U(rs, (t, n, i)), U(rs, (size,), -0.3, 0.3),
              U(rs, (layers, n, h)), U(rs, (layers, n, h))]
    params = dict(state_size=h, num_layers=layers, mode="lstm",
                  state_outputs=True)
    want = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays], **params)
    with tmx.cpu():
        got = tnd.RNN(*[tnd.array(a) for a in arrays], **params)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _check(g, w, FWD_TOL, False, "RNN")


@pytest.mark.parametrize("name,n_states,params", [
    ("sgd_update", 0, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam_update", 2, {"lr": 0.01, "beta1": 0.8, "wd": 0.01,
                        "clip_gradient": 0.3}),
    ("adamw_update", 2, {"lr": 0.01, "wd": 0.1, "eta": 0.5}),
    ("adagrad_update", 1, {"lr": 0.1, "epsilon": 1e-6, "wd": 0.01,
                           "rescale_grad": 0.5}),
    ("nag_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("mp_sgd_update", 1, {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.4}),
    ("mp_sgd_mom_update", 2, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("rmsprop_update", 1, {"lr": 0.01, "gamma1": 0.9, "wd": 0.01,
                           "clip_weights": 0.8}),
    ("rmspropalex_update", 3, {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.8,
                               "epsilon": 1.0}),
    ("ftrl_update", 2, {"lr": 0.1, "lamda1": 0.05, "beta": 1.0,
                        "wd": 0.01}),
    ("signsgd_update", 0, {"lr": 0.05, "wd": 0.01}),
    ("signum_update", 1, {"lr": 0.05, "momentum": 0.9, "wd_lh": 0.01}),
    ("adadelta_update", 2, {"rho": 0.9, "epsilon": 1e-5, "wd": 0.01}),
    ("lamb_update_phase1", 2, {"beta1": 0.9, "beta2": 0.99, "t": 3,
                               "wd": 0.01}),
    # (weight, direction, r1, r2): the norms as arrays, elementwise
    ("lamb_update_phase2", 2, {"lr": 0.05, "lower_bound": 0.5,
                               "upper_bound": 1.5}),
])
def test_update_op_matches_jax_results_and_state_writes(name, n_states,
                                                        params):
    """The registered update ops are the JAX ops: the new weight comes
    back, the weight passed in is untouched, the states are written
    back in place (``mutates``)."""
    rs = rs_for(name)
    arrays = [U(rs, (3, 4)) for _ in range(2)] \
        + [U(rs, (3, 4), 0.1, 1.0) for _ in range(n_states)]
    res = {}
    for pkg, mod in ((jmx, jmx.nd), (tmx, tnd)):
        with (tmx.cpu() if pkg is tmx else jmx.cpu()):
            xs = [pkg.nd.array(a) for a in arrays]
            out = getattr(mod, name)(*xs, **params)
            res[pkg] = [out.asnumpy()] + [x.asnumpy() for x in xs]
    for got, want in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(res[tmx][1], arrays[0])


@pytest.mark.parametrize("name,per", [("multi_sgd_update", 2),
                                      ("multi_sgd_mom_update", 3),
                                      ("multi_mp_sgd_update", 3),
                                      ("multi_mp_sgd_mom_update", 4)])
def test_multi_update_ops_match_jax(name, per):
    rs = rs_for(name)
    arrays = [U(rs, (2, 3)) for _ in range(2 * per)]
    params = {"lrs": (0.1, 0.2), "wds": (0.0, 0.01), "num_weights": 2}
    if "mom" in name:
        params["momentum"] = 0.9
    want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in arrays],
                                 **params)
    with tmx.cpu():
        got = getattr(tnd, name)(*[tnd.array(a) for a in arrays], **params)
    for g, w in zip(_outs(got), _outs(want)):
        _check(g, w, FWD_TOL, False, name)


RANDOM = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16.0 / 12),
    ("normal", dict(loc=0.5, scale=2.0), 0.5, 4.0),
    ("gamma", dict(alpha=2.0, beta=1.5), 3.0, 4.5),
    ("exponential", dict(scale=2.0), 2.0, 4.0),
    ("poisson", dict(lam=3.0), 3.0, 3.0),
    ("negative_binomial", dict(k=3, p=0.5), 3.0, 6.0),
    ("randint", dict(low=0, high=10), 4.5, 8.25),
]


@pytest.mark.parametrize("name,params,mean,var", RANDOM)
def test_random_ops_repeat_under_a_seed_and_have_their_moments(
        name, params, mean, var):
    n = 20000
    with tmx.cpu():
        fn = getattr(tnd.random, name)
        tmx.random.seed(7)
        a = fn(shape=(n,), **params).asnumpy()
        tmx.random.seed(7)
        b = fn(shape=(n,), **params).asnumpy()
        c = fn(shape=(n,), **params).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(b, c)
    a = a.astype(np.float64)
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(a.var() - var) < 0.1 * var


def test_sample_ops_shuffle_bernoulli_multinomial():
    with tmx.cpu():
        tmx.random.seed(3)
        mu = tnd.array([0.0, 10.0])
        s = tnd.sample_normal(mu, tnd.array([1.0, 0.1]), shape=(5000,))
        assert s.shape == (2, 5000)
        np.testing.assert_allclose(s.asnumpy().mean(1), [0.0, 10.0],
                                   atol=0.1)
        u = tnd.sample_uniform(tnd.array([0.0]), tnd.array([2.0]),
                               shape=(4000,)).asnumpy()
        assert u.min() >= 0 and u.max() <= 2 and abs(u.mean() - 1) < 0.05
        g = tnd.sample_gamma(tnd.array([2.0]), tnd.array([1.0]),
                             shape=(4000,)).asnumpy()
        assert abs(g.mean() - 2.0) < 0.15
        x = tnd.arange(10)
        sh = tnd.random.shuffle(x).asnumpy()
        assert sorted(sh.tolist()) == list(range(10))
        bern = tnd.random.bernoulli(prob=0.3, shape=(20000,)).asnumpy()
        assert abs(bern.mean() - 0.3) < 0.02
        probs = tnd.array([[0.1, 0.0, 0.9], [1.0, 0.0, 0.0]])
        draws = tnd.random.multinomial(probs, shape=(1000,)).asnumpy()
        assert draws.shape == (2, 1000) and (draws[1] == 0).all()
        assert 0.85 < (draws[0] == 2).mean() < 0.95
        out, logp = tnd.sample_multinomial(probs, get_prob=True)
        assert out.shape == (2,) and logp.shape == (2,)
        p = tnd.Dropout(tnd.ones((10000,)), p=0.25, mode="always")
        assert abs((p.asnumpy() == 0).mean() - 0.25) < 0.02


def _jax_names():
    return set(jreg._OPS)


def test_registry_covers_the_jax_registry_less_the_waiting_list():
    waiting = {n for names in tnd.WAITING.values() for n in names}
    port = set(treg._OPS)
    assert not port & waiting
    assert _jax_names() - port == waiting
    assert port <= _jax_names()
    # every registered op is held by a case above or by its own test
    # (the detection and vision contrib ops: tests/test_torch_detection.py
    # and tests/test_torch_vision_contrib.py; the int8 ops:
    # tests/test_torch_quantization.py; the NumPy frontend's _npi_* ops:
    # tests/test_torch_numpy*.py)
    contrib = {n for n, op in treg._OPS.items() if op.fn.__module__ in (
        "mxnet_tpu_torch.ops.detection", "mxnet_tpu_torch.ops.vision_contrib",
        "mxnet_tpu_torch.ndarray.op_impl_quant", "mxnet_tpu_torch.numpy.ops")}
    assert port == set(SPECS) | OWN_TESTS | contrib


# the items with unported names: the registry's waiting list, and the
# Long tail, whose pieces are all ported now (its registry names, the
# _npi_* ops, mx.contrib.onnx and the native image batcher)
@pytest.mark.parametrize("item", sorted(set(tnd.WAITING) | {"Long tail"}))
def test_waiting_names_raise_naming_their_roadmap_item(item, tmp_path):
    for name in tnd.WAITING.get(item, ()):
        with pytest.raises(NotImplementedError, match=f"'{item}'"):
            getattr(tnd, name)
    if item == "Long tail":
        import io

        from PIL import Image

        assert "Long tail" not in tnd.WAITING
        assert not any(n.startswith("_npi_") for names in
                       tnd.WAITING.values() for n in names)
        # mx.contrib.onnx round-trips a graph
        path = str(tmp_path / "fc.onnx")
        with tmx.cpu():
            fc = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                        no_bias=True, name="fc")
            tmx.contrib.onnx.export_model(
                fc, {"fc_weight": tmx.nd.ones((2, 3))},
                input_shapes={"data": (1, 3)}, onnx_file_path=path)
            sym, args, _ = tmx.contrib.onnx.import_model(path)
        assert sorted(args) == ["fc_weight"] and \
            "fc_weight" in sym.list_arguments()
        # ImageRecordIterNative reads JPEG records
        rec = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "x.idx"),
                                             str(tmp_path / "x.rec"), "w")
        for i in range(2):
            buf = io.BytesIO()
            Image.new("RGB", (9, 7), (10 * i, 20, 30)).save(buf, "JPEG")
            rec.write_idx(i, tmx.recordio.pack(
                tmx.recordio.IRHeader(0, float(i), i, 0), buf.getvalue()))
        rec.close()
        it = tmx.io.ImageRecordIterNative(
            path_imgrec=str(tmp_path / "x.rec"),
            path_imgidx=str(tmp_path / "x.idx"), data_shape=(3, 8, 8),
            batch_size=2, ctx=tmx.cpu())
        batch = it.next()
        assert batch.data[0].shape == (2, 3, 8, 8)
        assert batch.label[0].asnumpy().tolist() == [0.0, 1.0]
