"""int8 quantization (``op_impl_quant``, ``contrib.quantization``)
against the JAX package, on the CPU.

The same numpy-seeded inputs and weights (carried by name) go through
both packages. What is held, and how closely:

- the int8 products: ``int8_gemm``/``int8_conv`` equal numpy's int64
  sums exactly (strides, padding, dilation, groups, and the cuBLASLt
  padding path's shapes);
- ``quantize_v2``/``dequantize_v2``/``quantize_weight``/
  ``quantize_act`` and the two int8 ops: the JAX package's values bit
  for bit (the codes, the scales, the outputs: the int32 sums are
  exact and each float step is one IEEE operation in the same order);
- ``quantize_net``: ``weight_q``, ``weight_scale`` and the folded
  biases bit for bit; the calibrated ranges (``act_amax``) within 1e-6
  relative (maxima of the float nets' activations, which the two
  packages sum in another order: one ulp apart at most here). With the
  JAX net's quantized parameters carried over by name, the port's
  outputs are the JAX quantized net's within 1e-6 of scale (every step
  after the exact int32 sums is one IEEE operation in the same order;
  the tolerance covers a float pooling's summation order). With its own
  calibration, within 1e-2 of scale: a range one ulp apart can put an
  activation on the other side of a rounding step, which moves it by
  one int8 step (~1/127 of that layer's range) and the layers after
  carry it on (resnet18_v1 measured 1.1e-3 of scale). For the JAX
  tests' MLP (dynamic and calibrated), their conv nets (BatchNorm
  folding with random running statistics, ``s8_interfaces`` chains),
  the MLP with entropy calibration and
  ``resnet18_v1`` at 32 x 32 (naive calibration); eager
  and hybridized bit for bit the same; saved by the port and loaded by
  the JAX package.

JAX eager and JAX jitted code divide by 127 differently (``jit`` turns
the division into a multiplication by its reciprocal), so the JAX
quantized layers are run eagerly, as the JAX package runs them.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ndarray import op_impl_quant as jquant
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import op_impl_quant as tquant

torch.set_num_threads(1)


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def carry(jnet, tnet):
    pre = jnet.prefix
    tnet.load_gluon_params({k[len(pre):]: v.data().asnumpy()
                            for k, v in jnet.collect_params().items()})


def params_agree(jnet, tnet):
    """The quantized nets' parameters: int8 codes, scales and biases
    bit for bit, calibrated ranges within 1e-6 relative."""
    pre = jnet.prefix
    jp = {k[len(pre):]: v.data().asnumpy()
          for k, v in jnet.collect_params().items()}
    tp = {k: v.detach().numpy() for k, v in tnet.gluon_params().items()}
    assert sorted(jp) == sorted(tp)
    for k, want in jp.items():
        assert tp[k].dtype == want.dtype, k
        if k.endswith("act_amax"):
            np.testing.assert_allclose(tp[k], want, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(tp[k], want, err_msg=k)
    return jp


# -- the int8 products -------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(5, 13, 3), (17, 16, 8), (40, 147, 64)])
def test_int8_gemm_is_exact(m, k, n):
    rs = np.random.RandomState(m)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    b = rs.randint(-127, 128, (n, k)).astype(np.int8)
    got = tquant.int8_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("stride,pad,dilate,groups", [
    ((1, 1), (1, 1), (1, 1), 1), ((2, 2), (3, 3), (1, 1), 1),
    ((1, 2), (0, 1), (2, 1), 1), ((1, 1), (1, 1), (1, 1), 2)])
def test_int8_conv_is_exact(stride, pad, dilate, groups):
    rs = np.random.RandomState(sum(stride + pad + dilate) + groups)
    x = rs.randint(-127, 128, (2, 4, 9, 8)).astype(np.int8)
    w = rs.randint(-127, 128, (6, 4 // groups, 3, 3)).astype(np.int8)
    got = tquant.int8_conv(torch.from_numpy(x), torch.from_numpy(w), stride,
                           pad, dilate, groups)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(),
        stride=stride, padding=pad, dilation=dilate, groups=groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


# -- the ops -----------------------------------------------------------------
def test_quantize_ops_equal_the_jax_package_bit_for_bit():
    rs = np.random.RandomState(7)
    x = rs.randn(4, 5).astype(np.float32)
    for kw in ({}, {"min_calib_range": -2.0, "max_calib_range": 2.0}):
        jout = jmx.nd.quantize_v2(jmx.nd.array(x), **kw)
        tout = nd.quantize_v2(nd.array(x, ctx=tmx.cpu()), **kw)
        for j, t in zip(jout, tout):
            np.testing.assert_array_equal(t.asnumpy(),
                                          j.asnumpy().astype(t.asnumpy()
                                                             .dtype))
        jdq = jmx.nd.dequantize_v2(*jout).asnumpy()
        tdq = nd.dequantize_v2(*tout).asnumpy()
        np.testing.assert_array_equal(tdq, jdq)
    w = rs.randn(6, 3, 3, 3).astype(np.float32)
    for cw in (False, True):
        jw = [np.asarray(a) for a in jquant.quantize_weight(w, cw)]
        tw = [a.numpy() for a in tquant.quantize_weight(torch.tensor(w), cw)]
        for j, t in zip(jw, tw):
            np.testing.assert_array_equal(t, j)
    for amax in (None, np.array([1.5], np.float32), np.array([-1.0],
                                                              np.float32)):
        ja = [np.asarray(a) for a in jquant.quantize_act(w, amax)]
        ta = [a.numpy() for a in tquant.quantize_act(
            torch.tensor(w), None if amax is None else torch.tensor(amax))]
        for j, t in zip(ja, ta):
            np.testing.assert_array_equal(t, j)


def test_int8_ops_equal_the_jax_package():
    rs = np.random.RandomState(8)
    xq = rs.randint(-127, 128, (8, 16)).astype(np.int8)
    wq = rs.randint(-127, 128, (4, 16)).astype(np.int8)
    xs, ws = np.float32([0.013]), np.float32([0.021])
    b = rs.randn(4).astype(np.float32)
    jfc = jmx.nd.quantized_fully_connected(
        *[jmx.nd.array(a, dtype=a.dtype) for a in (xq, wq, xs, ws, b)],
        num_hidden=4).asnumpy()
    tfc = nd.quantized_fully_connected(
        *[nd.array(a, dtype=a.dtype, ctx=tmx.cpu()) for a in (xq, wq, xs,
                                                               ws, b)],
        num_hidden=4).asnumpy()
    np.testing.assert_array_equal(tfc, jfc)
    cx = rs.randint(-127, 128, (2, 3, 8, 8)).astype(np.int8)
    cw = rs.randint(-127, 128, (5, 3, 3, 3)).astype(np.int8)
    cws = (rs.rand(5).astype(np.float32) + 0.5) / 100
    amax = np.float32([3.0])
    args = (cx, cw, xs, cws, rs.randn(5).astype(np.float32), amax)
    kw = dict(kernel=(3, 3), num_filter=5, pad=(1, 1), stride=(2, 1))
    for n_in in (5, 6):         # float out, and requantized to int8
        jc = jmx.nd.quantized_conv(
            *[jmx.nd.array(a, dtype=a.dtype) for a in args[:n_in]],
            **kw).asnumpy()
        tc = nd.quantized_conv(
            *[nd.array(a, dtype=a.dtype, ctx=tmx.cpu()) for a in
              args[:n_in]], **kw).asnumpy()
        assert tc.dtype == jc.dtype
        np.testing.assert_array_equal(tc, jc)


# -- quantize_net -------------------------------------------------------------
def _mlp(mx_nn, prefix):
    net = mx_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx_nn.Dense(32, activation="relu", in_units=16),
                mx_nn.Dense(8, in_units=32))
    return net


def _conv_net(mx_nn, prefix):
    net = mx_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx_nn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=3),
                mx_nn.BatchNorm(in_channels=8), mx_nn.Activation("relu"),
                mx_nn.Conv2D(8, 3, padding=1, in_channels=8),
                mx_nn.BatchNorm(in_channels=8), mx_nn.Activation("relu"),
                mx_nn.Conv2D(4, 1, in_channels=8), mx_nn.Dense(5))
    return net


def _pair(build, x, rs, random_stats=False):
    """The JAX net (Xavier weights, a forward for the deferred shapes,
    and, when asked, random BatchNorm statistics and affines, as
    training leaves them) and the port's with its weights."""
    jnet = build(jmx.gluon.nn, None)
    jnet.initialize(init=jmx.initializer.Xavier())
    jnet(jmx.nd.array(x))
    if random_stats:
        for name, p in jnet.collect_params().items():
            if "batchnorm" in name:
                v = rs.randn(*p.shape).astype(np.float32)
                p.set_data(jmx.nd.array(np.abs(v) + 0.5 if name.endswith(
                    ("_var", "_gamma")) else v))
    with tmx.cpu():
        tnet = build(nn, jnet.prefix)
        tnet.initialize()
        tnet(torch.tensor(x))
    carry(jnet, tnet)
    return jnet, tnet


CASES = {
    "mlp-dynamic": (_mlp, (8, 16), dict()),
    "mlp-calibrated": (_mlp, (8, 16), dict(calib=2)),
    "conv-fold-bn": (_conv_net, (2, 3, 8, 8), dict(calib=1)),
    "conv-s8-chain": (_conv_net, (2, 3, 8, 8),
                      dict(calib=1, s8_interfaces=True)),
    "mlp-entropy": (_mlp, (8, 16), dict(calib=2, calib_mode="entropy")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_net_equals_the_jax_package(case, tmp_path):
    build, shape, opts = CASES[case]
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    jnet, tnet = _pair(build, x, rs, random_stats=case.startswith("conv"))
    calib = [rs.randn(*shape).astype(np.float32)
             for _ in range(opts.get("calib", 0))]
    kw = {k: v for k, v in opts.items() if k != "calib"}
    if calib:
        kw["num_calib_examples"] = 32 * len(calib)
    jq.quantize_net(jnet, calib_data=[(jmx.nd.array(c),) for c in calib]
                    if calib else None, **kw)
    tq.quantize_net(tnet, calib_data=[(torch.tensor(c),) for c in calib]
                    if calib else None, **kw)
    assert [type(c).__name__ for c in tnet.children()] == \
        [type(c).__name__ for c in jnet._children.values()]
    assert sorted(tnet._quant_ranges) == sorted(jnet._quant_ranges)
    jp = params_agree(jnet, tnet)
    if kw.get("s8_interfaces"):
        tconvs = [c for c in tnet.children()
                  if isinstance(c, tq.QuantizedConv2D)]
        jconvs = [c for c in jnet._children.values()
                  if isinstance(c, jq.QuantizedConv2D)]
        assert [(c._out_req is None, c._prequantized) for c in tconvs] == \
            [(c._out_req is None, c._prequantized) for c in jconvs]
    want = jnet(jmx.nd.array(x)).asnumpy()
    close(tnet(torch.tensor(x)).numpy(), want, 1e-2, f"{case}, own ranges")
    tnet.load_gluon_params(jp)
    got = tnet(torch.tensor(x)).numpy()
    close(got, want, 1e-6, case)
    tnet.hybridize()
    np.testing.assert_array_equal(tnet(torch.tensor(x)).numpy(), got)
    # the quantized parameters checkpoint through the usual files, and
    # the JAX package reads the port's (a chained JAX layer also holds
    # its consumer's range as a parameter of its own, ``_out_req``,
    # which the file does not carry twice)
    f = str(tmp_path / "q.params")
    tnet.save_parameters(f)
    jnet.load_parameters(f, allow_missing=bool(kw.get("s8_interfaces")))
    close(jnet(jmx.nd.array(x)).asnumpy(), got, 1e-6, "jax loads the port's")


def test_quantize_net_refuses_before_rewriting():
    rs = np.random.RandomState(12)
    _, tnet = _pair(_mlp, rs.randn(2, 16).astype(np.float32), rs)
    with pytest.raises(tmx.MXNetError, match="calib_data"):
        tq.quantize_net(tnet, s8_interfaces=True)
    assert all(type(c) is nn.Dense for c in tnet.children())
    with pytest.raises(tmx.MXNetError, match="int8"):
        tq.quantize_net(tnet, quantized_dtype="uint8")


def test_resnet18_quantized_equals_the_jax_package():
    rs = np.random.RandomState(13)
    x = rs.randn(2, 3, 32, 32).astype(np.float32)
    calib = [rs.randn(2, 3, 32, 32).astype(np.float32)]
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    jnet.initialize()
    want_f32 = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        tnet = gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                  prefix=jnet.prefix)
    carry(jnet, tnet)
    jq.quantize_net(jnet, calib_data=[(jmx.nd.array(c),) for c in calib])
    tq.quantize_net(tnet, calib_data=[(torch.tensor(c),) for c in calib])
    jp = params_agree(jnet, tnet)
    # every convolution folded its BatchNorm in: one Identity each
    assert sum(k.endswith("weight_q") for k in jp) == 21
    assert not any("batchnorm" in k and "folded" not in k
                   for k in tnet.gluon_params())
    want = jnet(jmx.nd.array(x)).asnumpy()
    close(tnet(torch.tensor(x)).numpy(), want, 1e-2, "int8, own ranges")
    tnet.load_gluon_params(jp)
    got = tnet(torch.tensor(x)).numpy()
    close(got, want, 1e-6, "int8 resnet18")
    close(got, want_f32, 0.1, "int8 against float32")
    tnet.hybridize()
    np.testing.assert_array_equal(tnet(torch.tensor(x)).numpy(), got)


def test_calibration_and_quantize_model_equal_the_jax_package():
    rs = np.random.RandomState(14)
    act = rs.randn(4096).astype(np.float32)
    act[:4] = 80.0
    assert tq._optimal_threshold(act) == jq._optimal_threshold(act)
    jc, tc = jq.CalibrationCollector(), tq.CalibrationCollector()
    for part in np.split(act, 4):
        jc.collect("l", part)
        tc.collect("l", torch.tensor(part))
    assert tc.ranges() == jc.ranges()
    with pytest.raises(tmx.MXNetError, match="calib_mode"):
        tq.CalibrationCollector("median")

    def graph(mx):
        data = mx.sym.var("data")
        net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                                 name="conv")
        net = mx.sym.FullyConnected(net, num_hidden=3, name="fc")
        return mx.sym.softmax(net, name="out")

    jsym, _, _ = jq.quantize_model(graph(jmx), {}, {})
    tsym, args, auxs = tq.quantize_model(graph(tmx), {}, {})
    assert tsym.tojson() == jsym.tojson() and args == {} and auxs == {}
    assert "__quantized_dtype__" in tsym.tojson()
