"""The port's contrib vision ops (``ops/vision_contrib.py``) against the
JAX package's, on the CPU.

The same numpy inputs go to the JAX op function and to the port's (CPU
tensors): forward values within 1e-6 of scale, and the gradient of
``sum(out * cotangent)`` (one seeded cotangent) with respect to every
differentiable input within 1e-5 of scale, ``jax.grad`` against torch's
autograd. Scale is a tensor's largest magnitude (at least 1). Cases
reach each op's boundary mode: ROIs that leave the image (ROIAlign's
zero band), offsets that push taps past the border (the deformable
convolution's fade), align-corners resizing, uneven adaptive bins,
PSROIPooling with ``group_size`` other than ``pooled_size``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import vision_contrib as jvc
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import vision_contrib as tvc

torch.set_num_threads(1)


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


def _check(name, arrays, grad_of, seed=0, **kw):
    """Forward and input gradients of ``name`` in both packages;
    ``grad_of`` the indices of the inputs to differentiate (the JAX side
    as one jitted ``jax.vjp``)."""
    jfn, tfn = getattr(jvc, name), getattr(tvc, name)
    rs = np.random.RandomState(seed)

    def f(*diff):
        full = [jnp.asarray(a) for a in arrays]
        for i, d in zip(grad_of, diff):
            full[i] = d
        return jfn(*full, **kw)

    def fwd_bwd(cot, *diff):
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cot)

    shape = jax.eval_shape(f, *[jnp.asarray(arrays[i]) for i in grad_of])
    cot = rs.randn(*shape.shape).astype(np.float32)
    want, jgrads = jax.jit(fwd_bwd)(
        jnp.asarray(cot, shape.dtype),
        *[jnp.asarray(arrays[i]) for i in grad_of])
    want = np.asarray(want)
    ts = [torch.tensor(a, requires_grad=i in grad_of)
          for i, a in enumerate(arrays)]
    got = tfn(*ts, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * _scale(want))
    (got * torch.from_numpy(cot)).sum().backward()
    for i, jg in zip(grad_of, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(ts[i].grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * _scale(jg), err_msg=str(i))


def _rois(rs, r, b, h, w, scale=1.0, out=0.0):
    x1 = rs.uniform(-out, w / scale * 0.6, r)
    y1 = rs.uniform(-out, h / scale * 0.6, r)
    x2 = x1 + rs.uniform(0.5, w / scale * 0.7, r)
    y2 = y1 + rs.uniform(0.5, h / scale * 0.7, r)
    idx = rs.randint(0, b, r)
    return np.stack([idx, x1, y1, x2, y2], 1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {"pooled_size": (3, 3), "spatial_scale": 0.5},
    {"pooled_size": (2, 4), "sample_ratio": 3, "aligned": True},
])
def test_roi_align(kw):
    rs = np.random.RandomState(0)
    data = rs.randn(2, 3, 10, 12).astype(np.float32)
    scale = kw.get("spatial_scale", 1.0)
    rois = _rois(rs, 5, 2, 10, 12, scale, out=2.0)   # some leave the image
    _check("roi_align", [data, rois], grad_of=(0, 1), **kw)


def test_roi_align_refusals():
    x = torch.zeros(1, 4, 4, 4)
    r = torch.tensor([[0.0, 0.0, 0.0, 2.0, 2.0]])
    with pytest.raises(NotImplementedError):
        nd.contrib.ROIAlign(x, r, position_sensitive=True)


@pytest.mark.parametrize("kw", [{"height": 9, "width": 1},
                                {"scale_height": 1.6, "scale_width": 0.5}])
def test_bilinear_resize_2d(kw):
    data = np.random.RandomState(1).randn(2, 3, 5, 7).astype(np.float32)
    _check("bilinear_resize_2d", [data], grad_of=(0,), **kw)
    with pytest.raises(NotImplementedError):
        nd.contrib.BilinearResize2D(torch.zeros(1, 1, 2, 2), height=3,
                                    width=3, mode="odd_scale")


@pytest.mark.parametrize("size", [(3, 4), 1])
def test_adaptive_avg_pooling_2d(size):
    data = np.random.RandomState(2).randn(2, 3, 7, 9).astype(np.float32)
    _check("adaptive_avg_pooling_2d", [data], grad_of=(0,),
           output_size=size)


@pytest.mark.parametrize("kw", [{"std0": 0.2, "std3": 0.5},
                                {"format": "center", "clip": 1.2}])
def test_box_decode(kw):
    rs = np.random.RandomState(3)
    data = rs.randn(2, 6, 4).astype(np.float32)
    xy = rs.rand(1, 6, 2)
    anchors = np.concatenate([xy, xy + rs.rand(1, 6, 2) * 0.5 + 0.1],
                             -1).astype(np.float32)
    _check("box_decode", [data, anchors], grad_of=(0, 1), **kw)


def test_box_encode():
    rs = np.random.RandomState(4)
    samples = (rs.rand(2, 6) > 0.4).astype(np.float32)
    matches = rs.randint(-1, 3, (2, 6)).astype(np.float32)
    xy = rs.rand(2, 6, 2)
    anchors = np.concatenate([xy, xy + rs.rand(2, 6, 2) * 0.5 + 0.1],
                             -1).astype(np.float32)
    xy = rs.rand(2, 3, 2)
    refs = np.concatenate([xy, xy + rs.rand(2, 3, 2) * 0.5 + 0.1],
                          -1).astype(np.float32)
    kw = {"means": (0.1, 0.0, -0.1, 0.0), "stds": (0.1, 0.2, 0.2, 0.3)}
    want = jvc.box_encode(*[jnp.asarray(a) for a in
                            (samples, matches, anchors, refs)], **kw)
    got = nd.contrib.box_encode(*[torch.from_numpy(a) for a in
                                  (samples, matches, anchors, refs)], **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * _scale(w))


def test_deformable_convolution():
    kw = {"kernel": (3, 2), "stride": (2, 1), "dilate": (1, 2),
          "pad": (1, 1), "num_filter": 6, "num_group": 2,
          "num_deformable_group": 2}
    rs = np.random.RandomState(5)
    b, c, h, w = 2, 4, 7, 6
    kh, kw_ = kw["kernel"]
    sh, sw = kw.get("stride", (1, 1))
    dh, dw = kw.get("dilate", (1, 1))
    ph, pw = kw["pad"]
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw_ - 1) - 1) // sw + 1
    dg = kw.get("num_deformable_group", 1)
    data = rs.randn(b, c, h, w).astype(np.float32)
    offset = (rs.randn(b, 2 * kh * kw_ * dg, oh, ow) * 1.5).astype(np.float32)
    weight = (rs.randn(kw["num_filter"], c // kw.get("num_group", 1), kh, kw_)
              * 0.3).astype(np.float32)
    bias = rs.randn(kw["num_filter"]).astype(np.float32)
    _check("deformable_convolution", [data, offset, weight, bias],
           grad_of=(0, 1, 2, 3), **kw)


@pytest.mark.parametrize("kw", [
    {"output_dim": 2, "pooled_size": 3, "spatial_scale": 0.5},
    {"output_dim": 3, "pooled_size": 4, "group_size": 2},
])
def test_psroi_pooling(kw):
    rs = np.random.RandomState(6)
    gs = kw.get("group_size") or kw["pooled_size"]
    c = kw["output_dim"] * gs * gs
    data = rs.randn(2, c, 8, 9).astype(np.float32)
    scale = kw.get("spatial_scale", 1.0)
    rois = _rois(rs, 4, 2, 8, 9, scale)
    _check("psroi_pooling", [data, rois], grad_of=(0,), **kw)


def test_registry_names():
    for name in ("ROIAlign", "BilinearResize2D", "AdaptiveAvgPooling2D",
                 "box_decode", "box_encode", "DeformableConvolution",
                 "PSROIPooling"):
        assert getattr(nd, name)._op is getattr(nd, "_contrib_" + name)._op
        assert not any(name in names for names in nd.WAITING.values())
    assert nd.box_encode._op.num_visible_outputs == 2
