"""Contrib vision operators: ROIAlign, BilinearResize2D,
AdaptiveAvgPooling2D, box_encode/box_decode, DeformableConvolution and
PSROIPooling.

Port of ``mxnet_tpu/ops/vision_contrib.py`` (the reference's
``src/operator/contrib/roi_align.cc``, ``bilinear_resize.cc``,
``adaptive_avg_pooling.cc``, ``deformable_convolution.cc``,
``psroi_pooling.cc`` and ``bounding_box.cc``). Each is torch ops on the
input's device and differentiates through autograd, as the JAX package
differentiates through XLA; none reads a tensor back to the host.

Bilinear sampling gathers only the points it needs: the images are
viewed as one (B * H * W, C) table and each sample reads its four
corner rows by index (``index_select``), so ``ROIAlign`` never copies
a whole feature map per ROI (the JAX package gathers ``data[b]`` for
each ROI: 1.3 GB at 512 ROIs over 256 x 50 x 50). Its three boundary
modes are the JAX package's: ``clamp`` (BilinearResize2D), ``zero_band``
(ROIAlign) and ``fade`` (DeformableConvolution). ``PSROIPooling``
likewise copies no feature map per ROI (the JAX package's does, twice:
4.7 GB at R-FCN's 300 ROIs over 1029 x 38 x 50): each bin's sum is four
reads of its image's summed-area table, in float64.
"""
from __future__ import annotations

import torch

from ..ndarray.register import register_op
from .detection import _corner_to_center, _scalar

__all__ = ["adaptive_avg_pooling_2d", "bilinear_resize_2d", "box_decode",
           "box_encode", "deformable_convolution", "psroi_pooling",
           "roi_align"]


def _table(data):
    """(B, C, H, W) as the (B * H * W, C) table ``_bilinear`` reads."""
    b, c, h, w = data.shape
    return data.permute(0, 2, 3, 1).reshape(b * h * w, c)


def _bilinear(table, h, w, base, ys, xs, boundary="clamp"):
    """Bilinear samples (..., C) of the images of ``table`` (``_table``)
    at float coordinates ``ys``/``xs`` (...); ``base`` (broadcastable to
    them) is each sample's image's first row, ``b * H * W``.

    Boundary modes: ``clamp`` clamps coordinates to the edge;
    ``zero_band`` (roi_align.cc) gives 0 for y < -1 or y > H (likewise
    x) and clamps in-band coordinates to the edge pixels at full weight;
    ``fade`` (deformable_im2col) counts each corner tap only if it lies
    inside the image, so values fade to 0 across the border."""
    if boundary == "zero_band":
        inside = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
        ys = ys.clamp(0.0, h - 1)
        xs = xs.clamp(0.0, w - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    shape = torch.broadcast_shapes(ys.shape, xs.shape, base.shape)

    def at(y, x):
        yi = y.clamp(0, h - 1).long()
        xi = x.clamp(0, w - 1).long()
        rows = (base + yi * w + xi).expand(shape).reshape(-1)
        v = table.index_select(0, rows).reshape(shape + (table.shape[1],))
        if boundary == "fade":
            ok = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
            v = v * ok[..., None]
        return v

    out = (at(y0, x0) * (wy0 * wx0)[..., None]
           + at(y0, x0 + 1) * (wy0 * wx1)[..., None]
           + at(y0 + 1, x0) * (wy1 * wx0)[..., None]
           + at(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])
    if boundary == "zero_band":
        out = out * inside[..., None]
    return out


@register_op("_contrib_ROIAlign", aliases=("ROIAlign",))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """ROI align (reference roi_align.cc): the average of bilinear
    samples per bin, no coordinate quantization, differentiable in the
    data and the ROIs. ``sample_ratio <= 0`` (adaptive in the
    reference) means 2 samples per bin axis, as in the JAX package.
    rois are ``[batch_idx, x1, y1, x2, y2]`` rows in image
    coordinates."""
    if position_sensitive:
        raise NotImplementedError(
            "ROIAlign(position_sensitive=True) (R-FCN PS-pooling: "
            "C/(ph*pw) channel groups) is not implemented: plain ROIAlign "
            "semantics would silently mis-train such a model")
    ph, pw = (int(p) for p in pooled_size)
    s = 2 if sample_ratio is None or int(sample_ratio) <= 0 \
        else int(sample_ratio)
    off = 0.5 if aligned else 0.0
    n, c, h, w = data.shape
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    rw = (x2 - x1).clamp_min(1.0 if not aligned else 1e-6)
    rh = (y2 - y1).clamp_min(1.0 if not aligned else 1e-6)
    dev = data.device
    iy = (torch.arange(ph * s, device=dev, dtype=torch.float32) + 0.5) / s
    ix = (torch.arange(pw * s, device=dev, dtype=torch.float32) + 0.5) / s
    ys = y1[:, None] + iy[None, :] * rh[:, None] / ph      # (R, ph*s)
    xs = x1[:, None] + ix[None, :] * rw[:, None] / pw      # (R, pw*s)
    base = (rois[:, 0].long() * (h * w))[:, None, None]
    samp = _bilinear(_table(data.float()), h, w, base, ys[:, :, None],
                     xs[:, None, :], boundary="zero_band")  # (R, P, Q, C)
    r = rois.shape[0]
    out = samp.reshape(r, ph, s, pw, s, c).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2).to(data.dtype)


@register_op("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))
def bilinear_resize_2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """Bilinear resize of (N, C, H, W) with align-corners sampling
    (reference bilinear_resize.cc: src = dst * (in - 1) / (out - 1)).
    Only ``mode="size"``; explicit sizes win over scales."""
    n, c, h, w = data.shape
    if mode != "size":
        raise NotImplementedError(
            f"BilinearResize2D mode={mode!r}: only 'size' is implemented")
    if int(height) <= 0 and scale_height is not None:
        height = int(round(h * float(scale_height)))
    if int(width) <= 0 and scale_width is not None:
        width = int(round(w * float(scale_width)))
    oh, ow = int(height), int(width)
    if oh <= 0 or ow <= 0:
        raise ValueError("BilinearResize2D needs height/width or scales")
    dev = data.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev) * \
        ((h - 1) / (oh - 1) if oh > 1 else 0.0)
    xs = torch.arange(ow, dtype=torch.float32, device=dev) * \
        ((w - 1) / (ow - 1) if ow > 1 else 0.0)
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]
    out = _bilinear(_table(data.float()), h, w, base, ys[None, :, None],
                    xs[None, None, :])                     # (N, oh, ow, C)
    return out.permute(0, 3, 1, 2).to(data.dtype)


@register_op("_contrib_AdaptiveAvgPooling2D",
             aliases=("AdaptiveAvgPooling2D",))
def adaptive_avg_pooling_2d(data, output_size=(1, 1)):
    """Adaptive average pooling (reference adaptive_avg_pooling.cc): bin
    i covers [floor(i * H / oh), ceil((i + 1) * H / oh)), as two
    row-normalized membership matrices contracted with the input."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = (int(o) for o in output_size)
    n, c, h, w = data.shape
    dev = data.device

    def masks(nbins, size):
        i = torch.arange(nbins, device=dev)[:, None]
        s = torch.arange(size, device=dev)[None, :]
        lo = (i * size) // nbins
        hi = ((i + 1) * size + nbins - 1) // nbins
        m = ((s >= lo) & (s < hi)).to(torch.float32)
        return m / m.sum(1, keepdim=True).clamp_min(1.0)

    out = torch.einsum("ph,nchw,qw->ncpq", masks(oh, h), data.float(),
                       masks(ow, w))
    return out.to(data.dtype)


@register_op("_contrib_box_decode", aliases=("box_decode",))
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):  # noqa: A002
    """Decode center-form offsets (B, N, 4) against anchors (1, N, 4) in
    ``format`` into corner boxes (reference bounding_box.cc BoxDecode)."""
    if format == "corner":
        ax, ay, aw, ah = _corner_to_center(anchors)
    elif format == "center":
        ax, ay, aw, ah = (anchors[..., i] for i in range(4))
    else:
        raise ValueError(
            f"box_decode: format must be 'corner' or 'center', "
            f"got {format!r}")
    cx = data[..., 0] * std0 * aw + ax
    cy = data[..., 1] * std1 * ah + ay
    tw = torch.exp(data[..., 2] * std2)
    th = torch.exp(data[..., 3] * std3)
    if clip is not None and clip > 0:
        tw = tw.clamp_max(clip)
        th = th.clamp_max(clip)
    w = tw * aw * 0.5
    h = th * ah * 0.5
    return torch.stack([cx - w, cy - h, cx + w, cy + h], -1)


@register_op("_contrib_box_encode", aliases=("box_encode",),
             differentiable=False, num_visible_outputs=2)
def box_encode(samples, matches, anchors, refs,
               means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.2, 0.2)):
    """Encode matched ground-truth boxes as regression targets
    (reference bounding_box.cc BoxEncode): samples (B, N) (1 for a
    positive anchor), matches (B, N) GT indices, anchors (B, N, 4) and
    refs (B, M, 4) corner boxes. Returns (targets (B, N, 4), masks
    (B, N, 4)); masks zero the non-positive anchors."""
    idx = matches.clamp_min(0).long()
    g = refs.gather(1, idx[:, :, None].expand(-1, -1, 4))
    ax, ay, aw, ah = _corner_to_center(anchors)
    gx, gy, gw, gh = _corner_to_center(g)
    eps = 1e-8
    aw_e, ah_e = aw.clamp_min(eps), ah.clamp_min(eps)
    raw = [(gx - ax) / aw_e, (gy - ay) / ah_e,
           torch.log(gw.clamp_min(eps) / aw_e),
           torch.log(gh.clamp_min(eps) / ah_e)]
    t = torch.stack([(r - float(mu)) / _scalar(float(sd), r)
                     for r, mu, sd in zip(raw, means, stds)], -1)
    m = (samples > 0.5).to(torch.float32)[:, :, None].expand(-1, -1, 4)
    return t * m, m.contiguous()


@register_op("_contrib_DeformableConvolution",
             aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           no_bias=False):
    """Deformable convolution v1 (reference deformable_convolution.cc):
    each kernel tap samples the input at its grid position plus a
    learned offset, bilinearly (``fade`` boundary), and the taps contract
    with the weights as a grouped convolution. data (B, C, H, W); offset
    (B, 2 * KK * num_deformable_group, OH, OW) in channel order
    [g0k0_y, g0k0_x, g0k1_y, ...]; weight (O, C / num_group, kh, kw).
    Differentiable in data, offset and weight."""
    kh, kw = (int(k) for k in kernel)
    sh, sw = (int(s) for s in stride)
    dh, dw = (int(d) for d in dilate)
    ph, pw = (int(p) for p in pad)
    b, c, h, w = data.shape
    o = int(num_filter) if num_filter else weight.shape[0]
    kk = kh * kw
    g = int(num_group)
    dg = int(num_deformable_group)
    if c % g or o % g:
        raise ValueError("channels must divide num_group")
    if c % dg:
        raise ValueError("channels must divide num_deformable_group")
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if offset.shape[1] != 2 * kk * dg:
        raise ValueError(
            f"offset needs {2 * kk * dg} channels, got {offset.shape[1]}")
    dev = data.device
    base_y = torch.arange(oh, dtype=torch.float32, device=dev) * sh - ph
    base_x = torch.arange(ow, dtype=torch.float32, device=dev) * sw - pw
    cg = c // dg
    x = data.float()
    off = offset.float()
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None]
    tables = [_table(x[:, gi * cg:(gi + 1) * cg]) for gi in range(dg)]
    taps = []
    for idx in range(kk):
        i, j = idx // kw, idx % kw
        parts = []
        for gi in range(dg):
            dy = off[:, (gi * kk + idx) * 2]                 # (B, OH, OW)
            dx = off[:, (gi * kk + idx) * 2 + 1]
            ys = base_y[:, None] + i * dh + dy
            xs = base_x[None, :] + j * dw + dx
            parts.append(_bilinear(tables[gi], h, w, base, ys, xs,
                                   boundary="fade"))        # (B, OH, OW, cg)
        taps.append(torch.cat(parts, -1))
    cols = torch.stack(taps, 1)                     # (B, KK, OH, OW, C)
    colsg = cols.reshape(b, kk, oh, ow, g, c // g)
    wr = weight.float().reshape(g, o // g, c // g, kk)
    out = torch.einsum("bkyxgc,gock->bgoyx", colsg, wr).reshape(b, o, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.float()[None, :, None, None]
    return out.to(data.dtype)


@register_op("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                  pooled_size=7, group_size=0):
    """Position-sensitive ROI pooling (reference psroi_pooling.cc,
    R-FCN): the channels are (output_dim x group^2); bin (i, j) averages
    the cells of channel group (floor(i * group / k), floor(j * group /
    k)) over its extent. rois are ``[batch_idx, x1, y1, x2, y2]`` image
    coordinate rows; their corners round half away from zero, as C's
    ``round``."""
    k = int(pooled_size)
    gs = int(group_size) if group_size else k
    od = int(output_dim)
    b, c, h, w = data.shape
    if od * gs * gs != c:
        raise ValueError(
            f"PSROIPooling: channels {c} != output_dim*group^2 "
            f"({od}*{gs}^2)")
    dev = data.device

    def round_c(v):
        return torch.floor(v + 0.5)

    x1 = round_c(rois[:, 1]) * spatial_scale
    y1 = round_c(rois[:, 2]) * spatial_scale
    x2 = round_c(rois[:, 3] + 1.0) * spatial_scale
    y2 = round_c(rois[:, 4] + 1.0) * spatial_scale
    rw = (x2 - x1).clamp_min(0.1)
    rh = (y2 - y1).clamp_min(0.1)
    i = torch.arange(k, dtype=torch.float32, device=dev)[None, :]
    yy1, xx1 = y1[:, None], x1[:, None]
    hh, ww = rh[:, None], rw[:, None]
    # a true division on either device: the bins' ends are floored and
    # ceiled, so a last-bit difference at an integer moves a whole row
    kt = _scalar(float(k), hh)
    lo_y = torch.floor(yy1 + i * hh / kt).clamp(0, h).long()     # (R, k)
    hi_y = torch.ceil(yy1 + (i + 1) * hh / kt).clamp(0, h).long()
    lo_x = torch.floor(xx1 + i * ww / kt).clamp(0, w).long()
    hi_x = torch.ceil(xx1 + (i + 1) * ww / kt).clamp(0, w).long()
    gidx = torch.arange(k, device=dev) * gs // k
    chan = (torch.arange(od, device=dev)[:, None, None] * (gs * gs)
            + gidx[None, :, None] * gs + gidx[None, None, :])  # (od, k, k)
    # bin (i, j) covers cells [lo_y, hi_y) x [lo_x, hi_x): four reads of
    # each image's summed-area table, in float64 so that the difference
    # of two large prefix sums loses nothing a float32 sum would keep
    sat = torch.nn.functional.pad(
        data.to(torch.float64).cumsum(2).cumsum(3), (1, 0, 1, 0))
    flat = sat.reshape(-1)
    plane = (rois[:, 0].long()[:, None, None, None] * c
             + chan[None]) * (h + 1)                          # (R, od, k, k)

    def at(y, x):
        idx = (plane + y[:, None, :, None]) * (w + 1) + x[:, None, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    sums = (at(hi_y, hi_x) - at(lo_y, hi_x) - at(hi_y, lo_x)
            + at(lo_y, lo_x))
    area = ((hi_y - lo_y)[:, :, None] * (hi_x - lo_x)[:, None, :]
            ).clamp_min(1)
    return (sums / area[:, None]).to(data.dtype)
