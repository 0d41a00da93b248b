"""``mx.nd.contrib``: ``arange_like``, ``boolean_mask``, ``index_copy``,
``index_array``, ``getnnz``, ``quantize``/``dequantize`` and the
detection and vision contrib ops.

Port of ``mxnet_tpu/ndarray/contrib.py``. The op wrappers call the
registry (``ops/detection.py``: ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``box_nms``, ``box_iou``,
``bipartite_matching``; ``ops/vision_contrib.py``: ``ROIAlign``,
``BilinearResize2D``, ``AdaptiveAvgPooling2D``, ``box_decode``,
``box_encode``, ``DeformableConvolution``, ``PSROIPooling``), so
``mx.nd.contrib.<op>``, ``mx.nd.<op>`` and ``mx.nd._contrib_<op>`` are
one function. ``foreach``, ``while_loop`` and ``cond`` are
``ops/control_flow.py``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from .ndarray import NDArray, as_nd
from .register import get_op as _get_op
from .register import invoke as _invoke

__all__ = ["AdaptiveAvgPooling2D", "BilinearResize2D",
           "DeformableConvolution", "MultiBoxDetection", "MultiBoxPrior",
           "MultiBoxTarget", "PSROIPooling", "ROIAlign", "arange_like",
           "bipartite_matching", "boolean_mask", "box_decode", "box_encode",
           "box_iou", "box_nms", "cond", "dequantize", "foreach", "getnnz",
           "index_array", "index_copy", "quantize", "while_loop"]


def _nd(t):
    return as_nd(t)


def _plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, NDArray) else t


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    return _invoke(_get_op("_arange_like"), [data],
                   {"start": start, "step": step, "repeat": repeat,
                    "axis": axis})


def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (reference boolean_mask.cc). The output's shape depends on the
    mask's values, so the mask is read back once (as in the JAX
    package: an eager-only op), then one differentiable ``take``
    gathers the slices; rows masked out get a zero gradient."""
    if not isinstance(index, NDArray) or not isinstance(data, NDArray):
        raise TypeError("boolean_mask expects NDArray data and index")
    if index.dim() != 1:
        raise ValueError(f"index must be 1-D, got shape {tuple(index.shape)}")
    ax = int(axis)
    if index.shape[0] != data.shape[ax]:
        raise ValueError(
            f"boolean_mask: index length {index.shape[0]} != data.shape"
            f"[{ax}] = {data.shape[ax]}")
    keep = torch.nonzero(_plain(index) != 0).reshape(-1)
    return _invoke(_get_op("take"), [data, _nd(keep.to(data.device))],
                   {"axis": ax, "mode": "clip"})


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with the rows ``index_vector`` replaced by
    ``new_tensor``'s (a new array)."""
    out = _plain(old_tensor).clone()
    out[_plain(index_vector).long()] = _plain(new_tensor).to(out.dtype)
    return _nd(out)


def index_array(data, axes=None):
    """Each element's index along ``axes`` (all by default): int64 of
    shape ``data.shape + (len(axes),)``."""
    shape = data.shape
    axes = tuple(int(a) for a in np.atleast_1d(axes)) if axes is not None \
        else tuple(range(len(shape)))
    grids = torch.meshgrid(*[torch.arange(shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return _nd(torch.stack(grids, -1).to(torch.int64))


def getnnz(data, axis=None):
    """The stored values of a csr array, as a 1-element int64 array."""
    from . import sparse
    if isinstance(data, sparse.CSRNDArray):
        return _nd(torch.tensor([data._aux.shape[0]], dtype=torch.int64,
                                device=data._aux.device))
    raise NotImplementedError("getnnz: csr arrays only")


def quantize(data, min_range, max_range, out_type="uint8"):
    """INT8/UINT8 quantization over [min_range, max_range] (reference
    quantize.cc); returns (quantized, min_range, max_range)."""
    lo = float(min_range.asscalar())
    hi = float(max_range.asscalar())
    x = _plain(data)
    if out_type == "uint8":
        scale = 255.0 / max(hi - lo, 1e-8)
        q = torch.round((x - lo) * scale).clamp(0, 255).to(torch.uint8)
    else:
        scale = 127.0 / max(abs(hi), abs(lo), 1e-8)
        q = torch.round(x * scale).clamp(-127, 127).to(torch.int8)
    return _nd(q), min_range, max_range


def dequantize(data, min_range, max_range, out_type="float32"):
    lo = float(min_range.asscalar())
    hi = float(max_range.asscalar())
    x = _plain(data)
    if x.dtype == torch.uint8:
        return _nd(x.to(torch.float32) * ((hi - lo) / 255.0) + lo)
    return _nd(x.to(torch.float32) * (max(abs(hi), abs(lo)) / 127.0))


# -- SSD detection family (ops/detection.py) ---------------------------
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    return _invoke(_get_op("_contrib_MultiBoxPrior"), [data],
                   {"sizes": sizes, "ratios": ratios, "clip": clip,
                    "steps": steps, "offsets": offsets})


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    return _invoke(_get_op("_contrib_MultiBoxTarget"),
                   [anchor, label, cls_pred],
                   {"overlap_threshold": overlap_threshold,
                    "ignore_label": ignore_label,
                    "negative_mining_ratio": negative_mining_ratio,
                    "negative_mining_thresh": negative_mining_thresh,
                    "minimum_negative_samples": minimum_negative_samples,
                    "variances": variances})


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    return _invoke(_get_op("_contrib_MultiBoxDetection"),
                   [cls_prob, loc_pred, anchor],
                   {"clip": clip, "threshold": threshold,
                    "background_id": background_id,
                    "nms_threshold": nms_threshold,
                    "force_suppress": force_suppress,
                    "variances": variances, "nms_topk": nms_topk})


def box_nms(data, **kwargs):
    return _invoke(_get_op("_contrib_box_nms"), [data], kwargs)


def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    return _invoke(_get_op("_contrib_box_iou"), [lhs, rhs],
                   {"format": format})


def bipartite_matching(dist, is_ascend=False, threshold=None, topk=-1):
    return _invoke(_get_op("_contrib_bipartite_matching"), [dist],
                   {"is_ascend": is_ascend, "threshold": threshold,
                    "topk": topk})


# -- contrib vision ops (ops/vision_contrib.py) --------------------------
def ROIAlign(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
             sample_ratio=-1, position_sensitive=False, aligned=False):
    return _invoke(_get_op("_contrib_ROIAlign"), [data, rois],
                   {"pooled_size": pooled_size,
                    "spatial_scale": spatial_scale,
                    "sample_ratio": sample_ratio,
                    "position_sensitive": position_sensitive,
                    "aligned": aligned})


def BilinearResize2D(data, height=0, width=0, scale_height=None,
                     scale_width=None, mode="size"):
    return _invoke(_get_op("_contrib_BilinearResize2D"), [data],
                   {"height": height, "width": width,
                    "scale_height": scale_height,
                    "scale_width": scale_width, "mode": mode})


def AdaptiveAvgPooling2D(data, output_size=(1, 1)):
    return _invoke(_get_op("_contrib_AdaptiveAvgPooling2D"), [data],
                   {"output_size": output_size})


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):  # noqa: A002
    return _invoke(_get_op("_contrib_box_decode"), [data, anchors],
                   {"std0": std0, "std1": std1, "std2": std2, "std3": std3,
                    "clip": clip, "format": format})


def box_encode(samples, matches, anchors, refs,
               means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.2, 0.2)):
    return _invoke(_get_op("_contrib_box_encode"),
                   [samples, matches, anchors, refs],
                   {"means": means, "stds": stds})


def DeformableConvolution(data, offset, weight, bias=None, kernel=(3, 3),
                          stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                          num_filter=0, num_group=1, num_deformable_group=1,
                          no_bias=False):
    return _invoke(_get_op("_contrib_DeformableConvolution"),
                   [data, offset, weight, bias],
                   {"kernel": kernel, "stride": stride, "dilate": dilate,
                    "pad": pad, "num_filter": num_filter,
                    "num_group": num_group,
                    "num_deformable_group": num_deformable_group,
                    "no_bias": no_bias})


def PSROIPooling(data, rois, spatial_scale=1.0, output_dim=0,
                 pooled_size=7, group_size=0):
    return _invoke(_get_op("_contrib_PSROIPooling"), [data, rois],
                   {"spatial_scale": spatial_scale, "output_dim": output_dim,
                    "pooled_size": pooled_size, "group_size": group_size})
