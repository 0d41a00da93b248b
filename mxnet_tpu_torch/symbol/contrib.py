"""``mx.sym.contrib``: ``arange_like`` and the detection and vision
contrib ops (port of ``mxnet_tpu/symbol/contrib.py``): each builds a
node of the registry's op (``ops/detection.py``,
``ops/vision_contrib.py``), which binds and runs through ``Executor``
as any other node."""
from __future__ import annotations

from ..ndarray.register import get_op
from .symbol import _get_op_or_waiting, _make_node


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, name=None):
    return _make_node(get_op("_arange_like"), [data],
                      {"start": start, "step": step, "repeat": repeat,
                       "axis": axis}, name=name)


def _contrib_sym(op_name):
    def f(*inputs, name=None, **params):
        return _make_node(_get_op_or_waiting(op_name), list(inputs), params,
                          name=name)
    f.__name__ = op_name.replace("_contrib_", "")
    return f


MultiBoxPrior = _contrib_sym("_contrib_MultiBoxPrior")
MultiBoxTarget = _contrib_sym("_contrib_MultiBoxTarget")
MultiBoxDetection = _contrib_sym("_contrib_MultiBoxDetection")
box_nms = _contrib_sym("_contrib_box_nms")
box_iou = _contrib_sym("_contrib_box_iou")
bipartite_matching = _contrib_sym("_contrib_bipartite_matching")

ROIAlign = _contrib_sym("_contrib_ROIAlign")
BilinearResize2D = _contrib_sym("_contrib_BilinearResize2D")
AdaptiveAvgPooling2D = _contrib_sym("_contrib_AdaptiveAvgPooling2D")
box_decode = _contrib_sym("_contrib_box_decode")
box_encode = _contrib_sym("_contrib_box_encode")
DeformableConvolution = _contrib_sym("_contrib_DeformableConvolution")
PSROIPooling = _contrib_sym("_contrib_PSROIPooling")
