"""``mx.npx``: the NumPy-extension namespace of the PyTorch port.

Port of ``mxnet_tpu/numpy_extension/__init__.py`` (MXNet's
``mx.npx``): the np-mode switch (``set_np``/``reset_np``/``use_np``,
``util``'s flags), the neural-network operators under NumPy's naming,
MXNet's ``reshape`` codes, and ``save``/``load``, whose arrays come
back as ``mx.np.ndarray``. Each function dispatches the same registry
op as the classic frontend: ``npx.layer_norm`` is ``LayerNorm``
(K3a/K3b on the card), ``npx.rnn`` is ``RNN`` (K6a/K6b in LSTM mode),
``npx.fully_connected`` ``FullyConnected``. ``deconvolution`` and
``roi_pooling`` raise ``NotImplementedError`` naming their ROADMAP item
('Vision remainders'), as ``mx.nd``'s ``Deconvolution`` and
``ROIPooling`` do.
"""
from __future__ import annotations

from ..ndarray import WAITING as _WAITING
from ..numpy.multiarray import _np_invoke, _proc, _procs
from ..util import (is_np_array, is_np_shape, reset_np,  # noqa: F401
                    set_np, use_np)

__all__ = [
    "set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
    "relu", "sigmoid", "log_sigmoid", "softmax", "log_softmax", "softmin",
    "activation", "leaky_relu", "gelu", "erf", "erfinv", "gamma",
    "gammaln", "digamma", "batch_dot", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "l2_normalization", "fully_connected",
    "convolution", "deconvolution", "pooling", "dropout", "embedding",
    "one_hot", "pick", "topk", "rnn", "roi_pooling", "sequence_mask",
    "smooth_l1", "gather_nd", "scatter_nd", "arange_like",
    "broadcast_like", "reshape", "reshape_like", "ctc_loss",
    "multibox_prior", "multibox_target", "multibox_detection",
    "box_nms", "box_iou", "waitall", "save", "load", "seed",
]

_WAITING_ITEM = {n: item for item, names in _WAITING.items() for n in names}


def _ns(fname, opname, tensor_args=1):
    """An npx function dispatching a registry op: the leading
    ``tensor_args`` positionals are tensor inputs (None for an optional
    one), the keywords the op's parameters."""

    def f(*args, **kwargs):
        if opname in _WAITING_ITEM:
            raise NotImplementedError(
                f"npx.{fname} ({opname}) is not ported yet (ROADMAP Queue "
                f"1, '{_WAITING_ITEM[opname]}')")
        if len(args) > tensor_args:
            raise TypeError(f"npx.{fname} takes at most {tensor_args} "
                            f"positional tensor arguments")
        return _np_invoke(opname, _procs(*args), kwargs or None)

    f.__name__ = fname
    f.__doc__ = f"npx.{fname}: the registry op {opname} under np-mode."
    return f


# activations and math extensions
relu = _ns("relu", "relu")
sigmoid = _ns("sigmoid", "sigmoid")
log_sigmoid = _ns("log_sigmoid", "log_sigmoid")
softmax = _ns("softmax", "softmax")
log_softmax = _ns("log_softmax", "log_softmax")
softmin = _ns("softmin", "softmin")
activation = _ns("activation", "Activation")
leaky_relu = _ns("leaky_relu", "LeakyReLU")
gelu = _ns("gelu", "gelu")
erf = _ns("erf", "erf")
erfinv = _ns("erfinv", "erfinv")
gamma = _ns("gamma", "gamma")
gammaln = _ns("gammaln", "gammaln")
digamma = _ns("digamma", "digamma")
smooth_l1 = _ns("smooth_l1", "smooth_l1")

# contractions and layers (tensor arity as the classic ops')
batch_dot = _ns("batch_dot", "batch_dot", tensor_args=2)
fully_connected = _ns("fully_connected", "FullyConnected", tensor_args=3)
convolution = _ns("convolution", "Convolution", tensor_args=3)
deconvolution = _ns("deconvolution", "Deconvolution", tensor_args=3)
pooling = _ns("pooling", "Pooling")
dropout = _ns("dropout", "Dropout")
embedding = _ns("embedding", "Embedding", tensor_args=2)
batch_norm = _ns("batch_norm", "BatchNorm", tensor_args=5)
layer_norm = _ns("layer_norm", "LayerNorm", tensor_args=3)
group_norm = _ns("group_norm", "GroupNorm", tensor_args=3)
instance_norm = _ns("instance_norm", "InstanceNorm", tensor_args=3)
l2_normalization = _ns("l2_normalization", "L2Normalization")
rnn = _ns("rnn", "RNN", tensor_args=4)
roi_pooling = _ns("roi_pooling", "ROIPooling", tensor_args=2)
ctc_loss = _ns("ctc_loss", "ctc_loss", tensor_args=4)

# indexing and shapes
one_hot = _ns("one_hot", "one_hot")
pick = _ns("pick", "pick", tensor_args=2)
topk = _ns("topk", "topk")
gather_nd = _ns("gather_nd", "gather_nd", tensor_args=2)
scatter_nd = _ns("scatter_nd", "scatter_nd", tensor_args=2)
arange_like = _ns("arange_like", "arange_like")
broadcast_like = _ns("broadcast_like", "broadcast_like", tensor_args=2)
sequence_mask = _ns("sequence_mask", "SequenceMask", tensor_args=2)
reshape_like = _ns("reshape_like", "reshape_like", tensor_args=2)


def reshape(a, newshape, reverse=False, order="C"):
    """MXNet's reshape codes: 0 keeps a dimension, -1 infers one, -2
    copies the rest, -3 merges two, -4 splits one into the next two
    values."""
    return _np_invoke("reshape", [_proc(a)],
                      {"shape": tuple(newshape), "reverse": reverse})


multibox_prior = _ns("multibox_prior", "_contrib_MultiBoxPrior")
multibox_target = _ns("multibox_target", "_contrib_MultiBoxTarget",
                      tensor_args=3)
multibox_detection = _ns("multibox_detection", "_contrib_MultiBoxDetection",
                         tensor_args=3)
box_nms = _ns("box_nms", "_contrib_box_nms")
box_iou = _ns("box_iou", "_contrib_box_iou", tensor_args=2)


def waitall():
    from ..engine import engine
    engine.wait_all()


def save(fname, data):
    """Save arrays (a dict, a list or one) in the ``.params`` format."""
    from ..ndarray import serialization
    serialization.save(fname, data)


def load(fname):
    """The arrays of :func:`save`'s file, as ``mx.np.ndarray``s."""
    from ..ndarray import serialization
    loaded = serialization.load(fname)
    if isinstance(loaded, dict):
        return {k: v.as_np_ndarray() for k, v in loaded.items()}
    if isinstance(loaded, list):
        return [v.as_np_ndarray() for v in loaded]
    return loaded.as_np_ndarray()


def seed(seed_state):
    from .. import random as _r
    _r.seed(seed_state)
