"""``mx.sym.npx``: the symbolic NumPy-extension namespace.

Port of ``mxnet_tpu/symbol/numpy_extension.py`` (MXNet's
``python/mxnet/symbol/numpy_extension/``): the eager ``mx.npx``
operators for graphs, each the same registry op under its NumPy-style
name. ``deconvolution`` and ``roi_pooling`` raise
``NotImplementedError`` naming their ROADMAP item, as ``mx.sym``'s
``Deconvolution`` and ``ROIPooling`` do."""
from __future__ import annotations

import sys as _sys

from .symbol import Symbol, _get_op_or_waiting, _make_node

__all__ = []

_NPX_OPS = {
    "relu": "relu", "sigmoid": "sigmoid", "log_sigmoid": "log_sigmoid",
    "softmax": "softmax", "log_softmax": "log_softmax",
    "softmin": "softmin", "activation": "Activation",
    "leaky_relu": "LeakyReLU", "gelu": "gelu", "erf": "erf",
    "erfinv": "erfinv", "gamma": "gamma", "gammaln": "gammaln",
    "digamma": "digamma", "smooth_l1": "smooth_l1",
    "batch_dot": "batch_dot", "fully_connected": "FullyConnected",
    "convolution": "Convolution", "deconvolution": "Deconvolution",
    "pooling": "Pooling", "dropout": "Dropout", "embedding": "Embedding",
    "batch_norm": "BatchNorm", "layer_norm": "LayerNorm",
    "group_norm": "GroupNorm", "instance_norm": "InstanceNorm",
    "l2_normalization": "L2Normalization", "rnn": "RNN",
    "roi_pooling": "ROIPooling", "ctc_loss": "ctc_loss",
    "one_hot": "one_hot", "pick": "pick", "topk": "topk",
    "gather_nd": "gather_nd", "scatter_nd": "scatter_nd",
    "arange_like": "arange_like", "broadcast_like": "broadcast_like",
    "sequence_mask": "SequenceMask", "reshape": "reshape",
    "reshape_like": "reshape_like",
    "multibox_prior": "_contrib_MultiBoxPrior",
    "multibox_target": "_contrib_MultiBoxTarget",
    "multibox_detection": "_contrib_MultiBoxDetection",
    "box_nms": "_contrib_box_nms", "box_iou": "_contrib_box_iou",
}

_mod = _sys.modules[__name__]


def _make(fname, opname):
    def f(*args, name=None, **params):
        bad = [a for a in args
               if not (isinstance(a, Symbol) or a is None)]
        if bad:
            raise TypeError(
                f"sym.npx.{fname}: positional argument of type "
                f"{type(bad[0]).__name__} is not a tensor input — pass "
                f"op parameters as keywords")
        inputs = list(args)
        # trailing optional inputs (e.g. bias=None) drop like eager
        while inputs and inputs[-1] is None:
            inputs.pop()
        if any(i is None for i in inputs):
            raise TypeError(
                f"sym.npx.{fname}: only TRAILING tensor inputs may be None")
        return _make_node(_get_op_or_waiting(opname), inputs, params,
                          name=name)

    f.__name__ = fname
    f.__doc__ = f"Symbolic npx.{fname}: registry op {opname}."
    return f


for _f, _o in _NPX_OPS.items():
    setattr(_mod, _f, _make(_f, _o))
    __all__.append(_f)


def reshape(data, newshape=None, reverse=False, name=None, **params):
    """Symbolic npx.reshape: same signature as the eager one
    (newshape maps to the op's ``shape`` param; special codes apply)."""
    if newshape is None:
        newshape = params.pop("shape", None)
    if newshape is None:
        raise TypeError("sym.npx.reshape requires newshape")
    return _make_node(_get_op_or_waiting("reshape"), [data],
                      {"shape": tuple(newshape), "reverse": reverse},
                      name=name)


__all__.append("reshape")


def __getattr__(attr):
    # AttributeError (not NotImplementedError) keeps hasattr/getattr
    # introspection semantics while preserving the pointer message
    raise AttributeError(
        f"sym.npx.{attr} has no symbolic lowering — hybridize the "
        f"block instead (the compiled path supports all of mx.npx)")
