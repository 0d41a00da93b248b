"""``mx.nd``: the imperative NDArray namespace of the PyTorch port.

Port of ``mxnet_tpu/ndarray/__init__.py``. The ``NDArray`` type and its
constructors, the ``.params`` file format (``save``/``load``), and one
function ``mx.nd.<op>`` per registered operator, generated at import
from the registry (``register.populate_namespace``, MXNet's
``_init_op_module``): the tensor ops (``op_impl_basic``), the
neural-network ops (``op_impl_nn``: ``FullyConnected``, ``LayerNorm``,
``flash_attention``, ``softmax_cross_entropy``, ...), ``RNN``, the
optimizer updates, the int8 ops (``op_impl_quant``) and the samplers,
with MXNet's names and arguments.
Then the eager wrappers the JAX file writes by hand: ``Dropout`` (reads
``autograd.is_training()``), ``BatchNorm`` (updates the moving
statistics in place when training), ``concat``/``stack``/``add_n``
(lists or varargs), ``split``/``split_v2``/``topk``, ``moveaxis`` and
``waitall``; and the ``random``, ``linalg``, ``sparse`` and ``contrib``
sub-namespaces. The detection and vision contrib ops
(``ops/detection.py``, ``ops/vision_contrib.py``) are registered under
their plain and ``_contrib_`` names, and ``nd.contrib`` wraps them.

The port's own names stay: ``nd.rnn``, ``nd.layer_norm``,
``nd.flash_attention_op``, ``nd.convolution``, ``nd.pooling``,
``nd.batch_norm`` and ``nd.batch_norm_train`` are the op functions the
port's layers call directly, which the registry holds as ``RNN``,
``LayerNorm``, ``flash_attention``, ...: a registry call and a direct
call take the same path to the same kernel. ``nd.relu``, ``nd.pick``,
``nd.log_softmax`` and ``nd.softmax_cross_entropy`` are the registry's
functions of those names. The update ops (``nd.sgd_update``, ...) are
the JAX ops': they return the new weight and write the states back
(the port's optimizers call ``op_impl_optimizer``'s in-place
functions). The ``_npi_*`` operators of the NumPy frontend
(``numpy/ops.py``) join the namespace when the package imports it. A
name of the JAX registry that is not ported yet (:data:`WAITING`)
raises ``NotImplementedError`` naming its ROADMAP Queue 1 item.
"""
from __future__ import annotations

from . import ndarray, register, serialization
from . import op_impl_basic, op_impl_nn, op_impl_optimizer, op_impl_random
from . import op_impl_quant, op_impl_rnn
from .. import operator as _operator  # noqa: F401  (registers Custom)
from ..ops import detection as _detection  # noqa: F401  (SSD op family)
from ..ops import vision_contrib as _vision_contrib  # noqa: F401
from .ndarray import NDArray, arange, array, empty, full, ones, waitall, zeros

_GENERATED = register.populate_namespace(__name__)

from .. import autograd as _autograd  # noqa: E402
# the port's own op functions under their own names (the registry has
# them as Convolution, LayerNorm, flash_attention, RNN, ...)
from .op_impl_nn import (batch_norm, batch_norm_train,  # noqa: E402
                         convolution, flash_attention_op, layer_norm,
                         pooling)
from .op_impl_rnn import rnn  # noqa: E402
from .register import get_op as _get_op  # noqa: E402
from .register import invoke as _invoke  # noqa: E402
from .serialization import load, load_bytes, save, save_bytes  # noqa: E402

# ----------------------------------------------------------------------
# names of the JAX registry not ported yet, by ROADMAP Queue 1 item
# ----------------------------------------------------------------------
WAITING = {
    "Vision remainders": (
        "Deconvolution", "UpSampling", "BilinearSampler", "LRN", "lrn",
        "ROIPooling", "GridGenerator", "SpatialTransformer"),
}
_WAITING_ITEM = {name: item for item, names in WAITING.items()
                 for name in names}


def __getattr__(name):
    item = _WAITING_ITEM.get(name)
    if item is not None:
        raise NotImplementedError(
            f"mx.nd.{name} is not ported yet (ROADMAP Queue 1, '{item}')")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ----------------------------------------------------------------------
# eager wrappers (the JAX file's)
# ----------------------------------------------------------------------
def zeros_like(data, **kwargs):
    return _invoke(_get_op("zeros_like"), [data])


def ones_like(data, **kwargs):
    return _invoke(_get_op("ones_like"), [data])


def Dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False,
            **kwargs):
    """Dropout in train mode (``autograd.is_training()``) or with
    ``mode="always"``; the identity otherwise."""
    return _invoke(_get_op("Dropout"), [data],
                   {"p": p, "mode": mode, "axes": axes,
                    "_training": _autograd.is_training()})


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, **kwargs):
    """Training mode (and not ``use_global_stats``): normalize with the
    batch's statistics and update the moving ones in place
    (``m * moving + (1 - m) * batch``, the biased variance); predict
    mode: normalize with the moving statistics."""
    ax = int(axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    if _autograd.is_training() and not use_global_stats:
        mean = _invoke(_get_op("mean"), [data], {"axis": red})
        shape = [1 if i != ax else -1 for i in range(data.ndim)]
        diff = data - mean.reshape(shape)
        var = _invoke(_get_op("mean"), [diff * diff], {"axis": red})
        m = float(momentum)
        with _autograd.pause():
            for mov, new in ((moving_mean, mean), (moving_var, var)):
                mov.copy_(m * mov + (1 - m) * new.detach().to(mov.dtype))
    else:
        mean, var = moving_mean, moving_var
    out = _invoke(_get_op("BatchNorm"), [data, gamma, beta, mean, var],
                  {"eps": eps, "momentum": momentum, "fix_gamma": fix_gamma,
                   "axis": axis})
    if output_mean_var:
        return out, mean, var
    return out


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke(_get_op("concat"), list(arrays), {"dim": axis})


def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    return _invoke(_get_op("split"), [data],
                   {"num_outputs": num_outputs, "axis": axis,
                    "squeeze_axis": squeeze_axis})


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    return _invoke(_get_op("split_v2"), [data],
                   {"indices_or_sections": indices_or_sections,
                    "axis": axis, "squeeze_axis": squeeze_axis})


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    return _invoke(_get_op("topk"), [data],
                   {"axis": axis, "k": k, "ret_typ": ret_typ,
                    "is_ascend": is_ascend, "dtype": dtype})


def moveaxis(data, source, destination):
    import torch
    return torch.movedim(data, source, destination)


def _listed(data):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        return list(data[0])
    return list(data)


def stack(*data, axis=0):
    return _invoke(_get_op("stack"), _listed(data), {"axis": axis})


def concat(*data, dim=1):
    return _invoke(_get_op("concat"), _listed(data), {"dim": dim})


def add_n(*data):
    return _invoke(_get_op("add_n"), _listed(data))


ElementWiseSum = add_n

from . import contrib, linalg, random, sparse  # noqa: E402
