"""Model checkpoint helpers (port of ``mxnet_tpu/model.py``, MXNet's
``python/mxnet/model.py``): :func:`save_checkpoint`/:func:`load_checkpoint`
(``prefix-symbol.json`` and ``prefix-%04d.params``, the arrays under
``arg:``/``aux:`` names in one ``.params`` file), and the
:class:`BatchEndParam` every batch callback receives."""
from __future__ import annotations

from collections import namedtuple

from .base import MXNetError

__all__ = ["BatchEndParam", "load_checkpoint", "load_params",
           "save_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    from . import ndarray as nd
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch):
    from . import ndarray as nd
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    if isinstance(save_dict, list):
        raise MXNetError("params file has no names; cannot split arg/aux")
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    from . import symbol as sym
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
