"""Automatic mixed precision: MXNet 1.x's ``mx.contrib.amp``.

Port of ``mxnet_tpu/contrib/amp/amp.py``. MXNet rewrites the graph,
inserting ``amp_cast``/``amp_multicast`` around the ops of its lists;
here :func:`init` installs a cast hook on op dispatch
(``ndarray.register.set_dispatch_cast_hook``) that casts each op's
tensor inputs by its name: the products of :data:`lists.TARGET_DTYPE_OPS`
to the half type, the ops of :data:`lists.FP32_OPS` to float32, and the
mixed inputs of :data:`lists.WIDEST_TYPE_CASTS` to the widest float
among them. The registry's ops, a symbol's walk and the built-in
layers' eager forwards (through ``register.amp_cast``) all pass it, and
the casts are ``Tensor.to`` calls on the autograd tape, so gradients
come back in each parameter's own type. ``torch.autocast`` is not
used: its op lists are torch's, and it does not see the port's
hand-written kernels.

The state is process-wide, as MXNet's: :func:`disable` removes the
hook (and bumps the generation that hybridized blocks and bound
executors key on, so their graphs captured under AMP are not served
after it).

:class:`LossScaler` scales dynamically for float16 only: bfloat16 has
float32's exponent range, so its scale stays 1 and no step scans for
overflow. For float16 the scan is one finite flag a gradient on the
device (``isfinite(g).all()``), the flags stacked, and one host read a
step (the JAX package reads each gradient back).
"""
from __future__ import annotations

import logging

import torch

from ...base import MXNetError
from . import lists

__all__ = ["LossScaler", "convert_model", "disable", "init", "init_trainer",
           "is_initialized", "scale_loss", "target_dtype", "unscale"]

_STATE = {"initialized": False, "target_dtype": "bfloat16",
          "target_ops": None, "fp32_ops": None, "widest_ops": None}

_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _is_float(a):
    return isinstance(a, torch.Tensor) and a.dtype in _FLOATS


def _cast_hook(name, arrays):
    """MXNet's amp_cast/amp_multicast, applied at dispatch. An
    ``Embedding``'s ids (its first input) index the table and keep their
    type: float ids past 256 would not survive bfloat16 (the JAX hook
    casts them with the table)."""
    if name in _STATE["target_ops"]:
        half = _HALF[_STATE["target_dtype"]]
        first = 1 if name == "Embedding" else 0
        return [a.to(half) if i >= first and _is_float(a) and a.dtype != half
                else a for i, a in enumerate(arrays)]
    if name in _STATE["fp32_ops"]:
        return [a.to(torch.float32)
                if _is_float(a) and a.dtype != torch.float32 else a
                for a in arrays]
    if name in _STATE["widest_ops"]:
        dts = [a.dtype for a in arrays if _is_float(a)]
        if len(set(dts)) > 1:
            widest = torch.float32 if torch.float32 in dts else max(
                dts, key=lambda d: torch.finfo(d).bits)
            return [a.to(widest) if _is_float(a) else a for a in arrays]
    return arrays


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on: install the dispatch cast hook. Extra op names
    extend the lists of :mod:`.lists`."""
    from ...ndarray.register import set_dispatch_cast_hook

    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("target_dtype must be bfloat16 or float16")
    _STATE["initialized"] = True
    _STATE["target_dtype"] = target_dtype
    _STATE["target_ops"] = set(lists.TARGET_DTYPE_OPS) \
        | set(target_precision_ops or ())
    _STATE["fp32_ops"] = set(lists.FP32_OPS) | set(fp32_ops or ()) \
        | set(conditional_fp32_ops or ())
    _STATE["widest_ops"] = set(lists.WIDEST_TYPE_CASTS)
    set_dispatch_cast_hook(_cast_hook)
    logging.info("AMP initialized (target %s)", target_dtype)


def disable():
    """Remove the cast hook."""
    from ...ndarray.register import set_dispatch_cast_hook

    _STATE["initialized"] = False
    set_dispatch_cast_hook(None)


def is_initialized():
    return _STATE["initialized"]


def target_dtype():
    return _STATE["target_dtype"]


class LossScaler:
    """Dynamic loss scaling, active for float16 only (module
    docstring): an overflowed step halves the scale (not below 1),
    ``scale_window`` clean steps in a row double it (up to 2**24)."""

    MAX_SCALE = 2.0 ** 24

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.active = _STATE["target_dtype"] == "float16"
        self._scale = init_scale if self.active else 1.0
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    @property
    def loss_scale(self):
        return self._scale

    def has_overflow(self, params):
        """Whether any gradient of ``params`` holds an inf or a NaN: one
        flag a gradient on its device, one read of their conjunction."""
        if not self.active:
            return False
        grads = [p._tensor.grad for p in params
                 if p.grad_req != "null" and p._tensor.grad is not None]
        if not grads:
            return False
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        return not bool(finite.all())

    def update_scale(self, skip):
        if skip:
            self._scale = max(self._scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self._scale = min(self._scale * self._factor,
                                  self.MAX_SCALE)
                self._unskipped = 0


def init_trainer(trainer):
    """Give a ``gluon.Trainer`` a loss scaler and wrap its ``step``: an
    overflowed step leaves every weight as it was, and the gradients
    are unscaled by the scale that was in effect during the backward
    before the scale is updated for the next one."""
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_scale = trainer._scale
    trainer._scale = trainer._scale / scaler.loss_scale
    orig_step = trainer.step

    def amp_step(batch_size, ignore_stale_grad=False):
        skip = scaler.has_overflow(trainer._params)
        trainer._scale = trainer._amp_original_scale / scaler.loss_scale
        scaler.update_scale(skip)
        if skip:
            logging.warning("AMP: gradient overflow, skipping update "
                            "(loss scale -> %g)", scaler.loss_scale)
            return None
        return orig_step(batch_size, ignore_stale_grad)

    trainer.step = amp_step
    return trainer


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``.
    At scale 1 (bfloat16, or a trainer without a scaler) the loss itself;
    else the loss times the scale, recorded even after ``record()``
    closed."""

    def __init__(self, loss, trainer):
        from ... import autograd

        scaler = getattr(trainer, "_amp_loss_scaler", None)
        s = scaler.loss_scale if scaler else 1.0
        if s == 1.0:
            self._scaled = loss
        else:
            with autograd.record(train_mode=autograd.is_training()):
                if isinstance(loss, (list, tuple)):
                    self._scaled = [l * s for l in loss]
                else:
                    self._scaled = loss * s

    def __enter__(self):
        return self._scaled

    def __exit__(self, *exc):
        return False


@torch.no_grad()
def unscale(trainer):
    """Divide the trainer's gradients by the loss scale in place (before
    clipping them, say)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req != "null" and p._tensor.grad is not None:
            for g in p.list_grad():
                g *= inv


def convert_model(block, target_dtype=None):
    """Cast a block's parameters to the half type (``BatchNorm`` keeps
    float32)."""
    block.cast(target_dtype or _STATE["target_dtype"])
    return block
