"""Optimizer update ops, in place.

Port of the updates of ``mxnet_tpu/ndarray/op_impl_optimizer.py`` that
the port's optimizers call: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``adamw_update`` and the multi-tensor
``multi_sgd_update`` / ``multi_sgd_mom_update``. The math is the JAX
package's, written as plain torch under ``no_grad``; where the JAX ops
return new arrays (written back through ``out=``), these update the
weight and the state tensors IN PLACE (no second copy of the model per
step) and return the weight. The JAX package leaves these to XLA, so
the port owes no hand kernel for them.

MXNet's conventions, kept here: the gradient is first scaled by
``rescale_grad`` and clipped to ``[-clip_gradient, clip_gradient]``
when that is positive; Adam adds ``wd * weight`` to the GRADIENT and
keeps epsilon outside the (uncorrected) square root, its bias
correction folded into ``lr`` by the optimizer; AdamW adds
``wd * weight`` to the UPDATE instead.
"""
from __future__ import annotations

import torch

__all__ = ["adam_update", "adamw_update", "multi_sgd_mom_update",
           "multi_sgd_update", "sgd_mom_update", "sgd_update"]


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``weight -= lr * (g + wd * weight)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (g + wd * weight))
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``mom = momentum * mom - lr * (g + wd * weight)``;
    ``weight += mom``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)
    return weight


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """MXNet's Adam step (``lr`` already bias-corrected by the
    optimizer): ``g = rescale(grad) + wd * weight``; the moments; then
    ``weight -= lr * mean / (sqrt(var) + epsilon)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    mean.copy_(beta1 * mean + (1.0 - beta1) * g)
    var.copy_(beta2 * var + (1.0 - beta2) * g * g)
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight


@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """AdamW: the moments of the rescaled gradient alone, and
    ``weight -= eta * lr * (mean / (sqrt(var) + epsilon) + wd *
    weight)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1.0 - beta1) * g)
    var.copy_(beta2 * var + (1.0 - beta2) * g * g)
    upd = mean / (torch.sqrt(var) + epsilon) + wd * weight
    weight.sub_(eta * lr * upd)
    return weight


def _per_weight(vals, i, default):
    if vals is None:
        return default
    if isinstance(vals, (tuple, list)):
        return float(vals[i]) if i < len(vals) else default
    return float(vals)              # one scalar for all weights


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0):
    """``sgd_update`` over many weights at once (per-weight ``lrs`` and
    ``wds``); returns the weights."""
    for i, (w, g) in enumerate(zip(weights, grads)):
        sgd_update(w, g, _per_weight(lrs, i, 0.01), _per_weight(wds, i, 0.0),
                   rescale_grad, clip_gradient)
    return list(weights)


@torch.no_grad()
def multi_sgd_mom_update(weights, grads, moms, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """``sgd_mom_update`` over many weights at once; returns the
    weights."""
    for i, (w, g, m) in enumerate(zip(weights, grads, moms)):
        sgd_mom_update(w, g, m, _per_weight(lrs, i, 0.01), momentum,
                       _per_weight(wds, i, 0.0), rescale_grad,
                       clip_gradient)
    return list(weights)
