"""Optimizer update ops, in place.

Port of ``mxnet_tpu/ndarray/op_impl_optimizer.py``: every update op of
the JAX registry. The math is the JAX package's, written as plain torch
under ``no_grad``; where the JAX ops return new arrays (written back
through ``out=``), the functions here update the weight and the state
tensors IN PLACE (no second copy of the model per step) and return the
weight. The JAX package leaves these to XLA, so the port owes no hand
kernel for them.

The registry (``mx.nd.sgd_update``, ...) holds every one under the JAX
op's signature and results (the end of this file): the result is new
arrays, and the states are written back into their inputs through the
``mutates`` pairs.

MXNet's conventions, kept here: the gradient is first scaled by
``rescale_grad`` and clipped to ``[-clip_gradient, clip_gradient]``
when that is positive; Adam adds ``wd * weight`` to the GRADIENT and
keeps epsilon outside the (uncorrected) square root, its bias
correction folded into ``lr`` by the optimizer; AdamW adds
``wd * weight`` to the UPDATE instead. The ``mp_*`` ops keep a float32
master copy of a float16/bfloat16 weight: the update runs on the
master and the weight gets its rounding. LAMB's phase 2 takes the two
norms as device tensors (nothing is read back).
"""
from __future__ import annotations

import torch

from .register import register_op

__all__ = ["adadelta_update", "adagrad_update", "adam_update",
           "adamw_update", "ftrl_update", "lamb_update_phase1",
           "lamb_update_phase2", "mp_sgd_mom_update", "mp_sgd_update",
           "multi_mp_sgd_mom_update", "multi_mp_sgd_update",
           "multi_sgd_mom_update", "multi_sgd_update", "nag_mom_update",
           "rmsprop_update", "rmspropalex_update", "sgd_mom_update",
           "sgd_update", "signsgd_update", "signum_update"]


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


@torch.no_grad()
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad: ``history += g * g``; ``weight -= lr * (g /
    sqrt(history + epsilon) + wd * weight)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    history.add_(g * g)
    weight.sub_(lr * (g / torch.sqrt(history + epsilon) + wd * weight))
    return weight


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov: ``g = rescale(grad) + wd * weight``; ``mom = momentum
    * mom + g``; ``weight -= lr * (g + momentum * mom)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    mom.copy_(momentum * mom + g)
    weight.sub_(lr * (g + momentum * mom))
    return weight


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """``sgd_update`` on the float32 master ``weight32``; the weight
    takes its rounding."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    weight32.sub_(lr * (g + wd * weight32))
    weight.copy_(weight32)
    return weight


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``sgd_mom_update`` on the float32 master and momentum."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """RMSProp (Tieleman and Hinton): ``n = gamma1 * n + (1 - gamma1) *
    g * g``; ``weight -= lr * g / sqrt(n + epsilon)``, then clipped to
    ``clip_weights`` when that is positive."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    n.copy_(gamma1 * n + (1.0 - gamma1) * g * g)
    weight.sub_(lr * g / torch.sqrt(n + epsilon))
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)
    return weight


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves): the mean square ``n`` and the mean
    ``g`` of the gradient, ``delta = gamma2 * delta - lr * gr /
    sqrt(n - g * g + epsilon)``, ``weight += delta``."""
    gr = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    n.copy_(gamma1 * n + (1.0 - gamma1) * gr * gr)
    g.copy_(gamma1 * g + (1.0 - gamma1) * gr)
    delta.copy_(gamma2 * delta
                - lr * gr / torch.sqrt(n - g * g + epsilon))
    weight.add_(delta)
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)
    return weight


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal: ``z`` and ``n`` accumulate; the weight is 0 where
    ``|z| <= lamda1`` and ``-(z - sign(z) * lamda1) / ((beta +
    sqrt(n)) / lr + wd)`` elsewhere."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z.add_(g - sigma * weight)
    n.copy_(new_n)
    w = -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd)
    weight.copy_(torch.where(z.abs() <= lamda1, torch.zeros_like(w), w))
    return weight


@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """``weight -= lr * (sign(g) + wd * weight)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * weight))
    return weight


@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """``mom = momentum * mom - (1 - momentum) * (g + wd * weight)``;
    ``weight += lr * sign(mom)``, less ``lr * wd_lh * weight`` (the
    decoupled decay, on the weight before the step)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    mom.copy_(momentum * mom - (1.0 - momentum) * g)
    w = weight + lr * torch.sign(mom)
    if wd_lh:
        w = w - lr * wd_lh * weight
    weight.copy_(w)
    return weight


@torch.no_grad()
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaDelta: ``acc_g`` of g * g, the step ``sqrt(acc_delta + eps) /
    sqrt(acc_g + eps) * g``, ``acc_delta`` of its square."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    acc_g.copy_(rho * acc_g + (1.0 - rho) * g * g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) * g
    acc_delta.copy_(rho * acc_delta + (1.0 - rho) * delta * delta)
    weight.sub_(delta)
    return weight


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's first phase: the moments, updated in place, and the
    direction ``m / (sqrt(v) + epsilon) + wd * weight`` (returned; the
    weight is not touched)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1.0 - beta1) * g)
    var.copy_(beta2 * var + (1.0 - beta2) * g * g)
    m = mean / (1.0 - beta1 ** t) if bias_correction else mean
    v = var / (1.0 - beta2 ** t) if bias_correction else var
    return m / (torch.sqrt(v) + epsilon) + wd * weight


@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's second phase: ``weight -= lr * ratio * g`` with the trust
    ratio ``r1 / r2`` (1 where either norm is 0), bounded when the
    bounds are positive; the norms stay on the device."""
    ones = torch.ones_like(r1)
    r1v = torch.where(r1 > 0, r1, ones)
    r2v = torch.where(r2 > 0, r2, ones)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1v / r2v, ones)
    if lower_bound is not None and lower_bound > 0:
        ratio = torch.clamp(ratio, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        ratio = torch.clamp(ratio, max=upper_bound)
    weight.sub_(lr * ratio * g)
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


@torch.no_grad()
def multi_mp_sgd_update(weights, grads, weights32, lrs=(), wds=(),
                        rescale_grad=1.0, clip_gradient=-1.0):
    """``mp_sgd_update`` over many weights at once; returns the
    weights."""
    for i, (w, g, w32) in enumerate(zip(weights, grads, weights32)):
        mp_sgd_update(w, g, w32, _per_weight(lrs, i, 0.01),
                      _per_weight(wds, i, 0.0), rescale_grad, clip_gradient)
    return list(weights)


@torch.no_grad()
def multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs=(), wds=(),
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0):
    """``mp_sgd_mom_update`` over many weights at once; returns the
    weights."""
    for i, (w, g, m, w32) in enumerate(zip(weights, grads, moms,
                                           weights32)):
        mp_sgd_mom_update(w, g, m, w32, _per_weight(lrs, i, 0.01), momentum,
                          _per_weight(wds, i, 0.0), rescale_grad,
                          clip_gradient)
    return list(weights)


# -- the registered ops: the JAX ops' signatures and results ----------------
# These return new arrays, as the JAX ops do: the weight comes back as
# the result (``out=weight`` writes it in place) and the states are
# written back into their inputs through the ``mutates`` pairs.
def _copies(*tensors):
    return [t.detach().clone() for t in tensors]


@register_op("sgd_update", differentiable=False)
def _sgd_update_op(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    (w,) = _copies(weight)
    return sgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)


@register_op("sgd_mom_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _sgd_mom_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    w, m = _copies(weight, mom)
    sgd_mom_update(w, grad, m, lr, momentum, wd, rescale_grad,
                   clip_gradient)
    return w, m


@register_op("adam_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2), (2, 3)))
def _adam_update_op(weight, grad, mean, var, lr=0.001, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=True):
    w, m, v = _copies(weight, mean, var)
    adam_update(w, grad, m, v, lr, beta1, beta2, epsilon, wd, rescale_grad,
                clip_gradient)
    return w, m, v


@register_op("adamw_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2), (2, 3)))
def _adamw_update_op(weight, grad, mean, var, lr=0.001, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                     rescale_grad=1.0, clip_gradient=-1.0):
    w, m, v = _copies(weight, mean, var)
    adamw_update(w, grad, m, v, lr, beta1, beta2, epsilon, wd, eta,
                 rescale_grad, clip_gradient)
    return w, m, v


@register_op("adagrad_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _adagrad_update_op(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    w, h = _copies(weight, history)
    adagrad_update(w, grad, h, lr, epsilon, wd, rescale_grad, clip_gradient)
    return w, h


@register_op("multi_sgd_update", differentiable=False)
def _multi_sgd_update_op(*args, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=None):
    """args = (w0, g0, w1, g1, ...); the updated weights."""
    n = int(num_weights) if num_weights is not None else len(args) // 2
    ws = _copies(*args[0:2 * n:2])
    return tuple(multi_sgd_update(ws, args[1:2 * n:2], lrs, wds,
                                  rescale_grad, clip_gradient))


@register_op("multi_sgd_mom_update", differentiable=False)
def _multi_sgd_mom_update_op(*args, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=None):
    """args = (w0, g0, m0, w1, g1, m1, ...); (w0', m0', w1', m1', ...)."""
    n = int(num_weights) if num_weights is not None else len(args) // 3
    ws = _copies(*args[0:3 * n:3])
    ms = _copies(*args[2:3 * n:3])
    multi_sgd_mom_update(ws, args[1:3 * n:3], ms, lrs, wds, momentum,
                         rescale_grad, clip_gradient)
    return tuple(t for pair in zip(ws, ms) for t in pair)


@register_op("nag_mom_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _nag_mom_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    w, m = _copies(weight, mom)
    nag_mom_update(w, grad, m, lr, momentum, wd, rescale_grad,
                   clip_gradient)
    return w, m


@register_op("mp_sgd_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _mp_sgd_update_op(weight, grad, weight32, lr=0.01, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    w, w32 = _copies(weight, weight32)
    mp_sgd_update(w, grad, w32, lr, wd, rescale_grad, clip_gradient)
    return w, w32


@register_op("mp_sgd_mom_update", differentiable=False,
             num_visible_outputs=1, mutates=((1, 2), (2, 3)))
def _mp_sgd_mom_update_op(weight, grad, mom, weight32, lr=0.01,
                          momentum=0.0, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, lazy_update=True):
    w, m, w32 = _copies(weight, mom, weight32)
    mp_sgd_mom_update(w, grad, m, w32, lr, momentum, wd, rescale_grad,
                      clip_gradient)
    return w, m, w32


@register_op("rmsprop_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _rmsprop_update_op(weight, grad, n, lr=0.001, gamma1=0.95,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    w, nn = _copies(weight, n)
    rmsprop_update(w, grad, nn, lr, gamma1, epsilon, wd, rescale_grad,
                   clip_gradient, clip_weights)
    return w, nn


@register_op("rmspropalex_update", differentiable=False,
             num_visible_outputs=1, mutates=((1, 2), (2, 3), (3, 4)))
def _rmspropalex_update_op(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                           gamma2=0.9, epsilon=1e-8, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           clip_weights=-1.0):
    w, nn, gg, dd = _copies(weight, n, g, delta)
    rmspropalex_update(w, grad, nn, gg, dd, lr, gamma1, gamma2, epsilon, wd,
                       rescale_grad, clip_gradient, clip_weights)
    return w, nn, gg, dd


@register_op("ftrl_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2), (2, 3)))
def _ftrl_update_op(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    w, zz, nn = _copies(weight, z, n)
    ftrl_update(w, grad, zz, nn, lr, lamda1, beta, wd, rescale_grad,
                clip_gradient)
    return w, zz, nn


@register_op("signsgd_update", differentiable=False)
def _signsgd_update_op(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    (w,) = _copies(weight)
    return signsgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)


@register_op("signum_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2),))
def _signum_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    w, m = _copies(weight, mom)
    signum_update(w, grad, m, lr, momentum, wd, rescale_grad, clip_gradient,
                  wd_lh)
    return w, m


@register_op("adadelta_update", differentiable=False, num_visible_outputs=1,
             mutates=((1, 2), (2, 3)))
def _adadelta_update_op(weight, grad, acc_g, acc_delta, rho=0.9,
                        epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0):
    w, ag, ad = _copies(weight, acc_g, acc_delta)
    adadelta_update(w, grad, ag, ad, rho, epsilon, wd, rescale_grad,
                    clip_gradient)
    return w, ag, ad


@register_op("lamb_update_phase1", differentiable=False,
             num_visible_outputs=1, mutates=((1, 2), (2, 3)))
def _lamb_update_phase1_op(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                           epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0):
    m, v = _copies(mean, var)
    g = lamb_update_phase1(weight, grad, m, v, beta1, beta2, epsilon, t,
                           bias_correction, wd, rescale_grad, clip_gradient)
    return g, m, v


@register_op("lamb_update_phase2", differentiable=False)
def _lamb_update_phase2_op(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                           upper_bound=-1.0):
    (w,) = _copies(weight)
    return lamb_update_phase2(w, g, r1, r2, lr, lower_bound, upper_bound)


@register_op("multi_mp_sgd_update", differentiable=False)
def _multi_mp_sgd_update_op(*args, lrs=(), wds=(), rescale_grad=1.0,
                            clip_gradient=-1.0, num_weights=None):
    """args = (w0, g0, w32_0, ...); (w0', w32_0', ...)."""
    n = int(num_weights) if num_weights is not None else len(args) // 3
    ws = _copies(*args[0:3 * n:3])
    w32s = _copies(*args[2:3 * n:3])
    multi_mp_sgd_update(ws, args[1:3 * n:3], w32s, lrs, wds, rescale_grad,
                        clip_gradient)
    return tuple(t for pair in zip(ws, w32s) for t in pair)


@register_op("multi_mp_sgd_mom_update", differentiable=False)
def _multi_mp_sgd_mom_update_op(*args, lrs=(), wds=(), momentum=0.0,
                                rescale_grad=1.0, clip_gradient=-1.0,
                                num_weights=None):
    """args = (w0, g0, m0, w32_0, ...); (w0', m0', w32_0', ...)."""
    n = int(num_weights) if num_weights is not None else len(args) // 4
    ws = _copies(*args[0:4 * n:4])
    ms = _copies(*args[2:4 * n:4])
    w32s = _copies(*args[3:4 * n:4])
    multi_mp_sgd_mom_update(ws, args[1:4 * n:4], ms, w32s, lrs, wds,
                            momentum, rescale_grad, clip_gradient)
    return tuple(t for trio in zip(ws, ms, w32s) for t in trio)
