"""The neural-network ops of the port's models, as plain functions on
tensors.

Port of the parts of ``mxnet_tpu/ndarray/op_impl_nn.py`` (and ``pick``
of ``op_impl_basic.py``) the BERT forward, its MLM loss, the Gluon
losses and the vision models reach: the activations (erf GELU, tanh
for the pooler, relu), the embedding gather, LayerNorm, fused flash
attention, the attention mask helpers of the composed (additive-mask)
path, ``log_softmax``, ``pick`` and ``softmax_cross_entropy``; and
``convolution``, ``pooling``, ``batch_norm_train`` and ``batch_norm``,
which the JAX package leaves to XLA and the port to cuDNN and torch's
own kernels (no hand-written kernel: the reference wrote none).
Flash attention, last-axis LayerNorm and ``softmax_cross_entropy`` go
to the hand-written CUDA kernels for CUDA tensors
(``ops.flash_attention``, ``ops.layer_norm``, ``ops.softmax_xent``;
each differentiable through its backward kernel) and to their plain
versions for CPU tensors; the rest is plain PyTorch, as the JAX
package leaves it to XLA.

Each fused op decides from device, shape and type alone, before any
launch, whether its kernel takes the call, as the JAX ops ask
``pallas_ok_for`` and the kernel's types: attention takes it for 4-D
float32/bfloat16/float16, LayerNorm for the last axis in those types
without ``output_mean_var``. What the JAX op computes with composed
math on its accelerator (float64, ``output_mean_var``, another axis)
takes the same math here on either device. Every other call goes to
the kernel, at any head dim: on the card the kernels launch, on the
CPU their plain versions run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import flash_attention as _fa
from ..ops import layer_norm as _ln
from ..ops.softmax_xent import softmax_xent_fused

__all__ = ["activation", "attention_length_mask", "attention_segment_mask",
           "attention_zero_empty_rows", "attention_zero_pad_rows",
           "batch_dot_attention_apply", "batch_dot_attention_scores",
           "batch_norm", "batch_norm_train", "causal_mask_scores",
           "convolution", "embedding", "flash_attention_op", "layer_norm",
           "log_softmax", "pick", "pooling", "relu", "segment_valid_len",
           "softmax_cross_entropy"]

_NEG = -1e30

_ACT = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="none"),   # erf, not tanh
}


def activation(data, act_type="relu"):
    """``Activation`` op: ``relu``, ``tanh`` (BERT's pooler) or
    ``gelu`` (the exact erf form, BERT's FFN)."""
    try:
        fn = _ACT[act_type]
    except KeyError:
        raise ValueError(f"unknown act_type {act_type!r}") from None
    return fn(data)


def relu(data):
    """``relu`` op."""
    return F.relu(data)


def embedding(data, weight):
    """Rows of ``weight`` at the ids in ``data``. Out-of-range ids clip
    to the table, as the JAX package's take does (an unchecked
    out-of-range gather would fault the card)."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


# -- composed attention (the additive-mask path) ----------------------------
def batch_dot_attention_scores(query, key):
    """(B,H,Sq,D),(B,H,Sk,D) -> (B,H,Sq,Sk) scores (unscaled)."""
    return torch.einsum("bhqd,bhkd->bhqk", query, key)


def batch_dot_attention_apply(probs, value):
    """(B,H,Sq,Sk),(B,H,Sk,D) -> (B,H,Sq,D)."""
    return torch.einsum("bhqk,bhkd->bhqd", probs, value)


def attention_length_mask(scores, valid_len):
    """Score columns at/after each example's valid length to -1e30."""
    sk = scores.shape[-1]
    m = torch.arange(sk, device=scores.device)[None, None, None, :] \
        < valid_len.to(torch.int64).reshape(-1)[:, None, None, None]
    return torch.where(m, scores, torch.full((), _NEG, dtype=scores.dtype,
                                             device=scores.device))


def attention_zero_empty_rows(probs, valid_len):
    """Zero the probs of examples with ``valid_len == 0`` (their
    all-masked rows softmax to uniform; the kernel gives zeros)."""
    ok = valid_len.reshape(-1) > 0
    return probs * ok[:, None, None, None].to(probs.dtype)


def attention_segment_mask(scores, segment_ids):
    """Cross-segment score pairs to -1e30 (packed rows, Sq == Sk)."""
    seg = segment_ids.to(torch.int64)
    m = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.where(m, scores, torch.full((), _NEG, dtype=scores.dtype,
                                             device=scores.device))


def attention_zero_pad_rows(probs, segment_ids):
    """Zero the probs of packed padding query rows (segment id 0)."""
    ok = segment_ids > 0
    return probs * ok[:, None, :, None].to(probs.dtype)


def segment_valid_len(segment_ids):
    """(B,) int32 count of non-padding slots per packed row: the used
    length, since packers lay segments contiguously from slot 0."""
    return (segment_ids > 0).sum(dim=-1, dtype=torch.int32)


def causal_mask_scores(scores):
    """End-aligned causal mask over the last two axes of (...,Sq,Sk)."""
    sq, sk = scores.shape[-2], scores.shape[-1]
    cm = torch.ones((sq, sk), dtype=torch.bool,
                    device=scores.device).tril(sk - sq)
    return torch.where(cm, scores, torch.full((), _NEG, dtype=scores.dtype,
                                              device=scores.device))


# -- fused ops ---------------------------------------------------------------
def flash_attention_op(query, key, value, valid_len=None, segment_ids=None,
                       causal=False, sm_scale=None):
    """softmax(Q K^T * scale) V over (B, H, S, D) inputs, with the
    per-example key lengths ``valid_len`` (B,) and the packed
    ``segment_ids`` (B, S) masked. A causal mask is end-aligned: q row 0
    sits at key position ``Skv - Sq``. The kernel takes what
    ``ops.flash_attention.kernel_takes``; anything else (float64)
    takes the JAX op's composed softmax:
    float32 scores scaled after the product, rows with no visible key
    exact zeros, the result in the query's type."""
    if valid_len is not None:
        valid_len = valid_len.to(torch.int32).reshape(-1).contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    q_off = key.shape[2] - query.shape[2] if causal else 0
    if _fa.kernel_takes(query):
        return _fa.flash_attention(query, key, value, sm_scale, bool(causal),
                                   q_off, valid_len, segment_ids)
    scale = sm_scale if sm_scale is not None \
        else 1.0 / (query.shape[-1] ** 0.5)
    s = batch_dot_attention_scores(query.float(), key.float()) * scale
    mask = _fa.visible_mask(s.shape[-2], s.shape[-1], s.device, valid_len,
                            segment_ids, causal, q_off)
    p = torch.softmax(s if mask is None else
                      torch.where(mask, s, torch.full((), _NEG,
                                                      device=s.device)),
                      dim=-1)
    if mask is not None:
        p = torch.where(mask.expand(s.shape).any(-1, keepdim=True), p,
                        torch.zeros((), device=s.device))
    return batch_dot_attention_apply(p, value.float()).to(query.dtype)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """LayerNorm over ``axis``. A last-axis call the kernel takes
    (``ops.layer_norm.kernel_takes``) without ``output_mean_var`` goes
    to the fused kernel; any other takes the JAX op's mean and
    variance. With ``output_mean_var`` returns ``(out, mean, var)``,
    the axis squeezed from the statistics."""
    ax = int(axis) % data.ndim
    if not output_mean_var and ax == data.ndim - 1 \
            and _ln.kernel_takes(data):
        return _ln.layer_norm_fused(data.contiguous(), gamma, beta,
                                    float(eps))
    mean = data.mean(dim=ax, keepdim=True)
    xc = data - mean
    var = (xc * xc).mean(dim=ax, keepdim=True)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    out = xc * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


# -- losses ------------------------------------------------------------------
def log_softmax(data, axis=-1, temperature=None):
    """``log_softmax`` op (``temperature`` divides the input first)."""
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=int(axis))


def pick(data, index, axis=-1, keepdims=False):
    """``pick`` op: the entries of ``data`` at ``index`` along ``axis``;
    out-of-range indices clip, as MXNet's default ``mode="clip"``."""
    ax = int(axis) % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


def softmax_cross_entropy(data, label):
    """``softmax_cross_entropy`` op: the SUM over rows of
    ``-log softmax(data)[label]`` for (N, V) ``data`` and (N,) labels of
    any numeric type (cast to int32 first, as both JAX paths do), shape
    (1,) in the data's type. The per-row losses come from the fused
    kernel (``ops.softmax_xent``: K4a forward, K4b backward); float64
    data takes the plain log-softmax and pick, as the JAX op does off
    its kernel's types."""
    label = label.to(torch.int32)
    if data.dtype in (torch.float32, torch.bfloat16, torch.float16):
        loss = softmax_xent_fused(data, label)
        return loss.sum().reshape(1).to(data.dtype)
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, 1, label.to(torch.int64)[:, None])
    return -picked.sum().reshape(1)


# -- convolution, pooling, BatchNorm -----------------------------------------
def _tup(v, n):
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return None
    t = tuple(int(x) for x in (v if isinstance(v, (tuple, list)) else (v,)))
    return t * n if len(t) == 1 else t


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False):
    """``Convolution`` op over (N, C, *spatial) data and an (O, C /
    num_group, *kernel) weight, 1-, 2- or 3-D, symmetric zero ``pad``,
    in the data's type (cuDNN on the card)."""
    nd_ = weight.ndim - 2 if kernel is None else len(_tup(kernel, 1))
    out = _CONV[nd_](data, weight,
                     None if no_bias else bias,
                     stride=_tup(stride, nd_) or 1,
                     padding=_tup(pad, nd_) or 0,
                     dilation=_tup(dilate, nd_) or 1,
                     groups=int(num_group))
    return out


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool(x, k, s, divisor=None):
    """Unpadded sum (``divisor=1``) or mean pooling; 1-D as 2-D."""
    if len(k) == 1:
        out = _avg_pool(x.unsqueeze(-2), (1,) + k, (1,) + s, divisor)
        return out.squeeze(-2)
    return _AVG_POOL[len(k)](x, k, s, 0, ceil_mode=False,
                             count_include_pad=True,
                             divisor_override=divisor)


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True):
    """``Pooling`` op: ``max``, ``avg`` or ``sum`` windows over the
    spatial axes of (N, C, *spatial) data, or over all of them with
    ``global_pool`` (kept as size-1 axes). ``"valid"`` pads ``pad`` on
    both edges; ``"full"`` (ceil mode) pads the high edge up to
    ``(out - 1) * stride + kernel - in - pad``, as the JAX op does, so
    a last window that starts in the padding is kept and an average
    with ``count_include_pad`` divides by the whole kernel there too
    (torch's ``ceil_mode`` does neither). Padding counts as -inf for
    max and 0 for sums; ``count_include_pad=False`` divides by the
    window's unpadded elements."""
    nd_ = data.ndim - 2
    if global_pool:
        ax = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=ax, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=ax, keepdim=True)
        return data.mean(dim=ax, keepdim=True)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    k = _tup(kernel, nd_)
    s = _tup(stride, nd_) or (1,) * nd_
    p = _tup(pad, nd_) or (0,) * nd_
    if pooling_convention == "full":
        pads = []
        for i in range(nd_):
            size = data.shape[2 + i]
            out = int(math.ceil((size + 2 * p[i] - k[i]) / s[i])) + 1
            need = (out - 1) * s[i] + k[i] - size - p[i]
            pads.append((p[i], max(need, p[i])))
    elif pooling_convention == "valid":
        pads = [(q, q) for q in p]
    else:
        raise ValueError(f"unknown pooling_convention "
                         f"{pooling_convention!r}")
    native = pooling_convention == "valid" \
        and all(2 * q <= kk for q, kk in zip(p, k))
    if pool_type == "max":
        if native:      # torch pads with -inf itself
            return _MAX_POOL[nd_](data, k, s, p)
        fill = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        x = F.pad(data, [e for lo_hi in reversed(pads) for e in lo_hi],
                  value=fill)
        return _MAX_POOL[nd_](x, k, s, 0)
    x = F.pad(data, [e for lo_hi in reversed(pads) for e in lo_hi]) \
        if any(any(lo_hi) for lo_hi in pads) else data
    if pool_type == "sum":
        return _avg_pool(x, k, s, divisor=1)
    if count_include_pad:
        return _avg_pool(x, k, s)
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    ones = F.pad(ones, [e for lo_hi in reversed(pads) for e in lo_hi])
    return _avg_pool(x, k, s, divisor=1) / _avg_pool(ones, k, s, divisor=1)


def _bn_shape(ndim, ax):
    shp = [1] * ndim
    shp[ax] = -1
    return shp


def _bn_acc(dtype):
    """BatchNorm's compute type: float32 for float32 and narrower data
    (the JAX op's), float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX op's math (its custom VJP,
    ``op_impl_nn.py:556-630``): a one-pass sum and sum of squares over
    ``x - shift`` in float32 (float64 data: float64), the biased
    variance ``s2/n - mean**2``, and a two-pass backward; the mean's and
    variance's cotangents fold into the same per-channel form."""

    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps, ax, fix_gamma):
        red = tuple(i for i in range(x.ndim) if i != ax)
        n = float(math.prod(x.shape[i] for i in red))
        shp = _bn_shape(x.ndim, ax)
        # the one-pass variance cancels when |mean| >> std; a shift by
        # an estimate of the mean (the running mean) keeps it centred
        acc = _bn_acc(x.dtype)
        xf = x.to(acc) - shift.to(acc).reshape(shp)
        s1 = xf.sum(red)
        s2 = (xf * xf).sum(red)
        mean_c = s1 / n
        var = torch.clamp(s2 / n - mean_c * mean_c, min=0.0)
        mean = mean_c + shift.to(acc)
        ivar = torch.rsqrt(var + eps)
        g32 = torch.ones_like(mean) if fix_gamma else gamma.to(acc)
        scale = g32 * ivar
        off = beta.to(acc) - mean_c * scale
        out = torch.addcmul(off.reshape(shp), xf, scale.reshape(shp))
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps, ctx.ax, ctx.fix_gamma = eps, ax, fix_gamma
        ctx.beta_dtype = beta.dtype
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        x, gamma, mean, var = ctx.saved_tensors
        ax = ctx.ax
        red = tuple(i for i in range(x.ndim) if i != ax)
        n = float(math.prod(x.shape[i] for i in red))
        shp = _bn_shape(x.ndim, ax)
        acc = mean.dtype
        ivar = torch.rsqrt(var + ctx.eps)
        g32 = torch.ones_like(mean) if ctx.fix_gamma else gamma.to(acc)
        dof = dout.to(acc)
        xc = x.to(acc) - mean.reshape(shp)
        dbeta = dof.sum(red)
        t = (dof * xc).sum(red)
        a = g32 * ivar
        c = -a * ivar * ivar * t / n
        b = -a * dbeta / n
        if dvar is not None:
            c = c + 2.0 * dvar.to(acc) / n
        if dmean is not None:
            b = b + dmean.to(acc) / n
        dx = torch.addcmul(b.reshape(shp), a.reshape(shp), dof)
        dx = dx.addcmul_(c.reshape(shp), xc).to(x.dtype)
        dgamma = torch.zeros_like(gamma) if ctx.fix_gamma \
            else (t * ivar).to(gamma.dtype)
        return dx, dgamma, dbeta.to(ctx.beta_dtype), None, None, None, None


def batch_norm_train(data, gamma, beta, shift=None, eps=1e-5, axis=1,
                     fix_gamma=False):
    """Training-mode BatchNorm: ``(out, batch_mean, batch_var)``, the
    statistics float32 (float64 for float64 data) and the variance
    biased (the JAX op's; the
    running-statistics update stays in the Gluon layer). ``shift`` is a
    per-channel estimate of the mean (the running mean) that re-centres
    the one-pass variance; the result is the same math whatever it is.
    ``fix_gamma`` treats gamma as ones and gives it a zero gradient.
    Differentiable in ``data``, ``gamma`` and ``beta``."""
    ax = int(axis) % data.ndim
    if shift is None:
        shift = torch.zeros(data.shape[ax], dtype=torch.float32,
                            device=data.device)
    return _BatchNormTrain.apply(data, gamma, beta, shift.detach(),
                                 float(eps), ax, bool(fix_gamma))


def batch_norm(data, gamma, beta, mean, var, eps=1e-5, fix_gamma=True,
               axis=1):
    """BatchNorm with the given statistics (predict mode): normalised
    in float32 (float64 for float64 data) whatever the data's type
    (bf16 data with f32 statistics, as the JAX op), given back in the
    data's type."""
    ax = int(axis) % data.ndim
    shp = _bn_shape(data.ndim, ax)
    acc = _bn_acc(data.dtype)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    x_hat = (data.to(acc) - mean.to(acc).reshape(shp)) \
        * torch.rsqrt(var.to(acc).reshape(shp) + eps)
    out = x_hat * g.to(acc).reshape(shp) + beta.to(acc).reshape(shp)
    return out.to(data.dtype)
