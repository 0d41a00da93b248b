"""The neural-network ops, as plain functions on tensors, each
registered under the JAX op's name.

Port of ``mxnet_tpu/ndarray/op_impl_nn.py`` (and ``pick`` of
``op_impl_basic.py``): ``FullyConnected``, the activations
(``Activation``, ``LeakyReLU``, ``gelu``, ``swish``), the softmax family
(``softmax``, ``log_softmax``, ``softmin``, ``SoftmaxActivation``,
``SoftmaxOutput``), ``Embedding``, ``Dropout``, the normalizations
(``LayerNorm``, ``BatchNorm``/``BatchNormTrain``, ``InstanceNorm``,
``GroupNorm``), fused flash attention and the attention mask helpers of
the composed (additive-mask) path, ``softmax_cross_entropy`` and the
loss heads (``MakeLoss``, the ``*RegressionOutput`` ops), and
``Convolution`` and ``Pooling``, which the JAX package leaves to XLA
and the port to cuDNN and torch's own kernels (no hand-written kernel:
the reference wrote none). Flash attention, last-axis LayerNorm and
``softmax_cross_entropy`` go to the hand-written CUDA kernels for CUDA
tensors (``ops.flash_attention``, ``ops.layer_norm``,
``ops.softmax_xent``; each differentiable through its backward kernel)
and to their plain versions for CPU tensors; the rest is plain
PyTorch, as the JAX package leaves it to XLA. The port's layers call
these functions directly; ``mx.nd.<name>`` reaches the same ones
through the registry. The JAX file's vision ops (``Deconvolution``,
``UpSampling``, ``BilinearSampler``, ``LRN``, ``ROIPooling``,
``GridGenerator``, ``SpatialTransformer``) and ``ctc_loss`` are not
ported yet (``ndarray.WAITING``).

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
from .ndarray import to_dtype
from .op_impl_basic import take_rows
from .register import register_op

__all__ = ["activation", "attention_length_mask", "attention_segment_mask",
           "attention_zero_empty_rows", "attention_zero_pad_rows",
           "batch_dot_attention_apply", "batch_dot_attention_scores",
           "batch_norm", "batch_norm_op", "batch_norm_train",
           "causal_mask_scores", "convolution", "dropout", "embedding",
           "flash_attention_op", "fully_connected", "gelu", "group_norm",
           "instance_norm", "layer_norm", "leaky_relu",
           "linear_regression_output", "log_softmax",
           "logistic_regression_output", "mae_regression_output",
           "make_loss", "pick", "pooling", "segment_valid_len",
           "softmax", "softmax_activation", "softmax_cross_entropy",
           "softmax_output", "softmin", "swish"]

_NEG = -1e30

_ACT = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "log_sigmoid": F.logsigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "gelu": lambda x: F.gelu(x, approximate="none"),   # erf, not tanh
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


@register_op("Activation")
def activation(data, act_type="relu"):
    """``Activation`` op by name: ``relu``, ``tanh`` (BERT's pooler),
    ``gelu`` (the exact erf form, BERT's FFN), ``sigmoid``,
    ``softrelu``, ... (the JAX op's table)."""
    try:
        fn = _ACT[act_type]
    except KeyError:
        raise ValueError(f"unknown act_type {act_type!r}") from None
    return fn(data)


@register_op("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the ids in ``data``. Out-of-range ids clip
    to the table, as the JAX package's take does (an unchecked
    out-of-range gather would fault the card). The table's gradient is
    dense, as the JAX ``take``'s VJP gives it (``sparse_grad`` is
    recorded by the layer, not acted on), and sums the rows of each id
    in a fixed order (``op_impl_basic.segment_sum``: the same bits on
    every run and inside a CUDA graph)."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return take_rows(weight, idx)


# -- composed attention (the additive-mask path) ----------------------------
@register_op("batch_dot_attention_scores")
def batch_dot_attention_scores(query, key):
    """(B,H,Sq,D),(B,H,Sk,D) -> (B,H,Sq,Sk) scores (unscaled), in the
    inputs' promoted type."""
    dt = torch.promote_types(query.dtype, key.dtype)
    return torch.einsum("bhqd,bhkd->bhqk", query.to(dt), key.to(dt))


@register_op("batch_dot_attention_apply")
def batch_dot_attention_apply(probs, value):
    """(B,H,Sq,Sk),(B,H,Sk,D) -> (B,H,Sq,D), in the inputs' promoted
    type (float32 probabilities against half values under AMP)."""
    dt = torch.promote_types(probs.dtype, value.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), value.to(dt))


@register_op("attention_length_mask")
def attention_length_mask(scores, valid_len):
    """Score columns at/after each example's valid length to -1e30."""
    sk = scores.shape[-1]
    m = torch.arange(sk, device=scores.device)[None, None, None, :] \
        < valid_len.to(torch.int64).reshape(-1)[:, None, None, None]
    return torch.where(m, scores, torch.full((), _NEG, dtype=scores.dtype,
                                             device=scores.device))


@register_op("attention_zero_empty_rows")
def attention_zero_empty_rows(probs, valid_len):
    """Zero the probs of examples with ``valid_len == 0`` (their
    all-masked rows softmax to uniform; the kernel gives zeros)."""
    ok = valid_len.reshape(-1) > 0
    return probs * ok[:, None, None, None].to(probs.dtype)


@register_op("attention_segment_mask")
def attention_segment_mask(scores, segment_ids):
    """Cross-segment score pairs to -1e30 (packed rows, Sq == Sk)."""
    seg = segment_ids.to(torch.int64)
    m = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.where(m, scores, torch.full((), _NEG, dtype=scores.dtype,
                                             device=scores.device))


@register_op("attention_zero_pad_rows")
def attention_zero_pad_rows(probs, segment_ids):
    """Zero the probs of packed padding query rows (segment id 0)."""
    ok = segment_ids > 0
    return probs * ok[:, None, :, None].to(probs.dtype)


@register_op("segment_valid_len", differentiable=False)
def segment_valid_len(segment_ids):
    """(B,) int32 count of non-padding slots per packed row: the used
    length, since packers lay segments contiguously from slot 0."""
    return (segment_ids > 0).sum(dim=-1, dtype=torch.int32)


@register_op("causal_mask_scores")
def causal_mask_scores(scores):
    """End-aligned causal mask over the last two axes of (...,Sq,Sk)."""
    sq, sk = scores.shape[-2], scores.shape[-1]
    cm = torch.ones((sq, sk), dtype=torch.bool,
                    device=scores.device).tril(sk - sq)
    return torch.where(cm, scores, torch.full((), _NEG, dtype=scores.dtype,
                                              device=scores.device))


# -- fused ops ---------------------------------------------------------------
@register_op("flash_attention")
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


@register_op("LayerNorm")
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
@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None,
                use_length=False):
    """``log_softmax`` op (``temperature`` divides the input first;
    ``dtype`` casts the result)."""
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.log_softmax(x, dim=int(axis))
    return out if dtype is None else out.to(to_dtype(dtype))


@register_op("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``pick`` op: the entries of ``data`` at ``index`` along ``axis``;
    out-of-range indices clip, as MXNet's default ``mode="clip"``."""
    ax = int(axis) % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


@register_op("softmax_cross_entropy")
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


@register_op("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, workspace=1024, cudnn_tune=None,
                cudnn_off=False, layout=None):
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


@register_op("Pooling")
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True, cudnn_off=False, layout=None):
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


@register_op("BatchNormTrain", num_visible_outputs=3)
def batch_norm_train(data, gamma, beta, shift=None, eps=1e-5, axis=1,
                     fix_gamma=False, momentum=0.9):
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


@register_op("BatchNorm")
def batch_norm_op(data, gamma, beta, mean, var, eps=1e-5, momentum=0.9,
                  fix_gamma=True, use_global_stats=False,
                  output_mean_var=False, axis=1, cudnn_off=False):
    """The registered ``BatchNorm``: :func:`batch_norm` with the given
    statistics (``nd.BatchNorm`` picks and updates them)."""
    return batch_norm(data, gamma, beta, mean, var, eps=eps,
                      fix_gamma=fix_gamma, axis=axis)


# -- the rest of the JAX file's ops ------------------------------------------
@register_op("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``data @ weight^T + bias``; ``flatten`` first folds every axis
    after the first (torch.matmul: cuBLAS on the card)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.ndim > 2 \
        else data
    return F.linear(x, weight, None if no_bias else bias)


@register_op("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The LeakyReLU family: leaky, prelu, elu, selu, gelu (erf) and
    rrelu (its mean slope, as the JAX op)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, lam = 1.6732632423543772, 1.0507009873554805
        return lam * torch.where(data > 0, data, alpha * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, mid * data)
    raise ValueError(f"unknown act_type {act_type}")


@register_op("gelu")
def gelu(data, approximate=False):
    return F.gelu(data, approximate="tanh" if approximate else "none")


@register_op("swish")
def swish(data, beta=1.0):
    return data * torch.sigmoid(beta * data)


@register_op("softmax")
def softmax(data, axis=-1, temperature=None, length=None, dtype=None,
            use_length=False):
    """Softmax over ``axis``; ``length`` (the leading axes' shape) masks
    the positions at or past each length, which come out 0."""
    ax = int(axis)
    x = data if temperature in (None, 1.0) else data / temperature
    if length is not None:
        mshape = [1] * x.ndim
        mshape[ax] = x.shape[ax]
        steps = torch.arange(x.shape[ax], device=x.device).reshape(mshape)
        lens = length.reshape(tuple(length.shape)
                              + (1,) * (x.ndim - length.ndim))
        mask = steps < lens
        out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=ax)
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    out = torch.softmax(x, dim=ax)
    return out if dtype is None else out.to(to_dtype(dtype))


@register_op("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register_op("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """The legacy loss head: softmax forward, ``(p - onehot) *
    grad_scale`` backward whatever the head gradient (MXNet's
    ``softmax_output.cc``, the JAX op's custom VJP)."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        ax = 1 if cfg["multi_output"] else -1
        out = torch.softmax(data, dim=ax)
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, _g):
        out, lab = ctx.saved_tensors
        cfg = ctx.cfg
        ax = 1 if cfg["multi_output"] else -1
        n_class = out.shape[ax]
        if cfg["multi_output"] and \
                tuple(lab.shape) != out.shape[:1] + out.shape[2:]:
            lab = lab.reshape(out.shape[:1] + out.shape[2:])
        oh = F.one_hot(lab.to(torch.int64).clamp(0, n_class - 1), n_class) \
            .to(out.dtype)
        oh = oh * (lab.to(torch.int64) >= 0)[..., None].to(out.dtype)
        if cfg["multi_output"]:
            oh = oh.movedim(-1, 1)
        alpha = cfg["smooth_alpha"]
        if alpha:
            oh = oh * (1.0 - alpha) + alpha / (n_class - 1) * (1.0 - oh)
        grad = out - oh
        if cfg["use_ignore"]:
            keep = (lab != cfg["ignore_label"]).to(out.dtype)
            if keep.ndim < out.ndim:
                keep = keep.unsqueeze(ax)
            grad = grad * keep
        if cfg["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif cfg["normalization"] == "valid" and cfg["use_ignore"]:
            grad = grad / (lab != cfg["ignore_label"]).sum().clamp(min=1)
        return grad * cfg["grad_scale"], None, None


@register_op("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, preserve_shape=False,
                   multi_output=False, out_grad=False, normalization="null",
                   smooth_alpha=0.0):
    """Softmax forward, ``p - onehot(label)`` backward (module
    :class:`_SoftmaxOutput`)."""
    cfg = dict(grad_scale=grad_scale, ignore_label=ignore_label,
               use_ignore=use_ignore, multi_output=multi_output,
               normalization=normalization, smooth_alpha=smooth_alpha)
    return _SoftmaxOutput.apply(data, label, cfg)


@register_op("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    ax = tuple(range(2, data.ndim))
    mean = data.mean(dim=ax, keepdim=True)
    var = ((data - mean) ** 2).mean(dim=ax, keepdim=True)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register_op("GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[:2]
    g = int(num_groups)
    x = data.reshape((n, g, c // g) + tuple(data.shape[2:]))
    ax = tuple(range(2, x.ndim))
    mean = x.mean(dim=ax, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=ax, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register_op("Dropout")
def dropout(data, p=0.5, mode="training", axes=None, _training=True):
    """Inverted dropout when training (or ``mode="always"``), else the
    identity. ``axes`` get a mask of size one, broadcast along them.
    Draws from the device's generator (``mx.random``)."""
    if (not _training and mode != "always") or p <= 0.0:
        return data + 0
    if not axes:
        return F.dropout(data, p, training=True)
    shape = list(data.shape)
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        shape[int(a)] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device) \
        .bernoulli_(keep)
    return data * mask / keep


@register_op("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return data * 1.0


class _RegressionOutput(torch.autograd.Function):
    """Identity (sigmoid for ``logistic``) forward; the backward is
    ``(out - label)`` (its sign for ``mae``) times ``grad_scale /
    batch``, whatever the head gradient, as MXNet's regression heads."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data + 0
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, _g):
        out, lab = ctx.saved_tensors
        diff = out - lab.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        return grad * ctx.grad_scale / out.shape[0], None, None, None


@register_op("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "linear", grad_scale)


@register_op("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "mae", grad_scale)


@register_op("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    return _RegressionOutput.apply(data, label, "logistic", grad_scale)


@register_op("ctc_loss", aliases=("CTCLoss", "_contrib_ctc_loss"))
def ctc_loss_op(data, label, data_lengths=None, label_lengths=None,
                use_data_lengths=False, use_label_lengths=False,
                blank_label="first"):
    """Connectionist temporal classification loss (``ops.ctc``): data
    (T, N, C) unnormalized, label (N, L); (N,) losses. ``blank_label``
    ``"first"``: index 0 is the blank and labels use 1..C-1;
    ``"last"``: index C-1 is the blank and labels use 0..C-2, padded
    with -1 (the alphabet is rolled onto the first form)."""
    from ..ops.ctc import ctc_loss as _ctc

    if blank_label not in ("first", "last"):
        raise ValueError(f"blank_label must be first|last, got "
                         f"{blank_label}")
    if blank_label == "last":
        data = torch.cat([data[..., -1:], data[..., :-1]], dim=-1)
        label = torch.where(label < 0, torch.full_like(label, -1),
                            label) + 1
    dl = data_lengths if use_data_lengths else None
    ll = label_lengths if use_label_lengths else None
    return _ctc(data, label, dl, ll)
