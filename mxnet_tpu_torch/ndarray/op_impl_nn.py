"""The neural-network ops BERT serving and training call, as plain
functions on tensors.

Port of the parts of ``mxnet_tpu/ndarray/op_impl_nn.py`` (and ``pick``
of ``op_impl_basic.py``) the BERT forward, its MLM loss and the Gluon
losses reach: the activations (erf GELU, tanh for the pooler, relu),
the embedding gather, LayerNorm, fused flash attention, the attention
mask helpers of the composed (additive-mask) path, ``log_softmax``,
``pick`` and ``softmax_cross_entropy``. Flash attention, last-axis
LayerNorm and ``softmax_cross_entropy`` go to the hand-written CUDA
kernels for CUDA tensors (``ops.flash_attention``, ``ops.layer_norm``,
``ops.softmax_xent``; each differentiable through its backward kernel)
and to their plain versions for CPU tensors; the rest is plain PyTorch,
as the JAX package leaves it to XLA.

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

import torch
import torch.nn.functional as F

from ..ops import flash_attention as _fa
from ..ops import layer_norm as _ln
from ..ops.softmax_xent import softmax_xent_fused

__all__ = ["activation", "attention_length_mask", "attention_segment_mask",
           "attention_zero_empty_rows", "attention_zero_pad_rows",
           "batch_dot_attention_apply", "batch_dot_attention_scores",
           "causal_mask_scores", "embedding", "flash_attention_op",
           "layer_norm", "log_softmax", "pick", "segment_valid_len",
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
