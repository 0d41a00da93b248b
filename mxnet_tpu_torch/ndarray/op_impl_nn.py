"""The neural-network ops encoder serving calls, as plain functions on
tensors.

Port of the parts of ``mxnet_tpu/ndarray/op_impl_nn.py`` the BERT
forward reaches: the activations (erf GELU, tanh for the pooler, relu),
the embedding gather, LayerNorm, fused flash attention, and the
attention mask helpers of the composed (additive-mask) path. Flash
attention and last-axis LayerNorm go to the hand-written CUDA kernels
for CUDA tensors (``ops.flash_attention`` / ``ops.layer_norm``) and to
their plain versions for CPU tensors; the rest is plain PyTorch, as
the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.layer_norm import layer_norm_fused

__all__ = ["activation", "attention_length_mask", "attention_segment_mask",
           "attention_zero_empty_rows", "attention_zero_pad_rows",
           "batch_dot_attention_apply", "batch_dot_attention_scores",
           "causal_mask_scores", "embedding", "flash_attention_op",
           "layer_norm", "segment_valid_len"]

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
    ``segment_ids`` (B, S) masked in the kernel. A causal mask is
    end-aligned: q row 0 sits at key position ``Skv - Sq``."""
    if valid_len is not None:
        valid_len = valid_len.to(torch.int32).reshape(-1).contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    q_off = key.shape[2] - query.shape[2] if causal else 0
    return flash_attention(query, key, value, sm_scale, bool(causal), q_off,
                           valid_len, segment_ids)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis``: the last axis goes to the fused kernel
    (``ops.layer_norm``), any other to the plain math."""
    ax = int(axis) % data.ndim
    if ax == data.ndim - 1:
        return layer_norm_fused(data.contiguous(), gamma, beta, float(eps))
    mean = data.mean(dim=ax, keepdim=True)
    xc = data - mean
    var = (xc * xc).mean(dim=ax, keepdim=True)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    return xc * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
