"""Flash attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the forward of ``mxnet_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` / ``flash_attention_with_lse`` over ``_flash_fwd``
and ``_fwd_kernel``), with the same public signatures minus
``interpret``. Shapes, as there::

    q            (B, H, Sq, D)
    k, v         (B, H, Skv, D)
    kv_lens      (B,) int32     keys at/after each row's length are
                                masked (optional)
    segment_ids  (B, S) int32   packed rows: a pair is visible only
                                inside one segment id (optional;
                                needs Sq == Skv)

``causal`` masks keys past ``row + q_offset`` (``q_offset`` is the
global position of q row 0 relative to k row 0). q is scaled by
``sm_scale`` (default ``1/sqrt(D)``) and rounded back to q's type
before the products, as the TPU wrapper does. A row with no visible
key gives exact zeros and ``lse = -1e30``. ``lse`` is (B, H, Sq)
float32.

:func:`flash_attention` / :func:`flash_attention_with_lse` launch the
hand-written CUDA kernel (``csrc/flash_attention.cu``) for CUDA
tensors; they take the plain version (:func:`flash_attention_reference`)
only for CPU tensors. Both check the operands and raise on what the
kernel does not take.
Forward only: asking for a gradient through the kernel raises (the
backward kernels come with training).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_reference",
           "flash_attention_with_lse"]

_NEG_INF = -1e30
#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"flash_attention": 0}
_MAX_D = 128
# mxtt_flash_attention_fwd(q, k, v, kv_lens, seg, o, lse, strides, B, H,
#                          Sq, Skv, D, scale, causal, q_offset, dtype)
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] \
    + [ctypes.c_int] * 3


def _visible(sq, skv, device, kv_lens=None, segment_ids=None,
             causal=False, q_offset=0):
    """(B|1, 1, Sq, Skv) bool mask of the visible (query, key) pairs,
    or None when every pair is visible."""
    mask = None
    col = torch.arange(skv, device=device)
    if kv_lens is not None:
        mask = col[None, None, None, :] \
            < kv_lens.to(torch.int64).reshape(-1)[:, None, None, None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int64)
        sm = seg[:, None, :, None] == seg[:, None, None, :]
        mask = sm if mask is None else mask & sm
    if causal:
        row = torch.arange(sq, device=device)
        cm = col[None, :] <= row[:, None] + q_offset
        mask = cm[None, None] if mask is None else mask & cm
    return mask


def flash_attention_reference(q, k, v, sm_scale=None, causal=False,
                              q_offset=0, kv_lens=None, segment_ids=None):
    """Plain PyTorch version: the composed masked softmax of
    ``mxnet_tpu/ndarray/op_impl_nn.py::flash_attention_op`` in float32
    on q pre-scaled as the kernel takes it, plus the log-sum-exp.
    Returns ``(o, lse)``."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    sq, skv = q.shape[2], k.shape[2]
    qf = (q * sm_scale).to(q.dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    mask = _visible(sq, skv, q.device, kv_lens, segment_ids, causal,
                    q_offset)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    seen = m > _NEG_INF / 2
    p = torch.where(seen, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones((), device=l.device), l)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l_safe, v.float()).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full((), _NEG_INF, device=l.device),
                      m + torch.log(l_safe))
    return o, lse[..., 0]


def _check(q, k, v, kv_lens, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (B, H, S, D) q, k, v")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(1..{_MAX_D})")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32, bfloat16 or "
                        f"float16 q/k/v of one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    ops = [("q", q), ("k", k), ("v", v)]
    if kv_lens is not None:
        if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32:
            raise TypeError(f"kv_lens must be ({b},) int32, got "
                            f"{tuple(kv_lens.shape)} {kv_lens.dtype}")
        ops.append(("kv_lens", kv_lens))
    if segment_ids is not None:
        if sq != skv:
            raise ValueError(f"segment_ids (packing) requires "
                             f"self-attention shapes, got sq={sq} != "
                             f"skv={skv}")
        if segment_ids.shape != (b, sq) or segment_ids.dtype != torch.int32:
            raise TypeError(f"segment_ids must be ({b}, {sq}) int32, got "
                            f"{tuple(segment_ids.shape)} "
                            f"{segment_ids.dtype}")
        ops.append(("segment_ids", segment_ids))
    devs = {t.device for _, t in ops}
    if len(devs) != 1:
        raise ValueError(f"flash attention operands on several devices: "
                         f"{sorted(map(str, devs))}")
    for name, t in ops:
        if t.ndim == 4:
            if t.stride(3) != 1:
                raise ValueError(f"{name} must be contiguous in its last "
                                 f"axis")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k, v, sm_scale, causal, q_offset, kv_lens, segment_ids):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash attention kernel is forward only: "
                           "run it under torch.no_grad() or "
                           "inference_mode()")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    # o in a (B, S, H, D) buffer: the caller's merge of the heads back
    # to (B, S, H * D) is then a free reshape
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    _build.launch("flash_attention", "mxtt_flash_attention_fwd", _ARGS,
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_lens.data_ptr() if kv_lens is not None else None,
                  segment_ids.data_ptr() if segment_ids is not None
                  else None,
                  o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
                  b, h, sq, skv, d, float(sm_scale), int(bool(causal)),
                  int(q_offset), _build.DTYPE_CODES[q.dtype])
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_with_lse(q, k, v, sm_scale=None, causal=False,
                             q_offset=0, kv_lens=None, segment_ids=None):
    """Flash attention returning ``(o, lse)`` (module docstring). CUDA
    tensors launch the CUDA kernel or raise; CPU tensors take
    :func:`flash_attention_reference`. On the card ``o`` is a
    (B, H, Sq, D) view of a (B, Sq, H, D) buffer."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check(q, k, v, kv_lens, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale, causal,
                                         q_offset, kv_lens, segment_ids)
    return _launch(q, k, v, sm_scale, causal, q_offset, kv_lens,
                   segment_ids)


def flash_attention(q, k, v, sm_scale=None, causal=False, q_offset=0,
                    kv_lens=None, segment_ids=None):
    """softmax(q k^T * scale [+ causal/length/segment mask]) v; see
    :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, sm_scale, causal, q_offset,
                                    kv_lens, segment_ids)[0]
