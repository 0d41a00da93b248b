"""Flash attention, forward (K1) and backward (K2): the CUDA kernels'
wrappers, their plain PyTorch versions, and the autograd Function that
binds the two.

Port of ``mxnet_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` / ``flash_attention_with_lse`` over ``_flash_fwd``
and ``_flash_bwd``), with the same public signatures minus
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

Both functions are differentiable, :func:`flash_attention_with_lse` in
both outputs: the lse cotangent folds into the backward's
``delta = rowsum(do * o) - dlse``. Forward and backward run in one
``torch.autograd.Function``: for CUDA tensors its forward launches K1
(``csrc/flash_attention.cu``) and its backward K2
(``csrc/flash_attention_bwd.cu``: one pass where every key fits a block,
else a dq and a dk/dv kernel, see :func:`backward_path`; one launch
count); for CPU tensors it takes the plain versions
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`), so the CPU tests run the
same wiring. The operands are checked, and what the kernels do not
take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_reference",
           "flash_attention_with_lse", "backward_path", "kernel_takes",
           "visible_mask"]

_NEG_INF = -1e30
#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
# mxtt_flash_attention_fwd(q, k, v, kv_lens, seg, o, lse, strides, B, H,
#                          Sq, Skv, D, scale, causal, q_offset, dtype)
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] \
    + [ctypes.c_int] * 3
# mxtt_flash_attention_bwd(q, k, v, do, o, lse, dlse, kv_lens, seg, dq,
#                          dk, dv, strides, B, H, Sq, Skv, D, scale,
#                          causal, q_offset, dtype)
_BWD_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float] \
    + [ctypes.c_int] * 3
#: keys and head dim the one-pass backward holds in shared memory at most,
#: and the head dim past which every kernel walks it in chunks
#: (``csrc/flash_attention_bwd.cu`` picks its path by the same limits)
_FUSED_KEYS, _FUSED_D, _CHUNKED_D = 128, 64, 256


def kernel_takes(q):
    """Whether the op hands queries like ``q`` to the kernels, from its
    shape and type alone, before any launch, as the JAX op asks
    ``pallas_ok_for`` and its kernel's types: (B, H, S, D) float32,
    bfloat16 or float16, at any head dim, on either device (the JAX
    kernel takes the whole head dim into its blocks at any D; CPU
    tensors take the plain versions)."""
    return q.ndim == 4 and q.dtype in _build.DTYPE_CODES


def backward_path(skv, d):
    """Which K2 kernels a backward of ``skv`` keys and head dim ``d``
    launches: ``"fused"`` (one pass, every key in the block: Skv <= 128,
    the JAX kernel's nk <= 2 case, with D <= 64, or D > 256 where the
    kernel walks the head dim in chunks of 64) or ``"split"`` (a dq and
    a dk/dv kernel). The kernels' C entry point makes the same choice;
    this is its label for tests and reports."""
    return "fused" if skv <= _FUSED_KEYS and (
        d <= _FUSED_D or d > _CHUNKED_D) else "split"


def visible_mask(sq, skv, device, kv_lens=None, segment_ids=None,
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
    mask = visible_mask(sq, skv, q.device, kv_lens, segment_ids, causal,
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


def flash_attention_backward_reference(q, k, v, lse, do, delta,
                                       sm_scale=None, causal=False,
                                       q_offset=0, kv_lens=None,
                                       segment_ids=None):
    """Plain PyTorch version of the backward: the TPU kernels' math step
    by step in float32. ``lse`` is the forward's, ``delta`` (B, H, Sq)
    ``rowsum(do * o) - dlse``. Returns ``(dq, dk, dv)`` in q's, k's and
    v's types."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    sq, skv = q.shape[2], k.shape[2]
    qf = (q * sm_scale).to(q.dtype).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = visible_mask(sq, skv, q.device, kv_lens, segment_ids, causal,
                        q_offset)
    # masked BEFORE the exponent: empty rows have lse = -1e30
    z = s - lse.float()[..., None]
    if mask is not None:
        z = torch.where(mask, z, torch.full((), -torch.inf, device=z.device))
    p = torch.exp(z)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_lens, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (B, H, S, D) q, k, v")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d < 1:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(at least 1)")
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
    b, h, sq, d = q.shape
    skv = k.shape[2]
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
                  int(q_offset), _build.DTYPE_CODES[q.dtype],
                  count=(LAUNCHES, "flash_attention"))
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, dlse, sm_scale, causal, q_offset,
                kv_lens, segment_ids):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    # each gradient in a (B, S, H, D) buffer, as o: the caller's merge of
    # the heads back into the fused projection's layout is a view
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=t.dtype,
                              device=q.device).transpose(1, 2)
                  for t, n in ((q, sq), (k, skv), (v, skv)))
    if b * h * max(sq, skv) == 0:
        return dq, dk, dv
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in (q, k, v, do, o, dq, dk, dv)
          for i in range(3)))
    _build.launch("flash_attention_bwd", "mxtt_flash_attention_bwd",
                  _BWD_ARGS, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  dlse.data_ptr() if dlse is not None else None,
                  kv_lens.data_ptr() if kv_lens is not None else None,
                  segment_ids.data_ptr() if segment_ids is not None
                  else None,
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  ctypes.addressof(strides), b, h, sq, skv, d,
                  float(sm_scale), int(bool(causal)), int(q_offset),
                  _build.DTYPE_CODES[q.dtype],
                  count=(LAUNCHES, "flash_attention_bwd"))
    return dq, dk, dv


def flash_attention_backward(q, k, v, o, lse, do, sm_scale=None,
                             causal=False, q_offset=0, kv_lens=None,
                             segment_ids=None, dlse=None):
    """dq, dk, dv of flash attention from the forward's ``o`` and
    ``lse`` and the output gradient ``do`` (and ``dlse``, the lse's
    gradient, when lse was used). CUDA tensors launch K2 or raise; CPU
    tensors take :func:`flash_attention_backward_reference`. ``delta =
    rowsum(do * o) - dlse``, which the JAX package computes outside its
    kernels, is one torch expression on the CPU and computed by K2 from
    o, do and dlse on the card."""
    _check(q, k, v, kv_lens, segment_ids)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape \
            or o.dtype != q.dtype:
        raise ValueError(f"o/do must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)}/{tuple(do.shape)} "
                         f"{o.dtype}/{do.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise TypeError(f"lse must be {tuple(q.shape[:3])} float32, got "
                        f"{tuple(lse.shape)} {lse.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _build.plain(q):
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        return flash_attention_backward_reference(
            q, k, v, lse, do, delta, sm_scale, causal, q_offset, kv_lens,
            segment_ids)
    do, o = (t if t.stride(-1) == 1 else t.contiguous() for t in (do, o))
    if dlse is not None:
        dlse = dlse.float().contiguous()
    return _launch_bwd(q, k, v, o, lse.contiguous(), do, dlse, sm_scale,
                       causal, q_offset, kv_lens, segment_ids)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, q_offset, kv_lens,
                segment_ids):
        if _build.plain(q):
            o, lse = flash_attention_reference(q, k, v, sm_scale, causal,
                                               q_offset, kv_lens,
                                               segment_ids)
        else:
            o, lse = _launch(q, k, v, sm_scale, causal, q_offset, kv_lens,
                             segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, segment_ids)
        ctx.attrs = (sm_scale, causal, q_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_lens, segment_ids = ctx.saved_tensors
        sm_scale, causal, q_offset = ctx.attrs
        if do is None:
            do = torch.zeros_like(q)
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do, sm_scale, causal, q_offset, kv_lens,
            segment_ids, dlse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q, k, v, sm_scale=None, causal=False,
                             q_offset=0, kv_lens=None, segment_ids=None):
    """Flash attention returning ``(o, lse)`` (module docstring),
    differentiable in both. CUDA tensors launch the CUDA kernels or
    raise; CPU tensors take the plain versions. On the card ``o`` is a
    (B, H, Sq, D) view of a (B, Sq, H, D) buffer."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check(q, k, v, kv_lens, segment_ids)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                                 int(q_offset), kv_lens, segment_ids)


def flash_attention(q, k, v, sm_scale=None, causal=False, q_offset=0,
                    kv_lens=None, segment_ids=None):
    """softmax(q k^T * scale [+ causal/length/segment mask]) v; see
    :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, sm_scale, causal, q_offset,
                                    kv_lens, segment_ids)[0]
