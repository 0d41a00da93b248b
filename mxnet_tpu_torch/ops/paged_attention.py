"""Paged flash attention for decode serving: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of the paged part of ``mxnet_tpu/ops/pallas/flash_attention.py``
(``paged_flash_attention`` / ``_paged_fwd_kernel`` and
``paged_attention_reference``). Shapes, as there::

    q          (B, H, Sq, D)          the last Sq tokens of each sequence
    k_pages    (P, H, page_size, D)   the pool (all sequences)
    v_pages    (P, H, page_size, D)
    page_table (B, NP) int32          physical page ids, padded with any
                                      in-range id past the row's
                                      ceil(kv_len / page_size) pages
    kv_lens    (B,) int32             written history length per row,
                                      INCLUDING the Sq query tokens

Query row ``i`` sees positions ``<= kv_len - Sq + i`` and ``< kv_len``;
a row with nothing to see gives exact zeros. Forward only.

:func:`paged_flash_attention` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors, and raises on what the
kernel does not take (float32 and bfloat16 at any head dim). It takes
the plain version (:func:`paged_attention_reference`) only for CPU
tensors. The kernel is split-KV: one launch a call, each row's history
cut into chunks of 64 keys (longer past 32 chunks) whose partial
softmax states the last block of a query tile folds, in chunk order.
The wrapper gives it a scratch for the partials, sized by the kernel's
own split policy (:func:`split_count`), and the ticket counters of the
current stream, which the kernel leaves at zero: calls on one stream
run one after another, so no two running calls share counters.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["LAUNCHES", "paged_attention_reference",
           "paged_flash_attention", "split_count"]

_NEG_INF = -1e30
#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"paged_attention": 0}
#: head dims a block takes at once; past it the kernel writes the output
#: in chunks of this many dims, one block each
_CHUNK_D = 256
_DTYPES = (torch.float32, torch.bfloat16)
# mxtt_paged_attention_fwd(q, k, v, table, kv_lens, out, part, tickets,
#                          B, H, Sq, D, page_size, n_table, vec, scale,
#                          dtype)
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int]
#: per (device, stream), the kernel's ticket counters: zeros between
#: calls (the last block of a query tile resets its own)
_TICKETS = {}
#: counters that a larger buffer replaced: a graph captured earlier
#: still launches on them, so they are never freed
_RETIRED = []


def paged_attention_reference(q, k_pages, v_pages, page_table, kv_lens,
                              sm_scale=None):
    """Plain PyTorch version, line for line the JAX package's dense
    reference: gather the table'd pages, mask columns past each row's
    ``kv_len`` (causal within the Sq chunk), max-subtracted softmax.
    Every row's computation is independent of the others."""
    b, h, sq, d = q.shape
    page_size = k_pages.shape[2]
    npages = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    tbl = page_table.long()
    # (B, NP, H, page, D) -> (B, H, NP*page, D)
    k = torch.movedim(k_pages[tbl], 2, 1) \
        .reshape(b, h, npages * page_size, d)
    v = torch.movedim(v_pages[tbl], 2, 1) \
        .reshape(b, h, npages * page_size, d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale, k.float())
    col = torch.arange(npages * page_size, dtype=torch.int32,
                       device=q.device)
    row = torch.arange(sq, dtype=torch.int32, device=q.device)
    kvl = kv_lens.to(torch.int32)[:, None, None, None]
    mask = torch.logical_and(
        col[None, None, None, :] <= kvl - sq + row[None, None, :, None],
        col[None, None, None, :] < kvl)
    s = torch.where(mask, s, torch.tensor(_NEG_INF, dtype=s.dtype,
                                          device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    seen = m > _NEG_INF / 2
    p = torch.where(seen, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones((), device=l.device), l)
    return torch.einsum("bhqk,bhkd->bhqd", p / l, v.float()).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, kv_lens):
    b, h, sq, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape[1] != h or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"page pool shape {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)} does not match q heads/dim ({h}, {d})")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B={b}, NP), got "
                         f"{tuple(page_table.shape)}")
    if kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be (B={b},), got "
                         f"{tuple(kv_lens.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    if d < 1:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(at least 1)")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, kv_lens)}
    if len(devs) != 1:
        raise ValueError(f"paged attention operands on several devices: "
                         f"{sorted(map(str, devs))}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("kv_lens", kv_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def split_count(n_table, page_size):
    """Blocks the kernel takes along a row's keys, as the kernel's
    library computes them (``mxtt_paged_attention_split``): one a
    64-key chunk (more keys a chunk past 32 chunks), as many as the
    table's width can hold, at least one. Only the grid and the scratch
    depend on it: a row's chunks depend on its own ``kv_len``, so its
    result does not. Builds the kernel on first use."""
    fn = _build.load("paged_attention").mxtt_paged_attention_split
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(int(n_table), int(page_size))
    if n < 1:
        raise ValueError(f"no split for a table of {n_table} pages of "
                         f"{page_size}")
    return n


def _tickets(device, n):
    """The current stream's ticket counters on ``device``, at least
    ``n``: calls on other streams may run at the same time, so each
    stream has its own. A buffer that grows keeps the old one alive
    (``_RETIRED``): a CUDA graph that captured a call holds its
    address."""
    key = (device, torch._C._cuda_getCurrentRawStream(device.index))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def paged_flash_attention(q, k_pages, v_pages, page_table, kv_lens,
                          sm_scale=None):
    """Decode-path attention over a paged KV pool (shapes in the module
    docstring). CUDA tensors launch the CUDA kernel or raise; CPU
    tensors take :func:`paged_attention_reference`."""
    if _build.plain(q):
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         kv_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check(q, k_pages, v_pages, page_table, kv_lens)
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    # the kernel scales q and rounds it back to q's type as it loads it,
    # where the TPU wrapper pre-scales it
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    page_size, n_table = k_pages.shape[2], page_table.shape[1]
    n_split = split_count(n_table, page_size)
    # chunks of the output's dims: ceil(D / 256) past D = 256, else one
    nz = -(-d // _CHUNK_D) if d > _CHUNK_D else 1
    # each (row, head, query, key chunk)'s partial: m, l a dims chunk,
    # then D sums
    part = torch.empty(b * h * sq * n_split * (d + 2 * nz),
                       dtype=torch.float32, device=q.device)
    vec = int(d * q.element_size() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k_pages,
                                                       v_pages)))
    code = _build.DTYPE_CODES[q.dtype]
    _build.launch("paged_attention", "mxtt_paged_attention_fwd", _ARGS,
                  q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), page_table.data_ptr(),
                  kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                  _tickets(q.device, b * h * sq * nz).data_ptr(), b, h, sq,
                  d,
                  page_size, n_table, vec, float(sm_scale),
                  code, count=(LAUNCHES, "paged_attention", code))
    return out
