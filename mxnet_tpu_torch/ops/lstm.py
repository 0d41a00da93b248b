"""Whole-sequence LSTM, forward (K6a) and backward (K6b): the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
Function that binds the two.

Port of ``mxnet_tpu/ops/pallas/lstm.py`` (``lstm_layer_fused`` over
``_lstm_fwd`` / ``_lstm_fwd_kernel`` and ``_lstm_bwd`` /
``_lstm_bwd_kernel``). One layer and direction over the whole
sequence: ``gin`` (T, N, 4H) holds the input-side gate projections
``x @ W_i2h^T + b_i2h + b_h2h`` in gate order (i, f, g, o), ``w`` is the
(H, 4H) recurrent weight and ``h0``, ``c0`` the (N, H) initial state::

    z = gin[t] + h @ w          (h rounded to w's type, f32 products)
    c = sigmoid(z_f) * c + sigmoid(z_i) * tanh(z_g)      (f32 carry)
    h = sigmoid(z_o) * tanh(c)

Forward emits ``out`` = every h, ``cseq`` = every c and the activated
gates, all in gin's type; the backward walks time in reverse from them
and gives ``dgin`` (gin's type) and dh0, dc0, dW (float32, cast to the
inputs' types by the Function).

``w`` may be any strided (H, 4H) view: MXNet's (4H, H) ``h2h_weight``
is passed as ``w_h2h.t()``, read by strides, and its gradient is
written in the same layout, so neither direction copies the weight.

:func:`lstm_layer_fused` is one ``torch.autograd.Function``: for CUDA
tensors its forward launches K6a (``csrc/lstm.cu``, one persistent
cooperative grid) and its backward K6b (the recurrence, one persistent
cooperative grid on the tensor cores, then the dW product); for CPU
tensors it takes the plain versions (:func:`lstm_forward_reference`, a
per-step loop that autograd can also differentiate, and
:func:`lstm_backward_reference`). In the JAX package the kernel is
opt-in (``MXNET_TPU_FUSED_LSTM``) and the default is XLA's scan. Here
the eager counterpart of that scan is a per-step loop, about eight
launches a step, so the ``RNN`` op takes K6 for every layer of the
kernels' types and the scan only for others (float64): the switch has
no role in the port.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "device_numbers", "lstm_backward",
           "lstm_backward_reference", "lstm_forward",
           "lstm_forward_reference", "lstm_layer_fused", "lstm_plan",
           "plan_grid"]

#: kernel launches by kernel name (the main-path proof counts these):
#: the backward is two kernels, the recurrence and the dW product
LAUNCHES = {"lstm_fwd": 0, "lstm_bwd": 0, "lstm_bwd_dw": 0}
# mxtt_lstm_device(out[3]); mxtt_lstm_occupancy(bwd, u, dtype, wg, walk,
# smem, out[1])
_DEVICE_ARGS = [ctypes.c_void_p]
_OCC_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p]
# mxtt_lstm_fwd(gin, w, sk, sg, h0, c0, out, cseq, gates, cbuf, hbuf, wg,
#               T, N, H, dtype, blocks, u, RG, ldw, hp, smem)
_FWD_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
# mxtt_lstm_bwd(gates, cseq, w, sk, sg, c0, dout, dcseq, dgin, dh0, dc0,
#               wg, T, N, H, dtype, blocks, u, RG, ldw, smem)
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
# mxtt_lstm_bwd_dw(out, h0, dgin, dw, sk, sg, T, N, H, dtype)
_DW_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_int] * 4
_WARPS = 8              # warps a block of the backward's recurrence
_FWD_WARPS = 16         # warps a block of the forward
_TILE = 8               # units of one mma n-tile
_plans = {}
_devices = {}


def lstm_forward_reference(gin, w, h0, c0):
    """Plain PyTorch version of K6a: a per-step loop with the kernel's
    casts, differentiable by autograd. Returns ``(out, cseq, gates)``
    in gin's type."""
    steps, _, g4 = gin.shape
    hid = g4 // 4
    wf = w.float()
    h, c = h0.float(), c0.float()
    outs, cs, gs = [], [], []
    for t in range(steps):
        z = gin[t].float() + h.to(w.dtype).float() @ wf
        i, f, g, o = z.split(hid, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h.to(gin.dtype))
        cs.append(c.to(gin.dtype))
        gs.append(torch.cat([i, f, g, o], dim=-1).to(gin.dtype))
    if not steps:
        empty = gin.new_empty((0, *h0.shape))
        return empty, empty.clone(), gin.new_empty(gin.shape)
    return torch.stack(outs), torch.stack(cs), torch.stack(gs)


def lstm_backward_reference(gates, cseq, out, w, h0, c0, dout, dcseq):
    """Plain PyTorch version of K6b: the reverse-time walk of
    ``_lstm_bwd_kernel`` in float32. Returns ``(dgin, dh0, dc0, dw)``:
    dgin in gates' type, the rest float32, dw of w's shape."""
    steps, _, g4 = gates.shape
    hid = g4 // 4
    wf = w.float()
    dh = torch.zeros(h0.shape, dtype=torch.float32, device=gates.device)
    dc = torch.zeros_like(dh)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=gates.device)
    dgin = torch.empty_like(gates)
    for t in range(steps - 1, -1, -1):
        i, f, g, o = gates[t].float().split(hid, dim=-1)
        c_t = cseq[t].float()
        c_prev = (cseq[t - 1] if t else c0).float()
        h_prev = (out[t - 1] if t else h0).to(w.dtype).float()
        tanh_c = torch.tanh(c_t)
        dh = dout[t].float() + dh
        dcur = dh * o * (1.0 - tanh_c * tanh_c) + dc + dcseq[t].float()
        dz = torch.cat([dcur * g * i * (1.0 - i),
                        dcur * c_prev * f * (1.0 - f),
                        dcur * i * (1.0 - g * g),
                        dh * tanh_c * o * (1.0 - o)], dim=-1)
        dgin[t] = dz.to(gates.dtype)
        dzc = dz.to(w.dtype).float()
        dh = dzc @ wf.t()
        dc = dcur * f
        dw += h_prev.t() @ dzc
    return dgin, dh, dc, dw


def _check(gin, w, h0, c0):
    if gin.ndim != 3 or gin.shape[2] % 4:
        raise ValueError(f"lstm takes gin (T, N, 4H), got "
                         f"{tuple(gin.shape)}")
    steps, n, g4 = gin.shape
    hid = g4 // 4
    if tuple(w.shape) != (hid, g4):
        raise ValueError(f"w must be ({hid}, {g4}), got {tuple(w.shape)}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (n, hid):
            raise ValueError(f"{name} must be ({n}, {hid}), got "
                             f"{tuple(t.shape)}")
    if gin.dtype not in _build.DTYPE_CODES or any(
            t.dtype != gin.dtype for t in (w, h0, c0)):
        raise TypeError(f"lstm kernel takes float32, bfloat16 or float16 "
                        f"gin/w/h0/c0 of one dtype, got {gin.dtype}/"
                        f"{w.dtype}/{h0.dtype}/{c0.dtype}")
    devs = {t.device for t in (gin, w, h0, c0)}
    if len(devs) != 1:
        raise ValueError(f"lstm operands on several devices: "
                         f"{sorted(map(str, devs))}")
    if gin.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lstm runs on cuda or cpu tensors, got "
                         f"{gin.device}")


def _plan(n, hid, dtype, sms, smem_limit, backward, mem_limit=None):
    """(plan, fits, what it needs): :func:`plan_grid`'s arithmetic, not
    raising."""
    plan = {"sms": sms, "smem_limit": smem_limit}
    item = torch.finfo(dtype).bits // 8
    chunk = 64 // item                  # depth of one warp's chunk
    depth = 4 * hid if backward else hid
    row = -(-depth // chunk) * chunk * item
    if row % 128 == 0:
        row += 64
    w_rows = 1 if backward else 4       # W rows a unit
    mt = -(-n // 16)

    def layout(u, w_global):
        rows = w_rows * u
        # the depth split's partials: the backward's 8 warps x 16 rows x
        # its W rows, the forward's 16 warps x 16 rows x 32 columns
        red = _WARPS * 16 * rows * 4 if backward else _FWD_WARPS * 16 * 32 * 4
        return rows, red + (0 if w_global else rows * row)

    # W's part in shared memory where it fits at one block an SM, else
    # (wide layers) in device memory at 16 units a block, where a block
    # may walk several work blocks a step
    sizes = (2 * _TILE, _TILE) if hid > _TILE else (_TILE,)
    for u, w_global in [*((u, False) for u in sizes), (sizes[0], True)]:
        rows, smem = layout(u, w_global)
        if smem <= smem_limit and -(-hid // u) <= sms:
            break
    u = min(u, hid)
    groups = -(-hid // u)
    rg = max(1, min(mt, sms // groups))
    work = groups * rg
    blocks = min(work, sms)
    scratch = work * rows * (row // item) if w_global else 0
    plan.update(blocks=blocks, work_blocks=work, walk=-(-work // blocks),
                units_per_block=u, unit_groups=groups, row_groups=rg,
                m_tiles=mt, w_row=row // item, smem_bytes=smem,
                w_global=w_global, w_scratch=scratch)
    if not backward:
        plan["h_row"] = -(-hid // chunk) * chunk
    mem_ok = mem_limit is None or scratch * item <= mem_limit
    fits = n >= 1 and hid >= 1 and smem <= smem_limit and mem_ok
    need = (f"{groups} unit groups of {u} units x {rg} row groups on "
            f"{blocks} blocks (one an SM), {smem} B of shared memory a "
            f"block (limit {smem_limit} B) and {scratch * item} B of W "
            f"rows in device memory (limit "
            f"{'none' if mem_limit is None else f'{mem_limit} B'})")
    return plan, fits, need


def plan_grid(n, hid, dtype, sms, smem_limit, backward=False,
              mem_limit=None):
    """The grid of one K6a (or, with ``backward``, K6b recurrence)
    launch for ``n`` rows and ``hid`` units on a card with ``sms`` SMs
    and ``smem_limit`` bytes of shared memory a block: a pure function,
    the arithmetic of ``csrc/lstm.cu``'s layout. One block an SM.

    Both kernels run the recurrent product on the tensor cores over
    work blocks of ``units_per_block`` units (16, two mma n-tiles, where
    W's rows for them fit, else 8) x ``row_groups`` groups of the
    batch's ``m_tiles`` tiles of 16 rows, so that each step's h
    (forward) or dgin (backward) crosses L2 once per unit group, not
    once per block: ``unit_groups`` = ceil(H / u), ``row_groups`` =
    min(m_tiles, SMs // unit_groups) (at least 1), ``work_blocks`` their
    product. Shared memory: W's rows for the block's units (the
    forward's four gate columns a unit, the backward's one row a unit),
    padded to whole n-tiles, each ``w_row`` elements of W's type (the
    product's depth, H forward and 4H backward, rounded up to 64 bytes
    at 64 mod 128), and the depth split's partial sums (f32). Where W's
    rows do not fit at one block an SM (``w_global``), 16 units a work
    block keep them in a device-memory scratch of ``w_scratch`` elements
    (one slice a work block) instead, and shared memory holds the
    partial sums only. The grid is ``blocks`` = min(work_blocks, SMs):
    past one unit group an SM (H > 16 x SMs) block b walks the work blocks
    b, b + blocks, ... every step (``walk`` of them at most), still one
    grid sync a step. The forward reads h from a scratch of ``h_row``
    elements a row (H rounded up to whole 64-byte chunks).
    On an H100 (132 SMs, 232,448 B) W stays in shared memory up to H =
    1056 in f32; any H runs with W's rows in device memory.
    ``mem_limit``: bytes of device memory the W scratch may take (none
    by default). Raises ``ValueError`` with the numbers when the shape
    does not fit: shared memory below the partial sums, or the scratch
    past ``mem_limit``."""
    n, hid, sms, smem_limit = int(n), int(hid), int(sms), int(smem_limit)
    if n < 1 or hid < 1 or sms < 1:
        raise ValueError(f"lstm grid needs N, H and SMs >= 1, got N={n}, "
                         f"H={hid}, SMs={sms}")
    plan, fits, need = _plan(n, hid, dtype, sms, smem_limit, backward,
                             mem_limit)
    if not fits:
        raise ValueError(
            f"lstm {'backward' if backward else 'forward'} kernel cannot "
            f"run N={n}, H={hid} ({dtype}) on {sms} SMs: {need}")
    return plan


def device_numbers(dev):
    """(SMs, shared bytes a block may have) of ``dev``; raises when it
    cannot launch a cooperative grid."""
    got = _devices.get(dev.index)
    if got is None:
        fn = getattr(_build.load("lstm"), "mxtt_lstm_device")
        fn.argtypes = [*_DEVICE_ARGS, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            err = fn(ctypes.addressof(buf), None)
        if err != 0:
            raise RuntimeError(f"lstm kernel: device query failed, CUDA "
                               f"error {err}")
        if not buf[2]:
            raise RuntimeError(f"lstm kernel: {dev} has no cooperative "
                               f"launch")
        got = _devices[dev.index] = (buf[0], buf[1])
    return got


def lstm_plan(n, hid, dtype=torch.float32, backward=False, device=None):
    """The grid K6a (or K6b's recurrence with ``backward``) launches for
    a batch of ``n`` rows and ``hid`` units on ``device`` (the current
    CUDA device by default): :func:`plan_grid` at the card's numbers,
    plus ``blocks_per_sm``, the blocks the kernel can keep resident on
    an SM. Raises ``ValueError`` with the numbers when the shape cannot
    run: shared memory past the limit, a W scratch past the card's
    memory, or more blocks than can be resident at once."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.index, bool(backward), int(n), int(hid), dtype)
    plan = _plans.get(key)
    if plan is not None:
        return plan
    sms, limit = device_numbers(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    plan = plan_grid(n, hid, dtype, sms, limit, backward, total)
    fn = getattr(_build.load("lstm"), "mxtt_lstm_occupancy")
    fn.argtypes = [*_OCC_ARGS, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * 1)()
    with torch.cuda.device(dev):
        err = fn(int(bool(backward)), plan["units_per_block"],
                 _build.DTYPE_CODES[dtype], int(plan["w_global"]),
                 int(plan["blocks"] < plan["work_blocks"]),
                 plan["smem_bytes"], ctypes.addressof(buf), None)
    if err != 0:
        raise RuntimeError(f"lstm kernel planning failed: CUDA error {err}")
    plan["blocks_per_sm"] = buf[0]
    if buf[0] * sms < plan["blocks"]:
        raise ValueError(
            f"lstm {'backward' if backward else 'forward'} kernel cannot "
            f"run N={n}, H={hid} ({dtype}) on this card: {plan['blocks']} "
            f"blocks with {plan['smem_bytes']} B of shared memory each, "
            f"{buf[0]} resident per SM x {sms} SMs")
    _plans[key] = plan
    return plan


def lstm_forward(gin, w, h0, c0):
    """K6a: ``(out, cseq, gates)`` in gin's type. CUDA tensors launch
    the kernel or raise; CPU tensors take
    :func:`lstm_forward_reference`."""
    _check(gin, w, h0, c0)
    if _build.plain(gin):
        return lstm_forward_reference(gin, w, h0, c0)
    steps, n, g4 = gin.shape
    hid = g4 // 4
    gin, h0, c0 = gin.contiguous(), h0.contiguous(), c0.contiguous()
    out = gin.new_empty((steps, n, hid))
    cseq = gin.new_empty((steps, n, hid))
    gates = torch.empty_like(gin)
    if steps and n:
        plan = lstm_plan(n, hid, gin.dtype, False, gin.device)
        cbuf = torch.empty((n, hid), dtype=torch.float32, device=gin.device)
        # h_{t-1} and h_t, rows of whole 64-byte chunks (the kernel zeroes
        # the columns past H)
        hbuf = gin.new_empty((2, n, plan["h_row"]))
        wg = gin.new_empty(plan["w_scratch"]) if plan["w_global"] else None
        _build.launch("lstm", "mxtt_lstm_fwd", _FWD_ARGS, gin.device,
                      gin.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
                      h0.data_ptr(), c0.data_ptr(), out.data_ptr(),
                      cseq.data_ptr(), gates.data_ptr(), cbuf.data_ptr(),
                      hbuf.data_ptr(), wg.data_ptr() if wg is not None
                      else None, steps, n, hid,
                      _build.DTYPE_CODES[gin.dtype], plan["blocks"],
                      plan["units_per_block"], plan["row_groups"],
                      plan["w_row"], plan["h_row"], plan["smem_bytes"],
                      count=(LAUNCHES, "lstm_fwd"))
    return out, cseq, gates


def lstm_backward(gates, cseq, out, w, h0, c0, dout, dcseq):
    """K6b: ``(dgin, dh0, dc0, dw)`` from the forward's saved gates,
    cseq and out and the cotangents of out and cseq; dgin in gates'
    type, dh0/dc0 (N, H) and dw (w's shape and strides) float32. CUDA
    tensors launch the two kernels (counted as ``lstm_bwd`` and
    ``lstm_bwd_dw``) or raise; CPU tensors take
    :func:`lstm_backward_reference`."""
    _check(gates, w, h0, c0)
    for name, t in (("cseq", cseq), ("out", out), ("dout", dout),
                    ("dcseq", dcseq)):
        if tuple(t.shape) != tuple(gates.shape[:2]) + (h0.shape[1],) \
                or t.dtype != gates.dtype or t.device != gates.device:
            raise ValueError(f"{name} must be {tuple(gates.shape[:2])} x "
                             f"{h0.shape[1]} {gates.dtype} on "
                             f"{gates.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if _build.plain(gates):
        return lstm_backward_reference(gates, cseq, out, w, h0, c0, dout,
                                       dcseq)
    steps, n, g4 = gates.shape
    hid = g4 // 4
    gates, cseq, out, h0, c0, dout, dcseq = (
        t.contiguous() for t in (gates, cseq, out, h0, c0, dout, dcseq))
    dgin = torch.empty_like(gates)
    dh0 = torch.zeros((n, hid), dtype=torch.float32, device=gates.device)
    dc0 = torch.zeros_like(dh0)
    dw = torch.empty_strided(tuple(w.shape), w.stride(), dtype=torch.float32,
                             device=gates.device)
    if steps and n:
        code = _build.DTYPE_CODES[gates.dtype]
        plan = lstm_plan(n, hid, gates.dtype, True, gates.device)
        wg = gates.new_empty(plan["w_scratch"]) if plan["w_global"] \
            else None
        _build.launch("lstm", "mxtt_lstm_bwd", _BWD_ARGS, gates.device,
                      gates.data_ptr(), cseq.data_ptr(), w.data_ptr(),
                      w.stride(0), w.stride(1), c0.data_ptr(),
                      dout.data_ptr(), dcseq.data_ptr(), dgin.data_ptr(),
                      dh0.data_ptr(), dc0.data_ptr(),
                      wg.data_ptr() if wg is not None else None, steps, n,
                      hid, code,
                      plan["blocks"], plan["units_per_block"],
                      plan["row_groups"], plan["w_row"], plan["smem_bytes"],
                      count=(LAUNCHES, "lstm_bwd"))
        _build.launch("lstm", "mxtt_lstm_bwd_dw", _DW_ARGS, gates.device,
                      out.data_ptr(), h0.data_ptr(), dgin.data_ptr(),
                      dw.data_ptr(), dw.stride(0), dw.stride(1), steps, n,
                      hid, code,
                      count=(LAUNCHES, "lstm_bwd_dw"))
    else:
        dw.zero_()
    return dgin, dh0, dc0, dw


class _LSTMLayer(torch.autograd.Function):
    """K6a forward with (gates, cseq, out) saved, K6b backward (plain
    versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, gin, w, h0, c0):
        out, cseq, gates = lstm_forward(gin, w, h0, c0)
        ctx.save_for_backward(gates, cseq, out, w, h0, c0)
        return out, cseq

    @staticmethod
    def backward(ctx, dout, dcseq):
        gates, cseq, out, w, h0, c0 = ctx.saved_tensors
        dgin, dh0, dc0, dw = lstm_backward(gates, cseq, out, w, h0, c0,
                                           dout, dcseq)
        return dgin, dw.to(w.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype)


def lstm_layer_fused(gin, w_h2h, h0, c0):
    """One LSTM layer/direction over the whole sequence (module
    docstring), differentiable in all four inputs.

    gin : (T, N, 4H) input-side gate projections, gate order (i, f, g,
        o). w_h2h : (H, 4H) recurrent weight, any strides (MXNet's
        (4H, H) parameter as ``.t()``). h0, c0 : (N, H).
    Returns ``(out, cseq)``, each (T, N, H) in gin's type; callers take
    ``out[-1]`` / ``cseq[-1]`` for the final state, so those cotangents
    reach the backward through plain indexing.
    """
    _check(gin, w_h2h, h0, c0)
    return _LSTMLayer.apply(gin, w_h2h, h0, c0)
