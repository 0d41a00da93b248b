#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card's name and power limit;
2. build every kernel of the serving and training paths from
   ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, in float32 and bfloat16, with its time,
   the plain version's, a library yardstick and the bound: paged
   attention (decode histories of 0..1024 tokens, the decode burst's
   own histories, a prefill chunk), flash attention (packed rows of
   64, 256 and 512 tokens, a dense causal 512, and the training
   batch's 64 x 128 padded rows), LayerNorm
   (8 x 512 rows of 768, eps 1e-12); and the training kernels at the
   training step's shapes: the flash-attention backward (64 x 128
   padded rows of the training batch, packed 512, dense causal 512),
   the LayerNorm backward (8192 x 768) and the fused softmax
   cross-entropy forward and backward (the batch's valid positions x
   30522; K3b and K4b also a repeat call held ``torch.equal``); the
   whole-sequence LSTM forward and backward (T=35, H=650, N=32 and
   N=1024), with their grid and cuDNN's LSTM layer as the yardstick,
   and the backward's fixed cost at N=1. Every time is the device's (torch.profiler: the device
   events a call launched, summed), with the wall of a call, host
   included, beside it; the memory-bound rows (LayerNorm, softmax
   cross-entropy) also with their inputs rotated past the 50 MB L2, and
   the LayerNorm forward's host time a call (five rounds interleaved
   with ``F.layer_norm``'s). ``device_ms`` takes a trace only when every
   device event occurs a whole multiple of the calls traced (retraced
   once, then the row fails);
4. the fused ops on the calls of the op faults, on the card against
   the same op on the CPU (1e-4 of scale; the LSTM's gradients 1e-3),
   with exact launch counts: LayerNorm at D=2048 forward and backward
   (K3a, K3b) and with ``output_mean_var`` (composed, no launch),
   attention at head_dim 256 forward and backward (K1, K2) and in
   float64 (composed, no launch), attention at head dims 264 and 512
   (K1 and K2 over chunks of the head dim; K2's one pass at S=40, its
   split pair at S=512), paged attention at head dim 320 (K5, decode
   and a 64-query chunk), ``softmax_cross_entropy`` with float32
   labels (the op casts them, K4a takes the call), one BPTT segment of
   ``gluon.rnn.LSTM`` at H=1500 (K6a, K6b and its dW product, W's rows
   in device memory) and one of 2 x LSTM(2500) at N=32 (each block
   walking two work blocks a step);
5. decode serving at GPT-2-small width (vocab 50257, 768 units, 12
   layers, 12 heads, random weights from ``--seed``): a
   ``DecodeEngine`` serves 8 greedy requests; results, streams, solo
   parity and the kernel launch counts are checked, serving metrics
   printed;
6. encoder serving at BERT-base width (vocab 30522, 768 units, 3072
   hidden, 12 layers, 12 heads, max_length 512, random weights from
   ``--seed``): a ``ServingEngine`` (mean pool, buckets 64/256/512, 8
   rows) is warmed over its shape universe, then 8 client threads
   submit 48 requests of 8..512 tokens at once; every answer is held
   against the same request served alone, launches must be exactly
   12 (flash attention) and 25 (LayerNorm) per forward, serving
   metrics printed;
7. BERT-base MLM training (``train-bertbase-mlm-b64s128``: the trunk
   without its pooler plus ``BERTMLMHead``, dropout 0, random f32
   weights from ``--seed``): 64 rows of 128 slots with valid lengths
   uniform in [64, 128] (``valid_length`` rides the flash kernels), ids
   and labels uniform over the vocabulary, every valid position
   predicted; ``autograd.record()`` -> forward ->
   ``nd.softmax_cross_entropy`` -> ``backward()`` ->
   ``Trainer.step(valid tokens)`` with Adam at lr 1e-4, 2 warm-up steps
   then 10 on the same batch. Every loss finite, the 10th below the
   1st, launches per step exactly 12 + 12 (flash attention forward and
   backward), 26 + 26 (LayerNorm) and 1 + 1 (softmax cross-entropy),
   every parameter's gradient finite and not all zero; step time p50,
   valid and slot tokens/s and peak memory printed;
8. LSTM word LM training (``train-wordlm-wt2-b32t35``:
   ``mxnet_tpu_torch/examples/word_lm.py``'s loop at WikiText-2 widths,
   vocab 33278, embedding 650, 2 x LSTM(650), dropout 0.2, Xavier
   weights from ``--seed``): the example's synthetic corpus in 32 rows,
   truncated BPTT over segments of 35, SGD at lr 1.0, clip 0.25, 2
   warm-up segments then 20. Every loss finite, the mean of the last 5
   below that of the first 5, launches per segment exactly 2 + 2 + 2
   (LSTM forward, the backward's recurrence and its dW product), every
   gradient finite and not all zero; step
   p50, tokens/s, perplexity and peak memory printed;
9. 2-layer models with the same seed on the card and on the CPU, for
   all four paths: greedy tokens agree and decode logits agree within
   ``atol=1e-3``; encoder outputs agree within ``atol=1e-3``; three
   Adam steps of the BERT training path and three SGD steps of the word
   LM (2 x 650, vocab 10000, batch 8, dropout 0) give losses within
   ``1e-4`` relative and step-1 gradients within ``1e-3`` of each
   parameter's largest CPU gradient;
10. ResNet-50 ImageNet-style training (``train-resnet50-imagenet-b128``:
    ``mxnet_tpu_torch/examples/train_imagenet.py``'s building blocks,
    ``resnet50_v1`` with 1000 classes, Xavier weights from ``--seed``,
    one synthetic batch of 128 x 3 x 224 x 224 uniform [0, 1) images
    and uniform labels, SGD at lr 0.1, momentum 0.9, wd 1e-4), 30
    warm-up steps (the loss first climbs for ~15 steps at lr 0.1, as
    the JAX model's does) then 10, once in float32 and once after
    ``net.cast("bfloat16")`` (BatchNorm keeps float32). Every loss
    finite and the 10th below the 1st, every gradient finite and not all
    zero, the running statistics finite and moved, no launch of any
    port kernel (convolution, pooling and BatchNorm run in cuDNN and
    torch's own kernels); step p50, images/s, peak memory and the
    step's FLOPs (convolutions and Dense, forward x 3) against 67
    TFLOP/s f32 and 989 TFLOP/s bf16 printed;
11. the MNIST MLP (``train-mnist-mlp-b64``:
    ``mxnet_tpu_torch/examples/mnist_gluon.py`` at its defaults:
    synthetic 60000, batch 64, Adam 1e-3, 5 epochs, a shuffled
    ``DataLoader``): its own gate (accuracy > 0.8), no port kernel,
    samples/s printed;
12. ``resnet50_v1`` at batch 4, 224 x 224, two SGD steps on the card
    and on the CPU, in float64: losses within ``1e-4`` relative, step-1
    gradients within ``1e-3`` of scale, running statistics within
    ``1e-4``; in float32 the step-1 losses within ``1e-4`` (the
    float32 gradients' gaps printed beside those of two CPU runs, with
    and without oneDNN: this model's float32 step-1 gradients move by
    tens of percent of scale with the rounding);
13. the JAX package's own scripts, unmodified, through
    ``python -m mxnet_tpu_torch.examples.run_reference`` in child
    processes on the card: ``example/word_lm.py`` at its default
    widths, data and schedule (vocab 10000, 2 x LSTM(650), 200000
    tokens, 2 epochs, bptt 35, batch 32, dropout 0.2, clip 0.25) with
    ``--optimizer adam --lr 0.002`` (its ``--quick`` optimizer: at its
    default SGD lr 1.0 neither package learns in 2 epochs; its own
    gate, perplexity below vocab / 2; K6a, K6b and its dW product
    launched exactly 2 x 356 times each: 2 + 2 + 2 a segment, 178
    segments an epoch), then ``example/mnist_gluon.py --epochs 2
    --save`` (its own gate, accuracy > 0.8; the ``.params`` it wrote
    load into a fresh MLP on the card and on the CPU, whose logits on
    a fixed batch agree within 1e-5 of scale; its ``.states`` load
    into a fresh Trainer, each state on the card, and take a step);
    perplexities, accuracies and seconds by epoch printed. Then resume
    on the card: an MLP (Adam, 5 + 5 steps) and the word LM at the
    script's widths (dropout 0, 3 + 3 SGD segments, the carried hidden
    states saved too) train, save, and train on here, while a fresh
    process (``--resume-child``) loads the files and takes the same
    last steps: final weights equal bit for bit (the word LM within
    1e-6 relative only if its own run does not repeat bit for bit).

The op-dispatch phase also times one
``F.scaled_dot_product_attention`` call beside K1, K2 and K5 at head
dims past 256 (264 and 512; K5 also 320): forward and backward apart.

``--profile`` adds a torch.profiler breakdown (device time by kernel,
busy share) of both serving windows and of one step of each training
path; the ResNet steps also by layer kind (convolutions, BatchNorm,
ReLU, pooling, Dense, loss, optimizer).

The last three lines of standard output are ``{"kernels": [...]}``,
then the card's name and power limit as ``nvidia-smi --query-gpu=
name,power.limit --format=csv,noheader`` gives them, then
``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the ``mxnet_tpu_torch`` package beside this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 FLOP/s outside the
# tensor cores (the bound of the kernels whose math runs there)
PEAK_HBM_BPS = 3.35e12
PEAK_F32_FLOPS = 67e12
# TF32 tensor-core peak (dense); a product kept to f32 accuracy by the
# 3-term split (a_hi b_hi + a_hi b_lo + a_lo b_hi) issues three of them
PEAK_TF32_FLOPS = 495e12
L2_BYTES = 50e6


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean wall of one call of ``fn`` in ms, host included: CUDA events
    around ``iters`` back-to-back calls after warm-up. When the host
    needs longer per call than the device, this is the host's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters=20, warmup=3, by_kernel=False):
    """Mean device time of one call of ``fn`` in ms: torch.profiler
    traces ``iters`` calls after warm-up and the device events they
    launched (kernels, memsets, copies) are summed and divided by
    ``iters``; the host's time between launches is left out. With
    ``by_kernel`` also returns ``{event name: ms per call}``. Every
    event name must occur a whole multiple of ``iters`` times (each call
    launches the same work): a trace that lost events is taken once
    more, and a second short count raises, as does a trace with no
    device time; a short sum is never returned."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # Now and then the device tracing misses the first launches after it
    # starts (on an H100 the first few calls of a window, whatever ran
    # on the device before them): the host waits 50 ms before launching
    # anything, and a ~1 ms spin kernel (torch.cuda._sleep) on each side
    # of the calls, left out of the sums, keeps the window's edges off
    # the calls' events.
    for attempt in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.05)
            torch.cuda._sleep(2_000_000)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
        names, counts = {}, {}
        for e in prof.key_averages():
            # the spins are not the calls'
            if e.device_type == DeviceType.CUDA and \
                    "spin_kernel" not in e.key:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                names[e.key] = names.get(e.key, 0.0) + us / 1e3 / iters
                counts[e.key] = counts.get(e.key, 0) + e.count
        short = {k: n for k, n in counts.items() if n % iters}
        total = sum(names.values())
        if not short and total > 0:
            return (total, names) if by_kernel else total
        log(f"device_ms: trace {attempt + 1} of {iters} calls "
            f"{'has event counts ' + str(short) if short else 'has no device time'}")
    raise AssertionError(f"device_ms: events lost in two traces of {iters} "
                         f"calls: counts {short or 'none'} are not whole "
                         f"multiples of the calls")


def queued_ms(fn, iters=10, warmup=2):
    """Device time of one call of ``fn`` in ms, without the profiler:
    CUDA events around ``iters`` calls that the host queues behind a
    ~25 ms spin kernel, so the device runs them back to back (the gaps
    between a call's kernels included, the host's time not). Raises if
    the host had not queued them all before the spin ended."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    if t0.query():
        raise AssertionError("queued_ms: the spin ended before the calls "
                             "were queued; lengthen it")
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_name(event):
    """A device event's kernel name without its return type, namespace
    and arguments."""
    name = event.split("(")[0] if "(anonymous" not in event \
        else event.split("::", 1)[-1].split("(")[0]
    return name.replace("void ", "")


def cold_ms(fn, args, iters=16):
    """Device time of ``fn(*args)`` with the inputs rotated over enough
    copies that each call finds them out of the L2 (at least twice its
    50 MB between two reads of one copy); returns (ms, copies). An
    input larger than that is its own rotation (copies = 1)."""
    import itertools
    import math

    nbytes = sum(a.numel() * a.element_size() for a in args)
    k = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = itertools.cycle([list(args)] + [[a.clone() for a in args]
                                           for _ in range(k - 1)])
    ms = device_ms(lambda: fn(*next(sets)), iters=max(iters, k),
                   warmup=k)
    return ms, k


def host_us(fn, calls=1000, batch=250):
    """Host time of one call of ``fn`` in µs: ``time.perf_counter``
    around ``calls`` calls, made in batches behind a ``torch.cuda.
    _sleep`` that keeps the device busy past each batch's end, so no
    call waits for the device or for a slot in its queue. Raises if a
    batch outlasted the sleep."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda._sleep(100_000_000)   # ~50 ms at the card's clock
        busy = torch.cuda.Event()
        busy.record()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        drained = busy.query()
        torch.cuda.synchronize()
        if drained:
            raise AssertionError("host_us: the device went idle during a "
                                 "batch; lengthen the sleep")
    return total / (calls // batch * batch) * 1e6


def host_rounds(fns, rounds=5):
    """:func:`host_us` of each of ``fns`` (``{key: fn}``), taken in
    ``rounds`` interleaved rounds so that load on the host falls on
    all of them alike; returns ``{key: (median, [min, max])}`` in µs a
    call."""
    import statistics

    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(host_us(fn))
    return {k: (statistics.median(v), [min(v), max(v)])
            for k, v in got.items()}


def timed(kernel, plain, library, iters=50, plain_iters=20, lib_iters=50,
          warmup=5):
    """The kernel's, its plain version's and the library yardstick's
    times: ``ms``, ``plain_ms``, ``library_ms`` device time
    (:func:`device_ms`), and ``call_ms``, ``plain_call_ms``,
    ``library_call_ms`` per call, host included (:func:`cuda_ms`)."""
    out = {}
    for key, fn, n in (("", kernel, iters), ("plain_", plain, plain_iters),
                       ("library_", library, lib_iters)):
        out[f"{key}call_ms"] = cuda_ms(fn, iters=n, warmup=warmup)
        out[f"{key}ms"] = device_ms(fn, iters=min(n, 20),
                                    warmup=min(warmup, 2))
    return out


def fmt_times(t):
    """One log fragment of :func:`timed`'s numbers, in µs."""
    def us(x):
        return f"{x * 1e3:.2f}"
    return (f"device {us(t['ms'])} us kernel, {us(t['plain_ms'])} plain, "
            f"{us(t['library_ms'])} library; per call, host included, "
            f"{us(t['call_ms'])} / {us(t['plain_call_ms'])} / "
            f"{us(t['library_call_ms'])} us")


def within_ulp(got, want, abs_tol, rel_tol=0.0):
    """Every element of ``got`` within ``abs_tol + rel_tol * |want|`` of
    ``want`` plus, for a bf16 output, one unit in its last place (2**-7
    of the value): kernel and plain version each round an f32 result
    once."""
    import torch

    rel = rel_tol + (2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0)
    bound = want.float().abs() * rel + abs_tol
    return bool(((got.float() - want.float()).abs() <= bound).all())


def paged_case(rng, b, h, sq, d, page_size, width, kv_lens, dtype, dev):
    """Random pool, permuted page tables (pad slots point at arbitrary
    in-range pages) and q for one paged-attention call."""
    import numpy as np
    import torch

    n_pages = b * width + 1
    k = rng.randn(n_pages, h, page_size, d).astype(np.float32)
    v = rng.randn(n_pages, h, page_size, d).astype(np.float32)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    table = rng.permutation(n_pages)[:b * width].reshape(b, width)
    kvl = np.asarray(kv_lens, np.int32)

    def t(x, dt=dtype):
        return torch.tensor(x, dtype=dt, device=dev)

    return (t(q), t(k), t(v), t(table.astype(np.int32), torch.int32),
            t(kvl, torch.int32))


def paged_work(b, h, sq, d, page_size, width, kv_lens, itemsize):
    """(bytes, flops) the call needs for THESE inputs: q read and out
    written once, each row's live K/V pages once, the table and
    lengths; two flops per multiply-add over the visible columns."""
    bytes_ = 2 * b * h * sq * d * itemsize + b * width * 4 + b * 4
    flops = 0
    for kvl in kv_lens:
        live = min(int(kvl), width * page_size)
        bytes_ += 2 * h * live * d * itemsize
        for i in range(sq):
            vis = max(0, min(live, int(kvl) - sq + i + 1))
            flops += h * 4 * vis * d
    return bytes_, flops


def check_paged_attention(rng, dev):
    """Kernel vs plain version at the decode and chunk shapes; returns
    the kernel's JSON entry (numbers of the decode shape, float32, at
    top level; the chunk shape under ``chunk``)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_flash_attention)

    cases = {
        # decode: 8 rows of 12 heads, ragged histories incl. 0 and 1024
        "decode": dict(b=8, h=12, sq=1, d=64, page_size=16, width=64,
                       kv_lens=[0, 1, 17, 100, 333, 512, 777, 1024]),
        # decode at the serving burst's own histories (prompts of 5..200
        # tokens plus up to 32 generated), in its table bucket of 16
        "burst": dict(b=8, h=12, sq=1, d=64, page_size=16, width=16,
                      kv_lens=[37, 49, 72, 96, 97, 132, 182, 232]),
        # chunked prefill: one 64-token chunk ending at position 200
        "chunk": dict(b=1, h=12, sq=64, d=64, page_size=16, width=16,
                      kv_lens=[201]),
    }
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    out = {}
    for name, c in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_case(rng, c["b"], c["h"], c["sq"], c["d"],
                              c["page_size"], c["width"], c["kv_lens"],
                              dtype, dev)
            got = paged_flash_attention(*args)
            want = paged_attention_reference(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            zero_rows = [i for i, n in enumerate(c["kv_lens"]) if n == 0]
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {dtype}: non-finite output")
            for i in zero_rows:
                if got[i].abs().max().item() != 0.0:
                    raise AssertionError(f"{name}: kv_len 0 row not 0")
            log(f"paged_attention {name} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (tol {tol[dtype]})")
            if not err <= tol[dtype]:
                raise AssertionError(
                    f"paged_attention {name} {dtype}: max_abs_err {err} "
                    f"> {tol[dtype]}")
            if dtype != torch.float32:
                out[name]["bf16_max_abs_err"] = err
                continue
            # yardstick only (never called by the port): SDPA over K/V
            # already gathered to dense, the gather excluded
            q, kp, vp, tbl, kvl = args
            b, h, sq, d = q.shape
            kd = torch.movedim(kp[tbl.long()], 2, 1).reshape(b, h, -1, d)
            vd = torch.movedim(vp[tbl.long()], 2, 1).reshape(b, h, -1, d)
            col = torch.arange(kd.shape[2], device=dev)
            row = torch.arange(sq, device=dev)
            kv = kvl.long()[:, None, None, None]
            mask = (col <= kv - sq + row[:, None]) & (col < kv)
            t = timed(lambda: paged_flash_attention(*args),
                      lambda: paged_attention_reference(*args),
                      lambda: F.scaled_dot_product_attention(
                          q, kd, vd, attn_mask=mask))
            nbytes, flops = paged_work(c["b"], c["h"], c["sq"], c["d"],
                                       c["page_size"], c["width"],
                                       c["kv_lens"], 4)
            bms, by = bound(nbytes, flops)
            out[name] = {"max_abs_err": err, **t, "bound_ms": bms,
                         "bound_by": by,
                         "library": "SDPA on pre-gathered K/V, gather "
                                    "excluded"}
            log(f"paged_attention {name} f32: {fmt_times(t)} (library: "
                f"SDPA on pre-gathered K/V, gather excluded), bound "
                f"{bms * 1e3:.2f} us ({by}: {nbytes} B, {flops} flop)")
    entry = {"name": "paged_attention", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
             "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:1027",
             "shape": "decode B=8 H=12 Sq=1 D=64 page 16 width 64 f32"}
    entry.update(out["decode"])
    entry["burst"] = dict(out["burst"],
                          shape="burst B=8 H=12 Sq=1 D=64 width 16 f32")
    entry["chunk"] = dict(out["chunk"],
                          shape="chunk B=1 H=12 Sq=64 D=64 width 16 f32")
    return entry


def packed_segments(rng, b, s):
    """(B, S) segment ids of packed rows: each row holds requests of
    8..S/2 tokens back to back from slot 0 (ids 1, 2, ...), then at
    least one padding slot (id 0); and each row's used length."""
    import numpy as np

    seg = np.zeros((b, s), np.int32)
    used = np.zeros(b, np.int32)
    for r in range(b):
        pos, sid = 0, 1
        limit = s - int(rng.randint(1, max(2, s // 8)))
        while True:
            n = int(rng.randint(8, max(9, s // 2 + 1)))
            if pos + n > limit:
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
        used[r] = pos
    return seg, used


def flash_work(b, h, s, d, itemsize, seg=None, causal=False, used=None):
    """(bytes, flops) one flash call needs for THESE inputs. Without
    ``used`` (each row's kv_len): q, k, v read for every slot. With it:
    k and v read up to each row's kv_len, q for the slots that see a key
    (a packed row's used slots; every slot of a padded row), and the
    lengths. Always o and the f32 lse written for every slot, and the
    ids; 4 * D flops (QK^T and PV) per visible (query, key) pair."""
    import numpy as np

    if used is None:
        q_rows = kv_rows = b * s
        bytes_ = 0
    else:
        kv_rows = int(np.asarray(used, np.int64).sum())
        q_rows = kv_rows if seg is not None else b * s
        bytes_ = b * 4
    bytes_ += (q_rows + 2 * kv_rows + b * s) * h * d * itemsize \
        + b * h * s * 4
    if seg is not None:
        bytes_ += seg.size * 4 + (b * 4 if used is None else 0)
        pairs = 0
        for row in seg:
            _, counts = np.unique(row[row > 0], return_counts=True)
            pairs += int((counts.astype(np.int64) ** 2).sum())
    elif causal:
        pairs = b * s * (s + 1) // 2
    elif used is not None:
        pairs = s * kv_rows
    else:
        pairs = b * s * s
    return bytes_, 4 * d * h * pairs


def check_flash_attention(rng, dev, lens):
    """K1 against its plain version at the encoder path's shapes:
    B=8 rows, 12 heads, D=64, packed rows of 64/256/512 slots (with
    padding, kv_lens from it) and a dense causal 512, and at the
    training step's: the batch's 64 x 128 padded rows (``kv_lens`` =
    its valid lengths), in float32 and bfloat16. Returns the kernel's
    JSON entry (numbers of the packed 512 f32 case at top level, the
    others under ``cases``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_reference, flash_attention_with_lse)

    h, d = 12, 64
    # o within 1e-4 (f32, the same math summed in another order) plus,
    # in bf16, one unit in the last place of the plain value (both round
    # an f32 result once); lse is f32 on both sides from the same
    # rounded q and k
    cases = [("packed", 8, 64), ("packed", 8, 256), ("packed", 8, 512),
             ("causal", 8, 512), ("padded", TRAIN_B, TRAIN_S)]
    out = {}
    for kind, b, s in cases:
        seg_np = used = None
        if kind == "packed":
            seg_np, used = packed_segments(rng, b, s)
        elif kind == "padded":
            used = np.asarray(lens, np.int32)
        base = [rng.randn(b, h, s, d).astype("float32") for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.tensor(x, dtype=dtype, device=dev)
                       for x in base)
            kw = {"causal": True} if kind == "causal" else {
                "kv_lens": torch.tensor(used, device=dev)}
            if kind == "packed":
                kw["segment_ids"] = torch.tensor(seg_np, device=dev)
            o, lse = flash_attention_with_lse(q, k, v, **kw)
            ro, rlse = flash_attention_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            empty = rlse <= -1e29
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"flash {kind} {s}: non-finite o")
            if not torch.equal(lse[empty], rlse[empty]) or (
                    empty.any() and o.float()[empty].abs().max() != 0):
                raise AssertionError(f"flash {kind} {s}: rows with no "
                                     f"visible key are not exact zeros")
            name = f"{kind} B={b} S={s} {str(dtype)[6:]}"
            log(f"flash_attention {name}: max_abs_err {err:.3e} (tol "
                f"1e-4{' + 1 ulp' if dtype != torch.float32 else ''}), "
                f"lse {lse_err:.3e} (tol 1e-4), {int(empty.sum())} empty "
                f"query rows")
            if not (within_ulp(o, ro, 1e-4) and lse_err <= 1e-4):
                raise AssertionError(f"flash_attention {name}: o err "
                                     f"{err}, lse err {lse_err}")
            if dtype != torch.float32:
                out[(kind, s)]["bf16_max_abs_err"] = err
                continue
            # yardstick only (never called by the port): SDPA with the
            # same visibility as a boolean mask built outside the timing
            col = torch.arange(s, device=dev)
            if kind == "causal":
                mask = col[None, :] <= col[:, None]
            elif kind == "padded":
                mask = (col[None, :] < kw["kv_lens"].long()[:, None]
                        )[:, None, None, :]
            else:
                sg = kw["segment_ids"].long()
                mask = (sg[:, None, :, None] == sg[:, None, None, :]) \
                    & (sg[:, None, None, :] > 0)
            t = timed(lambda: flash_attention_with_lse(q, k, v, **kw),
                      lambda: flash_attention_reference(q, k, v, **kw),
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, attn_mask=mask),
                      plain_iters=10, lib_iters=20)
            nbytes, flops = flash_work(b, h, s, d, 4, seg_np,
                                       kind == "causal", used)
            # the products on the tensor cores, f32 kept by three TF32
            # terms each; the bound on CUDA cores beside it
            bms, by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
            cms, cby = bound(nbytes, flops)
            out[(kind, s)] = {
                "shape": f"{kind} B={b} H={h} S={s} D={d} f32",
                "max_abs_err": err, **t, "bound_ms": bms, "bound_by": by,
                "bound_cuda_cores_ms": cms, "bound_cuda_cores_by": cby,
                "library": "SDPA with a boolean mask"}
            log(f"flash_attention {name}: {fmt_times(t)} (library: SDPA, "
                f"boolean mask), bound {bms * 1e3:.2f} us ({by}: {nbytes} "
                f"B, {flops} flop x 3 TF32 terms; on CUDA cores "
                f"{cms * 1e3:.2f} us, {cby})")
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
             "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:568"}
    entry.update(out.pop(("packed", 512)))
    entry["cases"] = list(out.values())
    return entry


def check_layer_norm(rng, dev):
    """K3a against its plain version at the encoder path's shape:
    8 x 512 rows of 768, eps 1e-12, in float32 and bfloat16; returns
    the kernel's JSON entry (numbers of the float32 case)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    r, d, eps = 8 * 512, 768, 1e-12
    # an offset mean: a one-pass E[x^2] - mean^2 variance would show
    x0 = (rng.randn(r, d) * 0.5 + 3.0).astype("float32")
    g0, b0 = (rng.randn(d).astype("float32") for _ in range(2))
    # y within 1e-5 + 2**-20 |y| (f32, sums in another order: the mean's
    # rounding, times rstd |gamma|, does not shrink with |y|, and the
    # rest grows with it) plus, in bf16, one unit in the last place of
    # the plain value
    entry = {"name": "layer_norm", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/layer_norm.cu",
             "replaces": "mxnet_tpu/ops/pallas/layer_norm.py:89",
             "shape": f"R={r} D={d} eps={eps} f32"}
    for dtype in (torch.float32, torch.bfloat16):
        x, g, b = (torch.tensor(a, dtype=dtype, device=dev)
                   for a in (x0, g0, b0))
        y, mu, rs = layer_norm_fused(x, g, b, eps, return_stats=True)
        ry, rmu, rrs = layer_norm_reference(x, g, b, eps,
                                            return_stats=True)
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs().max().item()
        stat_err = max((mu - rmu).abs().max().item(),
                       ((rs - rrs).abs() / rrs).max().item())
        log(f"layer_norm {str(dtype)[6:]}: max_abs_err {err:.3e} (tol "
            f"1e-5 + 2**-20 |y|"
            f"{' + 1 ulp' if dtype != torch.float32 else ''}), "
            f"mean/rstd {stat_err:.3e} (tol 1e-5)")
        if not (within_ulp(y, ry, 1e-5, 2.0 ** -20) and stat_err <= 1e-5):
            raise AssertionError(f"layer_norm {dtype}: err {err}, stats "
                                 f"{stat_err}")
        if dtype != torch.float32:
            entry["bf16_max_abs_err"] = err
            continue
        t = timed(lambda: layer_norm_fused(x, g, b, eps),
                  lambda: layer_norm_reference(x, g, b, eps),
                  lambda: F.layer_norm(x, (d,), g, b, eps))
        t.update(cold_times(
            lambda *a: layer_norm_fused(*a, eps),
            lambda *a: F.layer_norm(a[0], (d,), a[1], a[2], eps),
            (x, g, b)))
        # the host's share of a call, as the encoder path makes it
        # (inference mode, no stats)
        with torch.inference_mode():
            hr = host_rounds({
                "k": lambda: layer_norm_fused(x, g, b, eps),
                "lib": lambda: F.layer_norm(x, (d,), g, b, eps)})
        t["host_us"], t["host_us_range"] = hr["k"]
        t["library_host_us"], t["library_host_us_range"] = hr["lib"]
        nbytes = 2 * r * d * 4 + 2 * d * 4
        flops = 8 * r * d
        bms, by = bound(nbytes, flops)
        entry.update({"max_abs_err": err, **t, "bound_ms": bms,
                      "bound_by": by, "library": "F.layer_norm"})
        log(f"layer_norm f32: {fmt_times(t)} (library: F.layer_norm); "
            f"{fmt_cold(t)}; host a call, median of 5 interleaved rounds "
            f"[range]: {t['host_us']:.2f} {fmt_range(t['host_us_range'])} "
            f"us, F.layer_norm {t['library_host_us']:.2f} "
            f"{fmt_range(t['library_host_us_range'])}; bound "
            f"{bms * 1e3:.2f} us ({by}: {nbytes} B, {flops} flop)")
    return entry


def cold_times(kernel, library, args):
    """:func:`cold_ms` of the kernel and the library yardstick on the
    same rotated inputs: ``cold_ms``, ``library_cold_ms`` and the
    rotation's ``cold_copies``."""
    ms, k = cold_ms(kernel, args)
    lib, _ = cold_ms(library, args)
    return {"cold_ms": ms, "library_cold_ms": lib, "cold_copies": k}


def fmt_range(r):
    return f"[{r[0]:.2f}, {r[1]:.2f}]"


def fmt_cold(t):
    return (f"cold L2 ({t['cold_copies']} copies of the inputs): device "
            f"{t['cold_ms'] * 1e3:.2f} us kernel, "
            f"{t['library_cold_ms'] * 1e3:.2f} library")


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over ``peak`` (the f32 CUDA-core rate unless
    given)."""
    t_bytes = nbytes / PEAK_HBM_BPS * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


TRAIN_B, TRAIN_S, VOCAB = 64, 128, 30522
# device ms of the first port's K3b and K4b at these rows' shapes, before
# their Hopper redesign (PERF.md, Findings: chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at 700.00 W); printed beside this run's, never compared
WAS_MS = {"layer_norm_bwd": 0.06840, "softmax_xent_bwd": 0.97009}


def train_batch(seed, b=TRAIN_B, s=TRAIN_S, vocab=VOCAB):
    """The training batch, as ``BENCH_PADDED=1`` draws it: valid lengths
    uniform in [S/2, S], ids and labels uniform over the vocabulary, one
    label per valid position; ``pos`` indexes the valid slots of the
    flattened (B * S) rows."""
    import numpy as np

    rng = np.random.RandomState(seed + 4)
    lens = rng.randint(s // 2, s + 1, b).astype(np.int32)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, int(lens.sum())).astype(np.int32)
    pos = np.concatenate([r * s + np.arange(n) for r, n in enumerate(lens)])
    return lens, ids, labels, pos


def check_flash_attention_bwd(rng, dev, lens):
    """K2 against its plain version: the training batch's 64 x 128
    padded rows (``kv_lens`` = its valid lengths), packed rows of 512
    and a dense causal 512, in float32 and bfloat16. Returns the
    kernel's JSON entry (the padded f32 case at top level)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse)

    h, d = 12, 64
    cases = [("padded", TRAIN_B, TRAIN_S), ("packed", 8, 512),
             ("causal", 8, 512)]
    out = {}
    for kind, b, s in cases:
        seg_np = used = None
        if kind == "packed":
            seg_np, used = packed_segments(rng, b, s)
        elif kind == "padded":
            used = np.asarray(lens, np.int32)
        base = [rng.randn(b, h, s, d).astype("float32") for _ in range(4)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.tensor(x, dtype=dtype, device=dev)
                           for x in base)
            kw = {"causal": True} if kind == "causal" else {
                "kv_lens": torch.tensor(used, device=dev)}
            if kind == "packed":
                kw["segment_ids"] = torch.tensor(seg_np, device=dev)
            o, lse = flash_attention_with_lse(q, k, v, **kw)
            got = flash_attention_backward(q, k, v, o, lse, do, **kw)
            delta = (do.float() * o.float()).sum(-1)
            want = flash_attention_backward_reference(q, k, v, lse, do,
                                                      delta, **kw)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            name = f"{kind} B={b} S={s} {str(dtype)[6:]}"
            # f32 sums over up to 512 keys or queries in another order,
            # plus one output ulp in bf16
            log(f"flash_attention_bwd {name}: max_abs_err {err:.3e} (tol "
                f"1e-4 + 1e-5 |g|{' + 1 ulp' if dtype != torch.float32 else ''})")
            if not all(torch.isfinite(g.float()).all() for g in got) or \
                    not all(within_ulp(g, w, 1e-4, 1e-5)
                            for g, w in zip(got, want)):
                raise AssertionError(f"flash_attention_bwd {name}: err "
                                     f"{err}")
            if dtype != torch.float32:
                out[kind]["bf16_max_abs_err"] = err
                continue
            # yardstick only (never called by the port): the backward of
            # SDPA with the same visibility as a boolean mask
            col = torch.arange(s, device=dev)
            if kind == "causal":
                mask = col[None, :] <= col[:, None]
            elif kind == "padded":
                mask = (col[None, :] < kw["kv_lens"].long()[:, None]
                        )[:, None, None, :]
            else:
                sg = kw["segment_ids"].long()
                mask = (sg[:, None, :, None] == sg[:, None, None, :]) \
                    & (sg[:, None, None, :] > 0)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ref_o = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            t = timed(lambda: flash_attention_backward(q, k, v, o, lse, do,
                                                       **kw),
                      lambda: flash_attention_backward_reference(
                          q, k, v, lse, do, delta, **kw),
                      lambda: torch.autograd.grad(ref_o, leaves, do,
                                                  retain_graph=True),
                      plain_iters=10, lib_iters=20)
            del ref_o, leaves
            nbytes, _ = flash_work(b, h, s, d, 4, seg_np, kind == "causal")
            if kind == "padded":
                pairs = h * s * int(used.astype(np.int64).sum())
            else:
                _, fwd_flops = flash_work(b, h, s, d, 4, seg_np,
                                          kind == "causal")
                pairs = fwd_flops // (4 * d)
            # read q, k, v, o, do and lse; write dq, dk, dv: the forward's
            # bytes (q, k, v, o, lse) plus do and three gradients
            nbytes += 4 * b * h * s * d * 4
            flops = 10 * d * pairs          # s, dp, dq, dk, dv products
            # on the tensor cores, f32 kept by three TF32 products each
            bms, by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
            out[kind] = {
                "shape": f"{kind} B={b} H={h} S={s} D={d} f32",
                "path": fa.backward_path(s, d),
                "max_abs_err": err, **t, "bound_ms": bms, "bound_by": by,
                "library": "SDPA backward (autograd), boolean mask"}
            log(f"flash_attention_bwd {name}: {fmt_times(t)} (kernel: "
                f"{fa.backward_path(s, d)}, delta included; library: SDPA "
                f"backward, boolean mask), bound {bms * 1e3:.2f} us ({by}: "
                f"{nbytes} B, {flops} flop x 3 TF32 terms)")
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/flash_attention_bwd.cu",
             "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:686",
             "also_replaces": ["mxnet_tpu/ops/pallas/flash_attention.py:747",
                               "mxnet_tpu/ops/pallas/flash_attention.py:775"]}
    entry.update(out.pop("padded"))
    entry["cases"] = list(out.values())
    return entry


def check_layer_norm_bwd(rng, dev):
    """K3b against its plain version at the trunk's shape: 64 x 128 rows
    of 768, eps 1e-12, float32 and bfloat16; returns the kernel's JSON
    entry (the float32 numbers)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.layer_norm import (
        layer_norm_backward, layer_norm_backward_reference,
        layer_norm_fused)

    r, d, eps = TRAIN_B * TRAIN_S, 768, 1e-12
    x0 = (rng.randn(r, d) * 0.5 + 3.0).astype("float32")
    g0, dy0 = rng.randn(d).astype("float32"), rng.randn(r, d).astype(
        "float32")
    entry = {"name": "layer_norm_bwd", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/layer_norm.cu",
             "replaces": "mxnet_tpu/ops/pallas/layer_norm.py:117",
             "shape": f"R={r} D={d} eps={eps} f32"}
    for dtype in (torch.float32, torch.bfloat16):
        x, g, dy = (torch.tensor(a, dtype=dtype, device=dev)
                    for a in (x0, g0, dy0))
        _, mu, rs = layer_norm_fused(x, g, g, eps, return_stats=True)
        dx, dg, db = layer_norm_backward(x, g, mu, rs, dy)
        rdx, rdg, rdb = layer_norm_backward_reference(x, g, mu, rs, dy)
        torch.cuda.synchronize()
        err = (dx.float() - rdx.float()).abs().max().item()
        # dgamma, dbeta: sums over 8192 rows in another order, within
        # 5e-5 of the sum of their terms' magnitudes
        xhat = (x.float() - mu[:, None]) * rs[:, None]
        red_ok = all(bool(((a - b_).abs() <= 5e-5 * t.abs().sum(0) + 1e-5)
                          .all())
                     for a, b_, t in ((dg, rdg, dy.float() * xhat),
                                      (db, rdb, dy.float())))
        red_err = max((dg - rdg).abs().max().item(),
                      (db - rdb).abs().max().item())
        log(f"layer_norm_bwd {str(dtype)[6:]}: dx max_abs_err {err:.3e} "
            f"(tol 1e-4 + 1e-5 |dx|"
            f"{' + 1 ulp' if dtype != torch.float32 else ''}), "
            f"dgamma/dbeta {red_err:.3e} (tol 5e-5 of the terms' |sum|)")
        if not (within_ulp(dx, rdx, 1e-4, 1e-5) and red_ok):
            raise AssertionError(f"layer_norm_bwd {dtype}: dx err {err}, "
                                 f"dgamma/dbeta err {red_err}")
        # no atomics: a second call gives the same bits
        again = layer_norm_backward(x, g, mu, rs, dy)
        if not all(torch.equal(a, b_) for a, b_ in zip((dx, dg, db), again)):
            raise AssertionError(f"layer_norm_bwd {dtype}: a second call "
                                 f"gave other bits")
        if dtype != torch.float32:
            entry["bf16_max_abs_err"] = err
            continue
        leaves = [t.detach().requires_grad_() for t in (x, g, g)]
        ref_y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], eps)
        t = timed(lambda: layer_norm_backward(x, g, mu, rs, dy),
                  lambda: layer_norm_backward_reference(x, g, mu, rs, dy),
                  lambda: torch.autograd.grad(ref_y, leaves, dy,
                                              retain_graph=True),
                  lib_iters=20)
        del ref_y
        # cold: the library's graph is rebuilt on each rotated copy, its
        # forward outside the window (grad of a saved graph per copy)
        graphs = {}

        def lib_bwd(x_, g_, mu_, rs_, dy_):
            key = x_.data_ptr()
            if key not in graphs:
                lv = [x_.detach().requires_grad_(), leaves[1], leaves[2]]
                graphs[key] = (F.layer_norm(lv[0], (d,), lv[1], lv[2],
                                            eps), lv)
            y_, lv = graphs[key]
            return torch.autograd.grad(y_, lv, dy_, retain_graph=True)

        t.update(cold_times(layer_norm_backward, lib_bwd,
                            (x, g, mu, rs, dy)))
        # the row kernel and the fold apart
        t["ms_by_event"] = {
            kernel_name(e): v for e, v in device_ms(
                lambda: layer_norm_backward(x, g, mu, rs, dy),
                by_kernel=True)[1].items()}
        del graphs, leaves
        # read x, dy, gamma, mean, rstd; write dx, dgamma, dbeta
        nbytes = 3 * r * d * 4 + d * 4 + 2 * r * 4 + 2 * d * 4
        flops = 11 * r * d
        bms, by = bound(nbytes, flops)
        entry.update({"max_abs_err": err, **t, "bound_ms": bms,
                      "bound_by": by,
                      "library": "F.layer_norm backward (autograd)"})
        log(f"layer_norm_bwd f32: {fmt_times(t)} (library: F.layer_norm "
            f"backward); {fmt_cold(t)}; bound {bms * 1e3:.2f} us ({by}: "
            f"{nbytes} B, {flops} flop); was "
            f"{WAS_MS['layer_norm_bwd'] * 1e3:.2f} us device; same bits "
            f"on a second call; device ms by kernel {t['ms_by_event']}")
    return entry


def check_softmax_xent(rng, dev, n):
    """K4a and K4b against their plain versions at the MLM loss's shape
    (the batch's ``n`` valid positions x 30522), float32 and bfloat16;
    returns the two kernels' JSON entries (float32 numbers)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.softmax_xent import (
        softmax_xent_backward, softmax_xent_backward_reference,
        softmax_xent_forward, softmax_xent_reference)

    v = VOCAB
    x0 = (rng.randn(n, v) * 2.0).astype("float32")
    lab = torch.tensor(rng.randint(0, v, n), dtype=torch.int32, device=dev)
    g = torch.tensor(rng.rand(n).astype("float32"), device=dev)
    src = "mxnet_tpu_torch/ops/csrc/softmax_xent.cu"
    fwd = {"name": "softmax_xent_fwd", "route": "cuda", "source": src,
           "replaces": "mxnet_tpu/ops/pallas/softmax_xent.py:89",
           "shape": f"N={n} V={v} f32"}
    bwd = {"name": "softmax_xent_bwd", "route": "cuda", "source": src,
           "replaces": "mxnet_tpu/ops/pallas/softmax_xent.py:127",
           "shape": f"N={n} V={v} f32"}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(x0, dtype=dtype, device=dev)
        loss, lse = softmax_xent_forward(x, lab)
        dx = softmax_xent_backward(x, lab, lse, g)
        rloss, rlse = softmax_xent_reference(x, lab)
        rdx = softmax_xent_backward_reference(x, lab, rlse, g)
        torch.cuda.synchronize()
        err = max((loss - rloss).abs().max().item(),
                  (lse - rlse).abs().max().item())
        derr = (dx.float() - rdx.float()).abs().max().item()
        name = str(dtype)[6:]
        # an f32 log-sum-exp over 30522 terms in another order; dx in
        # the logits' type
        log(f"softmax_xent {name}: loss/lse max_abs_err {err:.3e} (tol "
            f"1e-5 + 1e-6 |lse|), dx {derr:.3e} (tol 1e-6 + 1e-5 |dx|"
            f"{' + 1 ulp' if dtype != torch.float32 else ''})")
        if not (bool(((loss - rloss).abs() <= 1e-5 + 1e-6 * rloss.abs())
                     .all()) and within_ulp(dx, rdx, 1e-6, 1e-5)):
            raise AssertionError(f"softmax_xent {dtype}: loss err {err}, "
                                 f"dx err {derr}")
        if not torch.equal(softmax_xent_backward(x, lab, lse, g), dx):
            raise AssertionError(f"softmax_xent_bwd {dtype}: a second call "
                                 f"gave other bits")
        if dtype != torch.float32:
            fwd["bf16_max_abs_err"], bwd["bf16_max_abs_err"] = err, derr
            continue
        lab64 = lab.long()
        leaf = x.detach().requires_grad_()
        ref = F.cross_entropy(leaf, lab64, reduction="none")
        # one input of 6541 x 30522 f32 (800 MB) is 16x the L2: each
        # call finds it cold, so the rotation is that input alone
        for entry, e, fn, plain, lib, nbytes, flops, libname in (
                (fwd, err, lambda: softmax_xent_forward(x, lab),
                 lambda: softmax_xent_reference(x, lab),
                 lambda: F.cross_entropy(x, lab64, reduction="none"),
                 n * v * 4 + n * 4 + 2 * n * 4, 4 * n * v,
                 "F.cross_entropy(reduction='none') forward"),
                (bwd, derr, lambda: softmax_xent_backward(x, lab, lse, g),
                 lambda: softmax_xent_backward_reference(x, lab, lse, g),
                 lambda: torch.autograd.grad(ref, [leaf], g,
                                             retain_graph=True),
                 2 * n * v * 4 + 3 * n * 4, 4 * n * v,
                 "F.cross_entropy(reduction='none') backward (autograd)")):
            t = timed(fn, plain, lib, plain_iters=10, lib_iters=20)
            t.update(cold_times(lambda *_, f=fn: f(), lambda *_, f=lib: f(),
                                (x,)))
            bms, by = bound(nbytes, flops)
            entry.update({"max_abs_err": e, **t, "bound_ms": bms,
                          "bound_by": by, "library": libname})
            was = (f"; was {WAS_MS[entry['name']] * 1e3:.2f} us device, "
                   f"same bits on a second call"
                   if entry["name"] in WAS_MS else "")
            log(f"{entry['name']} f32: {fmt_times(t)} (library: "
                f"{libname}); {fmt_cold(t)}; bound {bms * 1e3:.2f} us "
                f"({by}: {nbytes} B, {flops} flop){was}")
        del ref, leaf
    return [fwd, bwd]


# WikiText-2 word LM (``bench.py::main_lstm``'s widths, the example's
# loop): the LSTM kernels' shapes are (T=35, N, 4 x 650)
WLM = dict(vocab=33278, emb=650, hid=650, layers=2, dropout=0.2, batch=32,
           bptt=35, lr=1.0, clip=0.25)


def lstm_close(got, want, dtype):
    """Within 1e-5 of ``want``'s scale (its largest magnitude, at least
    1) in float32, one bf16 ulp of it in bfloat16: kernel and plain
    version run the same f32 recurrence, summed in another order, and
    each rounds every h it feeds back once."""
    import math

    import torch

    scale = max(want.float().abs().max().item(), 1.0)
    tol = 1e-5 * scale if dtype == torch.float32 \
        else 2.0 ** (math.floor(math.log2(scale)) - 7)
    err = (got.float() - want.float()).abs().max().item()
    return err <= tol, err


def check_lstm(rng, dev):
    """K6a and K6b against their plain versions at the word LM's shapes
    (T=35, H=650; N=32 the example's batch, N=1024 ``bench.py``'s), in
    float32 and bfloat16, with times, the grid, the bound and cuDNN's
    LSTM layer as the yardstick; returns the two kernels' JSON entries
    (the N=32 float32 numbers at top level, N=1024 under ``large``)."""
    import torch

    from mxnet_tpu_torch.ops import lstm

    t, h = WLM["bptt"], WLM["hid"]
    src = "mxnet_tpu_torch/ops/csrc/lstm.cu"
    fwd = {"name": "lstm_fwd", "route": "cuda", "source": src,
           "replaces": "mxnet_tpu/ops/pallas/lstm.py:132"}
    # K6b is two kernels: the recurrence and the dW product after it
    bwd = {"name": "lstm_bwd", "route": "cuda", "source": src,
           "replaces": "mxnet_tpu/ops/pallas/lstm.py:175",
           "kernels": ["lstm_bwd_kernel", "lstm_bwd_dw_kernel"]}
    for n in (WLM["batch"], 1024):
        base = [rng.randn(t, n, 4 * h).astype("float32") * 0.5,
                rng.randn(4 * h, h).astype("float32") / h ** 0.5,
                rng.randn(n, h).astype("float32") * 0.5,
                rng.randn(n, h).astype("float32") * 0.5,
                rng.randn(t, n, h).astype("float32"),
                rng.randn(t, n, h).astype("float32")]
        for dtype in (torch.float32, torch.bfloat16):
            gin, w4, h0, c0, dout, dcseq = (
                torch.tensor(a, dtype=dtype, device=dev) for a in base)
            w = w4.t()                       # MXNet's (4H, H), by strides
            out, cseq, gates = lstm.lstm_forward(gin, w, h0, c0)
            want = lstm.lstm_forward_reference(gin, w, h0, c0)
            got_b = lstm.lstm_backward(gates, cseq, out, w, h0, c0, dout,
                                       dcseq)
            want_b = lstm.lstm_backward_reference(gates, cseq, out, w, h0,
                                                  c0, dout, dcseq)
            torch.cuda.synchronize()
            res_f = [lstm_close(g, r, dtype) for g, r in
                     zip((out, cseq, gates), want)]
            res_b = [lstm_close(g, r, dtype) for g, r in zip(got_b, want_b)]
            err_f = max(e for _, e in res_f)
            err_b = max(e for _, e in res_b)
            name = f"T={t} N={n} H={h} {str(dtype)[6:]}"
            tol = "1e-5" if dtype == torch.float32 else "one bf16 ulp"
            log(f"lstm {name}: forward max_abs_err {err_f:.3e}, backward "
                f"{err_b:.3e} (tol {tol} of each output's scale)")
            if not all(ok for ok, _ in res_f + res_b):
                raise AssertionError(f"lstm {name}: forward {res_f}, "
                                     f"backward {res_b}")
            if dtype != torch.float32:
                key = "bf16_max_abs_err" if n == WLM["batch"] \
                    else "large_bf16_max_abs_err"
                fwd[key], bwd[key] = err_f, err_b
                continue
            iters = 20 if n <= 64 else 5
            # yardstick only (never called by the port): one cuDNN LSTM
            # layer with the same recurrent weight; it also does the
            # input projection (x @ W_i2h^T), here x of width H
            ref = torch.nn.LSTM(h, h, device=dev)
            with torch.no_grad():
                ref.weight_hh_l0.copy_(w4)
            x = torch.tensor(rng.randn(t, n, h).astype("float32"),
                             device=dev)
            xl = x.detach().requires_grad_()
            ref_out, (ref_h, ref_c) = ref(xl, (h0[None], c0[None]))
            leaves = [xl, *ref.parameters()]
            t_f = timed(lambda: lstm.lstm_forward(gin, w, h0, c0),
                        lambda: lstm.lstm_forward_reference(gin, w, h0, c0),
                        lambda: ref(x, (h0[None], c0[None])),
                        iters=iters, plain_iters=5, lib_iters=iters,
                        warmup=2)
            t_b = timed(lambda: lstm.lstm_backward(
                            gates, cseq, out, w, h0, c0, dout, dcseq),
                        lambda: lstm.lstm_backward_reference(
                            gates, cseq, out, w, h0, c0, dout, dcseq),
                        lambda: torch.autograd.grad(
                            (ref_out, ref_c), leaves, (dout, dcseq[-1:]),
                            retain_graph=True),
                        iters=iters, plain_iters=5, lib_iters=iters,
                        warmup=2)
            # the backward's device time by event (its kernels, memsets)
            t_b["ms_by_event"] = device_ms(lambda: lstm.lstm_backward(
                gates, cseq, out, w, h0, c0, dout, dcseq), iters=iters,
                warmup=1, by_kernel=True)[1]
            del ref_out, ref_h, ref_c, leaves, xl, ref
            s = 4
            flops_f = 2 * t * n * h * 4 * h
            bytes_f = (t * n * 4 * h * 2 + 4 * h * h + 2 * n * h
                       + 2 * t * n * h) * s
            bytes_b = (t * n * 4 * h * 2 + 4 * t * n * h + 4 * h * h
                       + 2 * n * h) * s + (2 * n * h + 4 * h * h) * 4
            grid = {k: lstm.lstm_plan(n, h, dtype, bk, dev) for k, bk in
                    (("fwd", False), ("bwd", True))}
            # both directions' products run on the tensor cores: f32
            # kept by three TF32 products each, so 3 x the flops at the
            # TF32 rate
            for entry, e, tm, nbytes, bms_ops, g, libname in (
                    (fwd, err_f, t_f, bytes_f,
                     3 * flops_f / PEAK_TF32_FLOPS * 1e3, grid["fwd"],
                     "torch.nn.LSTM forward (cuDNN), input "
                     "projection included"),
                    (bwd, err_b, t_b, bytes_b,
                     3 * 2 * flops_f / PEAK_TF32_FLOPS * 1e3, grid["bwd"],
                     "torch.nn.LSTM backward (cuDNN, "
                     "autograd), input projection included")):
                bms_bytes = nbytes / PEAK_HBM_BPS * 1e3
                bms = max(bms_bytes, bms_ops)
                by = "bytes" if bms_bytes >= bms_ops else "operations"
                flops = 2 * flops_f if entry is bwd else flops_f
                nums = {"shape": f"{name}", "max_abs_err": e, **tm,
                        "bound_ms": bms, "bound_by": by, "library": libname,
                        "grid": {k: v for k, v in g.items()
                                 if k not in ("sms", "smem_limit")}}
                if n == WLM["batch"]:
                    entry.update(nums)
                else:
                    entry["large"] = nums
                log(f"{entry['name']} {name}: {fmt_times(tm)} (library: "
                    f"{libname}), bound {bms * 1e3:.2f} us ({by}: {nbytes} "
                    f"B, {flops} flop); grid {g}")
            log(f"lstm_bwd {name} device time by event (ms a call): "
                f"{t_b['ms_by_event']}")
    # K6b at N=1: what a step costs whatever the batch (grid sync,
    # phase A, the chain of loads)
    gin, w4, h0, c0, dout, dcseq = (
        torch.tensor(a, device=dev) for a in
        (rng.randn(t, 1, 4 * h).astype("float32") * 0.5,
         rng.randn(4 * h, h).astype("float32") / h ** 0.5,
         *(rng.randn(1, h).astype("float32") * 0.5 for _ in range(2)),
         *(rng.randn(t, 1, h).astype("float32") for _ in range(2))))
    w = w4.t()
    out, cseq, gates = lstm.lstm_forward(gin, w, h0, c0)
    args = (gates, cseq, out, w, h0, c0, dout, dcseq)
    res = [lstm_close(g, r, torch.float32) for g, r in
           zip(lstm.lstm_backward(*args),
               lstm.lstm_backward_reference(*args))]
    if not all(ok for ok, _ in res):
        raise AssertionError(f"lstm_bwd T={t} N=1 H={h} float32: {res}")
    ms, by_event = device_ms(lambda: lstm.lstm_backward(*args),
                             by_kernel=True)
    bwd["n1"] = {"shape": f"T={t} N=1 H={h} float32",
                 "max_abs_err": max(e for _, e in res), "ms": ms,
                 "ms_by_event": by_event}
    log(f"lstm_bwd T={t} N=1 H={h} float32: max_abs_err "
        f"{bwd['n1']['max_abs_err']:.3e} (tol 1e-5 of scale), device "
        f"{ms * 1e3:.2f} us; by event (ms a call): {by_event}")
    return [fwd, bwd]


def check_op_dispatch(seed, dev):
    """The fused ops on the calls of the op faults, on the card against
    the same op on the CPU, each call's launches counted: LayerNorm at
    D=2048 (K3a and K3b, a block a row) forward and backward, and with
    ``output_mean_var`` (the JAX op's composed math: no launch);
    attention at head_dim 256 (K1 and K2's split pair, lengths and a
    causal mask) forward and backward, and in float64 (composed: no
    launch); attention at head dims 264 and 512 (K1 and K2 over chunks
    of the head dim: 40 keys on K2's one pass, 512 on its split pair);
    paged attention (K5) at head dim 320, decode and a 64-query chunk;
    ``softmax_cross_entropy`` with float32 labels (the op casts them,
    K4a takes the call); one BPTT segment of ``gluon.rnn.LSTM`` at
    H=1500 (``word_lm.py --nhid 1500``: K6a and K6b with W's rows in
    device memory, and the dW product), forward and backward, and one of
    2 x LSTM(2500) at N=32 (157 unit groups: blocks walk two work blocks
    a step). Each
    kernel call's device time is printed. Tolerances: 1e-4 of each
    output's scale (float32 sums in another order; the LSTM's gradients
    1e-3, as the word LM's gate)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.ndarray import op_impl_nn
    from mxnet_tpu_torch.ops import launch_counts, lstm, reset_launch_counts

    from mxnet_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed + 6)
    cpu = torch.device("cpu")
    x = rng.randn(4, 33, 2048).astype("float32") * 0.5 + 1.0
    g, b = rng.randn(2048).astype("float32"), rng.randn(2048).astype("float32")
    q, k, v = (rng.randn(2, 2, 40, 256).astype("float32") for _ in range(3))
    lens = np.array([40, 9], np.int32)
    # head dims past 256: 40 keys (K2's one pass) and 512 (its split pair)
    wide = {(d, s): [rng.randn(2, 2, s, d).astype("float32")
                     for _ in range(3)]
            for d in (264, 512) for s in (40, 512)}
    wide_lens = {40: np.array([40, 9], np.int32),
                 512: np.array([512, 300], np.int32)}
    # paged attention at head dim 320: decode and a 64-query chunk over
    # histories of 5..700 tokens on 16-token pages
    paged = {}
    for sq in (1, 64):
        kvls = np.array([700, 64 + 5, 333], np.int32)
        width = -(-int(kvls.max()) // 16)
        pool = rng.randn(3 * width + 1, 2, 16, 320).astype("float32")
        paged[320, sq] = (rng.randn(3, 2, sq, 320).astype("float32"), pool,
                          rng.randn(*pool.shape).astype("float32"),
                          rng.permutation(3 * width + 1)[:3 * width]
                          .reshape(3, width).astype(np.int32), kvls)
    # and at head dims 264 and 512 (two of K5's 256-column chunks), from
    # a generator of their own so that the rows above keep their inputs
    rng_wide = np.random.RandomState(seed + 16)
    for d in (264, 512):
        for sq in (1, 64):
            kvls = np.array([700, 64 + 5, 333], np.int32)
            width = -(-int(kvls.max()) // 16)
            pool = rng_wide.randn(3 * width + 1, 2, 16, d).astype("float32")
            paged[d, sq] = (
                rng_wide.randn(3, 2, sq, d).astype("float32"), pool,
                rng_wide.randn(*pool.shape).astype("float32"),
                rng_wide.permutation(3 * width + 1)[:3 * width]
                .reshape(3, width).astype(np.int32), kvls)
    logits = rng.randn(64, 1000).astype("float32")
    labels = rng.randint(0, 1000, 64).astype("float32")
    hid, steps, rows = 1500, WLM["bptt"], 8
    seq = rng.randn(steps, rows, hid).astype("float32")
    if not lstm.lstm_plan(rows, hid, torch.float32, device=dev)["w_global"]:
        raise AssertionError("lstm plan: H=1500 f32 must keep W's rows in "
                             "device memory")
    # past one unit group an SM: 2 x LSTM(2500), N=32, a short segment
    hid_w, steps_w, rows_w = 2500, 5, WLM["batch"]
    seq_w = rng.randn(steps_w, rows_w, hid_w).astype("float32")
    plan_w = lstm.lstm_plan(rows_w, hid_w, torch.float32, True, dev)
    if plan_w["walk"] < 2:
        raise AssertionError(f"lstm plan: H={hid_w} must walk work blocks, "
                             f"got {plan_w}")

    def grads(outs, leaves):
        """outs, then the gradients of sum(out * out) over ``leaves``."""
        sum(((o.float() * o.float()).sum() for o in outs)).backward()
        return outs + [a.grad for a in leaves]

    def layer_norm_2048(t):
        leaves = [t(a, True) for a in (x, g, b)]
        return grads([op_impl_nn.layer_norm(*leaves, eps=1e-5)], leaves)

    def attention_256(t, dtype="float32"):
        leaves = [t(a.astype(dtype), True) for a in (q, k, v)]
        return grads([op_impl_nn.flash_attention_op(
            *leaves, valid_len=t(lens), causal=True)], leaves)

    def attention_wide(t, d, s):
        leaves = [t(a, True) for a in wide[d, s]]
        return grads([op_impl_nn.flash_attention_op(
            *leaves, valid_len=t(wide_lens[s]), causal=True)], leaves)

    def paged_wide(t, d, sq):
        qp, kp, vp, table, kvls = paged[d, sq]
        return [pa.paged_flash_attention(t(qp), t(kp), t(vp), t(table),
                                         t(kvls))]

    def lstm_segment(t, h=hid, xs_np=seq, layers=1):
        dev_ = t(xs_np).device
        layer = rnn.LSTM(h, num_layers=layers, input_size=h, device=dev_)
        layer.initialize(seed=seed)
        xs = t(xs_np, True)
        with autograd.record():
            out = layer(xs)
        return grads([out], [xs]) + [p.grad() for p in
                                     layer.collect_params().values()]

    # name: (call, its launches on the card)
    calls = {
        "layer_norm D=2048": (layer_norm_2048,
                              {"layer_norm": 1, "layer_norm_bwd": 1}),
        "layer_norm output_mean_var": (lambda t: list(op_impl_nn.layer_norm(
            t(x[..., :768]), t(g[:768]), t(b[:768]), eps=1e-5,
            output_mean_var=True)), {}),
        "attention head_dim 256": (attention_256, {
            "flash_attention": 1, "flash_attention_bwd": 1}),
        "attention float64": (lambda t: attention_256(t, "float64"), {}),
        **{f"attention head_dim {d} S={sl}": (
            lambda t, d=d, sl=sl: attention_wide(t, d, sl),
            {"flash_attention": 1, "flash_attention_bwd": 1})
           for d in (264, 512) for sl in (40, 512)},
        **{f"paged {'decode' if sq == 1 else 'chunk'} head_dim {d}": (
            lambda t, d=d, sq=sq: paged_wide(t, d, sq),
            {"paged_attention": 1})
           for d in (320, 264, 512) for sq in (1, 64)},
        "softmax_cross_entropy float labels": (lambda t: [
            tnd.softmax_cross_entropy(t(logits), t(labels))],
            {"softmax_xent_fwd": 1}),
        "gluon.rnn.LSTM H=1500": (lstm_segment, {
            "lstm_fwd": 1, "lstm_bwd": 1, "lstm_bwd_dw": 1}),
        f"gluon.rnn.LSTM 2 x H={hid_w} T={steps_w} N={rows_w}": (
            lambda t: lstm_segment(t, hid_w, seq_w, 2),
            {"lstm_fwd": 2, "lstm_bwd": 2, "lstm_bwd_dw": 2}),
    }
    worst, kernel_ms = {}, {}
    for name, (fn, expect) in calls.items():
        def on(device):
            def t(a, grad=False):
                return torch.tensor(a, device=device, requires_grad=grad)
            return lambda: fn(t)
        reset_launch_counts()
        got = on(dev)()
        torch.cuda.synchronize()
        moved = {k: n for k, n in launch_counts().items() if n}
        if moved != expect:
            raise AssertionError(f"op dispatch {name}: launches {moved}, "
                                 f"expected {expect}")
        want = on(cpu)()
        errs = []
        for i, (gt, w) in enumerate(zip(got, want)):
            # the LSTM's gradients (outputs past its first) as the word
            # LM's gate
            tol = 1e-3 if "LSTM" in name and i else 1e-4
            scale = max(w.abs().max().item(), 1.0)
            errs.append((gt.detach().cpu() - w.detach()).abs().max().item()
                        / scale)
            if not (torch.isfinite(gt).all() and errs[-1] <= tol):
                raise AssertionError(f"op dispatch {name}: output {i} "
                                     f"differs by {errs[-1]} of scale")
        worst[name] = max(errs)
        ms = ""
        if expect:
            # the ported kernels' device time a call (the inputs' copies
            # and the layer's set-up left out)
            _, by = device_ms(on(dev), iters=3, warmup=1, by_kernel=True)
            kernel_ms[name] = {
                kernel_name(e): t for e, t in by.items()
                if any(f in e for f in ("layer_norm", "flash_", "xent",
                                        "lstm", "paged_"))}
            ms = ", device ms a call " + json.dumps(
                {k: round(t, 4) for k, t in kernel_ms[name].items()})
        log(f"op dispatch {name}: card vs CPU max {worst[name]:.3e} of "
            f"scale, launches {moved or 'none'}{ms}")
    reset_launch_counts()
    sdpa_beside_chunks(dev, wide, wide_lens, paged, kernel_ms)
    return worst


def sdpa_beside_chunks(dev, wide, wide_lens, paged, kernel_ms):
    """Library yardsticks of the op-dispatch rows past head dim 256: one
    ``F.scaled_dot_product_attention`` call on the same inputs and masks
    (an additive float mask), its forward and its backward
    (``torch.autograd.grad`` of the forward's output with the row's head
    gradient, 2 x out) apart, beside
    K1's and K2's device time a call; the paged rows against SDPA over
    K/V already gathered to dense (the gather excluded), forward only, as
    phase 3's K5 yardstick. SDPA's times are ``queued_ms``'s (the
    profiler dropped the first memory-efficient attention kernel of
    every trace of one row), the kernels' ``device_ms``'s; f32."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for (d, s), arrs in wide.items():
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in arrs)
        lens = torch.tensor(wide_lens[s], device=dev)
        col = torch.arange(s, device=dev)
        keep = (col[None, :] <= col[:, None])[None, None] \
            & (col < lens[:, None, None, None])
        # an additive float mask, made once: a boolean one is turned
        # into one inside every call
        mask = torch.zeros(keep.shape, device=dev).masked_fill(
            ~keep, float("-inf"))

        def fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        out = fwd()
        head = (2 * out).detach()

        def fwd_bwd():
            torch.autograd.grad(fwd(), (q, k, v), head)

        f_ms = queued_ms(fwd)
        fb_ms = queued_ms(fwd_bwd)
        mine = kernel_ms[f"attention head_dim {d} S={s}"]
        k1 = sum(t for e, t in mine.items() if "flash_fwd" in e)
        k2 = sum(t for e, t in mine.items() if "flash_bwd" in e)
        rows[f"attention head_dim {d} S={s}"] = {
            "k1_ms": k1, "sdpa_fwd_ms": f_ms, "k2_ms": k2,
            "sdpa_bwd_ms": fb_ms - f_ms}
    for (d, sq), (qn, kn, vn, tn, kvn) in paged.items():
        q, kp, vp = (torch.tensor(a, device=dev) for a in (qn, kn, vn))
        tbl = torch.tensor(tn, device=dev).long()
        b, h = q.shape[:2]
        kd = torch.movedim(kp[tbl], 2, 1).reshape(b, h, -1, d)
        vd = torch.movedim(vp[tbl], 2, 1).reshape(b, h, -1, d)
        col = torch.arange(kd.shape[2], device=dev)
        row = torch.arange(sq, device=dev)
        kv = torch.tensor(kvn, device=dev).long()[:, None, None, None]
        keep = (col <= kv - sq + row[:, None]) & (col < kv)
        mask = torch.zeros(keep.shape, device=dev).masked_fill(
            ~keep, float("-inf"))
        name = f"paged {'decode' if sq == 1 else 'chunk'} head_dim {d}"
        rows[name] = {
            "k5_ms": sum(kernel_ms[name].values()),
            "sdpa_fwd_ms": queued_ms(
                lambda: F.scaled_dot_product_attention(q, kd, vd,
                                                       attn_mask=mask))}
    for name, r in rows.items():
        log(f"op dispatch {name}: device ms a call " + json.dumps(
            {k: round(t, 4) for k, t in r.items()}))
    log("op dispatch SDPA yardsticks: " + json.dumps(rows))
    return rows


def _profiler(on):
    import contextlib

    import torch

    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def report_profile(prof, wall, ranges=()):
    """Device time by kernel over the window (the 15 largest and every
    kernel of the port's own), and the device's busy share of the
    window's wall (the profiler's own overhead inflates
    the wall; read shares, not rates, from a profiled run). Only the
    device's own events count: the operators that launched them (which
    in the backward's threads carry their kernels' time too) do not,
    nor the trace's own named ``ranges``, which the trace also puts on
    the device's timeline."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in ranges),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    log(f"profile: device busy {busy:.4f} s of {wall:.4f} s wall "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    # the 15 largest, then the port's own kernels below them (those of
    # its sources' anonymous namespaces)
    for i, e in enumerate(rows):
        ours = e.key.split("(anonymous namespace)::")[0] in ("", "void ")
        if i < 15 or ours:
            log(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
                f"{e.key[:90]}")


def serve_main_path(seed, profile, dev, power_line, layers=12, new=32):
    """GPT-2-small width (``layers`` deep) through DecodeEngine, ``new``
    tokens per request; returns the launch counts of the serving run."""
    import numpy as np

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import DecodeEngine, PagedCausalLM

    t0 = time.perf_counter()
    model = PagedCausalLM(vocab=50257, units=768, layers=layers,
                          heads=12, max_len=1024, seed=seed, device=dev)
    log(f"model: GPT-2-small width, {layers} layers, "
        f"{sum(p.numel() for p in model.params.values())} params "
        f"({time.perf_counter() - t0:.1f} s to build)")
    rng = np.random.RandomState(seed)
    lens = [5, 17, 40, 64, 65, 100, 150, 200]
    prompts = [rng.randint(0, 50257, n).tolist() for n in lens]
    with DecodeEngine(model, max_rows=8, page_size=16,
                      n_pages=1024) as eng:
        t0 = time.perf_counter()
        eng.warmup()
        log(f"warmup: {time.perf_counter() - t0:.1f} s")
        eng.reset_stats()
        ops.reset_launch_counts()
        with _profiler(profile) as prof:
            t0 = time.perf_counter()
            futs = [eng.submit(p, max_new_tokens=new,
                               stream=(i % 2 == 0))
                    for i, p in enumerate(prompts)]
            streamed = {i: [part["token"]
                            for part in f.stream(timeout=600)]
                        for i, f in enumerate(futs) if i % 2 == 0}
            outs = [f.result(timeout=600).tolist() for f in futs]
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if prof is not None:
            report_profile(prof, wall)
        snap = eng.snapshot()
        for i, o in enumerate(outs):
            if len(o) != new:
                raise AssertionError(f"request {i}: {len(o)} tokens, "
                                     f"want {new}")
            if i in streamed and streamed[i] != o:
                raise AssertionError(f"request {i}: stream != result")
        iters = snap["decode"]["iterations"]
        if counts["paged_attention"] < layers * iters:
            raise AssertionError(
                f"paged_attention launched {counts['paged_attention']} "
                f"times, want >= layers x iterations = "
                f"{layers} x {iters}")
        solo_i = 5
        solo = eng.infer(prompts[solo_i], max_new_tokens=new,
                         timeout=600).tolist()
        if solo != outs[solo_i]:
            raise AssertionError(f"solo run of request {solo_i} differs "
                                 f"from its batched run: {solo} vs "
                                 f"{outs[solo_i]}")
        eng.pool.check_isolated()
    dec = snap["decode"]
    gen = sum(len(o) for o in outs)
    log(f"served {len(outs)} requests, {gen} tokens in {wall:.3f} s: "
        f"{gen / wall:.1f} tokens/s; TTFT p50 {dec['ttft']['p50_ms']} ms "
        f"p99 {dec['ttft']['p99_ms']} ms; inter-token p50 "
        f"{dec['inter_token']['p50_ms']} ms p99 "
        f"{dec['inter_token']['p99_ms']} ms; {iters} decode iterations, "
        f"{dec['prefill_chunks']} prefill chunks; launches {counts} "
        f"[{power_line}]")
    log("serving metrics: " + json.dumps(
        {"tokens_per_s": gen / wall, "wall_s": wall, "generated": gen,
         "ttft_ms": dec["ttft"], "inter_token_ms": dec["inter_token"],
         "iterations": iters, "prefill_chunks": dec["prefill_chunks"],
         "launches": counts, "card": power_line}))
    return counts


def cross_device(seed, dev):
    """Same seed, 2 layers, on the card and on the CPU."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.serving import (DecodeEngine, PagedCausalLM,
                                         PagedKVPool)

    kw = dict(vocab=50257, units=768, layers=2, heads=12, max_len=1024,
              seed=seed)
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, 50257, n).tolist() for n in (7, 70, 130)]
    toks = {}
    models = {"cuda": PagedCausalLM(device=dev, **kw),
              "cpu": PagedCausalLM(device="cpu", **kw)}
    for name, model in models.items():
        with DecodeEngine(model, max_rows=4, page_size=16,
                          n_pages=64) as eng:
            toks[name] = [eng.infer(p, max_new_tokens=8, timeout=600)
                          .tolist() for p in prompts]
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"greedy tokens differ across devices: "
                             f"{toks['cuda']} vs {toks['cpu']}")
    # teacher-forced logits through the paged path: dense prefill of a
    # prompt, then decode steps fed the same tokens on both devices
    prompt = prompts[1]
    logits = {}
    for name, model in models.items():
        pool = PagedKVPool(2, 12, 64, page_size=16, n_pages=16,
                           device=model.device, engine_id=f"x_{name}")
        pool.ensure("s", len(prompt) + 4)
        phys, off = pool.scatter_indices("s", len(prompt), 128)
        ids = np.zeros(128, np.int32)
        ids[:len(prompt)] = prompt
        _, caches = model.prefill(pool.caches, ids, len(prompt), phys, off)
        tables = pool.padded_tables(["s"], 16)
        rows = []
        for j, tok in enumerate(toks["cpu"][1][:4]):
            lg, caches = model.decode_logits(
                caches, [tok], [len(prompt) + j], tables)
            rows.append(lg.float().cpu())
        logits[name] = torch.cat(rows)
    gap = (logits["cuda"] - logits["cpu"]).abs().max().item()
    log(f"cross-device: greedy tokens identical for {len(prompts)} "
        f"prompts; teacher-forced logits max gap {gap:.3e} (atol 1e-3)")
    if not gap <= 1e-3:
        raise AssertionError(f"logits gap {gap} > 1e-3")


BERT_BASE = dict(vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512)


def encoder_requests(rng, n=48):
    """``n`` requests of 8..512 tokens; every second one has token
    type 1 on its second half."""
    import numpy as np

    reqs = []
    for i in range(n):
        toks = rng.randint(1000, 30522, int(rng.randint(8, 513)))
        tt = None
        if i % 2:
            tt = np.zeros(len(toks), np.int32)
            tt[len(toks) // 2:] = 1
        reqs.append((toks.astype(np.int32), tt))
    return reqs


def serve_encoder(seed, profile, dev, power_line, clients=8):
    """BERT-base width through ServingEngine; returns the launch counts
    of the run (warmup, traffic and solo runs)."""
    import numpy as np

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                      bert_serving_entry)
    from mxnet_tpu_torch.serving import ServingEngine

    layers = BERT_BASE["num_layers"]
    t0 = time.perf_counter()
    net = BERTModel(device=dev, seed=seed, **BERT_BASE)
    log(f"model: BERT-base width, {layers} layers, "
        f"{sum(p.numel() for p in net.parameters())} params "
        f"({time.perf_counter() - t0:.1f} s to build)")
    entry = bert_serving_entry(net)
    forwards = collections.Counter()

    def counted(ids, tt, vl, seg, pos):
        forwards[tuple(ids.shape)] += 1
        return entry(ids, tt, vl, seg, pos)

    reqs = encoder_requests(np.random.RandomState(seed + 2))
    results = [None] * len(reqs)
    eng = ServingEngine(counted, device=dev, pool="mean",
                        bucket_lens=(64, 256, 512), max_rows=8)
    with eng:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.warmup()
        log(f"warmup: {sum(forwards.values())} forwards over the shape "
            f"universe in {time.perf_counter() - t0:.1f} s")
        n_warm = sum(forwards.values())
        forwards.clear()
        eng.reset_stats()
        go = threading.Barrier(clients + 1)

        def client(c):
            go.wait()
            futs = [(i, eng.submit(*reqs[i]))
                    for i in range(c, len(reqs), clients)]
            for i, f in futs:
                results[i] = f.result(timeout=600)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        with _profiler(profile) as prof:
            go.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
        if prof is not None:
            report_profile(prof, wall)
        snap = eng.snapshot()
        batches = dict(forwards)
        forwards.clear()
        if any(r is None for r in results):
            raise AssertionError(f"{sum(r is None for r in results)} "
                                 f"requests unanswered")
        gap = 0.0
        for (toks, tt), got in zip(reqs, results):
            solo = eng.infer(toks, tt, timeout=600)
            gap = max(gap, float(np.abs(got - solo).max()))
        counts = ops.launch_counts()
    n_fwd = n_warm + sum(batches.values()) + sum(forwards.values())
    # f32 throughout; cuBLAS picks its GEMM by row count, so a batched
    # and a solo forward differ in summation order over 12 layers
    log(f"solo parity: max gap {gap:.3e} over {len(reqs)} mean-pooled "
        f"results (atol 2e-3)")
    if not gap <= 2e-3:
        raise AssertionError(f"batched vs solo gap {gap} > 2e-3")
    want = {"flash_attention": layers * n_fwd,
            "layer_norm": (2 * layers + 1) * n_fwd}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times "
                                 f"in {n_fwd} forwards, want {n}")
    lat = snap["latency"]["total"]
    toks = sum(len(t) for t, _ in reqs)
    by_shape = {f"{r}x{s}": n for (r, s), n in sorted(batches.items())}
    log(f"served {len(reqs)} requests, {toks} tokens in {wall:.3f} s: "
        f"{len(reqs) / wall:.2f} requests/s, {toks / wall:.1f} tokens/s; "
        f"latency p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} ms; packing "
        f"efficiency {snap['packing_efficiency']}; batches by rows x "
        f"row_len {by_shape}; {n_fwd} forwards ({n_warm} warmup, "
        f"{len(reqs)} solo); launches {counts} [{power_line}]")
    log("encoder serving metrics: " + json.dumps(
        {"requests_per_s": len(reqs) / wall, "tokens_per_s": toks / wall,
         "wall_s": wall, "requests": len(reqs), "tokens": toks,
         "latency_ms": lat, "packing_efficiency":
             snap["packing_efficiency"], "batches": by_shape,
         "warmup_forwards": n_warm,
         "forwards": n_fwd, "solo_max_gap": gap, "launches": counts,
         "card": power_line}))
    return counts


def cross_device_encoder(seed, dev):
    """Same seed, 2 layers at BERT-base width, one packed batch on the
    card and on the CPU (plain versions there)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.io.packing import pack_sequences

    kw = dict(BERT_BASE, num_layers=2, seed=seed)
    rng = np.random.RandomState(seed + 3)
    seqs = [rng.randint(1000, 30522, n).astype(np.int32)
            for n in (7, 70, 130, 300, 512, 33)]
    packed = pack_sequences(seqs, 512)
    arrays = (packed.data, np.zeros_like(packed.data), packed.valid_length,
              packed.segment_ids, packed.positions)
    outs = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        net = BERTModel(device=device, **kw)
        t = [torch.from_numpy(a).to(net.device) for a in arrays]
        with torch.inference_mode():
            seq, _ = net(t[0], t[1], t[2], None, t[3], t[4])
        outs[name] = seq.float().cpu().numpy()
    valid = packed.segment_ids > 0
    gap = float(np.abs(outs["cuda"] - outs["cpu"])[valid].max())
    log(f"cross-device encoder: {len(seqs)} packed sequences, max gap "
        f"{gap:.3e} over valid slots (atol 1e-3)")
    if not gap <= 1e-3:
        raise AssertionError(f"encoder gap {gap} > 1e-3")


def build_trainer(seed, dev, num_layers):
    """BERT-base width trunk (no pooler: the MLM loss never reads it)
    + ``BERTMLMHead`` with random weights from ``seed``, dropout 0, and
    a ``Trainer`` with Adam at lr 1e-4 over all their parameters."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMHead, BERTModel

    cfg = dict(BERT_BASE, num_layers=num_layers)
    net = BERTModel(dropout=0.0, attention_dropout=0.0, use_pooler=False,
                    device=dev, seed=seed, **cfg)
    head = BERTMLMHead(cfg["vocab_size"], cfg["units"], device=dev,
                       seed=seed + 1)
    params = dict(net.collect_params().items())
    params.update(head.collect_params().items())
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    return net, head, params, trainer


def to_device(batch, dev):
    import numpy as np
    import torch

    lens, ids, labels, pos = batch
    return (torch.tensor(ids, device=dev), torch.zeros(ids.shape,
                                                       dtype=torch.int32,
                                                       device=dev),
            torch.tensor(lens, device=dev), torch.tensor(pos, device=dev),
            torch.tensor(labels, device=dev), int(np.sum(lens)))


def train_step(net, head, trainer, batch):
    """One MLM step through the user's entry points; returns the loss
    tensor (shape (1,), the sum over the valid positions)."""
    from mxnet_tpu_torch import autograd, nd

    ids, tt, lens, pos, labels, n_valid = batch
    with autograd.record():
        seq = net(ids, tt, lens)
        flat = seq.reshape(-1, seq.shape[-1])[pos]   # the valid slots
        loss = nd.softmax_cross_entropy(head(flat), labels)
    loss.backward()
    trainer.step(n_valid)
    return loss


def train_main_path(seed, profile, dev, power_line, steps=10, warmup=2):
    """``train-bertbase-mlm-b64s128`` on the card; returns the launch
    counts of the measured steps."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import ops

    layers = BERT_BASE["num_layers"]
    t0 = time.perf_counter()
    net, head, params, trainer = build_trainer(seed, dev, layers)
    n_params = sum(p.data().numel() for p in params.values())
    log(f"model: BERT-base width, {layers} layers + MLM head, {n_params} "
        f"params ({time.perf_counter() - t0:.1f} s to build)")
    batch = to_device(train_batch(seed), dev)
    n_valid = batch[-1]
    for _ in range(warmup):
        train_step(net, head, trainer, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step(net, head, trainer, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item() / n_valid)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {"flash_attention": layers, "flash_attention_bwd": layers,
                "layer_norm": 2 * layers + 2,
                "layer_norm_bwd": 2 * layers + 2,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    for name, n in per_step.items():
        if counts[name] != n * steps:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{steps} steps, want {n} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    dead = []
    for name, p in params.items():
        g = p.grad()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite gradient")
        if g.abs().max().item() == 0.0:
            dead.append(name)
    if dead:
        raise AssertionError(f"all-zero gradients: {dead}")
    if profile:
        with _profiler(True) as prof:
            t0 = time.perf_counter()
            train_step(net, head, trainer, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log("training step profile:")
        report_profile(prof, wall)
    p50 = float(np.median(times))
    slots = TRAIN_B * TRAIN_S
    log(f"trained {steps} steps (+{warmup} warm-up) on {TRAIN_B} x "
        f"{TRAIN_S} slots, {n_valid} valid: step p50 {p50 * 1e3:.2f} ms, "
        f"{n_valid / p50:.1f} valid tokens/s, {slots / p50:.1f} slot "
        f"tokens/s; loss per token {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; launches {counts} "
        f"[{power_line}]")
    log("training metrics: " + json.dumps(
        {"step_ms_p50": p50 * 1e3, "step_ms": [t * 1e3 for t in times],
         "valid_tokens_per_s": n_valid / p50,
         "slot_tokens_per_s": slots / p50, "valid_tokens": n_valid,
         "loss_per_token": losses, "peak_memory_bytes": peak,
         "params": n_params, "launches": counts, "card": power_line}))
    return counts


def cross_device_train(seed, dev, steps=3):
    """Same seed, 2 layers at BERT-base width, a small batch: three Adam
    steps on the card and on the CPU (plain versions there)."""
    import numpy as np
    import torch

    batch = train_batch(seed + 5, b=4, s=32)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        net, head, params, trainer = build_trainer(seed, device, 2)
        data = to_device(batch, device)
        losses, grads = [], None
        for i in range(steps):
            losses.append(train_step(net, head, trainer, data).item())
            if i == 0:
                grads = {k: p.grad().detach().cpu().clone()
                         for k, p in params.items()}
        runs[name] = losses, grads
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    worst, worst_name = 0.0, None
    for k, g_cpu in runs["cpu"][1].items():
        gap = (runs["cuda"][1][k] - g_cpu).abs().max().item()
        scale = g_cpu.abs().max().item()
        if gap > 1e-3 * scale + 1e-7 and gap / max(scale, 1e-30) > worst:
            worst, worst_name = gap / max(scale, 1e-30), k
    log(f"cross-device training: losses {runs['cuda'][0]} (card) vs "
        f"{runs['cpu'][0]} (cpu), max relative gap {rel:.3e} (tol 1e-4); "
        f"step-1 gradients of {len(runs['cpu'][1])} parameters "
        f"{'within' if worst_name is None else 'NOT within'} 1e-3 of each "
        f"parameter's largest CPU gradient")
    if not rel <= 1e-4:
        raise AssertionError(f"training losses differ by {rel}")
    if worst_name is not None:
        raise AssertionError(f"gradient of {worst_name} differs by {worst} "
                             f"of its scale")


def build_wordlm(seed, dev, vocab, dropout):
    """``WordLM`` at 2 x 650 with Xavier weights from ``seed`` and a
    ``Trainer`` with the example's SGD at lr 1.0."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.examples.word_lm import WordLM
    from mxnet_tpu_torch.initializer import Xavier

    net = WordLM(vocab, WLM["emb"], WLM["hid"], WLM["layers"],
                 dropout=dropout, device=dev)
    net.initialize(init=Xavier(), seed=seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": WLM["lr"]})
    return net, trainer


def wordlm_data(vocab, batch, segments):
    """The example's synthetic corpus, batchified into ``batch`` rows
    long enough for ``segments`` BPTT segments."""
    from mxnet_tpu_torch.examples.word_lm import batchify, synthetic_corpus

    n = batch * (WLM["bptt"] * (segments + 1) + 2)
    return batchify(synthetic_corpus(n, vocab), batch)


def train_wordlm_main_path(seed, profile, dev, power_line, steps=20,
                           warmup=2):
    """``train-wordlm-wt2-b32t35`` on the card; returns the launch counts
    of the measured segments."""
    import gc
    import math

    import numpy as np
    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.examples.word_lm import train_segments

    gc.collect()        # earlier phases' graphs: not this path's memory
    t0 = time.perf_counter()
    net, trainer = build_wordlm(seed, dev, WLM["vocab"], WLM["dropout"])
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    data = wordlm_data(WLM["vocab"], WLM["batch"], warmup + steps + 1)
    log(f"model: word LM, vocab {WLM['vocab']}, emb {WLM['emb']}, "
        f"{WLM['layers']} x LSTM({WLM['hid']}), dropout {WLM['dropout']}, "
        f"{n_params} params ({time.perf_counter() - t0:.1f} s to build)")
    segs = train_segments(net, trainer, data, WLM["bptt"], WLM["clip"])
    for _ in range(warmup):
        next(segs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = next(segs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.double().mean().item())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    per_seg = {"lstm_fwd": WLM["layers"], "lstm_bwd": WLM["layers"],
               "lstm_bwd_dw": WLM["layers"]}
    for name, n in per_seg.items():
        if counts[name] != n * steps:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{steps} segments, want {n} per segment")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 mean {first}, "
                             f"last 5 mean {last}: {losses}")
    dead = []
    for name, p in params.items():
        g = p.grad()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite gradient")
        if g.abs().max().item() == 0.0:
            dead.append(name)
    if dead:
        raise AssertionError(f"all-zero gradients: {dead}")
    if profile:
        with _profiler(True) as prof:
            t0 = time.perf_counter()
            next(segs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log("word LM step profile:")
        report_profile(prof, wall)
    p50 = float(np.median(times))
    tokens = WLM["batch"] * WLM["bptt"]
    ppl = math.exp(float(np.mean(losses)))
    log(f"trained {steps} segments (+{warmup} warm-up) of {WLM['batch']} x "
        f"{WLM['bptt']} tokens: step p50 {p50 * 1e3:.2f} ms, "
        f"{tokens / p50:.1f} tokens/s; loss per token {losses[0]:.7f} -> "
        f"{losses[-1]:.7f} (first 5 mean {first:.7f}, last 5 mean "
        f"{last:.7f}), perplexity {ppl:.1f}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches {counts} [{power_line}]")
    log("word LM metrics: " + json.dumps(
        {"step_ms_p50": p50 * 1e3, "step_ms": [t * 1e3 for t in times],
         "tokens_per_s": tokens / p50, "loss_per_token": losses,
         "perplexity": ppl, "peak_memory_bytes": peak, "params": n_params,
         "launches": counts, "card": power_line}))
    return counts


def cross_device_wordlm(seed, dev, steps=3):
    """Same seed, 2 x 650 at vocab 10000, batch 8, bptt 35, dropout 0:
    three SGD steps of the word LM's loop on the card and on the CPU
    (plain versions there)."""
    import torch

    from mxnet_tpu_torch.examples.word_lm import train_segments

    vocab = 10000
    data = wordlm_data(vocab, 8, steps)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        net, trainer = build_wordlm(seed, device, vocab, 0.0)
        params = net.collect_params()
        losses, grads = [], None
        for i, loss in enumerate(train_segments(
                net, trainer, data, WLM["bptt"], WLM["clip"], steps)):
            losses.append(loss.double().mean().item())
            if i == 0:
                grads = {k: p.grad().detach().cpu().clone()
                         for k, p in params.items()}
        runs[name] = losses, grads
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    worst, worst_name = 0.0, None
    for k, g_cpu in runs["cpu"][1].items():
        gap = (runs["cuda"][1][k] - g_cpu).abs().max().item()
        scale = g_cpu.abs().max().item()
        if gap > 1e-3 * scale + 1e-7 and gap / max(scale, 1e-30) > worst:
            worst, worst_name = gap / max(scale, 1e-30), k
    log(f"cross-device word LM: losses {runs['cuda'][0]} (card) vs "
        f"{runs['cpu'][0]} (cpu), max relative gap {rel:.3e} (tol 1e-4); "
        f"step-1 gradients of {len(runs['cpu'][1])} parameters "
        f"{'within' if worst_name is None else 'NOT within'} 1e-3 of each "
        f"parameter's largest CPU gradient")
    if not rel <= 1e-4:
        raise AssertionError(f"word LM losses differ by {rel}")
    if worst_name is not None:
        raise AssertionError(f"gradient of {worst_name} differs by {worst} "
                             f"of its scale")


# 30 warm-up steps: at the example's lr 0.1 (momentum 0.9, no lr
# warm-up, Xavier weights) the loss falls for two steps, then climbs
# to a peak between steps 11 and 29 (8 to 33 over seeds 0-4 in f32 and
# bf16 on an H100) before it falls; the 10 measured steps come after.
RESNET = dict(network="resnet50_v1", classes=1000, batch=128, image=224,
              steps=10, warmup=30)
# steps of the main path's start that a second model must repeat
RESNET_REPEAT = 3
# H100 SXM data-sheet peak of bf16 on the tensor cores (dense)
PEAK_BF16_FLOPS = 989e12


def forward_flops(net, x):
    """FLOPs of one forward of ``net`` on ``x`` counted from its
    convolutions' and Dense layers' shapes: 2 x multiply-adds, each
    output element taking in_channels / groups x kernel taps (the
    Dense: in_units); BatchNorm, pooling and elementwise work left out.
    One predict-mode forward, no graph kept."""
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv

    total = [0]

    def count(mod, inputs, out):
        total[0] += 2 * out.numel() * (mod.weight[0].numel()
                                       if isinstance(mod, _Conv)
                                       else mod.weight.shape[1])

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, (_Conv, Dense))]
    try:
        net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resnet_profile(net, run):
    """One traced step of the ResNet path: device time by layer kind
    (CPU ops' device totals: convolutions forward and backward, the
    BatchNorms, ReLU, pooling, the Dense, the loss, the optimizer) and
    the device's busy share; BatchNorm's forward is marked by hooks for
    the trace only."""
    import torch
    from torch.autograd import DeviceType

    from mxnet_tpu_torch.gluon.nn import BatchNorm

    ranges = []

    def enter(mod, args):
        ranges.append(torch.profiler.record_function("BatchNorm.forward"))
        ranges[-1].__enter__()

    def leave(mod, args, out):
        ranges.pop().__exit__(None, None, None)

    hooks = []
    for m in net.modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(enter))
            hooks.append(m.register_forward_hook(leave))
    try:
        with _profiler(True) as prof:
            wall = run()
    finally:
        for h in hooks:
            h.remove()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # one CPU-side row each: the forward op (its device total holds the
    # kernels it launched) or the backward node's evaluate_function row
    bwd = "autograd::engine::evaluate_function: "
    kinds = {
        "conv forward": ("aten::convolution",),
        "conv backward": (bwd + "ConvolutionBackward0",),
        "BatchNorm forward": ("BatchNorm.forward",),
        "BatchNorm backward": (bwd + "_BatchNormTrainBackward",),
        "relu": ("aten::relu", bwd + "ReluBackward0"),
        "residual add": ("aten::add", bwd + "AddBackward0"),
        "max pool": ("aten::max_pool2d",
                     bwd + "MaxPool2DWithIndicesBackward0"),
        "global pool + dense": ("aten::mean", bwd + "MeanBackward1",
                                "aten::linear", bwd + "AddmmBackward0"),
        "loss": ("aten::log_softmax", bwd + "LogSoftmaxBackward0",
                 "aten::gather", bwd + "GatherBackward0"),
        "optimizer": ("optimizer.step",),
    }
    rows = {e.key: dev_us(e) / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    got = {kind: sum(rows.get(n, 0.0) for n in names)
           for kind, names in kinds.items()}
    # the device's busy time: the union of its events' intervals (cuDNN
    # may run kernels side by side); the trace's own ranges, which it
    # also puts on the device's timeline, left out
    marks = ("BatchNorm.forward", "optimizer.step")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name not in marks)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    busy = union / 1e3
    kernels = sum(self_us(e) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key not in marks) / 1e3
    got["other"] = kernels - sum(got.values())
    log(f"resnet step profile: device busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall ({100 * busy / (wall * 1e3):.1f}%, idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%), kernels {kernels:.3f} ms "
        f"summed; device ms by kind "
        + json.dumps({k: round(v, 3) for k, v in got.items()}))
    report_profile(prof, wall, marks)
    return dict(got, busy_ms=busy, kernels_ms=kernels, wall_ms=wall * 1e3)


def train_resnet_main_path(seed, profile, dev, power_line, dtype):
    """``train-resnet50-imagenet-b128`` on the card in ``dtype``
    (``examples/train_imagenet.py``'s building blocks): Xavier weights
    from ``seed``, one synthetic batch, SGD (lr 0.1, momentum 0.9, wd
    1e-4), 30 warm-up steps then 10. Gates: every loss finite and the
    10th below the 1st, every gradient finite and not all zero, the
    running statistics finite and moved, no launch of a port kernel,
    and a second model from ``seed`` repeating the first steps' losses
    bit for bit (the losses are chaotic in the weights: the loss gate
    means something only on a run that one seed fixes). Returns the
    path's metrics."""
    import gc

    import numpy as np
    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.examples import train_imagenet as ex

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()       # the whole phase launches none
    r = RESNET
    t0 = time.perf_counter()
    net, loss_fn, trainer = ex.build(r["network"], r["classes"], dev,
                                     dtype, seed)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values()
                   if p.grad_req != "null")
    stats0 = {k: p.data().detach().clone() for k, p in params.items()
              if "running" in k}
    x, y = ex.synthetic_batch(r["batch"], r["image"], r["classes"], seed,
                              dev, dtype)
    flops = 3 * forward_flops(net, x)
    log(f"model: {r['network']}, {r['classes']} classes, {dtype}, "
        f"{n_params} trained params, {len(params)} parameters with the "
        f"running statistics ({time.perf_counter() - t0:.1f} s to build)")
    t0 = time.perf_counter()
    warm = []
    for _ in range(r["warmup"]):
        _, loss = ex.train_step(net, loss_fn, trainer, x, y)
        warm.append(loss.detach().double().mean())
    warm = torch.stack(warm).tolist()
    torch.cuda.synchronize()
    log(f"warm-up: {r['warmup']} steps in {time.perf_counter() - t0:.1f} s "
        f"(the first calls' set-up included)")
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(r["steps"]):
        t0 = time.perf_counter()
        _, loss = ex.train_step(net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.double().mean().item())
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    if counts:
        raise AssertionError(f"the ResNet path launched port kernels: "
                             f"{counts}")
    if not all(np.isfinite(warm + losses)):
        raise AssertionError(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    dead = []
    for name, p in params.items():
        if p.grad_req == "null":
            continue
        g = p.grad()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite gradient")
        if g.abs().max().item() == 0.0:
            dead.append(name)
    if dead:
        raise AssertionError(f"all-zero gradients: {dead}")
    for name, before in stats0.items():
        now = params[name].data()
        if not bool(torch.isfinite(now).all()):
            raise AssertionError(f"{name}: non-finite running statistic")
        if torch.equal(now, before):
            raise AssertionError(f"{name}: running statistic did not move")
    again = _resnet_repeat(seed, dev, dtype, x, y, RESNET_REPEAT)
    if again != warm[:RESNET_REPEAT]:
        raise AssertionError(f"a second model from seed {seed} gave other "
                             f"losses: {again} vs {warm[:RESNET_REPEAT]}")
    log(f"repeat: a second model from seed {seed} gave the first "
        f"{RESNET_REPEAT} losses bit for bit")
    breakdown = None
    if profile:
        step = trainer.step

        def marked_step(batch_size):
            with torch.profiler.record_function("optimizer.step"):
                step(batch_size)

        def one_step():
            t0 = time.perf_counter()
            ex.train_step(net, loss_fn, trainer, x, y)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        trainer.step = marked_step      # the trace's range, this step only
        try:
            breakdown = resnet_profile(net, one_step)
        finally:
            del trainer.step
    p50 = float(np.median(times))
    peak_flops = PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    share = flops / p50 / peak_flops
    log(f"trained {r['steps']} steps (+{r['warmup']} warm-up) of "
        f"{r['batch']} x 3 x {r['image']}^2 in {dtype}: step p50 "
        f"{p50 * 1e3:.2f} ms, {r['batch'] / p50:.1f} images/s; "
        f"{flops / 1e12:.4f} TFLOP a step (conv + dense, forward x 3): "
        f"{flops / p50 / 1e12:.2f} TFLOP/s, {100 * share:.2f}% of "
        f"{peak_flops / 1e12:.0f} TFLOP/s; loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; peak memory {peak / 2 ** 30:.3f} GiB "
        f"[{power_line}]")
    metrics = {"dtype": dtype, "step_ms_p50": p50 * 1e3,
               "step_ms": [t * 1e3 for t in times],
               "images_per_s": r["batch"] / p50, "step_flops": flops,
               "tflops_per_s": flops / p50 / 1e12,
               "peak_share": share, "peak_flops": peak_flops,
               "loss": losses, "warmup_loss": warm,
               "peak_memory_bytes": peak,
               "params": n_params, "profile_ms": breakdown,
               "card": power_line}
    log("resnet metrics: " + json.dumps(metrics))
    del net, trainer, x, y
    return metrics


def _resnet_repeat(seed, dev, dtype, x, y, steps):
    """The first ``steps`` mean losses of a second model built from
    ``seed`` as the main path builds it, on the main path's batch."""
    import torch

    from mxnet_tpu_torch.examples import train_imagenet as ex

    r = RESNET
    net, loss_fn, trainer = ex.build(r["network"], r["classes"], dev,
                                     dtype, seed)
    losses = [ex.train_step(net, loss_fn, trainer, x, y)[1].detach()
              .double().mean() for _ in range(steps)]
    return torch.stack(losses).tolist()


def _resnet_steps(seed, device, dtype, batch, steps, perturb=0.0):
    """``steps`` SGD steps of ``resnet50_v1`` from ``seed`` in ``dtype``
    on a synthetic batch (each pixel times ``1 + perturb * N(0, 1)``
    from ``seed`` where ``perturb`` is set): the mean losses, the step-1
    gradients and the running statistics after the last step, on the
    host."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.examples import train_imagenet as ex

    r = RESNET
    net, loss_fn, trainer = ex.build(r["network"], r["classes"], device,
                                     "float32", seed)
    net.cast(dtype)
    x, y = ex.synthetic_batch(batch, r["image"], r["classes"], seed + 7,
                              device, dtype)
    if perturb:
        noise = np.random.RandomState(seed).standard_normal(x.shape)
        x = x * (1.0 + perturb * torch.from_numpy(noise).to(x))
    params = net.collect_params()
    losses, grads = [], None
    for i in range(steps):
        _, loss = ex.train_step(net, loss_fn, trainer, x, y)
        losses.append(loss.double().mean().item())
        if i == 0:
            grads = {k: p.grad().detach().double().cpu()
                     for k, p in params.items() if p.grad_req != "null"}
    stats = {k: p.data().detach().double().cpu()
             for k, p in params.items() if "running" in k}
    return losses, grads, stats


def _resnet_gaps(a, b):
    """(worst loss gap relative, worst step-1 gradient gap of scale and
    its parameter, worst running-statistic gap of scale and its tensor)
    of run ``a`` against run ``b``. A convolution bias that feeds a
    BatchNorm (the bottlenecks' 1x1 biases) has a zero gradient in exact
    arithmetic and holds rounding noise on any device; its scale is the
    largest gradient of the model's BatchNorm betas in ``b``."""
    rel = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    beta = max(g.abs().max().item() for k, g in b[1].items()
               if k.endswith("_beta"))
    grad = max(((a[1][k] - g).abs().max().item()
                / max(beta if "conv2d" in k and k.endswith("_bias")
                      else g.abs().max().item(), 1e-30), k)
               for k, g in b[1].items())
    stat = max(((a[2][k] - t).abs().max().item()
                / max(t.abs().max().item(), 1e-30), k)
               for k, t in b[2].items())
    return rel, grad, stat


def cross_device_resnet(seed, dev, steps=2, batch=4):
    """``resnet50_v1`` from the same seed at batch 4, 224 x 224, two SGD
    steps on the card and on the CPU. Gated in float64 (every layer,
    BatchNorm's statistics too, computes in float64): mean losses within
    1e-4 relative, step-1 gradients within 1e-3 of each parameter's
    largest CPU gradient, running statistics within 1e-4 of each
    tensor's largest magnitude. In float32 only the step-1 losses are
    gated (1e-4): the step-1 gradients of this model and batch move by
    up to tens of percent of scale between two correct float32 runs
    that round otherwise, which the float32 CPU run shows against
    itself with its oneDNN convolutions turned off (printed beside the
    card's gaps); the loss after a step at lr 0.1 inherits that. The
    cause is the model's conditioning, not the rounding: a float64 run
    on the card whose pixels move by 1e-7 relative (float32's rounding
    is 6e-8) is printed against the unmoved one."""
    import torch

    cpu = torch.device("cpu")
    runs = {}
    for dtype in ("float64", "float32"):
        for name, device in (("cuda", dev), ("cpu", cpu)):
            runs[name, dtype] = _resnet_steps(seed, device, dtype, batch,
                                              steps)
    runs["cuda-moved", "float64"] = _resnet_steps(seed, dev, "float64",
                                                  batch, steps, perturb=1e-7)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        runs["cpu-native", "float32"] = _resnet_steps(seed, cpu, "float32",
                                                      batch, steps)
    finally:
        torch.backends.mkldnn.enabled = prev
    gaps = {}
    for a, b in ((("cuda", "float64"), ("cpu", "float64")),
                 (("cuda", "float32"), ("cpu", "float32")),
                 (("cpu-native", "float32"), ("cpu", "float32")),
                 (("cuda-moved", "float64"), ("cuda", "float64"))):
        gaps[a] = _resnet_gaps(runs[a], runs[b])
        rel, (grad, gname), (stat, sname) = gaps[a]
        log(f"cross-device resnet {a[0]} vs {b[0]}, {a[1]}: losses "
            f"{runs[a][0]} vs {runs[b][0]}, max relative gap {rel:.3e}; "
            f"step-1 gradients of {len(runs[b][1])} parameters within "
            f"{grad:.3e} of scale (worst {gname}); running statistics of "
            f"{len(runs[b][2])} tensors within {stat:.3e} (worst {sname})")
    rel, (grad, gname), (stat, sname) = gaps["cuda", "float64"]
    if not rel <= 1e-4:
        raise AssertionError(f"resnet float64 losses differ by {rel}")
    if not grad <= 1e-3:
        raise AssertionError(f"resnet float64 gradient of {gname} differs "
                             f"by {grad} of its scale")
    if not stat <= 1e-4:
        raise AssertionError(f"resnet float64 running statistic {sname} "
                             f"differs by {stat} of its scale")
    first = abs(runs["cuda", "float32"][0][0] - runs["cpu", "float32"][0][0]) \
        / abs(runs["cpu", "float32"][0][0])
    if not first <= 1e-4:
        raise AssertionError(f"resnet float32 step-1 losses differ by "
                             f"{first}")
    log(f"cross-device resnet: float64 gates hold (losses 1e-4, "
        f"gradients 1e-3, running statistics 1e-4), float32 step-1 "
        f"losses within {first:.3e} (tol 1e-4)")


def train_mnist_main_path(seed, dev, power_line):
    """``train-mnist-mlp-b64``: ``examples/mnist_gluon.py`` at its
    defaults (synthetic 60000, batch 64, Adam 1e-3, 5 epochs, shuffled
    ``DataLoader``) on the card; its own gate (accuracy > 0.8) and no
    launch of a port kernel."""
    import gc

    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.examples import mnist_gluon

    gc.collect()
    args = mnist_gluon.parse_args(["--seed", str(seed)])
    args.device = str(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = mnist_gluon.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    if counts:
        raise AssertionError(f"the MNIST path launched port kernels: "
                             f"{counts}")
    if not res["accuracy"] > 0.8:
        raise AssertionError(f"MNIST did not converge: {res}")
    rates = [e["samples_per_s"] for e in res["epochs"]]
    log(f"mnist: {args.epochs} epochs of {args.samples} in {wall:.2f} s "
        f"(set-up included), samples/s by epoch {[round(v, 1) for v in rates]}"
        f", accuracy {res['accuracy']:.4f} [{power_line}]")
    log("mnist metrics: " + json.dumps(dict(res, wall_s=wall,
                                            card=power_line)))
    return res


# -- phase 13: the JAX package's own scripts, unmodified, on the card ------
REF_WLM = dict(vocab=10000, tokens=200000, batch=32, bptt=35, epochs=2,
               layers=2)
RESUME_STEPS = (5, 5)           # MLP: steps before the save, steps after
RESUME_SEGMENTS = (3, 3)        # word LM: segments before and after


def ref_wordlm_segments():
    """Segments an epoch of ``example/word_lm.py`` at its defaults:
    ``range(0, n - 1 - bptt, bptt)`` over ``n = tokens // batch``."""
    n = REF_WLM["tokens"] // REF_WLM["batch"]
    return len(range(0, n - 1 - REF_WLM["bptt"], REF_WLM["bptt"]))


def run_reference_script(script, args, timeout):
    """``python -m mxnet_tpu_torch.examples.run_reference SCRIPT ARGS``
    on the card in a child process; returns ``(lines, stamps, counts,
    wall)``: its standard output, each line's arrival in seconds after
    the start, and the launch counts it printed last. Fails unless the
    script exits 0 (its own assertions held)."""
    import tempfile

    cmd = [sys.executable, "-m", "mxnet_tpu_torch.examples.run_reference",
           os.path.join(HERE, script), *args]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        lines, stamps = [], []
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                stamps.append(time.perf_counter() - t0)
            rc = proc.wait()
        finally:
            timer.cancel()
        err.seek(0)
        tail = err.read()[-3000:]
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{script} {args} exited {rc}:\n"
                             + "\n".join(lines[-20:]) + "\n" + tail)
    counts = json.loads(lines[-1])["launch_counts"]
    return lines, stamps, counts, wall


def _epoch_lines(lines, stamps, key):
    rows = [(s, line) for s, line in zip(stamps, lines)
            if line.startswith("epoch ") and key in line]
    secs = [b[0] - a[0] for a, b in zip(rows, rows[1:])]
    return [line for _, line in rows], [rows[0][0]] + secs if rows else []


# The script's own optimizer for ``--quick``. Its default, SGD at lr
# 1.0, scales each step by 1 / (bptt * batch) on top of a loss already
# averaged over the bptt steps: an lr of 1/35 per token, under which
# neither package learns in 2 epochs (the JAX package's script fails
# its own assertion there too).
REF_WLM_ARGS = ["--optimizer", "adam", "--lr", "0.002"]


def reference_word_lm(power_line):
    """``example/word_lm.py`` at its default widths, data and schedule
    with ``REF_WLM_ARGS`` through the runner: its own gate (perplexity
    below vocab / 2), and K6a/K6b launched exactly 2 + 2 + 2 times a
    segment."""
    lines, stamps, counts, wall = run_reference_script(
        "example/word_lm.py", REF_WLM_ARGS, timeout=600)
    segs = ref_wordlm_segments() * REF_WLM["epochs"]
    want = {k: REF_WLM["layers"] * segs
            for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw")}
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"example/word_lm.py launches {got}, want "
                             f"{want} ({segs} segments)")
    epochs, secs = _epoch_lines(lines, stamps, "perplexity")
    ppl = [float(e.split("perplexity ")[1].split()[0]) for e in epochs]
    log(f"reference word_lm.py {' '.join(REF_WLM_ARGS)}: perplexity by "
        f"epoch {ppl} (vocab "
        f"{REF_WLM['vocab']}); seconds by epoch {[round(s, 2) for s in secs]}"
        f" (epoch 0 from the child's start, set-up included); "
        f"{ref_wordlm_segments()} segments an epoch; launches {got}; "
        f"wall {wall:.1f} s [{power_line}]")
    return {"args": REF_WLM_ARGS, "perplexity": ppl, "epoch_s": secs,
            "launches": got, "wall_s": wall}


def _mlp(lib_nn):
    net = lib_nn.HybridSequential()
    net.add(lib_nn.Flatten(), lib_nn.Dense(256, activation="relu"),
            lib_nn.Dense(128, activation="relu"), lib_nn.Dense(10))
    return net


def reference_mnist(dev, power_line, tmp):
    """``example/mnist_gluon.py --epochs 2 --save``: its own gate
    (accuracy > 0.8); the ``.params`` it wrote load into a fresh MLP on
    the card and on the CPU (the card's forward of those weights is the
    trained net's logits), which agree within 1e-5 of scale on a fixed
    batch; its ``.states`` load into a fresh Trainer and take a step."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn

    prefix = os.path.join(tmp, "mnist")
    lines, stamps, counts, wall = run_reference_script(
        "example/mnist_gluon.py", ["--epochs", "2", "--save", prefix],
        timeout=600)
    if any(counts.values()):
        raise AssertionError(f"the MNIST script launched port kernels: "
                             f"{counts}")
    epochs, secs = _epoch_lines(lines, stamps, "accuracy")
    x = np.random.RandomState(11).rand(64, 1, 28, 28).astype(np.float32)
    logits = {}
    for where, ctx in (("card", mx.Context.of(dev)), ("cpu", mx.cpu())):
        with ctx:
            net = _mlp(nn)
            net.load_parameters(prefix + ".params")
            logits[where] = net(
                mx.nd.array(x)).asnumpy().astype(np.float64)
    scale = max(1.0, float(np.abs(logits["cpu"]).max()))
    gap = float(np.abs(logits["card"] - logits["cpu"]).max()) / scale
    if not gap <= 1e-5:
        raise AssertionError(f"MNIST .params: card vs CPU logits differ by "
                             f"{gap:.3g} of scale")
    with mx.Context.of(dev):
        net = _mlp(nn)
        net.load_parameters(prefix + ".params")
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        trainer.load_states(prefix + ".states")
        states = trainer._updater.states
        if len(states) != 6 or not all(
                m.device == dev and v.device == dev
                for m, v in states.values()):
            raise AssertionError(f"MNIST .states: {len(states)} states, "
                                 f"want 6 on the card")
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x)), mx.nd.zeros((64,)))
        loss.backward()
        trainer.step(64)
        if not np.isfinite(loss.mean().asscalar()):
            raise AssertionError("MNIST: a step after load_states gave a "
                                 "non-finite loss")
    log(f"reference mnist_gluon.py: {epochs}; seconds by epoch "
        f"{[round(s, 2) for s in secs]} (epoch 0 from the child's start, "
        f"set-up included); .params card vs CPU logits {gap:.3g} of scale; "
        f".states: {len(states)} Adam states loaded on the card, one step "
        f"taken; wall {wall:.1f} s [{power_line}]")
    return {"epochs": epochs, "epoch_s": secs, "logit_gap": gap}


def _resume_mlp(dev, mode, ckpt):
    """The MNIST MLP (deferred widths, Xavier, Adam 1e-3) on fixed
    batches of the example's data: mode ``a`` takes RESUME_STEPS[0]
    steps, saves, takes RESUME_STEPS[1] more; mode ``b`` loads the save
    and takes the same last steps. Returns the final ``.params``
    bytes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer
    from mxnet_tpu_torch.examples.mnist_gluon import synthetic_mnist
    from mxnet_tpu_torch.gluon import nn

    k, m = RESUME_STEPS
    x, y = synthetic_mnist(64 * (k + m))
    with mx.Context.of(dev):
        net = _mlp(nn)
        net.initialize(init=initializer.Xavier(), seed=3)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        if mode == "b":
            net.load_parameters(ckpt + ".params")
            trainer.load_states(ckpt + ".states")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for i in range(k + m) if mode == "a" else range(k, k + m):
            xb = mx.nd.array(x[64 * i:64 * (i + 1)])
            yb = mx.nd.array(y[64 * i:64 * (i + 1)])
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(64)
            if mode == "a" and i == k - 1:
                net.save_parameters(ckpt + ".params")
                trainer.save_states(ckpt + ".states")
    return mx.nd.save_bytes(dict(net.named_parameters()))


def _resume_wordlm(dev, mode, ckpt, vocab=REF_WLM["vocab"]):
    """The word LM at the example's defaults (vocab 10000, 2 x 650,
    bptt 35, batch 32, SGD lr 1.0, clip 0.25), dropout 0: mode ``a``
    trains RESUME_SEGMENTS[0] segments, saves the weights, the states
    file and the carried hidden states, trains RESUME_SEGMENTS[1] more;
    mode ``b`` loads them and trains the same last segments. Returns
    the final ``.params`` bytes."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.examples.word_lm import (WordLM, batchify,
                                                  synthetic_corpus)
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    from mxnet_tpu_torch.initializer import Xavier

    k, m = RESUME_SEGMENTS
    bptt, batch = REF_WLM["bptt"], REF_WLM["batch"]
    data = torch.as_tensor(batchify(synthetic_corpus(
        batch * (bptt * (k + m) + 2), vocab), batch), device=dev).long()
    net = WordLM(vocab, 650, 650, REF_WLM["layers"],
                 dropout=0.0, device=dev)
    net.initialize(init=Xavier(), seed=4)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    states = net.begin_state(batch, dev)
    if mode == "b":
        net.load_parameters(ckpt + ".params")
        trainer.load_states(ckpt + ".states")
        states = [s.as_subclass(torch.Tensor) for s in
                  mx.nd.load(ckpt + ".hidden.params", ctx=dev)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    for s in range(k + m) if mode == "a" else range(k, k + m):
        i = s * bptt
        xb, yb = data[:, i:i + bptt], data[:, i + 1:i + 1 + bptt]
        states = [h.detach() for h in states]
        with autograd.record():
            logits, states = net(xb, states)
            loss = loss_fn(logits, yb)
        autograd.backward(loss)
        clip_global_norm([p.grad() for p in params], 0.25 * bptt * batch)
        trainer.step(bptt * batch)
        if mode == "a" and s == k - 1:
            net.save_parameters(ckpt + ".params")
            trainer.save_states(ckpt + ".states")
            mx.nd.save(ckpt + ".hidden.params", [h.detach() for h in states])
    return mx.nd.save_bytes(dict(net.named_parameters()))


RESUMERS = {"mlp": _resume_mlp, "wordlm": _resume_wordlm}


def resume_child(spec):
    """``--resume-child``: the ``b`` leg of one resume check in a fresh
    process; writes the final ``.params`` bytes to ``spec['out']``."""
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(spec["device"])
    payload = RESUMERS[spec["model"]](dev, "b", spec["ckpt"], **spec["kw"])
    with open(spec["out"], "wb") as f:
        f.write(payload)
    return 0


def resume_on_the_card(dev, power_line, tmp):
    """Train, save, train on (this process); a fresh process loads the
    save and takes the same steps. The MLP's final weights must be equal
    bit for bit; the word LM's too when its own run repeats bit for bit
    (an ``a`` leg run twice), else within 1e-6 relative."""
    import numpy as np

    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    children, finals = {}, {}
    kws = {"mlp": {}, "wordlm": {"vocab": REF_WLM["vocab"]}}
    for model, fn in RESUMERS.items():
        ckpt = os.path.join(tmp, f"resume_{model}")
        finals[model] = fn(dev, "a", ckpt, **kws[model])
        spec = {"model": model, "ckpt": ckpt, "out": ckpt + ".b.params",
                "device": str(dev), "kw": kws[model]}
        children[model] = (spec, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--resume-child",
             json.dumps(spec)], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    repeat = RESUMERS["wordlm"](dev, "a", os.path.join(tmp, "repeat"),
                                **kws["wordlm"])
    verdicts = {}
    for model, (spec, proc) in children.items():
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"resume child {model} exited "
                                 f"{proc.returncode}:\n{out[-3000:]}")
        with open(spec["out"], "rb") as f:
            resumed = f.read()
        if resumed == finals[model]:
            verdicts[model] = "bit for bit"
            continue
        if model == "mlp" or repeat == finals["wordlm"]:
            raise AssertionError(f"resume {model}: the resumed run's "
                                 f"weights differ from the uninterrupted "
                                 f"run's")
        a = mx.nd.load_bytes(finals[model], ctx="cpu")
        b = mx.nd.load_bytes(resumed, ctx="cpu")
        rel = max(float(np.abs(a[n].asnumpy() - b[n].asnumpy()).max())
                  / max(float(np.abs(a[n].asnumpy()).max()), 1e-30)
                  for n in a)
        if not rel <= 1e-6:
            raise AssertionError(f"resume {model}: {rel:.3g} relative")
        verdicts[model] = f"within {rel:.3g} relative (the run itself " \
                          f"does not repeat bit for bit)"
    log(f"resume on the card: MLP {RESUME_STEPS[0]} + {RESUME_STEPS[1]} "
        f"Adam steps: {verdicts['mlp']}; word LM (vocab "
        f"{REF_WLM['vocab']}, 2 x 650, dropout 0) {RESUME_SEGMENTS[0]} + "
        f"{RESUME_SEGMENTS[1]} SGD segments: {verdicts['wordlm']} (an "
        f"uninterrupted run repeats bit for bit: "
        f"{repeat == finals['wordlm']}); {time.perf_counter() - t0:.1f} s "
        f"[{power_line}]")
    return verdicts


def reference_scripts(dev, power_line):
    """Phase 13 (module docstring)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ref_scripts_") as tmp:
        wlm = reference_word_lm(power_line)
        mnist = reference_mnist(dev, power_line, tmp)
        resume = resume_on_the_card(dev, power_line, tmp)
    return {"word_lm": wlm, "mnist": mnist, "resume": resume}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and test inputs")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving windows and one step of each "
                         "training path with torch.profiler (device time "
                         "by kernel, busy share)")
    ap.add_argument("--resume-child", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        print("chip_smoke.py: the mxnet_tpu_torch package is not beside "
              "this script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if args.resume_child:       # phase 13's fresh process, on its device
        return resume_child(json.loads(args.resume_child))
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.ops import _build

    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    power_line = smi[dev.index].strip()
    log(f"device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {power_line}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {_build.SOURCES}")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rng = np.random.RandomState(args.seed)
    lens = train_batch(args.seed)[0]
    entries = [check_paged_attention(rng, dev),
               check_flash_attention(rng, dev, lens),
               check_layer_norm(rng, dev),
               check_flash_attention_bwd(rng, dev, lens),
               check_layer_norm_bwd(rng, dev),
               *check_softmax_xent(rng, dev, int(lens.sum())),
               *check_lstm(rng, dev)]
    check_op_dispatch(args.seed, dev)
    # each path's launches, counted from 0 over its own run
    decode = serve_main_path(args.seed, args.profile, dev, power_line)
    encoder = serve_encoder(args.seed, args.profile, dev, power_line)
    train = train_main_path(args.seed, args.profile, dev, power_line)
    wordlm = train_wordlm_main_path(args.seed, args.profile, dev,
                                    power_line)
    # the vision paths: no port kernel on them (cuDNN and torch's own)
    for dtype in ("float32", "bfloat16"):
        train_resnet_main_path(args.seed, args.profile, dev, power_line,
                               dtype)
    train_mnist_main_path(args.seed, dev, power_line)
    # the JAX package's own scripts through the runner, then resume
    reference_scripts(dev, power_line)
    for e in entries:
        name = e["name"]
        if name == "lstm_fwd":
            e["launches"] = wordlm[name]
        elif name == "lstm_bwd":
            e["launches"] = wordlm[name]
            e["launches_by_kernel"] = {
                k: wordlm[k] for k in ("lstm_bwd", "lstm_bwd_dw")}
        elif name == "paged_attention":
            e["launches"] = decode[name]
        elif name in ("flash_attention", "layer_norm"):
            # forward kernels of both the encoder and the training path
            e["launches"] = encoder[name]
            e["launches_by_path"] = {"encoder": encoder[name],
                                     "train": train[name]}
        else:
            e["launches"] = train[name]
        e["card"] = power_line
    cross_device(args.seed, dev)
    cross_device_encoder(args.seed, dev)
    cross_device_train(args.seed, dev)
    cross_device_wordlm(args.seed, dev)
    cross_device_resnet(args.seed, dev)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
