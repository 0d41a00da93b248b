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
   ``DecodeEngine`` serves 8 greedy requests, each model step a CUDA
   graph per shape (as the JAX model's steps are ``jax.jit``s);
   results, streams, solo parity and the kernel launch counts (K5
   exactly layers x (decode iterations + prefill chunks)) are checked,
   serving metrics printed;
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
    1e-6 relative only if its own run does not repeat bit for bit);
14. ``mx.nd`` and user HybridBlocks: ``nd.LayerNorm``,
    ``nd.flash_attention``, ``nd.softmax_cross_entropy`` and ``nd.RNN``
    on CUDA NDArrays at the main paths' shapes (the training batch's
    64 x 128 x 768 rows, its 64 x 12 x 128 x 64 heads with its valid
    lengths, its valid positions x 30522 logits; the word LM's
    T=35, N=32, 2 x LSTM(650)), forward and backward, against the op
    functions on plain tensors: the same bits and exactly 1 + 1
    launches each (the RNN 2 + 2 + 2); every op case of
    ``tests/nd_op_cases.py`` on the card and on the CPU in float32
    (outputs within ``test_utils``' float32 tolerances, integer,
    comparison and ordering results exact); then
    ``mxnet_tpu_torch/examples/hybrid_bert.py`` (a BERT-base trunk and
    MLM head written in F-ops) with the weights of phase 7's model zoo
    pair: step-1 loss within 1e-5 relative and gradients within 1e-3
    of scale of the model zoo's, then phase 7's batch, 2 warm-up and 10
    Adam steps at lr 1e-4 with phase 7's gates (12 + 12, 26 + 26, 1 + 1
    launches a step), its step p50 and valid tokens/s printed beside
    phase 7's p50; and the F-op model at 2 layers card vs CPU as phase
    9 holds the model zoo's (losses 1e-4 relative, step-1 gradients
    1e-3 of scale);
15. hybridize: the paths again as CUDA graphs (``HybridBlock.
    hybridize``, the decode model's step graphs, ``engine.chain_steps``),
    beside their eager runs: the decode burst of phase 5 (a graph per
    bucket) beside the same model with its steps' bodies called
    directly (greedy streams of both equal to phase 5's token for
    token);
    the encoder burst of phase 6 through ``bert_serving_entry(...,
    hybridize=True)`` (every batch's output equal to the eager entry's
    on the same batch to the bit, exactly 12 + 25 launches a forward,
    no capture after the warm-up); BERT-base MLM (phase 7's trunk and
    head, each a forward and a backward graph) and the F-op BERT-base
    (phase 14's model, one pair of graphs): step 1's loss and gradients
    against the eager model's (bit for bit, or within 1e-6 relative and
    1e-5 of scale, said which), then 2 + 10 Adam steps with phase 7's
    gates; the word LM at its widths, dropout 0 (embedding, LSTM and
    decoder each a graph): 6 segments' losses and weights equal to the
    eager model's to the bit, K6a/K6b and the dW kernel 2 + 2 + 2 a
    segment, every one a replay; ``chain_steps`` of 10 momentum-SGD
    steps of an MLP at the MNIST example's widths, equal to 200 single
    steps to the bit; the vision examples' models with their
    ``hybridize()`` undone (ResNet-50 f32 and bf16 step p50, an MNIST
    epoch), beside phases 10 and 11, which now run graphed; every
    running mean and variance of the graphed ResNet-50 equal to the
    eager one's to the bit after 13 steps. Every kernel K1-K6 must have
    launched inside a graph replay (hard gate). Rates, latencies,
    capture times and the memory the graphs hold (BERT-base MLM also
    at a second training shape, b32s128) are printed beside the eager
    ones; step 1 of each BERT side is repeated, to tell a difference of
    the graph from the run-to-run spread of eager; then, after every
    timed run, profiled bursts (decode, encoder) and profiled training
    steps (BERT-base MLM) of both for the busy shares, the graphed
    step's kernels in the trace held against its replayed launch
    counts. The empty graphs captured in the run are named;
16. Wide&Deep and row_sparse, which launch no port kernel (gate:
    ``ops.launch_counts()`` all 0 over the phase): the cell
    ``train-widedeep-criteo-b1024`` (``examples/wide_deep.py``'s
    building blocks: ``wide_deep()`` at wide_dim 100000, 26 fields of
    10000 ids, embed 16, MLP 256-128-64-2, Xavier weights from
    ``--seed``, one synthetic batch of 1024, Adam 1e-3), 3 warm-up + 20
    steps eager, then hybridized (forward and backward graphs) twice:
    the mean of the last 5 losses below that of the first 5, every
    gradient finite and not all zero (both tables and the MLP),
    captures in the warm-up and none after, the second graphed model
    equal to the first bit for bit and the graphed losses within 1e-6
    relative of eager's (bit for bit said), five profiled steps of each
    (busy share; the graphed trace holds the tables' ``segment_reduce``
    kernels with no host call of it: the embedding backward replays
    inside the graph); the per-field layout with the fused model's
    weights gives its output and gradients within 1e-6 of scale; card
    vs CPU at wide_dim 5000 and fields of 500 (step-1 loss and three
    Adam steps' losses within 1e-4 relative, step-1 gradients within
    1e-3 of scale, phase 9's gates); ``cast_storage``, ``retain``,
    ``dot(csr, dense)`` and ``dot(csr.T, dense)``, ``row_sparse_pull``
    to a dense and a row_sparse destination and row_sparse pushes with
    repeated ids through SGD, momentum, Adam and AdaGrad on the card
    against the CPU (moves exact, sums within 1e-6 of scale, a second
    card run bit for bit, rows not pushed unchanged); then
    ``example/wide_deep.py`` and ``example/sparse_linear.py``
    unmodified at their defaults through ``run_reference`` in child
    processes (their own gates: accuracy > 0.65 and > 0.8). Step p50 and
    examples/s eager and graphed, busy shares, peak memory and the
    sparse-linear step time printed;
17. the symbolic API: the word LM as an ``mx.sym`` graph
    (``train-wordlm-wt2-b32t35-sym``: ``sym.Embedding`` -> ``sym.RNN``
    (2 x 650) -> ``Reshape`` -> ``FullyConnected`` (33278) ->
    ``SoftmaxOutput``, time-major, phase 8's Xavier weights carried
    over, dropout 0) bound with ``simple_bind`` on the card with every
    shape given: its step-1 softmax within 1e-5 and every weight's
    gradient within 1e-3 of scale of the Gluon model's
    (``SoftmaxOutput`` with normalization ``"null"`` and grad_scale
    1/35 gives the Gluon loss's gradient), then 2 warm-up and 20
    segments through ``mx.optimizer.get_updater`` (phase 8's SGD and
    clip) on the executor's arrays, the final states carried: losses
    finite, the last 5's mean below the first 5's, 2 + 2 + 2 LSTM
    launches a segment, the training key's two graphs captured at the
    first call and none after, and the same segments through the eager
    walk (``MXNET_TPU_SYMBOLIC_JIT=0``) within 1e-6 relative (bit for
    bit said); ``mx.model.save_checkpoint`` of the trained LM, then
    ``SymbolBlock.imports`` and ``Module.load`` on the card give the
    executor's outputs bit for bit, K6a launched by each; the LM at 2 x
    200, vocab 1000, card vs CPU (phase 9's gates);
    ``sym.LayerNorm``, ``sym.flash_attention`` and
    ``sym.softmax_cross_entropy`` at phase 14's shapes in one bound
    graph: forward and backward give the ``nd`` calls' bits, one launch
    of each kernel a call; ``example/mnist_module.py`` and
    ``example/rnn_bucketing.py`` unmodified at their defaults through
    ``run_reference`` in child processes (their gates: accuracy > 0.8;
    the bucketing script's printed final accuracy >= 0.75, its
    ``--quick`` gate), no port kernel, and the graphs captured: 3 for
    the module (its training key's pair and its predict key), a pair
    per bucket for the bucketing module. Step p50 graphed and eager,
    tokens/s, beside phase 8's Gluon p50, and the scripts' seconds by
    epoch printed.

The op-dispatch phase also times one
``F.scaled_dot_product_attention`` call beside K1, K2 and K5 at head
dims past 256 (264 and 512; K5 also 320): forward and backward apart.

``--profile`` adds a torch.profiler breakdown (device time by kernel,
busy share) of both serving windows and of one step of each training
path; the ResNet steps also by layer kind (convolutions, BatchNorm,
ReLU, pooling, Dense, loss, optimizer).

In the ``kernels`` line, ``launches_by_path["nd"]`` counts phase 14's
launches: the F-op model's 10 steps for K1, K2, K3a, K3b, K4a and K4b,
the registry's ``nd.RNN`` call for K6a and K6b; ``launches_in_graph``
counts phase 15's launches made by graph replays;
``launches_by_path["sym"]`` counts phase 17's: the symbolic LM's 20
measured segments for K6a and K6b, one replay of the registry ops'
graph for K1, K2, K3a, K3b, K4a and K4b.

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
import contextlib
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
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%; "
        f"{sum(e.count for e in rows)} device events")
    # the 15 largest, then the port's own kernels below them (those of
    # its sources' anonymous namespaces)
    for i, e in enumerate(rows):
        ours = e.key.split("(anonymous namespace)::")[0] in ("", "void ")
        if i < 15 or ours:
            log(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
                f"{e.key[:90]}")
    return busy / wall


def serve_main_path(seed, profile, dev, power_line, layers=12, new=32,
                    model=None):
    """GPT-2-small width (``layers`` deep) through DecodeEngine, ``new``
    tokens per request; ``model``: a built one (phase 15 passes phase
    5's, graphed or under :func:`eager_steps`). Returns the launch
    counts of the serving run and ``{"model", "outs", "metrics",
    "busy"}``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import DecodeEngine, PagedCausalLM

    t0 = time.perf_counter()
    if model is not None:
        layers = model.layers
    else:
        model = PagedCausalLM(vocab=50257, units=768, layers=layers,
                              heads=12, max_len=1024, seed=seed,
                              device=dev)
        log(f"model: GPT-2-small width, {layers} layers, "
            f"{sum(p.numel() for p in model.params.values())} params "
            f"({time.perf_counter() - t0:.1f} s to build)")
    rng = np.random.RandomState(seed)
    lens = [5, 17, 40, 64, 65, 100, 150, 200]
    prompts = [rng.randint(0, 50257, n).tolist() for n in lens]
    with DecodeEngine(model, max_rows=8, page_size=16,
                      n_pages=1024) as eng:
        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated(dev)
        eng.warmup()
        warm_s = time.perf_counter() - t0
        graph_mem = torch.cuda.memory_allocated(dev) - mem0
        log(f"warmup: {warm_s:.1f} s; "
            f"{eng.snapshot()['compile_cache']['miss']} captures")
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
        busy = report_profile(prof, wall) if prof is not None else None
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
        steps = iters + snap["decode"]["prefill_chunks"]
        graphed = "_run" not in vars(model)
        if graphed and counts["paged_attention"] != layers * steps:
            raise AssertionError(
                f"graphed: paged_attention launched "
                f"{counts['paged_attention']} times, want layers x (decode "
                f"iterations + prefill chunks) = {layers} x {steps}")
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
    metrics = {"tokens_per_s": gen / wall, "wall_s": wall,
               "generated": gen, "ttft_ms": dec["ttft"],
               "inter_token_ms": dec["inter_token"], "iterations": iters,
               "prefill_chunks": dec["prefill_chunks"], "launches": counts,
               "graphed": graphed, "warmup_s": warm_s,
               "compile_cache": snap["compile_cache"],
               "graph_memory_bytes": graph_mem, "card": power_line}
    log("serving metrics: " + json.dumps(metrics))
    return counts, {"model": model, "outs": outs, "metrics": metrics,
                    "busy": busy, "new": new}


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
    """BERT-base width through ServingEngine, the entry eager; returns
    the launch counts of the run (warmup, traffic and solo runs) and
    ``{"net", "metrics"}``."""
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
    entry = bert_serving_entry(net, hybridize=False)
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
    metrics = {"requests_per_s": len(reqs) / wall,
               "tokens_per_s": toks / wall, "wall_s": wall,
               "requests": len(reqs), "tokens": toks, "latency_ms": lat,
               "packing_efficiency": snap["packing_efficiency"],
               "batches": by_shape, "warmup_forwards": n_warm,
               "forwards": n_fwd, "solo_max_gap": gap, "launches": counts,
               "card": power_line}
    log("encoder serving metrics: " + json.dumps(metrics))
    return counts, {"net": net, "metrics": metrics}


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
    return counts, p50


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
    of the measured segments and the step p50 in seconds."""
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
    return counts, p50


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
    active = net._active
    net.hybridize(False)        # the hooks count one eager forward
    try:
        net(x)
    finally:
        for h in hooks:
            h.remove()
        net.hybridize(active)
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


# -- phase 14: mx.nd and user HybridBlocks ------------------------------------
def _grad_gap(got, want):
    """Largest ``|got - want|`` over ``want``'s largest magnitude."""
    gap = (got.float().cpu() - want.float().cpu()).abs().max().item()
    return gap / max(want.float().abs().max().item(), 1e-30)


def nd_registry_on_the_card(seed, dev):
    """``nd.LayerNorm``, ``nd.flash_attention``,
    ``nd.softmax_cross_entropy`` and ``nd.RNN`` on CUDA NDArrays at the
    main paths' shapes, forward and backward, against the op functions
    on plain tensors from the same inputs and head: exact launch counts
    each way and the same bits. Returns the registry runs' launches by
    kernel."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, nd, ops
    from mxnet_tpu_torch.ndarray import op_impl_nn, op_impl_rnn

    rng = np.random.RandomState(seed + 14)
    lens, _, labels, _ = train_batch(seed)

    def t(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                            device=dev)

    u, heads = BERT_BASE["units"], BERT_BASE["num_heads"]
    vl = torch.tensor(lens, device=dev)
    lab = torch.tensor(labels, device=dev)
    h, n, layers = WLM["hid"], WLM["batch"], WLM["layers"]
    size = op_impl_rnn.rnn_param_size(layers, WLM["emb"], h, False, "lstm")
    rnn_kw = dict(state_size=h, num_layers=layers, mode="lstm",
                  state_outputs=True)
    cases = [
        ("LayerNorm", [t((TRAIN_B, TRAIN_S, u)), t((u,), 0.5, 1.5),
                       t((u,))],
         lambda a: op_impl_nn.layer_norm(*a, eps=1e-12),
         lambda a: nd.LayerNorm(*a, axis=-1, eps=1e-12),
         {"layer_norm": 1, "layer_norm_bwd": 1}),
        ("flash_attention",
         [t((TRAIN_B, heads, TRAIN_S, u // heads)) for _ in range(3)],
         lambda a: op_impl_nn.flash_attention_op(*a, vl),
         lambda a: nd.flash_attention(*a, vl.as_subclass(nd.NDArray)),
         {"flash_attention": 1, "flash_attention_bwd": 1}),
        ("softmax_cross_entropy", [t((len(labels), VOCAB), -4, 4)],
         lambda a: op_impl_nn.softmax_cross_entropy(a[0], lab),
         lambda a: nd.softmax_cross_entropy(a[0],
                                            lab.as_subclass(nd.NDArray)),
         {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}),
        ("RNN", [t((WLM["bptt"], n, WLM["emb"])),
                 t((size,), -0.05, 0.05), t((layers, n, h)),
                 t((layers, n, h))],
         lambda a: op_impl_rnn.rnn(*a, **rnn_kw)[0],
         lambda a: nd.RNN(*a, **rnn_kw)[0],
         {"lstm_fwd": layers, "lstm_bwd": layers, "lstm_bwd_dw": layers}),
    ]
    total = collections.Counter()
    for name, args, direct, reg, want in cases:
        runs, head = [], None
        for fn in (direct, reg):
            xs = [a.clone() if fn is direct else
                  a.clone().as_subclass(nd.NDArray) for a in args]
            for x in xs:
                x.requires_grad_(True)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with autograd.record():
                out = fn(xs)
            plain = out.as_subclass(torch.Tensor)
            if head is None:            # one head for both runs
                head = torch.tensor(rng.uniform(-1, 1, tuple(plain.shape)),
                                    dtype=plain.dtype, device=dev)
            out.backward(head if fn is direct else head.as_subclass(
                nd.NDArray))
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            runs.append((plain.detach(), [x.grad.as_subclass(torch.Tensor)
                                          for x in xs], counts))
        (o_d, g_d, n_d), (o_r, g_r, n_r) = runs
        if n_d != want or n_r != want:
            raise AssertionError(f"nd.{name}: launches {n_r} (direct "
                                 f"{n_d}), want {want}")
        same = torch.equal(o_r, o_d) and all(
            torch.equal(a, b) for a, b in zip(g_r, g_d))
        if not same:
            raise AssertionError(f"nd.{name}: not the direct call's bits")
        total.update(n_r)
        log(f"nd.{name} on CUDA NDArrays: launches {n_r}, forward and "
            f"{len(g_r)} gradients bit for bit the op function's")
    return dict(total)


def nd_sweep_card_vs_cpu(dev):
    """Every registered op of the CPU parity tests' table
    (``tests/nd_op_cases.py``) on the card and on the CPU in float32:
    outputs within ``test_utils``' float32 tolerances (rtol 1e-4, atol
    1e-6), integer, comparison and ordering results exact."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from nd_op_cases import SPECS, rs_for

    from mxnet_tpu_torch import nd, test_utils
    from mxnet_tpu_torch.context import Context

    rtol, atol = test_utils.device_tols("float32")
    worst, n_out = 0.0, 0
    for name in sorted(SPECS):
        inputs, params, _, exact = SPECS[name]
        arrays = inputs(rs_for(name))
        outs = []
        for d in (dev, torch.device("cpu")):
            with Context.of(d):
                xs = [nd.array(a, dtype=a.dtype) for a in arrays]
                got = getattr(nd, name)(*xs, **params)
            outs.append(list(got) if isinstance(got, (list, tuple))
                        else [got])
        for g, w in zip(*outs):
            if g.device.type != "cuda":
                raise AssertionError(f"nd.{name}: output on {g.device}")
            g = g.as_subclass(torch.Tensor).cpu()
            w = w.as_subclass(torch.Tensor)
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"nd.{name}: {g.shape} {g.dtype} on "
                                     f"the card, {w.shape} {w.dtype}")
            n_out += 1
            if exact or not g.is_floating_point():
                if not torch.equal(g, w):
                    raise AssertionError(f"nd.{name}: card and CPU differ")
                continue
            gd, wd = g.double().numpy(), w.double().numpy()
            if not np.allclose(gd, wd, rtol=rtol, atol=atol,
                               equal_nan=True):
                raise AssertionError(
                    f"nd.{name}: card vs CPU gap "
                    f"{np.nanmax(np.abs(gd - wd))} past rtol {rtol} atol "
                    f"{atol}")
            fin = np.isfinite(wd)
            if fin.any():
                worst = max(worst, float(np.max(
                    np.abs(gd - wd)[fin] / (atol + rtol * np.abs(wd[fin])))))
    log(f"registry sweep: {len(SPECS)} ops, {n_out} outputs, card vs CPU "
        f"within rtol {rtol} / atol {atol} (worst {worst:.3f} of the "
        f"allowance), exact ones bit for bit")


def build_hybrid(seed, dev, num_layers):
    """``examples/hybrid_bert.py`` at BERT-base width on ``dev`` with the
    weights of phase 7's model zoo pair (``build_trainer``'s, from
    ``seed``); returns ``(hybrid, zoo trunk, zoo head)``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.examples import hybrid_bert

    net, head, _, _ = build_trainer(seed, dev, num_layers)
    cfg = dict(BERT_BASE, num_layers=num_layers)
    with Context.of(dev):
        hyb = hybrid_bert.build(gluon, layer_norm_eps=1e-12, **cfg)
    hybrid_bert.load_weights(hyb, net, head)
    return hyb, net, head


def hybrid_step(hyb, trainer, batch):
    """One MLM step of the F-op model; returns its loss tensor."""
    from mxnet_tpu_torch import autograd

    ids, tt, lens, pos, labels, n_valid = batch
    with autograd.record():
        loss = hyb(ids, tt, lens, pos, labels)
    loss.backward()
    if trainer is not None:
        trainer.step(n_valid)
    return loss


def train_hybrid_main_path(seed, dev, power_line, zoo_p50, steps=10,
                           warmup=2):
    """The F-op BERT-base MLM model on ``train-bertbase-mlm-b64s128``:
    step 1 against the model zoo pair with the same weights (loss
    within 1e-5 relative, every gradient within 1e-3 of its largest),
    then 2 warm-up and 10 Adam steps with exact launches a step.
    Returns the measured steps' launches."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import gluon, nd, ops

    layers, u = BERT_BASE["num_layers"], BERT_BASE["units"]
    t0 = time.perf_counter()
    hyb, net, head = build_hybrid(seed, dev, layers)
    log(f"F-op BERT-base: {len(hyb.collect_params())} parameters from "
        f"the model zoo pair ({time.perf_counter() - t0:.1f} s)")
    batch = to_device(train_batch(seed), dev)
    ids, tt, lens, pos, labels, n_valid = batch
    from mxnet_tpu_torch import autograd
    with autograd.record():
        seq = net(ids, tt, lens)
        zloss = nd.softmax_cross_entropy(head(seq.reshape(-1, u)[pos]),
                                         labels)
    zloss.backward()
    hloss = hybrid_step(hyb, None, batch)
    rel = abs(hloss.item() - zloss.item()) / abs(zloss.item())
    zoo = {"trunk": net.collect_params(), "head": head.collect_params()}
    from mxnet_tpu_torch.examples.hybrid_bert import zoo_name
    worst, worst_name = 0.0, None
    for name, p in hyb.collect_params().items():
        part, z = zoo_name(name)
        gap = _grad_gap(p.grad(), zoo[part][z].grad())
        if gap > worst:
            worst, worst_name = gap, name
    log(f"F-op vs model zoo, step 1: loss {hloss.item():.6f} vs "
        f"{zloss.item():.6f} (relative gap {rel:.3e}, tol 1e-5); largest "
        f"gradient gap {worst:.3e} of scale ({worst_name}, tol 1e-3)")
    if not rel <= 1e-5:
        raise AssertionError(f"F-op loss differs by {rel}")
    if not worst <= 1e-3:
        raise AssertionError(f"F-op gradient of {worst_name} differs by "
                             f"{worst} of its scale")
    del net, head, zoo, seq, zloss
    params = hyb.collect_params()
    for p in params.values():
        p.zero_grad()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    for _ in range(warmup):
        hybrid_step(hyb, trainer, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = hybrid_step(hyb, trainer, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item() / n_valid)
    counts = ops.launch_counts()
    per_step = {"flash_attention": layers, "flash_attention_bwd": layers,
                "layer_norm": 2 * layers + 2,
                "layer_norm_bwd": 2 * layers + 2,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    for name, k in per_step.items():
        if counts[name] != k * steps:
            raise AssertionError(f"F-op model: {name} launched "
                                 f"{counts[name]} times in {steps} steps, "
                                 f"want {k} a step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"F-op model: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"F-op model: loss did not fall: {losses}")
    for name, p in params.items():
        g = p.grad()
        if not bool(torch.isfinite(g).all()) or g.abs().max().item() == 0:
            raise AssertionError(f"F-op model: {name} gradient not finite "
                                 f"or all zero")
    p50 = float(np.median(times))
    log(f"F-op BERT-base trained {steps} steps (+{warmup} warm-up): step "
        f"p50 {p50 * 1e3:.2f} ms, {n_valid / p50:.1f} valid tokens/s; "
        f"model zoo (phase 7, this run) {zoo_p50 * 1e3:.2f} ms: ratio "
        f"{p50 / zoo_p50:.4f}; loss per token {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; launches {counts} [{power_line}]")
    log("F-op training metrics: " + json.dumps(
        {"step_ms_p50": p50 * 1e3, "step_ms": [x * 1e3 for x in times],
         "valid_tokens_per_s": n_valid / p50,
         "zoo_step_ms_p50": zoo_p50 * 1e3, "ratio_to_zoo": p50 / zoo_p50,
         "loss_per_token": losses, "launches": counts,
         "card": power_line}))
    return counts


def cross_device_hybrid(seed, dev, steps=3):
    """The F-op model at 2 layers, BERT-base width, from one seed on the
    card and on the CPU: three Adam steps, losses within 1e-4 relative
    and step-1 gradients within 1e-3 of each parameter's largest CPU
    gradient."""
    import torch

    from mxnet_tpu_torch import gluon

    batch = train_batch(seed + 5, b=4, s=32)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        hyb, _, _ = build_hybrid(seed, device, 2)
        params = hyb.collect_params()
        trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
        data = to_device(batch, device)
        losses, grads = [], None
        for i in range(steps):
            losses.append(hybrid_step(hyb, trainer, data).item())
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
    log(f"cross-device F-op training: losses {runs['cuda'][0]} (card) vs "
        f"{runs['cpu'][0]} (cpu), max relative gap {rel:.3e} (tol 1e-4); "
        f"step-1 gradients of {len(runs['cpu'][1])} parameters "
        f"{'within' if worst_name is None else 'NOT within'} 1e-3 of each "
        f"parameter's largest CPU gradient")
    if not rel <= 1e-4:
        raise AssertionError(f"F-op training losses differ by {rel}")
    if worst_name is not None:
        raise AssertionError(f"F-op gradient of {worst_name} differs by "
                             f"{worst} of its scale")


def nd_and_hybrid_blocks(seed, dev, power_line, zoo_p50):
    """Phase 14; returns ``{kernel: launches}`` of its registry runs and
    of the F-op model's measured steps."""
    t0 = time.perf_counter()
    reg = nd_registry_on_the_card(seed, dev)
    nd_sweep_card_vs_cpu(dev)
    train = train_hybrid_main_path(seed, dev, power_line, zoo_p50)
    cross_device_hybrid(seed, dev)
    log(f"phase 14 (mx.nd and user HybridBlocks): "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {k: v for k, v in train.items() if v}
    for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw"):
        counts[k] = reg[k]
    return counts


# -- phase 15: hybridize (CUDA graphs) ----------------------------------------
def _captures_of(*blocks):
    """(captures, capture ms) of the hybridized blocks' CachedOps."""
    n, ms = 0, 0.0
    for b in blocks:
        for e in b._cached_graph.values():
            n += sum(1 + (i.bwd is not None) for i in e.instances)
            ms += e.capture_ms
    return n, ms


def _busy(x):
    return "not measured" if x is None else f"{100 * x:.1f}%"


def _median(xs):
    import numpy as np

    return float(np.median(xs))


def _p(m, key, q):
    return m[key][f"{q}_ms"]


@contextlib.contextmanager
def eager_steps(model):
    """Within it, ``model`` (a ``PagedCausalLM``) calls its steps'
    bodies directly, outside its graphs: the eager side of phase 15
    (the package has no switch for it)."""
    import numpy as np
    import torch

    def run(name, caches, arrays, body):
        return body(caches, *[torch.as_tensor(np.asarray(a, np.int64),
                                              device=model.device)
                              for a in arrays])

    model._run = run
    try:
        yield model
    finally:
        del model._run


def hybrid_decode(seed, dev, power_line, graphed, profiles, rounds=3):
    """The decode burst of phase 5 (``graphed``: one graph per prefill,
    chunk and decode bucket, K5 inside) and the same model with its
    steps' bodies called directly (eager), in turns, ``rounds`` of
    each: every burst's greedy streams equal to phase 5's token for
    token, K5 launched exactly layers x steps in the graphed ones;
    medians of each side's rates. Adds to ``profiles`` a profiled burst
    of each, for the busy shares."""
    model, new = graphed["model"], graphed["new"]
    runs = {"eager": [], "graphed": []}
    caps, n_graphs = [0.0], 0
    for _ in range(rounds):
        for mode in ("eager", "graphed"):
            with eager_steps(model) if mode == "eager" \
                    else contextlib.nullcontext():
                _, got = serve_main_path(seed, False, dev, power_line,
                                         new=new, model=model)
            if got["outs"] != graphed["outs"]:
                raise AssertionError(f"{mode} decode streams differ from "
                                     f"phase 5's")
            runs[mode].append(got["metrics"])
            if mode == "graphed":
                # a burst's own captures; the model holds those of every
                # engine still alive (a closed engine's pool stays)
                n_graphs = got["metrics"]["compile_cache"]["miss"]
                caps = sorted(g.capture_ms for r, g in model._graphs
                              .values() if r() is not None) or [0.0]

    def side(ms):
        return {"tokens_per_s": _median([x["tokens_per_s"] for x in ms]),
                "ttft_p50_ms": _median([_p(x, "ttft_ms", "p50") for x in ms]),
                "ttft_p99_ms": _median([_p(x, "ttft_ms", "p99") for x in ms]),
                "inter_token_p50_ms": _median(
                    [_p(x, "inter_token_ms", "p50") for x in ms]),
                "inter_token_p99_ms": _median(
                    [_p(x, "inter_token_ms", "p99") for x in ms]),
                "tokens_per_s_runs": [x["tokens_per_s"] for x in ms],
                "warmup_s": _median([x["warmup_s"] for x in ms]),
                "memory_after_warmup_bytes": ms[-1]["graph_memory_bytes"]}

    m = {"graphed": side(runs["graphed"]), "eager": side(runs["eager"]),
         "graphs": n_graphs, "capture_ms": caps}

    def line(k):
        x = m[k]
        return (f"{k} {x['tokens_per_s']:.1f} tokens/s (runs "
                f"{', '.join(f'{v:.1f}' for v in x['tokens_per_s_runs'])}),"
                f" TTFT p50 {x['ttft_p50_ms']:.2f} p99 {x['ttft_p99_ms']:.2f}"
                f" ms, inter-token p50 {x['inter_token_p50_ms']:.2f} p99 "
                f"{x['inter_token_p99_ms']:.2f} ms")

    log(f"hybridize decode ({rounds} bursts a side, in turns, medians): "
        f"streams of both equal to phase 5's token for token; "
        f"{line('graphed')}; "
        f"{line('eager')}; {n_graphs} graphs a burst, capture ms per bucket "
        f"median "
        f"{caps[len(caps) // 2]:.1f} (max {caps[-1]:.1f}), warm-up "
        f"{m['graphed']['warmup_s']:.1f} s vs eager "
        f"{m['eager']['warmup_s']:.1f} s; memory held after the warm-up "
        f"{m['graphed']['memory_after_warmup_bytes'] / 2**20:.1f} MiB vs "
        f"eager {m['eager']['memory_after_warmup_bytes'] / 2**20:.1f} MiB "
        f"[{power_line}]")

    def profile():
        m["busy"] = {}
        for mode in ("eager", "graphed"):
            with eager_steps(model) if mode == "eager" \
                    else contextlib.nullcontext():
                m["busy"][mode] = serve_main_path(
                    seed, True, dev, power_line, new=new,
                    model=model)[1]["busy"]
        log(f"hybridize decode, busy share: graphed "
            f"{_busy(m['busy']['graphed'])}, eager "
            f"{_busy(m['busy']['eager'])} (profiled bursts)")

    profiles.append(profile)
    return m


def hybrid_encoder(seed, dev, power_line, eager, profiles, clients=8,
                   rounds=3):
    """The encoder burst of phase 6 through ``bert_serving_entry``, the
    eager model (phase 6's) and a second one from the seed with
    ``hybridize=True`` (one graph per (rows, row_len) bucket, K1 and
    K3a inside), ``rounds`` bursts each in turns: every graphed batch's
    output equal to the eager model's on the same batch, to the bit;
    launches exactly 12 + 25 a forward; no capture after the warm-up;
    medians of each side's rates. Adds to ``profiles`` a profiled
    burst of each."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                      bert_serving_entry)
    from mxnet_tpu_torch.serving import ServingEngine

    layers = BERT_BASE["num_layers"]
    eager_net = eager["net"]
    net = BERTModel(device=dev, seed=seed, **BERT_BASE)
    entries = {"eager": bert_serving_entry(eager_net, hybridize=False),
               "graphed": bert_serving_entry(net, hybridize=True)}
    seen = []

    def recorded(*args):
        out = entries["graphed"](*args)
        seen.append(([a.clone() for a in args], out.clone()))
        return out

    reqs = encoder_requests(np.random.RandomState(seed + 2))

    def burst(eng, profile):
        results = [None] * len(reqs)
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
        if any(r is None for r in results):
            raise AssertionError("encoder: requests unanswered")
        busy = report_profile(prof, wall) if prof is not None else None
        snap = eng.snapshot()
        return {"requests_per_s": len(reqs) / wall, "wall_s": wall,
                "latency_ms": snap["latency"]["total"],
                "compile_cache": snap["compile_cache"], "busy": busy}

    def engine(mode):
        fn = recorded if mode == "graphed" else entries["eager"]
        return ServingEngine(fn, device=dev, pool="mean",
                             bucket_lens=(64, 256, 512), max_rows=8)

    runs = {"eager": [], "graphed": []}
    with engine("eager") as e_eng, engine("graphed") as g_eng:
        ops.reset_launch_counts()
        mem0 = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        g_eng.warmup()
        warm_s = time.perf_counter() - t0
        graph_mem = torch.cuda.memory_allocated(dev) - mem0
        warm_cc = g_eng.snapshot()["compile_cache"]
        n_fwd = warm_cc["miss"] + warm_cc["memory_hit"]
        counts = ops.launch_counts()
        e_eng.warmup()
        for _ in range(rounds):
            for mode, eng in (("eager", e_eng), ("graphed", g_eng)):
                before, n0 = ops.launch_counts(), len(seen)
                runs[mode].append(burst(eng, False))
                if mode == "graphed":
                    after = ops.launch_counts()
                    counts = {k: n + after[k] - before[k]
                              for k, n in counts.items()}
                    n_fwd += len(seen) - n0
        cc = g_eng.snapshot()["compile_cache"]
    want = {"flash_attention": layers * n_fwd,
            "layer_norm": (2 * layers + 1) * n_fwd}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"graphed encoder: {name} launched "
                                 f"{counts[name]} times in {n_fwd} "
                                 f"forwards, want {n}")
    if cc["miss"] != warm_cc["miss"]:
        raise AssertionError(f"graphed encoder: traffic captured "
                             f"{cc['miss'] - warm_cc['miss']} graphs after "
                             f"the warm-up")
    with torch.inference_mode():
        for args, out in seen:
            if not torch.equal(entries["eager"](*args), out):
                raise AssertionError("graphed encoder: a batch's output "
                                     "differs from the eager model's")
    caps = _captures_of(net)

    def side(ms):
        return {"requests_per_s": _median([x["requests_per_s"] for x in ms]),
                "latency_p50_ms": _median([_p(x, "latency_ms", "p50")
                                           for x in ms]),
                "latency_p99_ms": _median([_p(x, "latency_ms", "p99")
                                           for x in ms]),
                "requests_per_s_runs": [x["requests_per_s"] for x in ms]}

    m = {"graphed": side(runs["graphed"]), "eager": side(runs["eager"]),
         "warmup_s": warm_s, "compile_cache": cc,
         "graph_memory_bytes": graph_mem, "captures": caps[0],
         "capture_ms": caps[1], "batches_checked": len(seen),
         "launches": counts, "card": power_line}

    def line(k):
        x = m[k]
        return (f"{k} {x['requests_per_s']:.2f} requests/s (runs "
                f"{', '.join(f'{v:.2f}' for v in x['requests_per_s_runs'])})"
                f", latency p50 {x['latency_p50_ms']:.2f} p99 "
                f"{x['latency_p99_ms']:.2f} ms")

    log(f"hybridize encoder ({rounds} bursts a side, in turns, medians): "
        f"{len(seen)} graphed batches equal to the eager model's to the "
        f"bit; launches exact ({n_fwd} graphed forwards); "
        f"{line('graphed')}; {line('eager')}; {caps[0]} graphs captured in "
        f"{caps[1]:.0f} ms, warm-up {warm_s:.1f} s; memory held by the "
        f"graphs {graph_mem / 2**20:.1f} MiB [{power_line}]")

    def profile():
        m["busy"] = {}
        for mode in ("eager", "graphed"):
            with engine(mode) as eng:
                eng.warmup()
                m["busy"][mode] = burst(eng, True)["busy"]
        log(f"hybridize encoder, busy share: graphed "
            f"{_busy(m['busy']['graphed'])}, eager "
            f"{_busy(m['busy']['eager'])} (profiled bursts)")

    profiles.append(profile)
    return m


def _grads(params):
    return {k: p.grad().detach().clone() for k, p in params.items()}


def _step_one(make, step, hybrid):
    """Step 1 (forward, backward, no update) of a model from ``make``:
    the model, its parameters, its loss and its gradients."""
    objs, params = make(hybrid)
    loss = step(objs, None).detach().clone()
    return objs, params, loss, _grads(params)


#: the kernels each launch counter stands for, one kernel a launch at
#: the shapes phase 15 profiles (K2 fused: Skv <= 128; K3b: its fold)
KERNEL_SYMBOLS = {
    "paged_attention": ("paged_attention_kernel",),
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_wide_kernel"),
    "flash_attention_bwd": ("flash_bwd_fused_kernel",
                            "flash_bwd_fused_wide_kernel"),
    "layer_norm": ("layer_norm_fwd_kernel", "layer_norm_fwd_long_kernel"),
    "layer_norm_bwd": ("layer_norm_bwd_fold_kernel",),
    "softmax_xent_fwd": ("xent_fwd_kernel",),
    "softmax_xent_bwd": ("xent_bwd_kernel",),
    "lstm_fwd": ("lstm_fwd_kernel",), "lstm_bwd": ("lstm_bwd_kernel",),
    "lstm_bwd_dw": ("lstm_bwd_dw_kernel",)}


def traced_launches(prof):
    """``{launch counter: kernels of it in the trace}`` (the port's
    kernels by their symbols, :data:`KERNEL_SYMBOLS`)."""
    import re

    from torch.autograd import DeviceType

    by_symbol = {sym: name for name, syms in KERNEL_SYMBOLS.items()
                 for sym in syms}
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"::(\w+)[<(]", e.key)
        name = by_symbol.get(m.group(1)) if m else None
        if name is not None:
            out[name] = out.get(name, 0) + e.count
    return out


def _trainer_of(objs):
    from mxnet_tpu_torch import gluon

    params = {k: p for o in objs if hasattr(o, "collect_params")
              for k, p in o.collect_params().items()}
    for p in params.values():
        p.zero_grad()
    return gluon.Trainer(params, "adam", {"learning_rate": 1e-4})


def graphed_training(label, make, step, batch_valid, profiles, steps=10,
                     warmup=2, second=None):
    """A training path, eager and hybridized, from the same seed: step 1
    of each (the loss and every gradient, bit for bit or within 1e-6
    relative / 1e-5 of scale, said which), then ``warmup`` Adam steps
    each and ``steps`` rounds of one eager and one graphed step in
    turns: the graphed steps' launches exact (12/12, 26/26, 1/1 a
    step) and their loss falling; each side's step p50. Step 1 runs
    twice on each side, which tells the run-to-run spread of each
    gradient (eager against eager, graphed against graphed) from a
    difference between the two. ``second(objs)``: one step at a second
    training shape, on the graphed side; the memory its graphs hold is
    measured. With ``profiles`` (a list) adds a profiled forward +
    backward of each, its port kernels in the trace held against the
    launch counts. Returns the metrics."""
    import gc

    import numpy as np
    import torch

    from mxnet_tpu_torch import ops

    layers = BERT_BASE["num_layers"]
    held = {}
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    eager_objs, pe, le, ge = _step_one(make, step, False)
    gc.collect()
    held["eager"] = torch.cuda.memory_allocated() - mem0
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    objs, pg, lg, gg = _step_one(make, step, True)
    first_s = time.perf_counter() - t0
    gc.collect()
    # less the step-1 copies of the loss and gradients held here
    held["graphed"] = torch.cuda.memory_allocated() - mem0 - sum(
        g.numel() * g.element_size() for g in (lg, *gg.values()))
    held["eager"] -= sum(g.numel() * g.element_size()
                         for g in (le, *ge.values()))
    same = torch.equal(le, lg) and all(torch.equal(ge[k], gg[k])
                                       for k in ge)
    rel = abs(lg.item() - le.item()) / abs(le.item())
    gaps = {k: _grad_gap(gg[k], ge[k]) for k in ge}
    worst_name = max(gaps, key=gaps.get)
    worst = gaps[worst_name]
    unequal = sorted(k for k in ge if not torch.equal(ge[k], gg[k]))
    # step 1 again on each side (no update yet: the same weights)
    spread = {}
    for mode, o, ps, g1 in (("eager", eager_objs, pe, ge),
                            ("graphed", objs, pg, gg)):
        step(o, None)
        g2 = _grads(ps)
        spread[mode] = {k: _grad_gap(g2[k], g1[k]) for k in g1
                        if not torch.equal(g2[k], g1[k])}
        del g2
    if not (rel <= 1e-6 and worst <= 1e-5):
        raise AssertionError(f"{label}: graphed step 1 off the eager one: "
                             f"loss {rel}, gradient of {worst_name} "
                             f"{worst} of its scale")
    del le, ge, lg, gg
    trainers = {"eager": _trainer_of(eager_objs), "graphed": _trainer_of(objs)}
    sides = {"eager": eager_objs, "graphed": objs}
    for mode in sides:
        for _ in range(warmup):
            step(sides[mode], trainers[mode])
    torch.cuda.synchronize()
    times = {"eager": [], "graphed": []}
    losses = []
    counts = {}
    for _ in range(steps):
        for mode in ("eager", "graphed"):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            loss = step(sides[mode], trainers[mode])
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
            if mode == "graphed":
                after = ops.launch_counts()
                for k in after:
                    counts[k] = counts.get(k, 0) + after[k] - before[k]
                losses.append(loss.item() / batch_valid)
    per_step = {"flash_attention": layers, "flash_attention_bwd": layers,
                "layer_norm": 2 * layers + 2,
                "layer_norm_bwd": 2 * layers + 2,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    for name, k in per_step.items():
        if counts[name] != k * steps:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times in {steps} graphed steps, want "
                                 f"{k} a step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: graphed loss did not fall: "
                             f"{losses}")
    if second is not None:
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        second(objs)
        gc.collect()
        torch.cuda.synchronize()
        held["graphed_second_shape"] = torch.cuda.memory_allocated() - mem0
    caps = _captures_of(*[o for o in objs if hasattr(o, "_cached_graph")])
    p50 = {k: _median(v) for k, v in times.items()}
    m = {"step_ms_p50": p50["graphed"] * 1e3,
         "eager_step_ms_p50": p50["eager"] * 1e3,
         "ratio_to_eager": p50["graphed"] / p50["eager"],
         "step_ms": [t * 1e3 for t in times["graphed"]],
         "eager_step_ms": [t * 1e3 for t in times["eager"]],
         "step1_bit_equal": same, "step1_loss_rel_gap": rel,
         "step1_grad_gap": worst, "step1_grad_gap_param": worst_name,
         "step1_grads_not_bit_equal": unequal,
         "step1_repeat_unequal": spread, "first_step_s": first_s,
         "captures": caps[0], "capture_ms": caps[1],
         "memory_after_step1_bytes": held, "loss_per_token": losses,
         "launches": counts}
    log(f"hybridize {label}: step 1 {'bit for bit' if same else 'NOT bit'}"
        f" equal to eager (loss gap {rel:.3e}; {len(unequal)} gradients "
        f"differ, the largest gap {worst:.3e} of scale in {worst_name}); "
        f"{steps} steps a side in turns: step p50 "
        f"{p50['graphed'] * 1e3:.2f} ms graphed vs {p50['eager'] * 1e3:.2f}"
        f" ms eager (ratio {p50['graphed'] / p50['eager']:.4f}), "
        f"{batch_valid / p50['graphed']:.1f} valid tokens/s graphed; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches exact; {caps[0]} "
        f"graphs captured in {caps[1]:.0f} ms (first step {first_s:.1f} s);"
        f" memory held after step 1 (weights, gradients and, graphed, the "
        f"graphs' pool) {held['graphed'] / 2**30:.3f} GiB graphed vs "
        f"{held['eager'] / 2**30:.3f} GiB eager"
        + (f"; a second training shape's graphs hold "
           f"{held['graphed_second_shape'] / 2**30:.3f} GiB more"
           if second is not None else ""))
    log(f"hybridize {label}, step 1 repeated on the same weights: "
        + "; ".join(f"{k} against {k}: " + (
            ", ".join(f"{n} ({g:.3e} of scale)" for n, g in v.items())
            or "every gradient equal to the bit")
            for k, v in spread.items()))
    log(f"hybridize {label} metrics: " + json.dumps(m))
    if profiles is None:
        del objs, eager_objs, trainers, sides
        gc.collect()
        return m

    def profile():
        m["profile"] = {}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for mode in ("eager", "graphed"):
            step(sides[mode], None)
            torch.cuda.synchronize()
            # one step traced but not kept first: the trace's first
            # kernels can go missing while the tracer starts
            with _profiler(True) as prof:
                t0 = time.perf_counter()
                step(sides[mode], None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"hybridize {label}, {mode} forward + backward:")
            m["profile"][mode] = {"wall_ms": wall * 1e3,
                                  "busy": report_profile(prof, wall)}
            # the port's kernels in the trace of one more step. In a
            # process that has traced before, a new trace can lose its
            # first ~20 device events whatever precedes them in time
            # (the smoke's BERT-base step lost its first LayerNorm and
            # attention kernels after a 50 ms wait and a warm-up step;
            # a fresh process lost none), so the trace opens with `pad`
            # spin kernels that take that loss before the step starts
            pad = 500
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(pad):
                    torch.cuda._sleep(100)
                torch.cuda.synchronize()
                before = ops.launch_counts()
                step(sides[mode], None)
                after = ops.launch_counts()
                torch.cuda.synchronize()
            counted = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
            traced = traced_launches(prof)
            spins = sum(e.count for e in prof.key_averages()
                        if "spin_kernel" in e.key)
            if traced != counted:
                raise AssertionError(f"{label}, {mode}: the port's kernels "
                                     f"in the trace {traced} differ from "
                                     f"the launches counted {counted} "
                                     f"({spins} of {pad} padding kernels "
                                     f"traced)")
            m["profile"][mode]["padding_kernels_traced"] = spins
            log(f"hybridize {label}, {mode}: the trace's port kernels "
                f"equal the launches counted, {counted} ({spins} of {pad} "
                f"padding kernels traced)")

    profiles.append(profile)
    return m


def hybrid_bert_mlm(seed, dev, power_line, profiles):
    """``train-bertbase-mlm-b64s128`` with the trunk and the MLM head
    hybridized (each a forward and a backward graph a step) beside the
    eager pair."""
    batch = to_device(train_batch(seed), dev)

    def make(hybrid):
        net, head, params, _ = build_trainer(seed, dev,
                                             BERT_BASE["num_layers"])
        if hybrid:
            net.hybridize()
            head.hybridize()
        return (net, head), params

    def step(objs, trainer, batch=batch):
        from mxnet_tpu_torch import autograd, nd

        net, head = objs
        ids, tt, lens, pos, labels, n_valid = batch
        with autograd.record():
            seq = net(ids, tt, lens)
            flat = seq.reshape(-1, seq.shape[-1])[pos]
            loss = nd.softmax_cross_entropy(head(flat), labels)
        loss.backward()
        if trainer is not None:
            trainer.step(n_valid)
        return loss

    other = to_device(train_batch(seed, b=TRAIN_B // 2), dev)
    return graphed_training("BERT-base MLM", make, step, batch[-1],
                            profiles, second=lambda objs: step(
                                objs, None, batch=other))


def hybrid_fop_bert(seed, dev, power_line, profiles):
    """``examples/hybrid_bert.py``'s F-op BERT-base MLM hybridized (one
    forward and one backward graph a step) beside the eager model."""
    batch = to_device(train_batch(seed), dev)

    def make(hybrid):
        hyb, _, _ = build_hybrid(seed, dev, BERT_BASE["num_layers"])
        if hybrid:
            hyb.hybridize()
        return (hyb,), hyb.collect_params()

    def step(objs, trainer):
        return hybrid_step(objs[0], trainer, batch)

    return graphed_training("F-op BERT-base", make, step, batch[-1],
                            profiles)


def hybrid_wordlm(seed, dev, power_line, segments=8):
    """The word LM at its widths, dropout 0, eager and hybridized (its
    embedding, LSTM and decoder each a graph; K6a/K6b inside), one
    segment of each in turns: each segment's loss and the final weights
    equal to the eager model's to the bit, exactly 2 + 2 + 2 LSTM
    launches a graphed segment, every one a replay; each side's segment
    p50 (the first segment, the capture's, left out)."""
    import gc

    import torch

    from mxnet_tpu_torch import graphs, ops
    from mxnet_tpu_torch.examples.word_lm import train_segments

    data = wordlm_data(WLM["vocab"], WLM["batch"], segments + 1)
    nets, segs = {}, {}
    for mode in ("eager", "graphed"):
        net, trainer = build_wordlm(seed, dev, WLM["vocab"], 0.0)
        if mode == "graphed":
            net.hybridize()
        nets[mode] = net
        segs[mode] = train_segments(net, trainer, data, WLM["bptt"],
                                    WLM["clip"])
    losses = {"eager": [], "graphed": []}
    times = {"eager": [], "graphed": []}
    counts, replayed = {}, {}
    for _ in range(segments):
        for mode in ("eager", "graphed"):
            before, rb = ops.launch_counts(), graphs.replayed_launches()
            t0 = time.perf_counter()
            losses[mode].append(next(segs[mode]).detach().clone())
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
            if mode == "graphed":
                after, ra = ops.launch_counts(), graphs.replayed_launches()
                for k in after:
                    counts[k] = counts.get(k, 0) + after[k] - before[k]
                    replayed[k] = (replayed.get(k, 0) + ra.get(k, 0)
                                   - rb.get(k, 0))
    same = all(torch.equal(a, b) for a, b in zip(losses["graphed"],
                                                  losses["eager"])) and \
        all(torch.equal(a, b) for a, b in zip(nets["graphed"].parameters(),
                                              nets["eager"].parameters()))
    if not same:
        raise AssertionError("graphed word LM differs from the eager one")
    for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_dw"):
        want = WLM["layers"] * segments
        if counts[k] != want or replayed[k] != want:
            raise AssertionError(f"graphed word LM: {k} launched "
                                 f"{counts[k]} times ({replayed[k]} "
                                 f"replayed), want {want}")
    p50 = {k: _median(v[1:]) for k, v in times.items()}
    log(f"hybridize word LM ({segments} segments a side, in turns): losses "
        f"and weights equal to eager to the bit; LSTM launches 2 + 2 + 2 a "
        f"segment, all replays; segment p50 {p50['graphed'] * 1e3:.2f} ms "
        f"graphed vs {p50['eager'] * 1e3:.2f} ms eager (ratio "
        f"{p50['graphed'] / p50['eager']:.4f}) [{power_line}]")
    del nets, segs
    gc.collect()
    return {"step_ms_p50": p50["graphed"] * 1e3,
            "eager_step_ms_p50": p50["eager"] * 1e3, "launches": counts}


def hybrid_chain_steps(dev, power_line, k=10, rounds=20):
    """``engine.chain_steps`` on the MNIST MLP's widths (784-128-64-10,
    batch 64, momentum SGD written on tensors): ``k`` steps as one
    graph, ``rounds`` chained calls equal to ``k * rounds`` single
    steps to the bit; time a step both ways."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.engine import chain_steps

    def step(w1, w2, w3, m1, m2, m3, x, y):
        ws = [w.detach().requires_grad_(True) for w in (w1, w2, w3)]
        with torch.enable_grad():
            h = torch.relu(x @ ws[0])
            h = torch.relu(h @ ws[1])
            loss = torch.nn.functional.cross_entropy(h @ ws[2], y)
            gs = torch.autograd.grad(loss, ws)
        ms = [0.9 * m + g for m, g in zip((m1, m2, m3), gs)]
        new = [w - 0.01 * m for w, m in zip((w1, w2, w3), ms)]
        return (*new, *ms, loss.detach())

    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.05,
                            dtype=torch.float32, device=dev)

    ws = [t(784, 128), t(128, 64), t(64, 10)]
    carry = ws + [torch.zeros_like(w) for w in ws]
    x = torch.tensor(rng.rand(64, 784), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.randint(0, 10, 64), device=dev)
    single = [c.clone() for c in carry]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k * rounds):
        *single, loss = step(*single, x, y)
    torch.cuda.synchronize()
    single_s = (time.perf_counter() - t0) / (k * rounds)
    chained = chain_steps(step, k, donate_argnums=range(6))
    out = chained(*[c.clone() for c in carry], x, y)      # the capture
    state = [c.clone() for c in carry]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = chained(*state, x, y)
        state = list(out[:6])
    torch.cuda.synchronize()
    chain_s = (time.perf_counter() - t0) / (k * rounds)
    if not all(torch.equal(a, b) for a, b in zip(out, (*single, loss))):
        raise AssertionError("chain_steps differs from single steps")
    log(f"hybridize chain_steps: {rounds} calls of {k} steps equal to "
        f"{k * rounds} single steps to the bit; {chain_s * 1e6:.1f} us a "
        f"step chained vs {single_s * 1e6:.1f} us single [{power_line}]")
    return {"chained_us": chain_s * 1e6, "single_us": single_s * 1e6}


def vision_both(seed, dev, power_line, steps=10, warmup=3, epochs=2):
    """The vision examples' models (which ``hybridize()``) beside the
    same models with that undone: ResNet-50 in f32 and bf16, one model
    of each kind from the seed, ``warmup`` steps each then ``steps``
    rounds of one eager and one graphed step in turns (step 1's loss
    equal, within 1e-6 relative, and each side's step p50; after the
    last step every BatchNorm running mean and variance of the graphed
    model, updated inside its graph at every replay, equal to the eager
    model's write-backs to the bit); then ``epochs`` MNIST epochs of
    each kind, in turns."""
    import gc

    import numpy as np
    import torch

    from mxnet_tpu_torch.examples import mnist_gluon
    from mxnet_tpu_torch.examples import train_imagenet as ex

    out = {}
    r = RESNET
    for dtype in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        models = {}
        for mode in ("eager", "graphed"):
            models[mode] = ex.build(r["network"], r["classes"], dev, dtype,
                                    seed)
            if mode == "eager":
                models[mode][0].hybridize(False)
        x, y = ex.synthetic_batch(r["batch"], r["image"], r["classes"],
                                  seed, dev, dtype)
        times = {"eager": [], "graphed": []}
        losses = {"eager": [], "graphed": []}
        for i in range(warmup + steps):
            for mode in ("eager", "graphed"):
                net, loss_fn, trainer = models[mode]
                t0 = time.perf_counter()
                _, loss = ex.train_step(net, loss_fn, trainer, x, y)
                torch.cuda.synchronize()
                if i >= warmup:
                    times[mode].append(time.perf_counter() - t0)
                losses[mode].append(loss.double().mean().item())
        rel = abs(losses["graphed"][0] - losses["eager"][0]) / \
            abs(losses["eager"][0])
        if not rel <= 1e-6:
            raise AssertionError(f"ResNet-50 {dtype}: graphed step-1 loss "
                                 f"off the eager one by {rel}")
        same = next((i for i, (a, b) in enumerate(zip(losses["graphed"],
                                                       losses["eager"]))
                     if a != b), None)
        stats = {mode: {n: t for n, t in models[mode][0]
                        .gluon_params().items() if "running" in n}
                 for mode in models}
        off = sorted(n for n, t in stats["eager"].items()
                     if not torch.equal(stats["graphed"][n], t))
        if not stats["eager"] or off:
            raise AssertionError(f"ResNet-50 {dtype}: running statistics "
                                 f"of the graphed model differ from the "
                                 f"eager one's after {warmup + steps} "
                                 f"steps: {off[:4]} ({len(off)} of "
                                 f"{len(stats['eager'])})")
        out[dtype] = {k: _median(v) * 1e3 for k, v in times.items()}
        out[dtype]["first_unequal_step"] = same
        n_stats = len(stats["eager"])
        del models, x, y, stats
        log(f"hybridize ResNet-50 {dtype} ({steps} steps a side, in turns): "
            f"step p50 {out[dtype]['graphed']:.2f} ms graphed vs "
            f"{out[dtype]['eager']:.2f} ms eager (ratio "
            f"{out[dtype]['graphed'] / out[dtype]['eager']:.4f}); losses "
            + ("equal to eager to the bit" if same is None else
               f"equal to eager up to step {same + 1} (step 1 within "
               f"{rel:.1e})") + f"; all {n_stats} running "
            f"means and variances equal to eager's to the bit "
            f"[{power_line}]")
    gc.collect()
    torch.cuda.empty_cache()
    args = mnist_gluon.parse_args(["--seed", str(seed), "--epochs", "1"])
    args.device = str(dev)
    build = mnist_gluon.build
    rates = {"eager": [], "graphed": []}
    try:
        for _ in range(epochs):
            for mode in ("eager", "graphed"):
                # the example's own model; eager: its hybridize() undone
                mnist_gluon.build = build if mode == "graphed" else (
                    lambda device, seed=0: build(device, seed)
                    .hybridize(False))
                res = mnist_gluon.train(args)
                rates[mode].append(res["epochs"][0]["samples_per_s"])
    finally:
        mnist_gluon.build = build
    out["mnist_samples_per_s"] = rates
    log(f"hybridize MNIST (an epoch of each, {epochs} in turns): samples/s "
        f"graphed {[round(v, 1) for v in rates['graphed']]} vs eager "
        f"{[round(v, 1) for v in rates['eager']]} [{power_line}]")
    return out


def embedding_probe(dev, units=768):
    """The token-type embedding's weight gradient alone
    (``aten.embedding_dense_backward``) at the training batch's shape,
    every id 0 of 2 rows as in phases 7 and 15: twice eagerly and twice
    from one CUDA graph, each pair and the two sides compared bit for
    bit. Returns ``{"eager_repeat", "graphed_repeat", "eager_vs_graphed"}``
    (each True when equal) and the gap of the last, of scale."""
    import torch

    from mxnet_tpu_torch import graphs

    gen = torch.Generator(device=dev).manual_seed(0)
    dy = torch.randn(TRAIN_B, TRAIN_S, units, device=dev, generator=gen)
    ids = torch.zeros(TRAIN_B, TRAIN_S, dtype=torch.long, device=dev)

    def grad(dy, ids):
        return torch.ops.aten.embedding_dense_backward(dy, ids, 2, -1,
                                                       False)

    e = [grad(dy, ids) for _ in range(2)]
    graph = graphs.capture(grad, [dy, ids], dev,
                           torch.cuda.graph_pool_handle(),
                           "embedding backward probe")
    g = [graph([dy, ids]).clone() for _ in range(2)]
    torch.cuda.synchronize()
    out = {"eager_repeat": torch.equal(e[0], e[1]),
           "graphed_repeat": torch.equal(g[0], g[1]),
           "eager_vs_graphed": torch.equal(e[0], g[0]),
           "gap_of_scale": _grad_gap(g[0], e[0])}
    log(f"embedding backward probe ({TRAIN_B}x{TRAIN_S} ids, all 0, "
        f"{units} units): eager twice equal {out['eager_repeat']}, "
        f"graphed twice equal {out['graphed_repeat']}, eager vs graphed "
        f"equal {out['eager_vs_graphed']} (gap {out['gap_of_scale']:.3e} "
        f"of scale)")
    return out


def hybridize_phase(seed, dev, power_line, eager):
    """Phase 15; returns ``{kernel: launches inside graph replays}``
    over its paths. Every profiled run comes after every timed one."""
    from mxnet_tpu_torch import graphs

    t0 = time.perf_counter()
    graphs.reset_replayed_launches()
    profiles = []
    m = {"decode": hybrid_decode(seed, dev, power_line, eager["decode"],
                                 profiles),
         "encoder": hybrid_encoder(seed, dev, power_line,
                                   eager["encoder"], profiles),
         "bert_mlm": hybrid_bert_mlm(seed, dev, power_line, profiles),
         "fop_bert": hybrid_fop_bert(seed, dev, power_line, None),
         "embedding_probe": embedding_probe(dev)}
    in_graph = graphs.replayed_launches()
    m["wordlm"] = hybrid_wordlm(seed, dev, power_line)
    for k, n in graphs.replayed_launches().items():
        in_graph[k] = in_graph.get(k, 0) + n
    m["chain_steps"] = hybrid_chain_steps(dev, power_line)
    m["vision"] = vision_both(seed, dev, power_line)
    missing = [k for k in KERNEL_NAMES if not in_graph.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched inside a graph: "
                             f"{missing}")
    for profile in profiles:
        profile()
    log(f"phase 15 (hybridize): every kernel launched inside a graph "
        f"{in_graph}; {time.perf_counter() - t0:.1f} s")
    log(f"empty graphs captured in this run (phases 1-15): "
        f"{graphs.empty_captures() or 'none'}")
    log("hybridize metrics: " + json.dumps(
        m, default=lambda o: None))
    return in_graph


# -- phase 16: Wide&Deep and row_sparse ---------------------------------------
#: ``train-widedeep-criteo-b1024``: the model zoo's ``wide_deep()`` widths
#: and ``example/wide_deep.py``'s training defaults
WD = dict(wide_dim=100000, field_dim=10000, batch=1024, lr=1e-3, warmup=3,
          steps=20)
#: card against CPU: the tables cut so the CPU side takes a second
WD_SMALL = dict(wide_dim=5000, field_dim=500, steps=3)


def _wd_build(seed, dev, hybridize, fused=True, **widths):
    from mxnet_tpu_torch.examples import wide_deep as ex

    w = dict(WD, **widths)
    return ex.build(dev, w["wide_dim"], w["field_dim"], lr=WD["lr"],
                    seed=seed, fused_fields=fused, hybridize=hybridize)


def _wd_batch(seed, dev, **widths):
    from mxnet_tpu_torch.examples import wide_deep as ex

    w = dict(WD, **widths)
    return ex.synthetic_batch(WD["batch"], w["wide_dim"], w["field_dim"],
                              seed, dev)


def _wd_grads_live(params, where):
    """Every gradient finite and not all zero (both tables, the MLP)."""
    import torch

    dead = []
    for name, p in params.items():
        g = p.grad()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{where}: {name}: non-finite gradient")
        if g.abs().max().item() == 0.0:
            dead.append(name)
    if dead:
        raise AssertionError(f"{where}: all-zero gradients: {dead}")


def wd_train(seed, dev, hybridize, batch):
    """``WD['warmup']`` + ``WD['steps']`` Adam steps of a model built
    from ``seed`` on ``batch``; the losses, step times, captures (during
    the warm-up and after it), the peak memory the run added to what
    was allocated before it, and the final weights."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import graphs
    from mxnet_tpu_torch.examples import wide_deep as ex

    base = torch.cuda.memory_allocated(dev)
    net, loss_fn, trainer = _wd_build(seed, dev, hybridize)
    c0 = graphs.captures()
    warm = [ex.train_step(net, loss_fn, trainer, batch)[1].double().mean()
            for _ in range(WD["warmup"])]
    warm = torch.stack(warm).tolist()
    torch.cuda.synchronize()
    c1 = graphs.captures()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(WD["steps"]):
        t0 = time.perf_counter()
        _, loss = ex.train_step(net, loss_fn, trainer, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.double().mean().item())
    params = net.collect_params()
    run = {"net": net, "loss_fn": loss_fn, "trainer": trainer,
           "params": params, "warm": warm, "losses": losses,
           "times": times, "p50": float(np.median(times)),
           "captures_warmup": c1 - c0,
           "captures_after": graphs.captures() - c1,
           "peak": torch.cuda.max_memory_allocated(dev) - base,
           "weights": {k: p.data().detach().clone()
                       for k, p in params.items()}}
    return run


def wd_profile(run, batch, graphed, steps=5):
    """``steps`` profiled steps: the device's busy share of their wall;
    for the graphed model also that the tables' gradient
    (``segment_sum``'s ``segment_reduce``) ran on the device while no
    host call made it: inside the backward graph's replays."""
    import torch
    from torch.autograd import DeviceType

    from mxnet_tpu_torch.examples import wide_deep as ex

    torch.cuda.synchronize()
    with _profiler(True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ex.train_step(run["net"], run["loss_fn"], run["trainer"],
                          batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"wide&deep {'graphed' if graphed else 'eager'}: {steps} steps "
        f"profiled, {wall / steps * 1e3:.3f} ms a step under the "
        f"profiler:")
    busy = report_profile(prof, wall)
    on_dev = on_host = 0
    for e in prof.key_averages():
        if "segment_reduce" in e.key:
            if e.device_type == DeviceType.CUDA:
                on_dev += e.count
            else:
                on_host += e.count
    if not on_dev:
        raise AssertionError("the tables' gradient kernel is not in the "
                             "trace")
    if graphed and on_host:
        raise AssertionError(f"graphed step: the host called "
                             f"segment_reduce {on_host} times (the "
                             f"embedding backward ran outside the graph)")
    if not graphed and not on_host:
        raise AssertionError("eager step: no host call of segment_reduce")
    return busy, on_dev


def _same_bits(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) for k in a)


def _gap(got, want):
    """The largest gap of each array, over its own largest magnitude."""
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].double().abs().max()), 1e-30)
               for k in want)


def wd_layouts_agree(seed, dev):
    """The per-field layout with the fused model's weights (its table
    split by field) gives the fused model's output, loss and gradients
    (the tables' split likewise): the same bits or within 1e-6 of each
    array's scale, said which."""
    import torch

    from mxnet_tpu_torch import autograd

    batch = _wd_batch(seed, dev)
    out = {}
    for fused in (True, False):
        net, loss_fn, _ = _wd_build(seed, dev, False, fused=fused)
        net(*batch[:3])                 # the MLP's deferred shapes
        if not fused:
            src = out[True]["weights"]
            nfield = WD["field_dim"]
            with torch.no_grad():
                for name, p in net.named_parameters():
                    if name.split(".")[0].isdigit():
                        i = int(name.split(".")[0]) - 1
                        p.copy_(src["field_embed.weight"][
                            i * nfield:(i + 1) * nfield])
                    else:
                        p.copy_(src[name])
        with autograd.record():
            o = net(*batch[:3])
            loss = loss_fn(o, batch[3])
        autograd.backward(loss)
        grads = {n: p.grad.detach().clone()
                 for n, p in net.named_parameters()}
        if not fused:
            grads["field_embed.weight"] = torch.cat(
                [grads.pop(f"{i + 1}.weight") for i in range(26)])
        out[fused] = {"out": o.detach(), "loss": loss.detach(),
                      "grads": grads,
                      "weights": {n: p.detach().clone()
                                  for n, p in net.named_parameters()}}
    a, b = out[True], out[False]
    same = torch.equal(a["out"], b["out"]) and _same_bits(a["grads"],
                                                          b["grads"])
    gap = max(_gap({"o": b["out"]}, {"o": a["out"]}),
              _gap(b["grads"], a["grads"]))
    if gap > 1e-6:
        raise AssertionError(f"layouts disagree: {gap:.3g} of scale")
    log(f"layouts: per-field with the fused weights gives the fused "
        f"output and gradients {'bit for bit' if same else f'within {gap:.3g} of scale'}")
    return {"same_bits": same, "gap": gap}


def wd_card_vs_cpu(seed, dev, steps=WD_SMALL["steps"]):
    """wide_dim 5000, fields of 500, the same weights and batch on the
    card and the CPU: step 1's loss within 1e-4 relative and gradients
    within 1e-3 of each parameter's largest CPU gradient (phase 9's
    gates), then ``steps`` Adam steps, losses within 1e-4 relative."""
    import torch

    from mxnet_tpu_torch import autograd

    small = {k: WD_SMALL[k] for k in ("wide_dim", "field_dim")}
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        net, loss_fn, trainer = _wd_build(seed, device, False, **small)
        batch = _wd_batch(seed, device, **small)
        net(*batch[:3])                 # the MLP's deferred shapes
        if side == "cpu":
            with torch.no_grad():
                for n, p in net.named_parameters():
                    p.copy_(res["card"]["init"][n])
        init = {n: p.detach().cpu().clone()
                for n, p in net.named_parameters()}
        losses, grads = [], None
        for _ in range(steps + 1):
            with autograd.record():
                loss = loss_fn(net(*batch[:3]), batch[3])
            autograd.backward(loss)
            losses.append(loss.double().mean().item())
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in net.named_parameters()}
            trainer.step(batch[0].shape[0])
        res[side] = {"init": init, "losses": losses, "grads": grads}
    card, cpu = res["card"], res["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                               cpu["losses"])]
    ggap = {n: float((card["grads"][n] - g).abs().max())
            / max(float(g.abs().max()), 1e-30)
            for n, g in cpu["grads"].items()}
    if max(rel) > 1e-4 or max(ggap.values()) > 1e-3:
        raise AssertionError(f"card vs CPU: losses {rel}, gradients "
                             f"{ggap}")
    log(f"card vs CPU (wide_dim {small['wide_dim']}, fields of "
        f"{small['field_dim']}): losses of step 1 and {steps} Adam steps "
        f"within {max(rel):.3g} relative; step-1 gradients within "
        f"{max(ggap.values()):.3g} of scale")
    return {"loss_rel": rel, "grad_gap": ggap}


def sparse_card_vs_cpu(seed, dev):
    """The sparse machinery on the card against the same calls on the
    CPU: ``cast_storage`` both ways, ``retain``, ``dot(csr, dense)`` and
    ``dot(csr.T, dense)`` (a 256 x 10000 batch of 16 nnz a row, the
    sparse linear example's widths), ``row_sparse_pull`` to a dense and
    a row_sparse destination (the wide table, 51200 ids), and row_sparse
    pushes with repeated ids (the fields' table, 26624 ids) through the
    SGD, momentum, Adam and AdaGrad updaters. Moves exact, sums within
    1e-6 of scale, a second card run the same bits, rows not pushed
    unchanged bit for bit."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp

    rs = np.random.RandomState(seed)
    dense = np.zeros((2000, 64), np.float32)
    rows = rs.choice(2000, 600, replace=False)
    dense[rows] = rs.randn(600, 64).astype(np.float32)
    nnz = np.zeros((256, 10000), np.float32)
    for r in range(256):
        nnz[r, rs.choice(10000, 16, replace=False)] = rs.rand(16) + 0.1
    rhs = rs.randn(10000, 4).astype(np.float32)
    rhs_t = rs.randn(256, 4).astype(np.float32)
    table = rs.randn(WD["wide_dim"], 2).astype(np.float32)
    pull_ids = rs.randint(0, WD["wide_dim"], 51200)
    fields = 26 * WD["field_dim"]
    w0 = rs.randn(fields, 16).astype(np.float32)
    push_ids = [rs.randint(0, fields, 26624) for _ in range(2)]
    push_g = [rs.randn(26624, 16).astype(np.float32) for _ in range(2)]
    optimizers = {"sgd": dict(learning_rate=0.1, wd=1e-4),
                  "sgd_momentum": dict(learning_rate=0.1, momentum=0.9),
                  "adam": dict(learning_rate=1e-3),
                  "adagrad": dict(learning_rate=0.1)}

    def run(ctx):
        out = {}
        with ctx:
            x = mx.nd.array(dense)
            rsp = sp.cast_storage(x, "row_sparse")
            csr = sp.cast_storage(x, "csr")
            out["rsp_ids"], out["rsp_vals"] = rsp.indices, rsp.data
            out["csr_ids"], out["csr_ptr"] = csr.indices, csr.indptr
            out["rsp_back"] = sp.cast_storage(rsp, "default")
            out["csr_back"] = csr.tostype("default")
            kept = sp.retain(rsp, mx.nd.array(rows[::3].astype(np.int64)))
            out["retain"] = kept.todense()
            batch = sp.csr_matrix(nnz)
            out["dot"] = sp.dot(batch, mx.nd.array(rhs))
            out["dot_t"] = sp.dot(batch, mx.nd.array(rhs_t),
                                  transpose_a=True)
            kv = mx.kv.create("local")
            kv.init("wide", mx.nd.array(table))
            dst = mx.nd.zeros(table.shape)
            kv.row_sparse_pull("wide", out=dst, row_ids=mx.nd.array(pull_ids))
            out["pull_dense"] = dst
            rdst = sp.zeros("row_sparse", table.shape)
            kv.row_sparse_pull("wide", out=rdst,
                               row_ids=mx.nd.array(pull_ids))
            out["pull_ids"], out["pull_vals"] = rdst.indices, rdst.data
            for name, kw in optimizers.items():
                kv = mx.kv.create("local")
                kv.init("weight", mx.nd.array(w0))
                opt = "sgd" if name.startswith("sgd") else name
                kv.set_optimizer(mx.optimizer.create(opt, **kw))
                for ids, g in zip(push_ids, push_g):
                    kv.push("weight", sp.row_sparse_array(
                        (g, ids), shape=w0.shape))
                w = mx.nd.zeros(w0.shape)
                kv.pull("weight", out=w)
                out["push_" + name] = w
        return {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                else v for k, v in out.items()}

    card, again = run(mx.gpu(dev.index)), run(mx.gpu(dev.index))
    cpu = run(mx.cpu())
    exact = [k for k in card if not k.startswith(("dot", "push"))]
    bad = [k for k in exact if not torch.equal(card[k], cpu[k])]
    if bad:
        raise AssertionError(f"card vs CPU: not the same values: {bad}")
    gaps = {k: _gap({k: card[k]}, {k: cpu[k]}) for k in card
            if k not in exact}
    if max(gaps.values()) > 1e-6:
        raise AssertionError(f"card vs CPU: {gaps}")
    unequal = [k for k in card if not torch.equal(card[k], again[k])]
    if unequal:
        raise AssertionError(f"a second card run gave other bits: "
                             f"{unequal}")
    untouched = np.setdiff1d(np.arange(fields), np.concatenate(push_ids))
    w0_t = torch.from_numpy(w0)
    for name in optimizers:
        if not torch.equal(card["push_" + name][untouched], w0_t[untouched]):
            raise AssertionError(f"{name}: rows not pushed moved")
    log(f"sparse ops on the card vs the CPU: moves exact ({', '.join(exact)}"
        f"), sums within {max(gaps.values()):.3g} of scale "
        f"({', '.join(f'{k} {v:.2g}' for k, v in gaps.items())}); a second "
        f"card run bit for bit; {untouched.size} rows not pushed unchanged "
        f"under each updater")
    return {"gaps": gaps, "exact": exact}


#: steps an epoch of ``example/sparse_linear.py`` at its defaults
SPARSE_LINEAR_STEPS = 4096 // 256


def reference_sparse_scripts(power_line):
    """``example/wide_deep.py`` and ``example/sparse_linear.py`` at their
    defaults through the runner: their own gates (accuracy > 0.65, >
    0.8) and no launch of a port kernel."""
    import numpy as np

    out = {}
    for script, key in (("example/wide_deep.py", "accuracy="),
                        ("example/sparse_linear.py", "train accuracy")):
        lines, stamps, counts, wall = run_reference_script(script, [],
                                                           timeout=600)
        got = {k: n for k, n in counts.items() if n}
        if got:
            raise AssertionError(f"{script} launched port kernels: {got}")
        epochs, secs = _epoch_lines(lines, stamps, key)
        out[script] = {"epochs": epochs, "epoch_s": secs, "wall_s": wall}
        log(f"reference {script} (defaults): {epochs[-1]}; seconds by "
            f"epoch {[round(s, 3) for s in secs]} (epoch 0 from the "
            f"child's start); wall {wall:.1f} s [{power_line}]")
    secs = out["example/sparse_linear.py"]["epoch_s"][1:]
    step = float(np.median(secs)) / SPARSE_LINEAR_STEPS
    out["sparse_linear_step_ms"] = step * 1e3
    log(f"sparse_linear.py: {step * 1e3:.2f} ms a step (the median epoch "
        f"over {SPARSE_LINEAR_STEPS} steps: csr_to_ell and np.unique on "
        f"the host, row_sparse_pull, forward, backward, push) "
        f"[{power_line}]")
    return out


def wide_deep_phase(seed, dev, power_line):
    """Phase 16 (module docstring); returns its metrics."""
    import gc

    import numpy as np
    import torch

    from mxnet_tpu_torch import ops

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ops.reset_launch_counts()       # the whole phase launches none
    batch = _wd_batch(seed, dev)
    eager = wd_train(seed, dev, False, batch)
    graphed = wd_train(seed, dev, True, batch)
    again = wd_train(seed, dev, True, batch)
    for name, r in (("eager", eager), ("graphed", graphed)):
        _wd_grads_live(r["params"], name)
        first, last = np.mean(r["losses"][:5]), np.mean(r["losses"][-5:])
        if not np.all(np.isfinite(r["warm"] + r["losses"])):
            raise AssertionError(f"{name}: non-finite loss")
        if not last < first:
            raise AssertionError(f"{name}: loss did not fall: "
                                 f"{r['losses']}")
    if not graphed["captures_warmup"] or graphed["captures_after"]:
        raise AssertionError(
            f"graphed: {graphed['captures_warmup']} captures in the "
            f"warm-up, {graphed['captures_after']} after it")
    if again["warm"] + again["losses"] != graphed["warm"] + \
            graphed["losses"] or not _same_bits(again["weights"],
                                                graphed["weights"]):
        raise AssertionError("a second graphed model from the seed gave "
                             "other bits")
    lrel = max(abs(a - b) / abs(b) for a, b in zip(
        eager["warm"] + eager["losses"], graphed["warm"] + graphed["losses"]))
    same = lrel == 0.0 and _same_bits(eager["weights"], graphed["weights"])
    if lrel > 1e-6:
        raise AssertionError(f"graphed vs eager losses: {lrel:.3g}")
    busy_e, _ = wd_profile(eager, batch, False)
    busy_g, seg = wd_profile(graphed, batch, True)
    b = WD["batch"]
    log(f"train-widedeep-criteo-b1024 (wide_dim {WD['wide_dim']}, 26 "
        f"fields of {WD['field_dim']}, embed 16, MLP 256-128-64-2, Adam "
        f"{WD['lr']}, {WD['warmup']} + {WD['steps']} steps on one "
        f"batch): eager p50 {eager['p50'] * 1e3:.3f} ms "
        f"({b / eager['p50']:.0f} examples/s), graphed p50 "
        f"{graphed['p50'] * 1e3:.3f} ms ({b / graphed['p50']:.0f} "
        f"examples/s; {graphed['captures_warmup']} captures in the "
        f"warm-up, none after); busy {_busy(busy_e)} eager, "
        f"{_busy(busy_g)} graphed (profiled steps; {seg} segment_reduce "
        f"kernels in the graphed trace, no host call); peak memory added "
        f"{eager['peak'] / 2 ** 30:.3f} GiB eager, "
        f"{graphed['peak'] / 2 ** 30:.3f} GiB graphed; loss "
        f"{graphed['losses'][0]:.6f} -> {graphed['losses'][-1]:.6f}; "
        f"second graphed model bit for bit; graphed vs eager "
        f"{'bit for bit' if same else f'losses within {lrel:.3g}'} "
        f"[{power_line}]")
    layouts = wd_layouts_agree(seed, dev)
    cross = wd_card_vs_cpu(seed, dev)
    sparse = sparse_card_vs_cpu(seed, dev)
    scripts = reference_sparse_scripts(power_line)
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    if counts:
        raise AssertionError(f"the Wide&Deep phase launched port kernels: "
                             f"{counts}")
    m = {"eager_step_ms": eager["times"], "graphed_step_ms":
         graphed["times"], "eager_p50_ms": eager["p50"] * 1e3,
         "graphed_p50_ms": graphed["p50"] * 1e3,
         "examples_per_s": {"eager": b / eager["p50"],
                            "graphed": b / graphed["p50"]},
         "busy": {"eager": busy_e, "graphed": busy_g},
         "peak_memory_bytes": {"eager": eager["peak"],
                               "graphed": graphed["peak"]},
         "losses": graphed["losses"], "graphed_vs_eager_bits": same,
         "layouts": layouts, "card_vs_cpu": cross, "sparse": sparse,
         "scripts": scripts, "card": power_line}
    log(f"phase 16 (Wide&Deep and row_sparse): no port kernel launched; "
        f"{time.perf_counter() - t_phase:.1f} s")
    log("widedeep metrics: " + json.dumps(m, default=lambda o: None))
    for r in (eager, graphed, again):
        r.clear()
    return m


# -- phase 17: the symbolic API -----------------------------------------------
#: the arguments of the symbolic word LM that are inputs, not weights
SYM_INPUTS = ("data", "softmax_label", "lstm_state", "lstm_state_cell")
#: its weights, in the updater's index order
SYM_WEIGHTS = ("embed_weight", "lstm_parameters", "decoder_weight",
               "decoder_bias")
#: card against CPU: 2 layers at small widths
SYM_SMALL = dict(vocab=1000, emb=200, hid=200, layers=2, batch=8, bptt=35,
                 steps=3)


def sym_wordlm(mx, vocab, emb, hid, layers, bptt):
    """``train-wordlm-wt2-b32t35-sym``'s graph: ``sym.Embedding`` ->
    ``sym.RNN`` (lstm, the final states out) -> ``Reshape`` ->
    ``FullyConnected`` -> ``SoftmaxOutput``, time-major (data (T, N),
    labels (T * N,)), the final states as ``BlockGrad`` outputs to carry
    into the next segment. ``SoftmaxOutput`` with normalization
    ``"null"`` and ``grad_scale`` 1 / T gives each position ``(p -
    onehot) / T``: the gradient of the Gluon loop's loss (each row's
    mean over its T tokens, summed over the rows)."""
    with mx.name.NameManager():
        e = mx.sym.Embedding(mx.sym.var("data"), input_dim=vocab,
                             output_dim=emb, name="embed")
        r = mx.sym.RNN(e, state_size=hid, num_layers=layers, mode="lstm",
                       state_outputs=True, name="lstm")
        flat = mx.sym.Reshape(r[0], shape=(-1, hid), name="flat")
        fc = mx.sym.FullyConnected(flat, num_hidden=vocab, name="decoder")
        out = mx.sym.SoftmaxOutput(fc, mx.sym.var("softmax_label"),
                                   grad_scale=1.0 / bptt,
                                   normalization="null", name="softmax")
        return mx.sym.Group([out, mx.sym.BlockGrad(r[1], name="h"),
                             mx.sym.BlockGrad(r[2], name="c")])


def sym_shapes(vocab, emb, hid, layers, bptt, batch):
    """Every argument's shape, given explicitly (``infer_shape`` has no
    rule for the RNN op's flat parameters, as the JAX package's has
    none)."""
    from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size

    return dict(data=(bptt, batch), softmax_label=(bptt * batch,),
                embed_weight=(vocab, emb),
                lstm_parameters=(rnn_param_size(layers, emb, hid, False,
                                                "lstm"),),
                lstm_state=(layers, batch, hid),
                lstm_state_cell=(layers, batch, hid),
                decoder_weight=(vocab, hid), decoder_bias=(vocab,))


def sym_bind(sym, ctx, shapes, weights):
    """``simple_bind`` with every shape, gradients for the weights only,
    then the weights copied in."""
    req = {n: "null" if n in SYM_INPUTS else "write"
           for n in sym.list_arguments()}
    ex = sym.simple_bind(ctx, grad_req=req, **shapes)
    for n, w in weights.items():
        ex.arg_dict[n][:] = w
    return ex


def sym_segments(data, bptt, device):
    """The word LM's BPTT segments, time-major: ``(data (T, N) float32,
    labels (T * N,) float32)`` for the symbol, and the same rows
    batch-major as int64 for the Gluon model."""
    import torch

    d = torch.as_tensor(data, device=device).long()
    out = []
    for i in range(0, d.shape[1] - 1 - bptt, bptt):
        xb, yb = d[:, i:i + bptt], d[:, i + 1:i + 1 + bptt]
        out.append((xb.t().float().contiguous(),
                    yb.t().reshape(-1).float().contiguous(), xb, yb))
    return out


def sym_step(ex, upd, x, y, clip_norm):
    """One BPTT segment through the bound graph: forward, backward,
    ``clip_global_norm``, the updater on every weight in place, the final
    states into the next segment's; returns the loss per token (on the
    card)."""
    import torch

    from mxnet_tpu_torch.gluon.utils import clip_global_norm

    outs = ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    clip_global_norm([ex.grad_dict[n] for n in SYM_WEIGHTS], clip_norm)
    for i, n in enumerate(SYM_WEIGHTS):
        upd(i, ex.grad_dict[n], ex.arg_dict[n])
    with torch.no_grad():
        ex.arg_dict["lstm_state"].copy_(outs[1])
        ex.arg_dict["lstm_state_cell"].copy_(outs[2])
        p = outs[0].as_subclass(torch.Tensor)
        return -p.gather(1, y.long()[:, None]).log().mean()


def sym_updater(bptt, batch):
    """The word LM's SGD (lr 1.0, the step's gradient over bptt x batch,
    as ``trainer.step(bptt * batch)``)."""
    from mxnet_tpu_torch import optimizer

    return optimizer.get_updater(optimizer.create(
        "sgd", learning_rate=WLM["lr"], rescale_grad=1.0 / (bptt * batch)))


def sym_weights_of(net):
    """The Gluon word LM's weights under the symbol's names (the LSTM's
    packed by ``pack_rnn_params``)."""
    from mxnet_tpu_torch.ndarray.op_impl_rnn import pack_rnn_params

    return {"embed_weight": net.embed.weight.detach(),
            "lstm_parameters": pack_rnn_params(
                [tuple(t.detach() for t in lp)
                 for lp in net.rnn.layer_params()]),
            "decoder_weight": net.decoder.weight.detach(),
            "decoder_bias": net.decoder.bias.detach()}


def sym_against_gluon(seed, dev, ex, net, seg):
    """Step 1 of the bound graph against the Gluon word LM it took its
    weights from (dropout 0, zero states): softmax outputs within 1e-5
    and every weight's gradient within 1e-3 of scale."""
    import torch

    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ndarray.op_impl_rnn import pack_rnn_params

    x, y, xb, yb = seg
    vocab = WLM["vocab"]
    with autograd.record():
        logits, _ = net(xb, net.begin_state(xb.shape[0], dev))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits, yb)
    autograd.backward(loss)
    want_p = torch.softmax(logits.detach().float(), -1).transpose(0, 1) \
        .reshape(-1, vocab)
    want_g = {"embed_weight": net.embed.weight.grad,
              "lstm_parameters": pack_rnn_params(
                  [tuple(t.grad for t in lp)
                   for lp in net.rnn.layer_params()]),
              "decoder_weight": net.decoder.weight.grad,
              "decoder_bias": net.decoder.bias.grad}
    outs = ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    out_gap = _grad_gap(outs[0], want_p)
    grad_gaps = {n: _grad_gap(ex.grad_dict[n], g) for n, g in want_g.items()}
    if out_gap > 1e-5 or max(grad_gaps.values()) > 1e-3:
        raise AssertionError(f"symbolic LM vs the Gluon model: outputs "
                             f"{out_gap:.3g} of scale (tol 1e-5), "
                             f"gradients {grad_gaps} (tol 1e-3)")
    return out_gap, grad_gaps


def _sym_train(ex, upd, segs, clip_norm, warmup, steps):
    """``warmup`` then ``steps`` segments; returns the losses, the
    measured segments' wall times, launches and the captures in the
    warm-up and after it."""
    import torch

    from mxnet_tpu_torch import graphs, ops

    c0 = graphs.captures()
    losses = [sym_step(ex, upd, x, y, clip_norm)
              for x, y, _, _ in segs[:warmup]]
    torch.cuda.synchronize()
    c1 = graphs.captures()
    ops.reset_launch_counts()
    times = []
    for x, y, _, _ in segs[warmup:warmup + steps]:
        t0 = time.perf_counter()
        losses.append(sym_step(ex, upd, x, y, clip_norm))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    return ([loss.double().item() for loss in losses], times, counts,
            c1 - c0, graphs.captures() - c1)


@contextlib.contextmanager
def symbolic_jit(on):
    """``MXNET_TPU_SYMBOLIC_JIT`` for the executors bound inside."""
    prev = os.environ.get("MXNET_TPU_SYMBOLIC_JIT")
    os.environ["MXNET_TPU_SYMBOLIC_JIT"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["MXNET_TPU_SYMBOLIC_JIT"]
        else:
            os.environ["MXNET_TPU_SYMBOLIC_JIT"] = prev


def sym_wordlm_main_path(seed, dev, power_line, gluon_p50, tmp, steps=20,
                         warmup=2):
    """``train-wordlm-wt2-b32t35-sym`` on the card (phase 17a and b);
    returns the measured segments' launch counts."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs

    v, e, h, n_l = WLM["vocab"], WLM["emb"], WLM["hid"], WLM["layers"]
    b, t = WLM["batch"], WLM["bptt"]
    net, _ = build_wordlm(seed, dev, v, 0.0)
    weights = {k: w.clone() for k, w in sym_weights_of(net).items()}
    sym = sym_wordlm(mx, v, e, h, n_l, t)
    shapes = sym_shapes(v, e, h, n_l, t, b)
    segs = sym_segments(wordlm_data(v, b, warmup + steps + 1), t, dev)
    clip_norm = WLM["clip"] * t * b
    ex = sym_bind(sym, mx.gpu(dev.index), shapes, weights)
    c0 = graphs.captures()
    out_gap, grad_gaps = sym_against_gluon(seed, dev, ex, net, segs[0])
    del net
    runs = {}
    for name, on in (("graphed", True), ("eager", False)):
        with symbolic_jit(on):
            run_ex = ex if on else sym_bind(sym, mx.gpu(dev.index), shapes,
                                            weights)
        losses, times, counts, cap_w, cap_a = _sym_train(
            run_ex, sym_updater(t, b), segs, clip_norm, warmup, steps)
        runs[name] = dict(losses=losses, times=times, counts=counts,
                          p50=float(np.median(times)), ex=run_ex,
                          captures=(cap_w, cap_a))
    g, eg = runs["graphed"], runs["eager"]
    per_seg = {"lstm_fwd": n_l, "lstm_bwd": n_l, "lstm_bwd_dw": n_l}
    for name, r in runs.items():
        got = {k: r["counts"][k] for k in per_seg}
        if got != {k: m * steps for k, m in per_seg.items()}:
            raise AssertionError(f"{name} symbolic LM launches {got} in "
                                 f"{steps} segments, want {per_seg} each")
        if not np.all(np.isfinite(r["losses"])):
            raise AssertionError(f"{name}: non-finite loss {r['losses']}")
        first = float(np.mean(r["losses"][warmup:warmup + 5]))
        last = float(np.mean(r["losses"][-5:]))
        if not last < first:
            raise AssertionError(f"{name}: loss did not fall: {r['losses']}")
    # the step-1 check captured the training key's forward and backward
    # graphs; nothing is captured after it
    captured = graphs.captures() - c0
    if captured != 2 or g["captures"] != (0, 0) or eg["captures"] != (0, 0):
        raise AssertionError(f"captures: {captured} in all, graphed run "
                             f"{g['captures']}, eager {eg['captures']} "
                             f"(warm-up, after); want 2 at the first call")
    lrel = max(abs(a - c) / abs(c) for a, c in zip(g["losses"],
                                                    eg["losses"]))
    same = lrel == 0.0 and all(
        torch.equal(g["ex"].arg_dict[k], eg["ex"].arg_dict[k])
        for k in SYM_WEIGHTS)
    if lrel > 1e-6:
        raise AssertionError(f"graphed vs eager losses differ by {lrel:.3g}")
    tokens = t * b
    log(f"train-wordlm-wt2-b32t35-sym (vocab {v}, embed {e}, {n_l} x "
        f"RNN lstm {h}, dropout 0, phase 8's Xavier weights, SGD lr "
        f"{WLM['lr']}, clip {WLM['clip']}): step 1 against the Gluon model "
        f"softmax within {out_gap:.3g} of scale, gradients within "
        f"{max(grad_gaps.values()):.3g} ({', '.join(f'{k} {x:.2g}' for k, x in grad_gaps.items())}); "
        f"{warmup} + {steps} segments: loss per token "
        f"{g['losses'][0]:.6f} -> {g['losses'][-1]:.6f}; step p50 "
        f"graphed {g['p50'] * 1e3:.3f} ms ({tokens / g['p50']:.0f} "
        f"tokens/s), eager walk {eg['p50'] * 1e3:.3f} ms "
        f"({tokens / eg['p50']:.0f} tokens/s), the Gluon model (phase 8, "
        f"dropout 0.2) {gluon_p50 * 1e3:.3f} ms; graphed vs eager "
        f"{'bit for bit' if same else f'losses within {lrel:.3g}'}; "
        f"launches {per_seg} a segment each way; 2 captures at the first "
        f"call, none after [{power_line}]")
    metrics = {"graphed_step_ms": [x * 1e3 for x in g["times"]],
               "eager_step_ms": [x * 1e3 for x in eg["times"]],
               "graphed_p50_ms": g["p50"] * 1e3,
               "eager_p50_ms": eg["p50"] * 1e3,
               "gluon_p50_ms": gluon_p50 * 1e3,
               "tokens_per_s": {"graphed": tokens / g["p50"],
                                "eager": tokens / eg["p50"]},
               "losses": g["losses"], "graphed_vs_eager_bits": same,
               "step1_output_gap": out_gap, "step1_grad_gaps": grad_gaps,
               "card": power_line}
    log("symbolic word LM metrics: " + json.dumps(metrics))
    sym_checkpoints(g["ex"], sym, dev, tmp, segs[0], steps + warmup)
    counts = g["counts"]
    for r in runs.values():
        r.clear()
    return counts


def sym_checkpoints(ex, sym, dev, tmp, seg, epoch):
    """Phase 17b: ``mx.model.save_checkpoint`` of the trained LM, then
    ``SymbolBlock.imports`` and ``Module.load`` on the card: their
    predict-mode outputs on one segment from zero states equal the
    executor's to the bit, each with its K6a launches."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, ops

    x, y, _, _ = seg
    prefix = os.path.join(tmp, "sym-wordlm")
    mx.model.save_checkpoint(prefix, epoch, sym,
                             {n: ex.arg_dict[n] for n in SYM_WEIGHTS}, {})
    zeros = torch.zeros_like(ex.arg_dict["lstm_state"])
    want = [o.clone() for o in ex.forward(
        is_train=False, data=x, softmax_label=y, lstm_state=zeros,
        lstm_state_cell=zeros)]
    layers = WLM["layers"]
    ops.reset_launch_counts()
    block = mx.gluon.SymbolBlock.imports(
        prefix + "-symbol.json", list(SYM_INPUTS),
        f"{prefix}-{epoch:04d}.params", ctx=mx.gpu(dev.index))
    got_b = block(*[a.as_subclass(nd.NDArray) for a in (x, y, zeros,
                                                         zeros)])
    torch.cuda.synchronize()
    n_b = ops.launch_counts()["lstm_fwd"]
    ops.reset_launch_counts()
    mod = mx.mod.Module.load(prefix, epoch, data_names=[
        "data", "lstm_state", "lstm_state_cell"],
        label_names=["softmax_label"], context=mx.gpu(dev.index))
    shapes = sym_shapes(WLM["vocab"], WLM["emb"], WLM["hid"], layers,
                        WLM["bptt"], WLM["batch"])
    mod.bind(data_shapes=[(n, shapes[n]) for n in (
        "data", "lstm_state", "lstm_state_cell", "lstm_parameters")],
        label_shapes=[("softmax_label", shapes["softmax_label"])],
        for_training=False)
    mod.init_params(arg_params=mod._preloaded_params[0],
                    aux_params=mod._preloaded_params[1])
    mod.forward(mx.io.DataBatch(data=[x, zeros, zeros], label=[y]),
                is_train=False)
    got_m = mod.get_outputs()
    torch.cuda.synchronize()
    n_m = ops.launch_counts()["lstm_fwd"]
    for name, got in (("SymbolBlock", got_b), ("Module.load", got_m)):
        if not all(torch.equal(a.as_subclass(torch.Tensor),
                               b.as_subclass(torch.Tensor))
                   for a, b in zip(got, want)):
            raise AssertionError(f"{name}: not the executor's bits")
    if n_b != layers or n_m != layers:
        raise AssertionError(f"K6a launches: SymbolBlock {n_b}, "
                             f"Module {n_m}, want {layers} each")
    log(f"checkpoint {os.path.basename(prefix)}-symbol.json + "
        f"-{epoch:04d}.params: SymbolBlock.imports and Module.load on the "
        f"card give the executor's outputs bit for bit ({len(want)} "
        f"outputs), K6a launched {layers} times by each")


def sym_card_vs_cpu(seed, dev):
    """The symbolic LM at 2 layers and small widths, card against CPU
    (phase 9's gates): three SGD segments' losses within 1e-4 relative,
    step-1 gradients within 1e-3 of scale."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    s = SYM_SMALL
    sym = sym_wordlm(mx, s["vocab"], s["emb"], s["hid"], s["layers"],
                     s["bptt"])
    shapes = sym_shapes(s["vocab"], s["emb"], s["hid"], s["layers"],
                        s["bptt"], s["batch"])
    rng = np.random.RandomState(seed + 17)
    weights = {n: torch.tensor(rng.uniform(-0.1, 0.1, shapes[n]),
                               dtype=torch.float32) for n in SYM_WEIGHTS}
    data = wordlm_data(s["vocab"], s["batch"], s["steps"])
    runs = {}
    for name, device, ctx in (("cuda", dev, mx.gpu(dev.index)),
                              ("cpu", torch.device("cpu"), mx.cpu())):
        ex = sym_bind(sym, ctx, shapes, weights)
        upd = sym_updater(s["bptt"], s["batch"])
        runs[name] = [
            sym_step(ex, upd, x, y, WLM["clip"] * s["bptt"] * s["batch"])
            .double().item() for x, y, _, _ in sym_segments(
                data, s["bptt"], device)[:s["steps"]]]
        # step-1 gradients: a fresh binding's first backward
        ex1 = sym_bind(sym, ctx, shapes, weights)
        x, y, _, _ = sym_segments(data, s["bptt"], device)[0]
        ex1.forward(is_train=True, data=x, softmax_label=y)
        ex1.backward()
        runs[name + "_grads"] = {n: ex1.grad_dict[n].detach().cpu().clone()
                                 for n in SYM_WEIGHTS}
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"],
                                                  runs["cpu"]))
    gaps = {n: _grad_gap(runs["cuda_grads"][n], g)
            for n, g in runs["cpu_grads"].items()}
    log(f"cross-device symbolic LM ({s['layers']} x {s['hid']}, vocab "
        f"{s['vocab']}, batch {s['batch']}): losses {runs['cuda']} (card) "
        f"vs {runs['cpu']} (cpu), max relative gap {rel:.3e} (tol 1e-4); "
        f"step-1 gradients within {max(gaps.values()):.3g} of scale (tol "
        f"1e-3)")
    if not rel <= 1e-4 or max(gaps.values()) > 1e-3:
        raise AssertionError(f"symbolic LM card vs CPU: losses {rel}, "
                             f"gradients {gaps}")


def sym_registry_ops(seed, dev):
    """Phase 17c: ``sym.LayerNorm``, ``sym.flash_attention`` and
    ``sym.softmax_cross_entropy`` at phase 14's shapes in one graph bound
    on the card: forward and backward (the first call captures, the
    second replays) give the ``nd`` calls' bits and exactly one launch
    of each kernel each way. Returns the replay's launches."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, ops

    rng = np.random.RandomState(seed + 17)
    lens, _, labels, _ = train_batch(seed)

    def t(shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                            device=dev)

    u, heads = BERT_BASE["units"], BERT_BASE["num_heads"]
    args = dict(x=t((TRAIN_B, TRAIN_S, u)), g=t((u,), 0.5, 1.5), b=t((u,)),
                q=t((TRAIN_B, heads, TRAIN_S, u // heads)),
                k=t((TRAIN_B, heads, TRAIN_S, u // heads)),
                v=t((TRAIN_B, heads, TRAIN_S, u // heads)),
                vl=torch.tensor(lens, device=dev),
                logits=t((len(labels), VOCAB), -4, 4),
                lab=torch.tensor(labels, device=dev).float())
    with mx.name.NameManager():
        s = {n: mx.sym.var(n) for n in args}
        sym = mx.sym.Group([
            mx.sym.LayerNorm(s["x"], s["g"], s["b"], axis=-1, eps=1e-12,
                             name="ln"),
            mx.sym.flash_attention(s["q"], s["k"], s["v"], s["vl"],
                                   name="att"),
            mx.sym.softmax_cross_entropy(s["logits"], s["lab"],
                                         name="xent")])
    req = {n: "null" if n in ("vl", "lab") else "write" for n in args}
    ex = sym.bind(mx.gpu(dev.index), {n: a.clone().as_subclass(nd.NDArray)
                                      for n, a in args.items()},
                  grad_req=req)
    want_n = {"layer_norm": 1, "layer_norm_bwd": 1, "flash_attention": 1,
              "flash_attention_bwd": 1, "softmax_xent_fwd": 1,
              "softmax_xent_bwd": 1}
    head = None
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outs = ex.forward(is_train=True)
        if head is None:
            head = [t(tuple(o.shape)) for o in outs]
        ex.backward(head)
        torch.cuda.synchronize()
        got_n = {k: n for k, n in ops.launch_counts().items() if n}
        if got_n != want_n:
            raise AssertionError(f"sym registry ops: launches {got_n}, want "
                                 f"{want_n}")
    leaves = {n: a.clone().as_subclass(nd.NDArray).requires_grad_(
        req[n] == "write") for n, a in args.items()}
    with autograd.record():
        want = [nd.LayerNorm(leaves["x"], leaves["g"], leaves["b"], axis=-1,
                             eps=1e-12),
                nd.flash_attention(leaves["q"], leaves["k"], leaves["v"],
                                   leaves["vl"]),
                nd.softmax_cross_entropy(leaves["logits"], leaves["lab"])]
    autograd.backward(want, [h.as_subclass(nd.NDArray) for h in head])
    same = all(torch.equal(o.as_subclass(torch.Tensor),
                           w.detach().as_subclass(torch.Tensor))
               for o, w in zip(outs, want)) and all(
        torch.equal(ex.grad_dict[n].as_subclass(torch.Tensor),
                    leaves[n].grad.as_subclass(torch.Tensor))
        for n in args if req[n] == "write")
    if not same:
        raise AssertionError("sym registry ops: not the nd calls' bits")
    log(f"sym.LayerNorm / flash_attention / softmax_cross_entropy bound "
        f"on the card at phase 14's shapes: forward and "
        f"{sum(r == 'write' for r in req.values())} gradients bit for bit "
        f"the nd calls', launches {want_n} a call (graph replay)")
    return want_n


def reference_symbolic_scripts(power_line):
    """Phase 17d: ``example/mnist_module.py`` and
    ``example/rnn_bucketing.py`` at their defaults through the runner:
    their own gates (accuracy > 0.8; the bucketing script's printed final
    accuracy held to its ``--quick`` gate, 0.75), no port kernel, and the
    graphs captured: the module's training key (a forward and a backward
    graph) and its predict key; one pair per bucket the batches draw,
    which every epoch replays."""
    import numpy as np

    out = {}
    lines, stamps, counts, wall = run_reference_script(
        "example/mnist_module.py", [], timeout=600)
    acc = float([ln for ln in lines if ln.startswith(
        "final accuracy")][0].split(": ")[1])
    caps = json.loads(lines[-1])["captures"]
    got = {k: n for k, n in counts.items() if n}
    if got or caps != 3 or not acc > 0.8:
        raise AssertionError(f"mnist_module.py: accuracy {acc}, captures "
                             f"{caps} (want 3), launches {got}")
    out["mnist_module"] = {"accuracy": acc, "captures": caps,
                           "wall_s": wall}
    log(f"reference mnist_module.py (defaults: 60000 synthetic, batch 64, "
        f"8 epochs of Module.fit, SGD 0.05): final accuracy {acc:.4f}; "
        f"3 captures (train forward + backward, predict); wall {wall:.1f} "
        f"s, {wall / 8:.2f} s an epoch with the child's start-up "
        f"[{power_line}]")
    # the buckets the script's batches draw (its own RandomState(7))
    rs = np.random.RandomState(7)
    buckets = (8, 16, 24)
    drawn = set()
    for _ in range(24):
        blen = buckets[rs.randint(3)]
        drawn.add(blen)
        rs.randn(16, blen, 4)
        rs.randint(0, 2, (16, 1, 1))
    drawn.add(buckets[-1])                  # the bound default bucket
    lines, stamps, counts, wall = run_reference_script(
        "example/rnn_bucketing.py", [], timeout=600)
    acc = float([ln for ln in lines if ln.startswith(
        "final train accuracy")][0].split(": ")[1])
    caps = json.loads(lines[-1])["captures"]
    got = {k: n for k, n in counts.items() if n}
    epochs, secs = _epoch_lines(lines, stamps, "train")
    if got or caps != 2 * len(drawn) or not acc >= 0.75:
        raise AssertionError(f"rnn_bucketing.py: accuracy {acc} (gate "
                             f"0.75), captures {caps} (want "
                             f"{2 * len(drawn)}), launches {got}")
    out["rnn_bucketing"] = {"accuracy": acc, "captures": caps,
                            "epoch_s": secs, "wall_s": wall}
    log(f"reference rnn_bucketing.py (defaults: buckets 8/16/24, hidden "
        f"32, batch 16, 10 epochs of 24 batches, Adam 5e-3): final train "
        f"accuracy {acc:.3f}; {caps} captures, a forward and a backward "
        f"graph for each of the {len(drawn)} buckets, none after the "
        f"first epoch; seconds by epoch {[round(s, 3) for s in secs]} "
        f"(epoch 0 from the child's start); wall {wall:.1f} s "
        f"[{power_line}]")
    return out


def symbolic_phase(seed, dev, power_line, gluon_p50):
    """Phase 17 (module docstring); returns its launches by kernel: the
    symbolic LM's measured segments (K6a/K6b) and the registry graph's
    replay (K1/K2, K3a/K3b, K4a/K4b)."""
    import gc
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts = sym_wordlm_main_path(seed, dev, power_line, gluon_p50, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    sym_card_vs_cpu(seed, dev)
    counts = {k: n for k, n in counts.items() if n}
    counts.update(sym_registry_ops(seed, dev))
    reference_symbolic_scripts(power_line)
    log(f"phase 17 (the symbolic API): {time.perf_counter() - t_phase:.1f} "
        f"s")
    return counts


KERNEL_NAMES = ("paged_attention", "flash_attention", "flash_attention_bwd",
                "layer_norm", "layer_norm_bwd", "softmax_xent_fwd",
                "softmax_xent_bwd", "lstm_fwd", "lstm_bwd", "lstm_bwd_dw")


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
    decode, decode_info = serve_main_path(args.seed, args.profile, dev,
                                          power_line)
    encoder, encoder_info = serve_encoder(args.seed, args.profile, dev,
                                          power_line)
    train, zoo_p50 = train_main_path(args.seed, args.profile, dev,
                                     power_line)
    wordlm, wordlm_p50 = train_wordlm_main_path(args.seed, args.profile,
                                                dev, power_line)
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
    # mx.nd and user HybridBlocks: the registry's kernel calls, then the
    # F-op BERT's training (launches counted from 0 over its own steps)
    by_nd = nd_and_hybrid_blocks(args.seed, dev, power_line, zoo_p50)
    for e in entries:
        if e["name"] in by_nd:
            e.setdefault("launches_by_path", {})["nd"] = by_nd[e["name"]]
        if e["name"] == "lstm_bwd":
            e["launches_by_path"]["nd_by_kernel"] = {
                k: by_nd[k] for k in ("lstm_bwd", "lstm_bwd_dw")}
    # hybridize: the paths again as CUDA graphs, beside their eager runs
    in_graph = hybridize_phase(args.seed, dev, power_line, {
        "decode": decode_info, "encoder": encoder_info})
    for e in entries:
        e["launches_in_graph"] = {
            k: in_graph.get(k, 0) for k in (
                ("lstm_bwd", "lstm_bwd_dw") if e["name"] == "lstm_bwd"
                else (e["name"],))}
    # Wide&Deep and row_sparse: no port kernel on this path
    wide_deep_phase(args.seed, dev, power_line)
    # the symbolic API: the LM's bound graph (K6a/K6b), the registry
    # ops' graph (K1/K2, K3a/K3b, K4a/K4b), checkpoints, the scripts
    by_sym = symbolic_phase(args.seed, dev, power_line, wordlm_p50)
    for e in entries:
        if e["name"] in by_sym:
            e.setdefault("launches_by_path", {})["sym"] = by_sym[e["name"]]
        if e["name"] == "lstm_bwd":
            e["launches_by_path"]["sym_by_kernel"] = {
                k: by_sym[k] for k in ("lstm_bwd", "lstm_bwd_dw")}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
