#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card's name and power limit;
2. build every kernel of the decode-serving path from ``mxnet_tpu_torch/
   ops/csrc`` (one ``nvcc`` per source, all at once);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, in float32 and bfloat16, with its
   time, the plain version's, a library yardstick and the bound;
4. the main path at GPT-2-small width (vocab 50257, 768 units, 12
   layers, 12 heads, random weights from ``--seed``): a ``DecodeEngine``
   serves 8 greedy requests; results, streams, solo parity and the
   kernel launch counts are checked, serving metrics printed;
5. a 2-layer model with the same seed on the card and on the CPU:
   greedy tokens agree, logits agree within ``atol=1e-3``.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the ``mxnet_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 FLOP/s outside the
# tensor cores (the kernel's math is f32 on CUDA cores)
PEAK_HBM_BPS = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
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
            ms = cuda_ms(lambda: paged_flash_attention(*args))
            plain_ms = cuda_ms(lambda: paged_attention_reference(*args),
                               iters=20)
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
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask))
            nbytes, flops = paged_work(c["b"], c["h"], c["sq"], c["d"],
                                       c["page_size"], c["width"],
                                       c["kv_lens"], 4)
            t_bytes = nbytes / PEAK_HBM_BPS * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations",
                         "library_ms": library_ms,
                         "library": "SDPA on pre-gathered K/V, gather "
                                    "excluded"}
            log(f"paged_attention {name} f32: {ms * 1e3:.2f} us kernel, "
                f"{plain_ms * 1e3:.2f} us plain, "
                f"{library_ms * 1e3:.2f} us library_ms (SDPA on "
                f"pre-gathered K/V, gather excluded), bound "
                f"{out[name]['bound_ms'] * 1e3:.2f} us "
                f"({out[name]['bound_by']}: {nbytes} B, {flops} flop)")
    entry = {"name": "paged_attention", "route": "cuda",
             "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
             "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:1027",
             "shape": "decode B=8 H=12 Sq=1 D=64 page 16 width 64 f32"}
    entry.update(out["decode"])
    entry["chunk"] = dict(out["chunk"],
                          shape="chunk B=1 H=12 Sq=64 D=64 width 16 f32")
    return entry


def _profiler(on):
    import contextlib

    import torch

    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def report_profile(prof, wall):
    """Device time by kernel over the serving window, and the device's
    busy share of the window's wall (the profiler's own overhead
    inflates the wall; read shares, not rates, from a profiled run)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    log(f"profile: device busy {busy:.4f} s of {wall:.4f} s wall "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in rows[:15]:
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and test inputs")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving window with torch.profiler "
                         "(device time by kernel, busy share)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        print("chip_smoke.py: the mxnet_tpu_torch package is not beside "
              "this script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

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
    entries = [check_paged_attention(rng, dev)]
    counts = serve_main_path(args.seed, args.profile, dev, power_line)
    for e in entries:
        e["launches"] = counts[e["name"]]
        e["card"] = power_line
    cross_device(args.seed, dev)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
