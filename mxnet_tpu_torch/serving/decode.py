"""Autoregressive decode serving: iteration-level continuous batching
over a paged KV cache, with streamed tokens.

The encoder :class:`~.engine.ServingEngine` re-forms a batch per
REQUEST; a decode server must re-form it per TOKEN. The
:class:`DecodeEngine` worker runs the Orca-style loop:

1. **Join at any iteration boundary.** Queued prompts are admitted
   between decode iterations — at most
   ``MXNET_TPU_DECODE_PREFILLS_PER_ITER`` prefills in flight per
   boundary. Prompts are NOT prefilled in one dense step: they are cut
   into kernel-sized chunks (``batcher.PrefillChunks`` buckets) and
   interleaved at iteration boundaries under a per-iteration token
   budget (``MXNET_TPU_DECODE_PREFILL_BUDGET``), so a 2k-token prompt
   never stalls the running batch for more than one chunk — the
   long-prompt TTFT vs everyone-else inter-token-p99 trade, both
   measured (``0`` restores whole-prompt dense prefill, the A/B
   baseline). Admission first asks the pool for a cached PREFIX match
   (``MXNET_TPU_KV_PREFIX``): full prompt-prefix pages computed by an
   earlier same-prefix request attach read-only (refcounted owner
   sets, copy-on-write at the divergence page), and the chunk loop
   starts at the first unmatched token — prefix hits cut both TTFT
   and device-s/1k-tokens. Admission reserves each request's
   WORST-CASE page budget up front, so the decode loop can never
   deadlock on an exhausted pool mid-generation — a join that doesn't
   fit is deferred (front of queue), not failed.
2. **One decode iteration** advances every live sequence by one token:
   a single step over the (rows × table-width) bucket
   (``batcher.DecodeSlots``), each row reading its own KV history
   through its page-table row (the CUDA kernel behind
   ``ops.paged_attention.paged_flash_attention``) and writing its new
   K/V slot in place (``decode_model.py``). Rows are numerically
   independent, so joining/leaving neighbors never change a sequence's
   tokens (the solo-parity golden).
3. **Leave on EOS / max-tokens**, KV pages recycled the same
   iteration; every generated token is pushed to the request's future
   as a streamed part (``InferenceFuture.stream()``) the moment it
   exists — inter-token latency is a first-class SLI
   (``mxnet_tpu_serving_inter_token_latency_ms``).

Token selection is greedy argmax by default (deterministic — the
solo-parity lever); a request may carry ``temperature``/``top_k``/
``top_p``/``seed`` (validated at submit), and the random draw is a
pure function of (seed, position) — a replayed stream resamples
byte-identically.

``iteration_level=False`` degrades the scheduler to classic STATIC
batching (joins only when the batch has fully drained, whole-prompt
dense prefill) — the bench leg's A/B baseline, kept deliberately so
the win stays measurable.

PyTorch port of ``mxnet_tpu/serving/decode.py``: the whole scheduling
loop (admission with worst-case page reservation and deferral, chunked
and dense prefill, prefix reuse with copy-on-write, the iteration
loop, static-cohort mode, warmup, submit/infer/snapshot/stop). The
engine runs on its model's device; its worker thread binds that device
explicitly and reads each step's tokens back once. Not ported yet: the
HTTP/wire exposition (``expose``), SLO evaluation and alerts, traffic
capture, the watchdog and flight-recorder/incident/profiler hooks.
On the card the model (``PagedCausalLM``) captures one CUDA graph per
step shape (a prefill bucket, a chunk bucket, a decode bucket) at its
first step and replays it after, as the JAX model compiles its
``jax.jit`` steps: the JAX engine's compile-cache counters count
captures (``miss``) and replays (``memory_hit``; ``persistent_hit``
stays 0, a graph does not outlive its process), a first visit of a
shape emits ``compile_begin`` and ``compile_end``, and a step that
captured counts in ``stats.compiles``/``compile_ms`` and bills as a
compile (``metrics.CaptureCounters``). A step captured if the
worker thread's capture count (``graphs.captures``) moved across it.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np

import torch

from .. import envvars, graphs
from ..telemetry import attribution as _attribution
from ..telemetry import events as _events
from . import tenancy
from .batcher import DecodeSlots, PrefillChunks
from .kvcache import PagedKVPool
from .metrics import (CaptureCounters, CostLedger, DecodeStats,
                      ServingStats, exemplar_gate, slow_exemplar)
from .queue import (DeadlineExceededError, EngineStoppedError,
                    QueueFullError, Request, RequestQueue,
                    RequestTooLongError, ServingError,
                    UnknownModelError, validate_sampling)

__all__ = ["DecodeEngine", "DecodeRequest"]

_engine_seq = itertools.count()


def _zero():
    """A stopped engine's gauge reading."""
    return 0


class DecodeRequest(Request):
    """One generation request: the prompt plus decode bookkeeping —
    generated tokens so far, the sequence's write position, chunked-
    prefill progress, sampling parameters, and the per-token timing
    stamps the inter-token SLI reads."""

    __slots__ = ("max_new_tokens", "eos_id", "stream", "generated",
                 "pos", "t_first", "t_last", "device_s", "prompt_len",
                 "temperature", "top_k", "top_p", "seed",
                 "prefill_pos", "reused_tokens")

    def __init__(self, tokens, max_new_tokens, eos_id=None, stream=False,
                 deadline_ms=None, trace_id=None, parent_span_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=0,
                 tenant=None, tenant_class=None, model_id=None):
        super().__init__(tokens, None, deadline_ms, trace_id=trace_id,
                         parent_span_id=parent_span_id, tenant=tenant,
                         tenant_class=tenant_class, model_id=model_id)
        self.prompt_len = int(self.tokens.size)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_id = int(eos_id) if eos_id is not None else None
        self.stream = bool(stream)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.generated = []
        self.pos = self.prompt_len     # where the NEXT token's KV goes
        self.prefill_pos = 0           # prompt tokens already in pages
        self.reused_tokens = 0         # of them, served by prefix reuse
        self.t_first = self.t_last = None
        self.device_s = 0.0            # amortized decode wall share


class DecodeEngine:
    """Continuous-batching decode server around one paged-KV LM.

    Parameters
    ----------
    model : the decode contract (``decode_model.PagedCausalLM`` or
        anything matching it): ``device``, ``spec`` (KV geometry),
        ``prefill(caches, ids, length, phys, off)`` and
        ``decode_step(caches, ids, positions, tables)``.
    prefill_bucket_lens : padded prompt-length buckets (ascending);
        a longer prompt is rejected at submit.
    max_rows : decode slot cap (default ``MXNET_TPU_DECODE_ROWS``).
    page_size / n_pages : KV pool geometry (``MXNET_TPU_KV_PAGE*``).
    max_new_tokens : default generation cap
        (``MXNET_TPU_DECODE_MAX_NEW_TOKENS``).
    eos_id : default end-of-sequence token id (None = generate to the
        cap).
    iteration_level : True (default) = Orca-style joins at iteration
        boundaries; False = static cohort batching (the A/B baseline —
        whole-prompt dense prefill, no prefix reuse).
    engine_id : metric/scoreboard label, as on ``ServingEngine``.
    prefill_budget : prompt tokens prefilled per iteration boundary
        (``MXNET_TPU_DECODE_PREFILL_BUDGET``); 0 = whole-prompt dense
        prefill (the chunked-prefill A/B baseline).
    prefix_cache / prefix_pages : prefix-KV reuse knobs forwarded to
        the pool (``MXNET_TPU_KV_PREFIX`` / ``_PAGES``); reuse needs
        chunked prefill (the dense prefill step cannot resume
        mid-prompt) and is forced off without it.
    temperature / top_k / top_p : engine-default sampling params for
        requests that carry none (``MXNET_TPU_DECODE_TEMPERATURE`` /
        ``_TOP_K`` / ``_TOP_P``; temperature 0 = greedy argmax).
    """

    def __init__(self, model, prefill_bucket_lens=(16, 64, 256),
                 max_rows=None, page_size=None, n_pages=None,
                 max_queue_depth=256, default_deadline_ms=None,
                 max_new_tokens=None, eos_id=None, iteration_level=True,
                 stats_window=4096, engine_id=None,
                 prefills_per_iter=None, prefill_budget=None,
                 prefix_cache=None, prefix_pages=None,
                 temperature=None, top_k=None, top_p=None,
                 model_id=None, model_version=None):
        self._model = model
        self.device = torch.device(model.device)
        spec = dict(model.spec)
        self.engine_id = str(engine_id) if engine_id is not None \
            else f"d{os.getpid():x}-{next(_engine_seq)}"
        # a decode engine hosts ONE paged-KV LM (the page pool is
        # sized to its geometry) but still names it, so model_id rides
        # its wire frames / journal entries / bills exactly as on the
        # multi-model encoder engine — and a request addressed to a
        # model this engine does not host is a typed 404, not silence
        self.model_id = (str(model_id) if model_id is not None
                         else tenancy.default_model_id())
        self.model_version = (str(model_version)
                              if model_version is not None else "v0")
        self.max_len = int(spec["max_len"])
        lens = sorted(set(int(b) for b in prefill_bucket_lens))
        if not lens or lens[0] < 1:
            raise ValueError(
                f"bad prefill_bucket_lens {prefill_bucket_lens!r}")
        self.prefill_bucket_lens = tuple(lens)
        self._max_rows = int(max_rows if max_rows is not None
                             else envvars.get("MXNET_TPU_DECODE_ROWS"))
        self._default_max_new = int(
            max_new_tokens if max_new_tokens is not None
            else envvars.get("MXNET_TPU_DECODE_MAX_NEW_TOKENS"))
        self._default_eos = eos_id
        self._iteration_level = bool(iteration_level)
        self._prefills_per_iter = max(1, int(
            prefills_per_iter if prefills_per_iter is not None
            else envvars.get("MXNET_TPU_DECODE_PREFILLS_PER_ITER")))
        self._default_deadline_ms = default_deadline_ms
        t, k, p, _ = validate_sampling(
            temperature if temperature is not None
            else envvars.get("MXNET_TPU_DECODE_TEMPERATURE"),
            top_k if top_k is not None
            else envvars.get("MXNET_TPU_DECODE_TOP_K"),
            top_p if top_p is not None
            else envvars.get("MXNET_TPU_DECODE_TOP_P"), None)
        self._default_temp, self._default_top_k, self._default_top_p = \
            t, k, p
        budget = int(prefill_budget if prefill_budget is not None
                     else envvars.get("MXNET_TPU_DECODE_PREFILL_BUDGET"))
        # chunked prefill rides the iteration loop; the static cohort
        # scheduler (the A/B baseline) keeps whole-prompt dense prefill
        self._prefill_budget = budget if self._iteration_level else 0
        self.pool = PagedKVPool(
            spec["n_layers"], spec["n_heads"], spec["head_dim"],
            page_size=page_size, n_pages=n_pages,
            engine_id=self.engine_id, device=self.device,
            # the dense prefill step recomputes the WHOLE prompt and
            # rewrites its pages — it cannot start mid-sequence, so
            # prefix reuse is only sound on the chunked path
            prefix_cache=(False if self._prefill_budget <= 0
                          else prefix_cache),
            prefix_pages=prefix_pages)
        self._slots = DecodeSlots(
            max_rows=self._max_rows,
            max_pages=self.pool.pages_for(self.max_len))
        self._chunks = (PrefillChunks(
            budget=self._prefill_budget,
            max_pages=self.pool.pages_for(self.max_len))
            if self._prefill_budget > 0 else None)
        self._prefilling = []          # worker-owned: mid-prefill reqs
        self._queue = RequestQueue(max_queue_depth)
        self._active = []              # worker-owned slot list
        # static (cohort) mode only: the cohort's row count, pinned at
        # admission — finished rows stay PADDED in the step until the
        # whole cohort drains, the classic static-batching waste the
        # iteration-level scheduler exists to eliminate (and the A/B
        # measures against)
        self._static_rows = 0
        self._reserved = {}            # owner -> worst-case pages
        self._reserved_pages = 0
        self._defer_logged = False
        self.stats = ServingStats(stats_window, engine_id=self.engine_id)
        self.decode_stats = DecodeStats(self.engine_id,
                                        window=stats_window)
        self.tenants = tenancy.TenantStats(self.engine_id)
        self._register_gauges()
        self.costs = CostLedger(self.engine_id)
        self.captures = CaptureCounters(self.engine_id)
        # step shapes visited: a first visit is a compile window
        self._seen_shapes = set()
        self._shapes_lock = threading.Lock()
        # one lock serializes model steps + pool swap: the worker loop
        # and warmup on the caller's thread must never interleave two
        # steps writing the same cache tensors
        self._forward_lock = threading.Lock()
        self._exemplars = exemplar_gate()
        self._worker = None
        self._abort = False
        self._started = False
        self._lock = threading.Lock()
        self._beat = time.monotonic()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._started:
                return self
            if self._queue.closed:
                raise EngineStoppedError("engine cannot be restarted")
            self._started = True
            self._beat = time.monotonic()
            self._worker = threading.Thread(target=self._run,
                                            name="mxnet_tpu_decode",
                                            daemon=True)
            self._worker.start()
        _events.emit("engine_start", engine_id=self.engine_id,
                     decode=True,
                     prefill_buckets=list(self.prefill_bucket_lens),
                     max_rows=self._max_rows,
                     kv_pages=self.pool.n_pages,
                     page_size=self.pool.page_size,
                     iteration_level=self._iteration_level)
        return self

    def stop(self, drain=True, timeout=None):
        """Shut down. ``drain=True`` finishes every queued and
        IN-FLIGHT generation first; ``drain=False`` fails them
        (counted ``cancelled``) — partial token streams end with the
        failure, exactly as ``stream()`` documents."""
        _events.emit("engine_abort" if not drain else "engine_stop",
                     engine_id=self.engine_id, drain=drain)
        with self._lock:
            self._queue.close()
            if not drain:
                self._abort = True
            worker = self._worker
        timed_out = False
        if worker is not None:
            worker.join(timeout)
            timed_out = worker.is_alive()
        for r in self._queue.drain_all():
            self.stats.bump("cancelled")
            self.tenants.observe_event(r.tenant, r.tenant_class,
                                       self.model_id, "cancelled")
            r.span.end(error="cancelled: engine stopped")
            r.future.set_exception(
                EngineStoppedError("engine stopped before request ran"))
        self._register_gauges()
        if timed_out:
            raise ServingError("decode worker did not stop in time")

    def _register_gauges(self):
        """Set the scrape-time gauges: the queue depth, the
        prefill/decode split and each tenant class's WFQ depth. Their
        functions hold the engine, so a stopped engine sets constants
        instead and is collected once dropped."""
        wfq = tenancy.wfq_depth_gauge()
        if self._queue.closed:
            self.stats.set_queue_depth_fn(_zero)
            self.decode_stats.set_split_fns(_zero, _zero)
            for cls in tenancy.TENANT_CLASSES:
                wfq.labels(engine_id=self.engine_id,
                           tenant_class=cls).set_function(_zero)
            return
        self.stats.set_queue_depth_fn(lambda: len(self._queue))
        self.decode_stats.set_split_fns(lambda: len(self._queue),
                                        lambda: len(self._active))
        for cls in tenancy.TENANT_CLASSES:
            wfq.labels(engine_id=self.engine_id,
                       tenant_class=cls).set_function(
                lambda c=cls: self._queue.depths().get(c, 0))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False

    @property
    def running(self):
        with self._lock:
            return (self._started and self._worker is not None
                    and self._worker.is_alive())

    # -- client surface ----------------------------------------------------
    def submit(self, tokens, token_types=None, deadline_ms=None,
               max_new_tokens=None, eos_id=None, stream=False,
               trace_id=None, parent_span_id=None, temperature=None,
               top_k=None, top_p=None, seed=None, model_id=None,
               tenant=None, tenant_class=None):
        """Enqueue one generation request; returns a STREAMING
        :class:`~.queue.InferenceFuture` — ``result()`` is the full
        (max_new_tokens,) int32 token array, ``stream()`` yields each
        token as it is generated. ``token_types`` is accepted for
        submit-surface compatibility (canaries, generic loadgen) and
        ignored — decode prompts are plain token ids.

        ``temperature``/``top_k``/``top_p``/``seed`` select seeded
        sampling (None = the engine defaults; temperature 0 = greedy).
        Out-of-range values raise
        :class:`~.queue.InvalidSamplingError` here — before any
        model step. A sampled request with no seed gets one minted
        at submit, so replay (stream(), failover re-dispatch) draws
        the same tokens.

        ``model_id`` must name THIS engine's model when given (a
        decode engine hosts exactly one — unknown ids are a typed
        404); ``tenant``/``tenant_class`` attribute the request to an
        owner and its WFQ admission class, as on the encoder engine."""
        del token_types
        temperature, top_k, top_p, seed = validate_sampling(
            temperature, top_k, top_p, seed)
        if temperature is None:
            temperature = self._default_temp
        if top_k is None:
            top_k = self._default_top_k
        if top_p is None:
            top_p = self._default_top_p
        if seed is None:
            seed = (int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF
                    if temperature > 0 else 0)
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        if max_new_tokens is None:
            max_new_tokens = self._default_max_new
        if eos_id is None:
            eos_id = self._default_eos
        req = DecodeRequest(tokens, max_new_tokens, eos_id=eos_id,
                            stream=stream, deadline_ms=deadline_ms,
                            trace_id=trace_id,
                            parent_span_id=parent_span_id,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p, seed=seed, tenant=tenant,
                            tenant_class=tenant_class,
                            model_id=model_id)
        req.span.set_attr(engine=self.engine_id, decode=True)
        self.stats.bump("submitted")
        if req.model_id is not None and req.model_id != self.model_id:
            self.stats.bump("rejected_unknown_model")
            self.tenants.observe_event(
                req.tenant, req.tenant_class, str(req.model_id),
                "rejected_unknown_model")
            _events.emit("request_shed", reason="unknown_model",
                         engine_id=self.engine_id,
                         model=str(req.model_id),
                         trace_id=req.trace_id, tokens=req.prompt_len)
            req.span.set_attr(shed="unknown_model").force_keep() \
               .end(error="shed: unknown_model")
            raise UnknownModelError(
                f"unknown model {req.model_id!r}: this decode engine "
                f"hosts {self.model_id!r}")
        req.model_id = self.model_id
        self.tenants.observe_event(req.tenant, req.tenant_class,
                                   req.model_id, "submitted")
        if not self._started or self._queue.closed:
            self.stats.bump("rejected_stopped")
            req.span.end(error="rejected: engine not running")
            raise EngineStoppedError("decode engine is not running")
        too_long = None
        if req.prompt_len > self.prefill_bucket_lens[-1]:
            too_long = (f"prompt of {req.prompt_len} tokens exceeds "
                        f"the largest prefill bucket "
                        f"({self.prefill_bucket_lens[-1]})")
        elif req.prompt_len + req.max_new_tokens > self.max_len:
            too_long = (f"prompt {req.prompt_len} + max_new_tokens "
                        f"{req.max_new_tokens} exceeds the model's "
                        f"max_len ({self.max_len})")
        elif (self.pool.pages_for(req.prompt_len + req.max_new_tokens)
                > self.pool.n_pages):
            too_long = ("request's worst-case KV footprint exceeds "
                        "the whole page pool")
        if too_long is not None:
            self.stats.bump("rejected_too_long")
            self.tenants.observe_event(req.tenant, req.tenant_class,
                                       req.model_id, "rejected_too_long")
            _events.emit("request_shed", reason="too_long",
                         engine_id=self.engine_id,
                         trace_id=req.trace_id, tokens=req.prompt_len)
            req.span.set_attr(shed="too_long").force_keep() \
               .end(error="shed: too_long")
            raise RequestTooLongError(too_long)
        try:
            victim = self._queue.put(req)
        except ServingError as e:
            full = not self._queue.closed
            reason = "queue_full" if full else "stopped"
            self.stats.bump("rejected_queue_full"
                            if full else "rejected_stopped")
            self.tenants.observe_event(
                req.tenant, req.tenant_class, req.model_id,
                "rejected_queue_full" if full else "rejected_stopped")
            _events.emit("request_shed", reason=reason,
                         engine_id=self.engine_id,
                         trace_id=req.trace_id, tokens=req.prompt_len)
            req.span.set_attr(shed=reason).force_keep() \
               .end(error=f"shed: {reason}")
            raise e
        if victim is not None:
            self._shed_victim(victim)
        return req.future

    def _shed_victim(self, victim):
        """Fail a request the WFQ queue evicted to admit a
        higher-class arrival under overload — same contract as the
        encoder engine's shed path."""
        self.stats.bump("rejected_queue_full")
        self.tenants.observe_event(victim.tenant, victim.tenant_class,
                                   victim.model_id or self.model_id,
                                   "shed")
        _events.emit("request_shed", reason="wfq_evicted",
                     engine_id=self.engine_id,
                     trace_id=victim.trace_id,
                     tenant_class=victim.tenant_class,
                     tokens=victim.prompt_len)
        victim.span.set_attr(shed="wfq_evicted").force_keep() \
              .end(error="shed: wfq_evicted")
        victim.future.set_exception(QueueFullError(
            f"shed by weighted-fair admission: queue full and a "
            f"higher class arrived (class {victim.tenant_class})"))

    def infer(self, tokens, max_new_tokens=None, eos_id=None,
              deadline_ms=None, timeout=None, temperature=None,
              top_k=None, top_p=None, seed=None):
        """Synchronous convenience: submit + wait for the full
        generated sequence."""
        return self.submit(tokens, deadline_ms=deadline_ms,
                           max_new_tokens=max_new_tokens,
                           eos_id=eos_id, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           seed=seed).result(timeout)

    # -- warmup ------------------------------------------------------------
    def warmup(self, shapes=None):
        """Run every (0, prefill_bucket) prompt shape, every (rows,
        table_width) decode bucket and every chunk bucket once (or the
        given subset) ahead of traffic: builds the CUDA kernel and
        warms the allocator. Dummy forwards write only the pool's
        scratch page. Call BEFORE traffic."""
        if shapes is None:
            shapes = self._shape_universe()
        for shape in shapes:
            if shape[0] == 0:
                self._forward_prefill_shape(shape[1])
            elif shape[0] < 0:
                self._forward_chunk_shape(-shape[0], shape[1])
            else:
                self._forward_decode_shape(*shape)
        return self

    def _shape_universe(self):
        """Every step shape: prefill buckets as (0, padded_len), decode
        buckets as (rows, table_width), chunked-prefill buckets as
        (-chunk, table_width). Dense prefill buckets stay in the
        universe even when chunking is on: the static/dense A/B arm
        needs them."""
        return ([(0, b) for b in self.prefill_bucket_lens]
                + list(self._slots.shape_universe())
                + (list(self._chunks.shape_universe())
                   if self._chunks is not None else []))

    def reset_stats(self):
        """Fresh measurement window (ledger + pool untouched) — the
        bench legs' warmup/measure split."""
        self.stats = ServingStats(self.stats.window,
                                  engine_id=self.engine_id)
        self.decode_stats = DecodeStats(self.engine_id,
                                        window=self.decode_stats.window)
        self._register_gauges()
        return self

    # -- observability surfaces --------------------------------------------
    def snapshot(self):
        out = self.stats.snapshot()
        out["running"] = self.running
        out["decode"] = self.decode_stats.snapshot()
        out["kv"] = self.pool.occupancy()
        out["kv"]["prefix"] = self.pool.prefix_stats()
        out["prefill_buckets"] = list(self.prefill_bucket_lens)
        out["max_rows"] = self._max_rows
        out["iteration_level"] = self._iteration_level
        out["models"] = {self.model_id: self.model_version}
        out["queue_classes"] = self._queue.depths()
        out["tenants"] = self.tenants.bills()
        out["active_slots"] = len(self._active)
        out["seconds_since_beat"] = round(
            time.monotonic() - self._beat, 3)
        out["device"] = str(self.device)
        out["costs"] = self.costs.totals()
        out["compile_cache"] = self.captures.snapshot()
        return out

    def scheduler_state(self):
        """The decode scheduler's live state — the drill-down for a
        wedged loop."""
        active = [{"trace_id": r.trace_id, "prompt": r.prompt_len,
                   "generated": len(r.generated), "pos": r.pos,
                   "max_new_tokens": r.max_new_tokens,
                   "reused_tokens": r.reused_tokens,
                   "pages": len(self.pool.table(r.id) or ())}
                  for r in list(self._active)]
        prefilling = [{"trace_id": r.trace_id, "prompt": r.prompt_len,
                       "prefill_pos": r.prefill_pos,
                       "reused_tokens": r.reused_tokens}
                      for r in list(self._prefilling)]
        return {"engine_id": self.engine_id,
                "iteration_level": self._iteration_level,
                "prefill_budget": self._prefill_budget,
                "models": {self.model_id: self.model_version},
                "active": active,
                "prefilling": prefilling,
                "prefill_queue_depth": len(self._queue),
                "queue_classes": self._queue.depths(),
                "reserved_pages": self._reserved_pages,
                "kv": self.pool.occupancy(),
                "prefix": self.pool.prefix_stats(),
                "page_refcounts": self.pool.page_refcounts(),
                "decode": self.decode_stats.snapshot()}

    def cost_table(self):
        """/costs body. Decode iterations land in NEGATED-rows buckets
        (-1, -2, -4, ... — "a decode batch of N rows"; the sign keeps
        them disjoint from prompt-length buckets for any config),
        prefill forwards in their padded prompt-length buckets."""
        return {"engine_id": self.engine_id,
                "buckets": self.costs.table(),
                "totals": self.costs.totals()}

    def whyslow(self):
        """The ``/whyslow`` body: this engine's per-stage attribution
        table + top stages by share of attributed time. Present (with
        ``enabled: false`` and empty tables) even when attribution is
        off, so fleet scrapers never 404-branch."""
        agg = _attribution.get_aggregator(self.engine_id)
        if agg is None:
            return {"owner": self.engine_id,
                    "enabled": _attribution.enabled(),
                    "requests": 0, "stages": [], "top": []}
        return agg.snapshot()

    # -- step timing -------------------------------------------------------
    def _step_compiled(self, shape_key, fn):
        """Run one model step of shape ``shape_key`` ((0, bucket) a
        prefill, (-chunk, width) a chunk, (rows, width) a decode step)
        and classify it as the JAX engine does: a first visit opens a
        compile window (``compile_begin``/``compile_end``), and a step
        that captured a CUDA graph (on this thread) is a ``miss``, any
        other a ``memory_hit``. Returns (result, wall_s, captured). The
        steps end in a host read of their tokens, so the wall covers the
        device work."""
        with self._shapes_lock:
            first = shape_key not in self._seen_shapes
        if first:
            _events.emit("compile_begin", engine_id=self.engine_id,
                         shape=list(shape_key))
        before = graphs.captures()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        captured = graphs.captures() != before
        result = self.captures.observe(captured)
        if captured:
            self.stats.bump("compiles")
            self.stats.compile_ms.observe(dt * 1e3)
        if first:
            with self._shapes_lock:
                self._seen_shapes.add(shape_key)
            _events.emit("compile_end", engine_id=self.engine_id,
                         shape=list(shape_key), result=result,
                         ms=round(dt * 1e3, 3))
        return out, dt, captured

    # -- warmup forwards ---------------------------------------------------
    def _forward_prefill_shape(self, bucket):
        ids = np.zeros(bucket, np.int32)
        phys = np.full(bucket, self.pool.scratch_page, np.int32)
        off = (np.arange(bucket) % self.pool.page_size).astype(np.int32)

        def run():
            with self._forward_lock:
                tok, caches = self._model.prefill(
                    self.pool.caches, ids, bucket, phys, off)
                self.pool.swap(caches)
            return int(tok)

        _out, dt, compiled = self._step_compiled((0, bucket), run)
        self.costs.observe_warmup(bucket, dt, compiled=compiled)

    def _forward_chunk_shape(self, chunk, width):
        ids = np.zeros(chunk, np.int32)
        table = np.full(width, self.pool.scratch_page, np.int32)

        def run():
            with self._forward_lock:
                tok, caches = self._model.prefill_chunk(
                    self.pool.caches, ids, 0, chunk, table)
                self.pool.swap(caches)
            return int(tok)

        _out, dt, compiled = self._step_compiled((-chunk, width), run)
        # chunk warmups bill into the positive token-count bucket —
        # they may merge with a same-sized dense prefill bucket, which
        # is fine: both are "prompt tokens prefilled" entries
        self.costs.observe_warmup(chunk, dt, compiled=compiled)

    def _forward_decode_shape(self, rows, width):
        ids = np.zeros(rows, np.int32)
        positions = np.zeros(rows, np.int32)
        tables = np.full((rows, width), self.pool.scratch_page,
                         np.int32)

        def run():
            with self._forward_lock:
                toks, caches = self._model.decode_step(
                    self.pool.caches, ids, positions, tables)
                self.pool.swap(caches)
            return toks.cpu()

        _out, dt, compiled = self._step_compiled((rows, width), run)
        self.costs.observe_warmup(-rows, dt, compiled=compiled)

    # -- worker ------------------------------------------------------------
    def _run(self):
        # the worker launches the device work: bind the engine's device
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            self._beat = time.monotonic()
            if self._abort:
                self._fail_all(EngineStoppedError(
                    "engine stopped before generation finished"))
                return
            self._admit()
            self._advance_prefills()
            if not self._active:
                if (self._queue.closed and not len(self._queue)
                        and not self._prefilling):
                    return
                continue
            try:
                self._iterate()
            except Exception as e:
                # a poison iteration fails ITS batch, never the engine:
                # every active sequence is failed (their streams end
                # with the error) and their pages recycle; queued
                # requests get a fresh batch next loop
                for req in self._active:
                    self._leave(req, error=e)
                self._active = []

    def _fail_all(self, exc):
        for req in self._active:
            self._leave(req, error=exc, counter="cancelled")
        self._active = []
        for req in self._prefilling:
            self._leave(req, error=exc, counter="cancelled",
                        joined=False)
        self._prefilling = []
        for req in self._queue.drain_all():
            self.stats.bump("cancelled")
            self.tenants.observe_event(req.tenant, req.tenant_class,
                                       self.model_id, "cancelled")
            req.span.end(error="cancelled: engine stopped")
            req.future.set_exception(exc)

    def _admit(self):
        """Join queued prompts at this iteration boundary. Chunked
        mode moves them into the PREFILLING set (pages reserved,
        prefix index consulted) for the chunk scheduler to advance;
        dense mode runs the whole prefill here. Static mode
        (``iteration_level=False``) admits only into an EMPTY batch
        and pins the cohort's row count until it fully drains — the
        classic cohort scheduler the A/B leg measures against."""
        if not self._iteration_level and self._active:
            return
        if not self._active and not self._prefilling:
            self._static_rows = 0
        chunked = self._chunks is not None
        admitted = 0
        while True:
            live = len(self._active) + len(self._prefilling)
            if live >= self._max_rows:
                break
            if chunked:
                # cap CONCURRENT chunked prefills — more would just
                # time-slice the same per-iteration token budget
                if len(self._prefilling) >= self._prefills_per_iter:
                    break
            elif admitted >= (self._prefills_per_iter if self._active
                              else self._max_rows):
                break
            # idle engines park on the queue poll; a running batch
            # polls without waiting (the decode loop must not linger)
            idle = not self._active and not self._prefilling \
                and not admitted
            reqs = self._queue.poll(1, timeout=0.05 if idle else 0.0)
            if not reqs:
                break
            req = reqs[0]
            now = time.monotonic()
            if req.expired(now):
                self.stats.bump("expired")
                self.tenants.observe_event(req.tenant, req.tenant_class,
                                           self.model_id, "expired")
                _events.emit("request_expired", trace_id=req.trace_id,
                             waited_ms=round(
                                 (now - req.t_submit) * 1e3, 3))
                req.span.end(error="deadline exceeded before prefill")
                req.future.set_exception(DeadlineExceededError(
                    f"request {req.id} deadline exceeded before "
                    "prefill"))
                continue
            worst = self.pool.pages_for(req.prompt_len
                                        + req.max_new_tokens)
            if self._reserved_pages + worst > self.pool.n_pages:
                # the pool cannot GUARANTEE this sequence's worst case:
                # defer (front of line), never fail — pages recycle the
                # moment any sequence leaves
                self._queue.requeue(req)
                # per-REQUEST defer breadcrumbs: the episode gets its
                # own stage span once the re-admit finally lands, so a
                # deferred request's TTFT outlier reads "defer", not
                # noise (the event below stays once-per-pool-episode —
                # the admit loop would re-emit it every poll otherwise)
                if req.t_defer is None:
                    req.t_defer = now
                req.defers += 1
                if not self._defer_logged:
                    self._defer_logged = True
                    _events.emit("decode_defer",
                                 engine_id=self.engine_id,
                                 trace_id=req.trace_id,
                                 need_pages=worst,
                                 reserved=self._reserved_pages,
                                 pool=self.pool.n_pages)
                break
            if req.t_defer is not None:
                # the defer episode just ended: admission is about to
                # succeed (or fail loudly) — stamp requeue -> now
                _events.emit("decode_defer_end",
                             engine_id=self.engine_id,
                             trace_id=req.trace_id,
                             deferrals=req.defers,
                             waited_ms=round(
                                 (now - req.t_defer) * 1e3, 3))
                _attribution.stamp(req, "defer", req.t_defer, now,
                                   attrs={"deferrals": req.defers})
                req.t_defer = None
            try:
                if chunked:
                    self._admit_chunked(req, worst)
                else:
                    self._prefill(req, worst)
            except Exception as e:
                self.pool.release(req.id)
                self._unreserve(req)
                self.stats.bump("failed")
                req.span.end(error=repr(e))
                req.future.set_exception(e)
                continue
            admitted += 1

    def _admit_chunked(self, req, worst_pages):
        """Reserve the worst case, consult the prefix index, and hand
        the request to the chunk scheduler. A prefix hit attaches the
        matched read-only pages to the request's table (COW copies
        materialized before anything reads them) and fast-forwards
        ``prefill_pos`` past the reused tokens — those positions'
        K/V are already in the pool."""
        self._reserved[req.id] = worst_pages
        self._reserved_pages += worst_pages
        matched, copies = self.pool.match_prefix(req.id, req.tokens)
        if copies:
            c0 = time.monotonic()
            with self._forward_lock:
                self.pool.copy_pages(copies)
            _attribution.stamp(req, "cow_copy", c0, time.monotonic(),
                               attrs={"pages": len(copies),
                                      "prefix_hit": True})
        req.prefill_pos = req.reused_tokens = matched
        self.stats.queue_ms.observe((req.t_drain - req.t_submit) * 1e3)
        self._prefilling.append(req)
        if matched:
            _events.emit("decode_prefix_hit", engine_id=self.engine_id,
                         trace_id=req.trace_id, matched=matched,
                         prompt=req.prompt_len, cow_pages=len(copies))

    def _advance_prefills(self):
        """Spend this iteration boundary's prefill-token budget
        (``MXNET_TPU_DECODE_PREFILL_BUDGET``) advancing mid-prefill
        prompts, FIFO — the running decode batch waits for at most
        one budget's worth of chunk steps, however long the prompts
        are. A prompt whose last chunk lands emits its first token
        and joins the decode batch."""
        if self._chunks is None or not self._prefilling:
            return
        budget = self._prefill_budget
        done = []
        for req in self._prefilling:
            if budget <= 0:
                break
            if req.expired():
                done.append(req)
                self.stats.bump("expired")
                _events.emit("request_expired", trace_id=req.trace_id,
                             waited_ms=round(
                                 (time.monotonic() - req.t_submit)
                                 * 1e3, 3))
                self._leave(req, error=DeadlineExceededError(
                    f"request {req.id} deadline exceeded during "
                    "chunked prefill"), counter="expired", joined=False)
                continue
            try:
                tok = None
                while budget > 0 and req.prefill_pos < req.prompt_len:
                    take = min(budget,
                               req.prompt_len - req.prefill_pos)
                    tok = self._prefill_chunk(req, take)
                    budget -= take
                if req.prefill_pos >= req.prompt_len:
                    done.append(req)
                    self._finish_prefill(req, tok)
            except Exception as e:
                if req not in done:
                    done.append(req)
                self._active = [r for r in self._active
                                if r.id != req.id]
                self.stats.bump("failed")
                self._leave(req, error=e, joined=False)
        if done:
            left = {r.id for r in done}
            self._prefilling = [r for r in self._prefilling
                                if r.id not in left]

    def _prefill_chunk(self, req, take):
        """One kernel-sized prompt slice through the paged chunk step.
        Returns the step's next-token sample — meaningful only for
        the chunk that completes the prompt (sampled at the prompt's
        last position); earlier chunks' is discarded."""
        t_chunk0 = time.monotonic()
        start = req.prefill_pos
        self.pool.ensure(req.id, start + take)
        pages_now = self.pool.pages_for(start + take)
        neg_chunk, width = self._chunks.bucket(take, pages_now)
        chunk = -neg_chunk
        ids = np.zeros(chunk, np.int32)
        ids[:take] = req.tokens[start:start + take]
        # the chunk's first write page could be a shared page at this
        # sequence's write frontier (a prefix hit whose match ended
        # exactly on a page boundary that is still index-pinned from
        # another chain) — copy-on-write before writing into it
        pairs = []
        cow = self.pool.prepare_write(req.id, start)
        if cow is not None:
            pairs.append(cow)
        table = self.pool.padded_tables([req.id], width)[0]

        cow_ival = [None]

        def run():
            with self._forward_lock:
                if pairs:
                    c0 = time.monotonic()
                    self.pool.copy_pages(pairs)
                    cow_ival[0] = (c0, time.monotonic())
                tok, caches = self._model.prefill_chunk(
                    self.pool.caches, ids, start, take, table,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, seed=req.seed)
                self.pool.swap(caches)
            return int(tok)

        tok, dt, compiled = self._step_compiled((neg_chunk, width), run)
        now = time.monotonic()
        self._beat = now
        # stage stamps: the chunk's full residency, with the COW copy
        # nested inside it (the extractor bills the copy slice to
        # cow_copy, the remainder to prefill_chunk — innermost wins)
        _attribution.stamp(req, "prefill_chunk", t_chunk0, now,
                           attrs={"tokens": take, "pos": start})
        if cow_ival[0] is not None:
            _attribution.stamp_interval(req, "cow_copy", cow_ival[0],
                                        attrs={"pages": len(pairs)})
        req.prefill_pos += take
        req.device_s += dt
        final = req.prefill_pos >= req.prompt_len
        done_now = final and (
            req.max_new_tokens == 1
            or (req.eos_id is not None and tok == req.eos_id))
        self.decode_stats.observe_chunk(take)
        # chunk steps bill by their REAL token count (the final chunk
        # adds the first generated token), so per-request bills —
        # (prompt - reused) + generated — reconcile against the
        # ledger token-for-token, exactly as the dense path does
        self.costs.observe_decode(chunk, dt, tokens=take + int(final),
                                  completed=int(done_now),
                                  compiled=compiled)
        return tok

    def _finish_prefill(self, req, tok):
        """The prompt's last chunk just ran: index its full pages for
        future prefix hits, emit the first generated token, and join
        the decode batch (or finish outright on EOS / a 1-token
        cap)."""
        self.pool.register_prefix(req.id, req.tokens)
        now = time.monotonic()
        req.t_first = req.t_last = now
        self.decode_stats.ttft_ms.observe((now - req.t_submit) * 1e3)
        self._emit_token(req, tok)
        if self._done_after_token(req, tok):
            self._leave(req, reason=self._leave_reason(req, tok),
                        joined=False)
            return
        self._active.append(req)
        self.decode_stats.observe_join()
        _events.emit("decode_join", engine_id=self.engine_id,
                     trace_id=req.trace_id, prompt=req.prompt_len,
                     reused_tokens=req.reused_tokens,
                     max_new_tokens=req.max_new_tokens,
                     active=len(self._active))

    def _unreserve(self, req):
        worst = self._reserved.pop(req.id, 0)
        self._reserved_pages -= worst

    def _prefill(self, req, worst_pages):
        """Run one prompt through the DENSE prefill step (static mode
        and the chunked-prefill A/B baseline), emit the first token,
        and either finish the request (max_new_tokens=1 / EOS on token
        one) or JOIN it to the decode batch."""
        self._reserved[req.id] = worst_pages
        self._reserved_pages += worst_pages
        t_pf0 = time.monotonic()
        bucket = next(b for b in self.prefill_bucket_lens
                      if b >= req.prompt_len)
        self.pool.ensure(req.id, req.prompt_len)
        req.prefill_pos = req.prompt_len
        ids = np.zeros(bucket, np.int32)
        ids[:req.prompt_len] = req.tokens
        phys, off = self.pool.scatter_indices(req.id, req.prompt_len,
                                              bucket)

        def run():
            with self._forward_lock:
                tok, caches = self._model.prefill(
                    self.pool.caches, ids, req.prompt_len, phys, off,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, seed=req.seed)
                self.pool.swap(caches)
            return int(tok)

        tok, dt, compiled = self._step_compiled((0, bucket), run)
        # prefill always carries exactly one live request, so its wall
        # lands in request_s (observe_decode) — what keeps
        # sum(per-request bills) == ledger request_s exact; the
        # request is counted once, at leave — which IS now for a
        # generation that ends on its first token (max_new_tokens=1,
        # or EOS immediately). Tokens: the prompt PLUS the first
        # generated token, matching the bills' unit token-for-token.
        done_now = (req.max_new_tokens == 1
                    or (req.eos_id is not None and tok == req.eos_id))
        self.costs.observe_decode(bucket, dt,
                                  tokens=req.prompt_len + 1,
                                  completed=int(done_now),
                                  compiled=compiled)
        now = time.monotonic()
        req.t_first = req.t_last = now
        req.device_s += dt
        _attribution.stamp(req, "prefill", t_pf0, now,
                           attrs={"tokens": req.prompt_len})
        self.decode_stats.ttft_ms.observe((now - req.t_submit) * 1e3)
        self.stats.queue_ms.observe((req.t_drain - req.t_submit) * 1e3)
        self._emit_token(req, tok)
        if self._done_after_token(req, tok):
            self._leave(req, reason=self._leave_reason(req, tok),
                        joined=False)
            return
        self._active.append(req)
        self.decode_stats.observe_join()
        _events.emit("decode_join", engine_id=self.engine_id,
                     trace_id=req.trace_id, prompt=req.prompt_len,
                     max_new_tokens=req.max_new_tokens,
                     active=len(self._active))

    def _emit_token(self, req, tok):
        req.generated.append(tok)
        self.decode_stats.observe_token()
        req.future.push_part({"index": len(req.generated) - 1,
                              "token": tok, "final": False})

    @staticmethod
    def _done_after_token(req, tok):
        return (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    @staticmethod
    def _leave_reason(req, tok):
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        return "max_tokens"

    def _iterate(self):
        """One decode iteration: every live sequence advances one
        token through the bucketed paged step; EOS/max-token leavers
        recycle their pages the same iteration."""
        active = self._active
        t_iter0 = time.monotonic()
        cow_pairs = []
        cow_reqs = []
        for req in active:
            # guaranteed by the admission reservation: never raises
            self.pool.ensure(req.id, req.pos + 1)
            # a shared prefix page at this row's write frontier gets a
            # private copy before the step writes into it (no-op for
            # private pages — one set lookup)
            cow = self.pool.prepare_write(req.id, req.pos)
            if cow is not None:
                cow_pairs.append(cow)
                cow_reqs.append(req)
        # ensure() just covered pos+1 for every row, so the page count
        # is pure arithmetic — no pool lock or table copy per token
        max_pages = max(self.pool.pages_for(req.pos + 1)
                        for req in active)
        n_rows = len(active)
        if not self._iteration_level:
            # classic static batching: the cohort's row count is
            # pinned at admission; rows whose sequences finished keep
            # burning padded slots until the LAST member drains
            self._static_rows = max(self._static_rows, n_rows)
            n_rows = self._static_rows
        rows_b, width_b = self._slots.bucket(n_rows, max_pages)
        ids = np.zeros(rows_b, np.int32)
        positions = np.zeros(rows_b, np.int32)
        temps = np.zeros(rows_b, np.float32)
        top_ks = np.zeros(rows_b, np.int32)
        top_ps = np.ones(rows_b, np.float32)
        seeds = np.zeros(rows_b, np.int32)
        for i, req in enumerate(active):
            ids[i] = req.generated[-1]
            positions[i] = req.pos
            temps[i] = req.temperature
            top_ks[i] = req.top_k
            top_ps[i] = req.top_p
            seeds[i] = req.seed
        owners = [req.id for req in active] \
            + ["__pad__"] * (rows_b - len(active))
        tables = self.pool.padded_tables(owners, width_b)

        cow_ival = [None]

        def run():
            with self._forward_lock:
                if cow_pairs:
                    c0 = time.monotonic()
                    self.pool.copy_pages(cow_pairs)
                    cow_ival[0] = (c0, time.monotonic())
                toks, caches = self._model.decode_step(
                    self.pool.caches, ids, positions, tables,
                    temperatures=temps, top_ks=top_ks, top_ps=top_ps,
                    seeds=seeds)
                self.pool.swap(caches)
            # ONE read-back of the whole step's tokens
            return toks.cpu().numpy()

        toks, dt, compiled = self._step_compiled((rows_b, width_b), run)
        now = time.monotonic()
        self._beat = now
        n_active = len(active)
        leavers = []
        share = dt / n_active
        completed = 0
        for i, req in enumerate(active):
            tok = int(toks[i])
            self.decode_stats.inter_token_ms.observe(
                (now - req.t_last) * 1e3)
            req.t_last = now
            req.pos += 1
            req.device_s += share
            # iteration residency: every cohort member was resident
            # for the whole step; a member whose row paid a COW copy
            # gets the copy slice re-billed to cow_copy (nested stamp)
            _attribution.stamp(req, "decode_iter", t_iter0, now)
            self._emit_token(req, tok)
            if self._done_after_token(req, tok):
                leavers.append((req, self._leave_reason(req, tok)))
                completed += 1
        if cow_ival[0] is not None:
            for req in cow_reqs:
                _attribution.stamp_interval(req, "cow_copy",
                                            cow_ival[0])
        self.decode_stats.observe_iteration(rows_b, n_active)
        if not compiled:
            self.stats.compute_ms.observe(dt * 1e3)
        self.costs.observe_decode(-rows_b, dt, tokens=n_active,
                                  completed=completed,
                                  compiled=compiled)
        if leavers:
            left = {req.id for req, _ in leavers}
            self._active = [r for r in active if r.id not in left]
            for req, reason in leavers:
                self._leave(req, reason=reason)

    def _leave(self, req, reason=None, error=None, counter="failed",
               joined=True):
        """Retire one sequence: pages recycled immediately, stream
        closed with the final result (or the failure)."""
        freed = self.pool.release(req.id)
        self._unreserve(req)
        self._defer_logged = False
        if joined:
            self.decode_stats.observe_leave()
        if error is not None:
            self.stats.bump(counter)
            self.tenants.observe_event(req.tenant, req.tenant_class,
                                       self.model_id, counter)
            req.span.end(error=repr(error))
            req.future.set_exception(error)
            return
        now = time.monotonic()
        req.t_done = now
        out = np.asarray(req.generated, np.int32)
        total_ms = (now - req.t_submit) * 1e3
        self.stats.total_ms.observe(
            total_ms, exemplar=slow_exemplar(req.trace_id, total_ms,
                                             self._exemplars))
        self.stats.bump("completed")
        self.tenants.observe_event(req.tenant, req.tenant_class,
                                   self.model_id, "completed")
        self.tenants.observe_latency(req.tenant, req.tenant_class,
                                     self.model_id, total_ms)
        self.tenants.observe_cost(
            req.tenant, req.tenant_class, self.model_id, req.device_s,
            req.prompt_len - req.reused_tokens + len(req.generated))
        # "tokens" mirrors the ledger's accounting unit (prompt tokens
        # PREFILLED — prefix-reused ones never hit the device — plus
        # tokens generated) so client-summed bills reconcile against
        # the /costs delta token-for-token
        req.future.cost = {"engine_id": self.engine_id,
                           "bucket": "decode",
                           "model": self.model_id,
                           "tenant": req.tenant,
                           "tenant_class": req.tenant_class,
                           "device_s": req.device_s,
                           "compiled": False,
                           "tokens": (req.prompt_len - req.reused_tokens
                                      + len(req.generated)),
                           "generated_tokens": len(req.generated),
                           "prompt_tokens": req.prompt_len,
                           "reused_tokens": req.reused_tokens,
                           "batch_requests": 1}
        _events.emit("decode_leave", engine_id=self.engine_id,
                     trace_id=req.trace_id, reason=reason,
                     tokens=len(req.generated), pages_freed=freed,
                     active=len(self._active))
        # critical-path decomposition: the engine-measured numbers the
        # router and loadgen will see verbatim (future.breakdown, the
        # streamed-final RESULT frame) + the /whyslow fleet aggregate
        if req.stages is not None:
            breakdown = _attribution.breakdown_from_stamps(
                req.stages, req.t_submit, now, trace_id=req.trace_id)
            req.future.breakdown = breakdown
            _attribution.aggregator(self.engine_id).observe(
                breakdown, tenant_class=req.tenant_class,
                model=self.model_id, trace_id=req.trace_id)
        req.span.set_attr(tokens=len(req.generated), reason=reason)
        req.span.end()
        req.future.set_result(out)
