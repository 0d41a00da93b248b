"""Execution engine: MXNet's ``engine`` module on torch's streams.

Port of ``mxnet_tpu/engine.py``. CUDA already gives the eager API
MXNet's asynchronous contract (a launch returns at once; a host read
waits), so what remains is :class:`Engine` with ``wait_for_var`` and
``wait_all`` (``torch.cuda.synchronize`` when a card is in use; the
CPU runs synchronously and there is nothing to wait for),
:func:`set_bulk_size` / :class:`bulk`, which keep their return values
and change nothing (a hybridized block's CUDA graph is what bulks
launches here), and :func:`chain_steps`, which captures ``k`` steps of
a training step into one CUDA graph.
"""
from __future__ import annotations

import os

import torch

__all__ = ["Engine", "bulk", "chain_steps", "engine", "set_bulk_size"]


def _cuda_in_use():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class Engine:
    """The engine singleton (:data:`engine`)."""

    def wait_for_var(self, array):
        """Wait until ``array`` is computed (its device's stream)."""
        if isinstance(array, torch.Tensor) and array.is_cuda:
            torch.cuda.current_stream(array.device).synchronize()

    def wait_all(self):
        """Wait for every queued operation on every card."""
        if _cuda_in_use():
            torch.cuda.synchronize()


engine = Engine()

_BULK_SIZE = [int(os.environ.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN",
                                 "15"))]


def set_bulk_size(size):
    """Set the bulk size; returns the previous one (no effect here)."""
    prev, _BULK_SIZE[0] = _BULK_SIZE[0], int(size)
    return prev


class bulk:
    """``with mx.engine.bulk(16): ...`` (sets and restores the size)."""

    def __init__(self, size):
        self.size = size
        self._prev = None

    def __enter__(self):
        self._prev = set_bulk_size(self.size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._prev)
        return False


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


def chain_steps(step_fn, k, donate_argnums=()):
    """``k`` iterations of a training step as one call, the JAX
    function's contract: ``step_fn(carry..., *args) -> (carry...,
    loss)`` takes and returns the same number of leading carry tensors
    (parameters, optimizer state), the trailing ``args`` go to every
    step. Returns ``fn(carry..., *args) -> (carry..., last_loss)``.

    On CUDA tensors the ``k`` steps are one CUDA graph (``graphs``), the
    counterpart of the JAX package's ``lax.scan`` in one executable:
    captured at the first call of each argument signature (shapes and
    types), then replayed, so the host enqueues one graph where it
    would enqueue ``k`` steps' launches. The carry lives in static
    buffers that the graph updates in place. A carry argument named in
    ``donate_argnums`` becomes the graph's own buffer: the call updates
    that tensor in place and returns it (pass the returned tensor back
    in, as one does with a donated JAX buffer, and no copy is made); the
    other carries are copied in and the results returned as copies. On
    the CPU the steps run in a loop. ``step_fn`` must not read tensors
    back to the host on the card (a capture refuses it)."""
    k = int(k)
    if k < 1:
        raise ValueError(f"chain_steps: k must be >= 1, got {k}")
    donate = frozenset(int(i) for i in donate_argnums)
    cache = {}

    def run_steps(args, n_carry):
        carry, rest, loss = list(args[:n_carry]), args[n_carry:], None
        for _ in range(k):
            out = step_fn(*carry, *rest)
            carry, loss = list(out[:-1]), out[-1]
        return carry, loss

    def n_carry_of(out, n_args):
        if not isinstance(out, (tuple, list)) or len(out) < 2:
            raise TypeError("chain_steps: step_fn must return (carry..., "
                            f"loss) with at least one carry output, got "
                            f"{type(out).__name__}")
        n = len(out) - 1
        if n > n_args:
            raise TypeError(f"chain_steps: step_fn returns {n} carry "
                            f"outputs but was called with only {n_args} "
                            f"arguments")
        return n

    def chained(*args):
        tensors = _tensors(args)
        if not tensors or tensors[0].device.type != "cuda":
            out = step_fn(*args)
            rest = args[n_carry_of(out, len(args)):]
            for _ in range(k - 1):
                out = step_fn(*out[:-1], *rest)
            return (*out[:-1], out[-1])
        key = tuple((tuple(a.shape), a.dtype, a.device) if isinstance(
            a, torch.Tensor) else (None, a) for a in args)
        entry = cache.get(key)
        if entry is None:
            entry = cache[key] = _capture_chain(
                step_fn, k, args, donate, n_carry_of, run_steps)
        return entry(args)

    return chained


def _capture_chain(step_fn, k, args, donate, n_carry_of, run_steps):
    """The CUDA graph of ``k`` steps for one argument signature."""
    from . import graphs

    dev = _tensors(args)[0].device
    with torch.no_grad():
        static = [a if (i in donate or not isinstance(a, torch.Tensor))
                  else a.detach().clone() for i, a in enumerate(args)]
    n_carry = [None]

    def steps(*static):
        carry, loss = run_steps(static, n_carry[0])
        # the carry comes back into the static buffers: a replay starts
        # where the last one ended
        with torch.no_grad():
            for s, c in zip(static[:n_carry[0]], carry):
                if c is not s:
                    s.copy_(c)
        return loss

    def probe():
        n_carry[0] = n_carry_of(step_fn(*static), len(static))

    # warm-up: one step tells the carry's arity; the static buffers
    # (donated tensors among them) are put back
    name = getattr(step_fn, "__name__", "step")
    graph = graphs.capture(steps, static, dev,
                           torch.cuda.graph_pool_handle(),
                           f"chain_steps({name}, k={k})", warm=probe,
                           state=_tensors(static))
    n = n_carry[0]

    def call(call_args):
        loss = graph(call_args)
        with torch.no_grad():
            carry = [static[i] if i in donate else static[i].clone()
                     for i in range(n)]
            return (*carry, loss.clone())

    return call
