"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package traces a function once per input signature and runs
the compiled program after that. Here a function of CUDA tensors is
*captured* once per key into a ``torch.cuda.CUDAGraph`` and replayed:
its inputs are copied into static buffers, the replay runs every
launch the function made while it was captured, on the same
addresses, and its outputs land in static buffers. A replay costs one
launch from the host where eager dispatch costs one per operation.

:func:`capture` makes a :class:`Graph` of ``fn(*static)``: calling the
graph with new inputs copies them into ``static`` (an input that
already is its static buffer, as a donated carry is, is not copied),
replays, and returns the static outputs, which the next call
overwrites. The hybridized blocks' CachedOp (``gluon.block``), the
decode model's steps (``serving.decode_model``) and
``engine.chain_steps`` are built on it.

What surrounds a capture:

- **Warm-up.** The function runs once eagerly on the capture stream
  before it is captured, so that lazy set-up happens outside the
  capture: cuBLAS's handle and workspace for that stream, the kernels'
  libraries, the paged-attention kernel's ticket counters of that
  stream (``ops.paged_attention._tickets``), the LSTM kernels' grid
  plans. The tensors given as ``state`` (running statistics that the
  function updates in place) are put back afterwards.
- **Threads.** Each thread warms up and captures on a side stream of
  its own (:func:`capture_stream`), and :func:`captures` counts the
  calling thread's captures: an engine tells a capture made by its own
  call from a replay by that count before and after the call, whatever
  other threads capture meanwhile. Warm-ups and captures take turns
  process-wide (torch hands out side streams from a pool, which two
  threads may share).
- **Launch counts.** The kernels' wrappers count their launches on
  the host, which a replay does not pass through. The launches on the
  capture stream are tallied apart (``ops._build.tally``): the
  warm-up's are dropped, the capture's are kept with its
  :class:`Graph` and added again at every replay, so
  ``ops.launch_counts()`` reads the same whether a block ran eagerly
  or from its graph. Launches on other streams count as they go.
- **Empty graphs.** A function that launches no device work (its
  outputs are views of its inputs, say) makes an empty graph, which
  torch warns about at the end of its capture. The capture takes that
  warning to itself, names the function in :func:`empty_captures`, and
  the graph's replay does nothing.
- **Host reads.** An operation whose loop needs a scalar from the
  device (NMS: its candidates' count and its convergence flag) reads
  it through :func:`host_read`, which counts the read for the calling
  thread and raises ``MXNetError`` while the current stream captures.
  A function whose warm-up made such a read is refused before its
  capture (:class:`NotCapturable`): the hybridized blocks' CachedOp
  and the executor run that key's forward eagerly from then on, and
  every other caller gets the error.
- **Failures.** A capture that fails raises ``MXNetError`` naming what
  was captured. Nothing is retried eagerly: code whose capture fails
  has an unmarked host read or an allocation pattern that a graph
  cannot hold, and that is a fault to fix.
- **Random numbers.** Operations that draw from torch's default CUDA
  generator (dropout) register it with the capture; each replay
  advances it and draws new numbers, and ``mx.random.seed`` after a
  capture takes effect on the next replay.

:func:`replayed_launches` counts the kernel launches that graph replays
made, apart from the eager ones.
"""
from __future__ import annotations

import collections
import threading
import time
import warnings

import torch

from . import ops
from .base import MXNetError
from .ops import _build

__all__ = ["Graph", "NotCapturable", "capture", "capture_stream", "captures",
           "count_capture", "empty_captures", "host_read", "replayed_launches",
           "reset_replayed_launches"]

_LOCAL = threading.local()
_CAPTURE_LOCK = threading.RLock()
_REPLAYED = collections.Counter()
_EMPTY = []
_EMPTY_WARNING = "The CUDA Graph is empty"


def captures():
    """Graphs the calling thread captured so far (CPU entries, which
    stand where a capture would be, included)."""
    return getattr(_LOCAL, "captures", 0)


def count_capture():
    """Count one capture (or the CPU entry that stands for one) of the
    calling thread."""
    _LOCAL.captures = captures() + 1


def empty_captures():
    """What each empty graph captured so far was made of (module
    docstring), in capture order."""
    return list(_EMPTY)


def replayed_launches():
    """``{kernel name: launches}`` made by graph replays since the last
    :func:`reset_replayed_launches` (they count in
    ``ops.launch_counts()`` too)."""
    return dict(_REPLAYED)


def reset_replayed_launches():
    _REPLAYED.clear()


class NotCapturable(MXNetError):
    """The function's warm-up read the device back to the host
    (:func:`host_read`), which a CUDA graph cannot hold."""


def _host_reads():
    return getattr(_LOCAL, "host_reads", 0)


def host_read(x):
    """``x.item()`` for an operation's loop-control scalar, counted for
    the calling thread (module docstring); raises ``MXNetError`` while
    the current stream captures."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError("an operation that reads the device back to the "
                         "host (NMS's loop control) cannot run inside a "
                         "CUDA graph capture")
    _LOCAL.host_reads = _host_reads() + 1
    return x.item()


def capture_stream(device):
    """The calling thread's side stream on ``device``, on which its
    graphs warm up and are captured (made at first use)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(index)
    return stream


class Graph:
    """One captured ``torch.cuda.CUDAGraph`` of ``fn(*static)``: its
    static inputs and outputs, the kernel launches a replay makes
    (``{kernel name: launches}``) and the capture's wall time in ms
    (warm-up excluded)."""

    __slots__ = ("graph", "static", "out", "launches", "capture_ms",
                 "empty")

    def __init__(self, graph, static, out, launches, capture_ms, empty):
        self.graph = graph
        self.static = static
        self.out = out
        self.launches = launches
        self.capture_ms = capture_ms
        self.empty = empty

    def replay(self):
        """Replay on the current stream and count its launches."""
        if not self.empty:
            self.graph.replay()
        if self.launches:
            ops.add_launch_counts(self.launches)
            _REPLAYED.update(self.launches)

    def __call__(self, inputs):
        """Copy ``inputs`` into the static inputs (tensors only; one that
        is its static buffer is not copied), replay, and return the
        static outputs."""
        with torch.no_grad():
            for s, t in zip(self.static, inputs):
                if isinstance(s, torch.Tensor) and \
                        s.data_ptr() != t.data_ptr():
                    s.copy_(t)
        self.replay()
        return self.out


def _on_capture_stream(device, fn):
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        with _build.tally(stream.cuda_stream) as tally:
            out = fn()
    current.wait_stream(stream)
    return out, tally


def _warm_up(fn, device, state):
    with torch.no_grad():
        saved = [t.detach().clone() for t in state]

    def run():
        fn()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)

    _on_capture_stream(device, run)


def capture(fn, static, device, pool, what, warm=None, state=()):
    """Capture ``fn(*static)`` into a :class:`Graph` on the calling
    thread's capture stream of ``device``, its memory from ``pool``
    (``torch.cuda.graph_pool_handle()``); the function's result is the
    graph's static outputs. First ``warm()`` runs once eagerly (by
    default ``fn(*static)``; ``warm=False`` skips the warm-up), and
    the tensors of ``state`` are put back after it. Raises
    :class:`NotCapturable` when the warm-up made a :func:`host_read`,
    and ``MXNetError`` naming ``what`` when the capture fails."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        if warm is not False:
            reads = _host_reads()
            _warm_up(warm or (lambda: fn(*static)), device, state)
            if _host_reads() != reads:
                raise NotCapturable(f"{what} reads the device back to the "
                                    f"host (graphs.host_read), which a CUDA "
                                    f"graph cannot hold")
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")

                def run():
                    with torch.cuda.graph(graph, pool=pool,
                                          stream=capture_stream(device),
                                          capture_error_mode="thread_local"):
                        return fn(*static)
                out, launches = _on_capture_stream(device, run)
        except (RuntimeError, ValueError, TypeError) as e:
            raise MXNetError(f"CUDA graph capture of {what} failed: "
                             f"{type(e).__name__}: {e}") from e
        capture_ms = (time.perf_counter() - t0) * 1e3
    empty = False
    for w in caught:
        if str(w.message).startswith(_EMPTY_WARNING):
            empty = True
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    if empty:
        _EMPTY.append(what)
    count_capture()
    return Graph(graph, static, out, launches, capture_ms, empty)
