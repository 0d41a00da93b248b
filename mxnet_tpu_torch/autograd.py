"""Define-by-run autograd with MXNet's contract, over torch autograd.

Port of ``mxnet_tpu/autograd.py``. The JAX package records a tape of
pullback closures; here torch's own autograd graph is the tape, and
this module keeps the two MXNet semantics torch does not have::

    with autograd.record():          # record + train mode
        loss = loss_fn(net(x), y)
    loss.backward()                  # leaf gradients per grad_req

- **Recording and train/predict mode are global (thread-local) autograd
  state**, not ``nn.Module.training``. :func:`record` turns torch's
  gradient mode on and sets train mode; :func:`pause` turns it off. The
  port's layers read :func:`is_training` (``Dropout``), and a
  :class:`~.gluon.block.Block` called outside :func:`record` builds no
  graph, as an MXNet block records nothing outside it.
- **grad_req.** ``"write"`` OVERWRITES a leaf's gradient on each
  backward, ``"add"`` accumulates and ``"null"`` takes none. torch
  always accumulates, so a ``"write"`` leaf carries a hook that drops
  its old gradient just before the new one lands: two backwards with no
  ``zero_grad`` between them leave the second gradient, not the sum. A
  leaf the backward does not reach keeps its gradient, as in MXNet.

A head's default gradient is ones of its shape, as MXNet's, for a
head of any size: :func:`backward`, and ``NDArray.backward`` (a plain
tensor's ``backward()`` is torch's own, whose implicit head gradient
exists only for a single element). ``train_mode`` of :func:`backward`
and :func:`grad` is the reference's argument: torch records each op's
backward with its forward, so the mode the forward ran in decides, and
the flag sets ``is_training()`` while the backward runs (it is read by
nothing there, as in the JAX package).
"""
from __future__ import annotations

import threading
import warnings
import weakref

import torch
from torch.nn.parameter import UninitializedParameter

__all__ = ["backward", "grad", "is_recording", "is_training",
           "mark_variables", "pause", "predict_mode", "record",
           "set_grad_req", "set_recording", "set_training", "train_mode"]

_GRAD_REQS = ("write", "add", "null")


class _AutogradState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AutogradState()
# grad() calls in flight: the write hooks then leave every .grad alone.
# Process-wide, not thread-local: on the card torch runs the backward
# (and so the hooks) in its own device threads.
_GRAD_CALLS = [0]
_GRAD_LOCK = threading.Lock()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _Scope:
    """Sets recording and/or train mode for its body; recording also
    sets torch's gradient mode."""

    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._grad_mode = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
            self._grad_mode = torch.enable_grad() if self._rec \
                else torch.no_grad()
            self._grad_mode.__enter__()
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._train is not None:
            set_training(self._prev_train)
        if self._rec is not None:
            self._grad_mode.__exit__(*exc)
            set_recording(self._prev_rec)
        return False


def record(train_mode: bool = True):
    """Scope: record operations for autograd (and set train mode)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope: stop recording (e.g. for parameter updates)."""
    return _Scope(False, train_mode)


def train_mode():
    """Scope: train mode, recording unchanged."""
    return _Scope(None, True)


def predict_mode():
    """Scope: predict mode, recording unchanged."""
    return _Scope(None, False)


def _write_hook(ref):
    def hook(g):
        leaf = ref()
        if leaf is not None and not _GRAD_CALLS[0] \
                and getattr(leaf, "_mx_grad_req", "write") == "write":
            leaf.grad = None        # the accumulation that follows writes
        return g
    return hook


def set_grad_req(leaf, req):
    """Give a leaf tensor MXNet's ``grad_req``: ``"null"`` stops its
    gradient, ``"write"``/``"add"`` take one (see the module
    docstring). Returns the leaf."""
    if req not in _GRAD_REQS:
        raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got "
                         f"{req!r}")
    leaf._mx_grad_req = req
    if isinstance(leaf, UninitializedParameter):
        return leaf             # set again when it takes its shape
    leaf.requires_grad_(req != "null")
    if req == "null":
        leaf.grad = None
    elif not getattr(leaf, "_mx_hooked", False):
        leaf.register_hook(_write_hook(weakref.ref(leaf)))
        leaf._mx_hooked = True
    return leaf


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to leaf tensors (MXAutogradMarkVariables):
    each variable gets ``grad_req`` and starts from its given
    gradient."""
    if isinstance(variables, torch.Tensor):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        set_grad_req(v, req)
        if req != "null":
            v.grad = g


def _head_grads(heads, head_grads):
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    return list(heads), [torch.ones_like(h) if g is None else g
                         for h, g in zip(heads, head_grads)]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run the reverse sweep from ``heads`` (default head gradient:
    ones); leaf gradients follow their ``grad_req``. ``train_mode``: see
    the module docstring."""
    with _Scope(None, bool(train_mode)):
        _backward(heads, head_grads, retain_graph)


def _backward(heads, head_grads, retain_graph):
    heads, head_grads = _head_grads(heads, head_grads)
    live = [(h, g) for h, g in zip(heads, head_grads) if h.requires_grad]
    if len(live) < len(heads):
        # as the JAX package: a head recorded without any gradient path
        # (outside record(), or every leaf "null") gives no gradient
        warnings.warn("backward() head was not computed inside "
                      "autograd.record() from a leaf that takes a "
                      "gradient; no gradient flows through it",
                      stacklevel=3)
    if live:
        torch.autograd.backward([h for h, _ in live], [g for _, g in live],
                                retain_graph=bool(retain_graph))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    and not written into any ``.grad``. ``train_mode``: see the module
    docstring."""
    heads, head_grads = _head_grads(heads, head_grads)
    single = isinstance(variables, torch.Tensor)
    variables = [variables] if single else list(variables)
    with _GRAD_LOCK:
        _GRAD_CALLS[0] += 1
    try:
        with _Scope(None, bool(train_mode)):
            out = torch.autograd.grad(
                heads, variables, head_grads,
                retain_graph=retain_graph if retain_graph is not None
                else create_graph, create_graph=create_graph,
                allow_unused=True)
    finally:
        with _GRAD_LOCK:
            _GRAD_CALLS[0] -= 1
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(variables, out)]
