"""Base of the port's layers: an ``nn.Module`` that carries Gluon's
parameter naming, MXNet's recording rule and the reference's Block
API.

Port of ``mxnet_tpu/gluon/block.py``.

**Names.** Each :class:`Block` keeps its own Gluon prefix. Given as
``prefix=``, it is used as it is (``""`` for none). Left ``None``, a
block made inside a parent's :meth:`~Block.name_scope` gets the
reference's ``<class>{count}_`` from that scope's counter
(``embedding0_``, ``lstm0_``, ``dense0_`` ...), and one made outside
any scope gets it from a process-wide counter, as MXNet's
``NameManager``. :meth:`Block.gluon_params` joins the prefixes along the
module tree below the block, so the port's names are the JAX model's
without the model prefix (``bertmodel0_``); :meth:`Block.collect_params`
(with a ``select`` regex over those names) and
:meth:`Block.load_gluon_params` use them. ``Block(params=other)``
shares: each parameter whose name ``other`` has is ``other``'s tensor,
also in children made inside the block's name scope.

**Parameter files.** :meth:`Block.save_parameters` and
:meth:`Block.load_parameters` use the reference's structural names
(``1.weight``, ``features.4.0.body.0.weight``, ``l0_i2h_weight``):
``named_parameters()``, which are what the JAX package's
``_collect_params_with_prefix`` gives for the same model, in the
``.params`` format of ``ndarray.serialization``. A file with no ``.``
in its names is read by Gluon name instead (the reference's legacy
full-name files; a model prefix is stripped).

**NDArray boundary.** When an argument of a top-level call is an
``NDArray`` (lists of them count), the block unwraps every argument to
a plain tensor and wraps its outputs back: NDArray in, NDArray out;
tensor in, tensor out. The outputs are ``mx.np.ndarray``s under
``npx.set_np()`` or when an argument is one (``ndarray.as_nd``).
Nothing inside a model's forward dispatches
through ``NDArray.__torch_function__``, and callers that pass tensors
(the serving engines, the examples' training loops, the kernels'
wrappers) see nothing of it.

**Deferred shapes.** A layer made without its input width (``Dense``
without ``in_units``, ``Conv2D`` without ``in_channels``, an ``LSTM``
without ``input_size``) holds ``UninitializedParameter``s; its first
forward, or a parameter file, gives them their shapes in place
(``parameter.materialize``).

**Seeds.** :meth:`Block.initialize` draws from numpy generators made
from its ``seed``: every parameter whose shape is known draws, in
registration order, from one ``numpy.random.default_rng(seed)``; a
deferred parameter draws when its shape becomes known, from its own
``numpy.random.default_rng((seed, k))``, ``k`` its position in that
order. A parameter made with its own initializer (``_param(...,
init=)``, e.g. an LSTM's ``"zeros"`` biases, or a layer's
``weight_initializer``) takes that one; the others take ``init`` (an
``initializer.Initializer`` or a registered name) by their names.
Without ``init`` they keep the port's default: every ``weight`` ~
Normal(0, ``sigma``), ``gamma`` and running variances ones,
``bias``/``beta`` and running means zeros. A parameter initialized
once is left as it is unless ``force_reinit``.

**User blocks.** A subclass that defines ``hybrid_forward(self, F,
x, ...)`` instead of ``forward`` runs as the reference's: ``F`` is
``mx.nd`` (the op registry) and the parameters it assigned as
attributes from ``self.params.get(...)``/``get_constant(...)`` come as
keyword arguments, plain tensors, by attribute name
(:meth:`Block.forward`). Inside it the F-ops see and give plain
tensors. Layers that define ``forward`` (all of the port's) keep their
own path. :meth:`Block.cast` changes the parameters' type in place, as
the JAX block's does. A block records a graph only inside
``autograd.record()``: called anywhere else it runs with torch's
gradient mode off, as an MXNet block records nothing outside
``record()``. Train/predict mode is ``autograd.is_training()``, not
``nn.Module.training``.

**Hybridize.** :class:`HybridBlock` is the reference's: after
:meth:`HybridBlock.hybridize` a call goes through its CachedOp, which
keeps one entry per key (the JAX key: the structure, shapes and types
of the arguments and ``autograd.is_training()``; here also whether
the call records, torch's inference mode and the device; the port has
no AMP, whose cast generation is the rest of the JAX key, and
:meth:`Block.cast` clears the cache). On CUDA tensors an entry is a
CUDA graph (``graphs``): the first call of a key warms up eagerly on
a side stream and captures the forward, later calls copy their inputs
into the entry's static inputs and replay. Under ``autograd.record()``
the entry is two graphs, the forward and its backward (captured with
``torch.autograd.grad`` over the parameters and the inputs that take
gradients), joined by a ``torch.autograd.Function``: ``backward()``,
``grad_req`` and ``Trainer.step`` see gradients as from an eager
forward. A second call of one key before the first call's backward
takes a second pair of graphs, so no call's saved activations are
overwritten. All graphs of one root block share one memory pool. A
recorded entry holds its forward's activations for as long as it
lives, so a block keeps at most four of them, dropping the least
recently used (:meth:`HybridBlock.hybridize` gives the cost). Each
call's outputs (and gradients) are copies out of the static buffers,
so they stay valid after the next call: one device copy of every
output (and gradient) a call. A hybridized block inside a hybridized
parent runs inside the parent's graph (nothing nests); a ``Block``
that is not a ``HybridBlock`` (``Sequential``, ``Lambda``, a user's
``gluon.Block``) only passes ``hybridize`` on to its children.
BatchNorm's running statistics update inside the graph at every
replay; dropout draws from torch's CUDA generator, which the capture
registers, so every replay draws a new mask and ``mx.random.seed``
after a capture takes effect. On CPU tensors there are no graphs: the
same CachedOp (keys, static input copies, output structure) runs the
eager body where the card would replay. A key whose forward reads the
device back to the host (an op that calls ``graphs.host_read``: NMS,
in ``box_nms`` and ``MultiBoxDetection``) is found at its warm-up and
runs its forward eagerly on the card from then on, as ``graphs``
says. Any other capture that fails raises ``MXNetError`` naming the
block and the key; nothing runs eagerly in its place. ``hybridize(remat=True)`` recomputes the block's
activations in the backward (``torch.utils.checkpoint``, non-reentrant)
when an ancestor's CachedOp (or the block's own) runs it; see
:meth:`HybridBlock.hybridize`. :func:`functionalize` gives a block as a
function of its parameters (``torch.func.functional_call``).

**Export.** A block called with an ``mx.sym`` Symbol builds its graph:
a block whose class defines ``hybrid_forward`` runs it with ``F =
mx.sym``, each parameter a variable of its full Gluon name, inside a
``name.Prefix`` of its full prefix (the JAX block's name scope), so the
graph's node names are the JAX package's: the full prefix is the
outermost block's prefix and the local prefixes down the module tree.
The built-in layers and the model zoo carry the JAX bodies as
``hybrid_forward`` beside their torch ``forward`` (tensors keep the
latter); a block without one (``Sequential``, a user ``Block``) runs
its ``forward``, which passes the Symbol on to its children, and one
whose ``forward`` is torch code raises ``MXNetError`` naming it (the
fused recurrent layers). :meth:`HybridBlock.export` writes that graph
and the parameters; :class:`SymbolBlock` runs a graph as a block
(``SymbolBlock.imports`` reads an export, of either package).
"""
from __future__ import annotations

import contextlib
import logging
import re
import threading
import warnings
import weakref

import numpy as np
import torch
from torch import nn

from .. import autograd, graphs, initializer, symbol
from .. import ndarray as _F
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import serialization
from ..name import Prefix
from ..ndarray.ndarray import NDArray, as_nd, dtype_name, wrap_cls
from ..ndarray.register import dispatch_cast_generation
from ..symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, is_deferred, materialize,
                        new_parameter)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "aux_updates_on",
           "functionalize"]

_LOG = logging.getLogger(__name__)

# a block's CachedOp keeps at most this many recorded entries (each
# holds its forward's activations), the least recently used going first
_RECORDED_KEYS = 4

# parameter names the default fill sets to one (the rest but weights: 0)
_ONES = ("gamma", "running_var", "moving_var")


class _BlockScope:
    """A block's name scope: children made inside it take their
    prefixes from its counters (and its shared parameters)."""

    _current = threading.local()
    _global = {}                    # NameManager: hint -> next count
    _global_lock = threading.Lock()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @classmethod
    def current(cls):
        return getattr(cls._current, "value", None)

    def next_prefix(self, hint):
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}_"

    @classmethod
    def global_prefix(cls, hint):
        with cls._global_lock:
            count = cls._global.get(hint, 0)
            cls._global[hint] = count + 1
        return f"{hint}{count}_"

    def __enter__(self):
        self._old = _BlockScope.current()
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old
        return False


# -- the CachedOp's guards ---------------------------------------------------
# Inside a CachedOp's body (its warm-up, capture or CPU run) every block
# runs eagerly, so a parent's graph holds its hybridized children: the
# JAX package's trace guard, which keeps jit from nesting.
_GUARD = threading.local()


def _in_cached_call():
    return getattr(_GUARD, "depth", 0) > 0


class _trace_guard:
    def __enter__(self):
        _GUARD.depth = getattr(_GUARD, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _GUARD.depth -= 1
        return False


def aux_updates_on():
    """Whether a layer with running state (``BatchNorm``) writes it
    now: not while remat recomputes a forward in the backward (the
    forward already wrote it) and not inside :func:`functionalize`'s
    function (which drops the updates, as the JAX package's does)."""
    return not getattr(_GUARD, "no_aux", False)


class _no_aux:
    def __enter__(self):
        self._prev = getattr(_GUARD, "no_aux", False)
        _GUARD.no_aux = True
        return self

    def __exit__(self, *exc):
        _GUARD.no_aux = self._prev
        return False


class _SymbolicNames:
    """The names of one symbolic call of ``root`` and of the blocks it
    reaches: each block's full prefix (the root's prefix and the local
    prefixes along the module tree, as the JAX blocks carry them) and
    one variable a parameter, named by its full Gluon name."""

    def __init__(self, root):
        self.prefix = {}
        self.param = {}
        self._vars = {}

        def walk(mod, prefix, scope):
            self.prefix.setdefault(id(mod), prefix)
            for name, t in mod.named_parameters(recurse=False):
                self.param.setdefault(id(t), prefix + name)
            for child, full, inner in _children_names(mod, scope):
                walk(child, full, inner)

        walk(root, root._prefix, root._prefix)

    def var(self, t, name, view=None):
        """The variable of parameter ``t`` (the first name it was given
        here, as the JAX ``Parameter.var`` keeps one)."""
        v = self._vars.get(id(t))
        if v is None:
            shape = getattr(t, "_mx_shape", None) if is_deferred(t) \
                else tuple(t.shape)
            v = symbol.var(self.param.get(id(t), name), shape=shape,
                           dtype=dtype_name(getattr(t, "_mx_dtype", None)
                                            or t.dtype),
                           lr_mult=getattr(view, "lr_mult", 1.0),
                           wd_mult=getattr(view, "wd_mult", 1.0))
            self._vars[id(t)] = v
        return v


def _children_names(mod, scope):
    """``(child, its full prefix, the prefix its own children extend)``
    for each child of ``mod``, whose children extend ``scope``. A child
    extends its own prefix for its children, unless it is marked
    ``_flat_scope``: a block whose children the JAX block makes in its
    parent's name scope (it never enters its own), so their names
    extend the parent's prefix."""
    for child in mod.children():
        full = scope + getattr(child, "_prefix", "")
        yield child, full, scope if getattr(child, "_flat_scope", False) \
            else full


class _Const:
    """A non-tensor argument in a key: it stands as itself."""


def _spec(obj, leaves):
    """The structure of ``obj`` for a cache key, its tensors appended to
    ``leaves``: a tensor stands as its shape, type, device and
    ``requires_grad``; lists, tuples and dicts recurse; anything else
    (``None``, numbers, strings) stands as itself and must hash."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return (torch.Tensor, tuple(obj.shape), obj.dtype, obj.device,
                obj.requires_grad)
    kind = type(obj)
    if kind in (list, tuple):
        return (kind, tuple(_spec(v, leaves) for v in obj))
    if kind is dict:
        return (dict, tuple((k, _spec(v, leaves)) for k, v in obj.items()))
    try:
        hash(obj)
    except TypeError:
        raise MXNetError(f"a hybridized block takes tensors, lists, tuples, "
                         f"dicts and hashable constants; got a "
                         f"{kind.__name__}") from None
    return (_Const, obj)


def _build(spec, it):
    """``spec`` rebuilt with the tensors of the iterator ``it``."""
    kind = spec[0]
    if kind is torch.Tensor:
        return next(it)
    if kind in (list, tuple):
        return kind(_build(s, it) for s in spec[1])
    if kind is dict:
        return {k: _build(s, it) for k, s in spec[1]}
    return spec[1]


def _has_dropout(block):
    return any(type(m).__name__ == "Dropout" and getattr(m, "_rate", 0) > 0
               for m in block.modules())


def _checkpoint(fn, policy, block):
    """``fn()`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward. The recompute writes no
    running statistics (:func:`aux_updates_on`). Outside a capture the
    RNG state is kept, so the recompute draws the forward's dropout
    masks; inside one torch cannot read it (a capture's generator
    offset is known only at replay), so a block with dropout in train
    mode raises there."""
    from torch.utils.checkpoint import checkpoint
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    if capturing and autograd.is_training() and _has_dropout(block):
        raise MXNetError(f"remat of {block.name or type(block).__name__}: "
                         f"dropout's recompute inside a CUDA graph would "
                         f"draw other masks than its forward")
    calls = [0]
    # the recompute runs in the backward, outside this call's scopes:
    # it re-enters them (recording, train mode, the trace guard, the
    # remat claim and any parameter aliases of a capture)
    training, swap = autograd.is_training(), getattr(_GUARD, "swap", None)

    def run():
        calls[0] += 1
        if calls[0] == 1:
            return fn()
        prev_rec = autograd.set_recording(True)
        prev_train = autograd.set_training(training)
        prev_remat = getattr(_GUARD, "remat", False)
        _GUARD.remat = True
        aliases = _swap_params(*swap) if swap else contextlib.nullcontext()
        try:
            with _trace_guard(), _no_aux(), torch.enable_grad(), aliases:
                return fn()
        finally:
            _GUARD.remat = prev_remat
            autograd.set_training(prev_train)
            autograd.set_recording(prev_rec)

    kw = {}
    if policy is not None:
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            policy)
    return checkpoint(run, use_reentrant=False,
                      preserve_rng_state=not capturing, **kw)


def _saved_ops(names):
    import torch.ops as _ops
    aten = _ops.aten
    table = {
        "dots": (aten.mm.default, aten.bmm.default, aten.addmm.default,
                 aten.baddbmm.default, aten.convolution.default),
        "dots_no_batch": (aten.mm.default, aten.addmm.default),
        "conv_out": (aten.convolution.default,),
    }
    return frozenset(op for n in names for op in table[n])


# JAX's checkpoint policy names that mean something in torch: what the
# forward keeps (the rest is recomputed). "nothing_saveable" is plain
# checkpointing (None here).
_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": ("dots",),
    "checkpoint_dots": ("dots",),
    "dots_with_no_batch_dims_saveable": ("dots_no_batch",),
    "checkpoint_dots_with_no_batch_dims": ("dots_no_batch",),
}


def checkpoint_policy(name):
    """The selective-checkpoint policy of a JAX policy name, or of
    ``"names:conv_out"`` (keep the convolutions' outputs, recompute the
    elementwise chain between them; the JAX ``Convolution`` op tags its
    output ``conv_out``). ``None`` for plain checkpointing. Raises
    ``ValueError`` naming any other name."""
    if name is None or callable(name):
        return name
    if name.startswith("names:"):
        names = name[len("names:"):].split(",")
        bad = [n for n in names if n != "conv_out"]
        if bad:
            raise ValueError(f"remat_policy {name!r}: no torch counterpart "
                             f"for the checkpoint names {bad} (only "
                             f"'conv_out')")
        keep = _saved_ops(["conv_out"])
    elif name in _POLICIES:
        what = _POLICIES[name]
        if what is None:
            return None
        keep = "all" if what == "all" else _saved_ops(what)
    else:
        raise ValueError(f"remat_policy {name!r} has no torch meaning: "
                         f"use one of {sorted(_POLICIES)} or "
                         f"'names:conv_out'")
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if keep == "all" or op in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _nd_in(x):
    return isinstance(x, NDArray) or (type(x) in (list, tuple) and any(
        isinstance(v, NDArray) for v in x))


def _unwrap(x):
    if isinstance(x, NDArray):
        return x.as_subclass(torch.Tensor)
    if type(x) in (list, tuple):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x, cls):
    if isinstance(x, torch.Tensor):
        return as_nd(x, cls=cls)
    if type(x) in (list, tuple):
        return type(x)(_wrap(v, cls) for v in x)
    return x


def _out_cls(args, kwargs):
    """The class of a top-level call's outputs: ``mx.np.ndarray`` under
    ``npx.set_np()`` or when an argument is one, else ``NDArray``."""
    flat = [v for a in (*args, *kwargs.values())
            for v in (a if type(a) in (list, tuple) else (a,))]
    return wrap_cls(*flat)


def _draw(name, chosen, rng, sigma, verbose, p):
    """Fill ``p`` with its initial values (module docstring)."""
    if chosen is not None:
        chosen(name, p, rng)
    elif name.endswith("weight"):
        w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        p.copy_(torch.from_numpy(w * np.float32(sigma)))
    else:
        p.fill_(1.0 if name.endswith(_ONES) else 0.0)
    p._mx_initialized = True
    if verbose:
        _LOG.info("Initialized %s as %s", name,
                  chosen if chosen is not None else "the default")


@torch.no_grad()
def init_params(items, init=None, ctx=None, verbose=False,
                force_reinit=False, seed=0, sigma=0.02):
    """Initialize ``(name, Parameter or tensor)`` pairs by the rules of
    :meth:`Block.initialize`."""
    dev = None if ctx is None else resolve_device(ctx)
    rng = np.random.default_rng(seed)
    default = None if init is None else initializer.create(init)
    skipped = []
    for k, (name, p) in enumerate(items):
        p = p._tensor if isinstance(p, Parameter) else p
        if getattr(p, "_mx_constant", False):
            continue                    # a Constant keeps its value
        if getattr(p, "_mx_initialized", False) and not force_reinit:
            skipped.append(name)
            continue
        own = getattr(p, "_mx_init", None)
        chosen = default if own is None else initializer.create(own)
        if is_deferred(p):
            if dev is not None:
                p._mx_device = dev
            p._mx_pending = lambda t, n=name, c=chosen, i=k: _draw(
                n, c, np.random.default_rng((seed, i)), sigma, verbose, t)
            continue
        if dev is not None and p.device != dev:
            p.data = p.data.to(dev)
            p.grad = None
        _draw(name, chosen, rng, sigma, verbose, p)
    if skipped:
        warnings.warn(f"Parameters {skipped[:3]}{'...' if len(skipped) > 3 else ''} "
                      f"are already initialized; ignoring. Set "
                      f"force_reinit=True to re-initialize.", stacklevel=3)


class Block(nn.Module):
    """``nn.Module`` with a Gluon prefix (see module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._deferred = False          # a parameter waits for its shape
        scope = _BlockScope.current()
        if prefix is None:
            hint = self._alias()
            prefix = scope.next_prefix(hint) if scope is not None \
                else _BlockScope.global_prefix(hint)
        self._prefix = prefix
        if params is not None:
            self._shared = (params, "")
        elif scope is not None and scope._block._shared is not None:
            pd, path = scope._block._shared
            self._shared = (pd, path + prefix)
        else:
            self._shared = None
        self._scope = _BlockScope(self)
        self._reg_params = {}           # attribute name -> Parameter view
        self._reg_keys = {}             # attribute name -> _parameters key
        # hybridize: the CachedOp is on (HybridBlock), remat and its
        # policy; _routed is any of them, the one test a call makes
        self._active = False
        self._remat = False
        self._remat_policy = None
        self._routed = False
        self._hybridize = (False, {})
        self._cached_graph = {}
        self._graph_pool = None

    def _alias(self):
        """The name hint of the block's prefix (the reference's): the
        class name in lower case unless a class says otherwise (the
        recurrent cells: ``lstm``, ``gru``, ...)."""
        return type(self).__name__.lower()

    def __setattr__(self, name, value):
        shared = self.__dict__.get("_shared")
        if shared is not None and isinstance(value, nn.Parameter):
            pd, path = shared
            if path + name in pd:
                value = pd[path + name]._tensor
        if isinstance(value, Parameter):
            # ``self.weight = self.params.get("weight", ...)``: the tensor
            # is registered (under the name given to ``get``, or this
            # one) and the attribute is the Gluon view, which
            # ``hybrid_forward`` receives as a keyword argument
            key = next((k for k, t in self._parameters.items()
                        if t is value._tensor), None)
            if key is None:
                self.register_parameter(name, value._tensor)
                self._deferred = self._deferred or is_deferred(value._tensor)
                key = name
            self._reg_params[name] = value
            self._reg_keys[name] = key
            self.__dict__[name] = value
            return
        super().__setattr__(name, value)

    def __call__(self, *args, **kwargs):
        # a plain tensor argument costs one type test: nested calls and
        # callers that pass tensors pay nothing more
        for a in args:
            if type(a) is not torch.Tensor:
                if _nd_in(a):
                    return self._call_nd(args, kwargs)
                if isinstance(a, Symbol):
                    return self._call_symbolic(args, kwargs)
        if kwargs and any(_nd_in(v) for v in kwargs.values()):
            return self._call_nd(args, kwargs)
        with torch.set_grad_enabled(autograd.is_recording()):
            if self._routed:
                return self._call_routed(args, kwargs)
            return super().__call__(*args, **kwargs)

    def _call_nd(self, args, kwargs):
        """NDArray in, NDArray out (module docstring)."""
        cls = _out_cls(args, kwargs)
        args = _unwrap(args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        return _wrap(self.__call__(*args, **kwargs), cls)

    def _call_symbolic(self, args, kwargs):
        """A Symbol in, the block's graph out (module docstring,
        "Export"). A block whose class defines ``hybrid_forward`` runs
        it with ``F = mx.sym``, its parameters variables of their full
        Gluon names, inside a ``Prefix`` of its full prefix (the JAX
        block's ``name_scope``); a block without one (``Sequential``,
        a user ``Block``) runs its ``forward``, which passes the Symbol
        on to its children. A ``forward`` that is torch code raises
        ``MXNetError`` naming the block."""
        names = getattr(_GUARD, "sym_names", None)
        if names is None:
            _GUARD.sym_names = _SymbolicNames(self)
            try:
                return self._call_symbolic(args, kwargs)
            finally:
                _GUARD.sym_names = None
        if type(self).hybrid_forward is Block.hybrid_forward:
            try:
                return nn.Module.__call__(self, *args, **kwargs)
            except MXNetError:
                raise
            except (AttributeError, TypeError, RuntimeError,
                    ValueError) as e:
                raise MXNetError(
                    f"{type(self).__name__} '{self.name}' has no symbolic "
                    f"form: its forward is torch code, which a Symbol "
                    f"cannot go through (a hybrid_forward of F-ops gives "
                    f"it one); {type(e).__name__}: {e}") from e
        prefix = names.prefix.get(id(self), self._prefix)
        if self._reg_params:
            own = {k: (self._reg_keys[k], v._tensor, v)
                   for k, v in self._reg_params.items()}
        else:
            own = {k: (k, t, getattr(t, "_mx_param", None))
                   for k, t in self._parameters.items() if t is not None}
        params = {k: names.var(t, prefix + key, view)
                  for k, (key, t, view) in own.items()}
        # the JAX block enters its name scope, a fresh Prefix; an empty
        # prefix keeps the enclosing one
        with Prefix(prefix) if self._prefix else contextlib.nullcontext():
            return self.hybrid_forward(symbol, *args, **kwargs, **params)

    def _call_routed(self, args, kwargs):
        """A hybridized call goes through the CachedOp unless an
        ancestor's is running it; a remat block inside one runs under
        checkpointing unless an outer block already claimed it."""
        if self._active and not _in_cached_call():
            return self._call_cached_op(args, kwargs)
        if self._remat and _in_cached_call() and torch.is_grad_enabled() \
                and not getattr(_GUARD, "remat", False):
            return self._remat_call(args, kwargs)
        return nn.Module.__call__(self, *args, **kwargs)

    def _remat_call(self, args, kwargs):
        prev = getattr(_GUARD, "remat", False)
        _GUARD.remat = True
        try:
            return _checkpoint(
                lambda: nn.Module.__call__(self, *args, **kwargs),
                checkpoint_policy(self._remat_policy), self)
        finally:
            _GUARD.remat = prev

    def register_child(self, block, name=None):
        """Register ``block`` as a child under ``name`` (by default its
        position among the children, as the reference names it)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)
        return block

    @property
    def prefix(self):
        return self._prefix

    @property
    def params(self):
        """This block's own :class:`~.parameter.ParameterDict` (its
        prefix, its parameters by their local names): ``get`` and
        ``get_constant`` make parameters on it, as in the reference.
        ``collect_params`` gathers the whole tree."""
        pd = self.__dict__.get("_params_dict")
        if pd is None:
            pd = ParameterDict(self._prefix, owner=self)
            for name, p in self.named_parameters(recurse=False):
                pd._params[name] = Parameter.of(name, p)
            self.__dict__["_params_dict"] = pd
        return pd

    def forward(self, x, *args, **kwargs):
        """``hybrid_forward(F, x, *args, **params)`` with ``F`` the
        ``mx.nd`` namespace and ``params`` the tensors of the
        parameters assigned as attributes (``self.weight =
        self.params.get(...)``), by attribute name, as the reference's
        ``HybridBlock.forward``. A block that defines ``forward``
        itself (every layer of the port) never comes here. Deferred
        shapes are given by the block's ``infer_shape(x, *args)`` on
        the first call."""
        if type(self).hybrid_forward is Block.hybrid_forward:
            raise NotImplementedError(
                f'Module [{type(self).__name__}] is missing the required '
                f'"forward" function (or "hybrid_forward")')
        if self._deferred:
            self._infer_param_shapes(x, *args)
        # read through _parameters, where a CachedOp's capture swaps in
        # its aliases
        params = {k: self._parameters.get(self._reg_keys[k], v._tensor)
                  for k, v in self._reg_params.items()}
        return self.hybrid_forward(_F, x, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """The reference's ``hybrid_forward``; subclasses define it
        (see :meth:`forward`)."""
        raise NotImplementedError

    def infer_shape(self, *args):
        """Give the deferred parameters their shapes from the first
        inputs (set ``param.shape``); blocks whose ``hybrid_forward``
        reads deferred parameters define it, as in the reference."""
        raise MXNetError(f"{type(self).__name__} has deferred-initialized "
                         f"parameters but does not implement infer_shape")

    def _infer_param_shapes(self, *args):
        deferred = [(k, v) for k, v in self._reg_params.items()
                    if is_deferred(v._tensor)]
        if deferred:
            self.infer_shape(*args)
            for k, v in deferred:
                t = v._tensor
                if not hasattr(t, "_mx_pending"):
                    raise MXNetError(
                        f"Parameter '{self._prefix}{k}' has not been "
                        f"initialized: call initialize() before the "
                        f"first forward")
                if 0 in tuple(v.shape):
                    raise DeferredInitializationError(
                        f"Parameter '{self._prefix}{k}': infer_shape "
                        f"left its shape {v.shape} unknown")
                materialize(t, v.shape, self._prefix + k)
        self._deferred = False

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    def name_scope(self):
        """Scope: blocks made inside it are this block's children by
        name (``with self.name_scope(): self.dense = nn.Dense(...)``)."""
        return self._scope

    def _param(self, shape, dtype, device, fill=0.0, grad_req="write",
               init=None):
        p = new_parameter(shape, dtype, device, fill, grad_req, init)
        self._deferred = self._deferred or is_deferred(p)
        return p

    def _finish_deferred(self, **shapes):
        """Give this block's deferred parameters their shapes
        (``name=shape``), as the first forward learns them."""
        for name, shape in shapes.items():
            p = getattr(self, name)
            if p is not None and is_deferred(p):
                if not hasattr(p, "_mx_pending"):
                    raise MXNetError(
                        f"Parameter '{self._prefix}{name}' has not been "
                        f"initialized: call initialize() before the "
                        f"first forward")
                materialize(p, shape, self._prefix + name)
        self._deferred = False

    def hybridize(self, active=True, **kwargs):
        """Pass ``hybridize`` and its arguments on to the children (a
        plain ``Block`` itself stays eager, as the reference's); the
        arguments are recorded on each block as ``_hybridize``."""
        self._hybridize = (bool(active), dict(kwargs))
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)
        return self

    @torch.no_grad()
    def cast(self, dtype):
        """Cast every parameter to ``dtype`` in place (the tensors stay
        the same ``nn.Parameter`` objects; old gradients are dropped).
        A layer may keep some of its own in another type: ``BatchNorm``
        keeps float32 for float16 and bfloat16."""
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self._cached_graph = {}
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dt)
            else:
                child.to(dt)
        for p in self.parameters(recurse=False):
            if is_deferred(p):
                p._mx_dtype = dt
                continue
            p.data = p.data.to(dt)
            p.grad = None
        return self

    def gluon_params(self):
        """``{gluon name (model prefix stripped): parameter}`` in
        registration order. Raises ``ValueError`` when two parameters
        come to one name (children that need prefixes were given
        none)."""
        out = {}

        def walk(mod, prefix, scope):
            for name, p in mod.named_parameters(recurse=False):
                if prefix + name in out:
                    raise ValueError(f"two parameters named "
                                     f"{prefix + name!r}: give the "
                                     f"children their Gluon prefixes")
                out[prefix + name] = p
            for child, full, inner in _children_names(mod, scope):
                walk(child, full, inner)

        walk(self, "", "")
        return out

    def collect_params(self, select=None):
        """:class:`~.parameter.ParameterDict` of the block's parameters
        by Gluon name (model prefix stripped); ``select`` is a regex
        the names must match (``re.match``), as the reference's."""
        pattern = re.compile(select) if select else None
        pd = ParameterDict(self._prefix)
        pd.update({name: Parameter.of(name, p)
                   for name, p in self.gluon_params().items()
                   if pattern is None or pattern.match(name)})
        return pd

    def zero_grad(self):
        """Zero every parameter's gradient (MXNet's, not
        ``nn.Module.zero_grad``'s drop to None)."""
        self.collect_params().zero_grad()

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, seed=0, sigma=0.02):
        """Initial weights by the rules of the module docstring's
        "Seeds", on ``ctx`` (a device or a context; ``None`` keeps each
        parameter where it was made). ``verbose`` logs each parameter's
        initializer. Parameters initialized before are left as they are
        unless ``force_reinit``. A ``ctx`` list of more than one device
        raises ``ValueError``: one card holds one replica."""
        init_params(self.gluon_params().items(), init, ctx, verbose,
                    force_reinit, seed, sigma)
        return self

    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters to ``filename`` (a ``.params`` file)
        under their structural names; ``deduplicate`` writes a shared
        parameter once, under its first name."""
        arrays = {}
        for name, p in self.named_parameters(
                remove_duplicate=bool(deduplicate)):
            if is_deferred(p):
                raise MXNetError(f"Parameter '{name}' has not been "
                                 f"initialized yet (its shape is "
                                 f"deferred): run a forward first")
            arrays[name] = p.detach()
        serialization.save(filename, arrays)

    save_params = save_parameters

    @torch.no_grad()
    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Read a ``.params`` file (module docstring). A deferred
        parameter takes its shape from the file (and its device from
        ``ctx``). ``cast_dtype`` with ``dtype_source="current"`` casts
        the file's arrays to the parameters' types; with ``"saved"``
        the parameters take the file's types. Without ``cast_dtype``
        values are copied into the parameters' types."""
        if dtype_source not in ("current", "saved"):
            raise ValueError(f"dtype_source {dtype_source!r}: 'current' "
                             f"or 'saved'")
        dev = None if ctx is None else resolve_device(ctx)
        loaded = serialization.load(filename, ctx="cpu")
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} has no parameter names")
        params = dict(self.named_parameters(remove_duplicate=False))
        if not loaded and not params:
            return
        if not any("." in k for k in loaded):
            # legacy files: Gluon names (a model prefix stripped)
            params = self.gluon_params()
            pre = self._prefix
            loaded = {k[len(pre):] if pre and k.startswith(pre) else k: v
                      for k, v in loaded.items()}
            if params and not set(loaded) & set(params):
                raise MXNetError(
                    f"no parameter of '{filename}' matches this Block: "
                    f"the file's first name is {next(iter(loaded))!r}, "
                    f"the Block's {next(iter(params))!r}")
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
        for name, arr in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter '{name}' loaded from file "
                        f"'{filename}' is not present in this Block")
                continue
            p = params[name]
            if is_deferred(p):
                if dev is not None:
                    p._mx_device = dev
                if cast_dtype and dtype_source == "saved":
                    p._mx_dtype = arr.dtype
                materialize(p, arr.shape, name)
            elif tuple(p.shape) != tuple(arr.shape):
                raise ValueError(f"Parameter '{name}': shape "
                                 f"{tuple(arr.shape)} in the file, "
                                 f"{tuple(p.shape)} in this Block")
            if cast_dtype and dtype_source == "saved" and \
                    p.dtype != arr.dtype:
                p.data = p.data.to(arr.dtype)
                p.grad = None
            p.copy_(arr.as_subclass(torch.Tensor))
            p._mx_initialized = True

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    @torch.no_grad()
    def load_gluon_params(self, params):
        """Copy ``{name: array}`` (Gluon names, model prefix stripped)
        into the parameters. Raises ``KeyError`` on a missing or an
        extra name and ``ValueError`` on a shape that differs."""
        mine = self.gluon_params()
        missing = sorted(set(mine) - set(params))
        extra = sorted(set(params) - set(mine))
        if missing or extra:
            raise KeyError(f"parameter names differ: missing {missing}, "
                           f"extra {extra}")
        for name, p in mine.items():
            arr = np.asarray(params[name])
            if is_deferred(p):
                materialize(p, arr.shape, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"parameter {name}: shape "
                                 f"{tuple(arr.shape)}, the port's is "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
            p._mx_initialized = True
        return self


class HybridBlock(Block):
    """A block that :meth:`hybridize` turns into CUDA graphs (module
    docstring, "Hybridize")."""

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  remat=None, remat_policy=None, **kwargs):
        """Turn the CachedOp on (``active``) or off, here and in every
        child, and empty this block's cache. ``static_alloc`` and
        ``static_shape`` are recorded: a CUDA graph always holds its
        memory and shapes.

        What an entry of the cache holds on the card: its static inputs
        and outputs; under ``autograd.record()`` also every activation
        its forward saves for the backward and the gradients' static
        buffers, for as long as the entry lives (BERT-base MLM at batch
        64 x 128 tokens: several GiB an entry). So the cache keeps at
        most four recorded entries (keys called under ``record()`` with
        parameters or inputs that take gradients): a fifth shape drops
        the least recently used one and its graphs, whose memory goes
        back to the block's graph pool for the next capture, and that
        shape captures again when it comes back. Predict-mode
        entries are not bounded, as the JAX package's jit cache is not.

        ``remat=True`` recomputes the block's activations in the
        backward instead of keeping them (``torch.utils.checkpoint``,
        non-reentrant), when its own CachedOp or an ancestor's runs it:
        hybridize the root with it for the whole net, or mark children
        with ``child.hybridize(active=False, remat=True)``. ``remat``
        and ``remat_policy`` left ``None`` keep the block's setting, so
        a later ``net.hybridize()`` keeps the children's marks;
        ``remat=False`` clears it. ``remat_policy`` says what the
        forward keeps: a JAX checkpoint policy name with a torch meaning
        (``nothing_saveable``, ``everything_saveable``,
        ``dots_saveable``/``checkpoint_dots``: matrix products and
        convolutions, ``dots_with_no_batch_dims_saveable``/
        ``checkpoint_dots_with_no_batch_dims``: unbatched products) or
        ``"names:conv_out"`` (the convolutions' outputs); any other name
        raises ``ValueError``."""
        kw = dict(kwargs)
        if static_alloc:
            kw["static_alloc"] = static_alloc
        if static_shape:
            kw["static_shape"] = static_shape
        if remat_policy is not None:
            checkpoint_policy(remat_policy)   # an unknown name raises now
            self._remat_policy = remat_policy
        if remat is not None:
            self._remat = bool(remat)
        self._active = bool(active)
        self._routed = self._active or self._remat
        self._cached_graph = {}
        # the children keep their own remat marks
        return Block.hybridize(self, active, **kw)

    def _call_cached_op(self, args, kwargs):
        leaves = []
        spec = _spec((args, kwargs), leaves)
        # the AMP generation: a graph captured before amp.init() (or
        # after it) is not replayed once the casts changed
        key = (spec, autograd.is_training(), torch.is_grad_enabled(),
               torch.is_inference_mode_enabled(), dispatch_cast_generation())
        params = list(self.parameters())
        cache = self._cached_graph
        entry = cache.get(key)
        if entry is not None and entry.psig == _psig(params):
            if entry.grad:
                cache[key] = cache.pop(key)     # the most recently used
            return entry(leaves)
        if any(is_deferred(p) for p in params):
            # deferred shapes: one eager pass in predict mode, recording
            # nothing, gives them (the JAX CachedOp's dry run)
            with autograd.pause(), _trace_guard():
                nn.Module.__call__(self, *args, **kwargs)
            params = list(self.parameters())
        # a new key, or parameters moved or retyped in place (a graph
        # holds their addresses)
        entry = _Entry(self, key, spec, leaves, params, _psig(params),
                       _describe(self, key))
        cache.pop(key, None)
        cache[key] = entry
        if entry.grad:
            recorded = [k for k, e in cache.items() if e.grad]
            for k in recorded[:-_RECORDED_KEYS]:
                del cache[k]        # its graphs and activations go
        return entry(leaves)

    def _body(self, spec, tensors):
        """The block's eager forward on ``tensors`` (laid out as
        ``spec``), inside the trace guard; under the block's own remat
        when it has one."""
        args, kwargs = _build(spec, iter(tensors))
        with _trace_guard():
            if self._remat and torch.is_grad_enabled():
                return self._remat_call(args, kwargs)
            return nn.Module.__call__(self, *args, **kwargs)

    def _pool(self):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _swapped(self, aliases):
        return _swap_params(self, aliases)

    def _graph_state(self, params):
        return [p for p in params if not p.requires_grad] + \
            list(self.buffers())

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (the graph of ``self(data)`` traced
        with ``mx.sym.var("data")``) and ``path-%04d.params`` (every
        parameter under ``arg:`` and its full Gluon name, the model
        prefix included, as the JAX package's export names it). Returns
        both file names. Blocks whose ``hybrid_forward`` is written in
        F-ops and the built-in layers export (each its ``hybrid_forward``,
        under its full prefix); a layer whose ``forward`` is torch code
        raises ``MXNetError`` naming it."""
        with autograd.pause():
            out = self(symbol.var("data"))
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        out.save(f"{path}-symbol.json")
        serialization.save(f"{path}-{epoch:04d}.params",
                           {f"arg:{self._prefix}{n}": t.detach()
                            for n, t in self.gluon_params().items()})
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


def _psig(params):
    return tuple((p.data_ptr(), p.requires_grad) for p in params)


def _describe(block, spec):
    shapes = []

    def walk(sp):
        if sp[0] is torch.Tensor:
            shapes.append(f"{tuple(sp[1])} {str(sp[2]).replace('torch.', '')}")
        elif sp[0] in (list, tuple):
            for x in sp[1]:
                walk(x)
        elif sp[0] is dict:
            for _, x in sp[1]:
                walk(x)

    walk(spec[0])
    return (f"block '{block.name or type(block).__name__}' at key "
            f"(inputs {', '.join(shapes) or 'none'}; training "
            f"{spec[1]}, recording {spec[2]})")


class _swap_params:
    """Within it, each parameter of ``block``'s tree that ``aliases``
    holds (by ``id``) reads as its alias. A recorded capture runs the
    block on aliases (``p.detach()`` leaves sharing ``p``'s memory): the
    captured backward differentiates to them, so the parameters' own
    ``AccumulateGrad`` nodes (made on the default stream, held by their
    ``grad_req`` hooks) never enter a capture, whose stream they would
    join; the eager autograd outside the graph then accumulates into
    the parameters."""

    def __init__(self, block, aliases):
        self._block, self._aliases, self._undo = block, aliases, []
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_GUARD, "swap", None)
        _GUARD.swap = (self._block, self._aliases)
        for mod in self._block.modules():
            for name, t in mod._parameters.items():
                if t is not None and id(t) in self._aliases:
                    self._undo.append((mod, name, t))
        for mod, name, t in self._undo:
            mod._parameters[name] = self._aliases[id(t)]
        return self

    def __exit__(self, *exc):
        for mod, name, t in self._undo:
            mod._parameters[name] = t
        self._undo = []
        _GUARD.swap = self._prev
        return False


class _Token:
    """Lives as long as a recorded call's autograd node."""


class _Instance:
    """One captured forward (and, recording, its backward) of an entry:
    ``fwd``/``bwd`` are ``graphs.Graph``s, ``out`` the forward's static
    outputs flattened."""

    __slots__ = ("fwd", "out", "diff", "bwd", "pending", "gen")

    def __init__(self):
        self.bwd = None
        self.pending = None
        self.gen = 0

    def busy(self):
        return self.pending is not None and self.pending() is not None


class _Entry:
    """One key of a CachedOp: on CUDA its captured graphs, on the CPU
    its static inputs and the eager body (module docstring).

    ``owner`` runs the body: a :class:`HybridBlock`, or a bound symbolic
    graph (``executor``). It gives ``_body(spec, tensors)`` (the eager
    forward on ``tensors``, laid out as ``spec``), ``_pool()`` (the
    graph memory pool), ``_swapped(aliases)`` (a scope in which the body
    reads each parameter ``p`` as ``aliases[id(p)]``) and
    ``_graph_state(params)`` (the tensors the body updates in place,
    which the warm-up puts back). ``leaves`` are copied into static
    inputs at each call; ``params`` are read where they are. ``what``
    names the entry in errors; ``device`` places an entry with neither
    leaves nor parameters."""

    def __init__(self, owner, key, spec, leaves, params, psig, what,
                 device=None):
        self.owner = owner
        self.spec = spec
        self.psig = psig
        self.grad = key[2] and (any(t.requires_grad for t in leaves)
                                or any(p.requires_grad for p in params))
        self.in_req = [t.requires_grad for t in leaves]
        self.params = [p for p in params if p.requires_grad] \
            if self.grad else []
        # tensors the forward updates in place (running statistics):
        # the warm-up puts them back
        self.state = owner._graph_state(params)
        dev = leaves[0].device if leaves else \
            (params[0].device if params else torch.device(device or "cpu"))
        self.device = dev
        self.cuda = dev.type == "cuda"
        self.what = what
        self.out_spec = None
        self.instances = []
        self.capture_ms = 0.0
        # set when the forward reads the device back to the host
        # (``graphs.NotCapturable``): the key then runs eagerly
        self.eager = False
        # calls from several threads take turns: they share the static
        # buffers
        self.lock = threading.Lock()
        if not self.cuda:
            with torch.no_grad():
                self.static_in = [torch.empty_like(t).copy_(t)
                                  for t in leaves]
            graphs.count_capture()      # the CPU entry stands for one

    # -- CUDA -------------------------------------------------------------
    def _capture(self, leaves):
        inst = _Instance()
        with torch.no_grad():
            static = [torch.empty_like(t).copy_(t) for t in leaves]
        for s, r in zip(static, self.in_req):
            if r and self.grad:
                s.requires_grad_(True)
        owner, dev, pool = self.owner, self.device, self.owner._pool()
        aliases = {id(p): p.detach().requires_grad_(True)
                   for p in self.params}

        def forward(*static):
            with torch.set_grad_enabled(self.grad), \
                    owner._swapped(aliases):
                return owner._body(self.spec, static)

        surface = [s for s in static if s.requires_grad] + \
            [aliases[id(p)] for p in self.params]

        def differentiable(out):
            flat = []
            _spec(out, flat)
            return [o for o in flat if o.requires_grad]

        def warm():
            req = differentiable(forward(*static))
            if self.grad and req:
                with autograd.hooks_off():
                    torch.autograd.grad(req, surface,
                                        [torch.ones_like(o) for o in req],
                                        allow_unused=True)

        inst.fwd = graphs.capture(forward, static, dev, pool, self.what,
                                  warm=warm, state=self.state)
        flat = []
        out_spec = _spec(inst.fwd.out, flat)
        inst.out = flat
        inst.diff = [o.requires_grad for o in flat]
        req = [o for o in flat if o.requires_grad]
        if self.grad and req:
            def backward(*grad_out):
                # retain_graph: the saved activations stay allocated
                # (the forward's replays write them), so no later
                # capture in the pool takes their memory
                with autograd.hooks_off():
                    return torch.autograd.grad(req, surface, grad_out,
                                               retain_graph=True,
                                               allow_unused=True)

            inst.bwd = graphs.capture(
                backward, [torch.empty_like(o) for o in req], dev, pool,
                self.what + " (backward)", warm=False)
        self.out_spec = out_spec
        self.capture_ms += inst.fwd.capture_ms + (
            inst.bwd.capture_ms if inst.bwd is not None else 0.0)
        self.instances.append(inst)
        return inst

    def _free_instance(self, leaves):
        for inst in self.instances:
            if not inst.busy():
                return inst
        return self._capture(leaves)

    def _replay(self, inst, leaves):
        inst.fwd(leaves)
        with torch.no_grad():
            return [o.clone() for o in inst.out]

    # -- a call -----------------------------------------------------------
    def __call__(self, leaves):
        with self.lock:
            if self.eager:
                return self.owner._body(self.spec, leaves)
            try:
                if self.grad:
                    outs = _GraphFn.apply(self, len(leaves), *leaves,
                                          *self.params)
                elif self.cuda:
                    outs = self._replay(self._free_instance(leaves), leaves)
                else:
                    with torch.no_grad():
                        for s, t in zip(self.static_in, leaves):
                            s.copy_(t)
                    out = self.owner._body(self.spec, self.static_in)
                    flat = []
                    self.out_spec = _spec(out, flat)
                    with torch.no_grad():
                        outs = [o.clone() for o in flat]
            except graphs.NotCapturable:
                # the forward reads the device back (NMS): it runs
                # eagerly from now on (``graphs``' host reads)
                self.eager = True
                self.instances = []
                return self.owner._body(self.spec, leaves)
            return _build(self.out_spec, iter(outs))

    def forward_recorded(self, ctx, leaves):
        if self.cuda:
            inst = self._free_instance(leaves)
            outs = self._replay(inst, leaves)
            inst.gen += 1
            ctx.inst, ctx.gen = inst, inst.gen
            ctx.token = _Token()
            inst.pending = weakref.ref(ctx.token)
            return outs, inst.diff
        # the CPU: the eager body on fresh copies of the inputs and on
        # parameter aliases, as a capture runs it; its autograd graph
        # is kept for this call's backward
        statics = [t.detach().clone().requires_grad_(r)
                   for t, r in zip(leaves, self.in_req)]
        aliases = {id(p): p.detach().requires_grad_(True)
                   for p in self.params}
        with torch.enable_grad(), self.owner._swapped(aliases):
            out = self.owner._body(self.spec, statics)
        flat = []
        self.out_spec = _spec(out, flat)
        ctx.inner = (flat, [s for s in statics if s.requires_grad]
                     + [aliases[id(p)] for p in self.params])
        with torch.no_grad():
            return [o.clone() for o in flat], [o.requires_grad
                                               for o in flat]

    def backward_recorded(self, ctx, grads):
        if self.cuda:
            inst = ctx.inst
            if ctx.gen != inst.gen:
                raise MXNetError(f"{self.what}: its graph ran again since "
                                 f"this call's forward, whose activations "
                                 f"are gone (a second backward through a "
                                 f"retained graph)")
            if inst.bwd is None:
                return [None] * (len(self.in_req) + len(self.params))
            grad_in = inst.bwd([g for g, d in zip(grads, inst.diff) if d])
            inst.pending = None
            with torch.no_grad():
                got = [None if g is None else g.clone() for g in grad_in]
        else:
            flat, surface = ctx.inner
            pairs = [(o, g) for o, g in zip(flat, grads) if o.requires_grad]
            if not pairs or not surface:
                got = [None] * len(surface)
            else:
                with autograd.hooks_off():
                    got = list(torch.autograd.grad(
                        [o for o, _ in pairs], surface,
                        [g for _, g in pairs], allow_unused=True))
        it = iter(got)
        return [next(it) if r else None for r in self.in_req] + \
            [next(it) for _ in self.params]


class _GraphFn(torch.autograd.Function):
    """A recorded call of a hybridized block: the forward graph's
    replay, and the backward graph's (on the CPU the eager body and
    ``torch.autograd.grad``)."""

    @staticmethod
    def forward(ctx, entry, n_in, *tensors):
        ctx.entry = entry
        outs, diff = entry.forward_recorded(ctx, tensors[:n_in])
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, diff)
                                      if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.entry.backward_recorded(ctx, grads))


def functionalize(block, training=False, ctx=None):
    """A block as a function of its parameters: ``(fn, params)``, where
    ``fn(param_arrays, rng_key, *inputs)`` runs the block with the
    tensors of ``param_arrays`` (``{name: tensor}``, the names of
    ``params``: :meth:`Block.gluon_params`'s) in place of its own,
    through ``torch.func.functional_call``, and ``params`` holds the
    block's current tensors. ``training`` is the mode ``fn`` runs in;
    ``fn`` is differentiable when torch's gradient mode is on (or
    under ``torch.func.grad``). ``rng_key``: ``None`` draws dropout from
    the device's generator as it stands; an int draws from a generator
    forked and seeded with it, leaving the device's as it was (the JAX
    function takes a key there). ``None`` inputs pass through. Running
    statistics are not updated (the JAX function drops them), and
    hybridized children run eagerly inside ``fn``. ``ctx``: a device
    to move the parameters to first."""
    if ctx is not None:
        dev = resolve_device(ctx)
        for p in block.parameters():
            if p.device != dev:
                p.data = p.data.to(dev)
                p.grad = None
    names = {id(p): n for n, p in
             block.named_parameters(remove_duplicate=False)}
    gluon = block.gluon_params()
    structural = {g: names[id(p)] for g, p in gluon.items()}

    def fn(param_arrays, rng_key, *inputs):
        tensors = {structural[g]: t for g, t in param_arrays.items()}
        prev_train = autograd.set_training(training)
        prev_rec = autograd.set_recording(torch.is_grad_enabled())
        devices = sorted({t.device.index for t in tensors.values()
                          if t.device.type == "cuda"})
        try:
            with _trace_guard(), _no_aux(), torch.random.fork_rng(
                    devices=devices, enabled=rng_key is not None):
                if rng_key is not None:
                    torch.manual_seed(int(rng_key))
                return torch.func.functional_call(
                    block, tensors, tuple(inputs), strict=False)
        finally:
            autograd.set_recording(prev_rec)
            autograd.set_training(prev_train)

    return fn, {g: p.detach() for g, p in gluon.items()}


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block (the reference's ``SymbolBlock``):
    ``outputs`` a Symbol (or a list of them), ``inputs`` the variables
    the call gives, every other argument of the graph a parameter of
    that name (deferred until ``params``, a ``{name: array}`` with or
    without ``arg:``/``aux:`` prefixes, gives it its shape and value).
    A call evaluates the graph eagerly (``Symbol._eval``); hybridized,
    through the CachedOp like any block."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = symbol.Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        self._arg_names = [n for n in outputs.list_arguments()
                           if n not in self._input_names]
        given = {}
        for name, arr in (params or {}).items():
            for pfx in ("arg:", "aux:"):
                if name.startswith(pfx):
                    name = name[len(pfx):]
            given[name] = arr
        for name in self._arg_names + [n for n in given
                                       if n not in self._arg_names]:
            if not name.isidentifier():
                raise MXNetError(f"SymbolBlock: argument name {name!r} "
                                 f"cannot name a parameter")
            arr = given.get(name)
            if arr is None:
                self.params.get(name, allow_deferred_init=True)
                continue
            p = self.params.get(name, shape=tuple(arr.shape),
                                dtype=dtype_name(arr.dtype))
            p.set_data(arr)
            p._tensor._mx_initialized = True

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of an exported ``-symbol.json`` and its
        ``.params`` file, its parameters on ``ctx`` (default: the
        current context)."""
        if isinstance(input_names, str):
            input_names = [input_names]
        with contextlib.ExitStack() as stack:
            if ctx is not None:
                stack.enter_context(ctx)
            graph = symbol.load(symbol_file)
            inputs = [symbol.var(n) for n in input_names]
            params = serialization.load(param_file, ctx="cpu") \
                if param_file else None
            return SymbolBlock(graph, inputs, params)

    def forward(self, x, *args):
        bindings = dict(zip(self._input_names, (x,) + args))
        for name in self._arg_names:
            # read through _parameters, where a CachedOp's capture swaps
            # in its aliases
            t = self._parameters[name]
            if is_deferred(t):
                raise DeferredInitializationError(
                    f"Parameter '{name}' of the SymbolBlock has no value: "
                    f"give it in params, or pass it as an input")
            bindings[name] = t
        outs = self._symbol._eval(bindings)
        return outs[0] if len(outs) == 1 else outs
