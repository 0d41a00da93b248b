"""Base of the port's layers: an ``nn.Module`` that carries Gluon's
parameter naming, MXNet's recording rule and the reference's Block
API.

Port of ``mxnet_tpu/gluon/block.py`` for eager training and serving.

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
tensor in, tensor out. Nothing inside a model's forward dispatches
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

**User blocks.** ``HybridBlock`` is another name for :class:`Block`. A
subclass that defines ``hybrid_forward(self, F, x, ...)`` instead of
``forward`` runs as the reference's: ``F`` is ``mx.nd`` (the op
registry) and the parameters it assigned as attributes from
``self.params.get(...)``/``get_constant(...)`` come as keyword
arguments, plain tensors, by attribute name (:meth:`Block.forward`).
Inside it the F-ops see and give plain tensors. Layers that define
``forward`` (all of the port's) keep their own path. PyTorch runs
eagerly, and :meth:`Block.hybridize` records its arguments and
compiles nothing (a CUDA graph of the step is ROADMAP Queue 1,
'Hybridize').
:meth:`Block.cast` changes the parameters' type in place, as the JAX
block's does. A block records a graph only inside
``autograd.record()``: called anywhere else it runs with torch's
gradient mode off, as an MXNet block records nothing outside
``record()``. Train/predict mode is ``autograd.is_training()``, not
``nn.Module.training``.
"""
from __future__ import annotations

import logging
import re
import threading
import warnings

import numpy as np
import torch
from torch import nn

from .. import autograd, initializer
from .. import ndarray as _F
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, is_deferred, materialize,
                        new_parameter)

__all__ = ["Block", "HybridBlock"]

_LOG = logging.getLogger(__name__)

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


def _nd_in(x):
    return isinstance(x, NDArray) or (type(x) in (list, tuple) and any(
        isinstance(v, NDArray) for v in x))


def _unwrap(x):
    if isinstance(x, NDArray):
        return x.as_subclass(torch.Tensor)
    if type(x) in (list, tuple):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return x if isinstance(x, NDArray) else x.as_subclass(NDArray)
    if type(x) in (list, tuple):
        return type(x)(_wrap(v) for v in x)
    return x


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
            hint = type(self).__name__.lower()
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
            if all(t is not value._tensor for t in self._parameters.values()):
                self.register_parameter(name, value._tensor)
                self._deferred = self._deferred or is_deferred(value._tensor)
            self._reg_params[name] = value
            self.__dict__[name] = value
            return
        super().__setattr__(name, value)

    def __call__(self, *args, **kwargs):
        # a plain tensor argument costs one type test: nested calls and
        # callers that pass tensors pay nothing more
        for a in args:
            if type(a) is not torch.Tensor and _nd_in(a):
                return self._call_nd(args, kwargs)
        if kwargs and any(_nd_in(v) for v in kwargs.values()):
            return self._call_nd(args, kwargs)
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args, **kwargs)

    def _call_nd(self, args, kwargs):
        """NDArray in, NDArray out (module docstring)."""
        args = _unwrap(args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return _wrap(super().__call__(*args, **kwargs))

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
        params = {k: v._tensor for k, v in self._reg_params.items()}
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
        """Accepted for the API (``static_alloc``, ``static_shape``,
        ...) and recorded on the block and its children; nothing is
        compiled: the port runs eagerly (a CUDA graph of the step is
        ROADMAP Queue 1, 'Hybridize')."""
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._hybridize = (bool(active), dict(kwargs))
        return self

    @torch.no_grad()
    def cast(self, dtype):
        """Cast every parameter to ``dtype`` in place (the tensors stay
        the same ``nn.Parameter`` objects; old gradients are dropped).
        A layer may keep some of its own in another type: ``BatchNorm``
        keeps float32 for float16 and bfloat16."""
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
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

        def walk(mod, prefix):
            for name, p in mod.named_parameters(recurse=False):
                if prefix + name in out:
                    raise ValueError(f"two parameters named "
                                     f"{prefix + name!r}: give the "
                                     f"children their Gluon prefixes")
                out[prefix + name] = p
            for child in mod.children():
                walk(child, prefix + getattr(child, "_prefix", ""))

        walk(self, "")
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


HybridBlock = Block
