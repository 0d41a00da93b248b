"""Gluon ``Parameter`` and ``ParameterDict`` as thin views over
``torch.nn.Parameter``.

Port of ``mxnet_tpu/gluon/parameter.py`` for one device (no
per-context replicas). A layer of the port owns its weights as
``nn.Parameter`` attributes; :meth:`~.block.Block.collect_params` wraps
each in a :class:`Parameter` carrying the Gluon name and the training
attributes MXNet keeps on it: ``grad_req`` (``"write"`` overwrites the
gradient on each backward, ``"add"`` accumulates, ``"null"`` takes
none; see ``autograd``), ``lr_mult`` and ``wd_mult``. The view is made
once per tensor and kept on it, so settings made through one
``collect_params()`` hold in the next.

**Deferred shapes.** A weight made with a 0 in its shape (``Dense``
without ``in_units``, ...) is a ``torch.nn.parameter.
UninitializedParameter``. ``Block.initialize`` records its
initializer; the first forward (or a parameter file) gives it its
shape, and :func:`materialize` turns it into a parameter of that shape
IN PLACE: the same object, so a ``Trainer`` made before that step holds
it. Reading it before then raises :class:`DeferredInitializationError`.

:meth:`Parameter.data` and :meth:`Parameter.grad` give ``NDArray``
views that share storage with the weight and its gradient (a write to
``p.data()[:]`` is a write to the weight, outside autograd); the
``Trainer`` and the kernels work on the plain tensors.
:meth:`ParameterDict.save`/:meth:`ParameterDict.load` read and write the
reference's full names (the dict's prefix + the port's name).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter

from .. import autograd
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, as_nd, to_dtype

__all__ = ["Constant", "DeferredInitializationError", "Parameter",
           "ParameterDict", "is_deferred", "materialize", "new_constant",
           "new_parameter"]


class DeferredInitializationError(MXNetError):
    """A parameter whose shape is not known yet was read."""


def is_deferred(tensor):
    # a type test, not isinstance: Parameter's metaclass makes that a
    # Python call, and forwards and the Trainer ask on every step
    return type(tensor) is UninitializedParameter


def new_parameter(shape, dtype, device, fill=0.0, grad_req="write",
                  init=None):
    """An ``nn.Parameter`` of ``shape`` filled with ``fill``, or, when
    a dimension is 0 (unknown), an ``UninitializedParameter`` that
    records the shape it has so far."""
    shape = tuple(int(s) for s in shape)
    if 0 in shape:
        p = UninitializedParameter(requires_grad=False, device=device,
                                   dtype=dtype)
        p._mx_shape, p._mx_fill = shape, fill
    else:
        # an integer parameter (int8 weights) takes no gradient
        p = torch.nn.Parameter(torch.full(shape, fill, dtype=dtype,
                                          device=device),
                               requires_grad=dtype.is_floating_point)
    if init is not None:
        p._mx_init = init           # this parameter's own initializer
    return autograd.set_grad_req(p, grad_req)


def _compatible(known, shape):
    return len(known) == len(shape) and all(
        k in (0, s) for k, s in zip(known, shape))


def materialize(tensor, shape, name="parameter"):
    """Give a deferred parameter its ``shape`` in place (its device and
    type are those recorded by ``initialize``/``cast``), then draw its
    recorded initializer, if ``initialize`` recorded one. A parameter
    that already has a shape is checked against ``shape``."""
    shape = tuple(int(s) for s in shape)
    if not is_deferred(tensor):
        if tuple(tensor.shape) != shape:
            raise ValueError(f"Parameter '{name}': shape {shape}, it has "
                             f"{tuple(tensor.shape)}")
        return tensor
    if not _compatible(tensor._mx_shape, shape):
        raise ValueError(f"Parameter '{name}': shape {shape} is "
                         f"incompatible with {tensor._mx_shape}")
    with torch.no_grad():
        tensor.materialize(shape, device=getattr(tensor, "_mx_device", None),
                           dtype=getattr(tensor, "_mx_dtype", None))
        tensor.fill_(tensor._mx_fill)
        pending = tensor.__dict__.pop("_mx_pending", None)
        if pending is not None:
            pending(tensor)
    autograd.set_grad_req(tensor, tensor._mx_grad_req)
    return tensor


class Parameter:
    """Gluon view of one ``nn.Parameter`` (module docstring)."""

    def __init__(self, name, tensor, lr_mult=1.0, wd_mult=1.0):
        self.name = name
        self._tensor = tensor
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult

    @classmethod
    def of(cls, name, tensor):
        """The view of ``tensor``, made on first use."""
        view = getattr(tensor, "_mx_param", None)
        if view is None:
            view = cls(name, tensor)
            tensor._mx_param = view
        return view

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def grad_req(self):
        return getattr(self._tensor, "_mx_grad_req", "write")

    @grad_req.setter
    def grad_req(self, req):
        autograd.set_grad_req(self._tensor, req)

    @property
    def shape(self):
        """The shape; a deferred parameter's has 0 where it is not
        known yet."""
        if is_deferred(self._tensor):
            return self._tensor._mx_shape
        return tuple(self._tensor.shape)

    @shape.setter
    def shape(self, new_shape):
        """Fill in a deferred parameter's unknown (0) dimensions (a
        block's ``infer_shape``); a known shape may only be restated."""
        new_shape = tuple(int(s) for s in new_shape)
        if not _compatible(self.shape, new_shape) and \
                not _compatible(new_shape, self.shape):
            raise ValueError(f"Parameter '{self.name}': shape "
                             f"{new_shape} is incompatible with "
                             f"{self.shape}")
        if is_deferred(self._tensor):
            self._tensor._mx_shape = tuple(
                n if n else o for n, o in zip(new_shape, self.shape))

    @property
    def dtype(self):
        return getattr(self._tensor, "_mx_dtype", None) or self._tensor.dtype

    @property
    def stype(self):
        """The storage type asked for (``ParameterDict.get(stype=)``);
        the weight is stored dense whatever it says, as in the JAX
        package."""
        return getattr(self._tensor, "_mx_stype", "default")

    @property
    def grad_stype(self):
        """The gradient's storage type asked for (``"row_sparse"`` for
        ``Embedding(sparse_grad=True)``); the gradient is dense, as the
        JAX package's is."""
        return getattr(self._tensor, "_mx_grad_stype", "default")

    def _check_initialized(self):
        if is_deferred(self._tensor):
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                f"because initialization was deferred. Actual "
                f"initialization happens during the first forward pass.")

    def data(self, ctx=None):
        """An NDArray view of the weight (shares its storage)."""
        self._check_initialized()
        return as_nd(self._tensor.detach())

    def grad(self, ctx=None):
        """An NDArray view of the gradient; zeros before the first
        backward (MXNet allocates it with the weight). Raises for
        ``grad_req='null'``."""
        self._check_initialized()
        if self.grad_req == "null":
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"'{self.name}' because grad_req='null'")
        if self._tensor.grad is None:
            self._tensor.grad = torch.zeros_like(self._tensor)
        return as_nd(self._tensor.grad)

    def list_data(self):
        """The weight on each context: one card holds one."""
        return [self.data()]

    def list_grad(self):
        return [self.grad()]

    def row_sparse_data(self, row_id):
        """The weight as a RowSparseNDArray of its nonzero rows;
        ``row_id`` is taken and, as in the JAX package, not read."""
        from ..ndarray import sparse
        return sparse.cast_storage(self.data(), "row_sparse")

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def zero_grad(self):
        if not is_deferred(self._tensor) and self._tensor.grad is not None:
            self._tensor.grad.zero_()

    @torch.no_grad()
    def set_data(self, data):
        """Copy ``data`` (a tensor, an NDArray or an array) into the
        weight; a deferred weight takes its shape from ``data``."""
        src = data if isinstance(data, torch.Tensor) else \
            torch.tensor(np.asarray(data))
        if is_deferred(self._tensor):
            materialize(self._tensor, src.shape, self.name)
        elif tuple(src.shape) != self.shape:
            raise ValueError(f"Parameter '{self.name}': shape "
                             f"{tuple(src.shape)}, want {self.shape}")
        self._tensor.copy_(src.detach())

    @torch.no_grad()
    def cast(self, dtype):
        dt = to_dtype(dtype)
        if is_deferred(self._tensor):
            self._tensor._mx_dtype = dt
            return
        self._tensor.data = self._tensor.data.to(dt)
        self._tensor.grad = None


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient
    (``ParameterDict.get_constant``); ``initialize`` leaves it as it
    is."""

    def __init__(self, name, tensor, value):
        super().__init__(name, tensor)
        self.value = value


def new_constant(name, value, device=None):
    """The ``nn.Parameter`` of a :class:`Constant` holding ``value``
    (array-like; Python floats as float32), with its view."""
    src = value.detach().as_subclass(torch.Tensor) \
        if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    if src.dtype == torch.float64 and not isinstance(value, torch.Tensor):
        src = src.float()
    t = torch.nn.Parameter(src.to(resolve_device(device)).clone(),
                           requires_grad=False)
    autograd.set_grad_req(t, "null")
    t._mx_initialized = t._mx_constant = True
    t._mx_param = Constant(name, t, value)
    return t


class ParameterDict:
    """Ordered ``{name: Parameter}``. The port's names carry no model
    prefix (``embed_word_weight``, ``enc_layer0_attn_qkv_weight``); the
    dict's ``prefix`` is the model's. ``shared`` is another dict whose
    parameters :meth:`get` hands out by name (parameter sharing).

    A block's own dict (``Block.params``, ``owner`` the block) holds
    the parameters :meth:`get` and :meth:`get_constant` make for it by
    the names given (the reference's ``self.params.get("weight", ...)``)
    and registers each on the block under that name, so the block's
    ``named_parameters``, ``collect_params``, ``initialize`` and
    parameter files see it as they see a layer's own weights."""

    def __init__(self, prefix="", shared=None, owner=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared
        self._owner = owner

    def __repr__(self):
        body = "\n".join(f"  {v}" for v in self._params.values())
        return f"{type(self).__name__} '{self._prefix}' (\n{body}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        owner = self._owner
        if owner is not None and owner._shared is not None:
            pd, path = owner._shared        # Block(params=...) sharing
            if path + name in pd:
                self._params[name] = pd[path + name]
                self._adopt(name, self._params[name])
                return self._params[name]
        return None

    def _adopt(self, name, param):
        """Register ``param``'s tensor on the owner block as ``name``."""
        owner = self._owner
        if owner is not None and name.isidentifier() and \
                name not in owner._parameters and \
                not hasattr(owner, name):
            owner.register_parameter(name, param._tensor)
            owner._deferred = owner._deferred or is_deferred(param._tensor)

    def get(self, name, shape=None, dtype="float32", init=None,
            grad_req="write", ctx=None, **kwargs):
        """The parameter ``name`` (the shared dict's, if it has one),
        else a new one of ``shape`` (0 or ``None`` for a dimension not
        known yet) on ``ctx`` (default: the current context). Given a
        ``shape`` with more known dimensions than the existing
        parameter's, the parameter takes them (deferred ones).
        ``lr_mult``/``wd_mult`` set those attributes; ``stype`` and
        ``grad_stype`` are recorded (storage stays dense);
        ``allow_deferred_init`` is accepted (a 0 always defers here)."""
        param = self._get_impl(name)
        if param is None:
            shape = (0,) if shape is None else tuple(
                0 if s is None else s for s in shape)
            param = Parameter.of(name, new_parameter(
                shape, to_dtype(dtype), resolve_device(ctx),
                grad_req=grad_req, init=init))
            self._params[name] = param
            self._adopt(name, param)
        elif shape is not None and is_deferred(param._tensor):
            param.shape = tuple(0 if s is None else s for s in shape)
        for k in ("lr_mult", "wd_mult"):
            if k in kwargs:
                setattr(param, k, kwargs.pop(k))
        # every 0 dimension defers here
        kwargs.pop("allow_deferred_init", None)
        # storage types are recorded (Parameter.stype/grad_stype); the
        # weight and its gradient stay dense, as in the JAX package
        for k in ("stype", "grad_stype"):
            v = kwargs.pop(k, "default")
            if v != "default":
                setattr(param._tensor, "_mx_" + k, v)
        if kwargs:
            raise TypeError(f"ParameterDict.get: unexpected arguments "
                            f"{sorted(kwargs)}")
        return param

    def get_constant(self, name, value=None):
        """The constant ``name``, made from ``value`` (array-like) the
        first time: a parameter with ``grad_req="null"`` that
        ``initialize`` leaves alone."""
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"No constant named '{name}'")
            param = new_constant(name, value)._mx_param
            self._params[name] = param
            self._adopt(name, param)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"Cannot update self with other because "
                                 f"they have different Parameters with "
                                 f"the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=0, sigma=0.02):
        """``Block.initialize``'s rules over these parameters."""
        from .block import init_params
        init_params(self._params.items(), init, ctx, verbose, force_reinit,
                    seed, sigma)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        """Set one attribute (``grad_req``, ``lr_mult``, ...) on every
        parameter."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Write the parameters under their full names (prefix + name)
        less ``strip_prefix``."""
        from ..ndarray import serialization
        arg_dict = {}
        for name, param in self.items():
            full = self._prefix + name
            if not full.startswith(strip_prefix):
                raise MXNetError(f"Prefix '{strip_prefix}' is to be "
                                 f"striped before saving, but Parameter's "
                                 f"name '{full}' does not start with it")
            arg_dict[full[len(strip_prefix):]] = param.data()
        serialization.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a file of full names (``restore_prefix`` + the file's
        name); a name matches this dict's prefix + a parameter's name."""
        from ..ndarray import serialization
        arg_dict = serialization.load(filename, ctx="cpu")
        if not isinstance(arg_dict, dict):
            raise MXNetError(f"{filename} contains unnamed arrays")
        mine = {self._prefix + k: v for k, v in self.items()}
        arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in mine:
                if name not in arg_dict:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
        for name, arr in arg_dict.items():
            if name not in mine:
                if not ignore_extra:
                    raise MXNetError(f"Parameter '{name}' loaded from file "
                                     f"'{filename}' is not present in "
                                     f"ParameterDict")
                continue
            param = mine[name]
            if ctx is not None and is_deferred(param._tensor):
                param._tensor._mx_device = resolve_device(ctx)
            param.set_data(arr)
