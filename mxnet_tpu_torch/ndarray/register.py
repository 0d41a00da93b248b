"""Operator registry and eager dispatch on torch tensors.

Port of ``mxnet_tpu/ndarray/register.py``: an :class:`Op` record per
registered name (its torch implementation and metadata),
:func:`register_op`, :func:`get_op`/:func:`list_ops`, :func:`invoke`
(MXNet's ``Imperative::Invoke``) and :func:`populate_namespace`, which
turns every registered op into a function ``mx.nd.<op>`` at import.

There is no tape: torch's autograd records each op as it runs, under
``autograd.record()`` as anywhere else. An op registered with
``differentiable=False`` runs under ``torch.no_grad()``. ``mutates``
pairs ``(output index, input index)`` write an output back into an
input in place, under ``no_grad`` (the optimizer updates' states);
an implementation that already updated the input in place returns the
input itself, and nothing is copied.

**Types in and out.** An op given an ``NDArray`` (as a tensor input or
a tensor keyword) returns ``NDArray``s; one given plain tensors returns
plain tensors, so the F-ops of a ``hybrid_forward`` (whose block
unwrapped its arguments) pay no ``__torch_function__`` dispatch. An op
with no tensor input (the samplers) returns an ``NDArray`` on ``ctx``.
numpy inputs become tensors on the op's device (float64 as float32, as
``nd.array``); Python scalars stay scalars.

``out=`` copies the visible outputs into the given arrays (under
``no_grad``) and returns them; ``ctx=`` places an op without tensor
inputs, and otherwise the first tensor input's device decides.
"""
from __future__ import annotations

import ast
import inspect
import sys
import types

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .ndarray import NDArray

__all__ = ["Op", "call_op_fn", "get_op", "invoke", "list_ops",
           "populate_namespace", "register_op"]

# name (and alias) -> Op; case-sensitive (FullyConnected vs broadcast_add)
_OPS: dict = {}


class Op:
    """A registered operator: ``fn(*tensors, **params)`` and its
    metadata (see ``mxnet_tpu/ndarray/register.py``'s ``Op``).
    ``num_visible_outputs`` is how many leading outputs the eager call
    returns (None: all); ``mutates`` the in-place write-backs. Two
    fields serve ``mx.sym``'s output count: ``dynamic_arity`` (the
    ``num_outputs`` param is the count: ``split``) and
    ``infer_num_outputs`` (``params -> count``: ``RNN``)."""

    __slots__ = ("name", "fn", "differentiable", "aliases",
                 "num_visible_outputs", "mutates", "dynamic_arity",
                 "infer_num_outputs")

    def __init__(self, name, fn, differentiable=True, aliases=(),
                 num_visible_outputs=None, mutates=(), dynamic_arity=False,
                 infer_num_outputs=None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.aliases = tuple(aliases)
        self.num_visible_outputs = num_visible_outputs
        self.mutates = tuple(mutates)
        self.dynamic_arity = bool(dynamic_arity)
        self.infer_num_outputs = infer_num_outputs

    def __repr__(self):
        return f"<Op {self.name}>"


def register_op(name=None, *, differentiable=True, aliases=(),
                num_visible_outputs=None, mutates=(), dynamic_arity=False,
                infer_num_outputs=None):
    """Decorator: register a torch function as an operator (and its
    aliases)."""

    def deco(fn):
        op_name = name or fn.__name__
        if not isinstance(fn, types.FunctionType):
            fn = _py_function(fn)       # a builtin takes no attributes
        op = Op(op_name, fn, differentiable=differentiable, aliases=aliases,
                num_visible_outputs=num_visible_outputs, mutates=mutates,
                dynamic_arity=dynamic_arity,
                infer_num_outputs=infer_num_outputs)
        for nm in (op_name,) + tuple(aliases):
            _OPS[nm] = op
            _POS_PARAM_NAMES.pop(nm, None)
        fn._op = op
        return fn

    return deco


def _py_function(fn):
    def impl(*args, **kwargs):
        return fn(*args, **kwargs)
    impl.__doc__ = fn.__doc__
    return impl


def get_op(name):
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def list_ops():
    """Every registered name, aliases included (MXListAllOpNames)."""
    return sorted(_OPS)


def _parse_param(v):
    """MXNet-style stringified params ("(3, 3)", "True") as values."""
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, NDArray) else x


def _as_tensor(x, device):
    """An op input as a plain tensor (or a Python scalar, kept)."""
    if isinstance(x, torch.Tensor):
        return _plain(x)
    if isinstance(x, (bool, int, float)) or x is None:
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (np.ndarray, list, tuple)):
        npv = np.asarray(x)
        t = torch.from_numpy(np.array(npv, order="C"))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(device)
    raise MXNetError(f"cannot convert {type(x)} to a tensor input")


def _device_of(inputs, params, ctx):
    if ctx is not None:
        return resolve_device(ctx)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    for v in params.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device(None)


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def invoke(op, inputs, params=None, out=None, ctx=None):
    """Eager dispatch of one op (module docstring)."""
    params = {k: _parse_param(v) for k, v in (params or {}).items()
              if v is not None}
    # trailing None tensor inputs (a bias with no_bias=True) are dropped
    # so the implementation's defaults apply
    inputs = list(inputs)
    while inputs and inputs[-1] is None:
        inputs.pop()
    nd_in = False
    for x in inputs:
        if isinstance(x, NDArray):
            nd_in = True
            break
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            nd_in = nd_in or isinstance(v, NDArray)
            params[k] = _plain(v)
    plain = all(type(x) in _PLAIN for x in inputs)
    if plain and inputs and ctx is None:
        arrays = inputs
    else:
        dev = _device_of(inputs, params, ctx)
        arrays = [_as_tensor(x, dev) for x in inputs]
        if not inputs:
            nd_in = True        # a sampler: an NDArray on ctx
            params.setdefault("device", dev)
    if op.differentiable:
        raw = call_op_fn(op, arrays, params)
    else:
        with torch.no_grad():
            raw = call_op_fn(op, arrays, params)
    multi = isinstance(raw, (tuple, list))
    outs = list(raw) if multi else [raw]
    if op.mutates:
        with torch.no_grad():
            for o_idx, i_idx in op.mutates:
                tgt = inputs[i_idx]
                if isinstance(tgt, torch.Tensor) and outs[o_idx] is not tgt \
                        and outs[o_idx] is not arrays[i_idx]:
                    tgt.copy_(outs[o_idx])
    n = len(outs) if op.num_visible_outputs is None \
        else op.num_visible_outputs
    outs = outs[:n]
    if out is not None:
        dst = list(out) if isinstance(out, (tuple, list)) else [out]
        if len(dst) != len(outs):
            raise MXNetError(f"{op.name}: expected {len(outs)} out= "
                             f"arrays, got {len(dst)}")
        with torch.no_grad():
            for d, o in zip(dst, outs):
                if d is not o:
                    d.copy_(o)
        results = dst
    elif nd_in:
        results = [o.as_subclass(NDArray) if isinstance(o, torch.Tensor)
                   and not isinstance(o, NDArray) else o for o in outs]
    else:
        results = outs
    if len(results) == 1:
        return results[0]
    return results


# op name -> leading positional parameter names of its implementation
_POS_PARAM_NAMES: dict = {}


def _positional_names(op):
    names = _POS_PARAM_NAMES.get(op.name)
    if names is None:
        try:
            names = []
            for p in inspect.signature(op.fn).parameters.values():
                if p.kind not in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD):
                    break
                names.append(p.name)
            names = tuple(names)
        except (TypeError, ValueError):
            names = ()
        _POS_PARAM_NAMES[op.name] = names
    return names


def call_op_fn(op, arrays, params):
    """``op.fn(*arrays, **params)``, rebinding by the signature when a
    param names one of the slots the tensors would take (a scalar
    given between tensors, ``op(x, 2.0, y)``, arrives as inputs
    ``[x, y]`` and params ``{<param1>: 2.0}``)."""
    if params:
        names = _positional_names(op)
        if names and any(n in params for n in names[:len(arrays)]):
            free = [n for n in names if n not in params]
            if len(arrays) <= len(free):
                return op.fn(**dict(zip(free, arrays)), **params)
    return op.fn(*arrays, **params)


def _make_ns_function(op, fname):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)        # symbol naming; nothing eagerly
        inputs = list(args)
        if not inputs and any(isinstance(v, torch.Tensor)
                              for v in kwargs.values()):
            # tensors given by name only (data=..., lhs=...): bind the
            # leading ones through the implementation's signature
            for pname in inspect.signature(op.fn).parameters:
                if isinstance(kwargs.get(pname), torch.Tensor):
                    inputs.append(kwargs.pop(pname))
                else:
                    break
        return invoke(op, inputs, kwargs, out=out, ctx=ctx)

    op_func.__name__ = fname
    op_func.__qualname__ = fname
    op_func.__doc__ = op.fn.__doc__
    op_func._op = op
    return op_func


def populate_namespace(module_name, names=None):
    """Generate ``mx.nd.<op>`` for every registered op into a module
    (``_init_op_module``); the module then replaces those it wraps
    itself. Returns the names made."""
    mod = sys.modules[module_name]
    made = []
    for nm, op in list(_OPS.items()):
        if names is not None and nm not in names:
            continue
        setattr(mod, nm, _make_ns_function(op, nm))
        made.append(nm)
    return sorted(made)
