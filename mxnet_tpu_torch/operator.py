"""Custom operator registration: ``mx.operator``.

Port of ``mxnet_tpu/operator.py`` (MXNet's ``python/mxnet/operator.py``
and ``src/operator/custom/custom.cc``). A user registers a Python
operator by name (``@mx.operator.register("softmax")`` on a
:class:`CustomOpProp` subclass) and calls it through the registry op
``Custom`` from ``mx.nd``, a Gluon block and ``mx.sym``/``Module``.

The user's ``forward`` and ``backward`` run on NDArrays over the op's
own tensors, in the calling thread (the backward in autograd's), and
launch torch ops on the inputs' device. The gradient contract is a
``torch.autograd.Function``: autograd calls the user's ``backward``
instead of differentiating ``forward``. The JAX package traces the
same callbacks into its XLA program; here they are eager Python, and
under a CUDA graph (a hybridized block, a bound ``Module``) they run
once, at capture, and replay as recorded. A callback that reads the
host (``asnumpy``, ``asscalar``) cannot be captured and raises
``MXNetError`` naming the op type.

As in the JAX package:

- ``declare_backward_dependency`` is accepted and unused: the backward
  gets every input and output;
- auxiliary states are refused (``list_auxiliary_states`` must be
  empty): model state belongs in Gluon Parameters;
- ``create_operator`` runs once for a forward and once for a backward,
  so a ``CustomOp`` keeps nothing on ``self`` between them;
- shapes and types of the outputs come from the prop's ``infer_shape``
  and ``infer_type``; ``mx.sym``'s shape inference asks them and never
  runs the user's ``forward``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .base import MXNetError
from .context import Context

__all__ = ["CustomOp", "CustomOpProp", "get_all_registered_operators",
           "register"]

# op_type -> CustomOpProp subclass
_PROP_REGISTRY: dict = {}


class CustomOp:
    """Base class of the user's operator (MXNet's
    ``mxnet.operator.CustomOp``). ``forward``/``backward`` receive lists
    of NDArrays and write their results into the given output lists
    with :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Honour the write request: ``"write"``/``"inplace"``
        overwrite, ``"add"`` accumulates, ``"null"`` does nothing."""
        if req == "null":
            return
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src), device=dst.device)
        with torch.no_grad():
            if req == "add":
                dst.add_(src.to(dst.dtype))
            else:
                dst.copy_(src)


class CustomOpProp:
    """The interface of a custom op (MXNet's
    ``mxnet.operator.CustomOpProp``). Subclass and override."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        """Default: the inputs as given, and every output of the first
        input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        """Default: everything takes the first input's type."""
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return (in_stype, ["default"] * len(self.list_outputs()),
                ["default"] * len(self.list_auxiliary_states()))

    def infer_storage_type_backward(self, ograd_stype, in_stype, out_stype,
                                    igrad_stype, aux_stype):
        return (ograd_stype, in_stype, out_stype,
                ["default"] * len(in_stype), aux_stype)

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Accepted for parity; the backward gets every array."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Class decorator: register a :class:`CustomOpProp` subclass under
    a name usable as ``op_type`` (``mx.operator.register``)."""

    def do_register(prop_cls):
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise MXNetError(
                f"mx.operator.register({reg_name!r}) expects a CustomOpProp "
                f"subclass, got {prop_cls}")
        _PROP_REGISTRY[reg_name] = prop_cls
        _build_custom_fn.cache_clear()
        return prop_cls

    return do_register


def get_all_registered_operators():
    """Names registered with :func:`register`."""
    return sorted(_PROP_REGISTRY)


def _make_prop(op_type, params):
    """The registered prop made with the op's non-tensor params, each
    as a string (MXNet passes every keyword to the prop's constructor
    as a string)."""
    try:
        prop_cls = _PROP_REGISTRY[op_type]
    except KeyError:
        raise MXNetError(
            f"custom op type {op_type!r} is not registered; known: "
            f"{get_all_registered_operators()}") from None
    kwargs = {k: (v if isinstance(v, str) else str(v))
              for k, v in params.items()}
    return prop_cls(**kwargs)


def _check_no_aux(prop, op_type):
    if prop.list_auxiliary_states():
        raise MXNetError(
            f"custom op {op_type!r}: auxiliary states are not supported "
            "(as in the JAX package); model state belongs in Gluon "
            "Parameters")


def _np_dtype(dtype):
    """A tensor type as the prop sees it: a numpy dtype, or the name
    ``"bfloat16"``, which numpy lacks (the default ``infer_type`` passes
    it on, and the output is made in bfloat16)."""
    from .ndarray.ndarray import dtype_name
    name = dtype_name(dtype)
    return name if name == "bfloat16" else np.dtype(name)


def _differentiable(t):
    return t.dtype.is_floating_point or t.dtype.is_complex


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _Spec:
    """What one ``(op_type, params, n_args, is_train)`` instantiation
    of a custom op needs at every call."""

    def __init__(self, op_type, params, n_args, is_train):
        self.op_type = op_type
        self.prop = _make_prop(op_type, params)
        _check_no_aux(self.prop, op_type)
        self.arg_names = list(self.prop.list_arguments())
        self.n_out = len(self.prop.list_outputs())
        self.is_train = is_train
        if n_args != len(self.arg_names):
            raise MXNetError(
                f"custom op {op_type!r} declares {len(self.arg_names)} "
                f"arguments {self.arg_names} but was called with {n_args} "
                f"tensor inputs")

    def out_specs(self, arrays):
        """``[(shape, torch dtype)]`` of the outputs, from the prop."""
        in_shapes = [list(a.shape) for a in arrays]
        ret = self.prop.infer_shape(in_shapes)
        if len(ret) < 2:
            raise MXNetError(
                f"custom op {self.op_type!r}: infer_shape must return "
                "(in_shape, out_shape, aux_shape)")
        from .ndarray.ndarray import to_dtype

        tret = self.prop.infer_type([_np_dtype(a.dtype) for a in arrays])
        return [(tuple(int(d) for d in s), to_dtype(t))
                for s, t in zip(ret[1], tret[1])]

    def operator(self, arrays):
        return self.prop.create_operator(
            Context.of(arrays[0].device) if arrays else None,
            [list(a.shape) for a in arrays],
            [_np_dtype(a.dtype) for a in arrays])

    def run(self, what, body):
        """The user's ``body`` with recording off; a failure while a
        CUDA graph captures names the op."""
        from . import autograd
        prev = autograd.set_recording(False)
        try:
            return body()
        except Exception as e:
            if _capturing() or "captur" in str(e):
                raise MXNetError(
                    f"custom op {self.op_type!r}: its {what} cannot run "
                    f"inside a CUDA graph capture (a hybridized block or "
                    f"a bound Module records it once and replays it); a "
                    f"callback that reads the host cannot be captured: "
                    f"{type(e).__name__}: {e}") from e
            raise
        finally:
            autograd.set_recording(prev)


class _CustomFunction(torch.autograd.Function):
    """One custom op call: forward makes ``out_data`` from the prop's
    shapes and types and runs the user's forward; backward runs the
    user's backward with zeros as ``in_grad``. Inputs of an integer or
    bool type take no gradient."""

    @staticmethod
    def forward(ctx, spec, *arrays):
        from .ndarray.ndarray import as_nd

        specs = spec.out_specs(arrays)
        dev = arrays[0].device
        if dev.type == "meta":
            outs = [torch.empty(s, dtype=t, device=dev) for s, t in specs]
        else:
            in_data = [as_nd(a) for a in arrays]
            out_data = [as_nd(torch.zeros(s, dtype=t, device=dev))
                        for s, t in specs]
            op = spec.operator(arrays)
            spec.run("forward", lambda: op.forward(
                is_train=spec.is_train, req=["write"] * len(out_data),
                in_data=in_data, out_data=out_data, aux=[]))
            outs = [o.as_subclass(torch.Tensor) for o in out_data]
        ctx.spec = spec
        ctx.save_for_backward(*arrays, *outs)
        ctx.n_in = len(arrays)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not _differentiable(o)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import as_nd

        spec = ctx.spec
        saved = ctx.saved_tensors
        arrays, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        out_grad = [as_nd(torch.zeros_like(o) if g is None else g)
                    for g, o in zip(grads, outs)]
        in_grad = [as_nd(torch.zeros_like(a)) for a in arrays]
        op = spec.operator(arrays)
        spec.run("backward", lambda: op.backward(
            req=["write"] * len(in_grad), out_grad=out_grad,
            in_data=[as_nd(a) for a in arrays],
            out_data=[as_nd(o) for o in outs],
            in_grad=in_grad, aux=[]))
        return (None,) + tuple(
            g.as_subclass(torch.Tensor) if _differentiable(a) else None
            for a, g in zip(arrays, in_grad))


@functools.lru_cache(maxsize=None)
def _build_custom_fn(op_type, frozen_params, n_args, is_train):
    """The cached callable of one ``(op_type, params, n_args,
    is_train)`` instantiation and its output count."""
    spec = _Spec(op_type, dict(frozen_params), n_args, is_train)

    def custom_call(*arrays):
        return _CustomFunction.apply(spec, *arrays)

    return custom_call, spec.n_out


def _invoke_custom(*arrays, op_type=None, **params):
    """Registry implementation of the ``Custom`` op."""
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    from . import autograd
    # a tensor given by keyword would not reach the autograd Function's
    # inputs: refuse it rather than drop its gradient
    bad = [k for k, v in params.items() if isinstance(v, torch.Tensor)]
    if bad:
        raise MXNetError(
            f"Custom: pass tensor inputs positionally (got tensor kwargs "
            f"{bad}); mx.sym.Custom accepts named tensor kwargs")
    params.pop("_training", None)
    fn, _ = _build_custom_fn(op_type, tuple(sorted(params.items())),
                             len(arrays), autograd.is_training())
    out = fn(*arrays)
    return out if len(out) > 1 else out[0]


def _custom_num_outputs(params):
    """``mx.sym``'s output count: the prop's ``list_outputs()``."""
    p = dict(params)
    p.pop("name", None)
    op_type = p.pop("op_type", None)
    if op_type is None:
        return 1
    return len(_make_prop(op_type, p).list_outputs())


def _custom_input_names(params):
    """``mx.sym``'s input names: the prop's ``list_arguments()``."""
    p = dict(params)
    p.pop("name", None)
    op_type = p.pop("op_type", None)
    if op_type is None:
        return None
    return list(_make_prop(op_type, p).list_arguments())


def _register_custom_op():
    from .ndarray.register import register_op

    register_op("Custom", differentiable=True,
                infer_num_outputs=_custom_num_outputs,
                infer_input_names=_custom_input_names)(_invoke_custom)


_register_custom_op()
