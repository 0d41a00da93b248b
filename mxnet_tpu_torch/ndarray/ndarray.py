"""``NDArray``: MXNet's array type as a ``torch.Tensor`` subclass.

Port of the array half of ``mxnet_tpu/ndarray/ndarray.py``. An
:class:`NDArray` is a torch tensor (``Tensor.as_subclass`` keeps the
storage and the autograd graph) with MXNet's methods: ``asnumpy``,
``asscalar``, ``context``/``ctx``, ``as_in_context``, ``copyto``,
``astype``, ``wait_to_read``, ``attach_grad``/``grad`` and
``backward``, whose default head gradient is ones for a head of any
size, as MXNet's. Torch ops on NDArrays give NDArrays (torch's default
``__torch_function__``); each such op pays a little host time for the
wrap. The port's blocks unwrap their arguments once at the top-level
call (``gluon.block``), so nothing inside a model dispatches through
it, and code that passes plain tensors never meets the subclass.

Pickles go through numpy (no device is baked in: an array loads on
the loader's current context), bfloat16 as its raw 16-bit words. The
constructors (:func:`array`, :func:`zeros`, ...) place arrays on
``ctx``, by default :func:`~..context.current_context` (``gpu(0)``
unless a ``with mx.cpu():`` scope is active). :func:`waitall` is
``torch.cuda.synchronize`` (the reference's ``engine.wait_all``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from ..util import _FLAGS as _NP_FLAGS

__all__ = ["NDArray", "arange", "array", "as_nd", "empty", "full", "ones",
           "waitall", "wrap_cls", "zeros"]

# MXNet's dtype codes (mshadow kFloat32 = 0, ...), as the JAX package's
# ``base.DTYPE_CODE_TO_NAME``
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.uint8: 3, torch.int32: 4, torch.int8: 5,
               torch.int64: 6, torch.bool: 7, torch.bfloat16: 12}
DTYPE_OF_CODE = {v: k for k, v in DTYPE_CODES.items()}
_NAMES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
          "int64": torch.int64, "bool": torch.bool}


def to_dtype(dtype):
    """A torch dtype from a name, a numpy dtype, a type, an MXNet code
    or a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, int) and not isinstance(dtype, bool):
        return DTYPE_OF_CODE[dtype]
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _NAMES[name]
    except KeyError:
        raise MXNetError(f"dtype {dtype!r} has no MXNet counterpart") \
            from None


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def raw_numpy(t):
    """``(numpy array, dtype name)`` of a tensor's bytes on the host;
    bfloat16 comes as its uint16 words (numpy has no bfloat16)."""
    t = t.detach()
    if isinstance(t, NDArray):
        t = t.as_subclass(torch.Tensor)
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), dtype_name(t.dtype)


def from_raw_numpy(npv, name, device="cpu"):
    """The inverse of :func:`raw_numpy`: a plain tensor on ``device``."""
    npv = np.array(npv, order="C")
    if name == "bfloat16":
        return torch.from_numpy(npv.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(npv).to(device)


def _unpickle(npv, name, np_cls=False):
    return as_nd(from_raw_numpy(npv, name, resolve_device(None)),
                 cls=_NP_CLS if np_cls else NDArray)


# the ``mx.np.ndarray`` class, installed by ``numpy.multiarray``, which
# the package imports (the JAX package's ``_NP_CLS``)
_NP_CLS = None


def wrap_cls(*sources):
    """The class an array made from ``sources`` takes: ``mx.np.ndarray``
    under ``npx.set_np()`` or when a source already is one (the JAX
    package's ``_wrap`` and ``invoke`` rule), else :class:`NDArray`."""
    npc = _NP_CLS
    if npc is not None:
        if _NP_FLAGS["array"]:
            return npc
        for s in sources:
            if isinstance(s, npc):
                return npc
    return NDArray


def as_nd(t, *sources, cls=None):
    """``t`` (a tensor) as ``cls``, by default :func:`wrap_cls` of
    ``sources``: the one place the port wraps a plain tensor into an
    array type. The wrap is an alias of the same storage, and stays on
    the tape of a recorded tensor (the JAX package's
    ``_convert_cls``)."""
    if cls is None:
        cls = wrap_cls(*sources)
    return t if type(t) is cls else t.as_subclass(cls)


def _tdtype(t):
    """A tensor's torch dtype (``mx.np.ndarray.dtype`` is numpy's)."""
    return torch.Tensor.dtype.__get__(t)


class NDArray(torch.Tensor):
    """MXNet's NDArray over a torch tensor (module docstring)."""

    @property
    def context(self):
        return Context.of(self.device)

    ctx = context

    @property
    def grad(self):
        g = torch.Tensor.grad.__get__(self)
        return None if g is None else as_nd(g, self)

    @grad.setter
    def grad(self, value):
        if isinstance(value, NDArray):
            value = value.as_subclass(torch.Tensor)
        torch.Tensor.grad.__set__(self, value)

    def asnumpy(self):
        """A numpy copy on the host (bfloat16 as float32: numpy has no
        bfloat16); a CPU array's copy too, not a view of its memory."""
        t = self.detach().as_subclass(torch.Tensor)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.numel() != 1:
            raise MXNetError("The current array is not a scalar")
        return self.detach().as_subclass(torch.Tensor).reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        """``float()`` of a one-element array (a recorded one too:
        the value, without autograd's warning)."""
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def wait_to_read(self):
        if self.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def copy(self):
        return self.detach().clone()

    def copyto(self, other):
        """A copy on a ``Context``, or a copy into another NDArray."""
        if isinstance(other, Context):
            return self.detach().to(resolve_device(other), copy=True)
        if isinstance(other, torch.Tensor):
            if other is not self:
                with torch.no_grad():
                    other.copy_(self)
            return other
        raise MXNetError(f"cannot copyto {type(other)}")

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        return self if self.device == dev else self.to(dev)

    def astype(self, dtype, copy=True):
        dt = to_dtype(dtype)
        if not copy and _tdtype(self) == dt:
            return self
        return self.to(dt, copy=True)

    def as_np_ndarray(self):
        """This array as an ``mx.np.ndarray`` sharing its storage
        (tape-linked under ``autograd.record()``)."""
        return as_nd(self, cls=_NP_CLS)

    def as_nd_ndarray(self):
        """This array as a classic :class:`NDArray` sharing its
        storage."""
        return as_nd(self, cls=NDArray)

    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf with a zero gradient buffer (MXNet
        allocates it at once; torch would leave ``grad`` None until the
        first backward)."""
        from .. import autograd
        if stype not in (None, "default"):
            raise ValueError(f"stype {stype!r}: the port's gradients "
                             f"are dense")
        if self.grad_fn is not None:
            raise MXNetError("attach_grad() on an array computed inside "
                             "autograd.record(); call detach() first")
        autograd.set_grad_req(self, grad_req)
        if grad_req != "null":
            self.grad = torch.zeros(self.shape, dtype=_tdtype(self),
                                    device=self.device)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Reverse sweep from this array; the head gradient defaults to
        ones of its shape (MXNet's, for any size)."""
        from .. import autograd
        autograd.backward(self, out_grad, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- MXNet's methods, each through the registered op of its meaning
    # (the JAX NDArray's; where torch has a method of the same name with
    # another meaning, MXNet's wins: ``flatten`` keeps the first axis,
    # ``max(axis)`` gives an array, ``reshape`` reads MXNet's codes,
    # ``transpose(*axes)`` permutes, ``repeat`` repeats elements,
    # ``split`` takes a number of outputs, ``take`` works along axis 0,
    # ``sort``/``topk`` give arrays). A torch-style ``dim``/``keepdim``
    # is read as ``axis``/``keepdims``.
    @property
    def T(self):
        return self.transpose()

    def as_in_ctx(self, ctx):
        return self.as_in_context(ctx)

    def cast(self, dtype):
        return self.astype(dtype)

    def zero_grad(self):
        g = torch.Tensor.grad.__get__(self)
        if g is not None:
            g.zero_()

    @property
    def stype(self):
        """Storage type: a dense NDArray's is ``"default"``."""
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype`` (``ndarray.sparse``)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def slice(self, begin, end, step=None):
        return _op("slice", [self], begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return _op("slice_axis", [self], axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _op("take", [self, indices], axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return _op("pick", [self, index], axis=axis, keepdims=keepdims)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _op("reshape", [self], shape=shape,
                   reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _op("reshape_like", [self, other])

    def transpose(self, *axes, **kwargs):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        axes = kwargs.get("axes", axes)
        return _op("transpose", [self], axes=tuple(axes) or None)

    def swapaxes(self, dim1, dim2):
        return _op("swapaxes", [self], dim1=dim1, dim2=dim2)

    def flatten(self):
        return _op("Flatten", [self])

    def expand_dims(self, axis):
        return _op("expand_dims", [self], axis=axis)

    def squeeze(self, axis=None):
        return _op("squeeze", [self], axis=axis)

    def broadcast_to(self, shape):
        return _op("broadcast_to", [self], shape=shape)

    def broadcast_like(self, other):
        return _op("broadcast_like", [self, other])

    def tile(self, reps):
        return _op("tile", [self], reps=reps)

    def repeat(self, repeats, axis=None):
        return _op("repeat", [self], repeats=repeats, axis=axis)

    def flip(self, axis):
        return _op("flip", [self], axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _op("split", [self], num_outputs=num_outputs, axis=axis,
                   squeeze_axis=squeeze_axis)

    def sum(self, axis=None, keepdims=False, **kw):
        return _reduce("sum", self, axis, keepdims, kw)

    def nansum(self, axis=None, keepdims=False, **kw):
        return _reduce("nansum", self, axis, keepdims, kw)

    def mean(self, axis=None, keepdims=False, **kw):
        return _reduce("mean", self, axis, keepdims, kw)

    def max(self, axis=None, keepdims=False, **kw):
        return _reduce("max", self, axis, keepdims, kw)

    def min(self, axis=None, keepdims=False, **kw):
        return _reduce("min", self, axis, keepdims, kw)

    def prod(self, axis=None, keepdims=False, **kw):
        return _reduce("prod", self, axis, keepdims, kw)

    def argmax(self, axis=None, keepdims=False, **kw):
        return _reduce("argmax", self, axis, keepdims, kw)

    def argmin(self, axis=None, keepdims=False, **kw):
        return _reduce("argmin", self, axis, keepdims, kw)

    def argsort(self, axis=-1, is_ascend=True):
        return _op("argsort", [self], axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _op("sort", [self], axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _op("topk", [self], axis=axis, k=k, ret_typ=ret_typ,
                   is_ascend=is_ascend)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _op("norm", [self], ord=ord, axis=axis, keepdims=keepdims)

    def abs(self):
        return _op("abs", [self])

    def exp(self):
        return _op("exp", [self])

    def log(self):
        return _op("log", [self])

    def sqrt(self):
        return _op("sqrt", [self])

    def square(self):
        return _op("square", [self])

    def sigmoid(self):
        return _op("sigmoid", [self])

    def relu(self):
        return _op("relu", [self])

    def softmax(self, axis=-1):
        return _op("softmax", [self], axis=axis)

    def log_softmax(self, axis=-1):
        return _op("log_softmax", [self], axis=axis)

    def tanh(self):
        return _op("tanh", [self])

    def clip(self, a_min, a_max):
        return _op("clip", [self], a_min=a_min, a_max=a_max)

    def round(self):
        return _op("round", [self])

    def floor(self):
        return _op("floor", [self])

    def ceil(self):
        return _op("ceil", [self])

    def sign(self):
        return _op("sign", [self])

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _op("one_hot", [self], depth=depth, on_value=on_value,
                   off_value=off_value, dtype=dtype)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _op("dot", [self, other], transpose_a=transpose_a,
                   transpose_b=transpose_b)

    def zeros_like(self):
        return _op("zeros_like", [self])

    def ones_like(self):
        return _op("ones_like", [self])

    def __reduce_ex__(self, protocol):
        return (_unpickle, raw_numpy(self) + (type(self) is _NP_CLS,))

    def __repr__(self, *, tensor_contents=None):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")


def _op(name, inputs, **params):
    from .register import get_op, invoke
    return invoke(get_op(name), inputs, params)


def _reduce(name, x, axis, keepdims, kw):
    """A reduction method; a torch-style ``dim``/``keepdim`` is read as
    ``axis``/``keepdims``."""
    if "dim" in kw:
        axis = kw.pop("dim")
    keepdims = kw.pop("keepdim", keepdims)
    if kw:
        raise TypeError(f"{name}() got unexpected arguments {sorted(kw)}")
    return _op(name, [x], axis=axis, keepdims=keepdims)


def _dev(ctx):
    return resolve_device(ctx)


def array(source, ctx=None, dtype=None):
    """An NDArray of ``source`` (array-like, tensor or NDArray) on
    ``ctx``. Python floats and float64 numpy data become float32, as
    in MXNet; a tensor keeps its type unless ``dtype`` is given."""
    dev, dt = _dev(ctx), to_dtype(dtype)
    if isinstance(source, torch.Tensor):
        t = source.detach().as_subclass(torch.Tensor)
        return as_nd(t.to(device=dev, dtype=dt or t.dtype, copy=True))
    npv = np.asarray(source)
    if dt is None:
        dt = torch.float32 if npv.dtype == np.float64 else to_dtype(npv.dtype)
    return as_nd(torch.from_numpy(np.array(npv, order="C"))
                 .to(device=dev, dtype=dt))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return as_nd(torch.zeros(_shape(shape),
                             dtype=to_dtype(dtype) or torch.float32,
                             device=_dev(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return as_nd(torch.ones(_shape(shape),
                            dtype=to_dtype(dtype) or torch.float32,
                            device=_dev(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return as_nd(torch.full(_shape(shape), val,
                            dtype=to_dtype(dtype) or torch.float32,
                            device=_dev(ctx)))


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the reference's ``empty``."""
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step,
                       dtype=to_dtype(dtype) or torch.float32,
                       device=_dev(ctx))
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return as_nd(out)


def waitall():
    """Wait for every queued operation on the card
    (``engine.wait_all``)."""
    from ..engine import engine
    engine.wait_all()
