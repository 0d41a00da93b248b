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

__all__ = ["NDArray", "arange", "array", "empty", "full", "ones",
           "ones_like", "waitall", "zeros", "zeros_like"]

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


def _unpickle(npv, name):
    return from_raw_numpy(npv, name, resolve_device(None)) \
        .as_subclass(NDArray)


class NDArray(torch.Tensor):
    """MXNet's NDArray over a torch tensor (module docstring)."""

    @property
    def context(self):
        return Context.of(self.device)

    ctx = context

    @property
    def grad(self):
        g = torch.Tensor.grad.__get__(self)
        return None if g is None else g.as_subclass(NDArray)

    @grad.setter
    def grad(self, value):
        if isinstance(value, NDArray):
            value = value.as_subclass(torch.Tensor)
        torch.Tensor.grad.__set__(self, value)

    def asnumpy(self):
        """A numpy copy on the host (bfloat16 as float32: numpy has no
        bfloat16)."""
        t = self.detach().as_subclass(torch.Tensor)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.numel() != 1:
            raise MXNetError("The current array is not a scalar")
        return self.detach().as_subclass(torch.Tensor).reshape(()).item()

    def item(self):
        return self.asscalar()

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
        if not copy and self.dtype == dt:
            return self
        return self.to(dt, copy=True)

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
            self.grad = torch.zeros(self.shape, dtype=self.dtype,
                                    device=self.device)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Reverse sweep from this array; the head gradient defaults to
        ones of its shape (MXNet's, for any size)."""
        from .. import autograd
        autograd.backward(self, out_grad, retain_graph=retain_graph,
                          train_mode=train_mode)

    def __reduce_ex__(self, protocol):
        return (_unpickle, raw_numpy(self))

    def __repr__(self, *, tensor_contents=None):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")


def _dev(ctx):
    return resolve_device(ctx)


def array(source, ctx=None, dtype=None):
    """An NDArray of ``source`` (array-like, tensor or NDArray) on
    ``ctx``. Python floats and float64 numpy data become float32, as
    in MXNet; a tensor keeps its type unless ``dtype`` is given."""
    dev, dt = _dev(ctx), to_dtype(dtype)
    if isinstance(source, torch.Tensor):
        t = source.detach().as_subclass(torch.Tensor)
        return t.to(device=dev, dtype=dt or t.dtype, copy=True) \
            .as_subclass(NDArray)
    npv = np.asarray(source)
    if dt is None:
        dt = torch.float32 if npv.dtype == np.float64 else to_dtype(npv.dtype)
    return torch.from_numpy(np.array(npv, order="C")) \
        .to(device=dev, dtype=dt).as_subclass(NDArray)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return torch.zeros(_shape(shape), dtype=to_dtype(dtype) or torch.float32,
                       device=_dev(ctx)).as_subclass(NDArray)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return torch.ones(_shape(shape), dtype=to_dtype(dtype) or torch.float32,
                      device=_dev(ctx)).as_subclass(NDArray)


def full(shape, val, ctx=None, dtype=None):
    return torch.full(_shape(shape), val,
                      dtype=to_dtype(dtype) or torch.float32,
                      device=_dev(ctx)).as_subclass(NDArray)


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
    return out.as_subclass(NDArray)


def zeros_like(data, **kwargs):
    return torch.zeros_like(data).as_subclass(NDArray)


def ones_like(data, **kwargs):
    return torch.ones_like(data).as_subclass(NDArray)


def waitall():
    """Wait for every queued operation on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
