"""Device contexts and device resolution for the PyTorch port.

Port of ``mxnet_tpu/context.py``: :class:`Context` (``cpu(i)``,
``gpu(i)``), ``with ctx:`` scopes, :func:`current_context` and
:func:`num_gpus`. ``Context("gpu", i)`` is ``torch.device("cuda", i)``.

Entry points run on the card unless the caller asks for another
device. :func:`current_context` is ``gpu(0)`` outside any ``with ctx:``
scope, with or without a card (the JAX package's "best available
device" would be a silent drop to the CPU), and using it without a card
raises. :func:`resolve_device` turns ``None`` into the current context's
device and RAISES when that is CUDA and there is no card. A CPU run is
always explicit: ``device="cpu"`` or ``with mx.cpu():`` (the tests).

Matmul precision is set explicitly for CUDA: full float32 products,
no TF32, in both cuBLAS and cuDNN. The JAX package's decode path runs
its f32 products at HIGHEST precision; TF32 would keep only about
three decimal digits and break parity with it.

cuDNN runs only deterministic convolution algorithms, chosen by its
heuristics and not by timing (``cudnn.deterministic`` on,
``cudnn.benchmark`` off), so that one seed gives one training run, as
the JAX package's compiled steps do. ResNet-50 at the example's SGD
settings (lr 0.1, momentum 0.9) is chaotic on a fixed batch: with
timed or atomic algorithms two runs from one seed drift apart within
a few steps, to losses that differ by whole units after thirty.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "current_context", "gpu", "num_gpus",
           "resolve_device", "set_matmul_precision"]


class Context:
    """A device context: ``Context("gpu", 0)``, ``Context("cpu")``.
    Usable as ``with ctx:`` to make it the current context."""

    # reference: Context::kCPU=1, kGPU=2, kCPUPinned=3, kCPUShared=5
    devtype2num = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devtype2num:
            raise MXNetError(f"unknown device type {device_type!r}: the "
                             f"port takes {sorted(self.devtype2num)}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    @property
    def torch_device(self):
        """The ``torch.device`` of this context (pinned and shared CPU
        memory are the CPU)."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()
        return False

    @classmethod
    def of(cls, device):
        """The context of a ``torch.device`` (or a name of one)."""
        dev = torch.device(device)
        if dev.type == "cuda":
            return cls("gpu", torch.cuda.current_device()
                       if dev.index is None else dev.index)
        if dev.type == "cpu":
            return cls("cpu", 0)
        raise MXNetError(f"device {dev} has no MXNet context")


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The innermost ``with ctx:`` scope's context, else ``gpu(0)``
    (module docstring)."""
    stack = getattr(Context._default, "stack", None)
    return stack[-1] if stack else gpu(0)


def set_matmul_precision():
    """Full-f32 matrix products on the card (no TF32 anywhere), and
    cuDNN's deterministic convolution algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``device`` (a ``Context``, a ``torch.device`` or its name) as a
    ``torch.device``; ``None`` is the current context's. Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and there is no card."""
    if device is None:
        device = current_context()
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(f"ctx {list(device)}: the port runs on one "
                             f"device; multi-device replicas wait for "
                             f"ROADMAP 'Multi-GPU'")
        device = device[0]
    dev = device.torch_device if isinstance(device, Context) \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: mxnet_tpu_torch runs on the GPU unless "
                "device='cpu' (or a `with mx.cpu():` scope) is given")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_matmul_precision()
    return dev
