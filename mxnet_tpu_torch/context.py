"""Device resolution for the PyTorch port.

Entry points run on the card unless the caller asks for another
device: :func:`resolve_device` turns ``None`` into the current CUDA
device and RAISES when there is none. It never drops quietly to the
CPU; a CPU run is always an explicit ``device="cpu"`` (the tests).

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

import torch

__all__ = ["resolve_device", "set_matmul_precision"]


def set_matmul_precision():
    """Full-f32 matrix products on the card (no TF32 anywhere), and
    cuDNN's deterministic convolution algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` is the current CUDA
    device. Raises ``RuntimeError`` when CUDA is asked for (explicitly
    or by default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: mxnet_tpu_torch runs on the GPU unless "
                "device='cpu' is passed explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_matmul_precision()
    return dev
