"""Kernels of the PyTorch port: each a hand-written CUDA kernel
(``csrc/``), its wrapper, and its plain PyTorch version beside it."""
from __future__ import annotations

from .paged_attention import (LAUNCHES, paged_attention_reference,
                              paged_flash_attention)

__all__ = ["LAUNCHES", "launch_counts", "paged_attention_reference",
           "paged_flash_attention", "reset_launch_counts"]


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
