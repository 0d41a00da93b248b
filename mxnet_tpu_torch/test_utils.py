"""Test utilities (port of ``mxnet_tpu/test_utils.py``, MXNet's
``test_utils.py``).

- ``default_context``/``set_default_context``;
- ``same``, ``almost_equal`` and ``assert_almost_equal`` with MXNet's
  per-type default tolerances (bfloat16 added): float16 (1e-2, 1e-4),
  bfloat16 (3e-2, 1e-3), float32 (1e-4, 1e-6), float64 (1e-5, 1e-8);
  the CUDA card computes float32 in full float32 (no TF32:
  ``context.set_matmul_precision``), so no device widens them;
- ``rand_shape_nd``, ``rand_ndarray``, ``list_gpus``, ``simple_forward``;
- ``check_numeric_gradient`` (central differences against autograd)
  and ``check_consistency`` (one computation under several contexts and
  types, forward and backward: the CPU against ``gpu(0)``);
- ``with_seed`` (numpy, ``mx.random`` and Python's ``random``);
- ``download`` raises: the port reads local files only.
"""
from __future__ import annotations

import functools
import logging
import random as pyrandom

import numpy as np
import torch

from . import random as mx_random
from .context import current_context, num_gpus
from .ndarray.ndarray import NDArray, array, dtype_name

__all__ = ["almost_equal", "assert_almost_equal", "check_consistency",
           "check_numeric_gradient", "default_context", "default_dtype",
           "device_tols", "download", "list_gpus", "rand_ndarray",
           "rand_shape_nd", "same", "set_default_context",
           "simple_forward", "with_seed"]

_DEFAULT_CTX = [None]

_TOLS = {
    "float16": (1e-2, 1e-4),
    "bfloat16": (3e-2, 1e-3),
    "float32": (1e-4, 1e-6),
    "float64": (1e-5, 1e-8),
}


def device_tols(dtype="float32"):
    """``(rtol, atol)`` for results of type ``dtype``."""
    return _TOLS.get(_name(dtype), (1e-4, 1e-6))


def default_context():
    return _DEFAULT_CTX[0] or current_context()


def set_default_context(ctx):
    _DEFAULT_CTX[0] = ctx


def default_dtype():
    return np.float32


def _name(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype


def _to_np(a):
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if isinstance(t, NDArray):
            t = t.as_subclass(torch.Tensor)
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(a)


def _dtype_of(a):
    return dtype_name(a.dtype) if isinstance(a, torch.Tensor) \
        else str(np.asarray(a).dtype)


def same(a, b):
    return np.array_equal(_to_np(a), _to_np(b))


def _resolve_tols(a, b, rtol, atol):
    if rtol is None or atol is None:
        worst = (1e-5, 1e-8)
        for nm in {_dtype_of(a), _dtype_of(b)}:
            t = _TOLS.get(nm, (1e-4, 1e-6))
            worst = (max(worst[0], t[0]), max(worst[1], t[1]))
        rtol = worst[0] if rtol is None else rtol
        atol = worst[1] if atol is None else atol
    return rtol, atol


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    rtol, atol = _resolve_tols(a, b, rtol, atol)
    return np.allclose(_to_np(a).astype(np.float64),
                       _to_np(b).astype(np.float64), rtol=rtol, atol=atol,
                       equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    rtol, atol = _resolve_tols(a, b, rtol, atol)
    a_np = _to_np(a).astype(np.float64)
    b_np = _to_np(b).astype(np.float64)
    if not np.allclose(a_np, b_np, rtol=rtol, atol=atol,
                       equal_nan=equal_nan):
        err = np.abs(a_np - b_np)
        rel = err / (np.abs(b_np) + atol)
        raise AssertionError(
            f"{names[0]} and {names[1]} differ: max abs err {err.max():g}, "
            f"max rel err {rel.max():g} (rtol={rtol} atol={atol})\n"
            f"{names[0]}: {a_np}\n{names[1]}: {b_np}")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None):
    """A uniform draw in [-1, 1) of ``shape``; a sparse ``stype``
    zeroes the rows outside a ``density`` mask and casts to it."""
    ctx = ctx or default_context()
    arr = np.random.uniform(-1.0, 1.0, size=shape) \
        .astype(dtype or np.float32)
    if stype == "default":
        return array(arr, ctx=ctx)
    from .ndarray import sparse
    if density is not None:
        mask = np.random.uniform(size=shape[:1]) < density
        arr = arr * mask.reshape((-1,) + (1,) * (len(shape) - 1))
    return sparse.cast_storage(array(arr, ctx=ctx), stype)


def list_gpus():
    return list(range(num_gpus()))


def simple_forward(fn, *inputs, ctx=None, **params):
    ctx = ctx or default_context()
    nd_inputs = [x if isinstance(x, NDArray) else array(x, ctx=ctx)
                 for x in inputs]
    out = fn(*nd_inputs, **params)
    if isinstance(out, NDArray):
        return out.asnumpy()
    return [o.asnumpy() for o in out]


def check_numeric_gradient(fn, inputs, grad_outputs=None, eps=1e-3,
                           rtol=None, atol=None, ctx=None, dtype=np.float64):
    """Central differences of ``fn(*inputs).sum()`` against autograd's
    gradient (float32 arrays; default tolerances 1e-2 / 1e-3)."""
    from . import autograd

    rtol = 1e-2 if rtol is None else rtol
    atol = 1e-3 if atol is None else atol
    ctx = ctx or default_context()

    def run(vals):
        return float(fn(*[array(v.astype(np.float32), ctx=ctx)
                          for v in vals]).sum().asscalar())

    nd_inputs = [array(x.astype(np.float32), ctx=ctx) for x in inputs]
    for x in nd_inputs:
        x.attach_grad()
    with autograd.record():
        loss = fn(*nd_inputs).sum()
    loss.backward()
    analytic = [x.grad.asnumpy().astype(np.float64) for x in nd_inputs]
    for i, x in enumerate(inputs):
        numeric = np.zeros(x.shape, dtype=np.float64)
        flat = x.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            plus = run(inputs)
            flat[j] = orig - eps
            minus = run(inputs)
            flat[j] = orig
            numeric.reshape(-1)[j] = (plus - minus) / (2 * eps)
        assert_almost_equal(analytic[i], numeric, rtol=rtol, atol=atol,
                            names=(f"analytic[{i}]", f"numeric[{i}]"))


def check_consistency(fn, ctx_list, inputs, rtol=None, atol=None,
                      grad_check=True):
    """Run ``fn`` under each ``{"ctx": ..., "dtype": ...}`` of
    ``ctx_list`` on ``inputs`` (numpy arrays) and hold every forward
    and backward against the first's, at the type's tolerances."""
    from . import autograd

    results = []
    for combo in ctx_list:
        ctx, dt = combo["ctx"], combo.get("dtype", "float32")
        nd_inputs = [array(x, ctx=ctx, dtype=dt) for x in inputs]
        for x in nd_inputs:
            x.attach_grad()
        with autograd.record():
            out = fn(*nd_inputs)
            loss = out.sum()
        grads = None
        if grad_check:
            loss.backward()
            grads = [_to_np(x.grad).astype(np.float64) for x in nd_inputs]
        results.append((_to_np(out).astype(np.float64), grads, combo))
    ref_out, ref_grads, ref_combo = results[0]
    for out, grads, combo in results[1:]:
        t = device_tols(combo.get("dtype", "float32"))
        r = rtol if rtol is not None else t[0]
        a = atol if atol is not None else t[1]
        assert_almost_equal(out, ref_out, rtol=r, atol=a,
                            names=(str(combo), str(ref_combo)))
        for g, rg in zip(grads or (), ref_grads or ()):
            assert_almost_equal(g, rg, rtol=r, atol=a,
                                names=(f"grad@{combo}", f"grad@{ref_combo}"))
    return results


def with_seed(seed=None):
    """Decorator: seed numpy, ``mx.random`` and ``random`` per call;
    logs the seed when the call fails."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            this = seed if seed is not None else np.random.randint(0, 2**31)
            np.random.seed(this)
            mx_random.seed(this)
            pyrandom.seed(this)
            try:
                return fn(*args, **kwargs)
            except Exception:
                logging.error("test failed with seed %d: reproduce with "
                              "@with_seed(%d)", this, this)
                raise
        return wrapper
    return deco


def download(url, fname=None, dirname=None, overwrite=False):
    raise NotImplementedError(
        "download: the port reads local files only; place the file "
        "beside the script")
