"""Build the port's CUDA kernels from the sources in ``ops/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``mxnet_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
is of the source, so an edited kernel rebuilds), then loaded with
``ctypes``. No PyTorch header is included: such a build takes seconds,
where one through ``torch.utils.cpp_extension`` takes minutes. Builds
happen at first use, never at import; :func:`build_all` starts one
``nvcc`` per source at once, so the whole set costs one compile's time.
The sources share ``csrc/common.cuh``; the wrappers share
:data:`DTYPE_CODES`, :func:`launch` and :func:`plain`: a CUDA tensor
launches its kernel or raises, a CPU tensor takes the plain version,
and a ``meta`` tensor (``mx.sym``'s shape inference) takes the plain
version too, which only computes shapes there: nothing runs and
nothing is counted.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["ARCH_FLAGS", "BUILD_DIR", "DTYPE_CODES", "SOURCES", "build_all",
           "launch", "load", "nvcc_path", "plain", "tally"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
#: the kernels of this package, by name (``csrc/<name>.cu``)
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "layer_norm", "softmax_xent", "lstm")
#: headers every source may include
HEADERS = ("common.cuh",)
#: Hopper with its arch-specific features (wgmma, setmaxnreg)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: the ``dtype`` argument of the kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs = {}
_fns = {}
#: ``-Xptxas -v`` report (registers, shared memory, spills) per build
BUILD_LOGS = {}
#: ``{cudaStream_t: {kernel name: launches}}`` of the streams whose
#: launches are tallied apart (:func:`tally`)
_TALLIES = {}


def plain(t):
    """Whether ``t`` takes a kernel's plain version: a CPU tensor, or a
    ``meta`` one, on which the plain version only computes shapes."""
    return t.device.type in ("cpu", "meta")


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    PATH, else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "mxnet_tpu_torch are built on the machine with the "
                       "card (set CUDA_HOME or put nvcc on PATH)")


def _target(name):
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1(" ".join(ARCH_FLAGS).encode())
    for path in (src, *(os.path.join(CSRC, x) for x in HEADERS)):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    (process or None, tmp path, final path)."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return None, None, lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name, proc, tmp, lib):
    if proc is not None:
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, lib)      # atomic: concurrent builds agree
    return ctypes.CDLL(lib)


def build_all(names=SOURCES):
    """Build (or find built) every named kernel, all ``nvcc`` runs in
    parallel; returns ``{name: ctypes.CDLL}``."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        for n, proc, tmp, lib in started:
            _libs[n] = _finish(n, proc, tmp, lib)
        return {n: _libs[n] for n in names}


def load(name):
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def launch(name, symbol, argtypes, device, *args, count=None):
    """Call the C entry point ``symbol`` of kernel ``name`` (built on
    first use) with ``args`` and ``device``'s current stream; each entry
    point takes the stream last and returns a ``cudaError_t``. Raises
    ``RuntimeError`` when that is not 0. The call switches the current
    device only when ``device`` is not already current: a launch on the
    current device costs no device switch. ``count``: ``(table,
    kernel)``, the wrapper's launch counts and the name to add one to
    once the launch went out (to the stream's tally instead, when it
    has one: :func:`tally`)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # the current stream's cudaStream_t, without building a
    # torch.cuda.Stream object (the call Triton's launcher makes)
    if index == current:
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            stream = torch._C._cuda_getCurrentRawStream(index)
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if count is not None:
        table, kernel = count
        tallied = _TALLIES.get(stream)
        if tallied is None:
            table[kernel] += 1
        else:
            tallied[kernel] = tallied.get(kernel, 0) + 1


@contextlib.contextmanager
def tally(stream):
    """Within it, the launches on ``stream`` (a ``cudaStream_t``) count
    into the dict it yields, not into their wrappers' tables: a CUDA
    graph's warm-up and capture run there (``graphs``), and a replay
    adds the capture's tally to the tables. Launches on other streams,
    from any thread, count as before."""
    own = _TALLIES[stream] = {}
    try:
        yield own
    finally:
        del _TALLIES[stream]
