#!/usr/bin/env python
"""Run one of the JAX package's own scripts on the port, unmodified.

    python -m mxnet_tpu_torch.examples.run_reference example/word_lm.py
    python -m mxnet_tpu_torch.examples.run_reference --ctx cpu \\
        example/mnist_gluon.py --epochs 1 --save /tmp/mlp

A ``sys.meta_path`` finder serves ``mxnet_tpu`` and every
``mxnet_tpu.<sub>`` from ``mxnet_tpu_torch.<sub>``, ahead of any other
finder, so ``import mxnet_tpu as mx`` in the script binds the port. A
module the port does not have fails with the reference module's name;
nothing ever resolves to the JAX package's files. The script runs as
``__main__`` (``runpy.run_path``) with the arguments after it; ``--ctx
cpu`` (before or right after the script's path) runs it inside ``with
mx.cpu():``, and ``--ctx gpu`` (the default) on the card.

At the end it prints one JSON line, the kernels' launch counts and the
graphs captured (``{"launch_counts": {...}, "captures": N}``:
``graphs.captures()``, which also counts the CPU's stand-in entries),
and exits non-zero if the script failed, or if ``jax`` or a module file
of the JAX package is in ``sys.modules``.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import json
import os
import runpy
import sys

__all__ = ["PortFinder", "forbidden_modules", "main"]

REF, PORT = "mxnet_tpu", "mxnet_tpu_torch"


class PortFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves ``mxnet_tpu[.sub]`` with the module ``mxnet_tpu_torch[.sub]``
    (the same module object under both names)."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != REF and not fullname.startswith(REF + "."):
            return None
        port = PORT + fullname[len(REF):]
        try:
            found = importlib.util.find_spec(port)
        except ModuleNotFoundError:
            found = None
        if found is None:
            raise ModuleNotFoundError(
                f"No module named {fullname!r} on the PyTorch port (it has "
                f"no {port!r} yet; see ROADMAP.md Queue 1)", name=fullname)
        return importlib.util.spec_from_loader(
            fullname, self, is_package=found.submodule_search_locations
            is not None)

    def create_module(self, spec):
        return importlib.import_module(PORT + spec.name[len(REF):])

    def exec_module(self, module):
        """The port's module is imported already."""


def forbidden_modules():
    """Names in ``sys.modules`` that are ``jax`` or come from a file of
    the JAX package."""
    ref_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), REF) + os.sep
    bad = []
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] in ("jax", "jaxlib"):
            bad.append(name)
            continue
        f = getattr(mod, "__file__", None) or ""
        if os.path.abspath(f).startswith(ref_dir):
            bad.append(name)
    return sorted(bad)


def _parse(argv):
    ctx, rest = "gpu", list(argv)
    while rest and rest[0].startswith("--ctx"):
        ctx = rest.pop(0).partition("=")[2] or rest.pop(0)
    if not rest:
        sys.exit("usage: run_reference [--ctx cpu|gpu] SCRIPT.py [args]")
    script, args = rest[0], rest[1:]
    while args and args[0].startswith("--ctx"):
        ctx = args.pop(0).partition("=")[2] or args.pop(0)
    if ctx not in ("cpu", "gpu"):
        sys.exit(f"--ctx {ctx!r}: cpu or gpu")
    return ctx, script, args


def main(argv=None):
    ctx, script, args = _parse(sys.argv[1:] if argv is None else argv)
    sys.meta_path.insert(0, PortFinder())
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs, ops

    sys.argv = [script] + args
    failed = None
    try:
        with (mx.cpu() if ctx == "cpu" else mx.gpu(0)):
            runpy.run_path(script, run_name="__main__")
    except SystemExit as exc:
        if exc.code not in (None, 0):
            failed = exc
    except BaseException as exc:            # report, then fail below
        failed = exc
        import traceback
        traceback.print_exc()
    print(json.dumps({"launch_counts": ops.launch_counts(),
                      "captures": graphs.captures()}), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"run_reference: the JAX package or jax was imported: "
              f"{bad[:5]}", file=sys.stderr)
        return 3
    if failed is not None:
        print(f"run_reference: {script} failed: {failed!r}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
