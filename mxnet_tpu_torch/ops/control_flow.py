"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``.

Port of ``mxnet_tpu/ops/control_flow.py`` (the reference's subgraph
ops ``_foreach``, ``_while_loop`` and ``_cond``, used through
``mx.nd.contrib``), with the JAX functions' signatures and results:
``foreach(body, data, init_states) -> (outputs, states)`` scans axis 0
(of each array of a list), stacking each step's outputs;
``while_loop(cond, func, loop_vars, max_iterations)`` needs
``max_iterations`` and returns ``(None, final_vars)``;
``cond(pred, then_func, else_func, inputs)`` runs one branch.

Where the JAX package traces the callbacks into one XLA loop, here
they run eagerly in Python, step by step. ``foreach`` reads nothing
back, so a hybridized block that calls it captures as a CUDA graph
(its steps unrolled). ``while_loop`` and ``cond`` must read their
predicate on the host: the read goes through ``graphs.host_read``, so
a hybridized block or a bound executor that calls them runs that key
eagerly on the card, as one that calls NMS does.
"""
from __future__ import annotations

import torch

from .. import graphs

__all__ = ["cond", "foreach", "while_loop"]


def _stack(outs):
    """Per-step outputs stacked on a new axis 0, keeping a step's
    structure (one array, or a list of them)."""
    first = outs[0]
    if isinstance(first, (list, tuple)):
        return [torch.stack([o[i] for o in outs]) for i in range(len(first))]
    return torch.stack(outs)


def _truth(p):
    if isinstance(p, torch.Tensor):
        return bool(graphs.host_read(p.reshape(-1)[0] != 0))
    return bool(p)


def foreach(body, data, init_states):
    """``mx.nd.contrib.foreach``: ``body(data_t, states) -> (out,
    states)`` over axis 0 of ``data`` (an array, or a list of arrays
    stepped together); returns the stacked outputs and the last
    states (a list when ``init_states`` is one)."""
    multi = isinstance(data, (list, tuple))
    steps = (data[0] if multi else data).shape[0]
    states = list(init_states) if isinstance(init_states, (list, tuple)) \
        else init_states
    outs = []
    for t in range(steps):
        out, states = body([d[t] for d in data] if multi else data[t],
                           states)
        if isinstance(states, tuple):
            states = list(states)
        outs.append(out)
    return _stack(outs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``mx.nd.contrib.while_loop``: while ``cond(*vars)`` holds and
    fewer than ``max_iterations`` steps ran, ``vars = func(*vars)[1]``.
    Returns ``(None, vars)`` as the JAX function does (its bounded loop
    keeps no stacked outputs); ``max_iterations`` is required, as
    there."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations (as the JAX "
                         "package's bounded loop does)")
    loop_vars = list(loop_vars)
    i = 0
    while i < max_iterations and _truth(cond(*loop_vars)):
        _, new_vars = func(*loop_vars)
        loop_vars = [new_vars] if isinstance(new_vars, torch.Tensor) \
            else list(new_vars)
        i += 1
    return None, loop_vars


def cond(pred, then_func, else_func, inputs):
    """``mx.nd.contrib.cond``: ``then_func(*inputs)`` when
    ``pred(*inputs)`` is true, else ``else_func(*inputs)``."""
    inputs = list(inputs)
    branch = then_func if _truth(pred(*inputs)) else else_func
    out = branch(*inputs)
    return list(out) if isinstance(out, tuple) else out
