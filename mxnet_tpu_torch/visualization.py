"""Network visualization (``mx.viz``).

Port of ``mxnet_tpu/visualization.py`` (the reference's
``python/mxnet/visualization.py``): :func:`print_summary` walks a
Symbol's DAG and prints the layer table (output shapes from one
``infer_shape`` over the internals, parameter counts, each shared
weight counted once) and returns the parameter total;
:func:`plot_network` renders the DAG with graphviz when that optional
package is installed and raises ``ImportError`` naming it otherwise.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["plot_network", "print_summary"]


def _order(symbol):
    """Post-order DAG walk — Symbol._topo already resolves indexed-output
    selections ("split0[1]") to their base node."""
    return symbol._topo()


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64, .74, 1.)):
    """Print a layer-by-layer summary of the symbol (reference
    visualization.py print_summary). ``shape`` is a dict of input
    name -> shape used to infer per-layer output shapes."""
    if symbol._is_group():
        raise MXNetError("print_summary expects a single-output symbol")
    shape_map = {}
    if shape is not None:
        # ONE inference over the internals group (not per-node — a
        # per-node loop re-walks the whole subgraph each time, O(n^2))
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape_partial(**shape)
        for s, os_ in zip(internals, out_shapes or ()):
            if os_ is not None and s.name:
                shape_map[s.name] = os_

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(cols):
        line = ""
        for i, col in enumerate(cols):
            line = (line + str(col))[:positions[i] - 1].ljust(positions[i])
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)

    order = _order(symbol)

    total = 0
    arg_names = set(symbol.list_arguments())
    # variable internals' output shapes ARE the arg shapes — one
    # inference pass serves both columns
    shaped_args = shape_map

    counted = set()  # weight shared across nodes (unrolled RNNs) counts once
    for node in order:
        if node._op is None and shape and node._name in shape:  # data input
            print_row([f"{node._name} (input)",
                       shape.get(node._name, ""), 0, ""])
            print("_" * line_length)
            continue
        if node._op is None:
            continue  # weight/bias variables fold into their consumer
        params = 0
        prevs = []
        for inp in node._inputs:
            inp = inp._base or inp
            if inp._op is None and inp._name in arg_names \
                    and inp._name not in counted \
                    and not inp._name.endswith("label") \
                    and (shape is None or inp._name not in shape):
                counted.add(inp._name)
                s = shaped_args.get(inp._name)
                if s:
                    n = 1
                    for d in s:
                        n *= int(d)
                    params += n
            else:
                prevs.append(inp.name or "")
        total += params
        out_shape = shape_map.get(node.name, "")
        print_row([f"{node.name} ({node._op.name})", out_shape, params,
                   ",".join(p for p in prevs if p)[:40]])
        print("_" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Render the DAG with graphviz (reference plot_network). Raises
    ``ImportError`` without the optional graphviz package (the text
    form is :func:`print_summary`)."""
    try:
        from graphviz import Digraph  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "plot_network requires the optional graphviz package "
            "(pip install graphviz); use mx.viz.print_summary for a "
            "text summary") from e
    _PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta", "moving_mean",
                       "moving_var", "running_mean", "running_var")

    def _hidden(var_name):
        # hide PARAMETER variables only — data/label inputs stay visible
        # even without a shape dict (reference behavior)
        return hide_weights and var_name is not None \
            and var_name.endswith(_PARAM_SUFFIXES)

    dot = Digraph(name=title, format=save_format)
    order = _order(symbol)
    for node in order:
        if node._op is None:
            if _hidden(node._name):
                continue
            dot.node(str(id(node)), node._name or "var", shape="oval")
        else:
            dot.node(str(id(node)), f"{node.name}\n{node._op.name}",
                     shape="box")
    for node in order:
        if node._op is None:
            continue
        for inp in node._inputs:
            inp = inp._base or inp
            if inp._op is None and _hidden(inp._name):
                continue
            dot.edge(str(id(inp)), str(id(node)))
    return dot
