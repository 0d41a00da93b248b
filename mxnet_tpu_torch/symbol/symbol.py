"""Symbol: the declarative graph API.

Port of ``mxnet_tpu/symbol/symbol.py`` (MXNet's
``python/mxnet/symbol/symbol.py`` over nnvm). A :class:`Symbol` is a
node of a DAG over the *same* op registry as ``mx.nd``
(``ndarray/register.py``); binding an :class:`~..executor.Executor`
turns the DAG into one computation: on the card one CUDA graph per
binding key, as the JAX executor jits one XLA program per key. The
nnvm JSON schema (``nodes``/``arg_nodes``/``heads``) is kept for
:meth:`Symbol.tojson` and :func:`load`: a graph built in both packages
with the same names gives the same string, and a ``-symbol.json`` of
either loads in the other.

:meth:`Symbol._walk` is the one evaluator: :meth:`Symbol._eval` applies
each op through :func:`~..ndarray.register.invoke` (the eager walk),
:meth:`Symbol._eval_raw` through :func:`~..ndarray.register.call_op_fn`
on plain tensors (the walk a CUDA graph captures). Both give a
training-aware op (``Dropout``, ``RNN``) its ``_training`` from
``autograd.is_training()``. :meth:`Symbol.infer_shape` runs each node
on ``meta`` tensors where the JAX package calls ``jax.eval_shape``:
the kernels' wrappers compute shapes there and launch nothing.
"""
from __future__ import annotations

import ast
import inspect
import json

import torch

from ..attribute import AttrScope
from ..base import MXNetError
from ..context import current_context
from ..name import NameManager

__all__ = ["Group", "Symbol", "Variable", "load", "load_json", "var"]

_TRAINING_AWARE = {}
_POSITIONAL_NAMES = {}


def _accepts_training(op):
    """True when the op implementation takes a ``_training`` keyword
    (Dropout, RNN: the ops that read the train mode)."""
    hit = _TRAINING_AWARE.get(op.name)
    if hit is None:
        try:
            hit = "_training" in inspect.signature(op.fn).parameters
        except (TypeError, ValueError):
            hit = False
        _TRAINING_AWARE[op.name] = hit
    return hit


def _with_training(op, params):
    if "_training" not in params and _accepts_training(op):
        from .. import autograd
        params = dict(params, _training=autograd.is_training())
    return params


class Symbol:
    """A node (or a group of output slots) of the symbolic graph."""

    def __init__(self, op=None, inputs=None, attrs=None, name=None,
                 num_outputs=1, output_index=None, base=None):
        self._op = op  # Op record, or None for variables and groups
        self._inputs = list(inputs or [])
        self._attrs = dict(attrs or {})
        self._name = name
        self._num_outputs = num_outputs
        # a Symbol may be a view of one output of ``base``
        self._output_index = output_index
        self._base = base

    # -- construction helpers ---------------------------------------------
    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attrs.get(key)

    def list_attr(self):
        return dict(self._attrs)

    def attr_dict(self):
        out = {}
        for node in self._topo():
            if node._name:
                out[node._name] = dict(node._attrs)
        return out

    def _set_attr(self, **kwargs):
        self._attrs.update({k: str(v) for k, v in kwargs.items()})

    # -- graph walking -----------------------------------------------------
    def _topo(self):
        seen = set()
        order = []

        def visit(node):
            node = node._base or node
            if id(node) in seen:
                return
            seen.add(id(node))
            for i in node._inputs:
                visit(i)
            order.append(node)

        visit(self)
        return order

    def list_arguments(self):
        return [n._name for n in self._topo()
                if n._op is None and not n._is_group()]

    def list_outputs(self):
        if self._is_group():
            return sum([i.list_outputs() for i in self._inputs], [])
        base = self._base or self
        if base._num_outputs > 1 and self._output_index is None:
            return [f"{base._name}_output{i}"
                    for i in range(base._num_outputs)]
        return [f"{base._name}_output"]

    def list_auxiliary_states(self):
        return []

    def get_internals(self):
        return Group(self._topo())

    def _is_group(self):
        return self._op is None and self._inputs and self._name is None

    @property
    def num_outputs(self):
        if self._is_group():
            return len(self._inputs)
        return 1 if self._output_index is not None else self._num_outputs

    def __getitem__(self, index):
        if self._is_group():
            return self._inputs[index]
        if isinstance(index, str):
            for i, nm in enumerate(self.list_outputs()):
                if nm == index or nm == index + "_output":
                    index = i
                    break
            else:
                raise MXNetError(f"no output named {index}")
        if self._num_outputs == 1 and index == 0:
            return self
        if not 0 <= index < self._num_outputs:
            raise IndexError(
                f"output index {index} out of range for {self._name!r} "
                f"with {self._num_outputs} outputs")
        return Symbol(output_index=index, base=self._base or self,
                      name=f"{self._name}[{index}]")

    def __iter__(self):
        for i in range(self.num_outputs):
            yield self[i]

    def __len__(self):
        return self.num_outputs

    # -- arithmetic builds graph nodes ------------------------------------
    def _binary(self, other, op_name, scalar_name, reverse=False):
        from ..ndarray.register import get_op
        if isinstance(other, Symbol):
            ins = [other, self] if reverse else [self, other]
            return _make_node(get_op(op_name), ins, {})
        return _make_node(get_op(scalar_name), [self],
                          {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "broadcast_add_scalar")

    def __radd__(self, o):
        return self._binary(o, "broadcast_add", "broadcast_add_scalar", True)

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "broadcast_sub_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "broadcast_sub_scalar", True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "broadcast_mul_scalar")

    def __rmul__(self, o):
        return self._binary(o, "broadcast_mul", "broadcast_mul_scalar", True)

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "broadcast_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "broadcast_div_scalar", True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "broadcast_power_scalar")

    def __neg__(self):
        from ..ndarray.register import get_op
        return _make_node(get_op("negative"), [self], {})

    def __eq__(self, o):
        return self._binary(o, "broadcast_equal", "broadcast_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "broadcast_not_equal",
                            "broadcast_not_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "broadcast_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "broadcast_lesser_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater",
                            "broadcast_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "broadcast_greater_equal_scalar")

    __hash__ = object.__hash__

    # common tensor methods as graph nodes
    def reshape(self, shape):
        from ..ndarray.register import get_op
        return _make_node(get_op("reshape"), [self], {"shape": shape})

    def transpose(self, axes=None):
        from ..ndarray.register import get_op
        return _make_node(get_op("transpose"), [self], {"axes": axes})

    def sum(self, axis=None, keepdims=False):
        from ..ndarray.register import get_op
        return _make_node(get_op("sum"), [self],
                          {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        from ..ndarray.register import get_op
        return _make_node(get_op("mean"), [self],
                          {"axis": axis, "keepdims": keepdims})

    def astype(self, dtype):
        from ..ndarray.register import get_op
        return _make_node(get_op("Cast"), [self], {"dtype": str(dtype)})

    # -- evaluation --------------------------------------------------------
    def _walk(self, bindings: dict, apply):
        """The one DAG evaluator: traverse base/group/variable/op nodes,
        memoize by node identity, and delegate op application to
        ``apply(op, flat_inputs, raw_attrs)``. The eager walk and the
        walk a CUDA graph captures both run through here."""
        cache: dict[int, object] = {}

        def ev(node):
            if node._base is not None:
                vals = ev(node._base)
                return vals[node._output_index] \
                    if isinstance(vals, (list, tuple)) else vals
            if id(node) in cache:
                return cache[id(node)]
            if node._is_group():
                out = [ev(i) for i in node._inputs]
            elif node._op is None:
                if node._name not in bindings:
                    raise MXNetError(f"unbound argument {node._name!r}")
                out = bindings[node._name]
            else:
                ins = [ev(i) for i in node._inputs]
                flat = []
                for x in ins:
                    flat.extend(x if isinstance(x, (list, tuple)) else [x])
                attrs = {k: v for k, v in node._attrs.items()
                         if not k.startswith("__")}
                out = apply(node._op, flat, attrs)
            cache[id(node)] = out
            return out

        result = ev(self)
        if not isinstance(result, (list, tuple)):
            result = [result]
        return list(result)

    def _eval(self, bindings: dict, training=False):
        """Evaluate the DAG with NDArray (or tensor) bindings, one
        :func:`~..ndarray.register.invoke` per op: the eager walk
        (``MXNET_TPU_SYMBOLIC_JIT=0``, ``SymbolBlock``)."""
        from ..ndarray.register import invoke

        def apply(op, flat, attrs):
            return invoke(op, flat, _with_training(op, attrs))

        return self._walk(bindings, apply)

    def _eval_raw(self, bindings: dict, device=None):
        """Evaluate the DAG with plain tensors through the ops'
        implementations (:func:`~..ndarray.register.call_op_fn`): the
        walk a CUDA graph captures. Visible-output slicing follows
        ``invoke``; an op registered ``differentiable=False`` runs
        without gradient; in-place ``mutates`` are not written back (as
        the JAX package's traced walk skips them); an op without tensor
        inputs (a sampler) is placed on ``device``."""
        from ..ndarray import register as _reg

        def apply(op, flat, attrs):
            params = {k: _reg._parse_param(v) for k, v in attrs.items()
                      if v is not None}
            params = _with_training(op, params)
            if not flat and device is not None:
                params.setdefault("device", device)
            if op.differentiable:
                out = _reg.call_op_fn(op, flat, params)
            else:
                with torch.no_grad():
                    out = _reg.call_op_fn(op, flat, params)
            vis = op.num_visible_outputs
            if vis is not None and isinstance(out, (tuple, list)):
                out = list(out[:vis])
                if len(out) == 1:
                    out = out[0]
            return out

        return self._walk(bindings, apply)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx or current_context(), kwargs)
        return ex.forward()

    # -- shape/type inference ---------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``.

        The nnvm InferShape analog: forward-propagates shapes through the
        DAG; parameter (variable) shapes of the standard layer ops are
        back-filled from their data input by per-op hint rules (the
        reference's per-op FInferShape), then each node's outputs come
        from running its op on float32 ``meta`` tensors (no data, no
        launch). A node whose op cannot run there yet (a missing input
        shape, a data-dependent op) is skipped and retried, as the JAX
        package's ``eval_shape`` probe loop does.
        """
        arg_names = self.list_arguments()
        if args:
            kwargs = dict(zip(arg_names, args))
        known = {k: tuple(int(d) for d in v) for k, v in kwargs.items()
                 if v is not None}

        nodes = self._topo()
        out_shapes_by_node: dict[int, list] = {}

        def input_shapes(node):
            shapes = []
            for i in node._inputs:
                base = i._base or i
                if base._op is None and not base._is_group():
                    shapes.append(known.get(base._name))
                else:
                    outs = out_shapes_by_node.get(id(base))
                    if outs is None:
                        shapes.append(None)
                    else:
                        shapes.append(outs[i._output_index or 0])
            return shapes

        from ..ndarray.register import call_op_fn
        progress = True
        while progress:
            progress = False
            for node in nodes:
                if node._op is None or id(node) in out_shapes_by_node:
                    continue
                in_shapes = input_shapes(node)
                if any(s is None for s in in_shapes):
                    hint = _PARAM_SHAPE_HINTS.get(node._op.name)
                    if hint is not None:
                        filled = hint(in_shapes, node._attrs)
                        for idx, shape in (filled or {}).items():
                            src = node._inputs[idx]
                            base = src._base or src
                            if base._op is None and base._name not in known \
                                    and shape is not None:
                                known[base._name] = tuple(int(d)
                                                          for d in shape)
                                progress = True
                        in_shapes = input_shapes(node)
                    if any(s is None for s in in_shapes):
                        continue
                params = {k: _parse_attr(v) for k, v in node._attrs.items()
                          if not k.startswith("__")}
                try:
                    metas = [torch.empty(s, dtype=torch.float32,
                                         device="meta") for s in in_shapes]
                    with torch.no_grad():
                        out = call_op_fn(node._op, metas, params)
                # not a worker loop: this fixpoint PROBES each node, and
                # "this node won't infer yet" is the expected negative
                except Exception:  # mxlint: disable=silent-except
                    continue
                if not isinstance(out, (tuple, list)):
                    out = [out]
                out_shapes_by_node[id(node)] = [tuple(o.shape) for o in out]
                progress = True

        arg_shapes = [known.get(n) for n in arg_names]
        if any(s is None for s in arg_shapes):
            return None, None, None
        base = self._base or self
        if self._is_group():
            outs = []
            for i in self._inputs:
                b = i._base or i
                node_outs = out_shapes_by_node.get(id(b))
                if node_outs is None and b._op is None:
                    # a variable member: its "output" is its own shape
                    node_outs = [known.get(b._name)]
                outs.append(None if node_outs is None
                            else node_outs[i._output_index or 0])
        else:
            node_outs = out_shapes_by_node.get(id(base))
            if node_outs is None and base._op is None:
                node_outs = [known.get(base._name)]
            outs = [None if node_outs is None
                    else node_outs[self._output_index or 0]]
        return arg_shapes, outs, []

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        # the reference's partial inference answers "unknown", not an
        # error
        except Exception:  # mxlint: disable=silent-except
            return None, None, None

    def infer_type(self, *args, **kwargs):
        import numpy as np
        return [np.float32 for _ in self.list_arguments()], [np.float32], []

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        from .. import ndarray as nd

        ctx = ctx or current_context()
        arg_shapes, _, _ = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError(f"simple_bind needs shapes for all arguments "
                             f"({self.list_arguments()}), got {kwargs}")
        args = {}
        for name, shape in zip(self.list_arguments(), arg_shapes):
            dt = (type_dict or {}).get(name, "float32")
            args[name] = nd.zeros(shape, ctx=ctx, dtype=dt)
        return self.bind(ctx, args, grad_req=grad_req)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx or current_context(), args or {},
                        args_grad, grad_req, aux_states)

    # -- gradient ----------------------------------------------------------
    def simple_gradient(self, wrt):
        raise MXNetError("use Executor.backward (autograd-based)")

    # -- serialization (nnvm JSON schema) ----------------------------------
    def tojson(self):
        nodes = []
        node_ids = {}
        arg_nodes = []
        for node in self._topo():
            nid = len(nodes)
            node_ids[id(node)] = nid
            if node._op is None and not node._is_group():
                arg_nodes.append(nid)
                nodes.append({"op": "null", "name": node._name or f"arg{nid}",
                              "attrs": {k: str(v)
                                        for k, v in node._attrs.items()},
                              "inputs": []})
            elif node._is_group():
                continue
            else:
                nodes.append({
                    "op": node._op.name,
                    "name": node._name or f"{node._op.name.lower()}{nid}",
                    "attrs": {k: _attr_str(v)
                              for k, v in node._attrs.items()},
                    "inputs": [[node_ids[id(i._base or i)],
                                i._output_index or 0, 0]
                               for i in node._inputs],
                })
        if self._is_group():
            heads = [[node_ids[id(i._base or i)], i._output_index or 0, 0]
                     for i in self._inputs]
        else:
            base = self._base or self
            heads = [[node_ids[id(base)], self._output_index or 0, 0]]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10600]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        if self._op is None and not self._inputs:
            return f"<Symbol {self._name}>"
        return (f"<Symbol "
                f"{self._name or (self._op.name if self._op else 'group')}>")


def _parse_attr(v):
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _np_prod(t):
    out = 1
    for d in t:
        out *= d
    return out


def _tupleize(v, n=None):
    if v is None:
        return None
    v = _parse_attr(v)
    if isinstance(v, int):
        return (v,) * (n or 1)
    return tuple(v)


# per-op parameter-shape back-fill (the FInferShape analog of the layer
# ops whose weight shapes derive from the data input)
def _hint_fully_connected(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    nh = int(_parse_attr(attrs.get("num_hidden", 0)))
    flatten = _parse_attr(attrs.get("flatten", True))
    in_units = _np_prod(data[1:]) if flatten else data[-1]
    out = {1: (nh, in_units)}
    if len(in_shapes) > 2:
        out[2] = (nh,)
    return out


def _hint_convolution(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    kernel = _tupleize(attrs.get("kernel"))
    nf = int(_parse_attr(attrs.get("num_filter", 0)))
    ng = int(_parse_attr(attrs.get("num_group", 1)))
    out = {1: (nf, data[1] // ng) + kernel}
    if len(in_shapes) > 2:
        out[2] = (nf,)
    return out


def _hint_deconvolution(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    kernel = _tupleize(attrs.get("kernel"))
    nf = int(_parse_attr(attrs.get("num_filter", 0)))
    ng = int(_parse_attr(attrs.get("num_group", 1)))
    out = {1: (data[1], nf // ng) + kernel}
    if len(in_shapes) > 2:
        out[2] = (nf,)
    return out


def _hint_channel_params(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    axis = int(_parse_attr(attrs.get("axis", 1)))
    c = data[axis % len(data)]
    return {i: (c,) for i in range(1, len(in_shapes))}


def _hint_layer_norm(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    axis = int(_parse_attr(attrs.get("axis", -1)))
    c = data[axis % len(data)]
    return {1: (c,), 2: (c,)}


def _hint_embedding(in_shapes, attrs):
    return {1: (int(_parse_attr(attrs.get("input_dim", 0))),
                int(_parse_attr(attrs.get("output_dim", 0))))}


def _hint_softmax_label(in_shapes, attrs):
    # label = data shape minus the class axis (the reference back-infers
    # it)
    data = in_shapes[0]
    if data is None:
        return {}
    if _parse_attr(attrs.get("multi_output", False)):
        # the reference infers the FLATTENED spatial label (n, d1*...*dk)
        n = 1
        for d in data[2:]:
            n *= d
        return {1: (data[0], n) if len(data) > 2 else (data[0],)}
    return {1: tuple(data[:-1])}


def _hint_regression_label(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return {}
    return {1: tuple(data)}


_PARAM_SHAPE_HINTS = {
    "FullyConnected": _hint_fully_connected,
    "Convolution": _hint_convolution,
    "Deconvolution": _hint_deconvolution,
    "BatchNorm": _hint_channel_params,
    "InstanceNorm": _hint_channel_params,
    "GroupNorm": _hint_channel_params,
    "LayerNorm": _hint_layer_norm,
    "Embedding": _hint_embedding,
    "SoftmaxOutput": _hint_softmax_label,
    "LinearRegressionOutput": _hint_regression_label,
    "LogisticRegressionOutput": _hint_regression_label,
    "MAERegressionOutput": _hint_regression_label,
}


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return str(tuple(v))
    return str(v)


def _make_node(op, inputs, params, name=None):
    params = {k: v for k, v in params.items() if v is not None}
    name = NameManager.current().get(name, op.name.lower())
    merged = AttrScope.current().get(None)
    merged.update(params)
    nout = 1
    if op.num_visible_outputs is not None:
        nout = op.num_visible_outputs
    if "num_outputs" in params and op.dynamic_arity:
        # dynamic-arity ops (split/SliceChannel): the output count IS the
        # param, so sym[0] of a split selects one output
        try:
            nout = int(params["num_outputs"])
        except (TypeError, ValueError):
            pass
    if op.infer_num_outputs is not None:
        # param-dependent arity (RNN); params may arrive JSON-stringified
        # (load_json)
        from ..ndarray.register import _parse_param
        nout = int(op.infer_num_outputs(
            {k: _parse_param(v) for k, v in params.items()}))
    return Symbol(op=op, inputs=inputs, attrs=merged, name=name,
                  num_outputs=nout)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    return Symbol(name=name, attrs=attrs)


var = Variable


def Group(symbols):
    return Symbol(inputs=list(symbols))


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Rebuild a Symbol DAG from nnvm-schema JSON."""
    from ..ndarray.register import get_op

    data = json.loads(json_str)
    nodes = data["nodes"]
    built: list[Symbol] = []

    def pick(src, out_idx):
        # output 0 of a MULTI-output node still needs a selector (the
        # bare node would splat every output)
        if src.num_outputs > 1:
            return src[out_idx]
        return src if out_idx == 0 else src[out_idx]

    for n in nodes:
        if n["op"] == "null":
            built.append(Variable(n["name"], attr=n.get("attrs", {})))
        else:
            ins = [pick(built[nid], out_idx)
                   for nid, out_idx, _ in n["inputs"]]
            attrs = n.get("attrs", n.get("param", {}))
            built.append(_make_node(_get_op_or_waiting(n["op"]), ins,
                                    dict(attrs), name=n["name"]))
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    outs = [pick(built[nid], out_idx) for nid, out_idx, _ in heads]
    return outs[0] if len(outs) == 1 else Group(outs)


def _refuse_waiting(name):
    """``NotImplementedError`` naming the ROADMAP item of a name of the
    JAX registry that the port has not ported yet (``mx.nd.WAITING``)."""
    from ..ndarray import _WAITING_ITEM
    item = _WAITING_ITEM.get(name)
    if item is not None:
        raise NotImplementedError(
            f"mx.sym.{name} is not ported yet (ROADMAP Queue 1, '{item}')")


def _get_op_or_waiting(name):
    """The registry's op (a name still waiting raises, naming its
    ROADMAP item)."""
    from ..ndarray.register import get_op
    _refuse_waiting(name)
    return get_op(name)


# creation-style symbol functions
def zeros(shape, dtype="float32", **kwargs):
    from ..ndarray.register import get_op
    v = Variable(NameManager.current().get(None, "zeros"))
    return _make_node(get_op("zeros_like"), [v], {})


def ones(shape, dtype="float32", **kwargs):
    from ..ndarray.register import get_op
    v = Variable(NameManager.current().get(None, "ones"))
    return _make_node(get_op("ones_like"), [v], {})


def arange(start, stop=None, step=1.0, repeat=1, name=None, dtype="float32"):
    raise MXNetError("symbol.arange: use arange_like or provide data")


# ops whose parameter inputs are auto-created as variables when omitted
# (the reference's symbol composition auto-creates {name}_weight etc. for
# any unfilled op input; here declared per layer op)
_OP_INPUT_NAMES = {
    "FullyConnected": ["data", "weight", "bias"],
    "Convolution": ["data", "weight", "bias"],
    "Deconvolution": ["data", "weight", "bias"],
    "BatchNorm": ["data", "gamma", "beta", "moving_mean", "moving_var"],
    "LayerNorm": ["data", "gamma", "beta"],
    "InstanceNorm": ["data", "gamma", "beta"],
    "GroupNorm": ["data", "gamma", "beta"],
    "Embedding": ["data", "weight"],
    "LeakyReLU": ["data", "gamma"],
    "RNN": ["data", "parameters", "state", "state_cell"],
    # loss heads: the label input is auto-created as {name}_label when
    # omitted, which is how Module's label binding finds it
    "SoftmaxOutput": ["data", "label"],
    "LinearRegressionOutput": ["data", "label"],
    "LogisticRegressionOutput": ["data", "label"],
    "MAERegressionOutput": ["data", "label"],
}


def _populate_symbol_ops(module):
    """Generate ``mx.sym.<op>`` builders from the port's registry."""
    from ..ndarray.register import _OPS

    def make(op):
        static_input_names = _OP_INPUT_NAMES.get(op.name)

        def positional_names():
            # op-fn parameter names in declaration order, for folding
            # scalar positional args (sym.clip(x, 0, 6)) into attrs
            names = _POSITIONAL_NAMES.get(op.name)
            if names is None:
                try:
                    names = []
                    for p in inspect.signature(op.fn).parameters.values():
                        if p.kind not in (p.POSITIONAL_ONLY,
                                          p.POSITIONAL_OR_KEYWORD):
                            break  # *args/keyword-only: unmappable
                        names.append(p.name)
                except (TypeError, ValueError):
                    names = []
                _POSITIONAL_NAMES[op.name] = names
            return names

        def sym_fn(*args, **kwargs):
            name = kwargs.pop("name", None)
            if any(not isinstance(a, (Symbol, type(None))) for a in args):
                pos = positional_names()
                folded = []
                extra = {}
                for i, a in enumerate(args):
                    if isinstance(a, (Symbol, type(None))):
                        folded.append(a)
                    elif i < len(pos):
                        extra[pos[i]] = a
                    else:
                        raise MXNetError(
                            f"sym.{op.name}: positional argument {i} "
                            f"({a!r}) is neither a Symbol nor mappable "
                            "to a keyword parameter")
                args = tuple(folded)
                extra.update(kwargs)
                kwargs = extra
            input_names = static_input_names
            rest = {}
            named_inputs = {}
            inputs = list(args)
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    if input_names and k in input_names:
                        named_inputs[k] = v
                    else:
                        inputs.append(v)
                else:
                    rest[k] = v
            if input_names:
                name = NameManager.current().get(name, op.name.lower())
                no_bias = bool(_parse_attr(rest.get("no_bias", False)))
                full = []
                it = iter(inputs)
                for in_name in input_names:
                    if in_name in named_inputs:
                        full.append(named_inputs[in_name])
                        continue
                    nxt = next(it, None)
                    if nxt is not None:
                        full.append(nxt)
                        continue
                    if in_name == "bias" and no_bias:
                        continue
                    if op.name == "LeakyReLU" and in_name == "gamma" and \
                            rest.get("act_type", "leaky") != "prelu":
                        continue
                    if op.name == "RNN" and in_name == "state_cell" and \
                            rest.get("mode") != "lstm":
                        continue
                    full.append(Variable(f"{name}_{in_name}"))
                return _make_node(op, full, rest, name=name)
            return _make_node(op, inputs, rest, name=name)

        sym_fn.__name__ = op.name
        sym_fn.__doc__ = op.fn.__doc__
        return sym_fn

    for nm, op in _OPS.items():
        setattr(module, nm, make(op))
