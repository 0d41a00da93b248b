"""ONNX export/import (``mx.contrib.onnx``).

Port of ``mxnet_tpu/contrib/onnx/__init__.py``, a near copy over the
port's ``mx.sym`` and ``nd``. The ONNX IR subset is encoded by hand
(``onnx_minimal_pb2.py``: the public ``onnx.proto``'s field layout, so
the files are real ONNX), with no onnx or protobuf package. Scope: the
op set of the model zoo's MLP/CNN families (Gemm/Conv/BatchNorm/
pooling/activations/elementwise/shape ops) and the fused RNN op
(ONNX ``LSTM``/``GRU``/``RNN``, one node a layer), opset 13.

- :func:`export_model` — Symbol + params → ``model.onnx``. For the
  same graph and parameters the file is the JAX package's, byte for
  byte, apart from ``producer_name``. Like the JAX exporter it writes
  every entry of ``params`` as an initializer, so an RNN's packed
  parameter vector rides along beside the per-layer W/R/B it was
  unpacked into; the importer returns it in ``arg_params``, though no
  node reads it.
- :func:`import_model` — ``model.onnx`` → (Symbol, arg_params,
  aux_params), the arrays on ``current_context()`` (the card, unless
  the caller is inside ``with mx.cpu():``). A recurrent node's
  ``parameters`` variable has no shape rule, so ``Module.bind`` cannot
  infer the imported graph's shapes: bind an ``Executor`` with every
  array given. The JAX importer drops a recurrent node's W/R/B from
  ``arg_params`` even when another node reads them; this one drops an
  initializer only after its last reader took it into a packed vector.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from . import onnx_minimal_pb2 as pb
from ...base import MXNetError

__all__ = ["export_model", "import_model"]

_DT = {"float32": pb.TensorProto.FLOAT, "float64": pb.TensorProto.DOUBLE,
       "float16": pb.TensorProto.FLOAT16, "bfloat16": pb.TensorProto.BFLOAT16,
       "int32": pb.TensorProto.INT32, "int64": pb.TensorProto.INT64,
       "int8": pb.TensorProto.INT8, "uint8": pb.TensorProto.UINT8,
       "bool": pb.TensorProto.BOOL}
_DT_REV = {v: k for k, v in _DT.items()}

_UNARY_EXPORT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
                 "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
                 "negative": "Neg", "identity": "Identity",
                 "copy": "Identity", "Flatten": "Flatten", "erf": "Erf",
                 "floor": "Floor", "ceil": "Ceil", "round": "Round"}
_BINARY_EXPORT = {"broadcast_add": "Add", "broadcast_sub": "Sub",
                  "broadcast_mul": "Mul", "broadcast_div": "Div",
                  "elemwise_add": "Add", "maximum": "Max", "minimum": "Min",
                  "broadcast_maximum": "Max", "broadcast_minimum": "Min"}


def _host(v):
    """A parameter (NDArray, tensor or numpy array) as a numpy array on
    the host; bfloat16 as a CPU tensor (numpy has no such type)."""
    t = torch.as_tensor(v).as_subclass(torch.Tensor).detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _np_tensor(name, arr):
    t = pb.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    if isinstance(arr, torch.Tensor):       # bfloat16 (_host)
        t.data_type = pb.TensorProto.BFLOAT16
        t.raw_data = arr.contiguous().view(torch.int16).numpy().tobytes()
        return t
    dt = str(arr.dtype) if str(arr.dtype) in _DT else "float32"
    t.data_type = _DT[dt]
    t.raw_data = np.ascontiguousarray(arr).astype(np.dtype(dt)).tobytes()
    return t


def _tensor_np(t):
    dtype = _DT_REV.get(t.data_type, "float32")
    shape = tuple(t.dims)
    if t.raw_data:
        if dtype == "bfloat16":
            # numpy has no bfloat16: the raw bits as a torch tensor
            bits = np.frombuffer(t.raw_data, np.uint16).reshape(shape)
            return torch.from_numpy(bits.astype(np.int16)).view(
                torch.bfloat16)
        return np.frombuffer(t.raw_data, np.dtype(dtype)).reshape(shape).copy()
    if t.float_data:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.int64_data:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    if t.int32_data:
        return np.asarray(t.int32_data, np.int32).reshape(shape)
    return np.zeros(shape, np.dtype(dtype))


def _attr(name, value):
    a = pb.AttributeProto()
    a.name = name
    if isinstance(value, float):
        a.type = pb.AttributeProto.FLOAT
        a.f = value
    elif isinstance(value, bool):
        a.type = pb.AttributeProto.INT
        a.i = int(value)
    elif isinstance(value, int):
        a.type = pb.AttributeProto.INT
        a.i = value
    elif isinstance(value, str):
        a.type = pb.AttributeProto.STRING
        a.s = value.encode()
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            a.type = pb.AttributeProto.FLOATS
            a.floats.extend(value)
        elif value and isinstance(value[0], str):
            a.type = pb.AttributeProto.STRINGS
            a.strings.extend(v.encode() for v in value)
        else:
            a.type = pb.AttributeProto.INTS
            a.ints.extend(int(v) for v in value)
    else:
        raise MXNetError(f"unsupported attribute {name}={value!r}")
    return a


class _Exporter:
    def __init__(self, graph):
        self.g = graph
        self.counter = 0
        self.extra_inits = []

    def uniq(self, base):
        self.counter += 1
        return f"{base}_{self.counter}"

    def node(self, op_type, inputs, outputs=None, name=None, **attrs):
        n = pb.NodeProto()
        n.op_type = op_type
        n.name = name or self.uniq(op_type.lower())
        n.input.extend(inputs)
        out = outputs or [n.name + "_out"]
        n.output.extend(out)
        for k, v in attrs.items():
            if v is not None:
                n.attribute.append(_attr(k, v))
        self.g.node.append(n)
        return out[0]

    def const_i64(self, vals):
        name = self.uniq("const")
        self.g.initializer.append(
            _np_tensor(name, np.asarray(vals, np.int64)))
        return name


def _tup(v, n=None):
    if v is None:
        return None
    t = tuple(int(x) for x in (v if isinstance(v, (list, tuple)) else (v,)))
    return t


# ---------------------------------------------------------------------------
# fused RNN op <-> ONNX LSTM/GRU/RNN (reference mx2onnx _op_translations
# RNN coverage). Gate-order maps between the cuDNN-canonical packed
# vector (op_impl_rnn.py: LSTM [i,f,g,o], GRU [r,z,n]) and the ONNX
# layouts (LSTM [i,o,f,c], GRU [z,r,h], W/R/B stacked per direction).
_RNN_GATES = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}
_RNN_ONNX_OP = {"lstm": "LSTM", "gru": "GRU",
                "rnn_relu": "RNN", "rnn_tanh": "RNN"}
# ours->onnx block permutation (onnx = ours[perm])
_RNN_PERM = {"lstm": (0, 3, 1, 2), "gru": (1, 0, 2),
             "rnn_relu": (0,), "rnn_tanh": (0,)}
# onnx->ours (inverse permutation)
_RNN_INV = {"lstm": (0, 2, 3, 1), "gru": (1, 0, 2),
            "rnn_relu": (0,), "rnn_tanh": (0,)}


def _gate_perm(mat, mode, perm_table):
    """Permute the H-row gate blocks of a (gates*H, X) matrix or
    (gates*H,) bias vector."""
    gates = _RNN_GATES[mode]
    perm = list(perm_table[mode])
    blocks = mat.reshape((gates, mat.shape[0] // gates) + mat.shape[1:])
    return blocks[perm].reshape(mat.shape)


def _rnn_unpack(packed, mode, H, L, D):
    """Split the cuDNN-canonical flat vector into per-layer/direction
    (w_i2h, w_h2h, b_i2h, b_h2h) numpy arrays (layout per
    op_impl_rnn._unpack_params; input size inferred from total length)."""
    gates = _RNN_GATES[mode]
    rest_w = (L - 1) * D * gates * H * (D * H + H)
    total_b = L * D * gates * H * 2
    first_w = packed.size - rest_w - total_b
    isz0 = first_w // (D * gates * H) - H
    if isz0 <= 0 or D * gates * H * (isz0 + H) != first_w:
        raise MXNetError(
            f"packed RNN parameter vector of size {packed.size} does not "
            f"match mode={mode} H={H} L={L} D={D}")
    ws = []
    idx = 0
    for layer in range(L):
        isz = isz0 if layer == 0 else D * H
        per = []
        for _ in range(D):
            w_i2h = packed[idx:idx + gates * H * isz].reshape(gates * H, isz)
            idx += gates * H * isz
            w_h2h = packed[idx:idx + gates * H * H].reshape(gates * H, H)
            idx += gates * H * H
            per.append([w_i2h, w_h2h])
        ws.append(per)
    for layer in range(L):
        for d in range(D):
            b_i2h = packed[idx:idx + gates * H]
            idx += gates * H
            b_h2h = packed[idx:idx + gates * H]
            idx += gates * H
            ws[layer][d].extend([b_i2h, b_h2h])
    return ws


def _export_rnn(ex, a, ins, params_lookup):
    """Emit ONNX LSTM/GRU/RNN node(s) for one fused-RNN application;
    returns [output, h_out(, c_out)] names."""
    mode = str(a.get("mode", "lstm"))
    if mode not in _RNN_GATES:
        raise MXNetError(f"RNN mode {mode!r} not exportable")
    H = int(a["state_size"])
    L = int(a.get("num_layers", 1))
    D = 2 if str(a.get("bidirectional", False)) in ("True", "1", "true") \
        else 1
    packed = params_lookup(ins[1])
    if packed is None:
        raise MXNetError(
            "RNN export needs the packed parameter vector as a constant "
            f"initializer; {ins[1]!r} is a free graph input")
    layers = _rnn_unpack(np.asarray(packed, np.float32).ravel(),
                         mode, H, L, D)
    lstm = mode == "lstm"
    onnx_op = _RNN_ONNX_OP[mode]

    def state_for(layer, name):
        if L == 1:
            return name  # already (D, N, H)
        return ex.node("Slice",
                       [name, ex.const_i64([layer * D]),
                        ex.const_i64([(layer + 1) * D]), ex.const_i64([0])])

    x = ins[0]
    hs, cs = [], []
    for layer in range(L):
        W = np.stack([_gate_perm(d[0], mode, _RNN_PERM)
                      for d in layers[layer]])
        R = np.stack([_gate_perm(d[1], mode, _RNN_PERM)
                      for d in layers[layer]])
        B = np.stack([np.concatenate([_gate_perm(d[2], mode, _RNN_PERM),
                                      _gate_perm(d[3], mode, _RNN_PERM)])
                      for d in layers[layer]])
        wn, rn, bn = (ex.uniq(f"rnn_{t}{layer}") for t in ("W", "R", "B"))
        for nm, arr in ((wn, W), (rn, R), (bn, B)):
            ex.g.initializer.append(_np_tensor(nm, arr))
        node_ins = [x, wn, rn, bn, "", state_for(layer, ins[2])]
        if lstm:
            node_ins.append(state_for(layer, ins[3]))
        outs = [ex.uniq("rnn_Y"), ex.uniq("rnn_Yh")]
        if lstm:
            outs.append(ex.uniq("rnn_Yc"))
        kw = {"hidden_size": H,
              "direction": "bidirectional" if D == 2 else "forward"}
        if mode == "gru":
            # cuDNN computes n = tanh(Wx + r*(Rh + bR))
            kw["linear_before_reset"] = 1
        if onnx_op == "RNN":
            kw["activations"] = ["Relu" if mode == "rnn_relu"
                                 else "Tanh"] * D
        ex.node(onnx_op, node_ins, outs, **kw)
        # Y (T, D, N, H) -> (T, N, D*H) for the next layer / output
        tr = ex.node("Transpose", [outs[0]], perm=(0, 2, 1, 3))
        x = ex.node("Reshape", [tr, ex.const_i64((0, 0, D * H))])
        hs.append(outs[1])
        if lstm:
            cs.append(outs[2])
    h = hs[0] if L == 1 else ex.node("Concat", hs, axis=0)
    if lstm:
        c = cs[0] if L == 1 else ex.node("Concat", cs, axis=0)
        return [x, h, c]
    return [x, h]


def _export_node(ex, op_name, attrs, ins, out_name=None,
                 params_lookup=None):
    """Map one mxnet op application to ONNX node(s); returns the output
    name (or a LIST of names for multi-output ops like RNN)."""
    a = {k: v for k, v in attrs.items() if v is not None}
    if op_name == "RNN":
        return _export_rnn(ex, a, ins, params_lookup)
    if op_name in _UNARY_EXPORT:
        return ex.node(_UNARY_EXPORT[op_name], ins, [out_name] if out_name else None)
    if op_name in _BINARY_EXPORT:
        return ex.node(_BINARY_EXPORT[op_name], ins, [out_name] if out_name else None)
    if op_name == "FullyConnected":
        x = ins[0]
        if str(a.get("flatten", True)) not in ("False", "0"):
            x = ex.node("Flatten", [x], axis=1)
        inputs = [x, ins[1]] + (ins[2:3] if len(ins) > 2 else [])
        return ex.node("Gemm", inputs, [out_name] if out_name else None,
                       alpha=1.0, beta=1.0, transB=1)
    if op_name == "Convolution":
        k = _tup(a.get("kernel"))
        nd_ = len(k)
        pads = _tup(a.get("pad")) or (0,) * nd_
        return ex.node("Conv", ins, [out_name] if out_name else None,
                       kernel_shape=k,
                       strides=_tup(a.get("stride")) or (1,) * nd_,
                       pads=pads + pads,
                       dilations=_tup(a.get("dilate")) or (1,) * nd_,
                       group=int(a.get("num_group", 1)))
    if op_name == "Activation":
        t = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softrelu": "Softplus"}[a.get("act_type", "relu")]
        return ex.node(t, ins, [out_name] if out_name else None)
    if op_name == "LeakyReLU":
        act = a.get("act_type", "leaky")
        if act == "leaky":
            return ex.node("LeakyRelu", ins, [out_name] if out_name else None,
                           alpha=float(a.get("slope", 0.25)))
        if act == "elu":
            return ex.node("Elu", ins, [out_name] if out_name else None,
                           alpha=float(a.get("slope", 0.25)))
        raise MXNetError(f"LeakyReLU act_type {act} not exportable")
    if op_name in ("softmax", "SoftmaxActivation", "SoftmaxOutput", "Softmax"):
        return ex.node("Softmax", ins[:1], [out_name] if out_name else None,
                       axis=int(a.get("axis", -1)))
    if op_name == "log_softmax":
        return ex.node("LogSoftmax", ins, [out_name] if out_name else None,
                       axis=int(a.get("axis", -1)))
    if op_name == "Pooling":
        global_pool = str(a.get("global_pool", False)) in ("True", "1")
        ptype = a.get("pool_type", "max")
        if global_pool:
            t = "GlobalMaxPool" if ptype == "max" else "GlobalAveragePool"
            return ex.node(t, ins, [out_name] if out_name else None)
        k = _tup(a.get("kernel"))
        pads = _tup(a.get("pad")) or (0,) * len(k)
        kw = dict(kernel_shape=k,
                  strides=_tup(a.get("stride")) or (1,) * len(k),
                  pads=pads + pads)
        # pooling_convention="full" is mxnet's ceil_mode (gluon
        # MaxPool2D(ceil_mode=True)); dropping it silently shifted
        # squeezenet's pool shapes by one
        if str(a.get("pooling_convention", "valid")) == "full":
            kw["ceil_mode"] = 1
        if ptype == "max":
            return ex.node("MaxPool", ins, [out_name] if out_name else None, **kw)
        kw["count_include_pad"] = int(str(a.get("count_include_pad", True))
                                      in ("True", "1"))
        return ex.node("AveragePool", ins, [out_name] if out_name else None, **kw)
    if op_name == "BatchNorm":
        return ex.node("BatchNormalization", ins[:5],
                       [out_name] if out_name else None,
                       epsilon=float(a.get("eps", 1e-5)),
                       momentum=float(a.get("momentum", 0.9)))
    if op_name == "Dropout":
        return ex.node("Dropout", ins[:1], [out_name] if out_name else None)
    if op_name in ("concat", "Concat"):
        return ex.node("Concat", ins, [out_name] if out_name else None,
                       axis=int(a.get("dim", 1)))
    if op_name == "add_n":
        return ex.node("Sum", ins, [out_name] if out_name else None)
    if op_name in ("reshape", "Reshape"):
        shape = ex.const_i64(_tup(a.get("shape")))
        return ex.node("Reshape", [ins[0], shape],
                       [out_name] if out_name else None)
    if op_name == "transpose":
        return ex.node("Transpose", ins, [out_name] if out_name else None,
                       perm=_tup(a.get("axes")))
    if op_name == "dot":
        return ex.node("MatMul", ins, [out_name] if out_name else None)
    if op_name == "Embedding":
        # onnx Gather(data=table, indices)
        return ex.node("Gather", [ins[1], ins[0]],
                       [out_name] if out_name else None, axis=0)
    if op_name == "clip":
        # bounds arrive as attrs (a_min/a_max kwargs) or as scalar
        # positional inputs (sym.clip(x, 0, 6))
        lo = a.get("a_min", ins[1] if len(ins) > 1 else 0.0)
        hi = a.get("a_max", ins[2] if len(ins) > 2 else 0.0)
        ex_lo = ex.uniq("clip_min")
        ex_hi = ex.uniq("clip_max")
        ex.g.initializer.append(_np_tensor(
            ex_lo, np.asarray(float(lo), np.float32)))
        ex.g.initializer.append(_np_tensor(
            ex_hi, np.asarray(float(hi), np.float32)))
        return ex.node("Clip", [ins[0], ex_lo, ex_hi],
                       [out_name] if out_name else None)
    raise MXNetError(f"op {op_name!r} has no ONNX export mapping")


def export_model(sym, params, input_shapes=None, input_types=None,
                 onnx_file_path="model.onnx", opset_version=13, **kwargs):
    """Export a Symbol + params dict to an ONNX file.

    params: dict name→NDArray covering every non-data argument.
    input_shapes: dict name→shape (or list matching free inputs)."""
    from ...symbol.symbol import Symbol

    if not isinstance(sym, Symbol):
        raise MXNetError("export_model expects a Symbol")
    params = {k.split(":", 1)[-1]: v for k, v in (params or {}).items()}
    model = pb.ModelProto()
    model.ir_version = 8
    model.producer_name = "mxnet_tpu_torch"
    opset = model.opset_import.add()
    opset.domain = ""
    opset.version = opset_version
    g = model.graph
    g.name = sym.name or "mxnet_tpu_graph"
    ex = _Exporter(g)

    for name, arr in params.items():
        g.initializer.append(_np_tensor(name, _host(arr)))

    shapes = dict(input_shapes or {})
    names: dict = {}

    def params_lookup(name):
        arr = params.get(name)
        if arr is None:
            return None
        arr = _host(arr)
        return arr.float().numpy() if isinstance(arr, torch.Tensor) else arr

    def first(v):
        # a multi-output node used directly as an input means output 0
        return v[0] if isinstance(v, list) else v

    def emit(node):
        if node._base is not None:
            outs = emit(node._base)
            if isinstance(outs, list):
                return outs[node._output_index or 0]
            return outs  # single-output subset
        if id(node) in names:
            return names[id(node)]
        if node._op is None:
            names[id(node)] = node._name
            if node._name not in params:
                vi = g.input.add()
                vi.name = node._name
                vi.type.tensor_type.elem_type = pb.TensorProto.FLOAT
                for d in shapes.get(node._name, ()):
                    vi.type.tensor_type.shape.dim.add().dim_value = int(d)
            return node._name
        # scalar positional args (sym.clip(x, 0, 6)) ride through as
        # python values for the op branch to fold into attributes
        ins = [first(emit(i)) if isinstance(i, Symbol) else i
               for i in node._inputs]
        attrs = {k: v for k, v in node._attrs.items() if not k.startswith("__")}
        out = _export_node(ex, node._op.name, attrs, ins,
                           out_name=node._name + "_out" if node._name else None,
                           params_lookup=params_lookup)
        names[id(node)] = out
        return out

    outputs = sym._inputs if sym._is_group() else [sym]
    for o in outputs:
        out_name = first(emit(o))
        vi = g.output.add()
        vi.name = out_name
        vi.type.tensor_type.elem_type = pb.TensorProto.FLOAT

    with open(onnx_file_path, "wb") as f:
        f.write(model.SerializeToString())
    return onnx_file_path


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------
_UNARY_IMPORT = {v: k for k, v in _UNARY_EXPORT.items() if v != "Identity"}
_UNARY_IMPORT["Identity"] = "identity"
_BINARY_IMPORT = {"Add": "broadcast_add", "Sub": "broadcast_sub",
                  "Mul": "broadcast_mul", "Div": "broadcast_div",
                  "Max": "broadcast_maximum", "Min": "broadcast_minimum"}


def _sym_pads(pads, nd_, op_type):
    """ONNX pads = [begin..., end...]; the mxnet ops take symmetric pads.
    Asymmetric padding raises loudly instead of silently truncating."""
    if not pads:
        return (0,) * nd_
    pads = tuple(pads)
    begin, end = pads[:nd_], pads[nd_:]
    if end and begin != end:
        raise MXNetError(
            f"{op_type}: asymmetric ONNX pads {pads} are not supported")
    return begin


def _get_attrs(n):
    out = {}
    for a in n.attribute:
        if a.type == pb.AttributeProto.FLOAT:
            out[a.name] = a.f
        elif a.type == pb.AttributeProto.INT:
            out[a.name] = a.i
        elif a.type == pb.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == pb.AttributeProto.INTS:
            out[a.name] = tuple(a.ints)
        elif a.type == pb.AttributeProto.FLOATS:
            out[a.name] = tuple(a.floats)
        elif a.type == pb.AttributeProto.STRINGS:
            out[a.name] = tuple(s.decode() for s in a.strings)
    return out


def _import_rnn(symmod, nd, n, a, ins, inits, env, arg_params, sym_of,
                readers):
    """ONNX LSTM/GRU/RNN node → fused sym.RNN; returns
    {onnx_output_name: Symbol} for the outputs the node declares.
    ``readers``: each name's count of the readers not yet imported."""
    t = n.op_type
    H = int(a["hidden_size"])
    direction = a.get("direction", "forward")
    if direction == "reverse":
        raise MXNetError(f"{t}: direction='reverse' is not supported "
                         "(wrap in bidirectional or flip the sequence)")
    D = 2 if direction == "bidirectional" else 1
    if t == "LSTM":
        mode = "lstm"
    elif t == "GRU":
        mode = "gru"
        if not int(a.get("linear_before_reset", 0)):
            raise MXNetError(
                "GRU with linear_before_reset=0 differs from the "
                "cuDNN-canonical cell this framework computes")
    else:
        acts = tuple(s.lower() for s in a.get("activations", ("tanh",) * D))
        if any(s != acts[0] for s in acts) or acts[0] not in ("tanh", "relu"):
            raise MXNetError(f"RNN activations {acts} not supported")
        mode = f"rnn_{acts[0]}"
    gates = _RNN_GATES[mode]
    W = inits.get(ins[1])
    R = inits.get(ins[2])
    if W is None or R is None:
        raise MXNetError(f"{t}: W/R must be constant initializers")
    B = inits.get(ins[3]) if len(ins) > 3 and ins[3] else \
        np.zeros((D, 2 * gates * H), np.float32)
    if B is None:
        raise MXNetError(f"{t}: B must be a constant initializer")
    ws, bs = [], []
    for d in range(D):
        ws.append(_gate_perm(np.asarray(W[d], np.float32),
                             mode, _RNN_INV).ravel())
        ws.append(_gate_perm(np.asarray(R[d], np.float32),
                             mode, _RNN_INV).ravel())
        bs.append(_gate_perm(np.asarray(B[d][:gates * H], np.float32),
                             mode, _RNN_INV))
        bs.append(_gate_perm(np.asarray(B[d][gates * H:], np.float32),
                             mode, _RNN_INV))
    packed = np.concatenate(ws + bs)
    pname = (n.name or f"{t.lower()}_{n.output[0]}") + "_parameters"
    env[pname] = ("var", symmod.var(pname))
    arg_params[pname] = nd.array(packed)
    # W/R/B are consumed into the packed vector — they must not linger
    # as free parameters the caller would have to feed, unless another
    # node still reads them (shared weights)
    for consumed in ins[1:4]:
        if consumed:
            readers[consumed] -= 1
            if readers[consumed] <= 0:
                arg_params.pop(consumed, None)
    if len(ins) > 4 and ins[4]:
        raise MXNetError(
            f"{t}: sequence_lens input is not supported — the fused RNN "
            "would run the full recurrence over padding and silently "
            "diverge from the ONNX-spec masked result")
    if len(ins) > 5 and ins[5]:
        init_h = sym_of(ins[5])
    else:
        raise MXNetError(
            f"{t}: initial_h input is required (implicit zero states "
            "need a static batch size this importer does not carry)")
    args = [sym_of(ins[0]), env[pname][1], init_h]
    if mode == "lstm":
        if len(ins) > 6 and ins[6]:
            args.append(sym_of(ins[6]))
        else:
            raise MXNetError("LSTM: initial_c input is required")
    r = symmod.RNN(*args, state_size=H, num_layers=1,
                   bidirectional=D == 2, mode=mode, state_outputs=True)
    # our output (T, N, D*H) -> ONNX Y (T, D, N, H)
    y = symmod.transpose(symmod.reshape(r[0], shape=(0, 0, D, H)),
                         axes=(0, 2, 1, 3))
    out = {n.output[0]: y} if n.output[0] else {}
    if len(n.output) > 1 and n.output[1]:
        out[n.output[1]] = r[1]
    if mode == "lstm" and len(n.output) > 2 and n.output[2]:
        out[n.output[2]] = r[2]
    if not out:
        out = {"_unused": y}
    return out


def import_model(onnx_file_path):
    """Load an ONNX file → (Symbol, arg_params, aux_params)."""
    from ... import symbol as symmod
    from ... import ndarray as nd

    model = pb.ModelProto()
    with open(onnx_file_path, "rb") as f:
        model.ParseFromString(f.read())
    g = model.graph
    inits = {t.name: _tensor_np(t) for t in g.initializer}
    env: dict = {}
    arg_params = {}
    for name, arr in inits.items():
        if (arr.dtype == np.int64 and arr.ndim <= 1) or arr.ndim == 0:
            # shape/axes constants and scalar attrs-as-inputs (Clip
            # min/max): plain python-side values, never parameters
            env[name] = ("const", arr)
        else:
            env[name] = ("var", symmod.var(name))
            arg_params[name] = nd.array(arr)
    for vi in g.input:
        if vi.name not in env:
            env[vi.name] = ("var", symmod.var(vi.name))
    readers = collections.Counter(
        [i for n in g.node for i in n.input if i]
        + [vi.name for vi in g.output])

    def val(name):
        kind, v = env[name]
        if kind == "const":
            return v
        return v

    def sym_of(name):
        kind, v = env[name]
        if kind == "const":
            raise MXNetError(f"{name} is a constant, not a tensor input")
        return v

    for n in g.node:
        a = _get_attrs(n)
        t = n.op_type
        ins = list(n.input)
        multi = None  # multi-output nodes set {output_name: sym}
        if t in ("LSTM", "GRU", "RNN"):
            multi = _import_rnn(symmod, nd, n, a, ins, inits, env,
                                arg_params, sym_of, readers)
            res = next(iter(multi.values()))
        elif t == "Slice":
            starts = np.asarray(val(ins[1])).ravel()
            ends = np.asarray(val(ins[2])).ravel()
            axes = (np.asarray(val(ins[3])).ravel() if len(ins) > 3
                    else np.arange(starts.size))
            if len(ins) > 4:
                steps = np.asarray(val(ins[4])).ravel()
                if (steps != 1).any():
                    raise MXNetError("Slice with steps != 1 not supported")
            res = sym_of(ins[0])
            for ax, b, e in zip(axes, starts, ends):
                res = symmod.slice_axis(res, axis=int(ax), begin=int(b),
                                        end=int(e))
        elif t in _UNARY_IMPORT:
            res = getattr(symmod, "flatten" if t == "Flatten" else _UNARY_IMPORT[t])(sym_of(ins[0])) \
                if t != "Flatten" else symmod.Flatten(sym_of(ins[0]))
        elif t in _BINARY_IMPORT:
            res = getattr(symmod, _BINARY_IMPORT[t])(sym_of(ins[0]), sym_of(ins[1]))
        elif t == "Gemm":
            alpha = float(a.get("alpha", 1.0))
            beta = float(a.get("beta", 1.0))
            trans_a = bool(a.get("transA", 0))
            trans_b = bool(a.get("transB", 0))
            bias = sym_of(ins[2]) if len(ins) > 2 else None
            w_arr = arg_params.get(ins[1])
            if (trans_b and not trans_a and alpha == 1.0
                    and (bias is None or beta == 1.0)):
                # the common (and our exporter's) convention → FC op
                num_hidden = int(w_arr.shape[0]) if w_arr is not None else 0
                res = symmod.FullyConnected(
                    sym_of(ins[0]), sym_of(ins[1]), bias,
                    num_hidden=num_hidden, no_bias=bias is None,
                    flatten=False)
            else:
                # general Gemm: alpha*op(A)·op(B) + beta*C
                A = sym_of(ins[0])
                B = sym_of(ins[1])
                res = symmod.dot(A, B, transpose_a=trans_a,
                                 transpose_b=trans_b)
                if alpha != 1.0:
                    res = res * alpha
                if bias is not None:
                    res = symmod.broadcast_add(
                        res, bias * beta if beta != 1.0 else bias)
        elif t == "MatMul":
            res = symmod.dot(sym_of(ins[0]), sym_of(ins[1]))
        elif t == "Conv":
            k = tuple(a["kernel_shape"])
            nd_ = len(k)
            pads = _sym_pads(a.get("pads"), nd_, t)
            bias = sym_of(ins[2]) if len(ins) > 2 else None
            w_arr = arg_params.get(ins[1])
            res = symmod.Convolution(
                sym_of(ins[0]), sym_of(ins[1]), bias, kernel=k,
                stride=tuple(a.get("strides", (1,) * nd_)), pad=pads,
                dilate=tuple(a.get("dilations", (1,) * nd_)),
                num_filter=int(w_arr.shape[0]) if w_arr is not None else 0,
                num_group=int(a.get("group", 1)), no_bias=bias is None)
        elif t in ("MaxPool", "AveragePool"):
            k = tuple(a["kernel_shape"])
            pads = _sym_pads(a.get("pads"), len(k), t)
            res = symmod.Pooling(
                sym_of(ins[0]), kernel=k,
                pool_type="max" if t == "MaxPool" else "avg",
                stride=tuple(a.get("strides", (1,) * len(k))), pad=pads,
                pooling_convention=("full" if int(a.get("ceil_mode", 0))
                                    else "valid"),
                # ONNX spec default: EXCLUDE padding from the average
                count_include_pad=bool(a.get("count_include_pad", 0)))
        elif t in ("GlobalMaxPool", "GlobalAveragePool"):
            res = symmod.Pooling(sym_of(ins[0]), global_pool=True,
                                 pool_type="max" if t == "GlobalMaxPool" else "avg")
        elif t == "BatchNormalization":
            res = symmod.BatchNorm(*[sym_of(i) for i in ins[:5]],
                                   eps=float(a.get("epsilon", 1e-5)),
                                   momentum=float(a.get("momentum", 0.9)),
                                   fix_gamma=False, use_global_stats=True)
        elif t == "Softmax":
            res = symmod.softmax(sym_of(ins[0]), axis=int(a.get("axis", -1)))
        elif t == "LogSoftmax":
            res = symmod.log_softmax(sym_of(ins[0]), axis=int(a.get("axis", -1)))
        elif t == "Dropout":
            res = symmod.Dropout(sym_of(ins[0]))
        elif t == "Concat":
            res = symmod.concat(*[sym_of(i) for i in ins],
                                dim=int(a.get("axis", 1)))
        elif t == "Sum":
            res = symmod.add_n(*[sym_of(i) for i in ins])
        elif t == "Reshape":
            shape = tuple(int(x) for x in val(ins[1]))
            res = symmod.reshape(sym_of(ins[0]), shape=shape)
        elif t == "Transpose":
            res = symmod.transpose(sym_of(ins[0]), axes=tuple(a.get("perm", ())))
        elif t == "Gather":
            res = symmod.Embedding(sym_of(ins[1]), sym_of(ins[0]),
                                   input_dim=0, output_dim=0)
        elif t == "Clip":
            lo = float(val(ins[1])) if len(ins) > 1 else a.get("min", 0.0)
            hi = float(val(ins[2])) if len(ins) > 2 else a.get("max", 0.0)
            res = symmod.clip(sym_of(ins[0]), a_min=lo, a_max=hi)
        elif t in ("LeakyRelu", "Elu"):
            res = symmod.LeakyReLU(
                sym_of(ins[0]),
                act_type="leaky" if t == "LeakyRelu" else "elu",
                slope=float(a.get("alpha", 0.25)))
        elif t == "Softplus":
            res = symmod.Activation(sym_of(ins[0]), act_type="softrelu")
        else:
            raise MXNetError(f"ONNX op {t!r} has no import mapping")
        if multi is not None:
            for out_name, s in multi.items():
                env[out_name] = ("var", s)
        else:
            env[n.output[0]] = ("var", res)

    outputs = [sym_of(vi.name) for vi in g.output]
    out_sym = outputs[0] if len(outputs) == 1 else symmod.Group(outputs)
    # split aux (BN running stats) from args by conventional names
    aux_params = {k: v for k, v in arg_params.items()
                  if k.endswith(("moving_mean", "moving_var",
                                 "running_mean", "running_var"))}
    for k in aux_params:
        arg_params.pop(k)
    return out_sym, arg_params, aux_params
