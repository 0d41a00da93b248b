"""Fused RNN operator: the op behind ``gluon.rnn.LSTM``, ``GRU`` and
``RNN``.

Port of ``mxnet_tpu/ndarray/op_impl_rnn.py`` (the ``RNN`` op, MXNet's
``src/operator/rnn.cc`` analog). The packed parameter layout is kept:
every (layer, direction)'s ``W_i2h`` then ``W_h2h``, layer-major, then
every ``b_i2h`` then ``b_h2h`` (cuDNN's canonical order), so the op's
signature and a packed weight vector match the JAX op's. Gate order:
LSTM (i, f, g, o), GRU (r, z, n), vanilla one gate.

``mode="lstm"``: each layer and direction computes its input
projections for the whole sequence in one product, ``gin = x @ W_i2h^T
+ b_i2h + b_h2h`` (plain torch, as the JAX package leaves it to XLA),
then runs the recurrence in ``ops.lstm.lstm_layer_fused``: K6a forward
and K6b backward on the card, their plain per-step versions on the CPU.
The op takes that path for every layer of the kernels' types
(float32/bfloat16/float16, any H: past one unit group an SM the
kernels' blocks walk several), decided before any launch. A float64
layer, which the kernels do not take, runs the JAX op's ``lax.scan``
cell as a per-step loop in the input's type, differentiable by
autograd.

``mode="gru"``, ``"rnn_tanh"`` and ``"rnn_relu"``: the JAX op computes
them with composed XLA math and no Pallas kernel, so the port runs each
layer and direction through torch's own one-layer RNN
(``torch._VF.gru``/``rnn_tanh``/``rnn_relu``: cuDNN on the card). Its
equations are the JAX cell's: GRU ``r, z = sigmoid(x_{r,z} + h_{r,z})``,
``n = tanh(x_n + r * (W_hn h + b_hn))``, ``h' = (1 - z) * n + z * h``;
vanilla ``h' = act(x W_i2h^T + b_i2h + h W_h2h^T + b_h2h)``.

A reverse direction flips the sequence before and after; its final
state is the last step it PROCESSED (``out[-1]`` before the flip back).
Dropout falls between layers, in training only; ``lstm_state_clip_min/
max`` clip the final c. ``projection_size`` and
``use_sequence_length`` raise: the JAX op accepts and ignores them,
which would give a wrong answer silently.

:func:`rnn_layers` takes the per-(layer, direction) tensors directly,
so the Gluon layers never pack their weights; :func:`rnn` is the op on
the packed vector, registered as ``RNN`` (``mx.nd.RNN``).
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..ops import lstm as _lstm
from ..ops._build import DTYPE_CODES
from .register import register_op

__all__ = ["pack_rnn_params", "rnn", "rnn_layers", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


# the one-layer torch RNN of each mode that is not LSTM's
_VF_RNN = {"gru": "gru", "rnn_tanh": "rnn_tanh", "rnn_relu": "rnn_relu"}
# cuDNN gathers the four tensors of a layer into its own buffer at each
# call, and says so; they are the Gluon layer's parameters, which keep
# their own storage by design. torch names the calling file, not the
# module, as the warning's origin.
warnings.filterwarnings(
    "ignore", message="RNN module weights are not part of single",
    category=UserWarning,
    module=r".*mxnet_tpu_torch[./]ndarray[./]op_impl_rnn")


def _check_mode(mode):
    if mode not in _GATES:
        raise ValueError(f"unknown RNN mode {mode!r}")


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total packed parameter count (reference GetRnnParamSize)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (isz + state_size)   # weights
    size += num_layers * dirs * gates * state_size * 2            # biases
    return size


def _unpack_params(params, num_layers, input_size, state_size, bidirectional,
                   mode):
    """Views into the packed vector: ``[(w_i2h, w_h2h, b_i2h, b_h2h)]``
    per (layer, direction), layer-major."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    hid = state_size
    want = rnn_param_size(num_layers, input_size, state_size, bidirectional,
                          mode)
    if params.ndim != 1 or params.numel() != want:
        raise ValueError(f"packed RNN parameters must be ({want},), got "
                         f"{tuple(params.shape)}")
    idx = 0
    weights = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hid * dirs
        for _ in range(dirs):
            w_i2h = params[idx: idx + gates * hid * isz].reshape(gates * hid,
                                                                 isz)
            idx += gates * hid * isz
            w_h2h = params[idx: idx + gates * hid * hid].reshape(gates * hid,
                                                                 hid)
            idx += gates * hid * hid
            weights.append((w_i2h, w_h2h))
    out = []
    for w_i2h, w_h2h in weights:
        b_i2h = params[idx: idx + gates * hid]
        idx += gates * hid
        b_h2h = params[idx: idx + gates * hid]
        idx += gates * hid
        out.append((w_i2h, w_h2h, b_i2h, b_h2h))
    return out


def pack_rnn_params(layer_params, mode="lstm"):
    """Concatenate per-(layer, direction) ``(w_i2h, w_h2h, b_i2h,
    b_h2h)`` into the packed vector (weights first, then biases)."""
    _check_mode(mode)
    ws, bs = [], []
    for w_i2h, w_h2h, b_i2h, b_h2h in layer_params:
        ws += [w_i2h.reshape(-1), w_h2h.reshape(-1)]
        bs += [b_i2h.reshape(-1), b_h2h.reshape(-1)]
    return torch.cat(ws + bs)


def _scan(gx, w_h2h, b_h2h, h0, c0):
    """The JAX op's ``lax.scan`` LSTM cell, a step at a time: gates
    ``gx[t] + h @ W_h2h^T + b_h2h`` in gate order (i, f, g, o), carry in
    the input's type. Returns ``(out, c_last)``."""
    h, c = h0, c0
    outs = []
    for t in range(gx.shape[0]):
        i, f, g, o = (gx[t] + h @ w_h2h.t() + b_h2h).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs), c


def _run_layer(x, w_i2h, w_h2h, b_i2h, b_h2h, h0, c0, reverse=False,
               mode="lstm"):
    """One direction of one layer. x (T, N, I) -> out (T, N, H), h_last,
    c_last (None but for LSTM)."""
    if reverse:
        x = torch.flip(x, dims=(0,))
    if mode != "lstm":
        fn = getattr(torch._VF, _VF_RNN[mode])
        # train: cuDNN keeps what its backward needs only in training
        # mode; no dropout inside the one layer
        out, h_n = fn(x, h0.unsqueeze(0), [w_i2h, w_h2h, b_i2h, b_h2h],
                      True, 1, 0.0, torch.is_grad_enabled(), False, False)
        h_last, c_last = h_n[0], None
    elif x.dtype in DTYPE_CODES:
        gin = (F.linear(x, w_i2h, b_i2h) + b_h2h).to(x.dtype)
        out, cseq = _lstm.lstm_layer_fused(gin, w_h2h.t(), h0, c0)
        h_last, c_last = out[-1], cseq[-1].to(c0.dtype)
    else:
        out, c_last = _scan(F.linear(x, w_i2h, b_i2h), w_h2h, b_h2h, h0,
                            c0)
        h_last = out[-1]
    if reverse:
        out = torch.flip(out, dims=(0,))
    return out, h_last, c_last


def rnn_layers(data, layer_params, state, state_cell, num_layers=1,
               bidirectional=False, p=0.0, training=False,
               lstm_state_clip_min=None, lstm_state_clip_max=None,
               mode="lstm"):
    """The RNN of ``mode`` over ``data`` (T, N, I) from per-(layer,
    direction) ``(w_i2h, w_h2h, b_i2h, b_h2h)`` (layer-major, as packed)
    and the (L * D, N, H) states (``state_cell`` for LSTM alone).
    Returns ``(output, h_out, c_out)``, ``c_out`` None but for LSTM."""
    _check_mode(mode)
    dirs = 2 if bidirectional else 1
    if len(layer_params) != num_layers * dirs:
        raise ValueError(f"{num_layers} layers x {dirs} directions need "
                         f"{num_layers * dirs} parameter sets, got "
                         f"{len(layer_params)}")
    lstm = mode == "lstm"
    if lstm and state_cell is None:
        raise ValueError("LSTM mode needs state_cell")
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            sidx = layer * dirs + d
            out, h_last, c_last = _run_layer(
                x, *layer_params[sidx], state[sidx],
                state_cell[sidx] if lstm else None, reverse=d == 1,
                mode=mode)
            outs.append(out)
            h_states.append(h_last)
            c_states.append(c_last)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and training and layer < num_layers - 1:
            x = F.dropout(x, p, training=True)
    h_out = torch.stack(h_states)
    if not lstm:
        return x, h_out, None
    c_out = torch.stack(c_states)
    if lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        c_out = c_out.clamp(lstm_state_clip_min, lstm_state_clip_max)
    return x, h_out, c_out


@register_op("RNN", infer_num_outputs=lambda params: 3 if str(
    params.get("mode", "lstm")) == "lstm" else 2)
def rnn(data, parameters, state, state_cell=None, sequence_length=None,
        state_size=0, num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, _training=False):
    """The ``RNN`` op. data (T, N, I); parameters the packed vector;
    state, state_cell (L * D, N, H; state_cell for LSTM alone). Returns
    ``(output, state_out, statecell_out)`` for LSTM, ``(output,
    state_out)`` for the other modes."""
    _check_mode(mode)
    if projection_size is not None or use_sequence_length:
        raise NotImplementedError("RNN projection_size and "
                                  "use_sequence_length are not implemented "
                                  "(the JAX op ignores them)")
    _, _, input_size = data.shape
    layer_params = _unpack_params(parameters, int(num_layers), input_size,
                                  int(state_size), bidirectional, mode)
    out, h, c = rnn_layers(data, layer_params, state, state_cell,
                           int(num_layers), bidirectional, p, _training,
                           lstm_state_clip_min, lstm_state_clip_max, mode)
    return (out, h, c) if mode == "lstm" else (out, h)
