"""CTC loss: the log-domain forward algorithm as torch ops over time.

Port of ``mxnet_tpu/ops/ctc.py`` (MXNet's ``src/operator/nn/
ctc_loss.cc``). The alpha recursion walks the time axis with the batch
and the extended label sequence vectorized; the blank is index 0 and
labels use 1..C-1. Gradients are autograd's through the recursion, as
the JAX package differentiates its scan; there is no hand-written
backward (the JAX package writes no Pallas kernel for CTC, so the port
owes none).

``NEG_INF`` is the JAX package's finite -1e30, not ``-inf``: the
masked branches of :func:`_log_add` then stay finite, so autograd's
gradient has no ``0 * inf``, and an alignment that cannot exist
(more labels than frames) gives a loss of about 1e30, as in the JAX
package, not ``inf``. ``torch.nn.functional.ctc_loss`` is not used:
its CUDA backward is not deterministic and its edge cases differ.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "ctc_loss", "ctc_loss_nd"]

NEG_INF = -1e30


def _log_add(a, b):
    mx = torch.maximum(a, b)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    return torch.where(
        (a <= NEG_INF / 2) & (b <= NEG_INF / 2),
        torch.full_like(mx, NEG_INF),
        safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe)))


def ctc_loss(logits, labels, input_lengths=None, label_lengths=None):
    """``logits``: (T, N, C) unnormalized; ``labels``: (N, L), 0 the
    blank (so padding), classes 1..C-1. ``input_lengths`` frames count
    per sample (default T); ``label_lengths`` labels per sample
    (default: the count of ``labels > 0``). Returns the (N,) losses in
    float32."""
    T, N, C = logits.shape
    L = labels.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.to(torch.int64)
    if input_lengths is None:
        input_lengths = torch.full((N,), T, dtype=torch.int64, device=dev)
    else:
        input_lengths = input_lengths.to(torch.int64)
    if label_lengths is None:
        label_lengths = (labels > 0).to(torch.int64).sum(dim=1)
    else:
        label_lengths = label_lengths.to(torch.int64)

    # the extended sequence, blanks interleaved: S = 2L + 1
    S = 2 * L + 1
    ext = torch.zeros((N, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    # a skip s-2 -> s where ext[s] is a label unlike ext[s-2]
    skip_ok = torch.zeros((N, S), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != 0)
    # log p of each extended symbol at every frame: (T, N, S)
    emit = logp.gather(2, ext.unsqueeze(0).expand(T, N, S))

    neg = torch.full((N, S), NEG_INF, dtype=torch.float32, device=dev)
    alpha = neg.clone()
    alpha[:, 0] = emit[0, :, 0]
    alpha[:, 1] = torch.where(label_lengths > 0, emit[0, :, 1], neg[:, 1])
    pad1, pad2 = neg[:, :1], neg[:, :2]
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        shift2 = torch.where(skip_ok, shift2, neg)
        new = _log_add(_log_add(alpha, shift1), shift2) + emit[t]
        # a sample whose input ended keeps its alpha
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    # the total: alpha at the last label and at the blank after it
    end = 2 * label_lengths
    last = alpha.gather(1, end[:, None])[:, 0]
    second = torch.where(
        label_lengths > 0,
        alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0],
        neg[:, 0])
    return -_log_add(last, second)


def ctc_loss_nd(pred, label, pred_lengths=None, label_lengths=None):
    """The registered ``ctc_loss`` op on ``pred`` (T, N, C) and
    ``label`` (N, L), as ``gluon.loss.CTCLoss`` calls it: label lengths
    without data lengths take full-length data lengths."""
    from ..ndarray.register import get_op, invoke

    if pred_lengths is None and label_lengths is not None:
        pred_lengths = torch.full((pred.shape[1],), pred.shape[0],
                                  dtype=torch.int32, device=pred.device)
    inputs = [pred, label]
    params = {"use_data_lengths": pred_lengths is not None,
              "use_label_lengths": label_lengths is not None}
    if pred_lengths is not None:
        inputs.append(pred_lengths)
    if label_lengths is not None:
        inputs.append(label_lengths)
    return invoke(get_op("ctc_loss"), inputs, params)
