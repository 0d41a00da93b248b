"""The port's CTC loss (``ops/ctc.py``, the ``ctc_loss`` op and its
aliases, ``gluon.loss.CTCLoss``) against the JAX package's, on the CPU.

The same numpy logits and labels go through both; losses agree within
1e-5 relative and the gradients with respect to the logits (the port's
autograd against ``jax.grad`` of the JAX function) within 1e-5 of their
scale: both run the same float32 log-domain recursion. Feasible cases
are also held against ``torch.nn.functional.ctc_loss`` (an independent
implementation) at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import ctc as jctc
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import ctc as tctc

torch.set_num_threads(1)

T, N, C, L = 12, 4, 6, 4


def _case(seed, t=T, n=N, c=C, lab=L):
    rs = np.random.RandomState(seed)
    logits = rs.randn(t, n, c).astype(np.float32)
    labels = rs.randint(1, c, (n, lab)).astype(np.int32)
    lens = rs.randint(1, lab + 1, n)
    for i, k in enumerate(lens):
        labels[i, k:] = 0
    labels[0, 1] = labels[0, 0]            # a repeat needs a blank between
    return logits, labels


def _check(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def _both(logits, labels, in_lens=None, lab_lens=None):
    """(loss, d sum(loss) / d logits) of each package's function."""
    def jf(x):
        return jctc.ctc_loss(
            x, jnp.asarray(labels),
            None if in_lens is None else jnp.asarray(in_lens),
            None if lab_lens is None else jnp.asarray(lab_lens))
    jl = jf(jnp.asarray(logits))
    jg = jax.grad(lambda x: jf(x).sum())(jnp.asarray(logits))
    x = torch.from_numpy(logits.copy()).requires_grad_()
    tl = tctc.ctc_loss(
        x, torch.from_numpy(labels),
        None if in_lens is None else torch.from_numpy(in_lens),
        None if lab_lens is None else torch.from_numpy(lab_lens))
    tl.sum().backward()
    return (tl.detach().numpy(), x.grad.numpy()), \
        (np.asarray(jl), np.asarray(jg))


@pytest.mark.parametrize("lengths", ["counted", "given", "inputs"])
def test_ctc_loss_and_gradient_match_jax(lengths):
    logits, labels = _case(0)
    in_lens = lab_lens = None
    if lengths in ("given", "inputs"):
        in_lens = np.array([12, 9, 10, 7], np.int32)
    if lengths == "given":
        lab_lens = (labels > 0).sum(1).astype(np.int32)
    (tl, tg), (jl, jg) = _both(logits, labels, in_lens, lab_lens)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check(tg, jg)
    assert np.isfinite(tg).all()
    # an independent implementation on the same (feasible) cases
    il = torch.full((N,), T) if in_lens is None else \
        torch.from_numpy(in_lens).long()
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), il,
        torch.from_numpy((labels > 0).sum(1)).long(), blank=0,
        reduction="none")
    np.testing.assert_allclose(tl, want.numpy(), rtol=1e-4)


def test_ctc_infeasible_alignment_is_finite_as_jax():
    """More labels (with repeats) than frames: no alignment exists. The
    finite NEG_INF gives ~1e30, as in the JAX package, and a gradient
    free of NaN."""
    logits, labels = _case(1, t=3, n=2, lab=4)
    labels[:] = [[1, 1, 2, 3], [2, 3, 0, 0]]
    (tl, tg), (jl, jg) = _both(logits, labels)
    assert tl[0] > 1e29 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tg).all()
    _check(tg, jg)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN"),
                                                 ("TNC", "NT")])
@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_gluon_loss_matches_jax(layout, label_layout, weighted):
    logits, labels = _case(2)
    pred = logits if layout == "TNC" else logits.swapaxes(0, 1)
    lab = labels if label_layout == "NT" else labels.T
    sw = np.array([1.0, 0.5, 2.0, 0.0], np.float32) if weighted else None
    jl = jloss.CTCLoss(layout, label_layout, weight=0.7)
    jx = jmx.nd.array(pred)
    jx.attach_grad()
    with jmx.autograd.record():
        jout = jl(jx, jmx.nd.array(lab), None, None,
                  None if sw is None else jmx.nd.array(sw))
    jout.backward()
    tl = tloss.CTCLoss(layout, label_layout, weight=0.7)
    with tmx.cpu():
        tx = tmx.nd.array(pred)
        tx.attach_grad()
        with tag.record():
            tout = tl(tx, tmx.nd.array(lab), None, None,
                      None if sw is None else tmx.nd.array(sw))
        tout.backward()
    assert tout.shape == (N,)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-5)
    _check(tx.grad.asnumpy(), jx.grad.asnumpy())


@pytest.mark.parametrize("name", ["ctc_loss", "CTCLoss",
                                  "_contrib_ctc_loss"])
@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_registry_names_match_jax(name, blank):
    """The op and its aliases, with data and label lengths, and the
    ``blank_label="last"`` alphabet (labels 0..C-2, padding -1)."""
    logits, labels = _case(3)
    if blank == "last":
        labels = labels - 1                 # 0 padding becomes -1
    dl = np.array([12, 11, 8, 12], np.int32)
    ll = (labels >= (0 if blank == "last" else 1)).sum(1).astype(np.int32)
    params = dict(use_data_lengths=True, use_label_lengths=True,
                  blank_label=blank)
    want = getattr(jmx.nd, name)(jmx.nd.array(logits), jmx.nd.array(labels),
                                 jmx.nd.array(dl), jmx.nd.array(ll),
                                 **params)
    with tmx.cpu():
        got = getattr(tmx.nd, name)(tmx.nd.array(logits),
                                    tmx.nd.array(labels), tmx.nd.array(dl),
                                    tmx.nd.array(ll), **params)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5)


def test_ctc_symbol_infers_and_runs():
    sym = tmx.sym
    out = sym.ctc_loss(sym.var("data"), sym.var("label"))
    assert out.infer_shape(data=(T, N, C), label=(N, L))[1] == [(N,)]
