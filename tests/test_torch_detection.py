"""The port's detection ops (``ops/detection.py``) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go to the JAX op
(``mx.nd.contrib.<op>``) and to the port's (``nd.contrib.<op>`` on CPU
tensors). Index outputs (matches, class targets, masks, which rows NMS
keeps and their order) must be equal; values within 1e-6. Cases:
``box_iou`` in both formats; ``bipartite_matching`` with ties, both
directions, a threshold and ``topk``; every argument of ``box_nms``
(``topk``, ``force_suppress``, ``background_id`` with ``id_index``,
``in_format``/``out_format``, ``valid_thresh``), tied scores, 2-D and
4-D inputs, and N = 2000 against the JAX package's N-step loop;
``MultiBoxPrior`` on non-square maps with ``steps``, ``offsets`` and
``clip``; ``MultiBoxTarget`` with and without mining, padded labels
and tied hardness; ``MultiBoxDetection`` with and without ``nms_topk``.
The port's NMS compacts the candidates and iterates to the greedy
fixed point (its module docstring); its rounds are checked against
the suppression chains, and its host reads (the only ones the
detection ops make) are counted. One test binds ``mx.sym.contrib.MultiBox
Prior/Target/Detection`` through ``Executor`` and holds the outputs
against ``nd``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import detection as jdet
from mxnet_tpu_torch import graphs, nd, sym
from mxnet_tpu_torch.ops import detection

torch.set_num_threads(1)


_JAX = {"box_iou": "box_iou", "bipartite_matching": "bipartite_matching",
        "box_nms": "box_nms", "MultiBoxPrior": "multibox_prior",
        "MultiBoxTarget": "multibox_target",
        "MultiBoxDetection": "multibox_detection"}


def _jax(name, *arrays, **kw):
    """The JAX package's op, jitted as one program."""
    fn = jax.jit(functools.partial(getattr(jdet, _JAX[name]), **kw))
    out = fn(*[jnp.asarray(a) for a in arrays])
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o) for o in outs]


def _port(name, *arrays, **kw):
    out = getattr(nd.contrib, name)(*[torch.from_numpy(np.asarray(a))
                                      for a in arrays], **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.numpy() for o in outs]


def _same(name, *arrays, exact=(), atol=1e-6, **kw):
    """Both packages on the same inputs: outputs in ``exact`` equal,
    the others within ``atol``."""
    want = _jax(name, *arrays, **kw)
    got = _port(name, *arrays, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if i in exact:
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    return got


def _boxes(rs, n, lead=(), spread=1.0):
    xy = rs.rand(*lead, n, 2).astype(np.float32) * spread
    wh = rs.rand(*lead, n, 2).astype(np.float32) * 0.3 * spread + 0.02
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 17, (2,)), _boxes(rs, 11, (2,))
    _same("box_iou", a, b, format=fmt)


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.4, "topk": 2},
                                {"is_ascend": True, "threshold": 0.3}])
def test_bipartite_matching(kw):
    rs = np.random.RandomState(1)
    d = rs.rand(3, 7, 5).astype(np.float32)
    _same("bipartite_matching", d, exact=(0, 1), **kw)
    # ties: a few values only, so the first maximum decides
    t = rs.randint(0, 3, (2, 6, 6)).astype(np.float32) / 2
    _same("bipartite_matching", t, exact=(0, 1), **kw)


def _nms_rows(rs, n, lead=(2,), classes=3, tied=False):
    """Rows [id, score, x1, y1, x2, y2]; ``tied``: every other score
    rounded to a quarter, so ties meet untied scores."""
    boxes = _boxes(rs, n, lead, spread=1.0)
    scores = rs.rand(*lead, n, 1).astype(np.float32)
    if tied:
        scores[..., ::2, :] = np.round(scores[..., ::2, :] * 4) / 4
    ids = rs.randint(0, classes, lead + (n, 1)).astype(np.float32)
    return np.concatenate([ids, scores, boxes], -1)


@pytest.mark.parametrize("kw", [
    {},
    {"topk": 5, "force_suppress": True},
    {"id_index": 0, "background_id": 1},
    {"id_index": 0, "background_id": 0, "topk": 7, "force_suppress": True},
    {"valid_thresh": 0.4, "overlap_thresh": 0.3},
    {"in_format": "center"},
    {"out_format": "center", "id_index": 0},
])
def test_box_nms_arguments(kw):
    rs = np.random.RandomState(2)
    data = _nms_rows(rs, 40, tied=True)
    _same("box_nms", data, exact=(0,), **kw)


def test_box_nms_shapes_and_columns():
    rs = np.random.RandomState(3)
    # 2-D input, and a 4-D batch with the score and the box elsewhere
    _same("box_nms", _nms_rows(rs, 25, lead=()), exact=(0,))
    d = _nms_rows(rs, 20, lead=(2, 3))
    d = np.concatenate([d[..., 2:], d[..., 1:2], d[..., :1]], -1)
    _same("box_nms", d, exact=(0,), coord_start=0, score_index=4,
          id_index=5, overlap_thresh=0.2)
    # nothing valid
    _same("box_nms", d, exact=(0,), coord_start=0, score_index=4,
          valid_thresh=2.0)


def test_box_nms_n2000_against_the_jax_loop():
    """N = 2000 crowded boxes (long suppression chains) with tied scores
    against the JAX package's 2000-step loop."""
    rs = np.random.RandomState(4)
    data = _nms_rows(rs, 2000, lead=(1,), classes=2, tied=True)
    data[..., 2:] = _boxes(rs, 2000, (1,), spread=0.6)
    with detection.nms_record() as calls:
        out = _same("box_nms", data, exact=(0,), overlap_thresh=0.3,
                    id_index=0)[0]
    kept = int((out[0, :, 0] >= 0).sum())
    st, = calls
    assert 0 < kept < st["candidates"] == int((data[0, :, 1] > 0).sum())
    assert st["rounds"] >= 2 * detection._ROUNDS_PER_READ
    assert st["reads"] == st["rounds"] // detection._ROUNDS_PER_READ + 1


def test_nms_rounds_follow_the_chain():
    """A chain of boxes, each overlapping the next by more than the
    threshold, in falling score order: greedy keeps every other box,
    and the fixed point takes one round a link: rounds 1 to 8 change
    the mask, so the loop runs three blocks of four (the third changes
    nothing) and reads the count and three flags."""
    n = 9
    x = np.arange(n, dtype=np.float32) * 0.5
    boxes = np.stack([x, np.zeros(n), x + 1.0, np.ones(n)], -1)
    scores = np.linspace(1.0, 0.2, n).astype(np.float32)
    data = np.concatenate([np.zeros((n, 1)), scores[:, None], boxes],
                          -1).astype(np.float32)
    with detection.nms_record() as calls:
        out = _port("box_nms", data, overlap_thresh=0.3)[0]
    np.testing.assert_array_equal(out[:5, 1], scores[::2])
    assert (out[5:] == -1).all()
    assert calls == [{"candidates": n, "rounds": 12, "reads": 4}]


def test_only_nms_reads_the_device_back():
    """NMS reads its loop control through ``graphs.host_read`` (the
    count, then one flag a block of rounds), which a CachedOp's warm-up
    counts to run the key eagerly on the card; ``MultiBoxPrior``,
    ``MultiBoxTarget`` and ``box_iou`` make no such read."""
    rs = np.random.RandomState(11)
    feat = torch.zeros(1, 2, 6, 6)
    label = torch.from_numpy(_labels(rs, 2, 3, counts=(2, 3)))
    reads = graphs._host_reads()
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=(0.3, 0.5))
    n = anchors.shape[1]
    cls = torch.from_numpy(rs.randn(2, 3, n).astype(np.float32))
    nd.contrib.MultiBoxTarget(anchors, label, cls, negative_mining_ratio=3.0)
    nd.contrib.box_iou(anchors[0], label[0, :, 1:])
    assert graphs._host_reads() == reads
    loc = torch.from_numpy((rs.randn(2, n * 4) * 0.3).astype(np.float32))
    with detection.nms_record() as calls:
        nd.contrib.MultiBoxDetection(torch.softmax(cls, 1), loc, anchors)
    assert graphs._host_reads() - reads == calls[0]["reads"] >= 2


@pytest.mark.parametrize("shape,kw", [
    ((1, 3, 5, 7), {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5)}),
    ((2, 4, 6, 4), {"sizes": (0.2,), "ratios": (1.0, 3.0), "clip": True}),
    ((1, 2, 3, 5), {"sizes": (0.4, 0.7), "ratios": (2.0,),
                    "steps": (0.25, 0.125), "offsets": (0.3, 0.6)}),
    ((1, 1, 38, 38), {"sizes": (0.1, 0.141), "ratios": (1.0, 2.0, 0.5),
                      "steps": (8 / 300, 8 / 300), "clip": False}),
])
def test_multibox_prior(shape, kw):
    x = np.zeros(shape, np.float32)
    _same("MultiBoxPrior", x, **kw)


def _labels(rs, b, m, counts):
    lab = -np.ones((b, m, 5), np.float32)
    for i, k in enumerate(counts):
        box = _boxes(rs, k, spread=0.7)
        lab[i, :k, 0] = rs.randint(0, 4, k)
        lab[i, :k, 1:] = box
    return lab


@pytest.mark.parametrize("kw", [
    {},
    {"negative_mining_ratio": 3.0},
    {"negative_mining_ratio": 2.5, "minimum_negative_samples": 5,
     "negative_mining_thresh": 0.4, "ignore_label": -2.0},
    {"overlap_threshold": 0.3, "variances": (0.2, 0.2, 0.1, 0.1)},
])
def test_multibox_target(kw):
    rs = np.random.RandomState(5)
    anchors = np.asarray(_port("MultiBoxPrior", np.zeros((1, 1, 6, 6),
                                                         np.float32),
                               sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5))[0])
    n = anchors.shape[1]
    label = _labels(rs, 3, 4, counts=(1, 4, 0))
    cls = rs.randn(3, 5, n).astype(np.float32)
    cls[:, :, ::2] = np.round(cls[:, :, ::2])   # hardness ties: stable sort
    loc_t, loc_m, cls_t = _same("MultiBoxTarget", anchors, label, cls,
                                exact=(1, 2), **kw)
    assert (cls_t[2] <= 0).all() and (cls_t[1] > 0).sum() >= 4


@pytest.mark.parametrize("kw", [
    {},
    {"nms_topk": 7, "force_suppress": True, "nms_threshold": 0.3},
    {"nms_topk": 20, "threshold": 0.2, "clip": False, "background_id": 2},
])
def test_multibox_detection(kw):
    rs = np.random.RandomState(6)
    anchors = np.asarray(_port("MultiBoxPrior", np.zeros((1, 1, 5, 5),
                                                         np.float32),
                               sizes=(0.3, 0.5), ratios=(1.0, 2.0))[0])
    n = anchors.shape[1]
    logits = rs.randn(2, 4, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, n * 4) * 0.5).astype(np.float32)
    _same("MultiBoxDetection", prob.astype(np.float32), loc, anchors,
          exact=(), **kw)
    got = _port("MultiBoxDetection", prob.astype(np.float32), loc, anchors,
                **kw)[0]
    want = _jax("MultiBoxDetection", prob.astype(np.float32), loc, anchors,
                **kw)[0]
    # which rows survive, their classes and their order: equal
    np.testing.assert_array_equal(got[..., 0], want[..., 0])


def test_registry_names_and_waiting():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "box_nms", "box_iou", "bipartite_matching"):
        assert getattr(nd, name)._op is getattr(nd, "_contrib_" + name)._op
        assert not any(name in names for names in nd.WAITING.values())
    assert not detection.multibox_prior._op.differentiable
    assert detection.multibox_target._op.num_visible_outputs == 3


def test_symbol_contrib_binds_through_the_executor():
    rs = np.random.RandomState(7)
    feat = rs.rand(2, 3, 4, 4).astype(np.float32)
    label = _labels(rs, 2, 3, counts=(2, 3))
    data, lab, cls_in = (sym.var("feat"), sym.var("label"),
                         sym.var("cls"))
    anchors = sym.contrib.MultiBoxPrior(data, sizes=(0.3, 0.5),
                                        ratios=(1.0, 2.0))
    n = 4 * 4 * 3
    tgt = sym.contrib.MultiBoxTarget(anchors, lab, cls_in,
                                     negative_mining_ratio=3.0)
    prob = sym.softmax(cls_in, axis=1)
    loc = sym.var("loc")
    det = sym.contrib.MultiBoxDetection(prob, loc, anchors, nms_topk=10)
    group = sym.Group([anchors, tgt[0], tgt[1], tgt[2], det])
    cls = rs.randn(2, 3, n).astype(np.float32)
    locv = (rs.randn(2, n * 4) * 0.3).astype(np.float32)
    cpu = torch.device("cpu")
    args = {"feat": nd.array(feat, ctx=cpu), "label": nd.array(label, ctx=cpu),
            "cls": nd.array(cls, ctx=cpu), "loc": nd.array(locv, ctx=cpu)}
    ex = group.bind(cpu, args)
    outs = [o.asnumpy() for o in ex.forward()]
    a = nd.contrib.MultiBoxPrior(args["feat"], sizes=(0.3, 0.5),
                                 ratios=(1.0, 2.0))
    t = nd.contrib.MultiBoxTarget(a, args["label"], args["cls"],
                                  negative_mining_ratio=3.0)
    d = nd.contrib.MultiBoxDetection(nd.softmax(args["cls"], axis=1),
                                     args["loc"], a, nms_topk=10)
    for got, want in zip(outs, [a, *t, d]):
        np.testing.assert_array_equal(got, want.asnumpy())
