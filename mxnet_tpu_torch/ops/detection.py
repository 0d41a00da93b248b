"""SSD-family detection operators: anchors, target matching, NMS.

Port of ``mxnet_tpu/ops/detection.py`` (the reference's
``src/operator/contrib/multibox_{prior,target,detection}`` and
``bounding_box.cc``): ``box_iou``, ``bipartite_matching``, ``box_nms``,
``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection``, each
registered under its plain and its ``_contrib_`` name, none
differentiable. The output contract is the JAX package's: fixed output
shapes, suppressed rows all -1, survivors sorted by score (ties by
their index: every ranking sort here is stable, as ``jnp.argsort`` is,
and every ``argmax`` takes the first maximum).

Everything computes with torch ops on the input's device; no op reads
a tensor back to the host except NMS, which reads loop-control scalars
(``graphs.host_read``: a CachedOp or a bound executor whose forward
makes such a read runs that forward eagerly, since a CUDA graph cannot
hold it). The JAX package walks the N score-sorted rows one at a time
(a ``fori_loop`` of N steps over an N x N IoU matrix). Here the
candidates are compacted first (only valid rows can survive or
suppress: a stable sort puts them first, and one host read gives their
largest count K per image), and then the keep mask is the fixed point of
``keep <- valid & ~(S^T keep)``, where S is the K x K strictly upper
triangular "row i suppresses row j" matrix in score order. Greedy NMS is
that iteration's unique fixed point, and round t fixes every row whose
chain of suppressors is at most t long, so it is reached in at most
chain-length rounds; the loop runs them in blocks of
``_ROUNDS_PER_READ`` and reads one flag after each block: whether the
block changed the mask. :func:`nms_record` collects, for the calling
thread, each call's candidates, rounds run and host reads.
``MultiBoxTarget``'s greedy matching runs M steps (the label's padded
object count), batched over images, and makes no host read at all.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import graphs
from ..ndarray.register import register_op

__all__ = ["bipartite_matching", "box_iou", "box_nms", "multibox_detection",
           "multibox_prior", "multibox_target", "nms_keep", "nms_record"]

_INF = float("inf")
# elements of one float temporary while the suppression matrix is built
_BUILD_BUDGET = 1 << 26
# elements of one bool temporary of a suppression round
_ROUND_BUDGET = 1 << 28
_ROUNDS_PER_READ = 4
_RECORD = threading.local()


@contextlib.contextmanager
def nms_record():
    """Within the scope, each NMS call of the calling thread appends
    ``{"candidates", "rounds", "reads"}`` to the list it yields: the
    compacted candidate count K, the rounds run (whole blocks of
    ``_ROUNDS_PER_READ``, the last of which changed nothing) and the
    host reads. They are counted on the host: recording reads nothing
    more from the device."""
    prev = getattr(_RECORD, "calls", None)
    _RECORD.calls = calls = []
    try:
        yield calls
    finally:
        _RECORD.calls = prev


def _note(**stats):
    calls = getattr(_RECORD, "calls", None)
    if calls is not None:
        calls.append(stats)


def _scalar(x, ref):
    """``x`` as a 0-d tensor of ``ref``'s type and device. Dividing by it
    is a true division on either device (CUDA divides by a host scalar
    through its reciprocal), and it costs no copy to the card."""
    return torch.full((), x, dtype=ref.dtype, device=ref.device)


# ---------------------------------------------------------------------------
# box format helpers
# ---------------------------------------------------------------------------
def _corner_to_center(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return (b[..., 0] + w * 0.5, b[..., 1] + h * 0.5, w, h)


def _iou_corner(a, b, eps=1e-12):
    """IoU of corner boxes a (..., N, 4) and b (..., M, 4): (..., N, M)."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    return inter / (area_a + area_b - inter + eps)


def _to_corner(b, in_format):
    if in_format == "center":
        x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    return b


def _from_corner(b, out_format):
    if out_format == "center":
        x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                           -1)
    return b


# ---------------------------------------------------------------------------
# box_iou / bipartite matching
# ---------------------------------------------------------------------------
@register_op("_contrib_box_iou", aliases=("box_iou",), differentiable=False)
def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    return _iou_corner(_to_corner(lhs, format), _to_corner(rhs, format))


def _greedy_pairs(score, steps, ok_fn):
    """``steps`` rounds of: take each matrix's first largest live entry
    (b, r, c) of ``score`` (G, N, M); where ``ok_fn(best)`` holds, match
    r to c and retire row r and column c. Returns (row match (G, N),
    col match (G, M)), -1 where unmatched; no host read."""
    g, n, m = score.shape
    dev = score.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    row_m = torch.full((g, n), -1, dtype=torch.long, device=dev)
    col_m = torch.full((g, m), -1, dtype=torch.long, device=dev)
    dead_r = torch.zeros((g, n), dtype=torch.bool, device=dev)
    dead_c = torch.zeros((g, m), dtype=torch.bool, device=dev)
    for _ in range(steps):
        live = score.masked_fill(dead_r[:, :, None] | dead_c[:, None, :],
                                 -_INF).reshape(g, -1)
        flat = live.argmax(1)
        best = live.gather(1, flat[:, None])[:, 0]
        r, c = flat // m, flat % m
        ok = ok_fn(best)[:, None]
        hit_r = (rows == r[:, None]) & ok
        hit_c = (cols == c[:, None]) & ok
        row_m = torch.where(hit_r, c[:, None], row_m)
        col_m = torch.where(hit_c, r[:, None], col_m)
        dead_r |= hit_r
        dead_c |= hit_c
    return row_m, col_m


@register_op("_contrib_bipartite_matching", aliases=("bipartite_matching",),
             differentiable=False, num_visible_outputs=2)
def bipartite_matching(dist, is_ascend=False, threshold=None, topk=-1):
    """Greedy bipartite matching on a pairwise score matrix (reference
    bounding_box.cc BipartiteMatching): take the globally best (row,
    col) pair, retire both, repeat. Returns (row_match, col_match) in
    ``dist``'s type, -1 where unmatched; leading dimensions are matched
    independently."""
    if dist.dim() < 2:
        raise ValueError("bipartite_matching expects a >=2-D dist matrix")
    lead = tuple(dist.shape[:-2])
    n, m = dist.shape[-2:]
    k = min(n, m) if topk is None or topk < 0 else min(topk, min(n, m))
    sign = 1.0 if not is_ascend else -1.0
    d = dist.reshape((-1, n, m))
    # sign-flip first, then mask NaN (a NaN under is_ascend never matches)
    score = torch.where(torch.isnan(d), -_INF, d * sign)

    def ok_fn(best):
        ok = best > -_INF
        if threshold is not None:
            dval = best * sign
            ok = ok & (dval <= threshold if is_ascend else dval >= threshold)
        return ok

    row_m, col_m = _greedy_pairs(score, k, ok_fn)
    return (row_m.to(dist.dtype).reshape(lead + (n,)),
            col_m.to(dist.dtype).reshape(lead + (m,)))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------
def _suppressors(boxes, ids, thresh, force_suppress):
    """T (G, K, K) bool: T[g, j, i] when row i < j of the score-sorted
    boxes suppresses row j (IoU above ``thresh``, same id unless
    ``force_suppress``); built a block of rows at a time."""
    g, k = boxes.shape[:2]
    t = torch.empty((g, k, k), dtype=torch.bool, device=boxes.device)
    idx = torch.arange(k, device=boxes.device)
    step = max(1, _BUILD_BUDGET // max(g * k, 1))
    for j0 in range(0, k, step):
        j1 = min(k, j0 + step)
        s = _iou_corner(boxes[:, j0:j1], boxes) > thresh
        if not force_suppress:
            s &= ids[:, j0:j1, None] == ids[:, None, :]
        s &= idx[None, :] < idx[j0:j1, None]
        t[:, j0:j1] = s
    return t


def _greedy_keep(boxes, ids, valid, thresh, force_suppress):
    """Greedy NMS's keep mask (G, K) over rows already in score order
    (module docstring), and the blocks of rounds it ran."""
    g, k = valid.shape
    t = _suppressors(boxes, ids, thresh, force_suppress)
    chunk = max(1, _ROUND_BUDGET // max(k * k, 1))
    keep = valid
    blocks = 0
    while True:
        start = keep
        for _ in range(_ROUNDS_PER_READ):
            keep = torch.cat([
                valid[g0:g0 + chunk] & ~(t[g0:g0 + chunk]
                                         & keep[g0:g0 + chunk, None, :]
                                         ).any(-1)
                for g0 in range(0, g, chunk)])
        blocks += 1
        # a state that repeats after a block is the fixed point: every
        # start reaches the unique fixed point within K rounds, so the
        # iteration has no cycle
        if not graphs.host_read((keep != start).any()):
            return keep, blocks


def nms_keep(boxes, scores, ids, valid, thresh, force_suppress, topk=-1):
    """Greedy NMS over (G, N) rows (boxes corner (G, N, 4)), highest
    score first, ties by index; only ``valid`` rows survive or suppress,
    and with ``topk > 0`` only the ``topk`` best of them. Returns
    (order (G, K), keep (G, K)): the K candidate rows' indices in score
    order, and which of them survive."""
    g, n = valid.shape
    masked = torch.where(valid, scores, -_INF)
    order = torch.argsort(masked, dim=-1, descending=True, stable=True)
    # the candidates' count: one host read, the compacted width
    k = graphs.host_read(valid.sum(-1).max()) if n and g else 0
    if topk is not None and topk > 0:
        k = min(k, int(topk))
    order = order[:, :k]
    vk = torch.gather(valid, 1, order)
    if k == 0:
        _note(candidates=0, rounds=0, reads=1 if n and g else 0)
        return order, vk
    bk = torch.gather(boxes, 1, order[:, :, None].expand(-1, -1, 4))
    ik = torch.gather(ids, 1, order)
    keep, blocks = _greedy_keep(bk, ik, vk, thresh, force_suppress)
    _note(candidates=k, rounds=blocks * _ROUNDS_PER_READ, reads=blocks + 1)
    return order, keep


def _emit(rows, order, keep):
    """(G, N, W): each group's kept rows in score order, then -1 rows."""
    g, n, w = rows.shape
    out = rows.new_full((g, n + 1, w), -1)
    if order.shape[1]:
        dest = torch.where(keep, torch.cumsum(keep, 1) - 1, n)
        src = torch.gather(rows, 1, order[:, :, None].expand(-1, -1, w))
        out.scatter_(1, dest[:, :, None].expand(-1, -1, w), src)
    return out[:, :n]


@register_op("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Suppressed entries become all -1 rows; survivors are sorted by
    score descending (reference bounding_box.cc contract)."""
    shape = tuple(data.shape)
    rows = data.reshape((-1,) + shape[-2:])
    scores = rows[:, :, score_index]
    boxes = _to_corner(rows[:, :, coord_start:coord_start + 4], in_format)
    ids = rows[:, :, id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= ids != background_id
    order, keep = nms_keep(boxes, scores, ids, valid, overlap_thresh,
                           bool(force_suppress), topk)
    if out_format != in_format:
        rows = rows.clone()
        rows[:, :, coord_start:coord_start + 4] = _from_corner(
            _to_corner(rows[:, :, coord_start:coord_start + 4], in_format),
            out_format)
    return _emit(rows, order, keep).reshape(shape)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
@register_op("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
             differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes for a (B, C, H, W) feature map, corner format in
    [0, 1]: per cell, sizes[k] x ratios[0] for all k plus sizes[0] x
    ratios[j] for j > 0 (reference multibox_prior-inl.h ordering).
    ``steps`` and ``offsets`` are (y, x)."""
    sizes = tuple(float(s) for s in (sizes if isinstance(sizes, (tuple, list))
                                     else (sizes,)))
    ratios = tuple(float(r) for r in (ratios if isinstance(ratios,
                                                           (tuple, list))
                                      else (ratios,)))
    h, w = int(data.shape[-2]), int(data.shape[-1])
    step_y = 1.0 / h if steps[0] < 0 else float(steps[0])
    step_x = 1.0 / w if steps[1] < 0 else float(steps[1])
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + float(offsets[0])) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + float(offsets[1])) * step_x
    # the reference scales the half-WIDTH by the map's aspect (h / w) so a
    # size means the same image fraction on both axes of a non-square map
    aspect = float(h) / float(w)
    half = [(s * aspect * (ratios[0] ** 0.5) / 2.0,
             s / (ratios[0] ** 0.5) / 2.0) for s in sizes]
    half += [(sizes[0] * aspect * (r ** 0.5) / 2.0,
              sizes[0] / (r ** 0.5) / 2.0) for r in ratios[1:]]
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    anchors = torch.stack([torch.stack([gx - hw, gy - hh, gx + hw, gy + hh],
                                       -1) for hw, hh in half], -2)
    anchors = anchors.reshape(1, -1, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
@register_op("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
             differentiable=False, num_visible_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth and emit training targets
    (reference multibox_target-inl.h): anchor (1, N, 4) corner, label
    (B, M, 5) rows [cls x1 y1 x2 y2] (cls -1 pads), cls_pred
    (B, num_cls + 1, N). Returns loc_target (B, N * 4), loc_mask
    (B, N * 4) and cls_target (B, N): class + 1 where matched, 0 for
    background, ``ignore_label`` for negatives mining left out.

    A greedy bipartite pass gives every GT its best anchor, then an
    unmatched anchor takes its best GT if their IoU reaches
    ``overlap_threshold``. Mining keeps ``int32(ratio * positives)``
    (at least ``minimum_negative_samples``) of the hardest negatives
    (best foreground score minus background score) among unmatched
    anchors whose best IoU is below ``negative_mining_thresh``.
    Unmatched anchors encode their offsets against GT 0, then are
    masked, as in the JAX package."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    b, m = label.shape[0], label.shape[1]
    acx, acy, aw, ah = _corner_to_center(anchors)
    gt_valid = label[:, :, 0] >= 0
    gt_boxes = label[:, :, 1:5]
    iou = _iou_corner(anchors[None], gt_boxes)          # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)

    # pass 1: greedy bipartite, each valid GT claims its best anchor
    match, _ = _greedy_pairs(iou, m, lambda best: best > 0.0)
    # pass 2: threshold matching for the still-unmatched anchors
    best_iou, best_gt = iou.max(2)
    thr_ok = (match < 0) & (best_iou >= overlap_threshold)
    match = torch.where(thr_ok, best_gt, match)
    matched = match >= 0
    midx = match.clamp_min(0)
    cls_t = torch.where(matched, label[:, :, 0].gather(1, midx) + 1.0, 0.0)

    if negative_mining_ratio > 0:
        num_pos = matched.sum(1)
        max_neg = (num_pos.to(torch.float64) * float(negative_mining_ratio)
                   ).to(torch.int32).clamp_min(int(minimum_negative_samples))
        neg_cand = ~matched & (best_iou < negative_mining_thresh)
        hardness = torch.where(neg_cand,
                               cls_pred[:, 1:].max(1).values - cls_pred[:, 0],
                               -_INF)
        order = torch.argsort(hardness, dim=1, descending=True, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=order.device).expand(b, n))
        keep_neg = neg_cand & (rank < max_neg[:, None])
        cls_t = torch.where(~matched & ~keep_neg, float(ignore_label), cls_t)

    # localization target: variance-encoded center-form offsets
    g = gt_boxes.gather(1, midx[:, :, None].expand(-1, -1, 4))
    gcx, gcy, gw, gh = _corner_to_center(g)
    eps = 1e-8
    aw_e, ah_e = aw.clamp_min(eps), ah.clamp_min(eps)
    var = [_scalar(float(v), anchors) for v in variances]
    loc_t = torch.stack([(gcx - acx) / aw_e / var[0],
                         (gcy - acy) / ah_e / var[1],
                         torch.log(gw.clamp_min(eps) / aw_e) / var[2],
                         torch.log(gh.clamp_min(eps) / ah_e) / var[3]], -1)
    loc_t = torch.where(matched[:, :, None], loc_t, 0.0).reshape(b, -1)
    loc_m = matched[:, :, None].expand(-1, -1, 4).to(torch.float32) \
        .reshape(b, -1)
    return loc_t, loc_m, cls_t


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
@register_op("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
             differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode predictions into detections (B, N, 6) rows
    [class_id, score, x1, y1, x2, y2]; pruned and suppressed rows are -1
    (reference multibox_detection-inl.h). ``nms_topk`` keeps the top-k
    candidates before suppression: discarded ranks neither survive nor
    suppress."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    bsz = cls_prob.shape[0]
    acx, acy, aw, ah = _corner_to_center(anchors)
    v = [float(x) for x in variances]
    off = loc_pred.reshape(bsz, n, 4)
    cx = off[..., 0] * v[0] * aw + acx
    cy = off[..., 1] * v[1] * ah + acy
    w = torch.exp(off[..., 2] * v[2]) * aw
    h = torch.exp(off[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], 1)
    score, cls_id = fg.max(1)
    cls_id = cls_id.to(torch.float32)
    valid = score > threshold
    rows = torch.cat([cls_id[..., None], score[..., None], boxes], -1)
    order, keep = nms_keep(boxes, score, cls_id, valid, nms_threshold,
                           bool(force_suppress), nms_topk)
    return _emit(rows, order, keep)
