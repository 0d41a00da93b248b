"""Sequence packing for variable-length token batches.

Port of ``mxnet_tpu/io/packing.py`` (numpy only, so a copy):
``pack_sequences``, ``unpack_sequences`` and ``packing_efficiency``,
the parts encoder serving needs. The layout contract is the JAX
package's, shared with the flash-attention kernel's packed path and
the engine's batcher:

- ``data``        (R, L): tokens, first-fit-packed, padded with
                  ``pad_value``;
- ``segment_ids`` (R, L) int32: 1..n per row in placement order, 0 on
                  padding — contiguous, monotonically non-decreasing
                  within a row (what makes the kernel's whole-tile
                  segment skip tight);
- ``positions``   (R, L) int32: PER-SEGMENT 0-based positions (each
                  sequence's positional embedding restarts at 0), 0 on
                  padding;
- ``valid_length``(R,) int32: used slots per row (segments are packed
                  from position 0, so this is also the kv length the
                  kernel masks with).

Positions are bounded by each SAMPLE's length, not the row length, so
a model with a finite position table (BERT ``max_length``) can pack
into rows longer than the table as long as every sample fits it.

``pack_sequences`` is greedy first-fit in arrival order.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["PackedBatch", "Placement", "pack_sequences", "unpack_sequences",
           "packing_efficiency"]


PackedBatch = namedtuple(
    "PackedBatch",
    ["data", "segment_ids", "positions", "valid_length", "placements",
     "extras"])

# where sample i landed: data[row, offset:offset+length] (segment_ids
# there are == segment; kept per-sample so unpack is exact)
Placement = namedtuple("Placement", ["row", "offset", "length", "segment"])


def pack_sequences(sequences, seq_len, extras=None, pad_value=0,
                   dtype=None, max_rows=None):
    """Greedy first-fit packing of 1-D samples into (R, seq_len) rows.

    Parameters
    ----------
    sequences : list of 1-D arrays (the token samples), each with
        0 < len <= seq_len.
    extras : optional list of lists of 1-D arrays, each parallel to
        ``sequences`` (labels, token types, ...) and length-equal per
        sample; packed into identical layouts.
    max_rows : refuse placements that would open row max_rows+1 —
        samples that no open row can hold raise.

    Returns a :class:`PackedBatch`; ``extras`` in the result is a list
    of (R, seq_len) arrays parallel to the input extras.
    """
    seqs = [np.asarray(s).reshape(-1) for s in sequences]
    extras = [list(map(np.asarray, ex)) for ex in (extras or [])]
    for ex in extras:
        if len(ex) != len(seqs):
            raise ValueError("extras must parallel sequences")
    if dtype is None:
        dtype = seqs[0].dtype if seqs else np.int32

    used = []          # per open row: slots consumed
    counts = []        # per open row: number of segments placed
    placements = []
    for idx, s in enumerate(seqs):
        n = len(s)
        if not 0 < n <= seq_len:
            raise ValueError(
                f"sample {idx} has length {n}, outside (0, {seq_len}]")
        for ex in extras:
            if len(ex[idx]) != n:
                raise ValueError(
                    f"extra for sample {idx} has length "
                    f"{len(ex[idx])} != {n}")
        for r in range(len(used)):      # first fit
            if used[r] + n <= seq_len:
                break
        else:
            r = len(used)
            if max_rows is not None and r >= max_rows:
                raise ValueError(
                    f"sample {idx} (len {n}) does not fit in any of the "
                    f"{max_rows} allowed rows")
            used.append(0)
            counts.append(0)
        placements.append(Placement(r, used[r], n, counts[r] + 1))
        used[r] += n
        counts[r] += 1

    rows = len(used)
    data = np.full((rows, seq_len), pad_value, dtype=dtype)
    seg = np.zeros((rows, seq_len), np.int32)
    pos = np.zeros((rows, seq_len), np.int32)
    packed_extras = [
        np.zeros((rows, seq_len), ex[0].dtype if ex else np.int32)
        for ex in extras]
    for i, (s, pl) in enumerate(zip(seqs, placements)):
        sl = slice(pl.offset, pl.offset + pl.length)
        data[pl.row, sl] = s
        seg[pl.row, sl] = pl.segment
        pos[pl.row, sl] = np.arange(pl.length)
        for ex, out in zip(extras, packed_extras):
            out[pl.row, sl] = ex[i]
    valid = np.asarray(used, np.int32)
    return PackedBatch(data, seg, pos, valid, placements, packed_extras)


def unpack_sequences(packed, placements=None):
    """Restore the original sample list from a packed array.

    ``packed`` is a PackedBatch (its own placements are used) or a bare
    (R, L[, ...]) array with ``placements`` given — the latter unpacks
    any array sharing the packed layout (model outputs: per-token
    hidden states slice the same way)."""
    if placements is None:
        placements = packed.placements
        packed = packed.data
    return [np.asarray(packed)[p.row, p.offset:p.offset + p.length]
            for p in placements]


def packing_efficiency(batch):
    """Fraction of slots holding real tokens (PackedBatch or a
    segment_ids array)."""
    seg = batch.segment_ids if isinstance(batch, PackedBatch) else batch
    seg = np.asarray(seg)
    return float((seg > 0).sum()) / seg.size
