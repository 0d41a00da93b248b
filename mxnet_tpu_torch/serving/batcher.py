"""Shape buckets of both serving paths.

- :class:`ContinuousBatcher` first-fit-packs drained encoder requests
  into a small closed set of (rows, row_len) shapes and emits a
  :class:`PackedPlan`: the row length is the smallest configured
  bucket that holds the longest request, the row COUNT is rounded up
  to a power of two (capped at ``max_rows``), padding with 1-token
  dummy rows. Within a row, requests are isolated by the flash
  kernel's ``segment_ids`` path.
- :class:`DecodeSlots` (rows x page-table width) and
  :class:`PrefillChunks` (chunk x page-table width) bound the decode
  loop's shapes.

A port of ``mxnet_tpu/serving/batcher.py``. The buckets bound the
shapes the kernels and the engines' cost ledgers see (a hybridized
model captures one CUDA graph per bucket, as the JAX package compiles
one executable), and keep the scheduling identical to the JAX
package's.
"""
from __future__ import annotations

import numpy as np

from ..io.packing import pack_sequences

__all__ = ["ContinuousBatcher", "DecodeSlots", "PackedPlan",
           "PrefillChunks"]


class PackedPlan:
    """One dispatchable batch: packed arrays + request placements."""

    __slots__ = ("data", "token_types", "segment_ids", "positions",
                 "valid_length", "entries", "rows", "row_len",
                 "valid_tokens", "pad_rows")

    def __init__(self, data, token_types, segment_ids, positions,
                 valid_length, entries, pad_rows):
        self.data = data
        self.token_types = token_types
        self.segment_ids = segment_ids
        self.positions = positions
        self.valid_length = valid_length
        self.entries = entries            # [(request, Placement)]
        self.rows, self.row_len = data.shape
        self.valid_tokens = sum(len(r) for r, _ in entries)
        self.pad_rows = pad_rows

    @property
    def packing_efficiency(self):
        return self.valid_tokens / float(self.rows * self.row_len)


class ContinuousBatcher:
    """Stateless planner: ``plan(requests)`` -> (PackedPlan, leftovers).

    Leftovers are requests that did not fit this batch (all rows full);
    the engine carries them into the next iteration at the front of the
    line — nothing is ever dropped here (dropping is the queue's and
    deadline checker's job, where it is loud).
    """

    def __init__(self, bucket_lens=(64, 256, 1024), max_rows=8,
                 quantize_rows=True, pad_value=0):
        lens = sorted(set(int(b) for b in bucket_lens))
        if not lens or lens[0] < 1:
            raise ValueError(f"bad bucket_lens {bucket_lens!r}")
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.bucket_lens = tuple(lens)
        self.max_len = lens[-1]
        self.max_rows = int(max_rows)
        self.quantize_rows = quantize_rows
        self.pad_value = pad_value

    def shape_universe(self):
        """Every (rows, row_len) this batcher can emit, enumerable up
        front for warmup."""
        rows = (_pow2_up_to(self.max_rows) if self.quantize_rows
                else list(range(1, self.max_rows + 1)))
        return [(r, b) for b in self.bucket_lens for r in rows]

    def _bucket_for(self, n):
        for b in self.bucket_lens:
            if n <= b:
                return b
        return None

    def _quantized_rows(self, used_rows):
        if not self.quantize_rows:
            return used_rows
        r = 1
        while r < used_rows:
            r *= 2
        return min(r, self.max_rows)

    def plan(self, requests):
        """First-fit as many of ``requests`` (in order) as fit
        ``max_rows`` rows of the chosen bucket length."""
        if not requests:
            return None, []
        row_len = self._bucket_for(max(len(r) for r in requests))
        if row_len is None:
            # the engine rejects oversize requests at admission; this
            # guards direct batcher users
            fits = [r for r in requests if len(r) <= self.max_len]
            rest = [r for r in requests if len(r) > self.max_len]
            plan, leftover = self.plan(fits)
            return plan, leftover + rest
        used = []                       # slots consumed per open row
        accepted, leftover = [], []
        for r in requests:
            n = len(r)
            for i in range(len(used)):  # first fit
                if used[i] + n <= row_len:
                    used[i] += n
                    accepted.append(r)
                    break
            else:
                if len(used) < self.max_rows:
                    used.append(n)
                    accepted.append(r)
                else:
                    leftover.append(r)
        tts = [r.token_types if r.token_types is not None
               else np.zeros(len(r), np.int32) for r in accepted]
        batch = pack_sequences([r.tokens for r in accepted], row_len,
                               extras=[tts], pad_value=self.pad_value,
                               dtype=np.int32, max_rows=self.max_rows)
        rows = self._quantized_rows(batch.data.shape[0])
        pad_rows = rows - batch.data.shape[0]
        data = _pad_rows(batch.data, pad_rows, self.pad_value)
        seg = _pad_rows(batch.segment_ids, pad_rows, 0)
        pos = _pad_rows(batch.positions, pad_rows, 0)
        tt = _pad_rows(batch.extras[0], pad_rows, 0)
        vl = np.concatenate([batch.valid_length,
                             np.ones(pad_rows, np.int32)]) \
            if pad_rows else batch.valid_length
        # dummy rows carry ONE 1-token segment so no row reaches the
        # kernel with zero valid keys (an all-masked softmax row)
        seg[batch.data.shape[0]:, 0] = 1
        return PackedPlan(data, tt, seg, pos, vl,
                          list(zip(accepted, batch.placements)),
                          pad_rows), leftover


def _pad_rows(arr, pad_rows, fill):
    if not pad_rows:
        return arr
    return np.concatenate(
        [arr, np.full((pad_rows,) + arr.shape[1:], fill, arr.dtype)])


def _pow2_up_to(cap):
    out, v = [], 1
    while v < cap:
        out.append(v)
        v *= 2
    out.append(int(cap))
    return sorted(set(out))


class DecodeSlots:
    """Closed (rows × table-width) bucket set for the decode batch.

    The encoder batcher above quantizes (rows, row_len); the decode
    loop's shape axes are the ROW COUNT of the iteration batch and the
    WIDTH of the padded page-table operand (pages of the longest
    member sequence). Both quantize to powers of two — rows capped at
    ``max_rows`` (the slot budget), width at ``max_pages`` (the pages
    a ``max_len`` sequence needs) — so the jitted decode step compiles
    ``log2(max_rows) x log2(max_pages)`` executables, enumerable up
    front for warmup, and a sequence crossing a page boundary reuses
    the next bucket's executable instead of tracing a fresh one.
    """

    def __init__(self, max_rows=8, max_pages=8):
        if max_rows < 1 or max_pages < 1:
            raise ValueError(
                f"bad decode slot geometry: rows {max_rows}, pages "
                f"{max_pages}")
        self.max_rows = int(max_rows)
        self.max_pages = int(max_pages)
        self._rows = _pow2_up_to(self.max_rows)
        self._widths = _pow2_up_to(self.max_pages)

    def bucket(self, n_rows, n_pages):
        """The (rows, width) bucket holding an ``n_rows``-sequence
        iteration whose longest member spans ``n_pages`` pages."""
        if n_rows < 1 or n_rows > self.max_rows:
            raise ValueError(f"{n_rows} rows outside 1..{self.max_rows}")
        if n_pages < 1 or n_pages > self.max_pages:
            raise ValueError(
                f"{n_pages} pages outside 1..{self.max_pages}")
        rows = next(r for r in self._rows if r >= n_rows)
        width = next(w for w in self._widths if w >= n_pages)
        return rows, width

    def shape_universe(self):
        """Every (rows, width) the decode loop can emit — the compile
        budget, enumerable for warmup."""
        return [(r, w) for r in self._rows for w in self._widths]


class PrefillChunks:
    """Closed (chunk × table-width) bucket set for CHUNKED prefill.

    The chunked-prefill step's shape axes are the padded chunk length
    Sq (the kernel's query-block size) and the padded page-table
    WIDTH — the width axis power-of-two quantized like
    :class:`DecodeSlots`, the chunk axis a SINGLE bucket: the
    pow2-padded per-iteration prefill budget. A ladder of smaller
    chunk rungs would pad less for short takes, but every rung
    multiplies the compile universe by the whole width ladder, and
    the kernel's valid-row mask makes the padding free anyway —
    measured on the CPU suite, the ladder tripled warmup-heavy tests.
    Widths reuse the decode slots' ladder, so the warmup manifest
    absorbs the new buckets through the same (rows × width) machinery.
    Bucket keys are ``(-chunk, width)`` — the NEGATED first element
    keeps chunk shapes disjoint from dense-prefill ``(0, bucket)`` and
    decode ``(rows, width)`` keys in the one shape-universe namespace.
    """

    def __init__(self, budget=64, max_pages=8):
        if budget < 1 or max_pages < 1:
            raise ValueError(
                f"bad chunk geometry: budget {budget}, pages "
                f"{max_pages}")
        self.budget = int(budget)
        self._chunk = 1 << (self.budget - 1).bit_length()
        self._widths = _pow2_up_to(int(max_pages))
        self.max_pages = int(max_pages)

    def bucket(self, n_tokens, n_pages):
        """The (-chunk, width) bucket for a slice of ``n_tokens``
        prompt tokens whose sequence spans ``n_pages`` pages so far."""
        if n_tokens < 1 or n_tokens > self.budget:
            raise ValueError(
                f"{n_tokens} chunk tokens outside 1..{self.budget}")
        if n_pages < 1 or n_pages > self.max_pages:
            raise ValueError(
                f"{n_pages} pages outside 1..{self.max_pages}")
        width = next(w for w in self._widths if w >= n_pages)
        return -self._chunk, width

    def shape_universe(self):
        """Every (-chunk, width) the chunked-prefill path can emit."""
        return [(-self._chunk, w) for w in self._widths]
