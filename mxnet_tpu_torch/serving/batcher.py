"""Decode-loop shape buckets: :class:`DecodeSlots` (rows x page-table
width) and :class:`PrefillChunks` (chunk x page-table width).

A port of the decode half of ``mxnet_tpu/serving/batcher.py``; the
encoder path's ``ContinuousBatcher`` belongs to encoder serving and is
left for that slice. PyTorch runs eagerly, so no executable is compiled
per bucket; the buckets still bound the shapes the paged-attention
kernel and the engine's cost ledger see, and keep the engine's
scheduling identical to the JAX package's.
"""
from __future__ import annotations

__all__ = ["DecodeSlots", "PrefillChunks"]


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
