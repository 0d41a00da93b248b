"""Paged KV cache: the decode engine's attention memory.

The vLLM idea, sized for this serving engine: instead of one
contiguous (max_len) KV buffer per sequence — whose worst-case
reservation wastes most of the pool on short chats — the cache is a
POOL of fixed-size pages (``MXNET_TPU_KV_PAGE_SIZE`` tokens each,
``MXNET_TPU_KV_PAGES`` total), preallocated once per layer as
``(P, H, page_size, D)`` device arrays. Each live sequence owns a
PAGE TABLE (an ordered list of physical page ids); growing past a
page boundary allocates exactly one more page, and a finished
sequence returns its pages to the free list the same iteration it
leaves the batch — memory fragmentation is impossible by construction
(every page is the same size) and occupancy is a first-class metric.

Isolation is per-page OWNER ATTRIBUTION, generalized to owner SETS:
a page is PRIVATE to one sequence while it is being written, but a
FULL page holding prompt-prefix K/V may be shared READ-ONLY by every
request whose prompt starts with the same tokens (production traffic
shares system prompts; recomputing their K/V per request is the
single largest avoidable prefill cost). Sharing is refcounted —
``refcount = live owners + (1 if the prefix index pins it)`` — with
copy-on-write the moment a shared page would be written: a prompt
diverging mid-page, or a shared page sitting at a sequence's write
frontier, gets a private copy first (:meth:`PagedKVPool.prepare_write`
/ the COW arm of :meth:`PagedKVPool.match_prefix`). A page recycles
to the free list exactly when its refcount hits zero. PARTIAL pages
are never shared: only pages whose every slot holds verified prompt
tokens enter the index, so the write frontier of one sequence can
never alias another's history. :meth:`PagedKVPool.check_isolated`
asserts all of it (consistent attribution both ways, shared pages at
identical table positions, free pages unreferenced) — the decode
analog of the packed encoder path's segment ids. The decode kernel
(``ops.paged_attention.paged_flash_attention``) then reads K/V
through the table with per-row ``kv_len`` masking, so one sequence
can never attend into another's pages even though they share the
physical pool.

The PREFIX INDEX is a bounded LRU (``MXNET_TPU_KV_PREFIX_PAGES``
entries, ``MXNET_TPU_KV_PREFIX`` gates the whole feature) keyed by a
sha1 CHAIN over page-granular prompt slices — entry ``i``'s key
hashes page ``i``'s tokens with page ``i-1``'s key, so a digest match
plus the stored per-page token comparison verifies the entire prefix
without storing O(prefix²) tokens. Index pins survive the owning
sequence (that is the cache value: the next same-prompt request hits
pages a finished one computed), but pinned-unowned pages are
reclaimed on demand when the free list runs dry — cached prefixes
give way to live sequences, never the reverse. Hits, misses,
evictions and COW copies are counted per engine
(``mxnet_tpu_serving_kv_prefix_events_total``) and the occupancy
gauge splits ``shared`` vs ``private`` page states.

PyTorch port of ``mxnet_tpu/serving/kvcache.py``. The host-side
bookkeeping (free list, tables, owner sets, prefix index, scatter
coordinates, padded tables, the isolation check) is unchanged. The
caches are torch tensors on the pool's device, allocated ZEROED once
(``torch.zeros``, as the JAX pool's ``jnp.zeros``: the pad rows of a
prefill chunk attend into unwritten columns, and uninitialised device
memory could hold NaNs there). The model steps write K/V into them IN
PLACE, so steady-state decode allocates nothing cache-sized; a COW
copy is an in-place page copy (:meth:`PagedKVPool.copy_pages` — call
it under the engine's forward lock, like any step). :meth:`swap`
stays the engine's contract for installing a step's returned caches.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import envvars
from ..context import resolve_device
from ..telemetry.registry import REGISTRY
from .queue import ServingError

__all__ = ["KVPagesExhaustedError", "PagedKVPool"]

class KVPagesExhaustedError(ServingError):
    """The page pool cannot hold another page: backpressure for the
    decode admission path (the engine defers the join — the request
    waits in the prefill queue until pages recycle)."""


def _kv_pages_gauge(registry=None):
    reg = registry if registry is not None else REGISTRY
    return reg.gauge(
        "mxnet_tpu_serving_kv_pages",
        "paged KV cache pool pages by state: used/free plus the "
        "used split shared (read-only prefix pages, frozen) vs "
        "private (single-owner, writable) and cached (index-pinned "
        "with no live owner), per engine",
        ("engine_id", "state"))


def _kv_events_counter(registry=None):
    reg = registry if registry is not None else REGISTRY
    return reg.counter(
        "mxnet_tpu_serving_kv_page_events_total",
        "paged KV cache pool events: alloc/free (pages) and exhausted "
        "(refused allocations), per engine", ("engine_id", "event"))


def _kv_prefix_counter(registry=None):
    reg = registry if registry is not None else REGISTRY
    return reg.counter(
        "mxnet_tpu_serving_kv_prefix_events_total",
        "prefix-KV-reuse events: hit/miss (prompt lookups), evict "
        "(LRU index entries dropped) and cow (copy-on-write page "
        "copies), per engine", ("engine_id", "event"))


# chain root: page 0's key hashes its tokens against this sentinel
_ROOT = b"kv-prefix-root"


class PagedKVPool:
    """Fixed-size-page KV pool with per-sequence page tables and a
    refcounted prefix-sharing index.

    Parameters
    ----------
    n_layers / n_heads / head_dim : the model's KV geometry — one
        (K, V) page array pair per layer, shaped
        ``(n_pages, n_heads, page_size, head_dim)``.
    page_size : tokens per page (default ``MXNET_TPU_KV_PAGE_SIZE``).
    n_pages : pool capacity (default ``MXNET_TPU_KV_PAGES``).
    dtype : cache dtype (the model's activation dtype).
    device : where the caches live (default: the current CUDA device;
        raises without one — pass ``device="cpu"`` explicitly).
    engine_id : label for the pool's metric families.
    prefix_cache : enable prefix-KV sharing (default
        ``MXNET_TPU_KV_PREFIX``).
    prefix_pages : LRU index capacity in entries (default
        ``MXNET_TPU_KV_PREFIX_PAGES``).

    ``caches`` is a flat tuple ``(k0, v0, k1, v1, ...)`` the model
    steps take first, update in place and return; the engine installs
    the returned tuple with :meth:`swap`. All bookkeeping (free list,
    tables, owner sets, prefix index) is host-side, thread-safe under
    one lock; tensor contents are only touched by the model steps and
    :meth:`copy_pages`.
    """

    def __init__(self, n_layers, n_heads, head_dim, page_size=None,
                 n_pages=None, dtype="float32", engine_id="default",
                 registry=None, prefix_cache=None, prefix_pages=None,
                 device=None):
        self.page_size = int(page_size if page_size is not None
                             else envvars.get("MXNET_TPU_KV_PAGE_SIZE"))
        self.n_pages = int(n_pages if n_pages is not None
                           else envvars.get("MXNET_TPU_KV_PAGES"))
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError(
                f"bad page pool geometry: {self.n_pages} pages of "
                f"{self.page_size} tokens")
        self.n_layers = int(n_layers)
        self.engine_id = str(engine_id)
        self.prefix_enabled = bool(
            envvars.get("MXNET_TPU_KV_PREFIX") if prefix_cache is None
            else prefix_cache)
        self.prefix_cap = int(
            envvars.get("MXNET_TPU_KV_PREFIX_PAGES")
            if prefix_pages is None else prefix_pages)
        if self.prefix_cap < 1:
            self.prefix_enabled = False
        self.device = resolve_device(device)
        # one extra SCRATCH page (id n_pages, never allocated): padded
        # decode-batch rows and prefill tail padding write there, so a
        # dummy row can never clobber a live sequence's page
        self.scratch_page = self.n_pages
        shape = (self.n_pages + 1, int(n_heads), self.page_size,
                 int(head_dim))
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.caches = tuple(
            torch.zeros(shape, dtype=dt, device=self.device)
            for _ in range(2 * self.n_layers))
        self._lock = threading.Lock()
        # LIFO free list: a just-freed (cache-warm) page is reused first
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._tables = {}               # owner -> [page ids] in order
        # per-page owner SETS (+1: the scratch page, never owned)
        self._owners = [set() for _ in range(self.n_pages + 1)]
        # prefix index: chain-digest -> {page, tokens, parent}; LRU in
        # insertion/touch order. _pinned maps page -> its index key,
        # _children maps parent key -> child keys (the partial-match /
        # divergence walk needs them; digests alone can't be computed
        # for a page whose tokens only partly match).
        self._prefix = OrderedDict()
        self._pinned = {}
        self._children = {}
        self._pstats = {"lookups": 0, "hits": 0, "misses": 0,
                        "pages_reused": 0, "tokens_reused": 0,
                        "cow_pages": 0, "evictions": 0, "inserts": 0}
        ev = _kv_events_counter(registry)
        self._c_alloc = ev.labels(engine_id=self.engine_id, event="alloc")
        self._c_free = ev.labels(engine_id=self.engine_id, event="free")
        self._c_exhausted = ev.labels(engine_id=self.engine_id,
                                      event="exhausted")
        pv = _kv_prefix_counter(registry)
        self._c_hit = pv.labels(engine_id=self.engine_id, event="hit")
        self._c_miss = pv.labels(engine_id=self.engine_id, event="miss")
        self._c_evict = pv.labels(engine_id=self.engine_id,
                                  event="evict")
        self._c_cow = pv.labels(engine_id=self.engine_id, event="cow")
        g = _kv_pages_gauge(registry)
        # pull gauges: scrape-time reads, zero hot-path cost
        g.labels(engine_id=self.engine_id, state="used") \
            .set_function(lambda: self._count_states()["used"])
        g.labels(engine_id=self.engine_id, state="free") \
            .set_function(lambda: len(self._free))
        g.labels(engine_id=self.engine_id, state="shared") \
            .set_function(lambda: self._count_states()["shared"])
        g.labels(engine_id=self.engine_id, state="private") \
            .set_function(lambda: self._count_states()["private"])
        g.labels(engine_id=self.engine_id, state="cached") \
            .set_function(lambda: self._count_states()["cached"])

    # -- geometry ----------------------------------------------------------
    def pages_for(self, kv_len):
        """Pages needed to hold ``kv_len`` tokens."""
        return -(-int(kv_len) // self.page_size)

    @property
    def bytes_total(self):
        return sum(c.numel() * c.element_size() for c in self.caches)

    def _count_states(self):
        """used/shared/private/cached page counts. Lock-free reads of
        the owner sets (pull-gauge scrapes tolerate a page mid-
        transition; the sums are exact the instant nothing moves)."""
        used = shared = cached = 0
        for page in range(self.n_pages):
            owners = len(self._owners[page])
            pinned = page in self._pinned
            if owners:
                used += 1
                if pinned or owners > 1:
                    shared += 1
            elif pinned:
                cached += 1
        return {"used": used, "shared": shared,
                "private": used - shared, "cached": cached}

    # -- allocation --------------------------------------------------------
    def _reclaim_locked(self, need):
        """Evict LRU index entries whose pages have no live owner
        until ``need`` pages are free (or no reclaimable entry is
        left). Cached prefixes yield to live sequences on demand —
        the index can never starve admission."""
        if need <= len(self._free):
            return
        for key in list(self._prefix):
            if len(self._free) >= need:
                break
            if not self._owners[self._prefix[key]["page"]]:
                self._evict_locked(key)

    def _evict_locked(self, key):
        """Drop one index entry: unpin its page (recycling it if no
        sequence still owns it) and unlink it from the chain."""
        entry = self._prefix.pop(key)
        page = entry["page"]
        self._pinned.pop(page, None)
        kids = self._children.get(entry["parent"])
        if kids is not None:
            kids.discard(key)
            if not kids:
                self._children.pop(entry["parent"], None)
        self._pstats["evictions"] += 1
        self._c_evict.inc()
        if not self._owners[page]:
            self._free.append(page)
            self._c_free.inc()

    def _alloc_locked(self, owner, n):
        """Pop ``n`` free pages for ``owner`` (reclaiming cached
        prefix pages if the free list is short); atomic — raises
        :class:`KVPagesExhaustedError` allocating nothing when the
        pool genuinely cannot hold them."""
        self._reclaim_locked(n)
        if n > len(self._free):
            self._c_exhausted.inc()
            raise KVPagesExhaustedError(
                f"KV pool exhausted: need {n} more pages for "
                f"{owner!r}, {len(self._free)} free of {self.n_pages}")
        out = []
        for _ in range(n):
            page = self._free.pop()
            self._owners[page].add(owner)
            out.append(page)
        self._c_alloc.inc(n)
        return out

    def ensure(self, owner, kv_len):
        """Grow ``owner``'s table to hold ``kv_len`` tokens; returns
        the table. Atomic: either every page needed is allocated or
        none is (:class:`KVPagesExhaustedError`) — a half-grown
        sequence could never run its next step."""
        need_pages = self.pages_for(kv_len)
        with self._lock:
            table = self._tables.setdefault(owner, [])
            grow = need_pages - len(table)
            if grow <= 0:
                return list(table)
            table.extend(self._alloc_locked(owner, grow))
            return list(table)

    def release(self, owner):
        """Drop ``owner``'s reference on every page it holds (the
        sequence left the batch); pages whose refcount hits zero
        recycle immediately, index-pinned ones stay cached for the
        next same-prefix prompt. Returns the number recycled. Unknown
        owners free 0 — release is idempotent by design (leave paths
        can race stop)."""
        with self._lock:
            table = self._tables.pop(owner, None)
            if not table:
                return 0
            freed = 0
            for page in table:
                self._owners[page].discard(owner)
                if not self._owners[page] and page not in self._pinned:
                    self._free.append(page)
                    freed += 1
            if freed:
                self._c_free.inc(freed)
            return freed

    # -- prefix sharing ----------------------------------------------------
    def _chain_key(self, parent, tokens):
        return hashlib.sha1(parent + np.ascontiguousarray(
            tokens, np.int32).tobytes()).digest()

    def match_prefix(self, owner, tokens):
        """Attach the longest cached prefix of ``tokens`` to
        ``owner``'s (empty) table. Returns ``(matched, copies)``:
        ``matched`` tokens of prompt K/V the prefill can skip, and
        ``copies`` — ``(src, dst)`` page pairs the caller MUST
        materialize with :meth:`copy_pages` before any step reads
        ``owner``'s table (the COW arm).

        Fully-matching FULL pages are attached read-only (the owner
        joins the page's owner set — zero data movement). The first
        page that matches only partially — the prompt diverges
        mid-page, or simply ends inside it — is COW-attached: a
        private copy carries the matched slots and the prefill
        overwrites the rest, so a partial match still saves its
        tokens without ever sharing a partially-valid page. At least
        one prompt token is always left to prefill — the first
        generated token's logits come from it."""
        toks = np.ascontiguousarray(tokens, np.int32).ravel()
        ps = self.page_size
        limit = int(toks.size) - 1     # last prompt token never reused
        with self._lock:
            if not self.prefix_enabled or limit < 1:
                return 0, []
            table = self._tables.setdefault(owner, [])
            if table:
                raise ValueError(
                    f"match_prefix on a non-empty table ({owner!r})")
            self._pstats["lookups"] += 1
            matched, copies, parent = 0, [], _ROOT
            while matched < limit:
                lo = matched
                want = toks[lo:lo + ps]
                cap = min(ps, limit - lo)      # usable tokens here
                key = self._chain_key(parent, want)
                entry = self._prefix.get(key)
                if (cap == ps and entry is not None
                        and np.array_equal(entry["tokens"], want)):
                    # whole page verified: share read-only
                    page = entry["page"]
                    self._owners[page].add(owner)
                    table.append(page)
                    self._prefix.move_to_end(key)
                    matched += ps
                    parent = key
                    self._pstats["pages_reused"] += 1
                    continue
                # tail page: find the child sharing the longest
                # sub-page prefix (divergence / prompt-end mid-page)
                best, best_m = None, 0
                for ck in self._children.get(parent, ()):
                    ce = self._prefix.get(ck)
                    if ce is None:
                        continue
                    et = ce["tokens"][:cap]
                    m = int((np.cumprod(et == want[:et.size])).sum())
                    if m > best_m:
                        best, best_m = ce, m
                if best is not None and best_m >= 1:
                    try:
                        dst = self._alloc_locked(owner, 1)[0]
                    except KVPagesExhaustedError:
                        break          # partial reuse is best-effort
                    table.append(dst)
                    copies.append((best["page"], dst))
                    self._prefix.move_to_end(
                        self._pinned[best["page"]])
                    matched += best_m
                    self._pstats["pages_reused"] += 1
                    self._pstats["cow_pages"] += 1
                    self._c_cow.inc()
                break
            if matched:
                self._pstats["hits"] += 1
                self._pstats["tokens_reused"] += matched
                self._c_hit.inc()
            else:
                self._pstats["misses"] += 1
                self._c_miss.inc()
            return matched, copies

    def register_prefix(self, owner, tokens):
        """Index every FULL prompt page of ``owner``'s freshly
        prefilled sequence (called once the whole prompt's K/V is in
        the pages). Pages already indexed (attached via
        :meth:`match_prefix`) are just LRU-refreshed; new entries pin
        their page — the pin is the cache's refcount, outliving the
        sequence. The LRU bound evicts the oldest entry beyond
        ``prefix_pages``. Partial pages (a prompt ending mid-page)
        are NEVER registered: every indexed slot holds verified
        prompt tokens."""
        toks = np.ascontiguousarray(tokens, np.int32).ravel()
        ps = self.page_size
        with self._lock:
            if not self.prefix_enabled:
                return 0
            table = self._tables.get(owner, ())
            parent, added = _ROOT, 0
            for i in range(int(toks.size) // ps):
                want = toks[i * ps:(i + 1) * ps]
                key = self._chain_key(parent, want)
                entry = self._prefix.get(key)
                if entry is not None:
                    self._prefix.move_to_end(key)
                    parent = key
                    continue
                if i >= len(table):
                    break
                page = table[i]
                if page in self._pinned:
                    # same physical page under a different chain key
                    # (a COW copy whose content since diverged can't
                    # happen for full prompt pages, but stay safe)
                    parent = key
                    continue
                self._prefix[key] = {"page": page,
                                     "tokens": want.copy(),
                                     "parent": parent}
                self._pinned[page] = key
                self._children.setdefault(parent, set()).add(key)
                self._pstats["inserts"] += 1
                added += 1
                parent = key
            while len(self._prefix) > self.prefix_cap:
                self._evict_locked(next(iter(self._prefix)))
            return added

    def prepare_write(self, owner, pos):
        """Make the page holding logical position ``pos`` of
        ``owner``'s sequence privately writable. A private page
        returns None (the fast path — one set-membership check). A
        FROZEN page (index-pinned or multi-owner: a shared prefix
        page that became this sequence's write frontier) is COW'd:
        the owner gets a fresh page in its table slot and the
        returned ``(src, dst)`` pair must be materialized with
        :meth:`copy_pages` before the next step."""
        idx = int(pos) // self.page_size
        with self._lock:
            table = self._tables.get(owner)
            if table is None or idx >= len(table):
                raise ValueError(
                    f"{owner!r}'s table does not cover position {pos}"
                    " (ensure first)")
            page = table[idx]
            frozen = page in self._pinned or len(self._owners[page]) > 1
            if not frozen:
                return None
            dst = self._alloc_locked(owner, 1)[0]
            table[idx] = dst
            self._owners[page].discard(owner)
            if not self._owners[page] and page not in self._pinned:
                self._free.append(page)
                self._c_free.inc()
            self._pstats["cow_pages"] += 1
            self._c_cow.inc()
            return page, dst

    def copy_pages(self, pairs):
        """Materialize COW copies on the device: for each ``(src,
        dst)``, page ``src``'s K/V content is copied in place into page
        ``dst`` across every layer. The CALLER must hold whatever lock
        serializes model steps against cache writes (the engine's
        forward lock)."""
        for src, dst in pairs:
            for c in self.caches:
                c[int(dst)].copy_(c[int(src)])

    def prefix_stats(self):
        """Prefix-index observability snapshot (scheduler-state
        flight-bundle section, loadgen report, /stats)."""
        with self._lock:
            st = dict(self._pstats)
            st["enabled"] = self.prefix_enabled
            st["entries"] = len(self._prefix)
            st["capacity"] = self.prefix_cap
            looked = st["hits"] + st["misses"]
            st["hit_rate"] = (round(st["hits"] / looked, 4)
                              if looked else None)
            return st

    def page_refcounts(self):
        """Per-page refcounts for every referenced page: owner count
        + index pin — the flight-bundle drill-down for a stuck or
        leaking pool."""
        with self._lock:
            out = {}
            for page in range(self.n_pages):
                owners = self._owners[page]
                pinned = page in self._pinned
                if owners or pinned:
                    out[page] = {"refs": len(owners) + int(pinned),
                                 "owners": len(owners),
                                 "pinned": pinned}
            return out

    # -- inspection --------------------------------------------------------
    def table(self, owner):
        """``owner``'s page table (a copy), or None."""
        with self._lock:
            t = self._tables.get(owner)
            return list(t) if t is not None else None

    def owner_of(self, page):
        """The page's SOLE owner, or None (free, cached, or shared by
        several — use :meth:`owners_of` for the full set)."""
        with self._lock:
            owners = self._owners[int(page)]
            return next(iter(owners)) if len(owners) == 1 else None

    def owners_of(self, page):
        """Every live sequence referencing ``page`` (frozen view)."""
        with self._lock:
            return frozenset(self._owners[int(page)])

    def occupancy(self):
        """Pool occupancy snapshot — the /stats + bench number.
        ``pages_used`` counts pages referenced by LIVE sequences;
        index-pinned pages with no owner report as ``pages_cached``
        (they recycle on demand, so they are headroom, not load)."""
        with self._lock:
            st = self._count_states()
            owners = len(self._tables)
            entries = len(self._prefix)
        return {"pages_total": self.n_pages, "pages_used": st["used"],
                "pages_free": len(self._free),
                "pages_shared": st["shared"],
                "pages_private": st["private"],
                "pages_cached": st["cached"],
                "prefix_entries": entries,
                "sequences": owners,
                "page_size": self.page_size,
                "occupancy": round(st["used"] / float(self.n_pages), 4)}

    def check_isolated(self):
        """Assert the attribution invariants, generalized to owner
        sets: every tabled page is attributed to that owner and vice
        versa; a page shared by several sequences sits at the SAME
        table index in each (prefix pages — position is content);
        free pages are unreferenced (no owner, no pin, no table);
        pinned pages are the ones their index entries name; and
        referenced + free == total. Raises ``AssertionError`` on
        violation (tests and drills call this; production code paths
        maintain it by construction)."""
        with self._lock:
            positions = {}               # page -> table index
            tabled = set()
            for owner, table in self._tables.items():
                for idx, page in enumerate(table):
                    assert owner in self._owners[page], (
                        f"page {page} tabled by {owner!r} but not "
                        f"attributed to it ({self._owners[page]!r})")
                    if page in positions:
                        assert positions[page] == idx, (
                            f"shared page {page} at table index {idx} "
                            f"for {owner!r} but {positions[page]} "
                            f"elsewhere")
                    positions[page] = idx
                    tabled.add(page)
            for page in range(self.n_pages):
                for owner in self._owners[page]:
                    assert page in self._tables.get(owner, ()), (
                        f"page {page} attributed to {owner!r} but "
                        f"missing from its table")
            for page in self._free:
                assert not self._owners[page], (
                    f"free page {page} still attributed to "
                    f"{self._owners[page]!r}")
                assert page not in self._pinned, (
                    f"free page {page} still pinned by the prefix "
                    f"index")
                assert page not in tabled, f"free page {page} is tabled"
            for key, entry in self._prefix.items():
                assert self._pinned.get(entry["page"]) == key, (
                    f"index entry for page {entry['page']} out of "
                    f"sync with its pin")
            referenced = {p for p in range(self.n_pages)
                          if self._owners[p] or p in self._pinned}
            assert tabled <= referenced
            assert len(referenced) + len(self._free) == self.n_pages, (
                f"{len(referenced)} referenced + {len(self._free)} "
                f"free != {self.n_pages}")
            assert not self._owners[self.scratch_page]
            assert self.scratch_page not in self._pinned
        return True

    # -- batch views -------------------------------------------------------
    def padded_tables(self, owners, width):
        """(R, width) int32 page-table batch for the decode step: row
        r is ``owners[r]``'s table padded with the scratch page (the
        kernel's per-row kv_len mask keeps padding slots dead — but a
        PAD ROW's write must land somewhere no live sequence owns)."""
        out = np.full((len(owners), int(width)), self.scratch_page,
                      np.int32)
        with self._lock:
            for r, owner in enumerate(owners):
                table = self._tables.get(owner, ())
                if len(table) > out.shape[1]:
                    raise ValueError(
                        f"table width {width} cannot hold {owner!r}'s "
                        f"{len(table)} pages")
                out[r, :len(table)] = table
        return out

    def scatter_indices(self, owner, valid, padded=None, start=0):
        """(physical_page, offset) int32 arrays addressing ``valid``
        logical positions of ``owner``'s sequence — the prefill
        writer's scatter coordinates. Entry ``i < valid`` addresses
        position ``start + i`` (``start=0`` is whole-prompt prefill;
        ``start > 0`` a chunked-prefill slice, FRONT-aligned like the
        chunk step's ids row); entries at/after ``valid`` map to the
        scratch page. The table must already cover ``start + valid``
        tokens (call :meth:`ensure` first)."""
        padded = int(valid) if padded is None else int(padded)
        start, valid = int(start), int(valid)
        idx = np.arange(padded)
        pos = start + idx
        live = idx < valid
        with self._lock:
            table = np.asarray(self._tables.get(owner, ()), np.int64)
        need = self.pages_for(start + valid)
        if need > len(table):
            raise ValueError(
                f"{owner!r}'s table ({len(table)} pages) does not "
                f"cover {start + valid} tokens")
        phys = np.full(padded, self.scratch_page, np.int64)
        phys[live] = table[pos[live] // self.page_size]
        off = pos % self.page_size
        return phys.astype(np.int32), off.astype(np.int32)

    def swap(self, caches):
        """Install a model step's returned caches (the same tensors,
        updated in place, for this package's model)."""
        if len(caches) != len(self.caches):
            raise ValueError("cache arity mismatch")
        self.caches = tuple(caches)
