"""Reference decode model: a paged-KV causal LM the decode engine drives.

PyTorch port of ``mxnet_tpu/serving/decode_model.py``, with the same
contract:

- ``prefill(caches, ids, length, phys, off)`` — one padded prompt row
  in, the first generated token out; per-position K/V are written into
  the paged pool at the precomputed page coordinates (tail padding
  lands on the scratch page). Dense causal attention in composed torch
  ops, as the JAX package writes it in jnp.
- ``prefill_chunk(caches, ids, start, valid, table)`` — one slice of a
  prompt: K/V written into the sequence's pages, then attention over
  the whole written history through the paged kernel (Sq = chunk).
- ``decode_step(caches, ids, positions, tables)`` — one iteration of
  the continuous decode batch: (R,) tokens in, (R,) next tokens out,
  each row reading its own history through its page-table row.

On CUDA tensors the chunk and decode steps launch the hand-written
paged-attention kernel (``ops.paged_attention``); on CPU tensors its
plain version. The JAX steps thread the cache through ``jax.jit`` with
donated buffers; here the K/V writes are in-place indexed assignments
into the pool's tensors, which is what the donation achieved: no
per-step cache-sized allocation.

Each step is split into host preparation (the page coordinates,
position ids, table rows and history lengths, computed in numpy and
packed into one int64 tensor that goes to the device in one copy) and
a body of tensor operations. On CUDA the body is a CUDA graph, the
counterpart of the JAX model's ``jax.jit`` steps: one per step kind
and shape (a decode step per (rows, table width), a prefill per padded
length, a chunk per (chunk, width)), keyed also on the pool's cache
tensors (addresses, shapes and types), since the graph writes K/V into
them; an entry whose cache tensors are gone is dropped. The first call
of a key warms up and captures (``graphs``), later calls copy the
packed inputs into the graph's static buffer and replay; the outputs
are copies. Greedy argmax runs inside the decode body; a prefill's
token, and any sampled token, is drawn after the body from its logits
(``_sample_row``). On the CPU the body runs eagerly, and the first
call of each key counts as a capture (``graphs.captures``), as a CPU
CachedOp entry does.

Sampling is greedy argmax by default. Seeded temperature / top-k /
top-p sampling keeps the JAX package's kept-set rule exactly, and its
random draw depends only on (seed, position): the Gumbel noise comes
from a ``torch.Generator`` seeded with a hash of the pair, never from
the batch's make-up. The bits differ from ``jax.random``'s.
"""
from __future__ import annotations

import hashlib
import struct
import weakref

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import graphs
from ..context import resolve_device
from ..ops.paged_attention import paged_flash_attention

__all__ = ["PagedCausalLM", "init_params"]

_NEG = -1e30


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = torch.square(x - m).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * g + b


def _draw_seed(seed, pos):
    """A generator seed that is a pure function of (seed, position)."""
    digest = hashlib.blake2b(struct.pack("<qq", int(seed), int(pos)),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _filter_logits(logits, temp, top_k, top_p):
    """Temperature-scaled logits with every token outside the kept set
    at -1e30: the ``top_k`` highest (0 = all), then the smallest
    highest-probability set whose mass reaches ``top_p`` — a token
    survives if the mass STRICTLY above it is < top_p, and the best
    token always survives. ``_sample_row``'s rule, line for line."""
    vocab = logits.shape[-1]
    lg = logits.float() / max(float(temp), 1e-6)
    order = torch.argsort(-lg, stable=True)       # token ids, best first
    ranks = torch.argsort(order, stable=True)     # rank of each token
    kk = int(top_k) if int(top_k) > 0 else vocab
    neg = torch.tensor(_NEG, dtype=lg.dtype, device=lg.device)
    lg = torch.where(ranks < kk, lg, neg)
    probs = torch.softmax(lg, dim=-1)
    sp = probs[order]                              # descending by rank
    cum = torch.cumsum(sp, dim=-1)
    keep = max(int(((cum - sp) < float(top_p)).sum()), 1)
    return torch.where(ranks < keep, lg, neg)


def _sample_row(logits, temp, top_k, top_p, seed, pos):
    """Draw ONE token id (0-d int32 tensor on the logits' device) from
    one logits row. ``temp <= 0`` is greedy argmax (ties to the first
    index). Otherwise Gumbel-max over the kept set, the noise drawn on
    the host from a generator keyed on (seed, pos), so a row's draw is
    the same whatever batch it rides in and whichever device runs it."""
    if float(temp) <= 0.0:
        return torch.argmax(logits).to(torch.int32)
    lg = _filter_logits(logits, temp, top_k, top_p)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(_draw_seed(seed, pos))
    u = torch.rand(lg.shape[-1], generator=gen, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(lg + gumbel.to(lg.device)).to(torch.int32)


def init_params(vocab, units, layers, max_len, seed=0):
    """Seeded ``Normal(0.02)`` weights as float32 numpy arrays, drawn
    from ``np.random.RandomState(seed)`` in the JAX package's order, so
    one seed gives the same weights in both packages."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)

    U, V = units, vocab
    p = {"embed": w(V, U), "pos": w(max_len, U),
         "lnf_g": np.ones((U,), np.float32),
         "lnf_b": np.zeros((U,), np.float32),
         "head": w(U, V)}
    for i in range(layers):
        p[f"l{i}_ln1_g"] = np.ones((U,), np.float32)
        p[f"l{i}_ln1_b"] = np.zeros((U,), np.float32)
        p[f"l{i}_ln2_g"] = np.ones((U,), np.float32)
        p[f"l{i}_ln2_b"] = np.zeros((U,), np.float32)
        for n in ("wq", "wk", "wv", "wo"):
            p[f"l{i}_{n}"] = w(U, U)
        p[f"l{i}_w1"] = w(U, 4 * U)
        p[f"l{i}_b1"] = np.zeros((4 * U,), np.float32)
        p[f"l{i}_w2"] = w(4 * U, U)
        p[f"l{i}_b2"] = np.zeros((U,), np.float32)
    return p


class PagedCausalLM(nn.Module):
    """GPT-small-shaped causal LM with a paged decode path.

    Weights are freshly initialized (seeded ``Normal(0.02)``, see
    :func:`init_params`) or taken over from the JAX model with
    :meth:`from_jax_params`. ``device=None`` is the current CUDA device
    (raises without one); ``device="cpu"`` runs on the CPU.
    """

    def __init__(self, vocab=256, units=64, layers=2, heads=4,
                 max_len=1024, seed=0, dtype="float32", device=None,
                 params=None):
        super().__init__()
        if units % heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{heads}")
        self.vocab = int(vocab)
        self.units = int(units)
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = self.units // self.heads
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        if params is None:
            params = init_params(self.vocab, self.units, self.layers,
                                 self.max_len, seed)
        self.params = nn.ParameterDict({
            k: nn.Parameter(torch.tensor(np.asarray(v), dtype=self.dtype,
                                         device=self.device),
                            requires_grad=False)
            for k, v in params.items()})
        self._graphs = {}
        self._graph_pool = None

    def _run(self, name, caches, arrays, body):
        """``body(caches, *tensors)`` with ``arrays`` (host integer
        arrays) as int64 tensors of their shapes on the model's device,
        copied in one transfer; on CUDA through the step's graph
        (module docstring). Returns the body's tuple of tensors."""
        shapes = tuple(np.shape(a) for a in arrays)
        host = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int64).ravel() for a in arrays]))

        def step(buf):
            out, i = [], 0
            for shape in shapes:
                n = int(np.prod(shape, dtype=np.int64))
                out.append(buf[i:i + n].view(shape))
                i += n
            return body(caches, *out)

        key = (name, shapes, tuple((c.data_ptr(), tuple(c.shape), c.dtype)
                                   for c in caches))
        entry = self._graphs.get(key)
        if entry is None or entry[0]() is None:
            # a new key, or the caches it was captured on are gone and
            # new ones took their addresses
            self._graphs = {k: e for k, e in self._graphs.items()
                            if e[0]() is not None}
            graph = None
            if self.device.type == "cuda":
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                # the warm-up writes the K/V that the first replay
                # writes again
                graph = graphs.capture(
                    step, [host.to(self.device)], self.device,
                    self._graph_pool, f"PagedCausalLM {name} step at "
                    f"{shapes}")
            else:
                graphs.count_capture()      # the CPU stands for one
            entry = self._graphs[key] = (weakref.ref(caches[0]), graph)
        if entry[1] is None:
            return step(host)
        return tuple(o.clone() for o in entry[1]([host]))

    @classmethod
    def from_jax_params(cls, params, heads, device=None, dtype="float32"):
        """Build the port's model from the JAX ``PagedCausalLM.params``
        (same keys, values as numpy arrays). Geometry is read off the
        shapes; ``heads`` is not recoverable from them."""
        p = {k: np.asarray(v, np.float32) for k, v in params.items()}
        vocab, units = p["embed"].shape
        layers = sum(1 for k in p if k.endswith("_wq"))
        return cls(vocab=vocab, units=units, layers=layers, heads=heads,
                   max_len=p["pos"].shape[0], dtype=dtype, device=device,
                   params=p)

    @property
    def spec(self):
        """The KV geometry the engine sizes its page pool from."""
        return {"n_layers": self.layers, "n_heads": self.heads,
                "head_dim": self.head_dim, "vocab": self.vocab,
                "max_len": self.max_len}

    # -- shared pieces ------------------------------------------------------
    def _qkv(self, h, i):
        """(..., U) -> three (..., H, D) projections."""
        p = self.params
        shape = h.shape[:-1] + (self.heads, self.head_dim)
        return ((h @ p[f"l{i}_wq"]).reshape(shape),
                (h @ p[f"l{i}_wk"]).reshape(shape),
                (h @ p[f"l{i}_wv"]).reshape(shape))

    def _mlp(self, x, i):
        p = self.params
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x @ p[f"l{i}_w1"] + p[f"l{i}_b1"],
                      approximate="tanh") @ p[f"l{i}_w2"] + p[f"l{i}_b2"]

    def _ln(self, x, name):
        return _layer_norm(x, self.params[f"{name}_g"],
                           self.params[f"{name}_b"])

    @staticmethod
    def _write(caches, i, phys, off, k, v):
        """Write per-position K/V into layer ``i``'s page tensors IN
        PLACE (the JAX model's ``.at[].set`` plus buffer donation).
        ``phys``/``off`` are (T,) page coordinates, ``k``/``v``
        (T, H, D)."""
        caches[2 * i][phys, :, off] = k
        caches[2 * i + 1][phys, :, off] = v

    # -- prefill ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, caches, ids, length, phys, off, temperature=0.0,
                top_k=0, top_p=1.0, seed=0):
        """One padded prompt row: ids (Lp,), ``length`` real tokens,
        phys/off (Lp,) page coordinates. Returns (first generated token
        as a 0-d int32 tensor, caches). Dense causal self-attention;
        K/V land in the pages for the decode steps to read back."""
        length = int(length)
        ids = np.asarray(ids, np.int64)
        lp = ids.shape[0]
        pos = np.minimum(np.arange(lp), self.max_len - 1)
        (logits,) = self._run(
            "prefill", caches, (ids, pos, np.asarray(phys, np.int64),
                                np.asarray(off, np.int64), [length - 1]),
            self._prefill_body)
        tok = _sample_row(logits, temperature, top_k, top_p, seed,
                          length - 1)
        return tok, caches

    def _prefill_body(self, caches, ids, pos, phys, off, last):
        p = self.params
        lp = ids.shape[0]
        x = p["embed"][ids] + p["pos"][pos]
        col = torch.arange(lp, device=ids.device)[None, :]
        row = torch.arange(lp, device=ids.device)[:, None]
        masked = col > row
        scale = float(np.float32(1.0 / np.sqrt(self.head_dim)))
        for i in range(self.layers):
            h = self._ln(x, f"l{i}_ln1")
            q, k, v = self._qkv(h, i)          # (Lp, H, D)
            self._write(caches, i, phys, off, k, v)
            s = torch.einsum("qhd,khd->hqk", q.float() * scale, k.float())
            s = s.masked_fill(masked[None], _NEG)
            s = s - s.amax(dim=-1, keepdim=True)
            w_ = torch.exp(s)
            w_ = w_ / w_.sum(dim=-1, keepdim=True)
            o = torch.einsum("hqk,khd->qhd", w_, v.float())
            x = x + o.reshape(lp, self.units).to(x.dtype) @ p[f"l{i}_wo"]
            x = x + self._mlp(self._ln(x, f"l{i}_ln2"), i)
        return self._last_logits(x, last)

    def _last_logits(self, x, last):
        """``((vocab,) logits of row last,)``: ``last`` is a 1-element
        index."""
        return (self._ln(x.index_select(0, last)[0], "lnf")
                @ self.params["head"],)

    # -- chunked prefill ----------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, caches, ids, start, valid, table,
                      temperature=0.0, top_k=0, top_p=1.0, seed=0):
        """One prompt SLICE through the paged kernel: ids (C,) with the
        ``valid`` real tokens FRONT-aligned (positions
        ``start..start+valid-1``; the tail is padding), table (W,) the
        sequence's padded page-table row. Each token's K/V goes to its
        page slot (padding to the scratch page), then the chunk attends
        over the written history with Sq = C and ``kv_len = start + C``:
        chunk row ``i`` is position ``start + i``, so the causal mask
        ``col <= kv_len - Sq + row`` lands on ``col <= start + i``.
        Padding rows attend into unwritten (zeroed or stale) columns;
        row-wise ops keep that in the discarded rows. Returns (token
        sampled at position ``start + valid - 1``, caches)."""
        start, valid = int(start), int(valid)
        ids_np = np.asarray(ids, np.int64)
        table_np = np.asarray(table, np.int64)
        c = ids_np.shape[0]
        width = table_np.shape[0]
        page_size = caches[0].shape[2]
        scratch = caches[0].shape[0] - 1
        pos = start + np.arange(c)
        live = np.arange(c) < valid
        page_idx = np.minimum(pos // page_size, width - 1)
        phys = np.where(live, table_np[page_idx], scratch)
        (logits,) = self._run(
            "chunk", caches,
            (ids_np, np.minimum(pos, self.max_len - 1), phys,
             pos % page_size, table_np[None], [start + c], [valid - 1]),
            self._chunk_body)
        tok = _sample_row(logits, temperature, top_k, top_p, seed,
                          start + valid - 1)
        return tok, caches

    def _chunk_body(self, caches, ids, pos, phys, off, table, kv_len, last):
        p = self.params
        c = ids.shape[0]
        x = p["embed"][ids] + p["pos"][pos]
        tbl, kvl = table.to(torch.int32), kv_len.to(torch.int32)
        for i in range(self.layers):
            h = self._ln(x, f"l{i}_ln1")
            q, k, v = self._qkv(h, i)               # (C, H, D)
            self._write(caches, i, phys, off, k, v)
            o = paged_flash_attention(
                q.transpose(0, 1)[None].contiguous(),       # (1,H,C,D)
                caches[2 * i], caches[2 * i + 1], tbl, kvl)
            o = o[0].transpose(0, 1).reshape(c, self.units)
            x = x + o.to(x.dtype) @ p[f"l{i}_wo"]
            x = x + self._mlp(self._ln(x, f"l{i}_ln2"), i)
        return self._last_logits(x, last)

    # -- decode -------------------------------------------------------------
    @torch.no_grad()
    def decode_logits(self, caches, ids, positions, tables):
        """The forward half of :meth:`decode_step`: ids/positions (R,),
        tables (R, W) page-table rows. Each row writes its new K/V at
        ``positions[r]`` and attends over its own pages up to
        ``positions[r] + 1`` — rows are numerically independent, which
        is what makes join/leave invisible to the sequences already
        running. Returns ((R, vocab) logits, caches)."""
        return self._decode(caches, ids, positions, tables)[0], caches

    def _decode(self, caches, ids, positions, tables):
        """(logits, greedy tokens) of one decode step."""
        positions = np.asarray(positions, np.int64)
        tables_np = np.asarray(tables, np.int64)
        r = positions.shape[0]
        page_size = caches[0].shape[2]
        return self._run(
            "decode", caches,
            (np.asarray(ids, np.int64),
             np.minimum(positions, self.max_len - 1),
             tables_np[np.arange(r), positions // page_size],
             positions % page_size, tables_np, positions + 1),
            self._decode_body)

    def _decode_body(self, caches, ids, pos, phys, off, tables, kv_lens):
        p = self.params
        r = ids.shape[0]
        x = p["embed"][ids] + p["pos"][pos]
        tbl, kvl = tables.to(torch.int32), kv_lens.to(torch.int32)
        for i in range(self.layers):
            h = self._ln(x, f"l{i}_ln1")
            q, k, v = self._qkv(h, i)               # (R, H, D)
            self._write(caches, i, phys, off, k, v)
            o = paged_flash_attention(q[:, :, None, :].contiguous(),
                                      caches[2 * i], caches[2 * i + 1],
                                      tbl, kvl)
            x = x + o[:, :, 0, :].reshape(r, self.units).to(x.dtype) \
                @ p[f"l{i}_wo"]
            x = x + self._mlp(self._ln(x, f"l{i}_ln2"), i)
        logits = self._ln(x, "lnf") @ p["head"]
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def decode_step(self, caches, ids, positions, tables,
                    temperatures=None, top_ks=None, top_ps=None,
                    seeds=None):
        """One continuous-batch iteration (:meth:`decode_logits`, then
        per-row sampling). Returns ((R,) int32 tokens on the model's
        device, caches)."""
        logits, toks = self._decode(caches, ids, positions, tables)
        positions = np.asarray(positions, np.int64)
        r = positions.shape[0]

        def _vec(vals, fill):
            return [fill] * r if vals is None else np.asarray(vals).tolist()

        temps = _vec(temperatures, 0.0)
        for j, (t, kk, pp, sd) in enumerate(zip(
                temps, _vec(top_ks, 0), _vec(top_ps, 1.0),
                _vec(seeds, 0))):
            if t > 0.0:
                toks[j] = _sample_row(logits[j], t, kk, pp, sd,
                                      positions[j])
        return toks, caches
