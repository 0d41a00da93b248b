"""INT8 quantization of Gluon nets (``mx.contrib.quantization``).

Port of ``mxnet_tpu/contrib/quantization.py`` (the reference's
``python/mxnet/contrib/quantization.py`` over
``src/operator/quantization/``): calibration (:func:`calib_graph`,
:class:`CalibrationCollector`: running min/max, or the KL-optimal
entropy thresholds), and :func:`quantize_net`, which rewrites a Gluon
net in place, each ``nn.Dense``/``nn.Conv2D`` child swapped for a
:class:`QuantizedDense`/:class:`QuantizedConv2D` holding int8 weights
quantized once (a Conv2D followed by a BatchNorm in a Sequential
container takes the BatchNorm's inference affine into its weight and
bias, channel-wise scales, and the BatchNorm becomes an ``Identity``).
Activations are quantized at each call with the calibrated range of
the layer's input, or the batch's own range without calibration
(``act_amax <= 0``, picked on the device). ``s8_interfaces`` also
requantizes a convolution's output straight into the next chained
convolution's input scale. The products are ``op_impl_quant``'s exact
int32 sums. :func:`quantize_model` annotates a Symbol graph, as the JAX
function does.

Layer names are the JAX package's full Gluon names: the root's prefix
and the local prefixes along the module tree (``resnetv10_stage1_
conv2d0``): the calibration ranges are keyed by them and
``exclude_layers`` names them. The quantized layers' parameters
(``weight_q``, ``weight_scale``, ``act_amax``, ``bias``) checkpoint
through ``save_parameters``/``load_parameters``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..gluon import nn as _nn
from ..gluon.block import HybridBlock
from ..ndarray.op_impl_quant import _amax_scale, quantize_act, \
    quantize_weight

__all__ = ["CalibrationCollector", "QuantizedConv2D", "QuantizedDense",
           "calib_graph", "quantize_model", "quantize_net"]


def _host(t):
    """A tensor's values as a float numpy array (float64 stays)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype != torch.float64:
            t = t.to(torch.float32)
        return t.as_subclass(torch.Tensor).cpu().numpy()
    return np.asarray(t)


def _full_names(net):
    """``{id(block): name}`` over ``net``'s tree, each block's name its
    JAX counterpart's: the prefixes from the root down, less the last
    ``_``."""
    out = {}

    def walk(mod, prefix):
        out[id(mod)] = prefix[:-1] if prefix.endswith("_") else prefix
        for child in mod.children():
            walk(child, prefix + getattr(child, "_prefix", ""))

    walk(net, net._prefix)
    return out


class CalibrationCollector:
    """Collects per-layer activation statistics over calibration batches
    (reference _LayerOutputMinMaxCollector / _LayerHistogramCollector).

    ``mode="naive"``: running min/max. ``mode="entropy"``: additionally
    keeps the observed values so :meth:`ranges` can run the KL-optimal
    threshold search (reference _get_optimal_thresholds /
    src/operator/quantization/calibrate.cc) — the symmetric range that
    minimizes the KL divergence between the clipped distribution and
    its 255-level quantization, which ignores rare outliers that would
    otherwise stretch the int8 grid."""

    def __init__(self, mode="naive", num_bins=8001):
        if mode not in ("naive", "entropy"):
            raise MXNetError(f"unknown calib_mode {mode!r} "
                             "(expected 'naive' or 'entropy')")
        self.mode = mode
        self.num_bins = num_bins
        self.min_max = {}
        self._hists = {}   # name -> _RangeHistogram (entropy mode)

    def collect(self, name, arr):
        a = _host(arr)
        lo, hi = float(a.min()), float(a.max())
        if name in self.min_max:
            plo, phi = self.min_max[name]
            lo, hi = min(lo, plo), max(hi, phi)
        self.min_max[name] = (lo, hi)
        if self.mode == "entropy":
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _RangeHistogram(self.num_bins)
            h.add(np.asarray(a, np.float32).ravel())

    def ranges(self):
        """Per-layer (lo, hi) to quantize against."""
        if self.mode == "naive":
            return self.min_max
        out = {}
        for name, h in self._hists.items():
            th = _optimal_threshold_hist(h.hist, h.edges())
            out[name] = (-th, th)
        return out


class _RangeHistogram:
    """Fixed-bin symmetric histogram whose range grows with the data:
    memory per layer is one (num_bins,) float array regardless of how
    many calibration batches run (the reference's histogram collector
    does the same; storing raw activations was O(total activations))."""

    def __init__(self, num_bins=8001):
        self.num_bins = num_bins
        self.amax = 0.0
        self.hist = np.zeros(num_bins, np.float64)

    def edges(self):
        return np.linspace(-self.amax, self.amax, self.num_bins + 1)

    def add(self, values):
        amax = float(np.abs(values).max()) if values.size else 0.0
        if amax > self.amax:
            if self.hist.any():
                # re-bin the existing mass into the wider range by its
                # old bin centers (bounded coarsening, standard practice)
                centers = 0.5 * (self.edges()[:-1] + self.edges()[1:])
                old = self.hist
                self.amax = amax
                self.hist = np.histogram(
                    centers, bins=self.num_bins,
                    range=(-amax, amax), weights=old)[0].astype(np.float64)
            else:
                self.amax = amax
        if self.amax == 0.0:
            return
        self.hist += np.histogram(values, bins=self.num_bins,
                                  range=(-self.amax, self.amax))[0]


def _smooth(p, eps=1e-4):
    """Move eps mass onto empty bins so KL(p||q) stays finite; returns
    None when the distribution has no support at all."""
    zeros = p == 0
    n_nonzero = p.size - int(zeros.sum())
    if n_nonzero == 0:
        return None
    off = eps * float(zeros.sum()) / n_nonzero
    out = p.astype(np.float64).copy()
    out[zeros] = eps
    out[~zeros] -= off
    if (out[~zeros] <= 0).any():
        return None
    return out


def _kl(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float((p[mask] * np.log(p[mask] / q[mask])).sum())


def _optimal_threshold(values, num_bins=8001, num_quantized_bins=255):
    """KL-optimal threshold from raw values (tests / one-shot use;
    the collector path feeds :func:`_optimal_threshold_hist` from its
    memory-bounded histogram)."""
    amax = float(np.abs(values).max()) if values.size else 0.0
    if amax == 0.0:
        return 0.0
    hist, edges = np.histogram(values, bins=num_bins, range=(-amax, amax))
    return _optimal_threshold_hist(hist.astype(np.float64), edges,
                                   num_quantized_bins)


def _optimal_threshold_hist(hist, edges, num_quantized_bins=255):
    """KL-divergence-optimal symmetric clipping threshold (the TensorRT
    calibration recipe the reference implements in calibrate.cc): over
    a symmetric histogram, for each candidate half-width ``i`` bins,
    compare the clipped distribution P (outliers folded into the edge
    bins) against Q = P re-quantized to 255 levels; return the
    threshold with minimal KL(P||Q)."""
    num_bins = hist.shape[0]
    amax = float(edges[-1])
    if amax == 0.0 or not hist.any():
        return 0.0
    zero = num_bins // 2
    half_q = num_quantized_bins // 2
    best_th, best_kl = amax, np.inf
    for i in range(half_q + 1, zero + 1):
        lo, hi = zero - i, zero + i + 1
        p = hist[lo:hi].copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        support = hist[lo:hi] != 0  # clipped-view support, pre-fold
        # quantize the sliced histogram into 255 equal-width groups:
        # each group's mass spreads uniformly over its occupied bins
        n = hi - lo
        merged = n // num_quantized_bins
        main = hist[lo:lo + merged * num_quantized_bins].reshape(
            num_quantized_bins, merged)
        gmass = main.sum(axis=1)
        gmass[-1] += hist[lo + merged * num_quantized_bins:hi].sum()
        occ = (main != 0).sum(axis=1).astype(np.float64)
        tail_occ = (hist[lo + merged * num_quantized_bins:hi] != 0).sum()
        occ[-1] += tail_occ
        per_bin = np.divide(gmass, occ, out=np.zeros_like(gmass),
                            where=occ > 0)
        q = np.repeat(per_bin, merged)
        q = np.concatenate([q, np.full(n - q.size, per_bin[-1])])
        q[~support] = 0.0
        ps, qs = _smooth(p), _smooth(q)
        if ps is None or qs is None:
            continue
        kl = _kl(ps, qs)
        if kl < best_kl:
            best_kl, best_th = kl, float(edges[hi])
    return best_th


def calib_graph(net, calib_data, num_batches=10, inputs=False,
                mode="naive"):
    """Run up to ``num_batches`` calibration batches (``(data, ...)``
    tuples or ``DataBatch``es) through ``net``, hooking every child's
    output (or its first input with ``inputs=True``: what the int8
    layers consume); ``mode="entropy"`` hooks the leaves only. Returns
    ``{layer name: (lo, hi)}``."""
    collector = CalibrationCollector(mode=mode)
    names = _full_names(net)
    handles = []

    def walk(block):
        for child in block.children():
            if mode != "entropy" or not any(True for _ in child.children()):
                name = names[id(child)]
                if inputs:
                    handles.append(child.register_forward_pre_hook(
                        lambda blk, ins, n=name: collector.collect(
                            n, ins[0])))
                else:
                    handles.append(child.register_forward_hook(
                        lambda blk, ins, out, n=name: collector.collect(
                            n, out)))
            walk(child)

    walk(net)
    try:
        seen = 0
        for batch in calib_data:
            data = batch[0] if isinstance(batch, (list, tuple)) \
                else batch.data[0]
            net(data)
            seen += 1
            if seen >= num_batches:
                break
    finally:
        for h in handles:
            h.remove()
    return collector.ranges()


class _QuantizedBase(HybridBlock):
    """int8 weights and their scales, quantized once from a float layer,
    in parameters (``weight_q``, ``weight_scale``, ``act_amax``, and
    ``bias`` where the layer had one or a BatchNorm was folded in), so
    a quantized net checkpoints like any; ``act_amax <= 0`` means the
    batch's own activation range."""

    @torch.no_grad()
    def _quantize_weight(self, float_layer, device, act_range, fold_bn=None,
                         channelwise=False):
        wf = float_layer.weight.detach().to(device, torch.float32)
        fold_bias = None
        if fold_bn is not None:
            # the BatchNorm's inference affine folded into the weight and
            # bias: w' = w * g / sigma a channel, b' = beta - mu * g /
            # sigma (+ b * g / sigma)
            gam, bet, mu, var = (t.detach().to(device, torch.float32) for t in (
                fold_bn.gamma, fold_bn.beta, fold_bn.running_mean,
                fold_bn.running_var))
            # the square root in float64, rounded once to float32: the
            # correctly rounded value, as CUDA's and XLA's (torch's
            # vectorized float32 square root on the CPU is not, and the
            # codes would differ between the card and the CPU)
            root = torch.sqrt((var + fold_bn._epsilon).double()).float()
            bscale = gam / root
            wf = wf * bscale.reshape((-1,) + (1,) * (wf.ndim - 1))
            b0 = float_layer.bias.detach().to(device, torch.float32) \
                if float_layer.bias is not None else 0.0
            fold_bias = bet - mu * bscale + b0 * bscale
        q, s = quantize_weight(wf, channelwise=channelwise)
        if fold_bias is None and float_layer.bias is not None:
            fold_bias = float_layer.bias.detach().to(device, torch.float32)
        amax = (max(abs(act_range[0]), abs(act_range[1]))
                if act_range is not None else -1.0)
        values = {"weight_q": q, "weight_scale": s,
                  "act_amax": torch.tensor([amax], dtype=torch.float32)}
        if fold_bias is not None:
            values["bias"] = fold_bias
        for name, v in values.items():
            p = self.params.get(name, shape=tuple(v.shape), dtype=v.dtype,
                                init="zeros", grad_req="null", ctx=device)
            p.set_data(v)
            p._tensor._mx_initialized = True
            setattr(self, name, p)
        if fold_bias is None:
            self.bias = None


class QuantizedDense(_QuantizedBase):
    """int8 replacement for ``nn.Dense``: weights quantized once, the
    input quantized at each call (its calibrated range when there is
    one), the layer's activation after the float result."""

    def __init__(self, float_layer, act_range=None, ctx=None, prefix=None):
        super().__init__(prefix=prefix or (float_layer.name + "_int8_"))
        device = resolve_device(ctx) if ctx is not None \
            else float_layer.weight.device
        self._units = float_layer._units
        self._flatten = float_layer._flatten
        self._act = float_layer.act
        self._quantize_weight(float_layer, device, act_range)

    def hybrid_forward(self, F, x, weight_q, weight_scale, act_amax,
                       bias=None):
        q, s = quantize_act(x, act_amax)
        out = F.quantized_fully_connected(
            q, weight_q, s, weight_scale, bias, num_hidden=self._units,
            flatten=self._flatten, no_bias=bias is None).to(x.dtype)
        return self._act(out) if self._act is not None else out


class QuantizedConv2D(_QuantizedBase):
    """int8 replacement for ``nn.Conv2D`` (channel-wise weight scales;
    ``fold_bn`` folds a following BatchNorm in). Chained by
    ``quantize_net(s8_interfaces=True)``, its output is int8 at the next
    convolution's input scale (``_out_req``, that layer's ``act_amax``)
    and that layer takes it as it is (``_prequantized``)."""

    def __init__(self, float_layer, act_range=None, ctx=None, prefix=None,
                 fold_bn=None):
        super().__init__(prefix=prefix or (float_layer.name + "_int8_"))
        device = resolve_device(ctx) if ctx is not None \
            else float_layer.weight.device
        k = float_layer._kwargs
        self._conv_kw = {"kernel": k["kernel"], "stride": k["stride"],
                         "dilate": k["dilate"], "pad": k["pad"],
                         "num_filter": float_layer._channels,
                         "num_group": k["num_group"]}
        self._act = float_layer.act
        self._out_req = None
        self._prequantized = False
        # the model's float type: a chained input is int8
        self._float_dtype = float_layer.weight.dtype
        self._quantize_weight(float_layer, device, act_range,
                              fold_bn=fold_bn, channelwise=True)

    def hybrid_forward(self, F, x, weight_q, weight_scale, act_amax,
                       bias=None):
        if self._prequantized and x.dtype == torch.int8:
            # the producer requantized into this layer's calibrated scale
            q, s = x, _amax_scale(act_amax.reshape(())).reshape(1)
        else:
            q, s = quantize_act(x, act_amax)
        out = F.quantized_conv(q, weight_q, s, weight_scale, bias,
                               self._out_req, **self._conv_kw,
                               no_bias=bias is None)
        if self._out_req is not None:
            return out          # int8, for the chained consumer
        out = out.to(self._float_dtype if x.dtype == torch.int8
                     else x.dtype)
        return self._act(out) if self._act is not None else out


def quantize_net(net, quantized_dtype="int8", calib_data=None,
                 calib_mode="naive", num_calib_examples=32, ctx=None,
                 exclude_layers=(), s8_interfaces=False, **kwargs):
    """Rewrite ``net`` in place so its ``Dense``/``Conv2D`` children run
    in int8, and return it (the JAX function's contract).

    With ``calib_data``, each layer's input range is collected first
    over ``max(1, num_calib_examples // 32)`` batches (static scales;
    ``calib_mode`` ``"naive"`` or ``"entropy"``); without, each batch
    is quantized at its own range. A Conv2D directly followed in a
    Sequential container by a channel-axis BatchNorm, with no inline
    activation, takes the BatchNorm in. ``exclude_layers`` names layers
    (full names) to leave in float. The net's CachedOp is turned off
    first (``hybridize`` again after)."""
    if quantized_dtype != "int8":
        raise MXNetError(f"only int8 is supported, got {quantized_dtype}")
    if s8_interfaces and calib_data is None:
        # refused before the in-place rewrite starts
        raise MXNetError(
            "s8_interfaces=True needs calibrated (static) activation "
            "ranges — pass calib_data")
    net.hybridize(active=False)
    ranges = {}
    if calib_data is not None:
        ranges = calib_graph(net, calib_data,
                             num_batches=max(1, num_calib_examples // 32),
                             inputs=True, mode=calib_mode)
    names = _full_names(net)

    def rewrite(block):
        items = list(block._modules.items())
        for idx, (key, child) in enumerate(items):
            rewrite(child)
            name = names[id(child)]
            if name in exclude_layers:
                continue
            if type(child) is _nn.Dense:
                qlayer = QuantizedDense(child, ranges.get(name), ctx)
            elif type(child) is _nn.Conv2D:
                # fold only where adjacency is dataflow (a Sequential),
                # the conv has no inline activation (the float graph is
                # then BN(act(conv))) and the BatchNorm normalizes the
                # conv's output channels
                fold_bn = None
                nxt = items[idx + 1][1] if idx + 1 < len(items) else None
                if isinstance(block, _nn.Sequential) and child.act is None \
                        and type(nxt) is _nn.BatchNorm and nxt._axis == 1 \
                        and names[id(nxt)] not in exclude_layers:
                    fold_bn = nxt
                qlayer = QuantizedConv2D(child, ranges.get(name), ctx,
                                         fold_bn=fold_bn)
                if fold_bn is not None:
                    block._modules[items[idx + 1][0]] = _nn.Identity(
                        prefix=fold_bn.name + "_folded_")
            else:
                continue
            block._modules[key] = qlayer

    rewrite(net)
    if s8_interfaces:
        _chain_s8_interfaces(net)
    net._quantized_dtype = quantized_dtype
    net._quant_ranges = ranges
    return net


def _chain_s8_interfaces(net):
    """Within each Sequential, a QuantizedConv2D that reaches the next
    QuantizedConv2D through only ``Identity`` and relu children
    requantizes its output into that consumer's calibrated input scale
    (relu is exact on the symmetric int8 codes); residual additions
    stay in float. A layer that appears twice in the tree is left
    unchained (its other path wants float)."""

    def passthrough(child):
        return type(child) is _nn.Identity or (
            type(child) is _nn.Activation and child._act_type == "relu")

    counts = {}

    def count(block):
        for c in block.children():
            counts[id(c)] = counts.get(id(c), 0) + 1
            count(c)

    count(net)

    def walk(block):
        if isinstance(block, _nn.Sequential):
            items = list(block.children())
            for i, child in enumerate(items):
                if not isinstance(child, QuantizedConv2D) or \
                        child._act is not None or counts[id(child)] > 1:
                    continue
                j = i + 1
                while j < len(items) and passthrough(items[j]):
                    j += 1
                if j < len(items) and isinstance(items[j], QuantizedConv2D):
                    consumer = items[j]
                    if counts[id(consumer)] > 1:
                        continue
                    amax = consumer._parameters["act_amax"]
                    if float(amax[0]) > 0:      # a calibrated range only
                        # the consumer's tensor, not a parameter of this
                        # layer
                        child.__dict__["_out_req"] = amax
                        consumer._prequantized = True
        for c in block.children():
            walk(c)

    walk(net)


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, calib_mode="naive", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   **kwargs):
    """The legacy symbolic entry point: ``(sym, arg_params,
    aux_params)`` with the ``FullyConnected``, ``Convolution`` and
    ``dot`` nodes annotated ``__quantized_dtype__``; the int8 execution
    path is :func:`quantize_net`'s rewrite (as in the JAX package)."""
    for node in sym._topo():
        if node._op is not None and node._op.name in (
                "FullyConnected", "Convolution", "dot"):
            node._attrs["__quantized_dtype__"] = quantized_dtype
    return sym, arg_params, aux_params
