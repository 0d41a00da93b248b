"""ResNet V1 and V2 (BASELINE config 2, the ImageNet model).

Port of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``: the same
blocks (``BasicBlockV1/V2``, ``BottleneckV1/V2``), the ``thumbnail``
stem for small images and the space-to-depth stem (``stem="s2d"``).
Parameters carry the JAX model's Gluon names without the model prefix
(``conv2d0_weight``, ``stage1_batchnorm3_running_var``,
``stage4_conv2d9_bias``, ``dense0_weight``). Gluon counts its names per
name scope: the model's scope holds the stem, the stages, the last
BatchNorm and the Dense, and each stage's scope holds the layers of
all its blocks, counted on across them (the blocks have an empty
prefix). :class:`_Names` hands out the same counters explicitly (the
containers take the empty prefix). Each layer takes its bias as the JAX one
does: ``BottleneckV1``'s first and last 1x1 convolutions have one, the
3x3 convolutions, the downsample convolutions and ``BottleneckV2``'s
do not.

Shapes are given at construction: ``in_channels`` is the images'
channel count (3), where the JAX model infers it from the first batch;
the structural names (``features.0.weight``, ...) are the JAX model's,
so ``save_parameters``/``load_parameters`` files pass between the two.
``remat_stages`` marks each residual block of those stages (1-based)
for activation recompute: when the hybridized net runs under
``record()``, each such block's activations are recomputed in the
backward (``torch.utils.checkpoint``; ``remat_policy`` as
``HybridBlock.hybridize``'s, ``"names:conv_out"`` keeping the
convolutions' outputs).
``device=None`` is the current context's device and raises without a
card. A Symbol goes through each block's ``hybrid_forward``, the JAX
block's F-ops, so ``export`` writes the JAX model's graph (give the
JAX model's ``prefix`` for its names).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....context import resolve_device
from ....ndarray import op_impl_nn as _nn
from ...block import HybridBlock
from ... import nn

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "SpaceToDepthStem", "get_resnet",
           "resnet101_v1", "resnet101_v2", "resnet152_v1", "resnet152_v2",
           "resnet18_v1", "resnet18_v2", "resnet34_v1", "resnet34_v2",
           "resnet50_v1", "resnet50_v2"]


class _Names:
    """One Gluon name scope's counters: ``_Names()("conv2d")`` gives
    ``"conv2d0_"``, then ``"conv2d1_"``, ..."""

    def __init__(self):
        self._count = {}

    def __call__(self, hint):
        n = self._count.get(hint, 0)
        self._count[hint] = n + 1
        return f"{hint}{n}_"


def _conv(names, channels, kernel, stride, pad, in_channels, use_bias, kw):
    return nn.Conv2D(channels, kernel, stride, pad, use_bias=use_bias,
                     in_channels=in_channels, prefix=names("conv2d"), **kw)


def _conv3x3(names, channels, stride, in_channels, kw):
    return _conv(names, channels, 3, stride, 1, in_channels, False, kw)


def _bn(names, channels, kw, **args):
    return nn.BatchNorm(in_channels=channels, prefix=names("batchnorm"),
                        **args, **kw)


def _relu(names):
    return nn.Activation("relu", prefix=names("relu"))


def space_to_depth(x, block_size):
    """(N, C, H, W) -> (N, C * b * b, H / b, W / b) with channel
    ``(dy * b + dx) * C + c`` (the JAX op's packing,
    ``op_impl_basic.py:466``; ``F.pixel_unshuffle`` packs ``c * b * b +
    dy * b + dx``)."""
    b = int(block_size)
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


class SpaceToDepthStem(HybridBlock):
    """The ``Conv2D(channels, 7, strides=2, padding=3)`` stem computed
    exactly as a 2x2 space-to-depth and a 4x4 stride-1 convolution over
    ``4 * in_channels`` channels. The weight keeps the plain stem's
    shape ``(channels, in_channels, 7, 7)`` and name; the 4x4 kernel is
    derived from it on each call: the 7x7 taps padded to 8x8 at the
    front, grouped by parity to match :func:`space_to_depth`'s packing,
    with the input padded 2 low and 1 high for the original pad of 3.
    H and W must be even."""

    def __init__(self, channels, in_channels=3, prefix="", device=None):
        super().__init__(prefix)
        self._channels = channels
        self._in_channels = in_channels
        self.weight = self._param((channels, in_channels, 7, 7),
                                  torch.float32, resolve_device(device))

    def forward(self, x):
        if x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError(f"SpaceToDepthStem requires even H and W (2x2 "
                             f"space-to-depth); got {tuple(x.shape)}: use "
                             f"stem='conv' for odd input sizes")
        o, c = self._channels, self._in_channels
        wp = F.pad(self.weight, (1, 0, 1, 0))
        w2 = wp.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4) \
            .reshape(o, 4 * c, 4, 4)
        y = F.pad(space_to_depth(x, 2), (2, 1, 2, 1))
        return _nn.convolution(y, w2, None, kernel=(4, 4), stride=(1, 1),
                               pad=(0, 0), no_bias=True)

    def hybrid_forward(self, F, x, weight):
        o, c = self._channels, self._in_channels
        wp = F.pad(weight, mode="constant",
                   pad_width=(0, 0, 0, 0, 1, 0, 1, 0))
        w2 = wp.reshape((o, c, 4, 2, 4, 2)) \
               .transpose((0, 3, 5, 1, 2, 4)) \
               .reshape((o, 4 * c, 4, 4))
        y = F.space_to_depth(x, block_size=2)
        y = F.pad(y, mode="constant", pad_width=(0, 0, 0, 0, 2, 1, 2, 1))
        return F.Convolution(y, w2, None, kernel=(4, 4), stride=(1, 1),
                             pad=(0, 0), num_filter=o, no_bias=True)


def _stem_conv(names, channels, stem, in_channels, kw):
    if stem == "s2d":
        return SpaceToDepthStem(channels, in_channels,
                                prefix=names("spacetodepthstem"), **kw)
    if stem != "conv":
        raise ValueError(f"unknown stem {stem!r}: 'conv' or 's2d'")
    return _conv(names, channels, 7, 2, 3, in_channels, False, kw)


class _Residual(HybridBlock):
    """A residual block's layers, named in the stage's scope (``names``;
    a fresh scope when None)."""

    def __init__(self, names, prefix, device):
        super().__init__(prefix)
        self._names = _Names() if names is None else names
        self._kw = {"device": resolve_device(device)}

    def _downsample(self, channels, stride, in_channels, with_bn):
        ds = nn.HybridSequential(prefix="")
        ds.add(_conv(self._names, channels, 1, stride, 0, in_channels,
                     False, self._kw))
        if with_bn:
            ds.add(_bn(self._names, channels, self._kw))
        return ds


class BasicBlockV1(_Residual):
    """conv3x3-BN-relu-conv3x3-BN, plus the input (or its 1x1
    downsample + BN), then relu."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 names=None, prefix="", device=None):
        super().__init__(names, prefix, device)
        n, kw = self._names, self._kw
        self.body = nn.HybridSequential(prefix="").add(
            _conv3x3(n, channels, stride, in_channels, kw),
            _bn(n, channels, kw), _relu(n),
            _conv3x3(n, channels, 1, channels, kw),
            _bn(n, channels, kw))
        self.downsample = self._downsample(channels, stride, in_channels,
                                           True) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + self.body(x))

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(_Residual):
    """1x1 (bias, stride) - 3x3 - 1x1 (bias) with BN and relu between,
    plus the input (or its downsample), then relu."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 names=None, prefix="", device=None):
        super().__init__(names, prefix, device)
        n, kw, mid = self._names, self._kw, channels // 4
        self.body = nn.HybridSequential(prefix="").add(
            _conv(n, mid, 1, stride, 0, in_channels, True, kw),
            _bn(n, mid, kw), _relu(n),
            _conv3x3(n, mid, 1, mid, kw),
            _bn(n, mid, kw), _relu(n),
            _conv(n, channels, 1, 1, 0, mid, True, kw),
            _bn(n, channels, kw))
        self.downsample = self._downsample(channels, stride, in_channels,
                                           True) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.body(x) + residual)

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(_Residual):
    """Pre-activation: BN-relu-conv3x3-BN-relu-conv3x3, plus the input
    (or the 1x1 downsample of the first activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 names=None, prefix="", device=None):
        super().__init__(names, prefix, device)
        n, kw = self._names, self._kw
        self.bn1 = _bn(n, in_channels, kw)
        self.conv1 = _conv3x3(n, channels, stride, in_channels, kw)
        self.bn2 = _bn(n, channels, kw)
        self.conv2 = _conv3x3(n, channels, 1, channels, kw)
        self.downsample = _conv(n, channels, 1, stride, 0, in_channels,
                                False, kw) if downsample else None

    def forward(self, x):
        residual = x
        x = F.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.relu(self.bn2(x)))
        return x + residual

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.bn2(self.conv1(x))
        x = self.conv2(F.Activation(x, act_type="relu"))
        return x + residual


class BottleneckV2(_Residual):
    """Pre-activation bottleneck: BN-relu-1x1-BN-relu-3x3 (stride)-
    BN-relu-1x1, no biases, plus the input (or the downsample of the
    first activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 names=None, prefix="", device=None):
        super().__init__(names, prefix, device)
        n, kw, mid = self._names, self._kw, channels // 4
        self.bn1 = _bn(n, in_channels, kw)
        self.conv1 = _conv(n, mid, 1, 1, 0, in_channels, False, kw)
        self.bn2 = _bn(n, mid, kw)
        self.conv2 = _conv3x3(n, mid, stride, mid, kw)
        self.bn3 = _bn(n, mid, kw)
        self.conv3 = _conv(n, channels, 1, 1, 0, mid, False, kw)
        self.downsample = _conv(n, channels, 1, stride, 0, in_channels,
                                False, kw) if downsample else None

    def forward(self, x):
        residual = x
        x = F.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.relu(self.bn2(x)))
        x = self.conv3(F.relu(self.bn3(x)))
        return x + residual

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.bn2(self.conv1(x))
        x = self.bn3(self.conv2(F.Activation(x, act_type="relu")))
        x = self.conv3(F.Activation(x, act_type="relu"))
        return x + residual


def _mark_remat(stage, policy=None):
    """Flag every residual block of a stage for activation recompute
    when an ancestor's CachedOp runs it (``active=False``: the blocks
    keep no CachedOp of their own)."""
    for blk in stage.children():
        blk.hybridize(active=False, remat=True, remat_policy=policy)


class _ResNet(HybridBlock):
    """The stem, four stages, global pooling and the Dense classifier,
    named in the model's scope."""

    def __init__(self, prefix, device):
        super().__init__(prefix)
        self._names = _Names()
        self._kw = {"device": resolve_device(device)}
        self.features = nn.HybridSequential(prefix="")

    def _add_stem(self, channels, thumbnail, stem, in_channels):
        n, kw = self._names, self._kw
        if thumbnail:
            self.features.add(_conv3x3(n, channels, 1, in_channels, kw))
        else:
            self.features.add(
                _stem_conv(n, channels, stem, in_channels, kw),
                _bn(n, channels, kw), _relu(n),
                nn.MaxPool2D(3, 2, 1, prefix=n("maxpool2d")))

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels):
        names = _Names()
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, names=names, **self._kw))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            names=names, **self._kw))
        return layer

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """ResNet V1: ``block`` (``BasicBlockV1`` or ``BottleneckV1``),
    ``layers`` blocks per stage, ``channels`` of the stem and of each
    stage; global average pooling feeds the Dense directly."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stem="conv", remat_stages=(),
                 remat_policy=None, in_channels=3, prefix="",
                 device=None):
        super().__init__(prefix, device)
        if len(layers) != len(channels) - 1:
            raise ValueError("len(layers) must be len(channels) - 1")
        self._add_stem(channels[0], thumbnail, stem, in_channels)
        for i, num_layer in enumerate(layers):
            stage = self._make_layer(block, num_layer, channels[i + 1],
                                     1 if i == 0 else 2, i + 1, channels[i])
            if (i + 1) in remat_stages:
                _mark_remat(stage, remat_policy)
            self.features.add(stage)
        self.features.add(nn.GlobalAvgPool2D(prefix=self._names("globalavgpool2d")))
        self.output = nn.Dense(classes, in_units=channels[-1],
                               prefix=self._names("dense"), **self._kw)


class ResNetV2(_ResNet):
    """ResNet V2: a parameter-free BatchNorm of the input
    (``scale=False, center=False``), the stem, pre-activation stages,
    BN-relu, global average pooling, ``Flatten`` and the Dense."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stem="conv", remat_stages=(),
                 remat_policy=None, in_channels=3, prefix="",
                 device=None):
        super().__init__(prefix, device)
        if len(layers) != len(channels) - 1:
            raise ValueError("len(layers) must be len(channels) - 1")
        n, kw = self._names, self._kw
        self.features.add(_bn(n, in_channels, kw, scale=False,
                              center=False))
        self._add_stem(channels[0], thumbnail, stem, in_channels)
        in_c = channels[0]
        for i, num_layer in enumerate(layers):
            stage = self._make_layer(block, num_layer, channels[i + 1],
                                     1 if i == 0 else 2, i + 1, in_c)
            if (i + 1) in remat_stages:
                _mark_remat(stage, remat_policy)
            self.features.add(stage)
            in_c = channels[i + 1]
        self.features.add(_bn(n, in_c, kw), _relu(n),
                          nn.GlobalAvgPool2D(prefix=n("globalavgpool2d")),
                          nn.Flatten(prefix=n("flatten")))
        self.output = nn.Dense(classes, in_units=in_c, prefix=n("dense"),
                               **kw)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to the net (``classes``, ``thumbnail``,
    ``stem``, ``device``, ...). ``pretrained=True`` loads
    ``resnet{num_layers}_v{version}`` from the local model store
    (``model_store.py``: ``root``, else its default root) onto ``ctx``;
    ``ctx`` also places the net when ``device`` is not given."""
    if num_layers not in resnet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise ValueError(f"Invalid resnet version: {version}.")
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    net = resnet_net_versions[version - 1](block, layers, channels, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, f"resnet{num_layers}_v{version}", ctx=ctx,
                        root=root)
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
