"""VGG 11/13/16/19 and their BatchNorm forms.

Port of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: ``features`` holds
each stage's 3x3 convolutions (padding 1, Xavier weights), each
followed by ReLU (with ``batch_norm``, a BatchNorm between), and a 2x2
max pool a stage, then two Dense(4096, relu) + Dropout(0.5); ``output``
is the classifier. The parameters carry the JAX model's names (Gluon:
``conv2d0_weight``, ..., ``dense2_bias`` in the model's scope;
structural: ``features.0.weight``, ..., ``output.bias``), so
``.params`` files pass between the two. The first Dense takes its
width from the first batch (512 x 7 x 7 at 224 x 224). ``device=None``
is the current context's device. ``pretrained=True`` loads the local
model store's weights (``model_store.py``). ``export`` writes the JAX
model's graph (each layer's ``hybrid_forward``).
"""
from __future__ import annotations

from ....context import resolve_device
from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "get_vgg", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn",
           "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]


class VGG(HybridBlock):
    """``layers[i]`` convolutions of ``filters[i]`` channels a stage."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 in_channels=3, prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        if len(layers) != len(filters):
            raise ValueError("layers and filters must have one entry a stage")
        kw = {"device": resolve_device(device)}
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm,
                                                in_channels, kw)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal", **kw))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       in_units=4096, **kw))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   in_units=4096, **kw)

    @staticmethod
    def _make_features(layers, filters, batch_norm, in_channels, kw):
        featurizer = nn.HybridSequential(prefix="")
        c = in_channels
        for num, f in zip(layers, filters):
            for _ in range(num):
                featurizer.add(nn.Conv2D(f, kernel_size=3, padding=1,
                                         in_channels=c,
                                         weight_initializer="xavier", **kw))
                if batch_norm:
                    featurizer.add(nn.BatchNorm(in_channels=f, **kw))
                featurizer.add(nn.Activation("relu"))
                c = f
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16, 19); ``kwargs`` go to
    :class:`VGG` (``classes``, ``batch_norm``, ``device``, ...).
    ``pretrained=True`` loads ``vgg{num_layers}`` (``_bn`` with batch
    norm) from the local model store (``model_store.py``: ``root``,
    else its default root) onto ``ctx``; ``ctx`` also places the net
    when ``device`` is not given."""
    if num_layers not in vgg_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(vgg_spec)}")
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        bn = "_bn" if kwargs.get("batch_norm") else ""
        load_pretrained(net, f"vgg{num_layers}{bn}", ctx=ctx, root=root)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
