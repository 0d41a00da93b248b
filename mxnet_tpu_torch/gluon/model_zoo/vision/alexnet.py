"""AlexNet.

Port of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``: the JAX
block's ``hybrid_forward`` and layers, so parameters and ``export``
carry the JAX model's names (give the JAX model's ``prefix``).
``device=None`` is the current context's device; ``pretrained=True``
loads the local model store's weights (``model_store.py``).
"""
from __future__ import annotations

from ....context import Context, resolve_device
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        with Context.of(resolve_device(device)), self.name_scope():
            # the JAX block also enters features' scope: a block with an
            # empty prefix keeps the enclosing one, so no scope here
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                        padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "alexnet", ctx=ctx, root=root)
    return net
