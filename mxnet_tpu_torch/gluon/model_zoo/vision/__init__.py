"""Vision models of the PyTorch port
(``mxnet_tpu/gluon/model_zoo/vision``'s counterpart): the ResNets.
AlexNet, DenseNet, Inception, MobileNet, SqueezeNet and VGG are not
ported yet (ROADMAP Queue 1, 'Vision remainders'); pretrained weights
wait for parameter files."""
from __future__ import annotations

from . import resnet
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "SpaceToDepthStem", "get_model",
           "get_resnet", "resnet", "resnet101_v1", "resnet101_v2",
           "resnet152_v1", "resnet152_v2", "resnet18_v1", "resnet18_v2",
           "resnet34_v1", "resnet34_v2", "resnet50_v1", "resnet50_v2"]

_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for n in (18, 34, 50, 101, 152) for v in (1, 2)}


def get_model(name, **kwargs):
    """A model by its model-zoo name (``"resnet50_v1"``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)} (the other vision models are "
                         f"not ported yet: ROADMAP Queue 1, 'Vision "
                         f"remainders')")
    return _models[name](**kwargs)
