"""Vision models of the PyTorch port
(``mxnet_tpu/gluon/model_zoo/vision``'s counterpart): the ResNets and
the VGGs. AlexNet, DenseNet, Inception, MobileNet and SqueezeNet are
not ported yet (ROADMAP Queue 1, 'Vision remainders');
``pretrained=True`` loads the weights from the local model store
(``model_store.py``), which never downloads."""
from __future__ import annotations

from . import resnet, vgg
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "SpaceToDepthStem", "VGG", "get_model",
           "get_resnet", "get_vgg", "resnet", "resnet101_v1", "resnet101_v2",
           "resnet152_v1", "resnet152_v2", "resnet18_v1", "resnet18_v2",
           "resnet34_v1", "resnet34_v2", "resnet50_v1", "resnet50_v2", "vgg",
           "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn",
           "vgg19", "vgg19_bn"]

_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for n in (18, 34, 50, 101, 152) for v in (1, 2)}
_models.update({f"vgg{n}{bn}": globals()[f"vgg{n}{bn}"]
                for n in (11, 13, 16, 19) for bn in ("", "_bn")})


def get_model(name, **kwargs):
    """A model by its model-zoo name (``"resnet50_v1"``, ``"vgg16"``,
    ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)} (AlexNet, DenseNet, Inception, "
                         f"MobileNet and SqueezeNet are not ported yet: "
                         f"ROADMAP Queue 1, 'Vision remainders')")
    return _models[name](**kwargs)
