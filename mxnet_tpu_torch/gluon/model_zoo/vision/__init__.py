"""Vision models of the PyTorch port
(``mxnet_tpu/gluon/model_zoo/vision``'s counterpart): the ResNets, the
VGGs, AlexNet, DenseNet, Inception V3, MobileNet V1/V2 and SqueezeNet,
under the JAX package's constructor names and ``get_model`` keys
(``"mobilenet1.0"``, ``"inceptionv3"``, ...). ``pretrained=True``
loads the weights from the local model store (``model_store.py``),
which never downloads."""
from __future__ import annotations

from . import densenet, inception, mobilenet, resnet, squeezenet, vgg
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, get_densenet)
from .inception import Inception3, inception_v3
from .mobilenet import (MobileNet, MobileNetV2, get_mobilenet,
                        get_mobilenet_v2, mobilenet0_5, mobilenet0_25,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_5,
                        mobilenet_v2_0_25, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .squeezenet import SqueezeNet, get_squeezenet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

__all__ = ["AlexNet", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
           "BottleneckV2", "DenseNet", "Inception3", "MobileNet",
           "MobileNetV2", "ResNetV1", "ResNetV2", "SpaceToDepthStem",
           "SqueezeNet", "VGG", "alexnet", "densenet121", "densenet161",
           "densenet169", "densenet201", "get_densenet", "get_mobilenet",
           "get_mobilenet_v2", "get_model", "get_resnet", "get_squeezenet",
           "get_vgg", "inception_v3", "mobilenet0_25", "mobilenet0_5",
           "mobilenet0_75", "mobilenet1_0", "mobilenet_v2_0_25",
           "mobilenet_v2_0_5", "mobilenet_v2_0_75", "mobilenet_v2_1_0",
           "resnet", "resnet101_v1", "resnet101_v2", "resnet152_v1",
           "resnet152_v2", "resnet18_v1", "resnet18_v2", "resnet34_v1",
           "resnet34_v2", "resnet50_v1", "resnet50_v2", "squeezenet1_0",
           "squeezenet1_1", "vgg", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn",
           "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]

_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for n in (18, 34, 50, 101, 152) for v in (1, 2)}
_models.update({f"vgg{n}{bn}": globals()[f"vgg{n}{bn}"]
                for n in (11, 13, 16, 19) for bn in ("", "_bn")})
_models.update({
    "alexnet": alexnet,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
})


def get_model(name, **kwargs):
    """A model by its model-zoo name (``"resnet50_v1"``, ``"vgg16"``,
    ``"mobilenet1.0"``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
