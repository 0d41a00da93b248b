"""``mx.mod``/``mx.module``: the symbolic training modules (port of
``mxnet_tpu/module/``)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
