"""``mx.contrib.amp``: automatic mixed precision (port of
``mxnet_tpu/contrib/amp``)."""
from . import lists
from .amp import (LossScaler, convert_model, disable, init, init_trainer,
                  is_initialized, scale_loss, target_dtype, unscale)

__all__ = ["LossScaler", "convert_model", "disable", "init", "init_trainer",
           "is_initialized", "lists", "scale_loss", "target_dtype",
           "unscale"]
