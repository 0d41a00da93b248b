"""Model zoo of the PyTorch port (``mxnet_tpu/gluon/model_zoo``'s
counterpart): the BERT trunk, its MLM/NSP heads and its serving entry,
and the vision ResNets (``vision``)."""
from __future__ import annotations

from . import bert, vision
from .bert import (BERTMLMHead, BERTModel, BERTNSPHead, bert_base,
                   bert_large, bert_serving_entry, get_bert)

__all__ = ["BERTMLMHead", "BERTModel", "BERTNSPHead", "bert", "bert_base",
           "bert_large", "bert_serving_entry", "get_bert", "vision"]
