"""Model zoo of the PyTorch port (``mxnet_tpu/gluon/model_zoo``'s
counterpart): the BERT trunk, its MLM/NSP heads and its serving entry,
the vision ResNets and VGGs (``vision``), the Wide & Deep recommender
and the local pretrained-weight store (``model_store``)."""
from __future__ import annotations

from . import bert, model_store, vision
from .bert import (BERTMLMHead, BERTModel, BERTNSPHead, bert_base,
                   bert_large, bert_serving_entry, get_bert)
from . import wide_deep as wide_deep_zoo
from .wide_deep import WideDeep, wide_deep

__all__ = ["BERTMLMHead", "BERTModel", "BERTNSPHead", "WideDeep", "bert",
           "bert_base", "bert_large", "bert_serving_entry", "get_bert",
           "model_store", "vision", "wide_deep", "wide_deep_zoo"]
