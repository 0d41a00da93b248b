"""Model zoo of the PyTorch port (``mxnet_tpu/gluon/model_zoo``'s
counterpart): the BERT trunk and its serving entry."""
from __future__ import annotations

from . import bert
from .bert import (BERTModel, bert_base, bert_large, bert_serving_entry,
                   get_bert)

__all__ = ["BERTModel", "bert", "bert_base", "bert_large",
           "bert_serving_entry", "get_bert"]
