"""BucketingModule: variable-length training through one module per
bucket (port of ``mxnet_tpu/module/bucketing_module.py``, MXNet's
``python/mxnet/module/bucketing_module.py``).

Each bucket key binds its own :class:`~.module.Module` of the symbol
``sym_gen(key)`` gives. A new bucket's parameter arrays are the default
bucket's own (``_share_into``): every bucket's graphs read the one
storage that the shared optimizer updates in place. All buckets'
executors share one graph cache and its memory pool, so on the card
each bucket captures its forward and backward graphs once, the first
time its key comes, and replays them after that.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..executor import _GraphCache
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None
        self._graph_cache = _GraphCache()

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, self.logger,
                      self._context, fixed_param_names=self._fixed_param_names)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if bucket_key not in self._buckets:
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes, for_training=self.for_training)
            mod._exec._graph_cache = self._graph_cache
            if self._curr_module is not None and \
                    self._curr_module.params_initialized:
                self._share_into(mod)
                mod.params_initialized = True
            elif self._init_args is not None:
                mod.init_params(**self._init_args)
            if self._curr_module is not None and \
                    self._curr_module.optimizer_initialized:
                # ONE optimizer/updater across buckets (shared state,
                # update counts advance once per step)
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod._kvstore = self._curr_module._kvstore
                mod.optimizer_initialized = True
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def _share_into(self, mod):
        """Share the default bucket's parameter ARRAYS with a new bucket
        module (the reference's shared_module): updates through any
        bucket are visible to all."""
        src = self._buckets[self._default_bucket_key]
        missing = [n for n in mod._param_names
                   if n not in src._exec.arg_dict]
        if missing:
            raise MXNetError(
                f"bucket parameters {missing} do not exist in the default "
                f"bucket {self._default_bucket_key!r}; the default bucket's "
                "graph must cover every parameter (reference contract)")
        for name in mod._param_names:
            mod._exec.arg_dict[name] = src._exec.arg_dict[name]
        for name in mod._aux_names:
            if name in src._exec.aux_dict:
                mod._exec.aux_dict[name] = src._exec.aux_dict[name]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self.for_training = for_training
        self.switch_bucket(self._default_bucket_key, data_shapes, label_shapes)
        self.binded = True

    def init_params(self, initializer=None, **kwargs):
        # positional initializer, as the reference's
        # init_params(initializer=Uniform(0.01), ...)
        kwargs = dict(kwargs, initializer=initializer)
        self._init_args = kwargs
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def init_optimizer(self, **kwargs):
        self._curr_module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # the parameters are shared arrays: one bucket's update is
        # every bucket's
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
