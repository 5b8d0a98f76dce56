"""BucketingModule, variable-length inputs through one executor a bucket
(port of ``mxnet_tpu/module/bucketing_module.py``; reference:
python/mxnet/module/bucketing_module.py: sym_gen per bucket_key,
parameters shared across the buckets' executors).

Each bucket binds its own Module; the parameters are shared through the
default bucket's module and copied into whichever bucket runs.
"""

import logging

from ..initializer import Uniform
from .base_module import BaseModule, _check_input_names
from .module import Module


class BucketingModule(BaseModule):
    """bucketing_module.py:40."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen

        symbol, data_names, label_names = sym_gen(default_bucket_key)
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)

        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._context = context
        self._work_load_list = work_load_list
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params

        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        self._assert_binded()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._assert_binded()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._assert_binded()
        return self._curr_module.output_shapes

    def get_params(self):
        self._assert_binded()
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._assert_binded()
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def get_states(self, merge_multi_context=True):
        self._assert_binded()
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._assert_binded()
        self._curr_module.set_states(states, value)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """bucketing_module.py:309 — binds the default bucket."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req

        symbol, data_names, label_names = self._sym_gen(self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        group2ctxs=self._group2ctxs,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None,
                    grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        if getattr(self, "_load_prefix", None):
            # restore a load()-requested checkpoint now that arrays exist
            self._curr_module.load_params(
                "%s-%04d.params" % (self._load_prefix, self._load_epoch))
            self.params_initialized = True
            self._load_prefix = None
        if getattr(self, "_preset_params", None):
            arg, aux = self._preset_params
            self._curr_module.init_params(allow_missing=True)
            self._curr_module.set_params(arg, aux, allow_missing=True,
                                         allow_extra=True)
            self.params_initialized = True
            # the executor holds the fresh values; mark dirty at THIS
            # level — get_params() pushes our flag down before syncing
            self._params_dirty = True
            self._preset_params = None

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """bucketing_module.py:376."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            group2ctxs=self._group2ctxs,
                            compression_params=self._compression_params)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._assert_binded()
        assert self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module) \
                    if hasattr(mod, "borrow_optimizer") else None
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        self._assert_binded()
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._curr_bucket_key
        data_shapes = data_batch.provide_data
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        """bucketing_module.py:465 — switch to the batch's bucket."""
        self._assert_binded()
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        # share latest params into this bucket's executor (sync the holder
        # bucket's device params to host first — update() steps land only
        # in its executor arg_dict)
        if self.params_initialized:
            src = self._buckets[self._default_bucket_key]
            if self._curr_module is not src:
                src._sync_params_from_devices()
                self._curr_module._arg_params = src._arg_params
                self._curr_module._aux_params = src._aux_params
                self._curr_module._exec.copy_params_from(
                    src._arg_params, src._aux_params, allow_extra_params=True)
                self._curr_module.params_initialized = True
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._assert_binded()
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._assert_binded()
        assert self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        if not self._curr_module.optimizer_initialized:
            self._curr_module._optimizer = \
                self._buckets[self._default_bucket_key]._optimizer
            self._curr_module._updater = \
                self._buckets[self._default_bucket_key]._updater
            self._curr_module._kvstore = \
                self._buckets[self._default_bucket_key]._kvstore
            self._curr_module._update_on_kvstore = \
                self._buckets[self._default_bucket_key]._update_on_kvstore
            self._curr_module.optimizer_initialized = True
        self._curr_module.update()
        # propagate updated params back to the default bucket holder
        if self._curr_bucket_key != self._default_bucket_key:
            src = self._curr_module
            dst = self._buckets[self._default_bucket_key]
            src._sync_params_from_devices()
            dst._arg_params = src._arg_params
            dst._aux_params = src._aux_params
            dst._exec.copy_params_from(src._arg_params, src._aux_params,
                                       allow_extra_params=True)

    def get_outputs(self, merge_multi_context=True):
        self._assert_binded()
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._assert_binded()
        assert self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._assert_binded()
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    @property
    def symbol(self):
        self._assert_binded()
        return self._curr_module.symbol

    def install_monitor(self, mon):
        self._assert_binded()
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    # ------------------------------------------------- checkpointing --
    def save_checkpoint(self, prefix, epoch, remove_amp_cast=False):
        """Save params + per-bucket symbols + the bucket list (reference
        bucketing_module.py save_checkpoint layout)."""
        assert self._buckets, "Empty BucketingModule cannot be saved"
        from .. import ndarray as nd
        import numpy as np
        self.save_params("%s-%04d.params" % (prefix, epoch))
        for bucket_key in self._buckets:
            symbol, _, _ = self._sym_gen(bucket_key)
            symbol.save("%s-%s-symbol.json" % (prefix, bucket_key))
        # non-integer bucket keys (tuples) can't serialize this way —
        # skip the reference-parity artifact then
        if all(isinstance(k, int) for k in self._buckets):
            nd.save("%s.buckets" % prefix,
                    nd.array(np.asarray(list(self._buckets),
                                        dtype=np.int32), dtype="int32"))

    @staticmethod
    def load(prefix, epoch, sym_gen=None, default_bucket_key=None,
             **kwargs):
        """Recreate a BucketingModule from save_checkpoint files; the
        original sym_gen must be supplied (symbols on disk are for
        inspection/inference tooling)."""
        assert sym_gen is not None, \
            "sym_gen is required to load a BucketingModule"
        assert default_bucket_key is not None
        mod = BucketingModule(sym_gen, default_bucket_key=default_bucket_key,
                              **kwargs)
        mod._load_prefix = prefix
        mod._load_epoch = epoch
        return mod

    @staticmethod
    def load_dict(sym_dict=None, sym_gen=None, default_bucket_key=None,
                  arg_params=None, aux_params=None, **kwargs):
        """Create a BucketingModule from in-memory dicts (reference
        load_dict contract): `sym_gen`/`default_bucket_key` define the
        module (sym_dict is accepted for signature parity — symbols are
        regenerated by sym_gen here), and arg/aux params install at
        bind time."""
        assert sym_gen is not None, \
            "sym_gen is required to build a BucketingModule"
        assert default_bucket_key is not None
        mod = BucketingModule(sym_gen,
                              default_bucket_key=default_bucket_key,
                              **kwargs)
        mod._preset_params = (arg_params or {}, aux_params or {})
        return mod
