"""Module, symbolic training and inference over a bound executor (port of
``mxnet_tpu/module/module.py``; reference: python/mxnet/module/module.py:
40-759, bind, init_params, init_optimizer, forward/backward/update,
save/load_checkpoint).

``bind`` makes one ``executor.Executor`` on ``context[0]``, which runs the
symbol's graph with torch ops; data parallelism across devices runs one
process a device and aggregates through the kvstore's dist store, not a
DataParallelExecutorGroup splitting batches on the host
(executor_group.py:282 in the reference). ``update`` takes one of four
routes: fused (``pushpull_fused``, keys in reverse-registration order) or
key by key, with the optimizer in the store (``update_on_kvstore``) or
local. A ``context`` list (with a ``work_load_list``, or without) is
accepted as the JAX package accepts it: the module binds on
``context[0]``, and ``_create_kvstore`` counts ``len(context)`` devices,
so ``kvstore="device"`` over two contexts makes a store and updates on
it. ``group2ctxs`` (a dict, or a list of dicts whose first serves
``context[0]``) places the symbol's ``ctx_group`` nodes through the
executor's ``group2ctx`` pass: model parallelism, a transfer at each group
boundary. The JAX module accepts ``group2ctxs`` and binds every node on
``context[0]``. The JAX module's observability, chaos and integrity hooks
are not ported.
"""

import logging
import warnings

import numpy as np

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from .. import kvstore as kvs
from ..base import MXNetError
from ..initializer import Uniform, InitDesc
from ..model import load_checkpoint
from .base_module import BaseModule, _check_input_names


class Module(BaseModule):
    """module.py:40."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        self._work_load_list = work_load_list
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if group2ctxs else None
        self._group2ctxs = dict(group2ctxs or {})

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []

        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._grad_req = None

        self._exec = None
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------ static ctor --
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """module.py:157."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """module.py:186."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    # ---------------------------------------------------------- props ---
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._assert_binded()
        return self._data_shapes

    @property
    def label_shapes(self):
        self._assert_binded()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._assert_binded()
        kwargs = dict(self._data_shapes)
        if self._label_shapes:
            kwargs.update(dict(self._label_shapes))
        _, out_shapes, _ = self._symbol.infer_shape(**kwargs)
        return list(zip(self._output_names, out_shapes))

    # --------------------------------------------------------- params ---
    def get_params(self):
        self._assert_binded()
        assert self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """module.py:268."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "init_params call ignored.", stacklevel=2)
            return
        self._assert_binded()

        if self._arg_params is None:
            self._arg_params = {name: nd.zeros(arr.shape, dtype=arr.dtype)
                                for name, arr in self._exec_param_arrays().items()}
        if self._aux_params is None:
            self._aux_params = {name: nd.zeros(arr.shape, dtype=arr.dtype)
                                for name, arr in self._exec_aux_arrays().items()}

        attrs = self._symbol.attr_dict()

        def fill(name, arr, supplied):
            """One param: prefer the caller-supplied value; otherwise
            draw from the initializer (if the caller supplied a dict at
            all, a missing name is an error unless allow_missing)."""
            provided = None if supplied is None else supplied.get(name)
            if provided is not None:
                if provided is arr:
                    return
                if provided.shape != arr.shape:
                    raise RuntimeError(
                        "Parameter %s cannot be initialized from "
                        "loading. Shape mismatch, target %s vs loaded "
                        "%s" % (name, str(arr.shape),
                                str(provided.shape)))
                arr[:] = provided._data
                return
            if supplied is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for pool, supplied in ((self._arg_params, arg_params),
                               (self._aux_params, aux_params)):
            for name in sorted(pool):
                fill(name, pool[name], supplied)

        self.params_initialized = True
        self._params_dirty = False
        self._exec.copy_params_from(self._arg_params, self._aux_params,
                                    allow_extra_params=True)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """module.py:341."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=allow_extra)
        self.params_initialized = True
        self._params_dirty = True

    def _exec_param_arrays(self):
        return {n: self._exec.arg_dict[n] for n in self._param_names
                if n in self._exec.arg_dict}

    def _exec_aux_arrays(self):
        return dict(self._exec.aux_dict)

    def _sync_params_from_devices(self):
        for n in self._param_names:
            if n in self._exec.arg_dict:
                self._arg_params[n]._data = self._exec.arg_dict[n]._data
        for n, v in self._exec.aux_dict.items():
            self._aux_params[n]._data = v._data
        self._params_dirty = False

    # ----------------------------------------------------------- bind ---
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """module.py:364: infers the shapes and makes the executor, with
        float32 zeros (or a variable's ``__dtype__``) on ``context[0]``
        for every argument and auxiliary state."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        assert not (not for_training and inputs_need_grad)

        data_shapes = [x if isinstance(x, tuple) or hasattr(x, "name")
                       else tuple(x) for x in data_shapes]
        norm = []
        for x in data_shapes:
            if hasattr(x, "name"):
                norm.append((x.name, tuple(x.shape)))
            else:
                norm.append((x[0], tuple(x[1])))
        self._data_shapes = norm
        if label_shapes is not None:
            norml = []
            for x in label_shapes:
                if hasattr(x, "name"):
                    norml.append((x.name, tuple(x.shape)))
                else:
                    norml.append((x[0], tuple(x[1])))
            self._label_shapes = norml
        else:
            self._label_shapes = None

        shape_kwargs = dict(norm)
        if self._label_shapes:
            shape_kwargs.update(dict(self._label_shapes))
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_kwargs)
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()

        # variables may pin dtype via __dtype__ (int8 quantized weights)
        var_dtypes = {node.name: node.attrs["__dtype__"]
                      for node in self._symbol._active_nodes()
                      if node.is_var() and "__dtype__" in node.attrs}
        args = {n: nd.zeros(s, ctx=self._context[0],
                            dtype=var_dtypes.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)}
        auxs = {n: nd.zeros(s, ctx=self._context[0])
                for n, s in zip(aux_names, aux_shapes)}
        grad_names = [n for n in arg_names
                      if n not in self._data_names + self._label_names
                      and n not in self._fixed_param_names] \
            if not inputs_need_grad else \
            [n for n in arg_names if n not in self._label_names
             and n not in self._fixed_param_names]
        args_grad = {n: nd.zeros(args[n].shape, ctx=self._context[0])
                     for n in grad_names} if for_training else None

        from ..executor import Executor
        self._exec = Executor(self._symbol, self._context[0], args,
                              args_grad=args_grad,
                              grad_req=grad_req if for_training else "null",
                              aux_states=auxs, group2ctx=self._group2ctxs)
        self.binded = True

        # params loaded before bind (Module.load) land in the fresh executor
        if self.params_initialized and self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params,
                                        self._aux_params or {},
                                        allow_extra_params=True)

        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())

    def _reset_bind(self):
        self.binded = False
        self._exec = None

    # ------------------------------------------------------- optimizer --
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """module.py:489 — sets up optimizer + kvstore.

        update_on_kvstore semantics (module.py:528): with a kvstore and a
        string optimizer, the optimizer runs inside the store (the
        reference would pickle it to PS servers)."""
        self._assert_binded()
        assert self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore_obj, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        # reference module.py:503-518: default rescale_grad = 1/batch_size
        # (scaled by num_workers under a dist kvstore)
        batch_size = self._data_shapes[0][1][0] if self._data_shapes else 1
        if kvstore_obj and "dist" in kvstore_obj.type:
            batch_size *= kvstore_obj.num_workers
        rescale_grad = 1.0 / max(batch_size, 1)

        if isinstance(optimizer, str):
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore_obj
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore_obj:
            if self._compression_params:
                kvstore_obj.set_gradient_compression(self._compression_params)
            for i, name in enumerate(self._param_names):
                if name in self._arg_params:
                    kvstore_obj.init(i, self._arg_params[name])
            if update_on_kvstore:
                kvstore_obj.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)

        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ---------------------------------------------------------- run -----
    def forward(self, data_batch, is_train=None):
        """module.py:585. A batch of a new shape runs as it is: the
        graph function takes any shape."""
        self._assert_binded()
        assert self.params_initialized
        if is_train is None:
            is_train = self.for_training

        feed = {}
        for (name, _), arr in zip(self._data_shapes, data_batch.data):
            feed[name] = arr
        if self._label_shapes and data_batch.label:
            for (name, _), arr in zip(self._label_shapes, data_batch.label):
                feed[name] = arr
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        """module.py:627."""
        self._assert_binded()
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """module.py:646: the kvstore's push/pull and the optimizer step.
        The gradients go bucketed when the store's ``fusion`` is on (the
        default): keys in reverse-registration order, one collective a
        ~25 MB bucket lane instead of one a key."""
        self._assert_binded()
        assert self.params_initialized and self.optimizer_initialized
        self._update_impl()

    def _update_impl(self):
        self._params_dirty = True
        fused = self._kvstore is not None and self._kvstore.fusion
        if fused:
            # reverse-registration (priority) order — the backward
            # pass produced these gradients last-layer-first
            pairs = [(i, name)
                     for i, name in enumerate(self._param_names)
                     if name in self._exec.grad_dict][::-1]
        if self._update_on_kvstore:
            if fused:
                if pairs:
                    self._kvstore.pushpull_fused(
                        [i for i, _ in pairs],
                        [self._exec.grad_dict[n] for _, n in pairs],
                        out=[self._exec.arg_dict[n] for _, n in pairs])
                return
            for i, name in enumerate(self._param_names):
                if name not in self._exec.grad_dict:
                    continue
                g = self._exec.grad_dict[name]
                w = self._exec.arg_dict[name]
                self._kvstore.push(i, g)
                self._kvstore.pull(i, out=w)
        else:
            if self._kvstore:
                if fused:
                    if pairs:
                        grads = [self._exec.grad_dict[n] for _, n in pairs]
                        self._kvstore.pushpull_fused(
                            [i for i, _ in pairs], grads, out=grads)
                else:
                    for i, name in enumerate(self._param_names):
                        if name not in self._exec.grad_dict:
                            continue
                        g = self._exec.grad_dict[name]
                        self._kvstore.push(i, g)
                        self._kvstore.pull(i, out=g)
            for i, name in enumerate(self._param_names):
                if name not in self._exec.grad_dict:
                    continue
                self._updater(i, self._exec.grad_dict[name],
                              self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        self._assert_binded()
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        self._assert_binded()
        assert self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if labels is None:
            return
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self._exec.outputs)))

    # ---------------------------------------------------------- states --
    def get_states(self, merge_multi_context=True):
        self._assert_binded()
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        self._assert_binded()
        if states is not None:
            for n, s in zip(self._state_names, states):
                self._exec.arg_dict[n]._data = s._data
        else:
            for n in self._state_names:
                self._exec.arg_dict[n][:] = value

    def save_optimizer_states(self, fname):
        """module.py:728."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """module.py:744."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        self._assert_binded()
        mon.install(self._exec)

    def reshape(self, data_shapes, label_shapes=None):
        """module.py:446."""
        self._assert_binded()
        self._data_shapes = [(x.name, tuple(x.shape)) if hasattr(x, "name")
                             else (x[0], tuple(x[1])) for x in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [(x.name, tuple(x.shape)) if hasattr(x, "name")
                                  else (x[0], tuple(x[1]))
                                  for x in label_shapes]
        kwargs = dict(self._data_shapes)
        if self._label_shapes:
            kwargs.update(dict(self._label_shapes))
        self._exec.reshape(**kwargs)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        if sparse_row_id_fn is not None and self._kvstore is not None:
            row_ids = sparse_row_id_fn(data_batch)
            for i, name in enumerate(self._param_names):
                if name in row_ids and name in self._exec.arg_dict:
                    self._kvstore.row_sparse_pull(
                        i, out=self._exec.arg_dict[name],
                        row_ids=row_ids[name])


def _create_kvstore(kvstore, num_device, arg_params):
    """model.py:69 _create_kvstore semantics."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)
