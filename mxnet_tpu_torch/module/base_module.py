"""BaseModule, the training-loop contract (port of
``mxnet_tpu/module/base_module.py``).

Reference counterpart: python/mxnet/module/base_module.py (fit:409,
score:176, predict:305, and the bind/init_params/init_optimizer
abstract surface). The SURFACE is the parity contract — every method
name, argument and return shape below matches the reference so Module
consumers port unchanged — but the loop internals are this repo's:
epochs drive a pull-one-ahead batch walk (iterators may reuse their
internal buffers per the MXNet contract, so the NEXT batch is fetched
only after the current one is consumed), metrics/callbacks ride the
shared BatchEndParam plumbing from model.py, and subclass hooks
(_prepare_epoch — SVRG's full-gradient refresh rides it) are explicit
rather than inlined special cases.
"""

import logging
import time

import numpy as np

from .. import io as mx_io
from .. import metric as mx_metric
from .. import ndarray as nd
from ..base import MXNetError
from ..model import BatchEndParam

# what a parameter (as opposed to a data/label input) looks like by
# name — used only to shrink the did-you-mean candidate list below
_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _check_input_names(symbol, names, typename, throw):
    """Every declared data/label/state name must be an argument of the
    bound symbol; an unknown name is almost always a typo, so the
    report lists the symbol's non-parameter arguments as candidates."""
    known = symbol.list_arguments()
    for name in names:
        if name in known:
            continue
        inputs = [a for a in known if not a.endswith(_PARAM_SUFFIXES)]
        msg = ("\033[91m%s_names=%s names '%s', which the symbol does "
               "not take as an argument. Symbol inputs that exist: "
               "%s\033[0m" % (typename, list(names), name,
                              ", ".join(inputs) or "<none>"))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _callbacks(cbs):
    """Normalize a callback argument (None | callable | list) to a
    flat list."""
    if cbs is None:
        return []
    if isinstance(cbs, (list, tuple)):
        return list(cbs)
    return [cbs]


_DRAINED = object()   # the data iterator has no batch left


class BaseModule(object):
    """The abstract train/eval/predict surface (reference
    base_module.py:64): subclasses supply bind/forward/backward/update
    and the parameter plumbing; this class owns the loops that drive
    them."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # ---------------------------------------------------------- errors --
    def _assert_binded(self):
        if not self.binded:
            raise MXNetError("Module not binded. Call bind() first.")

    # -------------------------------------------------------- high-level --
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Inference over ``eval_data``, accumulated into
        ``eval_metric``; returns the metric's name/value pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, mx_metric.EvalMetric):
            eval_metric = mx_metric.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for batch in eval_data:
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            for cb in _callbacks(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric,
                                 locals=locals()))
            nbatch += 1
        for cb in _callbacks(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                             eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Generator over ``(outputs_without_pad, nbatch, batch)``
        (reference base_module.py:262): each batch's outputs are
        sliced down to the real rows before they are yielded, so pad
        rows never leak into downstream accumulation."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            yield ([out[0:out.shape[0] - batch.pad]
                    for out in self.get_outputs()], nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Forward over ``eval_data`` and collect outputs. A bare
        array runs as one batch; an iterator accumulates per-batch
        output lists, concatenated along batch when ``merge_batches``
        (a single merged output unwraps from its list unless
        ``always_output_list``)."""
        assert self.binded and self.params_initialized
        if isinstance(eval_data, (nd.NDArray, np.ndarray)):
            one = nd.array(eval_data) if isinstance(eval_data, np.ndarray) \
                else eval_data
            self.forward(mx_io.DataBatch([one]), is_train=False)
            return self.get_outputs()[0]
        if not isinstance(eval_data, mx_io.DataIter):
            raise ValueError("eval_data must be of type NDArray or DataIter")
        collected = [
            [out.copy() for out in outs]
            for outs, _, _ in self.iter_predict(eval_data,
                                                num_batch=num_batch,
                                                reset=reset)]
        if not collected or not merge_batches:
            return collected
        width = len(collected[0])
        if any(len(outs) != width for outs in collected):
            raise AssertionError(
                "Cannot merge batches, as num of outputs is not the same "
                "in mini-batches. Maybe bucketing is used?")
        merged = [nd.concatenate([outs[i] for outs in collected])
                  for i in range(width)]
        return merged if width > 1 or always_output_list else merged[0]

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The canonical training loop: bind, initialize, then
        ``num_epoch`` passes of step/metric/callback with optional
        per-epoch validation."""
        from .. import initializer as init_mod
        assert num_epoch is not None, "please specify number of epochs"

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer or init_mod.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if not isinstance(eval_metric, mx_metric.EvalMetric):
            eval_metric = mx_metric.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            eval_metric.reset()
            self._prepare_epoch(epoch - begin_epoch, train_data)
            self._run_epoch(train_data, eval_metric, epoch, monitor,
                            batch_end_callback, sparse_row_id_fn)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)

            # one consistent host-side parameter snapshot per epoch:
            # checkpoint callbacks and the device state must agree
            arg_snap, aux_snap = self.get_params()
            self.set_params(arg_snap, aux_snap)
            for cb in _callbacks(epoch_end_callback):
                cb(epoch, self.symbol, arg_snap, aux_snap)

            if eval_data is not None:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

            train_data.reset()

    def _prepare_epoch(self, epoch_offset, train_data):
        """Hook before each training epoch (e.g. SVRG full-gradient
        refresh); default no-op."""

    def _run_epoch(self, train_data, eval_metric, epoch, monitor,
                   batch_end_callback, sparse_row_id_fn):
        """One pass over train_data: step, metric, callbacks per batch.

        Walks the iterator one batch AHEAD of consumption — prepare()
        sees the upcoming batch (sparse row-id hints) while the
        current one is still the module's live input — but never pulls
        batch n+1 before batch n is fully consumed: MXNet-contract
        iterators may recycle their internal buffers on every next().
        """
        feed = iter(train_data)
        current = next(feed, _DRAINED)
        nbatch = 0
        while current is not _DRAINED:
            if monitor is not None:
                monitor.tic()
            self.forward_backward(current)
            self.update()
            if isinstance(current, list):
                self.update_metric(eval_metric,
                                   [b.label for b in current],
                                   pre_sliced=True)
            else:
                self.update_metric(eval_metric, current.label)
            upcoming = next(feed, _DRAINED)
            if upcoming is not _DRAINED:
                self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
            if monitor is not None:
                monitor.toc_print()
            for cb in _callbacks(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric,
                                 locals=locals()))
            nbatch += 1
            current = upcoming

    # ------------------------------------------------- symbol/params API --
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """One flat file of ``arg:<name>`` / ``aux:<name>`` entries —
        the reference's checkpoint key convention, which load_params
        (and the reference's own loader) round-trips."""
        arg_params, aux_params = self.get_params()
        blob = {"arg:" + name: value for name, value in arg_params.items()}
        blob.update({"aux:" + name: value
                     for name, value in aux_params.items()})
        nd.save(fname, blob)

    def load_params(self, fname):
        args, auxs = {}, {}
        for key, value in nd.load(fname).items():
            kind, _, name = key.partition(":")
            if kind == "arg":
                args[name] = value
            elif kind == "aux":
                auxs[name] = value
            else:
                raise ValueError(
                    "Invalid param file %s: key %r is neither arg: "
                    "nor aux:" % (fname, key))
        self.set_params(args, auxs)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()


def _as_list(obj):
    """Kept under the reference helper's name for external callers:
    anything not already a list/tuple is wrapped (None included —
    unlike _callbacks, which treats None as 'no callbacks')."""
    return obj if isinstance(obj, (list, tuple)) else [obj]
