"""Checkpointing helpers and the legacy FeedForward model (port of
``mxnet_tpu/model.py``): the ``-symbol.json`` and ``-%04d.params`` files
are written and read through the port's ``symbol`` and
``nd.save``/``nd.load``.

Reference: python/mxnet/model.py:394-472 (save_checkpoint/load_checkpoint
with prefix-NNNN.params + prefix-symbol.json) and the legacy FeedForward
estimator-style API.
"""

import logging
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym
from . import io as mx_io

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """model.py:394 — saves prefix-symbol.json + prefix-NNNN.params."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_params(prefix, epoch):
    """model.py:442 — returns (arg_params, aux_params)."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """model.py:472 — returns (symbol, arg_params, aux_params)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward(object):
    """Legacy estimator API (model.py:544). Thin adapter over Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _get_module(self, data, label_name="softmax_label"):
        from .module import Module
        data_names = [x[0] for x in data.provide_data]
        label_names = [x[0] for x in data.provide_label] or [label_name]
        mod = Module(self.symbol, data_names=data_names,
                     label_names=label_names, context=self.ctx)
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        if not isinstance(X, mx_io.DataIter):
            X = mx_io.NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                                  shuffle=True)
        self._module = self._get_module(X)
        self._module.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         optimizer=self.optimizer,
                         optimizer_params=self.kwargs,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = self._module.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        if not isinstance(X, mx_io.DataIter):
            X = mx_io.NDArrayIter(X, None, batch_size=self.numpy_batch_size)
        if self._module is None:
            self._module = self._get_module(X)
            self._module.bind(data_shapes=X.provide_data, for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {})
        if reset:
            X.reset()
        outputs = []
        for batch in X:
            self._module.forward(batch, is_train=False)
            outputs.append(self._module.get_outputs()[0].asnumpy())
            if num_batch is not None and len(outputs) >= num_batch:
                break
        return np.concatenate(outputs)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)
