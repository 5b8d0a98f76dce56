"""User-defined modules in pure Python (port of
``mxnet_tpu/module/python_module.py``; reference:
python/mxnet/module/python_module.py).

PythonModule implements the BaseModule contract with no parameters and
no executor: subclasses fill in forward/backward. PythonLossModule is
the canonical use — a loss "layer" at the top of a pipeline (typically
inside a SequentialModule) whose backward emits the loss gradient
computed by a user function.
"""

import logging

import numpy as np

from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule


class PythonModule(BaseModule):
    """A module whose computation is written directly in Python. It has
    no parameters (update/init are no-ops) — shape inference, binding
    and the forward/backward contract are what subclasses inherit."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super(PythonModule, self).__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ------------------------------------------------------ properties --
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------------ parameters --
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        pass

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        """Subclasses that produce predictions should override; by
        default a python module computes no metric."""

    # ----------------------------------------------------------- bind --
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [
                l if isinstance(l, DataDesc) else DataDesc(*l)
                for l in label_shapes]
        self._output_shapes = self._compute_output_shapes()
        self.params_initialized = True

    def _compute_output_shapes(self):
        """Infer output shapes from data/label shapes. Must be
        overridden when outputs differ from the single data input."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """Loss head as a module: forward stores the prediction, backward
    produces the input gradient via `grad_func` (or the default
    cross-entropy-style pred-label gradient)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super(PythonLossModule, self).__init__(
            data_names, label_names, [name + "_output"], logger=logger)
        self._name = name
        assert len(self._data_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [DataDesc(self._name + "_output",
                         self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head; it takes no head gradient"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad)
            self._scores_grad = grad
        else:
            # default: d/dscores of cross-entropy with integer labels
            # over softmaxed scores
            prob = nd.softmax(self._scores, axis=-1)
            one_hot = nd.one_hot(self._labels.astype("int32"),
                                 prob.shape[-1])
            self._scores_grad = (prob - one_hot) / prob.shape[0]

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
