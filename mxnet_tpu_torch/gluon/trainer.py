"""Gluon Trainer (port of ``mxnet_tpu/gluon/trainer.py``; reference:
python/mxnet/gluon/trainer.py:27, step:305, _allreduce_grads:356,
_update:399).

Applies an Optimizer to a set of Parameters on one context. The
reference creates its default ``kvstore="device"`` store even for one
device, and the all-reduce of one gradient gives that gradient back; so
here ``"device"``, ``"local"`` and ``None`` all take the local update
path, and ``allreduce_grads`` leaves the gradients as they are. More
than one context, a ``dist_*`` store or a ``KVStore`` object,
``update_on_kvstore=True`` and ``compression_params`` are the kvstore of
ROADMAP item A7 and raise naming it. The reference's observability,
chaos, memory-budget, elastic, integrity and bucketed-fusion hooks and
its AMP loss-scaler attribute are not ported.
"""

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


def _kvstore_error(what):
    return MXNetError(
        "%s is mxnet_tpu/kvstore.py, which the PyTorch port has not ported "
        "yet (ROADMAP item A7)" % what)


class Trainer(object):
    """Applies an Optimizer on a set of Parameters.

    Parameters
    ----------
    params : ParameterDict or list of Parameter
    optimizer : str or Optimizer
    optimizer_params : dict
    kvstore : 'device', 'local' or None (one context)
    compression_params : None (gradient compression is A7)
    update_on_kvstore : None or False
    """

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        seq = list(params.values()) if hasattr(params, "values") \
            else params
        if not isinstance(seq, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        outsider = next(
            (p for p in seq if not isinstance(p, Parameter)), None)
        if outsider is not None:
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got list of %s." % (type(outsider)))
        if not (isinstance(kvstore, str) or kvstore is None) \
                or kvstore not in _LOCAL_STORES:
            raise _kvstore_error("kvstore %r" % (kvstore,))
        if update_on_kvstore:
            raise _kvstore_error("update_on_kvstore=True")
        if compression_params:
            raise _kvstore_error("gradient compression")
        self._params = list(seq)
        self._param2idx = {p.name: i
                           for i, p in enumerate(self._params)}
        hyper = dict(optimizer_params or {})
        self._scale = float(hyper.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, hyper)
        self._kvstore_type = kvstore
        self._update_on_kvstore = False
        self._kv_initialized = False

    def _init_optimizer(self, optimizer, hyper):
        ready_made = isinstance(optimizer, opt.Optimizer)
        assert not (ready_made and hyper), \
            "optimizer_params must be None if optimizer is an " \
            "Optimizer instance"
        self._optimizer = optimizer if ready_made \
            else opt.create(optimizer, **hyper)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _ready(self):
        """Check once that the parameters share one context."""
        if self._kv_initialized:
            return
        ctxs = {c for p in self._params if p._data is not None
                for c in p.list_ctx()}
        if len(ctxs) > 1:
            raise _kvstore_error("training over %d contexts (%s)" % (
                len(ctxs), ", ".join(sorted(str(c) for c in ctxs))))
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------- step --
    def step(self, batch_size, ignore_stale_grad=False):
        """One parameter update: rescale the gradients by 1/batch_size,
        all-reduce them (the identity on one context) and apply the
        optimizer (gluon/trainer.py:305)."""
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """All-reduce the gradients across contexts: on one context they
        stay as they are."""
        self._ready()

    def _trainable(self):
        """(slot, param) for every param that receives grads."""
        return ((slot, p) for slot, p in enumerate(self._params)
                if p.grad_req != "null")

    def update(self, batch_size, ignore_stale_grad=False):
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in self._trainable():
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(
                        "Parameter %s has not been initialized" % param.name)
                continue
            if not param._data._fresh_grad:
                # the grad array still holds a previous iteration's value
                # (reference: trainer.py _update fresh-grad check)
                if ignore_stale_grad:
                    continue
                raise UserWarning(
                    "Gradient of Parameter `%s` on context %s has not been "
                    "updated by backward since last `step`. This could mean "
                    "a bug in your model that made it only use a subset of "
                    "the Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning"
                    % (param.name, str(param.list_ctx()[0])))
            self._updaters[0](i, param.grad(), param.data())
            param._data._fresh_grad = False

    # ------------------------------------------------------------ states --
    def save_states(self, fname):
        assert self._optimizer is not None
        self._ready()
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        self._ready()
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
