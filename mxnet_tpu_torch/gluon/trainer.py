"""Gluon Trainer (port of ``mxnet_tpu/gluon/trainer.py``; reference:
python/mxnet/gluon/trainer.py:27, step:305, _allreduce_grads:356,
_update:399).

Applies an Optimizer to a set of Parameters; the gradients' aggregation
goes through the kvstore. The default ``kvstore="device"`` makes a store
even on one context, as the reference does, and ``_allreduce_grads``
sends every gradient through its ``pushpull_fused`` in
reverse-registration order (the last layers' gradients, ready first in
backward, reduce first: the reference's priority push), one collective a
bucket lane; a store made with ``fusion=False`` takes the per-key
push/pull path. A ``KVStore`` object or any ``dist_*`` name works the
same way, the latter over the ``torch.distributed`` world.
``update_on_kvstore`` (set automatically when the store's sharded update
applies: ``shard_update`` on, more than one rank, sgd/nag/adam) moves
the optimizer into the store. ``kvstore=None`` keeps the local update
path, which also trains parameters that lie on several contexts, each
updated on its own, as the JAX package's Trainer does; with a store, such
parameters raise (JAX's fused push fails on them). Under an elastic
launcher each step ends at ``parallel.elastic.step_boundary`` (heartbeat
and membership check), as in JAX. The reference's observability, chaos,
memory-budget and integrity hooks and its AMP loss-scaler attribute are
not ported.
"""

from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from ..parallel import elastic, fusion
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer(object):
    """Applies an Optimizer on a set of Parameters.

    Parameters
    ----------
    params : ParameterDict or list of Parameter
    optimizer : str or Optimizer
    optimizer_params : dict
    kvstore : str or KVStore, default 'device'
    compression_params : dict, optional (gradient compression config)
    update_on_kvstore : bool, optional
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
        self._params = list(seq)
        self._param2idx = {p.name: i
                           for i, p in enumerate(self._params)}
        self._compression_params = compression_params
        hyper = dict(optimizer_params or {})
        self._scale = float(hyper.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, hyper)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
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
        """Bring the kvstore up once, at the first call that needs it.

        Parameters on several contexts train without a store, each updated
        on its own context. A store packs every gradient into one buffer a
        lane and needs them on one device: the JAX package's fused push
        fails on parameters on two devices (its concatenate rejects them),
        and the port refuses them up front."""
        if self._kv_initialized:
            return
        kv = self._kvstore_type
        ctxs = {c for p in self._params if p._data is not None
                for c in p.list_ctx()}
        if len(ctxs) > 1 and kv is not None:
            raise MXNetError(
                "Trainer: the parameters lie on %d contexts (%s) and a "
                "kvstore (%r) would aggregate them; its fused push packs "
                "every gradient into one buffer on one device, and the JAX "
                "package's Trainer fails there too. Pass kvstore=None to "
                "update each parameter on its own context, or move the "
                "parameters to one context" % (
                    len(ctxs), ", ".join(sorted(str(c) for c in ctxs)),
                    kv if isinstance(kv, str) else kv.type))
        if kv is not None and not isinstance(kv, kvs.KVStore):
            kv = kvs.create(kv)
        self._kvstore = kv
        if self._update_on_kvstore is None:
            # the sharded update runs inside the store (its
            # reduce-scatter -> sharded update -> all-gather owns the
            # optimizer state), so it moves the update onto the store;
            # every other configuration updates locally
            self._update_on_kvstore = bool(
                kv is not None and kv.shard_update
                and kv.supports_shard_update()
                and fusion.FlatOptimizer.supports(self._optimizer)
                is not None)
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            for slot, param in enumerate(self._params):
                if param._data is not None:
                    kv.init(slot, param.data())
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
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
        all-reduce them through the kvstore and apply the optimizer
        (gluon/trainer.py:305)."""
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        if elastic.enabled():
            # the elastic membership check at the step boundary: a dead
            # peer found here shrinks before the next collective can
            # block this rank
            self._elastic_steps = getattr(self, "_elastic_steps", 0) + 1
            elastic.step_boundary(self._elastic_steps)

    def allreduce_grads(self):
        self._ready()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        if self._kvstore.fusion:
            items = [(slot, p) for slot, p in self._trainable()
                     if p._data is not None]
            if not items:
                return
            # reverse-registration (priority) order
            items.reverse()
            grads = [p.grad() for _, p in items]
            self._kvstore.pushpull_fused(
                [slot for slot, _ in items], grads,
                out=None if self._update_on_kvstore else grads)
            return
        for slot, param in self._trainable():
            self._kvstore.push(slot, param.grad(), priority=-slot)
            if not self._update_on_kvstore:
                self._kvstore.pull(slot, param.grad(), priority=-slot)

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
            if self._update_on_kvstore and self._kvstore is not None:
                self._kvstore.pull(i, param.data(), priority=-i)
            else:
                self._updaters[0](i, param.grad(), param.data())
            param._data._fresh_grad = False

    # ------------------------------------------------------------ states --
    def save_states(self, fname):
        assert self._optimizer is not None
        self._ready()
        if self._update_on_kvstore and self._kvstore is not None:
            # the store owns the states (the sharded slots included)
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        self._ready()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
