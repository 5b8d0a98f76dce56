"""Parameter-server server role (port of ``mxnet_tpu/kvstore_server.py``;
reference: python/mxnet/kvstore_server.py).

There is no server role: ``dist_sync`` replaces the ps-lite push/pull
and the servers' ApplyUpdates with an all-reduce over a
``torch.distributed`` world in which every process is a worker
(``kvstore.KVStoreTPUSync``). These entry points keep scripts that probe
DMLC_ROLE importable and say so instead of hanging.
"""

import os

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer(object):
    """Accepted for API parity; run() explains the mapping."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        raise RuntimeError(
            "dist_sync has no server role: aggregation is an all-reduce "
            "across the worker processes of a torch.distributed world "
            "(every rank joins it through parallel.init_distributed, calls "
            "kvstore.create('dist_sync') and pushes and pulls "
            "synchronously)")


def _init_kvstore_server_module():
    role = os.environ.get("DMLC_ROLE", "worker")
    if role in ("server", "scheduler"):
        raise RuntimeError(
            "DMLC_ROLE=%s requested, but dist_sync has no server role and "
            "runs no ps-lite scheduler: relaunch every process as a worker "
            "of one torch.distributed world (its rendezvous replaces the "
            "scheduler)" % role)
