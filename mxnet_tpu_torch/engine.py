"""Execution engine (port of the part of ``mxnet_tpu/engine.py`` that
the NDArray core calls).

PyTorch orders the work of one stream itself, so the port needs no
dependency scheduler: ``waitall`` and ``wait_for_var`` are device syncs
and ``bulk`` is a no-op scope. The host-side worker threads and the
engine's environment settings wait for the rest of the library (ROADMAP
A9).
"""

import contextlib

import torch


def _sync(tensors):
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def wait_for_var(tensor):
    """Engine::WaitForVar: block until ``tensor`` is computed."""
    _sync([tensor])


def wait_for_all():
    """MXNDArrayWaitAll: wait for all work queued on every GPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def set_bulk_size(size):
    """Kept for API parity: there is no op bulking to tune."""
    return size


@contextlib.contextmanager
def bulk(size):
    """Context manager parity with mx.engine bulking (a no-op)."""
    yield
