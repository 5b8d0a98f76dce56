"""Storage accounting (port of the part of ``mxnet_tpu/storage.py``
that the NDArray core calls).

PyTorch's caching allocator owns device memory; ``device_memory_stats``
reads its counters (``torch.cuda.memory_stats``). Allocation tracking is
opt-in (``start_tracking()``): every NDArray made while tracking is
counted per context and uncounted when it is collected.
"""

import threading
import weakref

import torch

__all__ = ["device_memory_stats", "start_tracking", "stop_tracking",
           "reset_stats", "summary"]

_TRACKING = False
_LOCK = threading.Lock()
_LIVE = {}      # ctx str -> [count, bytes]
_PEAK = {}      # ctx str -> peak bytes
_TOTAL = {}     # ctx str -> cumulative alloc count
_EPOCH = 0      # bumped by reset_stats; stale finalizers are ignored


def _note_alloc(arr):
    nbytes = arr._data.numel() * arr._data.element_size()
    key = str(arr._ctx)
    with _LOCK:
        live = _LIVE.setdefault(key, [0, 0])
        live[0] += 1
        live[1] += nbytes
        _PEAK[key] = max(_PEAK.get(key, 0), live[1])
        _TOTAL[key] = _TOTAL.get(key, 0) + 1
        epoch = _EPOCH
    weakref.finalize(arr, _note_free, key, nbytes, epoch)


def _note_free(key, nbytes, epoch):
    with _LOCK:
        live = _LIVE.get(key)
        if epoch != _EPOCH or not live:
            return
        live[0] -= 1
        live[1] -= nbytes


def start_tracking():
    """Count NDArray allocations per context from this point on."""
    global _TRACKING
    _TRACKING = True


def stop_tracking():
    global _TRACKING
    _TRACKING = False


def reset_stats():
    global _EPOCH
    with _LOCK:
        _EPOCH += 1
        _LIVE.clear()
        _PEAK.clear()
        _TOTAL.clear()


def summary():
    """Tracked allocation stats: {ctx: {live, live_bytes, peak_bytes,
    total_allocs}} (only NDArrays made while tracking)."""
    with _LOCK:
        return {
            ctx: {"live": live[0], "live_bytes": live[1],
                  "peak_bytes": _PEAK.get(ctx, 0),
                  "total_allocs": _TOTAL.get(ctx, 0)}
            for ctx, live in _LIVE.items()}


def device_memory_stats(device=None):
    """Per-GPU byte counters of the caching allocator, keyed by device
    name: ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``
    (the names the JAX package's counters use), with the allocator's
    own ``memory_stats`` beside them. Empty without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    ids = [device] if device is not None else range(torch.cuda.device_count())
    out = {}
    for i in ids:
        stats = dict(torch.cuda.memory_stats(i))
        stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
        stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
        stats["bytes_limit"] = torch.cuda.mem_get_info(i)[1]
        out["cuda:%d" % i] = stats
    return out
