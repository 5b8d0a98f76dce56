"""Legacy executor-manager helpers (port of
``mxnet_tpu/executor_manager.py``; reference:
python/mxnet/executor_manager.py).

The reference's DataParallelExecutorGroup (one executor per GPU with
hand-split batches) has no counterpart: data parallelism runs one
process per device over a ``torch.distributed`` world (``parallel``,
``kvstore``'s dist store). What survives are the workload-splitting
helpers old user code imports."""

from .base import MXNetError

__all__ = ["split_input_slice", "check_arguments"]


def split_input_slice(batch_size, work_load_list):
    """Split batch_size into per-device slices proportional to
    work_load_list (reference _split_input_slice)."""
    total = sum(work_load_list)
    if total <= 0:
        raise MXNetError("Invalid workload")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            min(batch_size, start + int(round(batch_size * load / total)))
        if end <= start:
            raise MXNetError(
                "Too many slices. Some splits are empty.")
        slices.append(slice(start, end))
        start = end
    return slices


_split_input_slice = split_input_slice


def check_arguments(symbol):
    """Reject symbols with duplicate argument/aux names (reference
    _check_arguments)."""
    names = symbol.list_arguments()
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise MXNetError(
            "Find duplicated argument name %s" % sorted(dup))
    aux = symbol.list_auxiliary_states()
    dupa = {n for n in aux if aux.count(n) > 1}
    if dupa:
        raise MXNetError(
            "Find duplicated auxiliary param name %s" % sorted(dupa))


_check_arguments = check_arguments
