"""RNN checkpoint helpers (port of ``mxnet_tpu/rnn/rnn.py``; reference:
python/mxnet/rnn/rnn.py).

Checkpoints store UNFUSED per-gate parameters so fused and unfused
cells can load each other's files — `save_rnn_checkpoint` unpacks
through the cells before writing, `load_rnn_checkpoint` packs after
reading. The files are ``model.save_checkpoint``'s, which either
package reads from the other.
"""

from .. import model


def _as_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """Save a Module-style checkpoint with cell parameters unpacked."""
    cells = _as_list(cells)
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint and re-pack parameters for the given cells."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    cells = _as_list(cells)
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback: like mx.callback.do_checkpoint but unpacking
    the RNN parameters first."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
