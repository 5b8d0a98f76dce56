"""Training callbacks (port of ``mxnet_tpu/callback.py``, which needs no
JAX: the port keeps its own copy).

Reference: python/mxnet/callback.py (do_checkpoint, log_train_metric,
Speedometer, ProgressBar, LogValidationMetricsCallback).
"""

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Checkpoint callback over a module (callback.py:33)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint to prefix-NNNN.params (callback.py:60)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Log metric every `period` batches (callback.py:87)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer(object):
    """Throughput + metric logging every `frequent` batches.

    API contract per reference callback.py:117: logs
    "Epoch[e] Batch [a-b] Speed: s samples/sec metric=value...", resets
    the local metric each report when auto_reset, and restarts its
    window when the batch counter rewinds (new epoch)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None     # (batch count, wall time) anchor

    def _report(self, param, speed, lo, hi):
        metric = param.eval_metric
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, hi, speed)
            return
        pairs = metric.get_name_value()
        if self.auto_reset:
            metric.reset_local()
        fields = "".join("\t%s=%f" % p for p in pairs)
        logging.info("Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec%s",
                     param.epoch, lo, hi, speed, fields)

    def __call__(self, param):
        count = param.nbatch
        anchor = self._window_start
        if anchor is None or anchor[0] > count:
            # first call, or the counter rewound (epoch rollover):
            # re-anchor without reporting
            self._window_start = (count, time.time())
            return
        if count % self.frequent != 0 or count == anchor[0]:
            return
        elapsed = time.time() - anchor[1]
        samples = (count - anchor[0]) * self.batch_size
        speed = samples / elapsed if elapsed > 0 else float("inf")
        self._report(param, speed, count - self.frequent, count)
        self._window_start = (count, time.time())


class ProgressBar(object):
    """ASCII progress bar (callback.py:188)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback(object):
    """Log validation metrics at epoch end (callback.py:213)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
