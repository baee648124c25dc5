"""Training callbacks (reference: mxnet_tpu/callback.py, after
python/mxnet/callback.py). A batch-end callback takes a
:data:`BatchEndParam`; an epoch-end callback takes ``(epoch, symbol,
arg_params, aux_params)``. The reference's telemetry gauge of the
Speedometer's rate is not ported."""
from __future__ import annotations

import logging
import math
import time
from collections import namedtuple

from .model import save_checkpoint

__all__ = ["BatchEndParam", "module_checkpoint", "do_checkpoint",
           "log_train_metric", "Speedometer", "ProgressBar",
           "LogValidationMetricsCallback"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Checkpoint a module every ``period`` epochs through
    ``mod.save_checkpoint``."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Save the symbol and parameters every ``period`` epochs as epoch
    ``iter_no + 1``."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Log the training metric every ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples per second (and the training metric, which it then
    resets) each time ``nbatch`` crosses a multiple of ``frequent``."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self._tic_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        prev = self.last_count
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            self._tic_count = count
            return
        if count // self.frequent > prev // self.frequent:
            done = max(1, count - self._tic_count)
            speed = done * self.batch_size / (time.time() - self.tic)
            if param.eval_metric is not None:
                name_value = param.eval_metric.get_name_value()
                param.eval_metric.reset()
                for name, value in name_value:
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\tTrain-%s=%f", param.epoch,
                                 count, speed, name, value)
            else:
                logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                             param.epoch, count, speed)
            self.tic = time.time()
            self._tic_count = count


class ProgressBar:
    """Log a text progress bar of ``nbatch`` out of ``total``."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Log the evaluation metric at the end of a ``score``."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
