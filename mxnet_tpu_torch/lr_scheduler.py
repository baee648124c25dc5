"""Learning-rate schedules (reference: mxnet_tpu/lr_scheduler.py, after
python/mxnet/lr_scheduler.py). An optimizer given ``lr_scheduler`` reads
the schedule at its ``num_update`` on every update; the schedule's
``base_lr`` starts as the optimizer's ``learning_rate``."""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, down to ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at %0.5e, "
                             "will not change in the future", num_update,
                             self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor as ``num_update`` passes each of the increasing
    ``step`` counts."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        if not isinstance(step, list) or len(step) < 1:
            raise ValueError("schedule step must be a list with at least one "
                             "entry")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal "
                                 "than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr
