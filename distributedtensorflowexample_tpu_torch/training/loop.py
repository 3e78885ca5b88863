"""The training loop (the JAX package's ``training/loop.py``): a plain
Python loop around one train-step call, with hooks at call boundaries.
Per-call host work is an iterator ``next`` and the step's launches;
metrics stay on the device until the logger's boundary.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

from distributedtensorflowexample_tpu_torch.training.hooks import Hook
from distributedtensorflowexample_tpu_torch.training.metrics import (
    MetricsLogger)


class TrainLoop:
    def __init__(self, train_step, batches: Iterator, num_steps: int,
                 hooks: Iterable[Hook] = (),
                 logger: MetricsLogger | None = None,
                 steps_per_call: int = 1):
        """``steps_per_call``: global steps one ``train_step`` call
        advances (the indexed step's ``unroll_steps``)."""
        self._train_step = train_step
        self._batches = batches
        self._prefetch = getattr(batches, "prefetch", None)
        self._num_steps = num_steps
        self._hooks = list(hooks)
        self._logger = logger or MetricsLogger()
        self._spc = max(1, steps_per_call)
        self.start_step = 0

    def run(self, state):
        start = int(state.step)
        self.start_step = start
        for h in self._hooks:
            h.begin(self)
        self._logger.start(start)
        for step in range(start + self._spc, self._num_steps + 1, self._spc):
            batch = next(self._batches)
            state, metrics = self._train_step(state, batch)
            if self._prefetch is not None:
                self._prefetch()
            self._logger.maybe_log(step, metrics)
            if any(h.needs_sync(step) for h in self._hooks):
                self._logger.sync()
            t_hooks = time.perf_counter()
            stops = [h.after_step(step, state, metrics) for h in self._hooks]
            self._logger.exclude(time.perf_counter() - t_hooks)
            if any(stops):
                break
        self._logger.sync()
        for h in self._hooks:
            h.end(state)
        return state
