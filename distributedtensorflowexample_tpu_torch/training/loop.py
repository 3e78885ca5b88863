"""The training loop (the JAX package's ``training/loop.py``): a plain
Python loop around one train-step call, with hooks at call boundaries.
Per-call host work is an iterator ``next`` and the step's launches;
metrics stay on the device until the logger's boundary.  On N ranks the
step returns each rank's share of the metrics; ``reduce_metrics`` (the
mesh's sum) turns them into the global ones, once per host read: at a
step where the logger or a hook reads them, never on the others.

Three counters split each boundary's wall time (the JAX loop's anatomy,
which ``MetricsHook`` reports and ``obs/timeline.step_anatomy`` reads):
the batch fetch, the train-step call (on the card: the enqueue, and the
waits inside it), and the hooks.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.training.hooks import Hook
from distributedtensorflowexample_tpu_torch.training.metrics import (
    MetricsLogger)
from distributedtensorflowexample_tpu_torch.utils.logging import chief_print

_INPUT_S = obs_metrics.counter(
    "loop_input_seconds_total", "wall seconds fetching batches at loop "
    "call boundaries")
_STEP_S = obs_metrics.counter(
    "loop_step_seconds_total", "wall seconds inside the train-step call "
    "(dispatch + compute + collective wait)")
_HOOK_S = obs_metrics.counter(
    "loop_hook_seconds_total", "wall seconds in after_step hooks "
    "(checkpoint/eval/telemetry)")


class TrainLoop:
    def __init__(self, train_step, batches: Iterator, num_steps: int,
                 hooks: Iterable[Hook] = (),
                 logger: MetricsLogger | None = None,
                 steps_per_call: int = 1, reduce_metrics=None,
                 should_stop=None):
        """``steps_per_call``: global steps one ``train_step`` call
        advances (the indexed step's ``unroll_steps``); ``should_stop``:
        a zero-argument callable polled at each call boundary."""
        self._reduce = reduce_metrics
        self._train_step = train_step
        self._batches = batches
        self._prefetch = getattr(batches, "prefetch", None)
        self._num_steps = num_steps
        self._hooks = list(hooks)
        self._logger = logger or MetricsLogger()
        self._spc = max(1, steps_per_call)
        self._should_stop = should_stop
        self.start_step = 0

    def run(self, state):
        start = int(state.step)
        self.start_step = start
        for h in self._hooks:
            h.begin(self)
        self._logger.start(start)
        interrupted = None
        try:
            for step in range(start + self._spc, self._num_steps + 1,
                              self._spc):
                if self._should_stop is not None and self._should_stop():
                    break
                state, stop = self._step(step, state)
                if stop:
                    break
        except KeyboardInterrupt as e:
            # The end hooks save ``state`` (the step updates it in place,
            # so an interrupt inside the optimizer's apply leaves that
            # step half applied; SIGTERM, polled above, never does).  Say
            # so: the save takes time, and a pause invites a second Ctrl-C.
            chief_print(f"interrupted at step {int(state.step)}: running "
                        f"the exit hooks (final checkpoint) before exiting")
            interrupted = e
        try:
            self._logger.sync()
        except KeyboardInterrupt as e:
            interrupted = interrupted or e
        for h in self._hooks:
            try:
                h.end(state)
            except KeyboardInterrupt as e:
                chief_print("interrupt during the exit hooks: still "
                            "running the remaining ones before exiting")
                interrupted = interrupted or e
        if interrupted is not None:
            raise interrupted
        return state

    def _step(self, step: int, state) -> tuple:
        """One call boundary: the train step, the log, the hooks; the
        state, and True when a hook asks to stop."""
        t0 = time.perf_counter()
        batch = next(self._batches)
        t1 = time.perf_counter()
        state, metrics = self._train_step(state, batch)
        t2 = time.perf_counter()
        if self._prefetch is not None:
            self._prefetch()
        # Before the hooks, so MetricsHook's mark includes this boundary.
        _INPUT_S.inc(t1 - t0)
        _STEP_S.inc(t2 - t1)
        if self._reduce is not None and (
                self._logger.due(step)
                or any(h.reads_metrics(step) for h in self._hooks)):
            metrics = self._reduce(metrics)
        self._logger.maybe_log(step, metrics)
        if any(h.needs_sync(step) for h in self._hooks):
            self._logger.sync()
        t_hooks = time.perf_counter()
        stops = [h.after_step(step, state, metrics) for h in self._hooks]
        dt_hooks = time.perf_counter() - t_hooks
        _HOOK_S.inc(dt_hooks)
        self._logger.exclude(dt_hooks)
        return state, any(stops)
