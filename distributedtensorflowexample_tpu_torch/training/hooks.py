"""Training hooks (from the JAX package's ``training/hooks.py``:
``StopAtStepHook``, ``EvalHook`` and ``MetricsHook``).

A hook sees the loop at call boundaries; stopping is a return value.
``needs_sync(step)`` tells the loop that the hook will wait on the device
at this boundary, so the loop synchronizes the card BEFORE starting the
hook's clock: the train steps still in flight then count as training
time, not as hook time.
"""

from __future__ import annotations


class Hook:
    def begin(self, loop) -> None: ...

    def needs_sync(self, step: int) -> bool:
        return False

    def after_step(self, step: int, state, metrics) -> bool:
        """Return True to request a stop."""
        return False

    def end(self, state) -> None: ...


class StopAtStepHook(Hook):
    def __init__(self, last_step: int):
        self._last_step = last_step

    def after_step(self, step, state, metrics) -> bool:
        return step >= self._last_step


class _EveryN:
    """Boundary-crossing interval check: fires when the step counter
    reaches or jumps past the next multiple of ``every``."""

    def __init__(self, every: int, start: int = 0):
        self._every = every
        self._next = None if not every else (start // every + 1) * every

    def due(self, step: int) -> bool:
        return self._next is not None and step >= self._next

    def __call__(self, step: int) -> bool:
        if not self.due(step):
            return False
        self._next = (step // self._every + 1) * self._every
        return True


class EvalHook(Hook):
    """Periodic exact-accuracy eval on a held-out split."""

    def __init__(self, eval_fn, every: int, logger):
        self._eval_fn = eval_fn
        self._every = every
        self._due = _EveryN(every)
        self._logger = logger

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))

    def needs_sync(self, step) -> bool:
        return self._due.due(step)

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step):
            self._logger.scalar(step, "eval_accuracy", self._eval_fn(state))
        return False


class MetricsHook(Hook):
    """Samples the loss at ``every``-step marks (the boundaries where the
    logger has already fetched it), keeping the ``(step, loss)`` tape the
    run summary reports.  The JAX package's hook also feeds its ``obs``
    registry; the port has no telemetry layer yet."""

    def __init__(self, every: int = 1):
        self._every = max(1, every)
        self._due = _EveryN(self._every)
        self.loss_tape: list[tuple[int, float]] = []

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step) and "loss" in metrics:
            self.loss_tape.append((step, float(metrics["loss"])))
        return False
