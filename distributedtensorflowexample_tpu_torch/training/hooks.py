"""Training hooks (from the JAX package's ``training/hooks.py``:
``StopAtStepHook``, ``CheckpointHook``, ``HeartbeatHook``, ``EvalHook``,
``MetricsHook`` and ``AnomalyHook``).

A hook sees the loop at call boundaries; stopping is a return value.
``needs_sync(step)`` tells the loop that the hook will wait on the device
at this boundary, so the loop synchronizes the card BEFORE starting the
hook's clock: the train steps still in flight then count as training
time, not as hook time.  ``reads_metrics(step)`` tells it that the hook
reads the step's metrics, which the loop then sums over the ranks first.
"""

from __future__ import annotations

import os
import time

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace


class Hook:
    def begin(self, loop) -> None: ...

    def needs_sync(self, step: int) -> bool:
        return False

    def reads_metrics(self, step: int) -> bool:
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


class CheckpointHook(Hook):
    """Periodic and final checkpoints through a ``CheckpointManager``
    (``training/checkpoint.py``)."""

    def __init__(self, manager, every: int):
        self._manager = manager
        self._every = every
        self._due = _EveryN(every)

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))

    def needs_sync(self, step) -> bool:
        return self._due.due(step)

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step):
            self._manager.save(step, state)
        return False

    def end(self, state) -> None:
        self._manager.save(int(state.step), state)
        self._manager.wait()


def touch_heartbeat(path: str) -> None:
    """Create or refresh the beat file.  Swallows OSError: a full disk
    must not kill the run the beat protects."""
    try:
        with open(path, "a"):
            pass
        os.utime(path)
    except OSError:
        pass


class HeartbeatHook(Hook):
    """Touch ``path`` at call boundaries, so an external watchdog can tell
    a slow but live run from a step that never returns: the touches stop.
    The engine installs it when ``SUPERVISE_HEARTBEAT`` names the
    file."""

    def __init__(self, path: str, every: int = 1):
        self._path = path
        self._every = max(1, every)
        self._due = _EveryN(self._every)

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))
        touch_heartbeat(self._path)

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step):
            touch_heartbeat(self._path)
        return False

    def end(self, state) -> None:
        touch_heartbeat(self._path)


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
    run summary reports, and feeds the process-wide ``obs`` registry, the
    flight recorder and the run ledger when they are armed (the JAX
    package's hook, ``training/hooks.py``).

    Per boundary: one counter add, one gauge set, one histogram observe.
    On ``every``-step marks only: the loss into the recorder's ring, the
    registry delta since the last mark, a ``steps`` trace event (with the
    loop's input, step-call and hook seconds since the last mark, which
    ``obs/timeline.step_anatomy`` reads) and a ledger sample
    (time-bounded by ``OBS_LEDGER_SAMPLE_S``)."""

    def __init__(self, every: int = 1):
        self._every = max(1, every)
        self._due = _EveryN(self._every)
        self.loss_tape: list[tuple[int, float]] = []
        self._steps = obs_metrics.counter(
            "train_steps_total", "completed global training steps")
        self._step_g = obs_metrics.gauge(
            "train_step", "last completed global step")
        self._loss_g = obs_metrics.gauge(
            "train_loss", "loss at the last sampled call boundary")
        self._window_h = obs_metrics.histogram(
            "train_window_seconds",
            "wall seconds between loop call boundaries")
        # The loop's anatomy counters (the same families training/loop.py
        # feeds: registration is idempotent).
        self._in_c = obs_metrics.counter("loop_input_seconds_total")
        self._stp_c = obs_metrics.counter("loop_step_seconds_total")
        self._hk_c = obs_metrics.counter("loop_hook_seconds_total")
        self._last_step = self._mark_step = 0
        self._last_t = self._mark_t = time.perf_counter()
        self._mark_cat = (0.0, 0.0, 0.0)
        self._prev_snap = None

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))
        self._last_step = self._mark_step = int(loop.start_step)
        self._last_t = self._mark_t = time.perf_counter()
        self._mark_cat = (self._in_c.value, self._stp_c.value,
                          self._hk_c.value)
        self._prev_snap = None
        rec = obs_recorder.get()
        if rec is not None:
            rec.note(start_step=int(loop.start_step))

    def reads_metrics(self, step) -> bool:
        return self._due.due(step)

    def after_step(self, step, state, metrics) -> bool:
        now = time.perf_counter()
        self._steps.inc(step - self._last_step)
        self._step_g.set(step)
        self._window_h.observe(now - self._last_t)
        self._last_step, self._last_t = step, now
        if not self._due(step):
            return False
        rec = obs_recorder.get()
        if "loss" in metrics:
            loss = float(metrics["loss"])
            self.loss_tape.append((step, loss))
            self._loss_g.set(loss)
            if rec is not None:
                rec.record_loss(step, loss)
        # The hook column trails one boundary: this boundary's hook
        # window is still open.
        cat = (self._in_c.value, self._stp_c.value, self._hk_c.value)
        obs_trace.event("steps", now - self._mark_t, step=step,
                        n=step - self._mark_step,
                        input_s=round(cat[0] - self._mark_cat[0], 6),
                        compute_s=round(cat[1] - self._mark_cat[1], 6),
                        hook_s=round(cat[2] - self._mark_cat[2], 6))
        self._mark_cat = cat
        self._mark_step, self._mark_t = step, now
        if rec is not None:
            snap = obs_metrics.registry().snapshot()
            if self._prev_snap is not None:
                rec.record_delta(obs_metrics.MetricsRegistry.delta(
                    self._prev_snap, snap))
            self._prev_snap = snap
        led = obs_ledger.get()
        if led is not None:
            led.sample(step)
        return False


class AnomalyHook(Hook):
    """Online anomaly detection at loop boundaries (``obs/anomaly.py``;
    the JAX package's hook): the step-time EWMA regression against the
    run's warmup-pinned baseline, and the NaN and loss-plateau sentinels.
    Detection only, never a stop.

    Per boundary a few float operations.  At ``every``-step marks the
    loss sentinels read the ``train_loss`` gauge that ``MetricsHook`` set
    at the same boundary (so this hook goes after it and fetches nothing
    from the device), and ``health_path`` gets an atomic ``health.json``.
    A new firing bumps ``anomaly_flags_total``, emits an ``anomaly`` trace
    event and dumps a flight (``final=False``).  The regression's window
    excludes checkpoint, snapshot and eval span time (the ``span_seconds``
    sums), as the logger's throughput excludes hook time."""

    _EXCLUDED_SPANS = ("checkpoint", "snapshot", "eval")

    def __init__(self, every: int = 1, health_path: str = "",
                 health=None):
        from distributedtensorflowexample_tpu_torch.obs import anomaly
        from distributedtensorflowexample_tpu_torch.obs import (
            serve as obs_serve)
        self._anomaly = anomaly
        self._every = max(1, every)
        self._health_path = health_path
        self.health = health or anomaly.RunHealth()
        self._loss_g = obs_metrics.gauge("train_loss")
        self._spans = [obs_metrics.histogram("span_seconds").labels(name=n)
                       for n in self._EXCLUDED_SPANS]
        self._due = _EveryN(self._every)
        self._last_step = 0
        self._last_t = time.perf_counter()
        self._last_excl = sum(c.sum for c in self._spans)
        # This RunHealth is the process's live health: the /health scrape
        # (obs/serve.py, OBS_HTTP_PORT) reads it at scrape time.
        obs_serve.set_health_source(self.health.payload)

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))
        self._last_step = int(loop.start_step)
        self._last_t = time.perf_counter()
        self._last_excl = sum(c.sum for c in self._spans)

    def _fired(self, kinds: list, step: int) -> None:
        for kind in kinds:
            self._anomaly.FLAGS_TOTAL.labels(kind=kind).inc()
            obs_trace.event("anomaly", 0.0, step=step, kind=kind,
                            z=round(self.health.step_time.z, 3))
            obs_recorder.dump_global(f"anomaly_{kind}", final=False)

    def after_step(self, step, state, metrics) -> bool:
        now = time.perf_counter()
        excl = sum(c.sum for c in self._spans)
        window = max(0.0, (now - self._last_t)
                     - (excl - self._last_excl))
        fired = self.health.observe_window(step, step - self._last_step,
                                           window)
        self._last_step = step
        self._last_t = now
        self._last_excl = excl
        if self._due(step):
            st = self.health.step_time
            if st.armed:
                self._anomaly.STEP_TIME_Z.set(round(st.z, 3))
            # Untouched (monotonic_ts None): no loss was sampled yet.
            if self._loss_g._bare.monotonic_ts is not None:
                fired += self.health.observe_loss(
                    step, float(self._loss_g.value))
            if fired:
                self._fired(fired, step)
            if self._health_path:
                self.health.write(self._health_path)
        elif fired:
            self._fired(fired, step)
        return False

    def end(self, state) -> None:
        if self._health_path:
            self.health.step = int(state.step)
            self.health.write(self._health_path)
