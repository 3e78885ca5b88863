"""Step metrics and throughput accounting (the JAX package's
``training/metrics.py``).

Metrics stay on the device until a log boundary; there the logger fetches
them, prints ``step N: loss=... accuracy=... steps_per_sec=...`` and
appends the same values to ``scalars.jsonl`` and, as TensorBoard scalars,
to a tfevents file in the same directory (``utils/tfevents.py``;
``tensorboard --logdir`` reads it).  ``steps_per_sec`` is wall
time between log boundaries, with the card synchronized before each clock
read (PyTorch returns before the device finishes, so an unsynchronized
clock would time the enqueue) and hook wall time discounted through
:meth:`MetricsLogger.exclude`.

Only the chief (rank 0, as in the JAX logger) prints and writes scalars;
every rank keeps the same clock, since the metrics it is handed at a log
boundary were summed over the ranks (``training/loop.py``).
"""

from __future__ import annotations

import json
import os
import time

import torch

from distributedtensorflowexample_tpu_torch.utils.tfevents import (
    TFEventsWriter)


class MetricsLogger:
    def __init__(self, log_dir: str = "", num_chips: int = 1,
                 log_every: int = 100, device: torch.device | None = None,
                 is_chief: bool = True):
        self._num_chips = max(1, num_chips)
        self._log_every = max(1, log_every)
        self._device = device
        self._is_chief = is_chief
        self._last_time = None
        self._last_step = 0
        self._file = None
        self._events = None
        if log_dir and is_chief:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                              buffering=1)
            self._events = TFEventsWriter(log_dir)
        self.last_steps_per_sec = 0.0

    def sync(self) -> None:
        """Wait for the card's queued work (no-op on the CPU)."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self, step: int):
        self.sync()
        self._last_step = step
        self._last_time = time.perf_counter()

    def exclude(self, seconds: float) -> None:
        """Discount ``seconds`` of non-training wall time (hooks) from the
        current throughput window."""
        if self._last_time is not None:
            self._last_time += seconds

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_log` logs at ``step``.  Boundary crossing,
        not a modulo: multi-step calls advance the step in strides that may
        jump over a multiple of log_every."""
        return step >= self._last_step + self._log_every

    def maybe_log(self, step: int, metrics) -> None:
        if not self.due(step):
            return
        fetched = {k: float(v) for k, v in metrics.items()}
        self.sync()
        now = time.perf_counter()
        if self._last_time is not None and step > self._last_step:
            dt = now - self._last_time
            if dt > 0:
                sps = (step - self._last_step) / dt
                self.last_steps_per_sec = sps
                fetched["steps_per_sec"] = round(sps, 2)
                fetched["steps_per_sec_per_chip"] = round(
                    sps / self._num_chips, 2)
        self._last_time = now
        self._last_step = step
        if not self._is_chief:
            return
        parts = " ".join(f"{k}={v:.4f}" for k, v in fetched.items())
        print(f"step {step}: {parts}", flush=True)
        if self._file:
            self._file.write(json.dumps({"step": step, **fetched}) + "\n")
        if self._events:
            for name, value in fetched.items():
                self._events.scalar(step, name, value)
            self._events.flush()

    def note(self, text: str) -> None:
        """Print a line, on the chief only."""
        if self._is_chief:
            print(text, flush=True)

    def scalar(self, step: int, name: str, value: float) -> None:
        if not self._is_chief:
            return
        print(f"step {step}: {name}={value:.4f}", flush=True)
        if self._file:
            self._file.write(json.dumps({"step": step, name: value}) + "\n")
        if self._events:
            self._events.scalar(step, name, value)
            self._events.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._events:
            self._events.close()
            self._events = None
