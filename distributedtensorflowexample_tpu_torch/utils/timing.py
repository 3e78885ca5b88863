"""Device-honest timing (the JAX package's ``utils/timing.py``).

A PyTorch call on a CUDA tensor returns once its kernels are queued, so a
``time.perf_counter()`` pair around a step times the enqueue.  Every timer
here takes an optional result (tensors, or dicts, lists and tuples of
them) and waits for the cards those tensors live on before reading the
clock, so the seconds are the wall time the device spent.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


def block_until_ready(result) -> None:
    """Wait for every CUDA card that holds a tensor of ``result``."""
    cards = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                cards.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(result)
    for card in cards:
        torch.cuda.synchronize(card)


class Timer:
    """Accumulating timer:
    ``with timer.measure() as out: out["result"] = step(...)`` —
    the result is drained before the clock stops."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        sink: list[tuple[str, float]] = []
        with timed_block(sink=sink) as out:
            yield out
        self.total += sink[0][1]
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


@contextlib.contextmanager
def timed_block(label: str = "", sink=None):
    """Time a block; assign ``out["result"]`` inside to wait on its device
    work: ``with timed_block("step") as out: out["result"] = step(...)``."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if "result" in out:
        block_until_ready(out["result"])
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
    else:
        print(f"[timing] {label or 'block'}: {dt * 1e3:.2f} ms", flush=True)


class RateMeter:
    """Sliding steps/sec meter over the last window of events."""

    def __init__(self, window: int = 50):
        self._stamps: collections.deque[float] = collections.deque(
            maxlen=max(2, window))

    def tick(self) -> None:
        self._stamps.append(time.perf_counter())

    @property
    def rate(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0
