"""The seeded discrete-event queue: a heap of ``(virtual_ts,
push_seq, callback)``.

``push_seq`` is the total order that makes the sim deterministic: two
events at the same virtual timestamp fire in the order they were
scheduled, never in heap-internal or thread-arrival order.  Callbacks
may push further events (a gang completion schedules the traffic
model's next sample; a ``request_stop`` supersedes a pending
completion), which is why consumption is pop-one-at-a-time from the
virtual sleep loop, not a drained batch.
"""

from __future__ import annotations

import heapq


class EventQueue:
    def __init__(self):
        self._heap: list[tuple] = []
        self._seq = 0

    def push(self, ts: float, fn, label: str = "") -> int:
        """Schedule ``fn()`` at virtual time ``ts``; returns the push
        seq (useful for logging/generation checks)."""
        self._seq += 1
        heapq.heappush(self._heap, (ts, self._seq, label, fn))
        return self._seq

    def peek_ts(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> tuple:
        """(ts, seq, label, fn) of the earliest event."""
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)
