"""The virtual clock and its installation into the repo's seams.

The clock contract (docs/DESIGN.md §25): the control plane reads time ONLY through ``obs/metrics._now``
(monotonic) / ``_wall`` (epoch) and sleeps ONLY through
``resilience/scheduler._sleep`` — ``tests/test_torch_sim.py`` runs the
clock-seam rule over the port's ``obs/`` and control-plane modules to
prove the read half statically.  ``installed_clock`` swaps all
three for the virtual clock and the event-pumping sleep, and restores
the real ones on exit, so a sim run and a live run execute the same
decision code with different physics.

Install BEFORE constructing the Scheduler/Remediator: ``Guardrails``
binds ``obs_metrics._wall`` at construction time (``clock or
obs_metrics._wall``), so a late install would leave the remediator's
flap/cooldown windows on the wall clock while everything else runs on
virtual time.
"""

from __future__ import annotations

import contextlib

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.resilience import (
    scheduler as sched_mod)


class VirtualClock:
    """Monotonic virtual seconds since sim start, plus a fixed epoch
    anchor so wall timestamps (journal/ledger ``ts`` fields) are
    deterministic and human-plausible.  Time NEVER moves on its own —
    only :meth:`advance_to`, called from the virtual sleep, moves it."""

    #: Deterministic epoch anchor (2020-09-13T12:26:40Z): same-seed
    #: runs must stamp identical wall ts; the real date would differ
    #: per run.
    EPOCH = 1_600_000_000.0

    def __init__(self, start_wall: float = EPOCH):
        self._mono = 0.0
        self._wall0 = float(start_wall)

    def now(self) -> float:
        return self._mono

    def wall(self) -> float:
        return self._wall0 + self._mono

    def advance_to(self, t: float) -> None:
        """Move to virtual time ``t`` (never backwards — an event
        popped at a ts the clock already passed fires 'now')."""
        if t > self._mono:
            self._mono = t


@contextlib.contextmanager
def installed_clock(clock: VirtualClock, sleep_fn):
    """Patch the three seams (``obs_metrics._now``/``_wall``,
    ``scheduler._sleep``) to the virtual clock + event-pumping sleep;
    restore the real clock on exit no matter how the sim ends."""
    saved = (obs_metrics._now, obs_metrics._wall, sched_mod._sleep)
    obs_metrics._now = clock.now
    obs_metrics._wall = clock.wall
    sched_mod._sleep = sleep_fn
    try:
        yield clock
    finally:
        obs_metrics._now, obs_metrics._wall, sched_mod._sleep = saved
