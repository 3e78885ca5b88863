"""sim/ — a deterministic discrete-event simulator that drives the
port's REAL control plane at fleet scale (the JAX package's ``sim/``,
on the port's ``obs/`` and ``resilience/``).

The point of this package is what it does NOT contain: a scheduler.
The simulated fleet runs the unmodified
:class:`~distributedtensorflowexample_tpu_torch.resilience.scheduler.Scheduler`
and :class:`~distributedtensorflowexample_tpu_torch.resilience.remediate.
Remediator` — the same classes, the same WAL rows, the same
``tools.obs_query why`` verdicts the live queue produces — against
10,000 simulated ranks, because every decision those classes make
already flows through two narrow seams:

* the **clock seam** (``obs/metrics._now``/``_wall`` + the scheduler's
  module-level ``_sleep``), proven bare-read-free by the clock-seam
  rule over ``obs/`` AND ``resilience/scheduler.py`` /
  ``resilience/remediate.py`` (``tests/test_torch_sim.py``);
* the **spawn seam** (``Scheduler(fleet_factory=...)``), where
  :class:`sim.fleet.SimFleetFactory` returns gang objects with the
  ``FleetSupervisor`` surface (``ranks``/``lost_ranks``/
  ``stragglers``/``run``/``request_stop``/``probe_lost_ranks``) whose
  lifecycles are scripted by a scenario file instead of subprocesses.

Everything is single-threaded-deterministic: a seeded event queue
ordered by ``(virtual_ts, push_seq)``, a virtual clock that only moves
when the scheduler's tick loop sleeps, and zero wall-clock reads — so
the same seed + scenario produces bitwise-identical journal and ledger
bytes, run after run, and the same bytes as the JAX package's
simulator.  Nothing here imports torch or launches a kernel: the
control plane runs on the host.  docs/DESIGN.md §25 holds the event
model, the clock contract, and the fidelity argument.
"""

from distributedtensorflowexample_tpu_torch.sim.clock import (  # noqa: F401
    VirtualClock, installed_clock)
from distributedtensorflowexample_tpu_torch.sim.events import (  # noqa: F401
    EventQueue)
from distributedtensorflowexample_tpu_torch.sim.fleet import (  # noqa: F401
    FleetHub, SimFleetFactory)
from distributedtensorflowexample_tpu_torch.sim.scenario import (  # noqa: F401
    SCENARIO_EVENTS, Scenario, load_scenario)
from distributedtensorflowexample_tpu_torch.sim.harness import (  # noqa: F401
    SimWorld)
from distributedtensorflowexample_tpu_torch.sim import (  # noqa: F401
    metrics as sim_metrics)
