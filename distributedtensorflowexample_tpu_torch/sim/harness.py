"""SimWorld: wire a scenario to the REAL control plane and run it to
quiescence on virtual time.

What runs here is the unmodified
:class:`~distributedtensorflowexample_tpu_torch.resilience.scheduler.
Scheduler` (tick loop, packer, eviction pricing, grow/heal drives —
constructed with the sim's fleet factory) and, when the scenario has a
``serve`` section, a second REAL
:class:`~distributedtensorflowexample_tpu_torch.resilience.remediate.
Remediator` running the autoscale policy against the traffic model.
The sim contributes only physics: the virtual clock, the scripted
events, and the simulated gangs.  ``SimWorld.run()`` must be called on
the MAIN thread — the scheduler installs its SIGTERM handler there,
exactly like the live ``tools.schedule`` entry point.

The virtual sleep is the sim's engine: every time the scheduler's tick
loop sleeps, the queue pumps every event due before the wake target,
advancing the clock to each event's timestamp in ``(virtual_ts,
push_seq)`` order.  Virtual time therefore moves ONLY inside the
scheduler's own sleeps — between them the control plane computes at a
frozen instant, which is what pins journal/ledger timestamps to the
decision that produced them.

``SIM_MAX_VIRTUAL_S`` (env) caps total virtual time — a scenario that
livelocks the queue (eviction ping-pong, a gate that never opens) dies
loudly at the cap instead of spinning the event loop forever.  Default:
10x the scenario horizon.
"""

from __future__ import annotations

import os

from distributedtensorflowexample_tpu_torch.resilience import (
    remediate as heal_mod)
from distributedtensorflowexample_tpu_torch.resilience.scheduler import (
    Scheduler)
from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
    Journal)
from distributedtensorflowexample_tpu_torch.sim.clock import (
    VirtualClock, installed_clock)
from distributedtensorflowexample_tpu_torch.sim.events import EventQueue
from distributedtensorflowexample_tpu_torch.sim.fleet import (
    FleetHub, SimFleetFactory)
from distributedtensorflowexample_tpu_torch.sim.scenario import (
    Scenario, load_scenario)
from distributedtensorflowexample_tpu_torch.sim.traffic import TrafficModel


class SimWorld:
    def __init__(self, scenario, workdir: str):
        self.scenario: Scenario = (
            scenario if isinstance(scenario, Scenario)
            else load_scenario(scenario))
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.ledger_path = os.path.join(self.workdir, "RUNS.jsonl")
        self.clock = VirtualClock()
        self.queue = EventQueue()
        self.hub = FleetHub(self.clock, self.queue, self.scenario)
        self.max_virtual_s = float(
            os.environ.get("SIM_MAX_VIRTUAL_S", "0") or 0
        ) or self.scenario.horizon_s * 10.0
        self.traffic: TrafficModel | None = None
        self.scheduler: Scheduler | None = None
        self.serve_remediator: heal_mod.Remediator | None = None
        self.summary: dict | None = None

    # --- the engine ----------------------------------------------------

    def _virtual_sleep(self, dt: float) -> None:
        """The scheduler's ``_sleep`` replacement: advance virtual time
        by ``dt``, firing every event due on the way, in ``(ts, seq)``
        order."""
        target = self.clock.now() + dt
        if target > self.max_virtual_s:
            raise RuntimeError(
                f"sim exceeded SIM_MAX_VIRTUAL_S={self.max_virtual_s:g}"
                f"s of virtual time (scenario "
                f"{self.scenario.name!r}, horizon "
                f"{self.scenario.horizon_s:g}s) — the queue is "
                f"livelocked or the ceiling is too tight")
        while True:
            ts = self.queue.peek_ts()
            if ts is None or ts > target:
                break
            ts, _seq, _label, fn = self.queue.pop()
            self.clock.advance_to(ts)
            fn()
        self.clock.advance_to(target)

    # --- serve-side wiring ---------------------------------------------

    def _wire_serve(self) -> None:
        serve = self.scenario.serve
        if not serve:
            return
        knee = float(serve["knee_per_replica"])
        # Cooldown default: seeded from the newest measured HEAL_*
        # MTTR record (2x the worst proven detect->recovered tail)
        # rather than a hardcoded constant — a scenario that names
        # cooldown_s still wins, and the seed is deterministic (the
        # record is checked in), so same-seed runs stay bitwise.
        cooldown_s = serve.get("cooldown_s")
        if cooldown_s is None:
            cooldown_s = heal_mod.mttr_seeded_cooldown_s()
        self.traffic = TrafficModel(
            self.clock, replicas=int(serve.get("replicas", 1)),
            knee_per_replica=knee)
        actuator = heal_mod.make_autoscale_actuator(
            self.traffic.get_replicas, self.traffic.set_replicas,
            knee_per_replica=knee,
            min_replicas=int(serve.get("min_replicas", 1)),
            max_replicas=int(serve.get("max_replicas", 8)),
            headroom=float(serve.get("headroom", 0.85)))
        self.serve_remediator = heal_mod.Remediator(
            journal=Journal(os.path.join(self.workdir,
                                         "serve_heal.jsonl")),
            ledger_path=self.ledger_path,
            scope="serve",
            dry_run=False,
            actuators={"scale_up": actuator, "scale_down": actuator},
            policy={
                "serve_overload": heal_mod.HealRule("scale_up"),
                "serve_underload": heal_mod.HealRule(
                    "scale_down",
                    flap_n=int(serve.get("scale_down_flap_n", 4))),
            },
            guardrails=heal_mod.Guardrails(
                flap_n=serve.get("flap_n"),
                flap_window_s=serve.get("flap_window_s"),
                cooldown_s=cooldown_s,
                budget=serve.get("budget"),
                clock=self.clock.wall))
        watcher = heal_mod.AutoscaleWatcher(
            self.traffic.stats, knee,
            headroom=float(serve.get("headroom", 0.85)),
            low_water=float(serve.get("low_water", 0.35)),
            min_replicas=int(serve.get("min_replicas", 1)))
        poll_s = float(serve.get("poll_s", 5.0))

        def _poll():
            for ev in watcher.poll():
                self.serve_remediator.observe(ev)
            nxt = self.clock.now() + poll_s
            if nxt <= self.scenario.horizon_s:
                self.queue.push(nxt, _poll, label="serve:poll")
        self.queue.push(poll_s, _poll, label="serve:poll")

    # --- the run -------------------------------------------------------

    def run(self) -> dict:
        sc = self.scenario
        for ev in sc.events:
            if ev.kind == "serve_load":
                if self.scenario.serve is None:
                    raise ValueError(
                        f"scenario {sc.name}: serve_load event at "
                        f"{ev.at} but no serve section")
                self.queue.push(
                    ev.at,
                    lambda ev=ev: self.traffic.set_offered(
                        ev.offered_per_s or 0.0),
                    label=f"world:serve_load@{ev.at:g}")
            else:
                self.queue.push(
                    ev.at, lambda ev=ev: self.hub.apply(ev),
                    label=f"world:{ev.kind}:{ev.job}@{ev.at:g}")
        # Install the clock BEFORE constructing anything that binds
        # obs_metrics._wall at construction (Guardrails does).
        with installed_clock(self.clock, self._virtual_sleep):
            self._wire_serve()
            self.scheduler = Scheduler(
                list(sc.jobs),
                devices=sc.devices,
                workdir=os.path.join(self.workdir, "sched"),
                ledger_path=self.ledger_path,
                tick_s=sc.tick_s,
                poll_s=min(sc.tick_s, 0.25),
                seed=sc.seed,
                slices=dict(sc.slices) if sc.slices else None,
                collective_fit=sc.collective_fit,
                fleet_factory=SimFleetFactory(self.hub))
            summary = self.scheduler.run()
        out = {
            "scenario": sc.name,
            "seed": sc.seed,
            "virtual_s": round(self.clock.now(), 6),
            "total_ranks": sc.total_ranks,
            "steps_lost": self.hub.steps_lost(),
            "summary": summary,
        }
        if self.hub.snap_stats["losses"]:
            # Only when the scenario scripted snapshot_loss — scenarios
            # without one keep their exact summary shape.
            out["snapshots"] = dict(self.hub.snap_stats)
        if self.traffic is not None:
            out["serve"] = self.traffic.finalize()
            out["serve"]["actions_used"] = (
                self.serve_remediator.guardrails.actions_used)
        self.summary = out
        return out
