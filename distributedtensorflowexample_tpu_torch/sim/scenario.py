"""The scenario DSL: a JSON file scripting what the simulated WORLD
does, never what the control plane decides.

Schema (all times in virtual seconds from sim start)::

    {
      "name": "fleet10k",             # stamps records + workdir
      "seed": 0,                      # Scheduler + jitter RNG seed
      "tick_s": 0.5,                  # scheduler policy-loop cadence
      "horizon_s": 3600,              # hard virtual-time ceiling
      "slices": {"podA": 2048, ...},  # multi-slice mesh (or "devices")
      "collective_fit": {"alpha_s":…, "beta_bytes_per_s":…},  # optional
      "jobs": [                       # resilience.scheduler.Job fields
        {"job": "t1", "kind": "train", "ranks": 256, "steps": 800,
         "est_step_time_s": 0.5, "state_bytes": 4194304,
         "sim": {"startup_s": 3.0, "teardown_s": 1.0}}, ...
      ],
      "serve": {                      # autoscale loop (optional)
        "replicas": 4, "knee_per_replica": 3779.67,
        "min_replicas": 1, "max_replicas": 16, "poll_s": 5.0,
        "headroom": 0.85, "low_water": 0.35,
        "flap_n": 2, "flap_window_s": 60, "cooldown_s": 60,
        "budget": 8                   # cooldown_s omitted -> seeded
      },                              # from the measured HEAL_* MTTR
                                      # record (remediate.
                                      # mttr_seeded_cooldown_s)
      "events": [                     # the scripted world
        {"at": 120, "kind": "host_loss", "job": "t1", "rank": 3}, ...
      ]
    }

``jobs[*].argv`` defaults to ``["sim"]`` — simulated gangs spawn no
processes, but the Job dataclass (and the grow probe's "does the
program resolve" check) wants a token.  ``jobs[*].sim`` holds the
world-model knobs the live scheduler never sees: gang startup/teardown
latency and the straggler slowdown factor.

Event kinds are the closed set below; an unknown kind refuses loudly
at load (a typo'd scenario must not silently run a milder storm).
``tools/sim_run.py`` mirrors this table for its ``--help``/validation
surface.  The port's two copies carry no keep-in-sync markers (the JAX
repo lint walks every file and would count a third copy of the pair);
``tests/test_torch_sim.py`` holds them equal to each other and to the
JAX package's tables instead.
"""

from __future__ import annotations

import dataclasses
import json
import os

from distributedtensorflowexample_tpu_torch.resilience.scheduler import Job

# What the simulated world can DO to the fleet, one line each.
SCENARIO_EVENTS = (
    "host_loss",         # rank's host dies (elastic: shrink; else lost)
    "host_recover",      # lost host answers the recovery probe again
    "straggler",         # rank named straggler; gang slows by factor
    "straggler_clear",   # straggler recovers; gang speed restored
    "gang_crash",        # whole gang crashes (rcs 1 → budgeted retry)
    "gang_wedge",        # gang reports backend wedged (rc 3 quarantine)
    "serve_load",        # offered serve traffic steps to a new level
    "snapshot_loss",     # rank's snapshot shard lost (mirror or rollback)
)

#: Per-job world-model knobs (the ``sim`` sub-dict of a scenario job).
#: ``teardown_s`` (request_stop → unanimous-143 latency) is absent on
#: purpose: unset, it falls back to ``FleetHub.TEARDOWN_S`` so the
#: SIM_TEARDOWN_S env knob can stretch every teardown for drills.
SIM_JOB_DEFAULTS = {
    "startup_s": 2.0,       # place → first step latency
    "straggle_factor": 0.5,  # gang rate multiplier while straggling
}


@dataclasses.dataclass(frozen=True)
class SimEvent:
    at: float
    kind: str
    job: str = ""
    rank: int | None = None
    offered_per_s: float | None = None   # serve_load only


@dataclasses.dataclass
class Scenario:
    name: str
    seed: int
    tick_s: float
    horizon_s: float
    slices: dict | None          # name -> capacity; None = single mesh
    devices: int                 # single-mesh width (slices is None)
    collective_fit: dict | None
    jobs: list[Job]
    sim_jobs: dict               # job id -> resolved sim knobs
    serve: dict | None
    events: list[SimEvent]

    @property
    def total_ranks(self) -> int:
        return sum(j.ranks for j in self.jobs)


def load_scenario(source) -> Scenario:
    """Parse + validate a scenario: a path to a JSON file or an
    already-loaded dict.  Validation is loud and total — every event
    kind, every job reference, every time must check out before the
    sim runs a single tick."""
    if isinstance(source, str):
        with open(source) as f:
            payload = json.load(f)
    else:
        payload = dict(source)
    name = payload.get("name") or (
        os.path.splitext(os.path.basename(source))[0]
        if isinstance(source, str) else "scenario")
    horizon = float(payload.get("horizon_s") or 3600.0)
    jobs: list[Job] = []
    sim_jobs: dict = {}
    for rec in payload.get("jobs") or []:
        rec = dict(rec)
        sim_knobs = dict(SIM_JOB_DEFAULTS)
        sim_knobs.update(rec.pop("sim", None) or {})
        rec.setdefault("argv", ["sim"])
        job = Job.from_dict(rec)
        if not job.steps or not job.est_step_time_s:
            raise ValueError(
                f"scenario {name}: job {job.job!r} needs steps and "
                f"est_step_time_s — the sim's world model derives the "
                f"gang's runtime from them")
        jobs.append(job)
        sim_jobs[job.job] = sim_knobs
    if not jobs:
        raise ValueError(f"scenario {name}: no jobs")
    ids = {j.job for j in jobs}
    events: list[SimEvent] = []
    for rec in payload.get("events") or []:
        kind = rec.get("kind")
        if kind not in SCENARIO_EVENTS:
            raise ValueError(
                f"scenario {name}: unknown event kind {kind!r} "
                f"(known: {', '.join(SCENARIO_EVENTS)})")
        if kind != "serve_load" and rec.get("job") not in ids:
            raise ValueError(
                f"scenario {name}: event {kind!r} at {rec.get('at')} "
                f"names unknown job {rec.get('job')!r}")
        at = float(rec.get("at", -1))
        if not 0 <= at <= horizon:
            raise ValueError(
                f"scenario {name}: event {kind!r} at {at} is outside "
                f"[0, horizon_s {horizon}]")
        events.append(SimEvent(
            at=at, kind=kind, job=rec.get("job") or "",
            rank=rec.get("rank"),
            offered_per_s=rec.get("offered_per_s")))
    events.sort(key=lambda e: (e.at, e.kind, e.job, e.rank or -1))
    slices = payload.get("slices")
    if slices is not None:
        slices = {str(k): int(v) for k, v in slices.items()}
    serve = payload.get("serve")
    if serve is not None and not serve.get("knee_per_replica"):
        raise ValueError(
            f"scenario {name}: serve.knee_per_replica is required — "
            f"the autoscale policy prices capacity from the measured "
            f"SLO knee (SERVE_lm record), not a guess")
    return Scenario(
        name=name,
        seed=int(payload.get("seed") or 0),
        tick_s=float(payload.get("tick_s") or 0.5),
        horizon_s=horizon,
        slices=slices,
        devices=int(payload.get("devices") or 0) or (
            sum(slices.values()) if slices else 8),
        collective_fit=payload.get("collective_fit"),
        jobs=jobs, sim_jobs=sim_jobs, serve=serve, events=events)
