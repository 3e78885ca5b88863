# graftlint: stdlib-only
"""Anomaly-driven remediation: the policy engine that closes the loop
from the detectors to the actuators (the JAX package's
``resilience/remediate.py``; pure Python over the port's ``obs/`` and
``resilience/``, with the same journal records and ``heal_*`` ledger
rows, so a journal written by either package replays in the other).

The fleet sees per-rank ``health.json`` flags (obs/anomaly.py),
journal/ledger ``anomaly`` annotations and live ``serve_*`` latency
gauges.  This module maps those detections onto *declared, rate-limited
policies* over actions the repo already performs safely:

====================  ====================================================
anomaly kind          default remediation
====================  ====================================================
``straggler`` /       **evict** — loss-free gang stop via
``step_time_          ``FleetSupervisor.request_stop`` (TERM → 143 →
regression``          snapshot); the relaunch resumes bitwise from the
                      agreed step, and a transient slowdown (a noisy
                      neighbor, a flapping NIC) does not ride along
``nan_loss`` /        **rollback** — gang rollback to the pinned
``loss_plateau``      last-good snapshot: the newest step every rank
                      holds VALID (SnapshotStore size+crc) that strictly
                      predates the anomaly's ``fired_step``; everything
                      newer is discarded (``discard_newer``) so the next
                      agreement pass cannot resurrect the condemned tail
``serve_p99_breach``  **slo_tighten** — tighten the serving admission
                      SLO (``SERVE_SLO_MS`` semantics,
                      serving/queue.py): shed load loudly instead of
                      admitting requests to miss
``rank_lost``         **quarantine** (repeated offender, flap-gated):
                      a host that keeps dying is the scheduler's rc-3
                      shape — stop feeding it work
``canary_regression`` **canary_rollback** — revert a canary promotion
                      (serving/promote.Canary) to the baseline snapshot
``serve_overload`` /  **scale_up** / **scale_down** — resize the serve
``serve_underload``   replica fleet against the measured SLO knee
                      (SERVE_lm record): offered load over the fleet's
                      in-SLO capacity grows it, sustained idle shrinks
                      it, both clamped to [min, max] replicas
====================  ====================================================

Every decision is **guarded** — this is the part that makes closing the
loop safe enough to ship:

- **flap damping**: a policy acts only after ``HEAL_FLAP_N`` detections
  of the same (kind, scope) inside ``HEAL_FLAP_WINDOW_S``.  Watchers
  emit one detection per poll *while the condition holds*, so a
  one-poll blip (a z-score grazing the threshold once) never reaches an
  actuator, while a persistent condition crosses the bar in
  ``flap_n`` polls.
- **per-kind cooldown** (``HEAL_COOLDOWN_S``): after acting on a
  (kind, scope), further detections of it are suppressed for the
  cooldown — an action storm against a condition the first action is
  still fixing is worse than the condition.
- **global action budget** (``HEAL_ACTION_BUDGET``): a hard ceiling on
  actions per remediator JOURNAL — WAL replay restores the spent count,
  so a crash-looping (or restarted) remediator cannot mint itself a
  fresh budget over the same workdir; an operator resets it by starting
  a new journal.  Exhaustion degrades to DETECTION-ONLY with one loud
  ``heal_budget_exhausted`` ledger row — a remediator gone wrong must
  converge to the detection-only stance, not escalate.
- **dry-run** (``HEAL_DRY_RUN``): every decision is journaled as a
  ``heal_dry_run`` row naming the action that *would* have fired;
  no actuator runs.  The commissioning mode: watch the policy engine
  against production telemetry before arming it.

Crash tolerance is the scheduler's write-ahead pattern: a
``heal_intent`` journal record commits BEFORE the actuator runs and the
applied ``heal_<action>`` record after, so a remediator SIGKILLed
mid-action replays its journal on construction — unmatched intents
re-apply idempotently (every actuator here is: ``request_stop`` on a
dead gang is a no-op, ``discard_newer`` finds the already-discarded
steps gone, re-tightening an SLO to the same value changes nothing).
Every decision also lands as a ``heal_*`` row in the run ledger — the
operator answer to "who restarted my job and why" must come from the
ledger alone.

Importing this module touches no device: the actuator factories that
need the snapshot stores import them lazily, so a scheduler or drill
harness can construct the policy engine in a process that never
initialises CUDA.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import math
import os
import re
import sys
import threading
import time

from distributedtensorflowexample_tpu_torch.obs import anomaly as obs_anomaly
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics

# The heal_* ledger-row schema: every decision class the remediator can
# take, written with src="heal" plus a "job" scope field.
# The `why` verb of tools.obs_query (and of the JAX package's
# tools/obs_query.py) renders exactly this set, so it stays the JAX
# package's tuple (tests/test_torch_remediate.py holds the two equal).
HEAL_EVENTS = (
    "heal_detect",            # anomaly folded into the policy engine
    "heal_evict",             # loss-free gang stop (TERM→143→resume)
    "heal_rollback",          # gang rollback to the pinned last-good step
    "heal_slo_tighten",       # serving admission SLO tightened / load shed
    "heal_quarantine",        # repeated offender quarantined (rc-3 shape)
    "heal_canary_promote",    # canary window clean: candidate promoted
    "heal_canary_rollback",   # canary regressed: reverted to baseline
    "heal_scale_up",          # serve fleet grown against the SLO knee
    "heal_scale_down",        # serve fleet shrunk (sustained underload)
    "heal_lr_drop",           # plateau -> LR-drop advisory (HEAL_LR_DROP)
    "heal_suppressed",        # guardrail suppressed an action (with why)
    "heal_dry_run",           # dry-run: what WOULD have fired
    "heal_budget_exhausted",  # budget gone: detection-only from here on
)

#: Actions (the ``heal_<action>`` applied-row suffixes).
HEAL_ACTIONS = ("evict", "rollback", "slo_tighten", "quarantine",
                "canary_promote", "canary_rollback",
                "scale_up", "scale_down", "lr_drop")

_DETECTIONS = obs_metrics.counter(
    "heal_detections_total", "anomaly detections folded into the "
    "remediation policy engine, by kind")
_ACTIONS = obs_metrics.counter(
    "heal_actions_total", "remediation actions applied, by action")
_SUPPRESSED = obs_metrics.counter(
    "heal_suppressed_total", "remediation actions suppressed by a "
    "guardrail, by reason")


def _log(msg: str) -> None:
    print(f"heal: {msg}", file=sys.stderr, flush=True)


# --- env knobs (constant-name reads through one helper each) ---------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def dry_run_default() -> bool:
    """``HEAL_DRY_RUN``: 1/true = journal what would fire, run nothing."""
    return str(os.environ.get("HEAL_DRY_RUN", "")).lower() in (
        "1", "true", "t", "yes", "y")


def cooldown_default() -> float:
    """``HEAL_COOLDOWN_S``: per-(kind, scope) quiet period after an
    action (default 30 s)."""
    return _env_float("HEAL_COOLDOWN_S", 30.0)


def lr_drop_enabled() -> bool:
    """``HEAL_LR_DROP``: 1/true = map ``loss_plateau`` to the lr-drop
    advisory stub instead of gang rollback (experimental: the trainer
    consumption seam is not wired yet — the actuator writes an advisory
    file a future LR hook reads at its next consensus poll)."""
    return str(os.environ.get("HEAL_LR_DROP", "")).lower() in (
        "1", "true", "t", "yes", "y")


def newest_heal_record(root: str = "") -> str:
    """Path of the newest checked-in MTTR drill record
    (``HEAL_*_r<NN>.json`` at the repo root — round number sorts
    lexicographically), or ``""`` when none exists."""
    if not root:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    paths = sorted(_glob.glob(os.path.join(root, "HEAL_*.json")))
    return paths[-1] if paths else ""


def mttr_seeded_cooldown_s(record_path: str = "", *, margin: float = 2.0,
                           floor_s: float = 5.0) -> float:
    """Cooldown seeded from MEASURED recovery time instead of a
    hardcoded constant: ``margin ×`` the worst end-to-end MTTR the
    newest ``HEAL_*`` drill record proved (detect → act → resumed), so
    the post-action quiet period holds exactly as long as a real heal
    plausibly takes.  A 30 s constant was simultaneously too short for
    a 21 s slow-rank evict+resume and absurdly long for a 54 ms SLO
    tighten; anchoring on the measured tail keeps the guardrail honest
    as the fleet's recovery speed changes.  ``HEAL_COOLDOWN_S`` (via
    :func:`cooldown_default`) still wins when no record is readable."""
    path = record_path or newest_heal_record()
    worst_ms = 0.0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if str(row.get("metric", "")).endswith("_mttr_ms"):
                    try:
                        worst_ms = max(worst_ms, float(row["value"]))
                    except (KeyError, TypeError, ValueError):
                        continue
    except OSError:
        return cooldown_default()
    if worst_ms <= 0:
        return cooldown_default()
    return max(floor_s, margin * worst_ms / 1000.0)


def budget_default() -> int:
    """``HEAL_ACTION_BUDGET``: global actions-per-journal ceiling
    (default 8; WAL replay restores the spent count, a new journal
    resets it); exhaustion degrades to detection-only, loudly."""
    return int(_env_float("HEAL_ACTION_BUDGET", 8))


def flap_n_default() -> int:
    """``HEAL_FLAP_N``: detections of one (kind, scope) inside the flap
    window before a policy may act (default 2 — a one-poll blip never
    reaches an actuator)."""
    return max(1, int(_env_float("HEAL_FLAP_N", 2)))


def flap_window_default() -> float:
    """``HEAL_FLAP_WINDOW_S``: the flap-damping window (default 60 s)."""
    return _env_float("HEAL_FLAP_WINDOW_S", 60.0)


# --- events + policy -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnomalyEvent:
    """One detection occurrence handed to the policy engine.

    ``key`` identifies the underlying anomaly (dedup for the
    ``heal_detect`` row: one row per distinct anomaly, however many
    polls re-observe it); ``scope`` labels whose anomaly it is (a job
    id under the scheduler, a task name standalone, "serve" for the
    serving worker) and keys the flap/cooldown guardrails together
    with ``kind``."""
    kind: str
    key: str
    scope: str = ""
    rank: int | None = None
    step: int | None = None
    source: str = ""              # health | ledger | scrape | canary
    # Optional episode label folded into the guardrail key: a watcher
    # that can PROVE recovery between occurrences (ServeWatcher's
    # breach→recover→breach) stamps a fresh episode so the new
    # condition gets a fresh decision instead of a cooldown leftover.
    episode: str = ""
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class HealRule:
    """kind → action, with an optional per-kind flap override (e.g.
    ``rank_lost`` → quarantine wants "repeated offender", not "first
    offense")."""
    action: str
    flap_n: int | None = None


#: The default policy table.  A kind with no rule is
#: detection-only: heal_detect rows, counters, nothing else.
DEFAULT_POLICY: dict[str, HealRule] = {
    "straggler": HealRule("evict"),
    "step_time_regression": HealRule("evict"),
    "nan_loss": HealRule("rollback"),
    "loss_plateau": HealRule("rollback"),
    "serve_p99_breach": HealRule("slo_tighten"),
    "rank_lost": HealRule("quarantine", flap_n=3),
    "canary_regression": HealRule("canary_rollback", flap_n=1),
    "serve_overload": HealRule("scale_up"),
    # Shrinking trades capacity for efficiency — demand a LONGER
    # period of proof than growth does (scale-down flaps are the
    # classic autoscaler failure: shed replicas into a lull, then
    # breach the SLO when the next burst lands on the smaller fleet).
    "serve_underload": HealRule("scale_down", flap_n=4),
}


# --- guardrails ------------------------------------------------------------

class Guardrails:
    """Flap damping + per-key cooldown + the global action budget —
    pure bookkeeping, injectable clock, no IO (the Remediator owns the
    rows)."""

    def __init__(self, flap_n: int | None = None,
                 flap_window_s: float | None = None,
                 cooldown_s: float | None = None,
                 budget: int | None = None,
                 clock=None):
        self.flap_n = flap_n_default() if flap_n is None else max(1, flap_n)
        self.flap_window_s = (flap_window_default()
                              if flap_window_s is None else flap_window_s)
        self.cooldown_s = (cooldown_default()
                           if cooldown_s is None else cooldown_s)
        self.budget = budget_default() if budget is None else budget
        self.clock = clock or obs_metrics._wall
        self.actions_used = 0
        self._seen: dict = {}         # key -> [detection ts, ...]
        self._acted: dict = {}        # key -> last action ts

    def note(self, key, flap_n: int | None = None) -> str:
        """Record one detection occurrence of ``key`` and return the
        disposition: ``act`` | ``flap`` | ``cooldown`` | ``budget``.
        The caller applies the action (and calls :meth:`acted`) only on
        ``act``."""
        now = self.clock()
        tape = [t for t in self._seen.get(key, [])
                if now - t <= self.flap_window_s]
        tape.append(now)
        self._seen[key] = tape
        last = self._acted.get(key)
        if self.cooldown_s > 0 and last is not None \
                and now - last < self.cooldown_s:
            return "cooldown"
        if len(tape) < (self.flap_n if flap_n is None else max(1, flap_n)):
            return "flap"
        if self.actions_used >= self.budget:
            return "budget"
        return "act"

    def acted(self, key) -> None:
        now = self.clock()
        self.actions_used += 1
        self._acted[key] = now
        self._seen[key] = []          # a fresh episode must re-flap

    def touch_cooldown(self, key) -> None:
        """Anchor the cooldown WITHOUT charging the budget — the
        errored-actuator path: a held condition whose actuator keeps
        crashing must retry once per cooldown, not once per poll
        (~12 fsync'd WAL rows/s), and crashes spend no budget."""
        self._acted[key] = self.clock()

    def restore_action(self, key, ts: float) -> None:
        """Replay half: an applied action from a previous incarnation
        still counts against the budget and still anchors the
        cooldown."""
        self.actions_used += 1
        if ts > self._acted.get(key, -float("inf")):
            self._acted[key] = ts


# --- the remediator --------------------------------------------------------

class Remediator:
    """The policy engine: observe detections, map them through the
    policy table and guardrails, run actuators under a write-ahead
    journal, land every decision as a ``heal_*`` ledger row.

    ``actuators`` maps action name → ``callable(event) -> dict``.  An
    actuator returns a detail dict for the applied row; returning
    ``{"noop": why}`` records a suppression instead (no budget, no
    cooldown) — the "condition true but nothing useful to do" case,
    e.g. a straggling job with no queued work waiting for its devices.
    A missing actuator is detection-only for that action.

    Construction replays the journal: detected keys re-latch, applied
    actions restore the budget/cooldown state, and an unmatched
    ``heal_intent`` — a SIGKILL landed between intent and effect — is
    re-applied idempotently (``replayed: true`` on its applied row)."""

    def __init__(self, journal=None, ledger_path: str = "",
                 *, actuators: dict | None = None,
                 policy: dict[str, HealRule] | None = None,
                 scope: str = "",
                 dry_run: bool | None = None,
                 guardrails: Guardrails | None = None,
                 clock=None):
        from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
            Journal)
        self.journal = journal or Journal(None)
        self.ledger_path = ledger_path
        self.actuators = dict(actuators or {})
        self.policy = dict(DEFAULT_POLICY if policy is None else policy)
        if policy is None and lr_drop_enabled():
            # Experimental (HEAL_LR_DROP): a plateau asks for a smaller
            # LR before it asks for a rollback — the advisory stub;
            # explicit policy tables are never silently rewritten.
            self.policy["loss_plateau"] = HealRule("lr_drop")
        self.scope = scope
        self.dry_run = dry_run_default() if dry_run is None else dry_run
        self.guardrails = guardrails or Guardrails(clock=clock)
        self._seq = 0
        self._detected: set[str] = set()
        # Last suppression reason per key — suppressed rows land once
        # per (key, reason) EPISODE, not once per poll: a held
        # condition re-observed every 0.25 s must not flood the ledger.
        self._last_suppression: dict = {}
        self._replay()

    # --- rows -------------------------------------------------------------
    def _row(self, event: str, *, seq=None, ledger: bool = True,
             **fields) -> None:
        fields.setdefault("job", self.scope or None)
        self.journal.write(event, **({"seq": seq} if seq is not None
                                     else {}), **fields)
        if ledger and self.ledger_path:
            obs_ledger.log_event(event, path=self.ledger_path, src="heal",
                                 **fields)

    def _suppress(self, ev: AnomalyEvent, action: str, reason: str,
                  **fields) -> str:
        _SUPPRESSED.labels(reason=reason).inc()
        if self._last_suppression.get(ev.key) != reason:
            self._last_suppression[ev.key] = reason
            self._row("heal_suppressed", key=ev.key, kind=ev.kind,
                      action=action, reason=reason,
                      job=ev.scope or self.scope or None, **fields)
        return reason

    # --- replay (crash tolerance) -----------------------------------------
    def _replay(self) -> None:
        applied_events = tuple(f"heal_{a}" for a in HEAL_ACTIONS)
        intents: dict[int, dict] = {}
        budget_row_seen = False
        for rec in self.journal.events():
            ev = rec.get("event", "")
            if not ev.startswith("heal_"):
                continue
            seq = rec.get("seq")
            if isinstance(seq, int):
                self._seq = max(self._seq, seq)
            if ev == "heal_detect":
                self._detected.add(rec.get("key") or "")
            elif ev == "heal_intent":
                intents[seq] = rec
            elif ev in applied_events or ev == "heal_suppressed":
                if isinstance(seq, int):
                    intents.pop(seq, None)
                if ev in applied_events and not rec.get("error"):
                    # Error rows balance the WAL but the live path never
                    # charged them (no acted()) — replay must not either,
                    # or a restart after N actuator failures would wake
                    # up budget-exhausted without one action ever run.
                    self.guardrails.restore_action(
                        (rec.get("kind"), rec.get("job") or "",
                         rec.get("episode") or ""),
                        float(rec.get("ts") or 0.0))
            elif ev == "heal_budget_exhausted":
                budget_row_seen = True
        self._budget_row_written = budget_row_seen
        if budget_row_seen and self.guardrails.actions_used \
                >= self.guardrails.budget:
            # The loud row is already on the ledger (written once per
            # journal); say on stderr that THIS incarnation inherits
            # the exhausted state rather than degrading silently.
            _log(f"journal replay restored {self.guardrails.actions_used}"
                 f"/{self.guardrails.budget} actions — starting in "
                 f"detection-only mode (heal_budget_exhausted already "
                 f"on the ledger)")
        for seq in sorted(intents):
            rec = intents[seq]
            action = rec.get("action") or ""
            ev = AnomalyEvent(kind=rec.get("kind") or "",
                              key=rec.get("key") or "",
                              scope=rec.get("job") or self.scope,
                              rank=rec.get("rank"), step=rec.get("step"),
                              episode=rec.get("episode") or "",
                              source="replay")
            _log(f"replaying interrupted heal intent seq={seq} "
                 f"({action} on {ev.key}): a prior remediator died "
                 f"between intent and effect")
            self._apply(ev, action, seq, replayed=True)

    # --- the decision path ------------------------------------------------
    def observe(self, ev: AnomalyEvent) -> str:
        """Fold one detection occurrence in; returns the disposition:
        ``detected`` (no rule) | ``flap`` | ``cooldown`` | ``budget`` |
        ``dry_run`` | ``no_actuator`` | ``noop`` | ``acted`` |
        ``error``."""
        if ev.key not in self._detected:
            self._detected.add(ev.key)
            _DETECTIONS.labels(kind=ev.kind).inc()
            self._row("heal_detect", key=ev.key, kind=ev.kind,
                      rank=ev.rank, step=ev.step, source=ev.source,
                      job=ev.scope or self.scope or None,
                      detail=obs_metrics.json_safe(ev.detail) or None)
        rule = self.policy.get(ev.kind)
        if rule is None:
            return "detected"
        gkey = (ev.kind, ev.scope or self.scope, ev.episode)
        disposition = self.guardrails.note(gkey, flap_n=rule.flap_n)
        if disposition == "flap":
            return self._suppress(ev, rule.action, "flap",
                                  seen=len(self.guardrails._seen[gkey]),
                                  need=(rule.flap_n
                                        or self.guardrails.flap_n))
        if disposition == "cooldown":
            return self._suppress(ev, rule.action, "cooldown",
                                  cooldown_s=self.guardrails.cooldown_s)
        if disposition == "budget":
            if not self._budget_row_written:
                self._budget_row_written = True
                self._row("heal_budget_exhausted",
                          budget=self.guardrails.budget, key=ev.key,
                          kind=ev.kind,
                          job=ev.scope or self.scope or None)
                _log(f"action budget {self.guardrails.budget} exhausted "
                     f"— degrading to detection-only; the WAL restores "
                     f"the spent count, so only a fresh journal resets "
                     f"it")
            return self._suppress(ev, rule.action, "budget")
        if self.dry_run:
            if self._last_suppression.get(ev.key) != "dry_run":
                self._last_suppression[ev.key] = "dry_run"
                self._row("heal_dry_run", key=ev.key, kind=ev.kind,
                          action=rule.action, rank=ev.rank, step=ev.step,
                          job=ev.scope or self.scope or None)
            return "dry_run"
        if rule.action not in self.actuators:
            return self._suppress(ev, rule.action, "no_actuator")
        self._seq += 1
        seq = self._seq
        self.journal.write("heal_intent", seq=seq, action=rule.action,
                           key=ev.key, kind=ev.kind, rank=ev.rank,
                           step=ev.step, episode=ev.episode or None,
                           job=ev.scope or self.scope or None)
        return self._apply(ev, rule.action, seq)

    def _apply(self, ev: AnomalyEvent, action: str, seq: int,
               replayed: bool = False) -> str:
        actuator = self.actuators.get(action)
        if actuator is None:
            # Replay path with a narrower actuator set than the dead
            # incarnation's: resolve the intent loudly, don't crash.
            return self._suppress(ev, action, "no_actuator", seq=seq)
        gkey = (ev.kind, ev.scope or self.scope, ev.episode)
        try:
            detail = actuator(ev) or {}
        except Exception as e:       # noqa: BLE001 — a broken actuator
            # must not kill the engine watching everything else; the
            # applied row carries the error so the WAL still balances.
            self._row(f"heal_{action}", seq=seq, key=ev.key, kind=ev.kind,
                      error=str(e), replayed=replayed or None,
                      job=ev.scope or self.scope or None)
            self.guardrails.touch_cooldown(gkey)
            _log(f"actuator {action} failed on {ev.key}: {e} "
                 f"(retrying after the {self.guardrails.cooldown_s:g}s "
                 f"cooldown)")
            return "error"
        if isinstance(detail, dict) and detail.get("noop"):
            return self._suppress(ev, action, f"noop: {detail['noop']}",
                                  seq=seq)
        self.guardrails.acted(gkey)
        self._last_suppression.pop(ev.key, None)
        _ACTIONS.labels(action=action).inc()
        self._row(f"heal_{action}", seq=seq, key=ev.key, kind=ev.kind,
                  rank=ev.rank, step=ev.step,
                  replayed=replayed or None,
                  episode=ev.episode or None,
                  job=ev.scope or self.scope or None,
                  detail=obs_metrics.json_safe(detail) or None)
        _log(f"{action} on {ev.key}"
             + (f" ({detail})" if detail else "")
             + (" [replayed]" if replayed else ""))
        return "acted"


# --- watchers (detection sources) ------------------------------------------

class HealthWatcher:
    """Poll per-rank ``health.json`` files (and the fleet aggregate)
    for firing flags; one event per poll per held condition.

    Flag semantics mirror obs/anomaly.py's payloads: ``nan_loss`` is
    permanent (``fired_step`` set means the run SAW a NaN — the
    condition cannot un-happen, so a post-mortem file still reports
    it); ``step_time_regression``/``loss_plateau`` count only while
    ``firing`` (a decayed blip must stop feeding the flap counter, or
    damping would be vacuous)."""

    def __init__(self, pattern: str, fleet_health: str = "",
                 scope: str = ""):
        self.pattern = pattern            # glob over per-rank files
        self.fleet_health = fleet_health  # aggregate (stragglers)
        self.scope = scope

    @staticmethod
    def _rank_of(payload: dict, path: str) -> int | None:
        r = payload.get("rank")
        if isinstance(r, int):
            return r
        m = re.search(r"health_rank(\d+)", os.path.basename(path))
        return int(m.group(1)) if m else None

    def poll(self) -> list[AnomalyEvent]:
        out: list[AnomalyEvent] = []
        for path in sorted(_glob.glob(self.pattern)):
            payload = obs_anomaly.read_health(path)
            if not payload or payload.get("kind") == "fleet":
                continue
            rank = self._rank_of(payload, path)
            for kind, f in (payload.get("flags") or {}).items():
                fired = f.get("fired_step")
                held = (fired is not None if kind == "nan_loss"
                        else bool(f.get("firing")))
                if not held:
                    continue
                out.append(AnomalyEvent(
                    kind=kind, key=f"rank{rank}:{kind}:{fired}",
                    scope=self.scope, rank=rank,
                    step=fired if fired is not None
                    else payload.get("step"),
                    source="health",
                    detail={"updated_unix": payload.get("updated_unix"),
                            "step": payload.get("step")}))
        if self.fleet_health:
            payload = obs_anomaly.read_health(self.fleet_health)
            if payload and payload.get("kind") == "fleet":
                skew = payload.get("skew") or {}
                for r in payload.get("stragglers") or []:
                    out.append(AnomalyEvent(
                        kind="straggler", key=f"straggler:rank{r}",
                        scope=self.scope, rank=int(r),
                        source="health",
                        detail={"why": (skew.get("why") or {}).get(
                                    str(r), (skew.get("why") or {}).get(r)),
                                "updated_unix": payload.get(
                                    "updated_unix")}))
        return out


class LedgerWatcher:
    """Tail the run ledger for ``anomaly`` / ``rank_lost`` rows — the
    fleet's journal annotations mirrored into RUNS.jsonl.  Tracks how
    many rows it has consumed; each NEW row is one detection
    occurrence (so N losses of one rank accumulate toward the
    repeated-offender flap bar)."""

    def __init__(self, path: str, kinds=("anomaly", "rank_lost"),
                 scope: str = ""):
        self.path = path
        self.kinds = tuple(kinds)
        self.scope = scope
        self._consumed = 0
        self._sizes: tuple = ()

    def _stat_sizes(self) -> tuple:
        out = []
        for p in (self.path, self.path + ".1"):
            try:
                out.append(os.stat(p).st_size)
            except OSError:
                out.append(-1)
        return tuple(out)

    def poll(self) -> list[AnomalyEvent]:
        # Size gate: the watch loop ticks every ~0.25 s against a file
        # that grows every few seconds at most — re-parsing the whole
        # ledger per tick is O(file) work for nothing.  Sizes move on
        # every append AND on rotation (live shrinks, .1 appears), so
        # an unchanged pair means unchanged rows.
        sizes = self._stat_sizes()
        if sizes == self._sizes:
            return []
        if sizes[0] < 0:
            # Mid-rotation window (os.replace moved the live file, the
            # next append hasn't recreated it): keep the cursor and the
            # size snapshot — re-read on the next poll, never reset
            # _consumed to 0 and re-emit history as fresh detections.
            return []
        self._sizes = sizes
        rows, _ = obs_ledger.read_rows(self.path)
        if len(rows) < self._consumed:
            # A second rotation dropped history below the cursor; clamp
            # forward rather than mis-slice — re-emitting old rank_lost
            # rows could quarantine a healthy host.
            self._consumed = len(rows)
            return []
        new, self._consumed = rows[self._consumed:], len(rows)
        out = []
        for i, row in enumerate(new):
            ev = row.get("event")
            if ev not in self.kinds:
                continue
            kind = row.get("kind") if ev == "anomaly" else "rank_lost"
            rank = row.get("rank")
            step = row.get("fired_step") if ev == "anomaly" \
                else row.get("step")
            out.append(AnomalyEvent(
                kind=str(kind), scope=self.scope,
                key=f"ledger:{kind}:rank{rank}:"
                    f"{step if step is not None else self._consumed - len(new) + i}",
                rank=rank, step=step, source="ledger",
                detail={"ts": row.get("ts"), "task": row.get("task"),
                        "why": row.get("why") or row.get("error")}))
        return out


class ServeWatcher:
    """Scrape serving latency (``stats_fn`` → the batcher's stats dict,
    or anything shaped like it) and emit ``serve_p99_breach`` while the
    p99 sits over ``breach_ms``.  Episodes re-arm on recovery: breach →
    heal → p99 back under → a LATER breach is a new key (a re-tightened
    SLO that breaches again deserves a fresh decision, not a cooldown
    leftover)."""

    def __init__(self, stats_fn, breach_ms: float,
                 min_completed: int = 8, scope: str = "serve"):
        self.stats_fn = stats_fn
        self.breach_ms = float(breach_ms)
        self.min_completed = min_completed
        self.scope = scope
        self._episode = 0
        self._in_breach = False

    def poll(self) -> list[AnomalyEvent]:
        try:
            stats = self.stats_fn() or {}
        except Exception:             # noqa: BLE001 — a scrape failing
            return []                 # must read as "no data", never die
        p99 = stats.get("p99_ms")
        completed = stats.get("completed") or 0
        if p99 is None or completed < self.min_completed:
            return []
        if p99 > self.breach_ms:
            self._in_breach = True
            return [AnomalyEvent(
                kind="serve_p99_breach",
                key=f"serve_p99:e{self._episode}", scope=self.scope,
                source="scrape", episode=f"e{self._episode}",
                detail={"p99_ms": p99, "breach_ms": self.breach_ms,
                        "completed": completed})]
        if self._in_breach:
            self._in_breach = False
            self._episode += 1
        return []


class AutoscaleWatcher:
    """Scrape the serve fleet's offered load (``stats_fn`` →
    ``{"offered_per_s", "replicas", ...}``) against the measured SLO
    knee — the best in-SLO per-replica throughput a SERVE_lm record
    proved (``throughput_vs_slo``) — and emit ``serve_overload`` while
    offered load exceeds the fleet's in-SLO capacity
    (``replicas × knee × headroom``) and ``serve_underload`` while the
    fleet idles under ``low_water`` of it.  Both directions carry their
    own recovery-re-armed episodes (ServeWatcher's pattern): load that
    breaches, recovers, and breaches again deserves a fresh decision,
    not a cooldown leftover."""

    def __init__(self, stats_fn, knee_per_replica: float, *,
                 headroom: float = 0.85, low_water: float = 0.35,
                 min_replicas: int = 1, scope: str = "serve"):
        self.stats_fn = stats_fn
        self.knee = float(knee_per_replica)
        self.headroom = headroom
        self.low_water = low_water
        self.min_replicas = min_replicas
        self.scope = scope
        self._episode = {"up": 0, "down": 0}
        self._held = {"up": False, "down": False}

    def _event(self, direction: str, kind: str, offered: float,
               replicas: int, capacity: float) -> AnomalyEvent:
        e = self._episode[direction]
        self._held[direction] = True
        return AnomalyEvent(
            kind=kind, key=f"serve_load:{direction}:e{e}",
            scope=self.scope, source="scrape", episode=f"e{e}",
            detail={"offered_per_s": round(offered, 3),
                    "capacity_per_s": round(capacity, 3),
                    "replicas": replicas,
                    "knee_per_replica": self.knee})

    def _recover(self, direction: str) -> None:
        if self._held[direction]:
            self._held[direction] = False
            self._episode[direction] += 1

    def poll(self) -> list[AnomalyEvent]:
        try:
            stats = self.stats_fn() or {}
        except Exception:             # noqa: BLE001 — a scrape failing
            return []                 # must read as "no data", never die
        offered = stats.get("offered_per_s")
        replicas = stats.get("replicas")
        if offered is None or not replicas:
            return []
        capacity = replicas * self.knee * self.headroom
        if offered > capacity:
            self._recover("down")
            return [self._event("up", "serve_overload", offered,
                                replicas, capacity)]
        if (replicas > self.min_replicas
                and offered < replicas * self.knee * self.low_water):
            self._recover("up")
            return [self._event("down", "serve_underload", offered,
                                replicas, capacity)]
        self._recover("up")
        self._recover("down")
        return []


# --- actuator factories ----------------------------------------------------

class FleetTarget:
    """Late-bound fleet handle: ``run_remediated`` swaps the live
    FleetSupervisor in per relaunch, so actuators built once keep
    pointing at the CURRENT gang."""

    def __init__(self):
        self.fleet = None

    def request_stop(self, reason: str) -> dict:
        fleet = self.fleet
        if fleet is None:
            return {"noop": "no live fleet"}
        fleet.request_stop(reason)
        return {"stopped": reason, "ranks": list(fleet.ranks)}

    def ranks(self) -> list[int]:
        return list(self.fleet.ranks) if self.fleet is not None else []


def make_evict_actuator(target: FleetTarget, reason: str = "heal_evict"):
    """Straggler/regression → loss-free gang stop: every rank saves and
    exits 143; the caller's relaunch resumes bitwise from the agreed
    step.  Idempotent: stopping a stopped (or finished) gang is a
    no-op."""
    def evict(ev: AnomalyEvent) -> dict:
        return target.request_stop(reason)
    return evict


def make_rollback_actuator(snapshot_dir_template: str,
                           target: FleetTarget | None = None,
                           ranks=None):
    """NaN/plateau → gang rollback: pin the last-good step (newest step
    EVERY rank holds valid that strictly predates the anomaly's
    ``fired_step``), discard everything newer on every rank, and stop
    the gang so the relaunch's agreement pass lands exactly there.
    "Valid" is ``snapshot.valid_steps`` — monolithic-valid UNION
    quorum-valid shard sets (resilience/shardstore.py), so a row-layout
    run rolls back to a step whose every 1/D shard is digest-intact (or
    ring-mirror-recoverable), and the discard covers both formats.
    Idempotent end to end: ``discard_newer`` finds already-discarded
    steps gone, and re-pinning the same step re-derives the same
    answer."""
    def rollback(ev: AnomalyEvent) -> dict:
        from distributedtensorflowexample_tpu_torch.resilience import (
            snapshot as snap)
        rs = list(ranks) if ranks is not None else (
            target.ranks() if target is not None else [0])
        if not rs:
            rs = [0]
        dirs = {r: snapshot_dir_template.replace("{rank}", str(r))
                for r in rs}
        per_rank = {r: snap.valid_steps(d) for r, d in dirs.items()}
        common = set.intersection(*(set(v) for v in per_rank.values())) \
            if per_rank else set()
        good = [s for s in common
                if ev.step is None or s < ev.step]
        last_good = max(good) if good else 0
        discarded = {r: snap.SnapshotStore(d).discard_newer(last_good)
                     for r, d in dirs.items()}
        detail = {"last_good": last_good, "bad_from": ev.step,
                  "discarded": {str(r): v for r, v in discarded.items()}}
        if target is not None:
            detail.update(target.request_stop("heal_rollback"))
            detail.pop("noop", None)    # a dead gang still got rolled back
        return detail
    return rollback


def make_quarantine_actuator(target: FleetTarget):
    """Repeated-offender rank → quarantine: tombstone the rank's host
    down-forever (``mark_host_down(down_s=0)``), so neither the fleet's
    recovery re-probe nor the scheduler's grow policy ever hands it
    work again — the supervisor protocol's rc-3 "stop burning the
    window" rule, applied to one host.  An operator removes the
    tombstone to parole it.  Idempotent: re-tombstoning a tombstoned
    host rewrites the same file."""
    def quarantine(ev: AnomalyEvent) -> dict:
        from distributedtensorflowexample_tpu_torch.resilience.faults import (
            mark_host_down)
        fleet = target.fleet
        if fleet is None or ev.rank is None:
            return {"noop": "no live fleet / event names no rank"}
        path = fleet._host_down_path(ev.rank)
        mark_host_down(path, down_s=0.0, rank=ev.rank)
        return {"rank": ev.rank, "tombstone": path}
    return quarantine


def make_slo_actuator(get_slo, set_slo, target_ms: float):
    """Serving p99 breach → tighten admission: clamp the live SLO down
    to ``target_ms`` (never loosen — that direction is an operator
    decision).  Idempotent: re-clamping to the same value is a no-op
    with a truthful row."""
    def tighten(ev: AnomalyEvent) -> dict:
        current = get_slo()
        new = target_ms if not current or current <= 0 \
            else min(current, target_ms)
        set_slo(new)
        return {"slo_ms": new, "was": current,
                "p99_ms": ev.detail.get("p99_ms")}
    return tighten


def make_lr_drop_actuator(advisory_path: str, factor: float = 0.5):
    """Plateau → LR-drop advisory (stub, behind ``HEAL_LR_DROP``): no
    live trainer seam consumes this yet, so the actuator's whole effect
    is one advisory file — ``{"scale", "fired_step", "kind"}`` — that a
    future LR hook reads at its next consensus poll, plus the
    ``heal_lr_drop`` ledger row.  Idempotent: rewriting the same
    advisory is a no-op in effect; repeated plateaus compound the scale
    so each action asks for a genuinely smaller LR."""
    def lr_drop(ev: AnomalyEvent) -> dict:
        prior = 1.0
        try:
            with open(advisory_path, encoding="utf-8") as f:
                prior = float((json.load(f) or {}).get("scale", 1.0))
        except (OSError, ValueError):
            pass
        scale = prior * factor
        tmp = advisory_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"scale": scale, "fired_step": ev.step,
                       "kind": ev.kind}, f)
        os.replace(tmp, advisory_path)
        return {"advisory": advisory_path, "scale": scale,
                "factor": factor, "stub": True}
    return lr_drop


def make_autoscale_actuator(get_replicas, set_replicas, *,
                            knee_per_replica: float,
                            min_replicas: int = 1,
                            max_replicas: int = 8,
                            headroom: float = 0.85):
    """Overload/underload → resize the serve replica fleet against the
    measured knee: the target is the replica count whose in-SLO
    capacity (``replicas × knee × headroom``) covers the offered load,
    clamped to ``[min_replicas, max_replicas]`` and to ONE step per
    action in the shrink direction (an autoscaler may chase a spike up
    quickly, but giving capacity back is done a replica at a time — a
    mis-measured lull must not halve the fleet).  At the max-replica
    ceiling an overload answers ``noop`` — the loud "policy cannot help
    further, operator must grow the ceiling" refusal, which costs no
    budget and no cooldown.  Idempotent: re-scaling to the current
    count is a no-op with a truthful row."""
    def scale(ev: AnomalyEvent) -> dict:
        current = int(get_replicas())
        offered = float(ev.detail.get("offered_per_s") or 0.0)
        want = max(min_replicas, math.ceil(
            offered / (knee_per_replica * headroom))
            if offered > 0 else min_replicas)
        if ev.kind == "serve_overload":
            target = min(max_replicas, max(current + 1, want))
            if current >= max_replicas:
                return {"noop": f"already at max_replicas "
                                f"{max_replicas} — the policy cannot "
                                f"add capacity; raise the ceiling or "
                                f"shed load (slo_tighten)"}
        else:
            target = max(min_replicas, min(current - 1, want))
            if current <= min_replicas:
                return {"noop": f"already at min_replicas "
                                f"{min_replicas}"}
        if target == current:
            return {"noop": f"already at target {current} replica(s)"}
        set_replicas(target)
        return {"replicas": target, "was": current,
                "offered_per_s": round(offered, 3),
                "knee_per_replica": knee_per_replica}
    return scale


# --- the self-healing fleet runner -----------------------------------------

def _current(ev: AnomalyEvent, since: float) -> bool:
    """Whether ``ev`` was read from a file written at or after ``since``
    (events with no ``updated_unix``, a ledger row's, always are)."""
    written = (ev.detail or {}).get("updated_unix")
    return not isinstance(written, (int, float)) or written >= since


def run_remediated(make_fleet, argv: list[str], remediator: Remediator,
                   watchers: list, *, target: FleetTarget | None = None,
                   name: str = "", snapshot_dir_template: str = "",
                   stdout_dir: str | None = None,
                   env_extra: dict | None = None,
                   poll_s: float = 0.25, max_heals: int = 4,
                   drain_polls: int = 3) -> dict:
    """Drive a gang to completion under remediation: launch via
    ``make_fleet()``, poll the watchers into the remediator while the
    gang runs, and relaunch (``agree_first`` — resuming over stores a
    previous incarnation wrote) whenever a heal action stopped it or a
    post-mortem poll healed a dead one, up to ``max_heals`` relaunches.

    Heal relaunches export ``SUPERVISE_ATTEMPT=<launch>`` so transient
    FaultPlans (tools/faultline.py) stay cleared across the new
    FleetSupervisor incarnation — the same "a retry models recovered
    hardware" semantics an in-fleet restart has.

    A detection read from a health file last written before the running
    launch started is the previous incarnation's, which the new ranks
    have not overwritten yet: it is not observed (:func:`_current`).
    Otherwise a relaunch whose start-up (the agreement pass, the ranks'
    imports) outlasts the cooldown is evicted before it starts, for the
    condition its predecessor was evicted for.  The JAX package's
    ``run_remediated`` observes it.

    Returns ``{"results": [GangResult...], "healed": int,
    "timeline": [(wall_ts, what)...], "status": <final>}``."""
    results = []
    timeline: list = []
    launch = 0
    while True:
        fleet = make_fleet()
        if target is not None:
            target.fleet = fleet
        extra = dict(env_extra or {})
        if launch > 0:
            extra.setdefault("SUPERVISE_ATTEMPT", str(launch))
        # Per-launch stdout: each incarnation restarts the fleet's
        # attempt numbering at 0, and a healed relaunch must not
        # clobber the evicted launch's JSON tails (both are evidence —
        # the drill's zero-lost-steps proof reads all of them).
        out_dir = (os.path.join(stdout_dir, f"launch{launch}")
                   if stdout_dir else None)
        started = obs_metrics._wall()
        timeline.append((started, f"launch{launch}"))
        box: list = []

        def _run(fleet=fleet, extra=extra, launch=launch,
                 out_dir=out_dir):
            try:
                box.append(fleet.run(
                    argv, name=name,
                    snapshot_dir_template=snapshot_dir_template,
                    stdout_dir=out_dir, env_extra=extra or None,
                    agree_first=launch > 0))
            except BaseException as e:   # noqa: BLE001 — surfaced below
                box.append(e)

        t = threading.Thread(target=_run, daemon=True,
                             name=f"heal-fleet-{launch}")
        actions_before = remediator.guardrails.actions_used
        t.start()
        while t.is_alive():
            for w in watchers:
                for ev in w.poll():
                    if _current(ev, started):
                        remediator.observe(ev)
            time.sleep(poll_s)
        t.join()
        # Post-mortem polls: a NaN child dies fast, but its health.json
        # survives — the rollback decision happens HERE, after the gang
        # is already gone (request_stop degrades to a no-op).
        for _ in range(drain_polls):
            for w in watchers:
                for ev in w.poll():
                    if _current(ev, started):
                        remediator.observe(ev)
        res = box[0] if box else None
        if isinstance(res, BaseException):
            raise res
        results.append(res)
        healed_now = remediator.guardrails.actions_used - actions_before
        timeline.append((obs_metrics._wall(),
                         f"result{launch}:{res.status if res else '?'}"))
        done = res is not None and res.status == "ok"
        if done or healed_now == 0 or launch >= max_heals:
            return {"results": results, "healed": launch,
                    "timeline": timeline,
                    "status": res.status if res else "unknown"}
        launch += 1
