"""The serve-traffic world model: piecewise-constant offered load
(stepped by ``serve_load`` scenario events) against a replica count
the autoscale actuator moves.

This is the sim's stand-in for ``serving/``'s admission telemetry: the
:class:`~distributedtensorflowexample_tpu_torch.resilience.remediate.
AutoscaleWatcher` polls :meth:`stats`, and
``make_autoscale_actuator`` calls :meth:`set_replicas` — both the REAL
policy objects, wired to simulated physics.  The model also keeps the
books the policy is judged on: seconds spent offered-above-capacity
(SLO breach exposure) and replica-seconds (the capacity bill), sampled
at every load/replica transition so the integral is exact, not
polled."""

from __future__ import annotations


class TrafficModel:
    def __init__(self, clock, *, replicas: int,
                 knee_per_replica: float):
        self.clock = clock
        self.knee = float(knee_per_replica)
        self._replicas = int(replicas)
        self._offered = 0.0
        self._last_t = 0.0
        self.breach_s = 0.0          # seconds with offered > capacity
        self.replica_s = 0.0         # integral of replicas over time
        #: (virtual_ts, offered_per_s, replicas) at every transition —
        #: the Perfetto timeline's serve track.
        self.timeline: list[tuple] = []
        self._mark()

    def _accrue(self) -> None:
        now = self.clock.now()
        dt = max(0.0, now - self._last_t)
        if self._offered > self._replicas * self.knee:
            self.breach_s += dt
        self.replica_s += dt * self._replicas
        self._last_t = now

    def _mark(self) -> None:
        self.timeline.append(
            (self.clock.now(), self._offered, self._replicas))

    # --- the world side (scenario events) ------------------------------

    def set_offered(self, offered_per_s: float) -> None:
        self._accrue()
        self._offered = float(offered_per_s)
        self._mark()

    # --- the policy side (watcher + actuator) --------------------------

    def stats(self) -> dict:
        return {"offered_per_s": self._offered,
                "replicas": self._replicas}

    def get_replicas(self) -> int:
        return self._replicas

    def set_replicas(self, n: int) -> None:
        self._accrue()
        self._replicas = int(n)
        self._mark()

    # --- the books -----------------------------------------------------

    def finalize(self) -> dict:
        """Close the integrals at the current virtual time."""
        self._accrue()
        self._mark()
        return {"breach_s": round(self.breach_s, 6),
                "replica_s": round(self.replica_s, 6),
                "final_replicas": self._replicas,
                "final_offered_per_s": self._offered}
