"""The port's resilience drivers (the JAX package's ``tools/`` scripts of
the same names), each run as ``python -m
distributedtensorflowexample_tpu_torch.tools.<name>``:

- ``faultline`` — one small training loop with a fault plan wired in,
  speaking the supervisor's exit-code protocol;
- ``supervise`` — any command under the heartbeat watchdog and bounded
  retries (``resilience/supervisor.py``);
- ``supervise_fleet`` — an N-rank gang under the fleet supervisor
  (``resilience/fleet.py``), self-healing with ``--heal``
  (``resilience/remediate.py``);
- ``schedule`` — a journaled queue of jobs over gang slots
  (``resilience/scheduler.py``);
- ``heal_drill`` — measured self-healing drills (MTTD, MTTR, steps
  lost) per fault class.
"""
