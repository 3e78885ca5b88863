"""The port's command-line tools (the JAX package's ``tools/`` scripts of
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
  lost) per fault class;
- ``sim_run``, ``obs_query``, ``obs_report`` — the fleet simulator and
  the ledger's and flights' readers;
- ``graftlint`` — the repo-invariant source rules and the collective
  contracts (``analysis/``);
- ``bench_collectives`` — ``t(S) = alpha + S/beta`` fitted per
  collective kind and group size through ``parallel/mesh.Mesh``, the
  record ``resilience/scheduler.load_collective_fit`` reads;
- ``bench_input`` — the native host loader against numpy, four stages,
  bit-identical before timed;
- ``ab_augment`` — the input path alone on the card (resident gather,
  crop and flip, dequant) in its variants, bitwise before timed;
- ``bench_ratchet`` — the records' comparator and trajectory
  (``obs_query trajectory``, ``schedule --trajectory``).
"""
