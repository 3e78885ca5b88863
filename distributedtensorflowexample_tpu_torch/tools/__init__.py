"""The port's command-line tools (the JAX package's ``tools/`` scripts of
the same names), each run as ``python -m
distributedtensorflowexample_tpu_torch.tools.<name>``:

- ``faultline`` — one small training loop with a fault plan wired in,
  speaking the supervisor's exit-code protocol;
- ``supervise`` — any command under the heartbeat watchdog and bounded
  retries (``resilience/supervisor.py``), or with ``--capture
  --records_dir D`` the journaled capture queue over the harnesses below:
  the headline, the ResNet-20 profile, the collectives, the LM bench, the
  full bench and the CLI trainer, every artifact under ``D``;
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
  (``obs_query trajectory``, ``schedule --trajectory``);
- ``bench_serving`` — the serving bench: the supervised ``serve_lm``
  headline, the saturation and SLO curves, the sharded, speculative and
  batched-prefill points, in a ``SERVE_*`` record (``--device cpu`` on
  the host; the card by default; ``tests/test_torch_bench_serving.py``);
- ``bench`` — the headline harness: one line per training workload,
  config 3's steps/sec/chip last, with its roofline probe, dequant A/B,
  MFU and each line's kernel launches (``tests/test_torch_bench.py``);
- ``bench_scaling`` — weak-scaling efficiency over 1 -> N ranks, the
  collective bytes a step counted through ``parallel/mesh.Mesh``
  (``tests/test_torch_bench_scaling.py``);
- ``bench_lm`` — the LM's tokens/s and MFU, and the knob A/B matrix
  (remat, shard_update, bucket, ZeRO-1, ZeRO-3 with and without overlap)
  over N ranks: bytes a rank, saved-for-backward bytes, collectives
  (``tests/test_torch_bench_lm.py``);
- ``bench_profile`` — ResNet-20's rate with and without augment against
  its roofline probe, the shares, a ``torch.profiler`` window
  (``tests/test_torch_bench_profile.py``);
- ``ab_quantize`` — the headline config over each resident storage of
  its split (float32, uint8 with each dequant, the CUDA dequant), bitwise
  before timed (``tests/test_torch_ab_quantize.py``).
"""
