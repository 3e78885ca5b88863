# graftlint: stdlib-only
"""The declared environment knobs of the PyTorch port.

Every named ``os.environ`` read (or write) inside
``distributedtensorflowexample_tpu_torch/`` has an entry here with a
line of documentation: ``analysis/src_lint.py``'s ``env-registry`` rule
proves it, and ``env-dead`` flags entries no code reads any more, so the
file states the real surface, no more and no less.
``python -m distributedtensorflowexample_tpu_torch.tools.graftlint --fix``
inserts ``TODO: document`` stubs for new knobs; replace them with a real
line.  Keys sorted alphabetically.
"""

from __future__ import annotations

ENV_REGISTRY: dict[str, str] = {
    "AB_CALLS": (
        "Calls of the deepest unroll a timed repeat in tools/ab_quantize.py "
        "(default 2)."),
    "AB_SMOKE": (
        "1 = tools/ab_quantize.py's wiring check (as --tiny): a 16-step "
        "unroll and no roofline probe."),
    "AB_UNROLL_EPOCHS": (
        "Epochs in one call of tools/ab_quantize.py's headline config "
        "(default 16)."),
    "BUCKET_GRADS_AUTO_BYTES": (
        "Overrides --bucket_grads auto's bucket size in bytes without a "
        "code change (parallel/bucketing.py)."),
    "CAPTURE_PIDFILE": (
        "supervise --capture's pidfile, relative to --records_dir (default "
        "capture.pid; tools/supervise.py)."),
    "CUDA_HOME": (
        "CUDA toolkit root whose bin/nvcc builds the kernels "
        "(ops/kernels/build.py; then CUDA_PATH, PATH, /usr/local/cuda)."),
    "CUDA_PATH": (
        "Fallback CUDA toolkit root when CUDA_HOME is unset "
        "(ops/kernels/build.py)."),
    "DISTTF_TPU_QUIET_SYNTHETIC": (
        "1 = suppress the synthetic-fallback warning when a real dataset "
        "is absent (data/synthetic.py)."),
    "FLEET_DRILL_DIE_IN_DISCARD": (
        "Drill seam: rank to SIGKILL mid-discard so the "
        "interrupted-agreement replay path stays tested "
        "(resilience/fleet.py)."),
    "FLEET_HOST_DOWN_FILE": (
        "Per-rank host-loss tombstone path (exported by the fleet "
        "supervisor): the host_loss fault writes it and the next spawn of "
        "that rank fails like a dead host (resilience/faults.py, "
        "resilience/fleet.py)."),
    "FLEET_RESUME_STEP": (
        "The step a fleet relaunch resumes from, exported by the fleet "
        "supervisor to each faultline rank (tools/faultline.py)."),
    "HEAL_ACTION_BUDGET": (
        "Global remediation-actions ceiling per remediator JOURNAL (WAL "
        "replay restores the spent count; a new journal resets it); "
        "exhaustion degrades to detection-only with a loud "
        "heal_budget_exhausted ledger row (resilience/remediate.py; "
        "default 8)."),
    "HEAL_CANARY_FRACTION": (
        "Share of serving requests routed to a canary candidate while it "
        "proves itself (serving/promote.py; default 0.25)."),
    "HEAL_CANARY_P99_RATIO": (
        "Canary p99 over this multiple of the baseline arm's p99 = "
        "regression, auto-rollback (serving/promote.py; default 2.0)."),
    "HEAL_CANARY_WINDOW": (
        "Canary-arm completions required before a promote/rollback "
        "verdict (serving/promote.py; default 16)."),
    "HEAL_COOLDOWN_S": (
        "Per-(kind, scope) quiet period after a remediation action — the "
        "action-storm guard (resilience/remediate.py; default 30)."),
    "HEAL_DRY_RUN": (
        "1 = remediation commissioning mode: journal heal_dry_run rows "
        "naming what WOULD fire, run no actuator "
        "(resilience/remediate.py)."),
    "HEAL_FLAP_N": (
        "Detections of one (kind, scope) inside the flap window before a "
        "remediation policy may act — a one-poll blip never reaches an "
        "actuator (resilience/remediate.py; default 2)."),
    "HEAL_FLAP_WINDOW_S": (
        "The flap-damping window in seconds (resilience/remediate.py; "
        "default 60)."),
    "HEAL_LR_DROP": (
        "1 = experimental: map loss_plateau to the LR-drop advisory stub "
        "instead of gang rollback — the actuator writes an advisory file "
        "a future trainer LR hook consumes (resilience/remediate.py)."),
    "OBS_ANOMALY_SKIP": (
        "Steps ignored at window start before the anomaly baseline arms "
        "(obs/anomaly.py; default 1 — the compile step)."),
    "OBS_ANOMALY_WARMUP": (
        "Steps used to pin the anomaly detector's step-time baseline "
        "(obs/anomaly.py; default 16)."),
    "OBS_ANOMALY_Z": (
        "EWMA z-score threshold before a step time is flagged anomalous "
        "(obs/anomaly.py; default 8.0)."),
    "OBS_DIR": (
        "Directory flight-recorder postmortems land in (obs/recorder.py; "
        "default: the system temp dir)."),
    "OBS_FLIGHT": (
        "1/true = arm the always-on flight recorder: span ring + counters "
        "+ loss tail dumped on exit/signal (obs/recorder.py)."),
    "OBS_HEALTH": (
        "Path of the health file AnomalyHook writes and the serve thread "
        "falls back to when HTTP is down (obs/anomaly.py, obs/serve.py, "
        "engine/engine.py; exported per rank by supervise_fleet)."),
    "OBS_HTTP_PORT": (
        "Port for the in-process /metrics + /health + /ledger scrape "
        "endpoint; unset/empty = no server (obs/serve.py)."),
    "OBS_LEDGER": (
        "Path of the append-only cross-run RUNS.jsonl ledger; unset/empty "
        "= no ledger (obs/ledger.py)."),
    "OBS_LEDGER_MAX_BYTES": (
        "Ledger size-rotation threshold in bytes (obs/ledger.py; default "
        "8 MiB)."),
    "OBS_LEDGER_SAMPLE_S": (
        "Minimum seconds between sampled ledger metric rows "
        "(obs/ledger.py; default 30)."),
    "OBS_PHASE": (
        "Capture-phase label stamped on obs events and ledger rows "
        "(obs/trace.py, obs/ledger.py)."),
    "OBS_PROM_DIR": (
        "Directory for textfile-collector .prom dumps refreshed per "
        "completed supervised task (resilience/supervisor.py)."),
    "OBS_RANK": (
        "Rank label of multi-process telemetry files and rows: the "
        "fleet's rank, a cluster process's id, or a spawned rank's global "
        "rank (exported by the fleet supervisor and set by "
        "engine/engine.py, serving/serve_lm.py; read by obs/*)."),
    "OBS_TRACE_FILE": (
        "Path to append per-process span events (JSONL) for the cross- "
        "rank timeline merge; unset = no trace (obs/trace.py)."),
    "SCHED_DRILL_DIE_AT": (
        "Drill seam: SIGKILL the scheduler right after it journals a "
        "matching record (substring of 'event:action:job'), so the write- "
        "ahead replay path stays tested (resilience/scheduler.py)."),
    "SCHED_QUEUE": (
        "Default queue file for tools.schedule when --queue is not passed "
        "(resilience/scheduler.py)."),
    "SCHED_SLO_PRIORITIES": (
        "Per-kind SLO priority overrides for the scheduler, "
        "'kind=int,...' (lower = more urgent; default serve=0 train=10 "
        "bench=20 drill=30; resilience/scheduler.py)."),
    "SCHED_TICK_S": (
        "Scheduler policy-loop cadence in seconds — the latency floor on "
        "every reap/evict/grow/admit decision (resilience/scheduler.py; "
        "default 0.25)."),
    "SERVE_LOAD_CLIENTS": (
        "Default closed-loop client thread count for serve_lm --drive "
        "(serving/loadgen.py; default 2)."),
    "SERVE_LOAD_REQUESTS": (
        "Default request count one serve_lm drive issues "
        "(serving/loadgen.py; default 16)."),
    "SERVE_PORT": (
        "Request-front port for the serving worker's POST /generate + GET "
        "/stats HTTP API; 0/unset = in-process only (serving/frontend.py "
        "— distinct from OBS_HTTP_PORT, the read-only telemetry scrape)."),
    "SERVE_SLOTS": (
        "Default concurrent decode slots for the serving worker "
        "(serving/engine.py; default 4)."),
    "SERVE_SLO_MS": (
        "End-to-end latency SLO in ms driving serving admission: a queued "
        "request predicted to finish past it is rejected loudly instead "
        "of admitted to miss; 0 = admit everything (serving/queue.py)."),
    "SERVE_SNAPSHOT": (
        "Default SnapshotStore directory serve_lm promotes when "
        "--snapshot is not passed (serving/promote.py)."),
    "SIM_MAX_VIRTUAL_S": (
        "Hard ceiling on total virtual seconds one sim run may advance — "
        "a livelocked scenario (eviction ping-pong, a gate that never "
        "opens) dies loudly at the cap instead of pumping the event queue "
        "forever (sim/harness.py; default 10x the scenario horizon)."),
    "SIM_TEARDOWN_S": (
        "Default request_stop -> unanimous-143 teardown latency for "
        "simulated gangs when the scenario's per-job sim knobs don't "
        "script one — stretch it to drill slow-drain eviction windows "
        "(sim/fleet.py; default 1.0)."),
    "SNAPSHOT_DIR": (
        "Shard-redundant snapshot directory the engine wires a "
        "ShardSnapshotHook and elastic restore into when the update "
        "layout is a row layout (engine/engine.py; unset = checkpoints "
        "only)."),
    "SNAPSHOT_IO_BACKOFF_S": (
        "First retry backoff for a failed shard-payload write, doubling "
        "per retry (resilience/shardstore.py; default 0.05)."),
    "SNAPSHOT_IO_RETRIES": (
        "Bounded retries per shard-payload write before the save raises "
        "(resilience/shardstore.py; default 2)."),
    "SNAPSHOT_REDUNDANCY": (
        "Copies of every shard in a shard-redundant snapshot set: 1 own + "
        "R-1 ring mirrors, so any R-1 shard losses reconstruct and R "
        "refuse loudly (resilience/shardstore.py, mirrored by the sim's "
        "snapshot_loss world model in sim/fleet.py; default 2)."),
    "SUPERVISE_ATTEMPT": (
        "Attempt number of the supervised child, exported by the "
        "supervisor so obs rows carry retry provenance (obs/*)."),
    "SUPERVISE_HEARTBEAT": (
        "Heartbeat file path a supervised child touches at call "
        "boundaries; the watchdog kills on staleness. Under the N x M "
        "layout only each launcher's first rank touches it "
        "(engine/engine.py, training/hooks.py, resilience/faults.py, "
        "serving/serve_lm.py)."),
    "SUPERVISE_HEARTBEAT_TIMEOUT_S": (
        "The watchdog's staleness edge in seconds, exported to children "
        "so the heartbeat_flap drill can aim at it "
        "(resilience/faults.py)."),
    "SUPERVISE_JOURNAL": (
        "The supervisor's journal path, exported to the child so "
        "faultline can record its attempts beside it "
        "(tools/faultline.py); supervise --capture's journal, relative to "
        "--records_dir (tools/supervise.py)."),
    "TF_CONFIG": (
        "Reference-compatible cluster topology JSON: the process count, "
        "this process's index and the coordinator (cluster.py)."),
}
