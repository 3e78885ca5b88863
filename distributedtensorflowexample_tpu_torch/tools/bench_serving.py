"""bench_serving — the serving-path bench family: closed-loop
throughput, p50/p99 latency, and the throughput-vs-SLO curve (the JAX
package's root ``bench_serving.py``, over the port's ``serving/``).

  # on the card (the default device), a demo-initialized snapshot:
  python -m distributedtensorflowexample_tpu_torch.tools.bench_serving \\
      --size lm_base --slots 8 --max_len 128 \\
      --json /tmp/records/SERVE_lm_gpu_r18.json
  # on the CPU, at lm_tiny:
  python -m distributedtensorflowexample_tpu_torch.tools.bench_serving \\
      --device cpu --requests 16 --json /tmp/records/SERVE_lm_cpu_r18.json

Six instruments over one engine family, with the JAX harness's metric
names and record layout:

1. **Supervised headline**: ``serving/serve_lm --drive N --stats`` as a
   child of ``resilience/supervisor.Supervisor`` (heartbeat watchdog
   armed, 180 s), the snapshot promoted through the SnapshotStore's
   validity path; its stats supply ``serve_<size>_supervised_tokens_per_
   sec`` and p50/p99.  The worker's wall includes its cold start (torch
   import, CUDA initialisation, promotion).
2. **Saturation sweep**: closed-loop clients over ``--clients_sweep``
   against one in-process ``DecodeEngine``; the headline point (the last
   client count, SLO off) gives ``serve_<size>_tokens_per_sec`` and
   ``serve_<size>_p99_ms``.
3. **SLO sweep**: at saturating load, ``--slo_sweep_ms`` through the
   admission knob; ``serve_<size>_throughput_vs_slo`` is the best in-SLO
   goodput over the constrained points, its ``spread_frac`` from repeats
   of that point.
4. **Params-stay-sharded point**: ``serve_lm --sharded_mesh D`` (rows at
   1/D a rank) driven closed-loop, ``serve_<size>_sharded_tokens_per_sec``
   and ``_sharded_params_frac_per_device``; and the lm_base/D=4
   residency, ``serve_lm_base_sharded_params_frac_per_device``.
5. **Speculative draft-k sweep**: a self-draft against the same workload
   decoded plain-greedy, ``serve_<size>_spec_tokens_per_sec``,
   ``_spec_accept_len`` and the must-be-zero ``_spec_mismatch``.
6. **Batched-prefill amortization**: one ``prefill_many`` call over a
   same-bucket burst against the same prompts prefilled solo,
   ``serve_<size>_prefill_batch_amortization``.

Output: one JSON line per metric on stdout (``spread_frac`` from the
repeats); ``--json`` writes them and a ``serving_bench_meta`` line, the
record ``tools.bench_ratchet`` reads (``SERVE_*.json``).

Where the port differs from the JAX harness, on purpose:

- (a) **A failed instrument fails the run.**  The record is still
  written, with each failed instrument's error under the meta line's
  ``errors``, and the tool then exits 1 naming the instruments.  An
  indivisible ``--sharded_mesh`` (or a negative one) is refused by name,
  exit 2, before anything is measured.
- (b) **The sharded point runs as ranks.**  The port's
  ``ShardedDecodeEngine`` runs one process per rank (rank 0 batches, the
  others follow), so instrument 4 runs ``serve_lm --sharded_mesh D
  --drive N --stats`` as a subprocess once per repeat and reads tokens/s,
  p50/p99, the residency and each rank's kernel launches from its stats.
  Each repeat is a fresh worker, so its first prefill and decode step
  fall inside its span.  The default D is 2 (on one card: two gloo ranks
  sharing it); D = 1 is ``serve_lm``'s in-process one-rank mesh; 0 skips
  the instrument.  The lm_base/D=4 residency runs in four ranks through
  ``parallel/launch.spawn`` and reads ``params_residency`` with no
  decode.  ``--host_devices`` is not carried over: the port's ranks are
  processes, not forced host devices.
- (c) **The ``*_mismatch`` column stays meaningful on the card.**  On the
  CPU the speculative output is bitwise greedy, and every request whose
  tokens differ counts.  On the card the verify step's (k+1)-row products
  are not the decode step's 1-row products, so a request counts where its
  tokens first differ at a position whose greedy top-2 logit gap exceeds
  :data:`SERVE_TAU` (``chip_smoke.py``'s tolerance); the raw count of
  differing requests stands beside it in ``detail.mismatch_raw``.
- (d) **Every line carries ``detail.device``**
  (``tools.bench_ratchet.describe_device``), so the ratchet keys a card's
  record as ``gpu:<name>``.
- (e) **No record at the repository's root**: ``--json`` writes where the
  caller says, and nothing else is written outside ``--workdir``.

``--real`` becomes ``--device {cuda,cpu}``: the tool runs on the card
unless ``--device cpu`` is given; with no card it raises
``DeviceUnavailable`` and never falls back to the CPU.  ``--sharded_requests``
is new: the sharded point's drive size (default: ``--requests``), since
two gloo ranks on one card decode two orders of magnitude slower than
the replicated engine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback

#: The top-2 logit gap at or below which a speculative token may differ
#: from plain greedy on the card (``chip_smoke.SERVE_TAU``).
SERVE_TAU = 0.25

_SERVE_LM = "distributedtensorflowexample_tpu_torch.serving.serve_lm"


def _emit(metric: str, value: float, unit: str, detail: dict,
          lines: list) -> None:
    rec = {"metric": metric, "value": round(float(value), 6),
           "unit": unit, "vs_baseline": 1.0, "detail": detail}
    print(json.dumps(rec), flush=True)
    lines.append(rec)


def _run_point(engine, *, requests: int, clients: int, max_new: int,
               slo_ms: float, seed: int) -> dict:
    """One closed-loop operating point against a fresh queue/batcher
    (the engine and its warm shapes are shared across points)."""
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        ClosedLoopLoadGen)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)

    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=slo_ms)
    gen = ClosedLoopLoadGen(queue, total=requests, clients=clients,
                            max_new=max_new, vocab=engine.vocab,
                            seed=seed)
    done = threading.Event()
    box: dict = {}

    def _drive():
        # Rejected ids re-queue under a tight SLO; the load generator
        # gives each id up after a few attempts, which bounds the point.
        box.update(gen.run())
        done.set()

    t = threading.Thread(target=_drive, daemon=True)
    steps0 = engine.decode_steps          # engine is shared across points
    t0 = time.monotonic()
    t.start()
    batcher.run(should_stop=done.is_set)
    t.join(timeout=10)
    wall = time.monotonic() - t0
    stats = batcher.stats()
    stats["decode_steps"] = engine.decode_steps - steps0
    goodput = (stats["tokens"] / wall) if wall > 0 else 0.0
    return {"clients": clients, "slo_ms": slo_ms,
            "requests": requests, "completed": stats["completed"],
            "rejected_slo": stats["rejected"]["slo"],
            "tokens": stats["tokens"], "wall_s": round(wall, 3),
            "goodput_tokens_per_sec": round(goodput, 3),
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "decode_steps": stats["decode_steps"],
            "step_ewma_ms": stats["step_ewma_ms"]}


def _oracle_run(engine, prompts, *, spec=None, repeats=3) -> tuple:
    """Decode ``prompts`` to completion through a fresh batcher
    (optionally speculative): submit-all-then-step keeps the workload
    IDENTICAL across configurations, so the returned token map diffs
    against another configuration's (the ``*_mismatch`` column).
    Returns ``(tokens_by_rid, [tokens/sec per repeat])`` — repeat 0 pays
    the cold shapes and is dropped by callers."""
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)
    toks_by_rid: dict = {}
    rates: list = []
    for _ in range(max(1, repeats)):
        queue = RequestQueue(engine.vocab)
        b = ContinuousBatcher(engine, queue, slo_ms=0.0, spec=spec)
        reqs = [queue.submit(p, m, rid=f"o{i}")
                for i, (p, m) in enumerate(prompts)]
        t0 = time.monotonic()
        while any(not r.done.is_set() for r in reqs):
            b.step()
        wall = time.monotonic() - t0
        prev, toks_by_rid = toks_by_rid, {r.rid: list(r.tokens)
                                          for r in reqs}
        if prev and prev != toks_by_rid:
            raise AssertionError(
                "oracle workload not deterministic across repeats")
        total = sum(len(r.tokens) for r in reqs)
        rates.append(round(total / wall, 3) if wall > 0 else 0.0)
    return toks_by_rid, rates


def _greedy_gap(engine, prompt, greedy: list, j: int) -> float:
    """Top-2 logit gap of plain greedy decode at token ``j`` of a request
    (``greedy`` its greedy tokens), replayed solo in slot 0 of the idle
    ``engine``: every step has the batched step's shape, so the logits
    are the ones the batched greedy run chose from."""
    import numpy as np
    (_, logits), = engine.prefill_many(
        [(0, prompt, len(greedy))]).values()
    for i in range(1, j + 1):
        engine.set_slot(0, greedy[i - 1], int(engine.positions[0]))
        logits = engine.decode_logits(busy=[0])[0]
    engine.set_slot(0, 0, 0)
    top2 = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top2[1] - top2[0])


def _mismatches(engine, prompts, greedy: dict, spec: dict,
                tau: float | None) -> tuple:
    """(requests counted as mismatched, requests whose tokens differ at
    all, each difference's rid, first differing position and the greedy
    top-2 gap there).  With ``tau`` None every difference counts; else
    only one whose gap exceeds ``tau``."""
    counted, raw, where = 0, 0, []
    for i, (prompt, _) in enumerate(prompts):
        rid = f"o{i}"
        want, got = greedy[rid], spec[rid]
        if got == want:
            continue
        raw += 1
        j = next((p for p, (a, b) in enumerate(zip(want, got)) if a != b),
                 min(len(want), len(got)))
        gap = _greedy_gap(engine, prompt, want, j) if j < len(want) \
            else None
        counted += tau is None or gap is None or gap > tau
        where.append({"rid": rid, "position": j,
                      "gap": None if gap is None else round(gap, 6)})
    return counted, raw, where


def _serve_lm_argv(args, snapshot: str, requests: int, seed: int,
                   stats_path: str, *extra) -> list:
    """A ``serve_lm`` child's command line: ``requests`` driven by the
    last ``--clients_sweep`` count, stats to ``stats_path`` (removed
    first: a repeat never reads a previous one's)."""
    if os.path.exists(stats_path):
        os.remove(stats_path)
    return [sys.executable, "-m", _SERVE_LM, "--device", args.device,
            "--snapshot", snapshot, "--size", args.size,
            "--slots", str(args.slots), "--max_len", str(args.max_len),
            "--drive", str(requests),
            "--clients", str(args.clients_sweep[-1]),
            "--drive_max_new", str(args.max_new), "--seed", str(seed),
            "--stats", stats_path, *extra]


def _supervised_headline(args, snapshot: str, workdir: str) -> dict:
    """The end-to-end point: serve_lm under the Supervisor, heartbeat
    armed, driven by its own closed loop; returns its stats JSON plus
    the supervision verdict."""
    from distributedtensorflowexample_tpu_torch.resilience.supervisor import (
        Supervisor)
    stats_path = os.path.join(workdir, "serve_stats.json")
    hb_path = os.path.join(workdir, "serve.beat")
    argv = _serve_lm_argv(args, snapshot, args.requests, args.seed,
                          stats_path)
    res = Supervisor(heartbeat_timeout_s=180.0).run(
        argv, name="bench_serving_headline",
        stdout_path=os.path.join(workdir, "serve.out"),
        stderr_path=os.path.join(workdir, "serve.err"),
        heartbeat_path=hb_path)
    out = {"supervision": {"status": res.status, "rc": res.returncode,
                           "attempts": res.attempts}}
    try:
        with open(stats_path) as f:
            out["stats"] = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        out["error"] = f"no stats from supervised worker: {e!r}"
    return out


def _sharded_drive(args, snapshot: str, D: int, requests: int,
                   seed: int, tag: str) -> dict:
    """``serve_lm --sharded_mesh D --drive requests --stats`` in a process
    of its own (which starts the D ranks); its stats, or an error naming
    its exit code and the end of its stderr."""
    stats_path = os.path.join(args.workdir, f"sharded_{tag}.json")
    err_path = os.path.join(args.workdir, f"sharded_{tag}.err")
    argv = _serve_lm_argv(args, snapshot, requests, seed, stats_path,
                          "--sharded_mesh", str(D))
    with open(os.path.join(args.workdir, f"sharded_{tag}.out"), "w") as out, \
            open(err_path, "w") as err:
        rc = subprocess.run(argv, stdout=out, stderr=err).returncode
    if rc != 0:
        with open(err_path) as f:
            tail = f.read()[-2000:]
        raise RuntimeError(f"serve_lm --sharded_mesh {D} exited {rc}: "
                           f"{tail}")
    with open(stats_path) as f:
        return json.load(f)


def _residency_rank(device: str, max_len: int, seed: int) -> dict:
    """One rank of the lm_base/D=4 residency instrument
    (``parallel/launch.spawn``'s child): lm_base's parameters cut into
    this rank's rows at the JAX instrument's 8 MiB buckets
    (``serving/promote.shard_model``), the sharded engine built over them
    (4 slots), its ``params_residency`` read; no decode runs."""
    import torch

    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        shard_model)
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        ShardedDecodeEngine)
    kernels.reset_launch_counts()
    mesh = make_mesh(device)
    torch.manual_seed(seed)
    model = build_model("lm_base", max_len=max_len)
    rows, layout = shard_model(model, mesh=mesh, bucket_bytes=8 << 20)
    engine = ShardedDecodeEngine(model, rows, layout, mesh=mesh, slots=4,
                                 cache_len=max_len)
    return {"rank": mesh.rank, "residency": engine.params_residency(),
            "launches": kernels.launch_counts()}


def _lm_base_residency(device: str, max_len: int, seed: int) -> list:
    """The four ranks of the lm_base/D=4 instrument: NCCL with a card a
    rank, else gloo (on one card, four ranks share it)."""
    import torch

    from distributedtensorflowexample_tpu_torch.parallel.launch import spawn
    # By the module's import name: run with ``-m``, this module is
    # ``__main__``, which a spawned rank cannot import by that name.
    from distributedtensorflowexample_tpu_torch.tools import bench_serving
    backend = ("nccl" if device == "cuda" and torch.cuda.device_count() >= 4
               else "gloo")
    return spawn(bench_serving._residency_rank, 4, backend,
                 args=(device, max_len, seed))


def _refusal(args) -> str | None:
    """Why these flags can only fail, or None: checked before anything is
    measured."""
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        check_slots)
    if not args.clients_sweep:
        return "--clients_sweep is empty: the headline point needs a " \
               "client count"
    if args.sharded_mesh < 0:
        return (f"--sharded_mesh {args.sharded_mesh}: a mesh has at least "
                f"one rank — shard over D >= 1 ranks, or pass 0 to skip "
                f"the sharded point")
    if args.sharded_mesh:
        try:
            check_slots(args.slots, args.sharded_mesh)
        except ModeRefusal as e:
            return str(e)
    return None


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", default="lm_tiny",
                   help="LM size to serve (LM_SIZES)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to serve (cuda: the card; cpu: the plain "
                        "versions on the host)")
    p.add_argument("--snapshot", default="",
                   help="snapshot dir (default: <workdir>/snaps, "
                        "demo-initialized if empty)")
    p.add_argument("--workdir", default="/tmp/bench_serving")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--requests", type=int, default=0,
                   help="requests per operating point (default "
                        "$SERVE_LOAD_REQUESTS*8 or 128)")
    p.add_argument("--sharded_requests", type=int, default=0,
                   help="requests per sharded repeat (default: "
                        "--requests)")
    p.add_argument("--max_new", type=int, default=8)
    p.add_argument("--clients_sweep", default="1,2,4,8")
    p.add_argument("--slo_sweep_ms", default="0,25,50,100")
    p.add_argument("--repeats", type=int, default=3,
                   help="headline-point repeats (spread_frac source)")
    p.add_argument("--supervised_repeats", type=int, default=2,
                   help="supervised end-to-end repeats (its wall "
                        "includes worker cold-start, so its own "
                        "spread_frac matters)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded_mesh", type=int, default=2,
                   help="ranks D of the params-stay-sharded point (1 = "
                        "serve_lm's in-process one-rank mesh; 0 = skip "
                        "it and the lm_base/D=4 residency)")
    p.add_argument("--spec_k_sweep", default="2,4",
                   help="draft window sizes for the speculative sweep "
                        "(empty = skip)")
    p.add_argument("--skip_supervised", action="store_true",
                   help="skip the supervised end-to-end headline "
                        "(in-process sweeps only)")
    p.add_argument("--json", default="",
                   help="write the SERVE_lm_* record here")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    args.clients_sweep = [int(x) for x in
                          args.clients_sweep.split(",") if x]
    args.slo_sweep_ms = [float(x) for x in
                         args.slo_sweep_ms.split(",") if x]
    args.spec_k_sweep = [int(x) for x in
                         args.spec_k_sweep.split(",") if x]
    why = _refusal(args)
    if why is not None:
        print(f"bench_serving: refused: {why}", file=sys.stderr, flush=True)
        return 2

    from distributedtensorflowexample_tpu_torch.device import resolve_device
    device = resolve_device(args.device)      # no card: DeviceUnavailable

    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import (
        recorder as obs_recorder)
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.obs.anomaly import (
        spread_fraction)
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
        SnapshotStore)
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        load_requests_default)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        init_lm_snapshot, promote)
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)

    obs_recorder.maybe_install()
    obs_ledger.maybe_begin("bench_serving", config=vars(args))
    obs_serve.maybe_start()
    kernels.reset_launch_counts()
    os.makedirs(args.workdir, exist_ok=True)
    snapshot = args.snapshot or os.path.join(args.workdir, "snaps")
    # Resolve the default BEFORE the supervised section reads
    # args.requests — `--drive 0` tells the worker to serve forever,
    # which turns the headline into a heartbeat-fed hang.
    requests = args.requests = (
        args.requests or max(128, load_requests_default() * 8))
    sharded_requests = args.sharded_requests or requests
    platform = "gpu" if device.type == "cuda" else "cpu"
    size = args.size
    lines: list = []
    errors: dict = {}

    if SnapshotStore(snapshot).latest_valid() is None:
        init_lm_snapshot(snapshot, size, seed=args.seed)

    shared = {"platform": platform, "size": size, "slots": args.slots,
              "max_len": args.max_len, "max_new": args.max_new,
              "requests": requests, "device": describe_device(args.device)}

    # 1. supervised end-to-end headline -----------------------------------
    if not args.skip_supervised:
        try:
            sup_runs = [
                _supervised_headline(args, snapshot, args.workdir)
                for _ in range(max(1, args.supervised_repeats))]
            rates = [(s.get("stats") or {}).get("tokens_per_sec") or 0.0
                     for s in sup_runs]
            best_i = max(range(len(rates)), key=lambda i: rates[i])
            sup, st = sup_runs[best_i], sup_runs[best_i].get("stats")
            if st and st.get("tokens_per_sec"):
                _emit(f"serve_{size}_supervised_tokens_per_sec",
                      st["tokens_per_sec"], "tokens/sec",
                      {**shared, "supervised": True,
                       "clients": args.clients_sweep[-1],
                       "repeats": rates,
                       "spread_frac": round(spread_fraction(rates), 4),
                       "p50_ms": st.get("p50_ms"),
                       "p99_ms": st.get("p99_ms"),
                       "completed": st.get("completed"),
                       "snapshot_step": st.get("snapshot_step"),
                       "snapshot_layout": st.get("snapshot_layout"),
                       "supervision": sup.get("supervision"),
                       "launches": st.get("launches"),
                       "note": "serving/serve_lm under the resilience "
                               "Supervisor (heartbeat armed), driven by "
                               "its in-process closed loop — process "
                               "boundary + promotion + continuous "
                               "batching all on the measured path; the "
                               "worker's wall includes its cold start "
                               "(torch import, CUDA initialisation, "
                               "promotion), so this is the relaunch-"
                               "cost-inclusive number"},
                      lines)
            else:
                errors["supervised"] = sup.get("error") or "no rate"
        except Exception as e:
            errors["supervised"] = repr(e)
            traceback.print_exc()

    # 2 + 3. in-process sweeps (one engine, warm shapes) ------------------
    pm = engine = None
    try:
        pm = promote(snapshot, size, device=device)
        engine = DecodeEngine(pm.model, slots=args.slots,
                              cache_len=args.max_len)
        # Warm: every prefill bucket's and the decode step's first call
        # (the card's lazy kernel loading) out of the tape.
        _run_point(engine, requests=max(8, 2 * args.slots),
                   clients=2, max_new=args.max_new, slo_ms=0.0,
                   seed=args.seed + 999)

        sat_clients = args.clients_sweep[-1]
        reps = []
        rep_points = []
        for r in range(max(1, args.repeats)):
            pt = _run_point(engine, requests=requests,
                            clients=sat_clients, max_new=args.max_new,
                            slo_ms=0.0, seed=args.seed)
            reps.append(pt["goodput_tokens_per_sec"])
            rep_points.append(pt)
        best = max(range(len(reps)), key=lambda i: reps[i])
        headline = rep_points[best]
        spread = round(spread_fraction(reps), 4)
        _emit(f"serve_{size}_tokens_per_sec", reps[best], "tokens/sec",
              {**shared, "clients": sat_clients, "repeats": reps,
               "spread_frac": spread, "p50_ms": headline["p50_ms"],
               "p99_ms": headline["p99_ms"],
               "decode_steps": headline["decode_steps"],
               "step_ewma_ms": headline["step_ewma_ms"],
               "snapshot_step": pm.step,
               "snapshot_layout": pm.layout}, lines)
        _emit(f"serve_{size}_p99_ms", headline["p99_ms"], "ms",
              {**shared, "clients": sat_clients, "spread_frac": spread,
               "p50_ms": headline["p50_ms"],
               "repeats_p99_ms": [p["p99_ms"] for p in rep_points]},
              lines)

        curve_clients = [
            _run_point(engine, requests=requests, clients=c,
                       max_new=args.max_new, slo_ms=0.0,
                       seed=args.seed + 1 + c)
            for c in args.clients_sweep]
        curve_slo = [
            _run_point(engine, requests=requests, clients=sat_clients,
                       max_new=args.max_new, slo_ms=s,
                       seed=args.seed + 101 + int(s))
            for s in args.slo_sweep_ms]
        # The curve row's VALUE is a measured scalar — the best in-SLO
        # goodput across the constrained sweep points — never the
        # sweep's point count (a config choice the ratchet would then
        # gate on: changing --slo_sweep_ms must not read as a perf
        # regression).  Its spread_frac comes from REPEATS OF THAT
        # POINT, not from the unconstrained headline's repeats — a
        # record must not report another metric's noise as its own.
        constrained = [p for p in curve_slo if p["slo_ms"] > 0] \
            or curve_slo
        best_pt = max(constrained,
                      key=lambda p: p["goodput_tokens_per_sec"])
        slo_reps = [best_pt["goodput_tokens_per_sec"]] + [
            _run_point(engine, requests=requests, clients=sat_clients,
                       max_new=args.max_new, slo_ms=best_pt["slo_ms"],
                       seed=args.seed + 201 + r
                       )["goodput_tokens_per_sec"]
            for r in range(max(0, args.repeats - 1))]
        _emit(f"serve_{size}_throughput_vs_slo",
              max(slo_reps), "tokens/sec (best in-SLO goodput)",
              {**shared,
               "spread_frac": round(spread_fraction(slo_reps), 4),
               "repeats": slo_reps,
               "best_point_slo_ms": best_pt["slo_ms"],
               "saturation_sweep": curve_clients,
               "slo_sweep": curve_slo,
               "note": "closed-loop curves: saturation_sweep varies "
                       "clients at SLO off; slo_sweep varies the "
                       "admission SLO at saturating load — in-SLO "
                       "goodput vs rejection rate is the serving "
                       "capacity trade"}, lines)
    except Exception as e:
        errors["sweep"] = repr(e)
        traceback.print_exc()

    # 4. params-stay-sharded point ----------------------------------------
    if args.sharded_mesh:
        # The lm_base/D=4 line first: at --size lm_base both residency
        # lines carry one name, and the ratchet compares the last line of
        # a name with the best before it, so the sharded point's own line
        # (1/D) must be the last.
        try:
            # lm_base/D=4: the training-side residency claim re-measured
            # on the SERVING engine's rows — read from the engine each
            # rank builds, with no decode of the 57M-parameter rung.
            ranks = _lm_base_residency(args.device, args.max_len,
                                       args.seed)
            bres = ranks[0]["residency"]
            _emit("serve_lm_base_sharded_params_frac_per_device",
                  bres["frac_per_device"], "fraction",
                  {"platform": platform, "size": "lm_base",
                   "mesh_size": 4, **bres, "expected": 0.25,
                   "device": shared["device"],
                   "residency_by_rank": [r["residency"] for r in ranks],
                   "launches_by_rank": [r["launches"] for r in ranks],
                   "note": "residency of the 57M-parameter rung at D=4, "
                           "four ranks through parallel/launch.spawn: "
                           "bytes of a rank's rows vs the rows' total "
                           "over the group, summed over buckets"},
                  lines)
        except Exception as e:
            errors["sharded_lm_base"] = repr(e)
            traceback.print_exc()

        try:
            D = args.sharded_mesh
            sh_stats = [
                _sharded_drive(args, snapshot, D, sharded_requests,
                               args.seed + 31 + r, str(r))
                for r in range(max(1, args.repeats))]
            sh_reps = [s.get("tokens_per_sec") or 0.0 for s in sh_stats]
            sb = max(range(len(sh_reps)), key=lambda i: sh_reps[i])
            st = sh_stats[sb]
            res = st["params_residency"]
            _emit(f"serve_{size}_sharded_tokens_per_sec", sh_reps[sb],
                  "tokens/sec",
                  {**shared, "requests": sharded_requests,
                   "mesh_size": D, "repeats": sh_reps,
                   "spread_frac": round(spread_fraction(sh_reps), 4),
                   "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                   "residency": res,
                   "snapshot_layout": st["snapshot_layout"],
                   "launches_by_rank": st.get("launches_by_rank"),
                   "note": "params resident at 1/D (zero3 bucket rows), "
                           "one all-gather per bucket inside each decode "
                           "step (serving/sharded.py "
                           "SHARDED_DECODE_CONTRACT), D ranks of "
                           "serve_lm --sharded_mesh, a fresh worker "
                           "each repeat; ranks sharing one card go "
                           "through gloo, host-staged"}, lines)
            _emit(f"serve_{size}_sharded_params_frac_per_device",
                  res["frac_per_device"], "fraction",
                  {**shared, "requests": sharded_requests,
                   "mesh_size": D, **res, "expected": 1.0 / D}, lines)
        except Exception as e:
            errors["sharded"] = repr(e)
            traceback.print_exc()
    # 5. speculative draft-k sweep ----------------------------------------
    try:
        if engine is not None and args.spec_k_sweep:
            import numpy as np
            from distributedtensorflowexample_tpu_torch.serving.spec import (
                SpecDecoder)
            rng = np.random.default_rng(args.seed + 7)
            n_req = max(16, 4 * args.slots)
            prompts = [(rng.integers(1, engine.vocab, size=int(
                rng.integers(4, 13))).astype(np.int32), args.max_new)
                for _ in range(n_req)]
            greedy_toks, greedy_rates = _oracle_run(engine, prompts)
            greedy_tps = max(greedy_rates[1:] or greedy_rates)
            draft = DecodeEngine(pm.model, slots=args.slots,
                                 cache_len=args.max_len)
            tau = SERVE_TAU if platform == "gpu" else None
            sweep: list = []
            mismatch_total = raw_total = 0
            for k in args.spec_k_sweep:
                spec = SpecDecoder(engine, draft, k=k)
                spec_toks, spec_rates = _oracle_run(engine, prompts,
                                                    spec=spec)
                tps = max(spec_rates[1:] or spec_rates)
                mism, raw, where = _mismatches(engine, prompts,
                                               greedy_toks, spec_toks, tau)
                mismatch_total += mism
                raw_total += raw
                st = spec.stats()
                sweep.append({
                    "k": k, "tokens_per_sec": tps,
                    "repeats": spec_rates,
                    "spread_frac": round(
                        spread_fraction(spec_rates[1:] or spec_rates), 4),
                    "accept_len_mean": st["accept_len_mean"],
                    "rounds": st["rounds"], "mismatch": mism,
                    "mismatch_raw": raw, "differences": where,
                    "uplift_vs_greedy": (round(tps / greedy_tps, 4)
                                         if greedy_tps else None)})
            best = max(sweep, key=lambda s: s["tokens_per_sec"])
            _emit(f"serve_{size}_spec_tokens_per_sec",
                  best["tokens_per_sec"], "tokens/sec",
                  {**shared, "k": best["k"], "requests": n_req,
                   "spread_frac": best["spread_frac"],
                   "greedy_tokens_per_sec": greedy_tps,
                   "greedy_repeats": greedy_rates,
                   "uplift_vs_greedy": best["uplift_vs_greedy"],
                   "draft": f"{size} (self-draft)", "k_sweep": sweep,
                   "note": "self-draft (same snapshot) = full "
                           "acceptance where the verify window agrees "
                           "with decode, the machinery's upper bound: "
                           "the draft steps cost target price, so the "
                           "uplift measures the batched verify's "
                           "amortization, not a ladder draft"}, lines)
            _emit(f"serve_{size}_spec_accept_len",
                  best["accept_len_mean"] or 0.0, "tokens/round",
                  {**shared, "k": best["k"], "k_sweep": sweep,
                   "note": "mean tokens emitted per slot-round "
                           "(accepted draft prefix + the verify step's "
                           "own token); k+1 = full acceptance"}, lines)
            _emit(f"serve_{size}_spec_mismatch", float(mismatch_total),
                  "requests",
                  {**shared, "requests_per_k": n_req, "k_sweep": sweep,
                   "mismatch_raw": raw_total, "tau": tau,
                   "note": "speculative output vs plain greedy on the "
                           "identical workload — the ratchet's "
                           "must-be-zero family (*_mismatch): on the CPU "
                           "every differing request counts; on the card "
                           "one counts where its first difference has a "
                           "greedy top-2 logit gap above tau "
                           "(mismatch_raw: every differing request)"},
                  lines)
    except Exception as e:
        errors["spec"] = repr(e)
        traceback.print_exc()

    # 6. batched-prefill amortization -------------------------------------
    try:
        if engine is not None:
            import numpy as np
            rng = np.random.default_rng(args.seed + 17)
            B = args.slots
            bp = [rng.integers(1, engine.vocab,
                               size=5 + (i % 4)).astype(np.int32)
                  for i in range(B)]       # all land in the same bucket
            for s in range(B):             # warm both shapes
                engine.prefill(s, bp[s], 1)
            engine.prefill_many([(s, bp[s], 1) for s in range(B)])
            solo_times, batch_times = [], []
            for _ in range(5):
                t0 = time.monotonic()
                for s in range(B):
                    engine.prefill(s, bp[s], 1)
                solo_times.append(time.monotonic() - t0)
                t0 = time.monotonic()
                engine.prefill_many([(s, bp[s], 1) for s in range(B)])
                batch_times.append(time.monotonic() - t0)
            solo, batched = min(solo_times), min(batch_times)
            _emit(f"serve_{size}_prefill_batch_amortization",
                  round(solo / batched, 4) if batched > 0 else 0.0, "x",
                  {**shared, "batch": B,
                   "solo_ms_per_request": round(solo / B * 1000.0, 4),
                   "batched_ms_per_request":
                       round(batched / B * 1000.0, 4),
                   "solo_repeats_ms": [round(t * 1000.0, 3)
                                       for t in solo_times],
                   "batched_repeats_ms": [round(t * 1000.0, 3)
                                          for t in batch_times],
                   "note": "one prefill_many call over a same-bucket "
                           "burst vs the same prompts prefilled solo "
                           "(best of 5, warm; each call ends in its "
                           "host copy of the logits): the admission "
                           "path's burst amortization, also the term "
                           "the SLO predictor prices per-request"},
                  lines)
    except Exception as e:
        errors["prefill_batch"] = repr(e)
        traceback.print_exc()

    launches = kernels.launch_counts()
    if args.json:
        meta = {"metric": "serving_bench_meta",
                "value": float(len(lines)), "unit": "lines",
                "vs_baseline": 1.0,
                "detail": {"family": "SERVE_lm", "platform": platform,
                           "provisional": True,   # meta, not a measurement
                           "errors": errors,
                           "device": shared["device"],
                           "launches": launches,
                           "note": ("CPU-platform numbers calibrate the "
                                    "serving machinery; never read as "
                                    "card throughput" if platform == "cpu"
                                    else "one card's record: "
                                         "detail.device names it")}}
        with open(args.json, "w") as f:
            for rec in lines + [meta]:
                f.write(json.dumps(rec) + "\n")
        print(f"bench_serving: wrote {args.json}", file=sys.stderr,
              flush=True)
    rc = 1 if errors else 0
    if errors:
        print(f"bench_serving: {len(errors)} instrument(s) failed: "
              + "; ".join(f"{k}: {v}" for k, v in errors.items()),
              file=sys.stderr, flush=True)
    obs_ledger.end_global(rc=rc, errors=errors or None)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
