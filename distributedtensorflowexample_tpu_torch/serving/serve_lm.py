"""serve_lm — the LM serving worker (the JAX package's
``tools/serve_lm.py``): snapshot → continuous-batching KV-cache decode.

    # serve a snapshot over HTTP until TERM (SERVE_PORT or --http):
    python -m distributedtensorflowexample_tpu_torch.serving.serve_lm \\
        --snapshot /tmp/lm_snaps --size lm_small --http 8811

    # self-contained demo on the CPU: init a snapshot if absent, drive 32
    # requests through the in-process closed loop, write stats, exit 0:
    python -m distributedtensorflowexample_tpu_torch.serving.serve_lm \\
        --device cpu --snapshot /tmp/lm_snaps --init_if_missing \\
        --drive 32 --stats /tmp/serve_stats.json

It runs on the CUDA card unless ``--device cpu`` is given (no card:
``DeviceUnavailable``), and speaks the trainers' operational protocols:

- **TERM → drain → 143**: SIGTERM stops admission, decodes every
  in-flight request to completion, rejects the queued tail loudly
  (outcome ``drained``), writes stats, exits 143.  In ``--drive`` mode a
  relaunch re-issues exactly the unfinished request ids from its
  ``--results`` tape.
- **heartbeat**: touches ``SUPERVISE_HEARTBEAT`` at loop boundaries (busy
  or idle, at most every 0.5 s), so a watchdog can tell a wedged decode
  from a quiet queue.
- **refusals** exit 2 before any request is admitted, naming the flag;
- **telemetry** as in the JAX tool: the flight recorder (``OBS_FLIGHT``),
  the run ledger (``OBS_LEDGER``: a ``run_start`` row with the serving
  config, ``run_end`` with the rc) and the live scrape
  (``OBS_HTTP_PORT``), armed in the process that runs the batcher.

``--sharded_mesh D`` (D >= 1) serves with the parameters left sharded:
D ranks start through ``parallel/launch.spawn`` (gloo on the CPU, and for
more ranks than visible cards, which share a card; NCCL across cards;
D = 1 is the sharded engine in this process on a one-rank mesh, whose
gathers are the identity, as the JAX tool's one-device mesh),
each promotes its 1/D rows (``promote.promote_sharded``) into a
``serving/sharded.ShardedDecodeEngine``; rank 0 runs the queue, the
batcher, the load generator and the front end, the others follow its
commands.  SIGTERM reaches every rank through ``spawn``'s forwarding:
rank 0 drains and stops the followers, and every rank exits 143.
Speculative decoding, sampling and the prefix cache are refused by name
against that engine (``spec.py``, ``queue.py``, ``prefix.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

RC_PREEMPTED = 143


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--snapshot", default="",
                   help="SnapshotStore directory to promote (default "
                        "$SERVE_SNAPSHOT)")
    p.add_argument("--size", default="lm_tiny",
                   help="LM size the snapshot holds (LM_SIZES)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to serve (cuda: the card; cpu: the plain "
                        "versions on the host)")
    p.add_argument("--slots", type=int, default=0,
                   help="concurrent decode slots (default $SERVE_SLOTS "
                        "or 4)")
    p.add_argument("--slo_ms", type=float, default=-1.0,
                   help="end-to-end latency SLO driving admission "
                        "(default $SERVE_SLO_MS; 0 = admit everything)")
    p.add_argument("--max_len", type=int, default=64,
                   help="KV-cache rows per slot (prompt + generated)")
    p.add_argument("--http", type=int, default=-1,
                   help="request-front port (default $SERVE_PORT; 0 = "
                        "in-process only)")
    p.add_argument("--init_if_missing", action="store_true",
                   help="write a demo-grade (untrained, seeded) snapshot "
                        "when the store holds no valid one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded_mesh", type=int, default=0,
                   help="params-stay-sharded decode over D ranks (each "
                        "holds 1/D of the parameters; 0 = replicated)")
    p.add_argument("--spec_draft", default="",
                   help="speculative decoding: LM_SIZES size that "
                        "DRAFTS (e.g. lm_tiny); the served model "
                        "verifies — output stays greedy")
    p.add_argument("--spec_draft_snapshot", default="",
                   help="snapshot dir for the draft model (default: "
                        "the served --snapshot dir)")
    p.add_argument("--spec_k", type=int, default=4,
                   help="draft window: tokens drafted per verify round")
    p.add_argument("--sample_temp", type=float, default=0.0,
                   help="sampling temperature (0 = greedy decode; "
                        "sampled tokens draw on per-request RNG lanes, "
                        "deterministic per request id)")
    p.add_argument("--sample_top_k", type=int, default=0,
                   help="restrict sampling to the k most likely tokens "
                        "(0 = full softmax; arms the sampler even at "
                        "default temperature)")
    p.add_argument("--sample_seed", type=int, default=0,
                   help="worker-level seed the per-request RNG lanes "
                        "derive from")
    p.add_argument("--prefix_cache", type=int, default=0,
                   help="share K/V rows across requests with equal "
                        "prompt prefixes (value = resident prompt "
                        "capacity; 0 = off)")
    p.add_argument("--drive", type=int, default=0,
                   help="drive N deterministic requests through the "
                        "in-process closed loop, then exit 0 (0 = serve "
                        "until TERM)")
    p.add_argument("--clients", type=int, default=0,
                   help="closed-loop client threads for --drive "
                        "(default $SERVE_LOAD_CLIENTS or 2)")
    p.add_argument("--drive_max_new", type=int, default=8,
                   help="generated tokens per driven request")
    p.add_argument("--drive_think_ms", type=float, default=0.0,
                   help="closed-loop client think time between "
                        "completions (holds offered load below "
                        "saturation)")
    p.add_argument("--results", default="",
                   help="--drive completion tape (JSONL; re-issues only "
                        "unfinished ids on relaunch)")
    p.add_argument("--stats", default="",
                   help="write the final stats JSON here")
    p.add_argument("--ready_file", default="",
                   help="touch this path once the worker is serving")
    return p


def _arm_obs(args, snapshot: str, slots: int, slo_ms: float) -> None:
    """The JAX tool's telemetry, in the process that runs the batcher."""
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import (
        recorder as obs_recorder)
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    rec = obs_recorder.maybe_install()
    if rec is not None:
        rec.note(tool="serve_lm", snapshot=snapshot, size=args.size,
                 slots=slots, slo_ms=slo_ms)
    obs_ledger.maybe_begin(
        "serve_lm", config={"snapshot": snapshot, "size": args.size,
                            "slots": slots, "slo_ms": slo_ms,
                            "max_len": args.max_len, "drive": args.drive,
                            "seed": args.seed,
                            "sharded_mesh": args.sharded_mesh,
                            "spec_draft": args.spec_draft,
                            "spec_k": args.spec_k,
                            "sample_temp": args.sample_temp,
                            "sample_top_k": args.sample_top_k,
                            "prefix_cache": args.prefix_cache})
    obs_serve.maybe_start()


def _init_if_missing(args, snapshot: str) -> None:
    from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
        SnapshotStore)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        init_lm_snapshot)
    if args.init_if_missing \
            and SnapshotStore(snapshot).latest_valid() is None:
        init_lm_snapshot(snapshot, args.size, seed=args.seed)
        print(f"serve_lm: initialized demo snapshot in {snapshot}",
              file=sys.stderr, flush=True)


def _batcher(args, engine, device, snapshot: str, slo_ms: float):
    """(batcher, mode description) around ``engine``: speculative
    decoding, sampling and the prefix cache as the flags ask, each
    refused by name where the engine lacks its seam."""
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        init_lm_snapshot, promote)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)
    from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
        SnapshotStore)
    mode_desc = ""
    spec = sampler = prefix = None
    if args.spec_draft:
        from distributedtensorflowexample_tpu_torch.serving.spec import (
            SpecDecoder)
        dsnap = args.spec_draft_snapshot or snapshot
        if args.init_if_missing and dsnap != snapshot \
                and SnapshotStore(dsnap).latest_valid() is None:
            init_lm_snapshot(dsnap, args.spec_draft, seed=args.seed)
        dpm = promote(dsnap, args.spec_draft, device=device)
        draft_engine = DecodeEngine(dpm.model, slots=engine.slots,
                                    cache_len=args.max_len)
        spec = SpecDecoder(engine, draft_engine, k=args.spec_k)
        mode_desc += (f", spec k={args.spec_k} (draft {args.spec_draft} "
                      f"step {dpm.step})")
    if args.sample_temp > 0 or args.sample_top_k > 0:
        from distributedtensorflowexample_tpu_torch.serving.sampling import (
            Sampler)
        sampler = Sampler(
            temperature=(args.sample_temp if args.sample_temp > 0
                         else 1.0),
            top_k=args.sample_top_k, seed=args.sample_seed)
        mode_desc += f", sampler {sampler.describe()}"
    if args.prefix_cache > 0:
        from distributedtensorflowexample_tpu_torch.serving.prefix import (
            PrefixCache)
        prefix = PrefixCache(engine, capacity=args.prefix_cache)
        mode_desc += f", prefix cache {args.prefix_cache}"
    batcher = ContinuousBatcher(engine, RequestQueue(engine.vocab),
                                slo_ms=slo_ms, spec=spec, sampler=sampler,
                                prefix_cache=prefix)
    return batcher, mode_desc


def _write_stats(path: str, stats: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(stats, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _serve(args, batcher, served: dict, device, term, t0: float,
           slo_ms: float, port: int, mode_desc: str) -> int:
    """Serve until TERM or the end of the ``--drive``: the front end, the
    drive's clients, the batcher loop, the stats; returns the rc.
    ``served``: the snapshot facts the stats carry (step, layout)."""
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.serving.frontend import (
        RequestFront)
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        ClosedLoopLoadGen, DriveFile, load_clients_default)
    from distributedtensorflowexample_tpu_torch.training.hooks import (
        touch_heartbeat)
    engine, queue = batcher.engine, batcher.queue
    front = RequestFront(queue, batcher, port).start() if port else None
    print(f"serve_lm: serving {args.size} snapshot step {served['step']} "
          f"({served['layout']}) on {device} — {engine.slots} slot(s), "
          f"cache {args.max_len} rows/slot ({engine.cache_bytes >> 10} "
          f"KiB), SLO {slo_ms or 'off'} ms, load time "
          f"{time.monotonic() - t0:.2f}s" + mode_desc
          + (f", HTTP :{front.port}" if front else ""),
          file=sys.stderr, flush=True)
    if args.ready_file:
        touch_heartbeat(args.ready_file)

    drive_done = threading.Event()
    gen = None
    gen_summary: dict = {}
    if args.drive > 0:
        gen = ClosedLoopLoadGen(
            queue, total=args.drive,
            clients=args.clients or load_clients_default(),
            max_new=args.drive_max_new, vocab=engine.vocab,
            seed=args.seed, think_ms=args.drive_think_ms,
            drive_file=DriveFile(args.results) if args.results
            else None)

        def _drive():
            gen_summary.update(gen.run())
            drive_done.set()

        threading.Thread(target=_drive, daemon=True,
                         name="serve-drive").start()

    hb_path = os.environ.get("SUPERVISE_HEARTBEAT", "")
    last_beat = [0.0]

    def should_stop() -> bool:
        if hb_path:
            now = time.monotonic()
            if now - last_beat[0] >= 0.5:
                last_beat[0] = now
                touch_heartbeat(hb_path)
        return bool(term) or drive_done.is_set()

    batcher.run(should_stop=should_stop)
    preempted = bool(term)
    if gen is not None:
        gen.stop.set()
        drive_done.wait(timeout=30)

    if front is not None:
        front.stop()
    stats = batcher.stats()
    # ``launches``: this process's kernel launches so far (none of the
    # port's kernels is on the serving path).
    stats.update(snapshot_step=served["step"],
                 snapshot_layout=served["layout"], size=args.size,
                 preempted=preempted, drive=gen_summary or None,
                 platform=device.type, launches=kernels.launch_counts(),
                 **served.get("extra", {}))
    if args.stats:
        _write_stats(args.stats, stats)
    print(json.dumps(stats, sort_keys=True), flush=True)
    rc = RC_PREEMPTED if preempted else 0
    if preempted:
        print(f"serve_lm: TERM — drained {stats['completed']} "
              f"completed request(s), rejected tail "
              f"{stats['rejected']['drained']}; exit {rc}",
              file=sys.stderr, flush=True)
    obs_ledger.end_global(rc=rc, completed=stats["completed"])
    return rc


def _sharded_rank(args, snapshot: str, slots: int, slo_ms: float,
                  port: int) -> dict:
    """One rank of ``--sharded_mesh`` (``parallel/launch.spawn``'s
    child): promote this rank's rows, build the sharded engine; rank 0
    serves, the others follow.  A SIGTERM is a flag from the first line
    on: rank 0 drains, stops the followers, and every rank exits 143."""
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        promote_sharded)
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        ShardedDecodeEngine)
    from distributedtensorflowexample_tpu_torch.utils.signals import (
        sigterm_flag)
    with sigterm_flag() as term:
        t0 = time.monotonic()
        kernels.reset_launch_counts()
        mesh = make_mesh(args.device)
        if mesh.size > 1:
            os.environ.setdefault("OBS_RANK", str(mesh.rank))
        if mesh.rank == 0:
            _arm_obs(args, snapshot, slots, slo_ms)
        pm = promote_sharded(snapshot, args.size, mesh=mesh,
                             mesh_size=args.sharded_mesh)
        engine = ShardedDecodeEngine(pm.model, pm.rows, pm.layout,
                                     mesh=mesh, slots=slots,
                                     cache_len=args.max_len)
        # Every rank is built (and its SIGTERM flag armed) before rank 0
        # reports ready.
        mesh.all_gather_int(0)
        rc = 0
        if mesh.rank != 0:
            engine.follow()
        else:
            try:
                batcher, mode_desc = _batcher(args, engine, mesh.device,
                                              snapshot, slo_ms)
                D = pm.layout.num_devices
                served = {"step": pm.step, "layout": pm.source_layout,
                          "extra": {"sharded_mesh": D,
                                    "params_residency":
                                        engine.params_residency()}}
                rc = _serve(args, batcher, served, mesh.device, term, t0,
                            slo_ms, port,
                            f", sharded D={D} (params resident at 1/{D})"
                            + mode_desc)
            finally:
                engine.stop_followers()
        preempted = rc == RC_PREEMPTED or bool(term)
    if preempted:
        print(f"serve_lm: rank {mesh.rank}: TERM — exit {RC_PREEMPTED}",
              file=sys.stderr, flush=True)
        raise SystemExit(RC_PREEMPTED)
    return {"rank": mesh.rank, "rc": rc,
            "decode_steps": engine.decode_steps,
            "launches": kernels.launch_counts()}


def _main_sharded(args, snapshot: str, slots: int, slo_ms: float,
                  port: int) -> int:
    """``--sharded_mesh D``: the by-name refusals, then D ranks.  D = 1
    runs the sharded engine in this process on a one-rank mesh (no
    process group, no spawn), whose collectives are the identity."""
    import torch

    from distributedtensorflowexample_tpu_torch.device import resolve_device
    from distributedtensorflowexample_tpu_torch.parallel.launch import spawn
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        check_slots)
    D = args.sharded_mesh
    try:
        if D < 1:
            raise ModeRefusal(
                f"--sharded_mesh {D}: a mesh has at least one rank — "
                f"serve replicated (--sharded_mesh 0) or shard over "
                f"D >= 1 ranks")
        check_slots(slots, D)
        resolve_device(args.device)
        _init_if_missing(args, snapshot)
    except ModeRefusal as e:
        print(f"serve_lm: refused: {e}", file=sys.stderr, flush=True)
        return 2
    backend = ("nccl" if args.device == "cuda"
               and torch.cuda.device_count() >= D else "gloo")
    try:
        if D == 1:
            ranks = [_sharded_rank(args, snapshot, slots, slo_ms, port)]
        else:
            ranks = spawn(_sharded_rank, D, backend,
                          args=(args, snapshot, slots, slo_ms, port))
    except ModeRefusal as e:
        print(f"serve_lm: refused: {e}", file=sys.stderr, flush=True)
        return 2
    except SystemExit as e:
        if e.code == RC_PREEMPTED:
            return RC_PREEMPTED
        raise
    # Each rank's kernel launches over its whole run, beside rank 0's
    # stats.
    launches = [r["launches"] for r in ranks]
    print(f"serve_lm: kernel launches by rank {json.dumps(launches)}",
          file=sys.stderr, flush=True)
    if args.stats and os.path.exists(args.stats):
        with open(args.stats) as f:
            stats = json.load(f)
        _write_stats(args.stats, {**stats, "launches_by_rank": launches})
    return ranks[0]["rc"]


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    from distributedtensorflowexample_tpu_torch.device import resolve_device
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine, serve_slots_default)
    from distributedtensorflowexample_tpu_torch.serving.frontend import (
        serve_port_default)
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        promote, serve_snapshot_default)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        serve_slo_ms_default)
    from distributedtensorflowexample_tpu_torch.utils.signals import (
        sigterm_flag)

    snapshot = args.snapshot or serve_snapshot_default()
    if not snapshot:
        _parser().error("--snapshot (or SERVE_SNAPSHOT) is required")
    slots = args.slots or serve_slots_default()
    slo_ms = serve_slo_ms_default() if args.slo_ms < 0 else args.slo_ms
    port = serve_port_default() if args.http < 0 else args.http
    if args.sharded_mesh:
        return _main_sharded(args, snapshot, slots, slo_ms, port)

    t0 = time.monotonic()
    _arm_obs(args, snapshot, slots, slo_ms)
    try:
        # Impossible flag combinations are refused BY NAME before any
        # request could be admitted — exit 2, argparse's own bad-usage
        # code, so a supervisor never retries a config that can only
        # refuse again.
        device = resolve_device(args.device)
        _init_if_missing(args, snapshot)
        pm = promote(snapshot, args.size, device=device)
        engine = DecodeEngine(pm.model, slots=slots, cache_len=args.max_len)
        batcher, mode_desc = _batcher(args, engine, device, snapshot,
                                      slo_ms)
    except ModeRefusal as e:
        print(f"serve_lm: refused: {e}", file=sys.stderr, flush=True)
        return 2
    with sigterm_flag() as term:
        return _serve(args, batcher, {"step": pm.step, "layout": pm.layout},
                      device, term, t0, slo_ms, port, mode_desc)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
