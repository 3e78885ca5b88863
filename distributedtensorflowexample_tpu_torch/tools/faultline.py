"""faultline — reproduce any injected-fault scenario from the CLI (the JAX
package's ``tools/faultline.py`` on the port).

Runs a small training loop with a named FaultPlan wired in, speaking the
supervisor's exit-code protocol, so every resilience scenario is one
command:

  python -m distributedtensorflowexample_tpu_torch.tools.faultline \\
      --plan preempt --steps 8 --workdir /tmp/fl
  # SIGTERM at a seed-drawn mid-run step -> snapshot saved -> exit 143
  python -m distributedtensorflowexample_tpu_torch.tools.faultline \\
      --plan preempt --steps 8 --workdir /tmp/fl
  # resumes from the snapshot, finishes, exit 0

The loop runs on the CUDA card unless ``--device cpu`` asks for the CPU
(no card with the default raises ``DeviceUnavailable``).  On the card
cuDNN runs its deterministic algorithms, so a resumed run is bitwise the
uninterrupted one.  The step is plain momentum SGD (lr 0.1, momentum
0.9) over the port's host-fed step (``parallel/sync.make_train_step``);
like the JAX driver it launches none of the port's kernels.

Plans (resilience/faults.py NAMED_PLANS): preempt, wedge, nan_loss,
corrupt_batch, corrupt_batch_rank, torn_snapshot, heartbeat_flap,
journal_torn, slow_rank, host_loss, shard_loss, bitflip, none — or
explicit specs like ``preemption@3`` / ``wedge@2:5.0`` /
``slow_rank@5:0.5%1``, comma-separated.  The same ``(--plan, --steps,
--seed)`` triple reproduces the same scenario anywhere, and the batches
are bitwise the JAX driver's.  Under the supervisor, faults are
TRANSIENT by default: they fire on attempt 0 only (SUPERVISE_ATTEMPT).

``--layout zero3 --mesh D`` runs the drill as D ranks of one ZeRO-3
group (``parallel/zero3.py``: the parameters and the momentum as 1/D
bucket rows), started by this process through ``parallel/launch.spawn``
(gloo on the CPU and for D ranks sharing fewer cards, NCCL when every
rank has a card of its own; one intra-op thread a rank, so the tape does
not depend on the host's core count).  Each rank takes its rows of every
global batch (the JAX step's batch sharding) and writes its part of the
shard-redundant ``ShardStore`` (resilience/shardstore.py) in place of
the monolithic SnapshotStore: snapshots are per-rank shard files + ring
mirrors under a quorum manifest, and resume goes through the elastic
regroup (so a ``--mesh 2`` resume of a ``--mesh 4`` run is legal).  To a
fleet this process stays ONE rank: a SIGTERM to its process group
reaches every mesh rank, the ranks agree on the stop at a step boundary,
save, and this process exits 143 once.  The ``shard_loss``/``bitflip``
plans delete or rot exactly one shard after the final save, once every
rank has returned; ``%RANK`` on those plans names the MESH-SHARD index
inside this process's store, not a fleet rank.  The emitted
``params_digest`` hashes the MATERIALIZED parameters (width-independent
in layout); the row-state ``digest`` hashes each rank's rows in rank
order and compares only at equal width.

Fleet drills (``supervise_fleet``) run one faultline per rank with the
SAME plan text: a ``%rank`` suffix pins a spec to one rank (``kill@5%1``
= kill rank 1 at step 5), and this process keeps only the specs for ITS
rank (--rank, default OBS_RANK).  When the fleet's resume-step
agreement exported FLEET_RESUME_STEP, the restore targets exactly that
step — never this rank's own newest.

stdout is one JSON line: status, start/end step, a sha256 digest over
every leaf of the port's resumable state (parameters, momentum, the
optimizer's count, model buffers, dropout generator states, step — the
cross-process bitwise-parity handle within the port), and the (step,
loss) tape.  Everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.parallel.mesh import ONE_RANK

_LM_DRILL_SEQ = 32      # short sequences keep LM drills cheap
_DRILL_BUCKET_BYTES = 1 << 20   # zero3 drills: one-ish bucket per dtype
LEARNING_RATE = 0.1     # optax.sgd(0.1, momentum=0.9) in the JAX driver
MOMENTUM = 0.9


def _leaves(obj):
    """Every leaf of a nested content dict, keys in sorted order."""
    if isinstance(obj, dict):
        for key in sorted(obj, key=str):
            yield from _leaves(obj[key])
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _leaves(item)
    else:
        yield obj


def _digest(state, mesh=ONE_RANK, replicated: bool = True) -> str:
    """sha256 over every leaf of ``saveable_state_dict`` (the one
    definition of a resumable state), as host bytes; of a row layout,
    this rank's rows (``replicated`` False)."""
    from distributedtensorflowexample_tpu_torch.training.state import (
        saveable_state_dict)
    h = hashlib.sha256()
    for leaf in _leaves(saveable_state_dict(state, mesh, replicated)):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def _batch_stream(batch_size: int, seed: int, start_step: int,
                  pool_size: int = 4, model: str = "softmax",
                  device: torch.device = torch.device("cpu")):
    """Deterministic, step-addressable batches: step s always sees pool
    slot (s-1) % pool_size, so a resumed run replays the identical
    stream from its restored step — the dataset-cursor contract the
    snapshot manifest records (here the cursor IS the step).  The pool
    is the JAX driver's bytes (the port's copies of ``make_synthetic``
    and ``make_synthetic_tokens``), uploaded once; LM models get int32
    token batches."""
    if model.startswith("lm_"):
        from distributedtensorflowexample_tpu_torch.data.lm import (
            make_synthetic_tokens)
        from distributedtensorflowexample_tpu_torch.models import LM_VOCAB
        seq = make_synthetic_tokens(batch_size * pool_size, _LM_DRILL_SEQ,
                                    LM_VOCAB, seed, sample_seed=seed + 1)
        x = seq[:, :-1].astype("int32")
        y = seq[:, 1:].astype("int32")
    else:
        from distributedtensorflowexample_tpu_torch.data.synthetic import (
            make_synthetic)
        x, y = make_synthetic(batch_size * pool_size, (28, 28, 1), 10,
                              seed=seed + 1)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pool = [{"image": up(x[i * batch_size:(i + 1) * batch_size]),
             "label": up(y[i * batch_size:(i + 1) * batch_size])}
            for i in range(pool_size)]

    def gen():
        s = start_step
        while True:
            yield pool[s % pool_size]
            s += 1

    return gen()


def init_state(model: str, seed: int, device: torch.device,
               mesh=ONE_RANK):
    """The run's initial state: ``model`` initialized from ``seed`` (flax's
    default init distributions, the port's own draws) on ``device``, with
    plain momentum SGD at :data:`LEARNING_RATE` and :data:`MOMENTUM`, in
    the tree layout (rank 0 of ``mesh`` broadcasts it).  The one place
    the state is built, so a test can start the port from another
    package's converted initial state."""
    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.training.optimizers import (
        MomentumSGD)
    from distributedtensorflowexample_tpu_torch.training.state import (
        TrainState)
    lr = np.float32(LEARNING_RATE)
    return TrainState.create(
        build_model(model),
        lambda m: MomentumSGD(m, lambda count: lr, MOMENTUM, fused=False),
        seed, device, mesh=mesh)


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def _emit(args, attempt: int, rank: int, start_step: int, losses,
          status: str, **extra) -> None:
    """The one stdout line."""
    rec = {"status": status, "plan": args.plan, "seed": args.seed,
           "attempt": attempt, "rank": rank, "start_step": start_step,
           "losses": [[s, loss] for s, loss in losses], **extra}
    print(json.dumps(rec, sort_keys=True), flush=True)


def _post_exit_faults(plan, final_step: int, snapshots, shards) -> None:
    """The plan's post-exit faults, applied AFTER the final save: the
    torn snapshot/journal shapes recovery must survive by falling back
    (previous valid snapshot; journal replay skipping the tail), and the
    shard store's lost or rotten shard (``shards`` None: the tree
    layout, which has no shard store to damage)."""
    from distributedtensorflowexample_tpu_torch.resilience.faults import (
        tear_journal)
    for spec in plan.post_exit_specs:
        if spec.step > final_step:
            continue
        if spec.kind == "torn_snapshot":
            torn = snapshots.tear_latest()
            print(f"faultline: tore snapshot {torn} mid-file",
                  file=sys.stderr, flush=True)
        elif spec.kind in ("shard_loss", "bitflip") and shards is None:
            print(f"faultline: {spec.kind} needs the shard store "
                  f"(--layout zero3) — no-op", file=sys.stderr, flush=True)
        elif spec.kind == "shard_loss":
            hit = shards.drop_rank_dir(spec.rank or 0)
            print(f"faultline: dropped mesh-shard {spec.rank or 0}'s whole "
                  f"directory from shard set {hit}", file=sys.stderr,
                  flush=True)
        elif spec.kind == "bitflip":
            hit = shards.flip_payload_byte(spec.rank or 0)
            step_hit, off = hit if hit else (None, None)
            print(f"faultline: flipped payload byte {off} of mesh-shard "
                  f"{spec.rank or 0} in shard set {step_hit} (silent rot)",
                  file=sys.stderr, flush=True)
        elif spec.kind == "journal_torn":
            jp = os.environ.get("SUPERVISE_JOURNAL", "")
            if jp and tear_journal(jp):
                print(f"faultline: tore journal {jp} mid-line",
                      file=sys.stderr, flush=True)
            else:
                print("faultline: journal_torn had no journal to tear "
                      "(SUPERVISE_JOURNAL unset or empty) — no-op",
                      file=sys.stderr, flush=True)


def _zero3_rank(opts: dict) -> dict:
    """One mesh rank of ``--layout zero3`` (``launch.spawn``'s child):
    this rank's rows of the ZeRO-3 state, restored from (and saved to)
    the shared shard store; returns its part of the record.  Every rank
    runs the same hooks with the same plan, so a fault lands at the same
    boundary on each; the stop after a SIGTERM is agreed at every
    boundary (one small all-gather), so no rank leaves a collective
    another is waiting in."""
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        apply_update_layout)
    from distributedtensorflowexample_tpu_torch.obs.anomaly import RunHealth
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        make_train_step)
    from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
        materialized)
    from distributedtensorflowexample_tpu_torch.resilience import (
        FaultInjectionHook, FaultyBatches, MetricsTapeHook, NaNGuardHook,
        ShardLayout, ShardSnapshotHook, ShardStore)
    from distributedtensorflowexample_tpu_torch.training.hooks import (
        AnomalyHook, HeartbeatHook, MetricsHook)
    from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
    from distributedtensorflowexample_tpu_torch.utils.signals import (
        SigtermFlag)

    # Installed for the rank's whole life and never restored: the fleet's
    # group-wide SIGTERM and this process's parent's forward of it may
    # both arrive, the second after the loop has stopped.
    term = SigtermFlag()
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: setattr(term, "_seen", True))
    mesh = make_mesh(opts["device"])
    if mesh.device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    chief = mesh.rank == 0
    state = init_state(opts["model"], opts["seed"], mesh.device, mesh)
    store = ShardStore(
        os.path.join(opts["workdir"], "snapshots"),
        layout=ShardLayout.for_params(
            "zero3_rows", _DRILL_BUCKET_BYTES,
            dict(state.model.named_parameters()), mesh.size),
        keep=opts["keep"])
    layout = None
    if opts["resume"]:
        agreed = opts["agreed"]
        if agreed:
            # The fleet's agreement pass picked the max common valid
            # step; restoring this store's own newest instead would
            # resume a different global step than the other fleet ranks.
            step = int(agreed)
            if step > 0:
                ok, why = store.validate(step)
                if not ok:
                    return {"refused": why, "agreed": step}
                state, aux = store.restore_elastic(
                    state, mesh=mesh, step=step, update_layout="zero3_rows")
                layout = aux["zero3_layout"]
        elif store.latest_valid() is not None:
            # The elastic restore: ANY saved width regroups onto this
            # mesh through the engine's one re-layout pass.
            state, aux = store.restore_elastic(state, mesh=mesh,
                                               update_layout="zero3_rows")
            layout = aux["zero3_layout"]
    if layout is None:
        state, layout = apply_update_layout(
            state, update_layout="zero3_rows",
            bucket_bytes=_DRILL_BUCKET_BYTES, mesh=mesh)
    start_step = int(state.step)
    per = opts["batch"] // mesh.size
    lo = mesh.rank * per
    # Every rank faults the same GLOBAL stream, then takes its rows: a
    # corrupted batch is the same bytes on each rank's slice.
    batches = FaultyBatches(
        _batch_stream(opts["batch"], opts["seed"], start_step,
                      model=opts["model"], device=mesh.device),
        opts["plan"], start_step=start_step)
    rows = ({k: v[lo:lo + per] for k, v in b.items()} for b in batches)
    tape = MetricsTapeHook()
    # The hooks of the one-process driver, in its order; every rank runs
    # MetricsHook (it makes the loop reduce the metrics, a collective,
    # at every step), rank 0 alone writes health and beats.
    hooks = [MetricsHook(every=1)]
    if chief:
        hooks.append(AnomalyHook(every=1, health_path=opts["health"],
                                 health=RunHealth(rank=opts["rank"])))
    hooks += [NaNGuardHook(), tape,
              ShardSnapshotHook(store, mesh, every=opts["snapshot_every"],
                                cursor={"seed": opts["seed"]}),
              FaultInjectionHook(opts["plan"])]
    if chief and opts["heartbeat"]:
        hooks.append(HeartbeatHook(opts["heartbeat"]))

    def agreed_stop() -> bool:
        return max(mesh.all_gather_int(bool(term))) > 0

    loop = TrainLoop(make_train_step(mesh=mesh, mode="zero3",
                                     zero3_layout=layout),
                     rows, opts["steps"], hooks=hooks,
                     reduce_metrics=mesh.sum_metrics,
                     should_stop=agreed_stop)
    out = {"start_step": start_step, "losses": tape.tape}
    try:
        state = loop.run(state)
    except FloatingPointError as e:
        # Every rank reads the same reduced loss, so every rank raises at
        # the same boundary, before the poisoned state is saved.
        return {**out, "status": "fault", "error": str(e),
                "step": start_step + len(tape.tape)}
    preempted = agreed_stop()
    with materialized(state, mesh) as flat:
        params_digest = hashlib.sha256(
            flat.detach().cpu().numpy().tobytes()).hexdigest()
    return {**out, "status": "preempted" if preempted else "ok",
            "step": int(state.step),
            "digest": _digest(state, mesh, replicated=False),
            "params_digest": params_digest}


def _main_zero3(args, plan, attempt: int, rank: int) -> int:
    """``--layout zero3``: the mesh ranks through ``launch.spawn``, then
    the post-exit faults once every rank has saved, and the record."""
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
    from distributedtensorflowexample_tpu_torch.parallel import launch
    from distributedtensorflowexample_tpu_torch.resilience import (
        ShardStore, SnapshotStore)
    from distributedtensorflowexample_tpu_torch.tools import (
        faultline as this)

    snap_dir = os.path.join(args.workdir, "snapshots")
    opts = {"model": args.model, "seed": args.seed, "batch": args.batch,
            "steps": args.steps, "workdir": args.workdir, "keep": args.keep,
            "snapshot_every": args.snapshot_every,
            "resume": _truthy(args.resume),
            "agreed": os.environ.get("FLEET_RESUME_STEP", ""),
            "device": args.device, "plan": plan, "rank": rank,
            "health": os.environ.get("OBS_HEALTH", ""),
            "heartbeat": os.environ.get("SUPERVISE_HEARTBEAT", "")}
    backend = ("nccl" if args.device == "cuda"
               and torch.cuda.device_count() >= args.mesh else "gloo")
    torch.set_num_threads(1)        # one intra-op thread a rank
    try:
        # By module name, not through __main__: the ranks unpickle it.
        parts = launch.spawn(this._zero3_rank, args.mesh, backend, (opts,))
    except SystemExit as e:
        if e.code != 143:
            raise
        # A rank the signal ended before its handler was in place: no
        # rank saved past the newest set on disk, and none reported.
        print("faultline: the mesh ranks were terminated before they "
              "reported", file=sys.stderr, flush=True)
        _emit(args, attempt, rank, 0, [], status="preempted")
        obs_ledger.end_global(rc=143)
        return 143
    head = parts[0]
    if "refused" in head:
        print(f"faultline: fleet agreed resume step {head['agreed']} is "
              f"not valid in this rank's shard store ({head['refused']}) "
              f"— the agreement pass guarantees every rank holds it; "
              f"refusing to resume from a divergent snapshot",
              file=sys.stderr, flush=True)
        obs_ledger.end_global(rc=1)
        return 1
    start_step = head["start_step"]
    if start_step:
        print(f"faultline: resumed from shard set at step {start_step}",
              file=sys.stderr, flush=True)
    if head["status"] == "fault":
        print(f"faultline: {head['error']}", file=sys.stderr, flush=True)
        _emit(args, attempt, rank, start_step, head["losses"],
              status="fault", error=head["error"], step=head["step"])
        obs_ledger.end_global(rc=1, final_step=head["step"])
        return 1
    _post_exit_faults(plan, head["step"],
                      SnapshotStore(snap_dir, keep=args.keep),
                      ShardStore(snap_dir))
    digest = hashlib.sha256("".join(p["digest"] for p in parts)
                            .encode()).hexdigest()
    status = head["status"]
    _emit(args, attempt, rank, start_step, head["losses"], status=status,
          step=head["step"], digest=digest,
          params_digest=head["params_digest"])
    if status == "preempted":
        obs_recorder.dump_global("preempted")
    rc = 143 if status == "preempted" else 0
    obs_ledger.end_global(rc=rc, final_step=head["step"])
    return rc


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plan", default="preempt",
                   help="named plan or kind[@step][:arg][%%rank] specs, "
                        "comma-separated (see resilience/faults.py)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--workdir", default="/tmp/faultline",
                   help="snapshot directory (shared across attempts — "
                        "this is what resume resumes from)")
    p.add_argument("--model", default="softmax",
                   choices=["softmax", "mnist_cnn", "lm_tiny"],
                   help="lm_tiny drills the transformer LM: corrupt_batch "
                        "garbage ids land out-of-vocab, the model's OOV "
                        "poison NaNs the loss, and NaNGuard takes it from "
                        "there (models/transformer_lm.py)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot_every", type=int, default=1)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--resume", default="true",
                   help="resume from the latest manifest-valid snapshot "
                        "(or from FLEET_RESUME_STEP when a fleet "
                        "agreement pass exported one)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank for %%rank-targeted fault "
                        "specs (default: OBS_RANK, else 0)")
    p.add_argument("--layout", default="tree", choices=["tree", "zero3"],
                   help="zero3: ZeRO-3 row state over --mesh ranks with "
                        "the shard-redundant ShardStore (shard_loss/"
                        "bitflip plans live here; resume is elastic "
                        "across widths)")
    p.add_argument("--mesh", type=int, default=4,
                   help="the number of ranks of --layout zero3")
    p.add_argument("--transient", default="true",
                   help="faults fire on SUPERVISE_ATTEMPT=0 only (a "
                        "retry models recovered hardware); false "
                        "re-fires every attempt")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the loop runs (cuda unless asked for the "
                        "CPU; no fallback)")
    args = p.parse_args(argv)

    from distributedtensorflowexample_tpu_torch.device import (
        require_cuda, resolve_device)
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.obs.anomaly import RunHealth
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        make_train_step)
    from distributedtensorflowexample_tpu_torch.resilience import (
        FaultInjectionHook, FaultPlan, FaultyBatches, MetricsTapeHook,
        NaNGuardHook, SnapshotHook, SnapshotStore)
    from distributedtensorflowexample_tpu_torch.training.hooks import (
        AnomalyHook, HeartbeatHook, MetricsHook)
    from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
    from distributedtensorflowexample_tpu_torch.utils.signals import (
        sigterm_flag)

    plan = FaultPlan.parse(args.plan, args.steps, args.seed)
    if args.layout == "zero3":
        if args.mesh < 2 or args.batch % args.mesh:
            print(f"faultline: --layout zero3 shards the state over "
                  f"--mesh >= 2 ranks and the global --batch into equal "
                  f"rows (mesh {args.mesh}, batch {args.batch})",
                  file=sys.stderr, flush=True)
            return 2
        if args.device == "cuda":
            require_cuda()          # the mesh ranks hold the card, not this
    else:
        device = resolve_device(args.device)
        if device.type == "cuda":
            # Bitwise resume on the card: the same algorithms every
            # attempt.
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False

    attempt = int(os.environ.get("SUPERVISE_ATTEMPT", "0"))
    rank = (args.rank if args.rank is not None
            else int(os.environ.get("OBS_RANK", "0")))
    # Supervised drills leave a flight_<pid>.json postmortem per attempt
    # (OBS_FLIGHT=1 opts a bare run in).
    rec = obs_recorder.maybe_install(sigterm=False)
    if rec is not None:
        rec.note(tool="faultline", plan=args.plan, model=args.model,
                 workdir=args.workdir)
    # Run ledger + live scrape (env-gated): a fleet drill's per-attempt
    # rows land in the RUNS.jsonl the fleet supervisor exported, and
    # OBS_HTTP_PORT answers /metrics and /health while the drill runs.
    obs_ledger.maybe_begin(
        "faultline", config={"plan": args.plan, "steps": args.steps,
                             "model": args.model, "seed": args.seed,
                             "batch": args.batch, "rank": rank})
    obs_serve.maybe_start()
    if any(s.rank is not None for s in plan.specs):
        # Every rank parses the SAME text (same seed anchor), then keeps
        # only its own specs — "kill rank 1 at step 5" is one shared
        # scenario, not per-rank guesswork.
        plan = plan.for_rank(rank)
        print(f"faultline: rank {rank} plan: "
              + (", ".join(f"{s.kind}@{s.step}" for s in plan.specs)
                 or "(no faults target this rank)"),
              file=sys.stderr, flush=True)
    if plan and _truthy(args.transient) and attempt > 0:
        print(f"faultline: attempt {attempt}: plan {args.plan!r} already "
              f"fired (transient) — clean run", file=sys.stderr, flush=True)
        plan = FaultPlan([], seed=args.seed, name=f"{args.plan} (cleared)")
    if args.layout == "zero3":
        return _main_zero3(args, plan, attempt, rank)

    store = SnapshotStore(os.path.join(args.workdir, "snapshots"),
                          keep=args.keep)
    state = init_state(args.model, args.seed, device)
    agreed_txt = os.environ.get("FLEET_RESUME_STEP", "")
    if _truthy(args.resume):
        if agreed_txt:
            # The fleet's agreement pass picked the max common valid
            # step and discarded everything newer; restoring this
            # rank's own newest instead would silently resume a
            # DIFFERENT global step than the other ranks.
            agreed = int(agreed_txt)
            if agreed > 0:
                ok, why = store.validate(agreed)
                if not ok:
                    print(f"faultline: fleet agreed resume step {agreed} "
                          f"is not valid in this rank's store ({why}) — "
                          f"the agreement pass guarantees every rank "
                          f"holds it; refusing to resume from a "
                          f"divergent snapshot", file=sys.stderr,
                          flush=True)
                    obs_ledger.end_global(rc=1)
                    return 1
                state = store.restore(state, step=agreed)
            # agreed == 0: no common step existed — start fresh.
        else:
            state = store.restore(state)
    start_step = int(state.step)
    if start_step:
        print(f"faultline: resumed from snapshot at step {start_step}",
              file=sys.stderr, flush=True)

    batches = FaultyBatches(
        _batch_stream(args.batch, args.seed, start_step, model=args.model,
                      device=device), plan, start_step=start_step)
    tape = MetricsTapeHook()
    # Order is load-bearing: MetricsHook first so the flight recorder
    # rings every step's loss INCLUDING a poisoned one (the evidence);
    # AnomalyHook next (it reads the loss gauge MetricsHook sets, and an
    # injected slow_rank delay lands in the next boundary's window, so
    # the per-rank health.json flags the straggler while it runs); then
    # the NaN guard, which must raise BEFORE SnapshotHook sees the
    # poisoned step; FaultInjectionHook goes after SnapshotHook so the
    # step that a preemption, wedge or kill covers is already saved.
    hooks = [MetricsHook(every=1),
             AnomalyHook(every=1,
                         health_path=os.environ.get("OBS_HEALTH", ""),
                         health=RunHealth(rank=rank)),
             NaNGuardHook(), tape,
             SnapshotHook(store, every=args.snapshot_every,
                          cursor={"seed": args.seed}),
             FaultInjectionHook(plan)]
    hb = os.environ.get("SUPERVISE_HEARTBEAT", "")
    if hb:
        hooks.append(HeartbeatHook(hb))

    def emit(status: str, digest_state=None, **extra) -> None:
        if digest_state is not None:
            extra.update(step=int(digest_state.step),
                         digest=_digest(digest_state))
        _emit(args, attempt, rank, start_step, tape.tape, status=status,
              **extra)

    with sigterm_flag() as preempted:
        loop = TrainLoop(make_train_step(), batches, args.steps,
                         hooks=hooks, should_stop=preempted)
        try:
            state = loop.run(state)
        except FloatingPointError as e:
            # The guard fired before the poisoned state could be saved;
            # the newest snapshot on disk is the last healthy step.  No
            # digest: a poisoned state has no parity claim to attest.
            print(f"faultline: {e}", file=sys.stderr, flush=True)
            emit("fault", error=str(e),
                 step=start_step + len(tape.tape))
            obs_ledger.end_global(rc=1,
                                  final_step=start_step + len(tape.tape))
            return 1
        _post_exit_faults(plan, int(state.step), store, None)
        if preempted:
            obs_recorder.dump_global("preempted")
            emit("preempted", digest_state=state)
            obs_ledger.end_global(rc=143, final_step=int(state.step))
            return 143
    emit("ok", digest_state=state)
    obs_ledger.end_global(rc=0, final_step=int(state.step))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
