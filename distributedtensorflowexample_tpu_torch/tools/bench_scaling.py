"""bench_scaling — sync-SGD weak-scaling efficiency over 1 -> N ranks
(the JAX package's root ``bench_scaling.py``): a fixed batch a rank, so
ideal scaling keeps the global steps/s constant as ranks are added, and

    efficiency(N) = steps_per_sec(N ranks) / steps_per_sec(1 rank)

  # on the card (the default device): ranks 1, 2, 4, 8
  python -m distributedtensorflowexample_tpu_torch.tools.bench_scaling
  # on the CPU, gloo ranks on the host:
  python -m distributedtensorflowexample_tpu_torch.tools.bench_scaling \\
      --device cpu --max_devices 2 --batch_per_chip 8 --unroll 2 --steps 4

Config 3's model (``mnist_cnn``) over a synthetic split of ``2 x unroll``
global batches, built by the port's ``Engine.build`` (the trainer's
indexed step) at N = 1, 2, 4, ... up to ``--max_devices``, measured best
of ``tools.bench.REPEATS`` windows of ``--steps`` steps (one warm-up
call).  One JSON line per N, then the summary ``{"metric":
"<mode>_sgd_weak_scaling", "value": efficiency at the largest N,
"unit": "efficiency_1_to_<N>"}``, as in JAX.

Per-step collective traffic: each rank counts the collectives its step
issues through ``parallel/mesh.Mesh`` (``Mesh.order``: kind, dtype,
bytes) over a one-step build's window, one step in sync mode and one
period (``--async_period`` steps) in async mode, the JAX harness's
one-step program: ``collectives_per_step`` is ``{kind: {"count",
"bytes"}}`` of that window.  In sync mode that is one all-reduce of the
float32 gradient, 4 bytes a parameter; in async mode the worker
average's all-reduce, which runs once a period, so
``amortized_bytes_per_step`` is the window's bytes divided by the
period.

Where the port differs from the JAX harness, on purpose:

- (a) **Ranks are processes.**  The JAX harness runs submeshes of one
  process (``--real`` for the chips, else 8 virtual CPU devices).  Here
  N = 1 is this process with no process group (the trainer's one-rank
  program, no collective), and N > 1 spawns N ranks through
  ``parallel/launch.spawn``.  ``--real`` becomes ``--device {cuda,cpu}``:
  the card unless ``--device cpu``; no card exits 1 naming ``--device
  cuda``.
- (b) **The backend is named.**  It follows
  ``tools/bench_collectives.choose_backend``: NCCL with a card a rank,
  else gloo, which may put several ranks on one card and stages every
  collective through host memory.  Each line says so (``backend``,
  ``host_staged``) with the distinct cards in use (``num_chips``,
  ``parallel/mesh.py``) and ``device`` (``bench_ratchet.describe_device``:
  the card's name and power limit).  On a one-card machine every N > 1
  is gloo ranks sharing the card: the efficiency prices the host-staged
  all-reduce, not NVLink.
- (c) **Traffic is counted, not parsed**: ``Mesh.order`` in place of the
  HLO parse (``collective_traffic``).  The metrics' all-reduce is not a
  counted collective (``Mesh.sum_metrics``, once a host read), where the
  JAX program psums two scalars every step; so the async amortization is
  exact, with no ``amortized_note``.
- (d) **The group's rate is its slowest rank's** (each rank measures its
  own windows; a step ends for all at the gradient all-reduce).
- (e) **Kernels**: none launch.  The config keeps ``--dequant_impl
  auto`` (the affine in-step dequant; the CUDA dequant kernel runs only
  under ``pallas``, which the JAX harness does not select either), and
  the CE pair and the SGD kernel are off, as in JAX; each line's
  ``launches`` lists every rank's counts to show it.
"""

from __future__ import annotations

import argparse
import json
import sys


def _counts(max_devices: int) -> list[int]:
    """1, 2, 4, ... up to ``max_devices``."""
    counts, n = [], 1
    while n <= max_devices:
        counts.append(n)
        n *= 2
    return counts


def _spec(args, ranks: int):
    """Config 3 at ``--batch_per_chip`` a rank on a split of ``2 x
    unroll`` global batches (the JAX harness's input), momentum 0.9 at
    the bare float lr 0.05."""
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.engine.engine import RunSpec
    global_batch = args["batch_per_chip"] * ranks

    def input_fn(cfg, split):
        return make_synthetic(global_batch * args["unroll"] * 2,
                              (28, 28, 1), 10, seed=0)

    cfg = RunConfig(batch_size=args["batch_per_chip"], seed=0,
                    learning_rate=0.05, momentum=0.9,
                    sync_mode=args["mode"],
                    async_period=args["async_period"],
                    device=args["device"])
    return RunSpec(model="mnist_cnn", dataset="mnist", config=cfg,
                   input_fn=input_fn)


def traffic(order: list) -> dict:
    """``Mesh.order`` entries ``(kind, dtype, bytes)`` -> ``{kind:
    {"count", "bytes"}}``."""
    out: dict = {}
    for kind, _, nbytes in order:
        row = out.setdefault(kind, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += int(nbytes)
    return out


def scaling_rank(args: dict) -> dict:
    """One rank (or, with no process group, the one-rank run): the
    counted collectives of a one-step build's window, then the measured
    rate of the ``--unroll`` build, and this rank's kernel launches."""
    from distributedtensorflowexample_tpu_torch.engine.engine import Engine
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.tools import bench

    mesh = make_mesh(args["device"])
    spec = _spec(args, mesh.size)
    kernels.reset_launch_counts()
    window = args["async_period"] if args["mode"] == "async" else 1
    one = Engine(spec).build(mesh=mesh, unroll=1)
    mesh.order = []
    state = one.state
    for _ in range(window):
        state, metrics = one.step(state, next(one.ds))
    bench._block(metrics)
    per_step = traffic(mesh.order)
    mesh.order = None
    built = Engine(spec).build(mesh=mesh, unroll=args["unroll"])
    best, rates, _ = bench._measure(built.step, built.ds, built.state,
                                    args["steps"], args["unroll"],
                                    warmup_calls=1)
    return {"rank": mesh.rank, "steps_per_sec": best, "repeats": rates,
            "collectives_per_step": per_step, "window_steps": window,
            "num_chips": mesh.num_chips,
            "launches": kernels.launch_counts()}


def measure(args: dict, n: int, backend: str | None) -> list[dict]:
    """``scaling_rank`` on each of ``n`` ranks (in this process, with no
    group, at ``n`` = 1)."""
    if n == 1:
        return [scaling_rank(args)]
    from distributedtensorflowexample_tpu_torch.parallel import launch
    # By its module's name: run with ``-m`` this module is ``__main__``,
    # and the spawned ranks unpickle the function by name.
    from distributedtensorflowexample_tpu_torch.tools import bench_scaling
    return launch.spawn(bench_scaling.scaling_rank, n, backend, (args,))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the ranks run (cuda: the visible "
                             "cards, several gloo ranks may share one)")
    parser.add_argument("--max_devices", type=int, default=8,
                        help="the largest rank count (1, 2, 4, ... up to "
                             "it)")
    parser.add_argument("--batch_per_chip", type=int, default=64)
    parser.add_argument("--unroll", type=int, default=16)
    parser.add_argument("--steps", type=int, default=64,
                        help="measured steps per repeat")
    parser.add_argument("--mode", choices=("sync", "async"), default="sync",
                        help="sync = one gradient all-reduce per step; "
                             "async = local SGD (config 2), whose worker "
                             "average all-reduces every --async_period "
                             "steps")
    parser.add_argument("--async_period", type=int, default=8)
    args = parser.parse_args(argv)
    if args.mode == "async" and args.async_period < 1:
        parser.error(f"--async_period must be >= 1, got {args.async_period}")
    if args.max_devices < 1:
        parser.error(f"--max_devices must be >= 1, got {args.max_devices}")
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            print(f"bench_scaling: {e}", file=sys.stderr, flush=True)
            return 1

    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.tools.bench_collectives import (
        choose_backend)
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)
    obs_ledger.maybe_begin("bench_scaling", config=vars(args))
    obs_serve.maybe_start()

    rank_args = vars(args)
    device = describe_device(args.device)
    counts = _counts(args.max_devices)
    results = {}
    for n in counts:
        backend = choose_backend("auto", args.device, n) if n > 1 else None
        ranks = measure(rank_args, n, backend)
        best = min(r["steps_per_sec"] for r in ranks)
        slowest = min(ranks, key=lambda r: r["steps_per_sec"])
        per_step = ranks[0]["collectives_per_step"]
        results[n] = best
        line = {
            "devices": n, "backend": backend,
            "host_staged": backend == "gloo" and args.device == "cuda",
            "num_chips": ranks[0]["num_chips"], "mode": args.mode,
            "global_batch": args.batch_per_chip * n,
            "steps_per_sec": round(best, 2),
            "repeats": slowest["repeats"],
            "collectives_per_step": per_step,
            "launches": [r["launches"] for r in ranks],
            "device": device,
        }
        if args.mode == "async":
            line["amortized_bytes_per_step"] = {
                op: round(v["bytes"] / ranks[0]["window_steps"])
                for op, v in per_step.items()}
        print(json.dumps(line), flush=True)

    base = results[counts[0]]
    efficiency = {str(n): round(results[n] / base, 4) for n in counts}
    top = counts[-1]
    top_backend = choose_backend("auto", args.device, top) if top > 1 \
        else None
    print(json.dumps({
        "metric": f"{args.mode}_sgd_weak_scaling",
        "value": efficiency[str(top)],
        "unit": f"efficiency_1_to_{top}",
        "vs_baseline": 1.0,
        "detail": {"backend": top_backend, "mode": args.mode,
                   "efficiency": efficiency,
                   "batch_per_chip": args.batch_per_chip,
                   "host_staged": top_backend == "gloo"
                   and args.device == "cuda",
                   "num_chips": line["num_chips"], "device": device,
                   "platform": "gpu" if args.device == "cuda" else "cpu",
                   "note": ("gloo ranks sharing the card(s) stage every "
                            "collective through host memory: the "
                            "efficiency prices that, not NCCL"
                            if top_backend == "gloo"
                            and args.device == "cuda" else
                            "NCCL, a card a rank" if args.device == "cuda"
                            else "gloo ranks on the host's cores: the "
                                 "per-step overhead trend only, never "
                                 "card numbers")},
    }), flush=True)
    obs_ledger.end_global(rc=0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
