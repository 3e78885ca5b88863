"""bench_collectives — collective latency/bandwidth on the port's mesh:
message size x group size curves with a fitted knee (the JAX package's
``bench_collectives.py``).

  python -m distributedtensorflowexample_tpu_torch.tools.bench_collectives \\
      --json /tmp/records/BENCH_collectives_gpu_r16.json
  python -m distributedtensorflowexample_tpu_torch.tools.bench_collectives \\
      --device cpu --submeshes 2 --sizes 4096,65536 --repeats 3

For each collective kind (``psum``, ``reduce_scatter``, ``all_gather``,
``all_to_all``) and each group size in ``--submeshes``, the ranks (one
process each, ``parallel/launch.spawn``) time one call per message size
over ``--repeats`` and the sweep fits

    t(S) = alpha + S / beta          (alpha = fixed cost, beta = bandwidth)

whose knee ``alpha * beta`` is the size where transfer time equals the
fixed cost.  ``suggest_bucket_bytes`` sizes a gradient bucket at ~4x the
psum knee.  The record is the JAX tool's: the summary line with
``detail.knees.<kind>.<devices>`` = ``{alpha_s, beta_bytes_per_s,
knee_bytes, r2}`` and ``suggested_bucket_bytes``, which
``resilience/scheduler.load_collective_fit`` reads.

The kinds go through the calls the port's steps issue:
``Mesh.all_reduce`` (psum), ``Mesh.reduce_scatter`` and
``Mesh.all_gather_into`` (``parallel/mesh.py``), so the fit prices the
port's own path; ``all_to_all`` is not a ``Mesh`` method and goes
through ``dist.all_to_all_single``.  A kind a backend refuses is named
in ``detail.unmeasured`` with its error, never dropped.

Backend per group size (``--backend auto``): ``nccl`` when the device is
``cuda`` and the visible cards number at least the group size (a card a
rank), else ``gloo``, which may put several ranks on one card and stages
card tensors through host memory: its times are host-staged, not NCCL
times.  Every point and the record name the backend.

The default sizes are the JAX tool's, 4 KiB-4 MiB.  Over NVLink, NCCL
takes about as long for 4 MiB as for 4 KiB (the host's launch and
synchronization dominate), so its fit needs ``--sizes`` into the
hundreds of MiB to see the bandwidth term; a flat curve fits
degenerate (``knee_bytes`` None), never a made-up knee.

Timing: the ranks meet at a barrier, the card is synchronized, one call
is timed on the host clock and the card synchronized again; a repeat's
time is its slowest rank's, a point's the least over the repeats (the
latency floor).  ``detail.repeats`` holds the headline knee fitted from
each repeat alone (``tools.bench_ratchet``'s noise gate reads it).

``--device cuda`` (the default) with no card exits 1 by name; it never
measures the CPU in its place.  ``--device cpu`` runs gloo ranks on the
host.  Output: one JSON line per point, the summary line last; ``--json``
writes the whole record (``detail.device`` names the card and its power
limit, or the host's CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from distributedtensorflowexample_tpu_torch.device import (
    DeviceUnavailable, require_cuda)
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
    describe_device)

_COLLECTIVES = ("psum", "reduce_scatter", "all_gather", "all_to_all")
# Ring-algorithm wire factors: an all-reduce moves 2(n-1)/n of the payload
# per device, the single-phase collectives (n-1)/n.
_BUS_FACTOR = {"psum": lambda n: 2 * (n - 1) / n,
               "reduce_scatter": lambda n: (n - 1) / n,
               "all_gather": lambda n: (n - 1) / n,
               "all_to_all": lambda n: (n - 1) / n}
#: The ranks of one group size must all report within this many seconds.
SWEEP_TIMEOUT_S = 900


def fit_latency_bandwidth(sizes_bytes, times_s) -> dict:
    """Least-squares fit of ``t = alpha + S/beta`` over (size, time)
    points.  Returns alpha (s), beta (bytes/s), the knee ``alpha*beta``
    (bytes), and r2 of the fit; degenerate inputs (one point, zero
    variance, non-positive slope) fall back to knee=None so callers
    never size buckets off a meaningless fit."""
    n = len(sizes_bytes)
    out = {"alpha_s": None, "beta_bytes_per_s": None, "knee_bytes": None,
           "r2": None}
    if n < 2:
        return out
    sx = sum(sizes_bytes)
    sy = sum(times_s)
    sxx = sum(s * s for s in sizes_bytes)
    sxy = sum(s * t for s, t in zip(sizes_bytes, times_s))
    den = n * sxx - sx * sx
    if den <= 0:
        return out
    slope = (n * sxy - sx * sy) / den          # 1/beta
    alpha = (sy - slope * sx) / n
    if slope <= 0 or alpha <= 0:
        return out
    mean_t = sy / n
    ss_tot = sum((t - mean_t) ** 2 for t in times_s)
    ss_res = sum((t - (alpha + slope * s)) ** 2
                 for s, t in zip(sizes_bytes, times_s))
    beta = 1.0 / slope
    out.update(alpha_s=alpha, beta_bytes_per_s=beta,
               knee_bytes=int(alpha * beta),
               r2=None if ss_tot == 0 else round(1 - ss_res / ss_tot, 4))
    return out


def suggest_bucket_bytes(knee_bytes: int | None) -> int | None:
    """--bucket_grads auto sizing from a fitted all-reduce knee: ~4x the
    knee (alpha's share of t(S) down to ~20%), clamped to a sane range
    so a pathological fit can't produce a 1-byte or 1-GB bucket."""
    if not knee_bytes or knee_bytes <= 0:
        return None
    return int(min(max(4 * knee_bytes, 256 << 10), 64 << 20))


def payload_elems(size: int, n: int) -> int:
    """The float32 elements of a ``size``-byte payload on ``n`` ranks,
    rounded up so every scatter and the all-to-all's ``[n, k]`` split
    divide (the JAX tool's rounding)."""
    return -(-(size // 4) // (n * n)) * (n * n)


def _op(coll: str, mesh, x: torch.Tensor):
    """One call of ``coll`` on this rank's input ``x``."""
    if coll == "psum":
        return lambda: mesh.all_reduce(x)
    if coll == "reduce_scatter":
        return lambda: mesh.reduce_scatter(x)
    if coll == "all_gather":
        return lambda: mesh.all_gather_into(x)
    out = torch.empty_like(x)
    return lambda: dist.all_to_all_single(out, x)


def measure_rank(colls: list, sizes: list, repeats: int,
                 device: str) -> dict:
    """In one rank of the group: ``times[kind][size index]`` = the
    seconds of each repeat, and ``errors[kind]`` for a kind the backend
    refused."""
    mesh = make_mesh(device)
    n = mesh.size

    def sync() -> None:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    times, errors = {}, {}
    gen = torch.Generator().manual_seed(mesh.rank)
    for coll in colls:
        try:
            per_size = []
            for size in sizes:
                elems = payload_elems(size, n)
                local = elems // n if coll == "all_gather" else elems
                x = torch.randn(local, generator=gen).to(mesh.device)
                call = _op(coll, mesh, x)
                call()                       # warm: buffers, the ring
                call()
                reps = []
                for _ in range(repeats):
                    dist.barrier()
                    sync()
                    t0 = time.perf_counter()
                    call()
                    sync()
                    reps.append(time.perf_counter() - t0)
                per_size.append(reps)
            times[coll] = per_size
        except RuntimeError as e:
            errors[coll] = f"{type(e).__name__}: {e}"[:600]
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": dist.get_backend(), "times": times,
            "errors": errors}


def choose_backend(flag: str, device: str, n: int) -> str:
    """``nccl`` on ``cuda`` with a card a rank, else ``gloo`` (``auto``);
    a forced ``nccl`` without enough cards is refused by name."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if flag == "nccl":
        if device != "cuda" or cards < n:
            raise ModeRefusal(f"--backend nccl at {n} ranks needs {n} cards "
                             f"(a card a rank); {cards} visible")
        return "nccl"
    if flag == "gloo":
        return "gloo"
    return "nccl" if device == "cuda" and cards >= n else "gloo"


def sweep(n: int, backend: str, device: str, colls: list, sizes: list,
          repeats: int) -> tuple[list, dict, dict, list]:
    """One group of ``n`` ranks: (points, fits by kind, errors by kind,
    the psum knee fitted from each repeat alone)."""
    # By its module's name: run with ``-m`` this module is ``__main__``,
    # and the spawned ranks unpickle the function by name.
    from distributedtensorflowexample_tpu_torch.tools import (
        bench_collectives)
    ranks = launch.spawn(bench_collectives.measure_rank, n, backend,
                         (colls, sizes, repeats, device),
                         timeout_s=SWEEP_TIMEOUT_S)
    platform = "gpu" if device == "cuda" else "cpu"
    staged = backend == "gloo" and device == "cuda"
    points, fits, errors, knee_reps = [], {}, {}, []
    for coll in colls:
        failed = [r["errors"][coll] for r in ranks if coll in r["errors"]]
        if failed:
            errors[coll] = failed[0]
            continue
        best, per_repeat = [], []
        for i, size in enumerate(sizes):
            payload = payload_elems(size, n) * 4
            # A repeat lasts until its slowest rank is done.
            reps = [max(r["times"][coll][i][k] for r in ranks)
                    for k in range(repeats)]
            t = min(reps)
            point = {"collective": coll, "devices": n, "bytes": payload,
                     "latency_s": round(t, 9),
                     "goodput_bytes_per_s": round(payload / t),
                     "bus_bytes_per_s": round(
                         _BUS_FACTOR[coll](n) * payload / t),
                     "platform": platform, "backend": backend,
                     "host_staged": staged,
                     "repeats_s": [round(v, 9) for v in reps]}
            points.append(point)
            print(json.dumps(point), flush=True)
            best.append((payload, t))
            per_repeat.append(reps)
        fits[coll] = fit_latency_bandwidth([s for s, _ in best],
                                           [t for _, t in best])
        if coll == "psum":
            knee_reps = [fit_latency_bandwidth(
                [s for s, _ in best], [reps[k] for reps in per_repeat]
            )["knee_bytes"] for k in range(repeats)]
    return points, fits, errors, knee_reps


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the ranks' tensors live (cuda: the "
                             "visible cards; several gloo ranks may share "
                             "one)")
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "gloo", "nccl"],
                        help="auto: nccl with a card a rank, else gloo "
                             "(host-staged on the card)")
    parser.add_argument("--sizes",
                        default="4096,32768,262144,1048576,4194304",
                        help="comma-separated message sizes in BYTES (the "
                             "full payload per collective)")
    parser.add_argument("--collectives", default=",".join(_COLLECTIVES))
    parser.add_argument("--submeshes", default="2,4",
                        help="group sizes (ranks) to sweep")
    parser.add_argument("--repeats", type=int, default=7,
                        help="timed calls per point (the least is "
                             "reported: the latency floor)")
    parser.add_argument("--json", default="",
                        help="also write the full record here "
                             "(BENCH_collectives_* family)")
    args = parser.parse_args(argv)

    sizes = [int(s) for s in args.sizes.split(",") if s]
    colls = [c for c in args.collectives.split(",") if c]
    for c in colls:
        if c not in _COLLECTIVES:
            parser.error(f"unknown collective {c!r} (one of {_COLLECTIVES})")
    counts = [int(n) for n in args.submeshes.split(",") if n]
    if not counts or min(counts) < 2:
        parser.error(f"--submeshes {args.submeshes!r}: every group needs "
                     f"at least 2 ranks")
    if args.repeats < 1:
        parser.error("--repeats must be >= 1")
    if args.device == "cuda":
        try:
            require_cuda()
        except DeviceUnavailable as e:
            print(f"bench_collectives: {e}", file=sys.stderr, flush=True)
            return 1
    try:
        backends = {n: choose_backend(args.backend, args.device, n)
                    for n in counts}
    except ValueError as e:
        parser.error(str(e))

    obs_ledger.maybe_begin("bench_collectives", config=vars(args))
    points, knees, unmeasured, knee_reps = [], {}, {}, []
    for n in counts:
        pts, fits, errors, reps = sweep(n, backends[n], args.device, colls,
                                        sizes, args.repeats)
        points += pts
        for coll, fit in fits.items():
            knees.setdefault(coll, {})[str(n)] = fit
        for coll, err in errors.items():
            unmeasured.setdefault(coll, {})[str(n)] = {
                "backend": backends[n], "error": err}
            print(json.dumps({"collective": coll, "devices": n,
                              "backend": backends[n], "unmeasured": err}),
                  flush=True)
        if n == counts[-1]:
            knee_reps = reps

    ar_knee = knees.get("psum", {}).get(str(counts[-1]), {}).get(
        "knee_bytes")
    platform = "gpu" if args.device == "cuda" else "cpu"
    staged = {str(n): b == "gloo" and args.device == "cuda"
              for n, b in backends.items()}
    record = {
        "metric": "collective_allreduce_knee_bytes",
        "value": float(ar_knee or 0),
        "unit": "bytes" if ar_knee else "unavailable",
        "vs_baseline": 1.0,
        "detail": {
            "platform": platform,
            "device": describe_device(args.device),
            "chip": args.device == "cuda",
            "note": ("gloo on the card stages every tensor through host "
                     "memory: those curves are host-staged, not NCCL "
                     "curves" if any(staged.values()) else
                     "NCCL curves, a card a rank" if args.device == "cuda"
                     else "CPU curves (gloo on the host): never card "
                          "numbers"),
            "devices": counts,
            "backends": {str(n): b for n, b in backends.items()},
            "host_staged": staged,
            "sizes_bytes": sizes,
            "n_repeats": args.repeats,
            "repeats": knee_reps,
            "knees": knees,
            "unmeasured": unmeasured,
            "suggested_bucket_bytes": suggest_bucket_bytes(ar_knee),
            "points": points,
        },
    }
    print(json.dumps({k: v for k, v in record.items() if k != "detail"}
                     | {"detail": {k: v for k, v in
                                   record["detail"].items()
                                   if k != "points"}}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
        print(f"bench_collectives: wrote {args.json}", file=sys.stderr,
              flush=True)
    obs_ledger.end_global(rc=0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
