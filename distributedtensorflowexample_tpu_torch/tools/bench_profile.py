"""bench_profile — ResNet-20's step rate decomposed in one process (the
JAX package's root ``bench_profile.py``):

  measured(augment)     config 4's path (the crop and flip on the card)
  measured(no augment)  the same gather path, augment off
  roofline              ``tools.bench._roofline_probe``: the step body over
                        one fixed resident batch, no gather, no augment

  augment share   = 1 - rate_aug / rate_noaug
  input+dispatch  = 1 - rate_noaug / rate_roofline

  # on the card (the default device), at the JAX sizes:
  python -m distributedtensorflowexample_tpu_torch.tools.bench_profile
  # shrunken (tools.bench.TINY's 256-row split, B=64, one epoch a call):
  python -m distributedtensorflowexample_tpu_torch.tools.bench_profile --tiny
  python -m distributedtensorflowexample_tpu_torch.tools.bench_profile --device cpu --tiny

One JSON line each, in the JAX order: ``resnet20_profile_augment``,
``resnet20_traced_window``, ``resnet20_profile_no_augment``,
``resnet20_roofline`` and ``resnet20_attribution`` (value: rate_aug over
rate_roofline, unit ``measured/roofline``; the shares in its detail).
Each stage is fault-isolated, and the shares come from whatever
survived, computed from the unrounded rates each line records as
``detail.steps_per_sec`` (the errors ride in the attribution's detail;
exit 1).  The variants are built by ``tools.bench._make("resnet20",
"cifar10", ...)`` at lr 0.1 and timed by ``tools.bench._measure``.

The traced window is ONE steady call of the augment variant (its state
warm) under ``torch.profiler`` with the CPU and, on the card, the CUDA
activities, written as a Chrome trace in ``--trace_dir``; the profiler is
stopped before the next variant whatever happens.  Its detail has the
trace's file count and bytes (as the JAX line has) and the device time a
step by kind (``utils/profiling.kind_of``: what one reads off the JAX
trace), empty on the CPU.  No ``AnomalyHook`` runs in this process (the
bench drives the step without the training loop), so the window cannot
fire a ``step_time_regression``.

Each variant's line has the JAX bytes fields: ``bytes_per_step`` (raw)
and ``bytes_audit`` (its top 8 ops) of ``utils/profiling.audit_step``,
one call of a build of the variant's own made after its measurement (the
timed state is never audited), ``arith_intensity_flop_per_byte`` and
``arith_intensity_effective`` (FLOPs over raw and effective bytes),
``bw_roofline_steps_per_sec`` and ``bw_roofline_effective_steps_per_sec``
(``tools.bench.HBM_BYTES_PER_S`` over those bytes) and
``mfu_ceiling_at_bw`` / ``_effective`` (the MFU a step at that rate
would reach); the bandwidth fields are null on the CPU.

Where the port differs from the JAX harness, on purpose: no backend
probe and no watchdog (``--device cuda`` with no card prints the
unavailable attribution line and exits 1, never the CPU in its place);
the FLOPs are counted from the shapes (``utils/flops.py``), not taken
from XLA's ``cost_analysis`` (the detail's ``note`` says so); MFU is
that count a step times the rate over ``tools.bench.PEAK_FLOPS`` (null
on the CPU).  Each line carries
``detail.device`` and the variant's kernel launches (none: the step runs
the default ``--dequant_impl auto``, the CE pair and the fused optimizer
off, as in JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

NOTE_AUDITS = ("flops_per_step is counted from the shapes (utils/flops.py), "
               "not taken from XLA's cost_analysis")


def _emit(metric: str, value: float, detail: dict, unit: str =
          "steps/sec/chip", digits: int = 2) -> None:
    print(json.dumps({"metric": metric, "value": round(value, digits),
                      "unit": unit, "vs_baseline": 1.0, "detail": detail}),
          flush=True)


def _unavailable(why: str, device: dict | None = None) -> None:
    detail = {"error": why[:500]}
    if device is not None:
        detail["device"] = device
    print(json.dumps({"metric": "resnet20_attribution", "value": 0.0,
                      "unit": "unavailable", "vs_baseline": 0.0,
                      "detail": detail}), flush=True)


def attribution(rates: dict, errors: dict) -> dict | None:
    """The JAX closing line from whatever rates survived (None when
    neither share nor the ratio can be formed)."""
    detail: dict = {}
    if "augment" in rates and "no_augment" in rates:
        detail["augment_share"] = round(
            1 - rates["augment"] / rates["no_augment"], 4)
    if "no_augment" in rates and "roofline" in rates:
        detail["input_dispatch_share"] = round(
            1 - rates["no_augment"] / rates["roofline"], 4)
    if errors:
        detail["errors"] = dict(errors)
    both = "augment" in rates and "roofline" in rates
    if not (detail or both):
        return None
    return {"metric": "resnet20_attribution",
            "value": (round(rates["augment"] / rates["roofline"], 4)
                      if both else 0.0),
            "unit": "measured/roofline", "vs_baseline": 1.0,
            "detail": detail}


def bytes_fields(step, ds, state, flops: int, on_card: bool) -> dict:
    """The JAX variant line's bytes fields from one audited call of
    ``step`` (a build of its own): raw and effective bytes a step, the
    arithmetic intensities and, on the card, the bandwidth rooflines and
    the MFU ceilings at them."""
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        audit_step)
    cost, audit = audit_step(step, ds, state, flops=flops, top_k=8)
    out = {}
    for suffix, nbytes in (("", cost["bytes_accessed"]),
                           ("_effective", audit["bytes_effective_per_step"])):
        rate = bench.HBM_BYTES_PER_S / nbytes if on_card else None
        out[f"arith_intensity{suffix or '_flop_per_byte'}"] = round(
            flops / nbytes, 2)
        out[f"bw_roofline{suffix}_steps_per_sec"] = (
            round(rate, 1) if on_card else None)
        out[f"mfu_ceiling_at_bw{suffix}"] = (
            round(rate * flops / bench.PEAK_FLOPS, 5) if on_card else None)
    return {"bytes_per_step": cost["bytes_accessed"], "bytes_audit": audit,
            **out}


def traced_call(step, ds, state, trace_dir: str, device) -> tuple:
    """One call of ``step`` under ``torch.profiler`` (the CPU and, on the
    card, the CUDA activities), exported as a Chrome trace in
    ``trace_dir``: ``(state, seconds, device us by kind)``.  The profiler
    is stopped on every path out."""
    import torch

    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        _activities, _device_us, _on_device, kind_of)
    with torch.profiler.profile(activities=_activities(device)) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, next(ds))
        bench._block(metrics)
        dt = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    by_kind: dict = {}
    for e in prof.key_averages():
        if _on_device(e):
            k = kind_of(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + _device_us(e)
    return state, dt, by_kind


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the step runs (no card with cuda: exit 1)")
    p.add_argument("--unroll", type=int, default=195,
                   help="steps a call (195 = one epoch at batch 256)")
    p.add_argument("--steps", type=int, default=390)
    p.add_argument("--batch_per_chip", type=int, default=256)
    p.add_argument("--trace_dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "resnet_trace"))
    p.add_argument("--skip_trace", action="store_true")
    p.add_argument("--roofline_length", type=int, default=128,
                   help="steps a roofline repeat")
    p.add_argument("--tiny", action="store_true",
                   help="tools.bench.TINY's split, batch and repeats, one "
                        "epoch a call, two calls, an 8-step roofline")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            _unavailable(f"device unavailable: {e}")
            print(f"bench_profile: {e}", file=sys.stderr, flush=True)
            return 1
    if args.tiny:
        # Process-wide, as tools.bench --tiny: the split sizes _make reads.
        bench.TRAIN_N = dict(bench.TINY["TRAIN_N"])
        bench.REPEATS = bench.TINY["REPEATS"]
        args.batch_per_chip = bench.TINY["BATCH"]["resnet"]
        args.roofline_length = bench.TINY["ROOFLINE_LEN"]["resnet"]
        args.unroll = bench.TINY["TRAIN_N"]["cifar10"] // args.batch_per_chip
        args.steps = 2 * args.unroll

    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import (
        recorder as obs_recorder)
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.obs.trace import span
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)

    obs_recorder.maybe_install()
    obs_ledger.maybe_begin("bench_profile", config=vars(args))
    obs_serve.maybe_start()
    device = describe_device(args.device)
    mesh = make_mesh(args.device)
    on_card = mesh.device.type == "cuda"
    n = mesh.num_chips
    rates: dict = {}
    errors: dict = {}

    def attempt(name, fn):
        try:
            fn()
        except Exception as e:
            errors[name] = repr(e)
            traceback.print_exc()

    def run_variant(tag: str, aug: str) -> tuple:
        with span(f"profile_{tag}", unroll=args.unroll):
            line = bench._Line(on_card)
            step, ds, state, u = line.make(
                "resnet20", "cifar10", args.batch_per_chip, args.unroll,
                mesh, augment=aug, lr=0.1)
            best, reps, state = bench._measure(step, ds, state, args.steps,
                                               u)
        rates[tag] = best
        flops = train_flops_per_step("resnet20",
                                     args.batch_per_chip * mesh.size)
        detail = {"repeats": reps, "steps_per_sec": best, "unroll": u,
                  "flops_per_step": flops,
                  "mfu": (round(flops * best / n / bench.PEAK_FLOPS, 5)
                          if on_card else None),
                  "peak_flops": bench.PEAK_FLOPS,
                  "batch_per_chip": args.batch_per_chip,
                  "dequant": ds.dequant_impl or "none", "device": device,
                  "note": NOTE_AUDITS}
        attempt(f"bytes_{tag}", lambda: detail.update(bytes_fields(
            *line.make("resnet20", "cifar10", args.batch_per_chip, 1, mesh,
                       augment=aug, lr=0.1)[:3], flops, on_card)))
        line.attach(detail)
        _emit(f"resnet20_profile_{tag}", best / n, detail)
        return step, ds, state, u

    for tag, aug in (("augment", "cifar"), ("no_augment", "none")):
        box: list = []
        attempt(tag, lambda: box.append(run_variant(tag, aug)))
        if not box or tag != "augment" or args.skip_trace:
            continue
        step, ds, state, u = box[0]
        try:
            with span("trace_window", unroll=u):
                state, dt, by_kind = traced_call(step, ds, state,
                                                 args.trace_dir, mesh.device)
            files = [os.path.join(r, f)
                     for r, _, fs in os.walk(args.trace_dir) for f in fs]
            _emit("resnet20_traced_window", u / dt / n,
                  {"trace_dir": args.trace_dir, "trace_files": len(files),
                   "trace_bytes": sum(os.path.getsize(f) for f in files),
                   "steps_in_window": u,
                   "device_us_per_step_by_kind": {
                       k: round(v / u, 3) for k, v in sorted(
                           by_kind.items(), key=lambda kv: -kv[1])},
                   "device": device})
        except Exception as e:
            traceback.print_exc()
            print(json.dumps({
                "metric": "resnet20_traced_window", "value": 0.0,
                "unit": "unavailable", "vs_baseline": 0.0,
                "detail": {"error": f"profiler failed: {e!r}"[:400],
                           "device": device}}), flush=True)
        del step, ds, state

    def run_roofline():
        with span("roofline", length=args.roofline_length):
            roof = bench._roofline_probe(mesh, args.batch_per_chip,
                                         length=args.roofline_length,
                                         model_name="resnet20",
                                         sample=(32, 32, 3), lr=0.1)
        rates["roofline"] = max(roof)
        _emit("resnet20_roofline", max(roof) / n,
              {"repeats": roof, "steps_per_sec": max(roof),
               "device": device})

    attempt("roofline", run_roofline)
    line = attribution(rates, errors)
    if line is not None:
        line["detail"]["device"] = device
        print(json.dumps(line), flush=True)
    obs_ledger.end_global(rc=1 if errors else 0, errors=errors or None)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
