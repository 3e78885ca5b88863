"""bench — the headline harness: one JSON line per workload, the headline
(config 3, sync-SGD MNIST CNN, in steps/sec/chip) last (the JAX
package's root ``bench.py``, over the port's Engine).

  # on the card (the default device), at the full sizes:
  python -m distributedtensorflowexample_tpu_torch.tools.bench
  # shrunken (``TINY``: the sizes chip_smoke.py's phase HB runs):
  python -m distributedtensorflowexample_tpu_torch.tools.bench --tiny
  python -m distributedtensorflowexample_tpu_torch.tools.bench --device cpu --tiny

Workloads, in measurement order (the headline is measured first and
emitted last):

  config 3  mnist_cnn_sync    HEADLINE: unroll sweep, roofline probe,
                              the ``--dequant auto`` A/B over
                              ``DEQUANT_AB_IMPLS`` (``pallas``: the
                              CUDA dequant kernel)
  config 4  cifar_resnet20    crop and flip, unroll sweep, MFU
  config 2  mnist_cnn_async   local SGD, period 8
  config 1  mnist_softmax     momentum 0, lr 0.5, roofline probe
  variants  mnist_cnn pallas_ce / fused_sgd (the CUDA CE pair / SGD)

Each line keeps the JAX metric name, unit (``steps/sec/chip``), rounding
and detail keys: every repeat and ``spread_frac``, the unroll sweep, the
same-window roofline probe (``vs_roofline``: the measured rate over the
probe's, which runs the same step body ``length`` times over one fixed
resident batch, no gather, in this process), ``roofline_cost_per_step``.
A workload is measured best of ``REPEATS``; each repeat ends in
``torch.cuda.synchronize()`` on the metrics it returns.  The sizing is
module-level, as in JAX (``TRAIN_N``, ``BATCH``, ``MIN_STEPS``,
``ROOFLINE_LEN``, the sweep shapes, ``DEQUANT_AB_IMPLS``, ``REPEATS``);
``--tiny`` sets them to :data:`TINY`.

How the bench's optimizer is the trainer's: the port's ``RunSpec`` has no
``optimizer_fn`` seam, and needs none.  ``_make``'s ``RunConfig`` keeps
the defaults ``lr_schedule="constant"``, ``warmup_steps=0``,
``weight_decay=0``, with which ``training/optimizers.build_optimizer``
builds ``MomentumSGD`` at the bare float learning rate (plain SGD at
momentum 0; the CUDA SGD kernel with ``fused_opt``), the trainer's own
step program over flat buffers, whose state has one layout whatever the
schedule.

Where the port differs from the JAX harness, on purpose:

- (a) **No backend probe.**  The card sits behind no tunnel, so the
  subprocess probe, its retry budget and its jittered sleeps are gone.
  ``--device cuda`` (the default) with no card exits 1 with a message
  naming ``--device cuda``, before any line; it never measures the CPU
  in its place.
- (b) **Exit codes.**  The record-survival layers stay: the provisional
  line at start, the exactly-once final emission, the SIGTERM handler
  that emits the held measured headline (exit 143) and the watchdog for
  a call wedged inside CUDA (exit 3).  A run whose last
  line is a sentinel, or where any workload failed (its error under the
  headline's ``detail.errors``), exits 1: never a sentinel with exit 0.
- (c) **``vs_baseline`` reads no TPU number.**  ``BASELINE_SELF.json``
  is never read.  ``--baselines PATH`` names a file of the port's own
  records; a line's baseline is the newest record of its metric on this
  run's platform (``tools/bench_ratchet._platform``: ``gpu:<card>``).
  With none, ``vs_baseline`` is 1.0 and ``detail.baseline`` null.  Every
  line carries ``detail.device`` (``bench_ratchet.describe_device``: the
  card's name and power limit) and ``detail.platform``.
- (d) **FLOPs from the shapes** (``utils/flops.py``), not XLA's
  ``cost_analysis``, and **bytes from the dispatched ops**:
  ``roofline_cost_per_step`` and ``cost_per_step`` hold ``flops`` and
  ``bytes_accessed``, the raw bytes a step of
  ``utils/profiling.audit_step`` (every aten op's inputs at full size
  plus its outputs, XLA's convention), each taken on a build of its own
  (one call, after the line's measurement, never the timed state), and
  ``roofline_bytes_ratio`` is the probe's bytes over the measured step's,
  as in JAX.  MFU is FLOPs a step x steps/s a card over
  :data:`PEAK_FLOPS`, the H100 SXM dense bf16 tensor-core peak (the
  record names it and its source); on the CPU ``mfu`` is null.
- (e) **Kernel launches by line.**  Each line's ``detail.launches``
  (``ops/kernels.launch_counts()``) must equal ``detail.kernel_steps``:
  on the card, the steps (warm-up included) that the line's builds ran
  with each kernel requested; 0 on the CPU, where the wrappers run
  their plain versions.  A line whose kernel did not launch for every
  step is a failure, not a slow line.
- (f) **Flags, not environment variables**: ``--dequant``
  (``BENCH_DEQUANT``), ``--headline_only`` (``BENCH_HEADLINE_ONLY``),
  ``--tiny``; the watchdog's budget is the constant
  ``TOTAL_BUDGET_S`` (``BENCH_TOTAL_BUDGET_S``).
- (g) **Data**: the synthetic splits (``TRAIN_N`` rows) unless
  ``DATA_DIR`` (or ``_make``'s ``data_dir``) names a directory of real
  bytes (the synthetic split where they are missing); no default
  directory such as ``/tmp/data`` is read.
- (h) **Unroll is a window, not a fused program**: the port's indexed
  step runs ``unroll`` step bodies in a Python loop per call
  (``parallel/sync.indexed_step``), so the sweep measures the host's
  per-call overhead, not a compile-time fusion.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback

REPEATS = 3
#: The H100 SXM dense bf16 tensor-core peak, FLOP/s (NVIDIA's data sheet,
#: at the 700 W power limit): MFU's denominator.
PEAK_FLOPS = 989.4e12
PEAK_FLOPS_SOURCE = ("NVIDIA H100 SXM data sheet: dense BF16 tensor-core "
                     "peak, 989.4 TFLOP/s, at 700 W")
#: The H100 SXM5 80GB's HBM3 rate, bytes/s (NVIDIA's data sheet): the
#: bandwidth floor's denominator (``tools.bytes_audit``, the harnesses'
#: ``bw_roofline_*`` fields, ``chip_smoke.py``'s kernel bounds).
HBM_BYTES_PER_S = 3.35e12

# Workload sizing, module-level so tests and --tiny shrink the same
# main() path (the JAX harness's bench.py:46-58).
DATA_DIR = ""                                    # "" = synthetic splits
TRAIN_N = {"mnist": 60000, "cifar10": 50000}     # split sizes
BATCH = {"cnn": 256, "softmax": 100, "resnet": 256}   # per chip
MIN_STEPS = {"headline": 512, "resnet": 96}      # per measurement
ROOFLINE_LEN = {"headline": 256, "softmax": 2048, "resnet": 128}
HEADLINE_REST_UNROLLS = lambda spe: {16, spe, 4 * spe, 8 * spe}
RESNET_UNROLLS = lambda spe: {8, 64, spe}
#: In-step dequant kernel (``--dequant``): ``auto`` resolves per split and
#: A/Bs the alternatives below at the winning unroll.
DEQUANT = "auto"
DEQUANT_AB_IMPLS = ("onehot", "lut", "pallas")
HEADLINE_ONLY = False
#: Wall-clock budget of the measurement phase (the watchdog), seconds.
TOTAL_BUDGET_S = 5400.0

#: The shrunken sizes (``--tiny``; chip_smoke.py's phase HB): every line
#: and every code path, a few thousand steps in all.
TINY = {"REPEATS": 2,
        "TRAIN_N": {"mnist": 256, "cifar10": 256},
        "BATCH": {"cnn": 64, "softmax": 64, "resnet": 64},
        "MIN_STEPS": {"headline": 16, "resnet": 8},
        "ROOFLINE_LEN": {"headline": 16, "softmax": 16, "resnet": 8},
        "HEADLINE_REST_UNROLLS": lambda spe: {spe},
        "RESNET_UNROLLS": lambda spe: {spe},
        "DEQUANT_AB_IMPLS": ("pallas",)}

HEADLINE = "mnist_cnn_sync_steps_per_sec_per_chip"

# Flipped (permanently: the process is exiting) by the SIGTERM handler;
# print() on the shared writer raises "reentrant call" if the signal
# landed mid-write, os.write to the fd does not.
_EMIT_RAW = False


def _println(line: str) -> None:
    """One record line to stdout, signal-safe in _EMIT_RAW mode."""
    if _EMIT_RAW:
        buf = (line + "\n").encode()
        while buf:
            try:
                n = os.write(1, buf)
            except OSError:
                return
            buf = buf[n:]
    else:
        print(line, flush=True)


def _emit(metric: str, per_chip: float, baselines: dict, detail: dict,
          device: dict | None = None) -> None:
    """One measured line (the JAX ``_emit``), with ``detail.baseline``
    and, given ``device`` (``describe_device``), ``detail.device``."""
    from distributedtensorflowexample_tpu_torch.obs.anomaly import (
        spread_fraction)
    baseline = baselines.get(metric)
    if detail.get("repeats") and "spread_frac" not in detail:
        detail["spread_frac"] = round(spread_fraction(detail["repeats"]), 4)
    detail["baseline"] = baseline
    if device is not None:
        detail["device"] = device
    _println(json.dumps({
        "metric": metric,
        "value": round(per_chip, 2),
        "unit": "steps/sec/chip",
        "vs_baseline": round(per_chip / baseline, 4) if baseline else 1.0,
        "detail": detail,
    }))


def _unavailable(why: str, errors: dict | None = None,
                 provisional: bool = False,
                 device: dict | None = None) -> dict:
    """The sentinel headline (the JAX ``emit_unavailable``'s line, less
    the probe's ``probe_attempts`` and the TPU outage notes' ``see``):
    unit ``unavailable`` and value 0.0, never a measured 100% drop."""
    detail: dict = {"error": why[:500]}
    if provisional:
        detail["provisional"] = True
    if errors:
        detail["errors"] = {k: v[:300] for k, v in list(errors.items())}
    if device is not None:
        detail["device"] = device
    return {"metric": HEADLINE, "value": 0.0, "unit": "unavailable",
            "vs_baseline": 0.0, "detail": detail}


def _block(metrics: dict) -> None:
    """Wait for the card to finish the work behind ``metrics``."""
    import torch
    if any(isinstance(v, torch.Tensor) and v.is_cuda
           for v in metrics.values()):
        torch.cuda.synchronize()


def _measure(step, ds, state, steps: int, unroll: int,
             warmup_calls: int = 2,
             repeats: int | None = None) -> tuple[float, list, object]:
    """Best-of-``repeats`` (default REPEATS) steady-state rate; each
    repeat ends in a synchronize on its own final metrics, so queued work
    cannot pass for throughput.  One ``measure`` span a measurement,
    never a step."""
    from distributedtensorflowexample_tpu_torch.obs.trace import span
    with span("measure", steps=steps, unroll=unroll) as attrs:
        calls = max(1, steps // unroll)
        actual_steps = calls * unroll
        metrics: dict = {}
        for _ in range(warmup_calls):
            state, metrics = step(state, next(ds))
        _block(metrics)
        rates = []
        for _ in range(REPEATS if repeats is None else repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                state, metrics = step(state, next(ds))
            _block(metrics)
            rates.append(actual_steps / (time.perf_counter() - t0))
        attrs["best_steps_per_sec"] = round(max(rates), 1)
    return max(rates), [round(r, 1) for r in rates], state


def _sweep(unrolls, make_fn, steps_for, err_prefix: str, errors: dict):
    """Measure every unroll in ``unrolls``, largest first, each point
    fault-isolated into ``errors``.  Returns (best_rate, best_unroll,
    best_repeats, {unroll: repeats})."""
    sweep = {}
    best_overall, best_unroll, best_rates = 0.0, None, []
    for unroll in sorted(unrolls, reverse=True):
        try:
            step, ds, state, u = make_fn(unroll)
            if u != unroll:
                raise RuntimeError(f"factory changed unroll {unroll} -> {u}")
            best, rates, _ = _measure(step, ds, state, steps_for(u), u)
            sweep[str(u)] = rates
            if best > best_overall:
                best_overall, best_unroll, best_rates = best, u, rates
        except Exception as e:
            errors[f"{err_prefix}{unroll}"] = repr(e)
            traceback.print_exc()
    return best_overall, best_unroll, best_rates, sweep


def _make(model_name: str, dataset: str, batch_per_chip: int, unroll: int,
          mesh, *, momentum: float = 0.9, ce_impl: str = "xla",
          fused_opt: bool = False, augment: str = "none", lr: float = 0.05,
          sync: bool = True, async_period: int = 8,
          data_dir: str | None = None, dequant_impl: str = "auto",
          perm_fn=None, quantize: str = "auto"):
    """One knob configuration as an Engine declaration, the same
    construction ``Engine.run`` wires minus hooks: ``(step, ds, state,
    unroll)``.  ``input_fn`` carries the bench's data source (synthetic,
    or the real bytes of ``data_dir``/``DATA_DIR``); the float-LR
    optimizer comes from the config (module docstring).  ``perm_fn``
    injects an index tape (``DeviceDataset``), as the parity tests do;
    ``quantize`` is the resident split's storage (``--quantize``)."""
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.data.cifar10 import (
        load_cifar10)
    from distributedtensorflowexample_tpu_torch.data.mnist import load_mnist
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        Engine, RunSpec)

    def input_fn(cfg, split):
        load = load_mnist if dataset == "mnist" else load_cifar10
        # Resolved at call time, so tests can repoint DATA_DIR/TRAIN_N.
        root = data_dir if data_dir is not None else DATA_DIR
        return load(root, split, synthetic_size=TRAIN_N[dataset],
                    source="fallback" if root else "synthetic")

    cfg = RunConfig(batch_size=batch_per_chip, seed=0,
                    learning_rate=lr, momentum=momentum,
                    sync_mode="sync" if sync else "async",
                    async_period=async_period,
                    pallas_ce=(ce_impl == "pallas"),
                    fused_optimizer=fused_opt,
                    dequant_impl=dequant_impl, quantize=quantize,
                    device=mesh.device.type)
    spec = RunSpec(model=model_name, dataset=dataset, config=cfg,
                   augment=(augment == "cifar"), input_fn=input_fn)
    built = Engine(spec).build(mesh=mesh, unroll=unroll, perm_fn=perm_fn)
    return built.step, built.ds, built.state, built.unroll


def _roofline_probe(mesh, batch_per_chip: int, length: int = 256,
                    model_name: str = "mnist_cnn",
                    sample: tuple = (28, 28, 1), lr: float = 0.05,
                    momentum: float = 0.9,
                    cost_out: dict | None = None) -> list:
    """Pure device step rate: the train step body (``parallel/sync``'s,
    the measured step's own) ``length`` times over one FIXED resident
    batch: no gather, no dequant, no augment, one synchronize a repeat.
    The gap between this and the measured path is input and per-call
    overhead.  Run in the same process as the measurement it
    calibrates.  ``cost_out`` gets the per-step ``flops`` from the
    shapes (``utils/flops.py``) and ``bytes_accessed``, the raw bytes of
    one step body audited on a state of its own
    (``utils/profiling.audit_step``)."""
    import torch

    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        _build_step_fn)
    from distributedtensorflowexample_tpu_torch.training.optimizers import (
        build_optimizer)
    from distributedtensorflowexample_tpu_torch.training.state import (
        TrainState)
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)

    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        audit_step)

    global_batch = batch_per_chip * mesh.size
    x, y = make_synthetic(global_batch, sample, 10, seed=0)
    batch = {"image": torch.from_numpy(x).to(mesh.device),
             "label": torch.from_numpy(y).to(mesh.device)}
    cfg = RunConfig(batch_size=batch_per_chip, seed=0, learning_rate=lr,
                    momentum=momentum)
    fresh_state = lambda: TrainState.create(
        build_model(model_name, dropout=0.5, mesh=mesh),
        lambda m: build_optimizer(cfg, m), 0, mesh.device, mesh=mesh)
    state = fresh_state()
    inner = _build_step_fn(mesh=mesh)
    if cost_out is not None:
        flops = train_flops_per_step(model_name, global_batch)
        cost_out.update(audit_step(
            lambda st, b: (st, inner(st, b)), itertools.repeat(batch),
            fresh_state(), flops=flops)[0])

    def probe() -> dict:
        metrics: dict = {}
        for _ in range(length):
            metrics = inner(state, batch)
        _block(metrics)
        return metrics

    probe()
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        probe()
        rates.append(length / (time.perf_counter() - t0))
    return [round(r, 1) for r in rates]


def _load_baselines(path: str, platform: str) -> dict:
    """``{metric: value}``: the newest steps/sec/chip record of each
    metric in ``path`` (the port's own records, ``bench_ratchet``'s
    reader) whose platform is ``platform``; ``{}`` without a path."""
    if not path:
        return {}
    from distributedtensorflowexample_tpu_torch.tools import bench_ratchet
    return {r["metric"]: float(r["value"])
            for r in bench_ratchet.load_records([path])
            if r.get("unit") == "steps/sec/chip"
            and bench_ratchet._platform(r) == platform}


class _Line:
    """One line's builds and kernel launches: :meth:`make` is ``_make``
    that remembers which kernels each build requested and its state;
    :meth:`attach` puts the launches since the line began, and the steps
    those builds ran with each kernel, in the line's detail."""

    def __init__(self, on_card: bool):
        from distributedtensorflowexample_tpu_torch.ops import kernels
        self._kernels = kernels
        self._on_card = on_card
        self._builds: list = []
        kernels.reset_launch_counts()

    def make(self, *args, **kw):
        step, ds, state, u = _make(*args, **kw)
        want = set()
        if kw.get("ce_impl") == "pallas":
            want |= {"ce_fwd", "ce_bwd"}
        if kw.get("fused_opt"):
            want.add("sgd")
        if getattr(ds, "dequant_impl", None) == "pallas":
            want.add("dequant")
        self._builds.append((want, state))
        return step, ds, state, u

    def attach(self, detail: dict) -> None:
        """Raises if a kernel launched other than once a step it was
        requested for (on the CPU: at all)."""
        got = self._kernels.launch_counts()
        expect = {k: sum(int(s.step) for want, s in self._builds
                         if k in want) if self._on_card else 0
                  for k in got}
        detail["launches"] = got
        detail["kernel_steps"] = expect
        if got != expect:
            raise RuntimeError(f"kernel launches {got} are not one a step "
                               f"of the builds that requested them "
                               f"({expect})")


def _arm_watchdog(budget_s: float, fire, _exit=os._exit) -> threading.Event:
    """Daemon timer that calls ``fire()`` and hard-exits (code 3) unless
    the returned Event is set within ``budget_s``: a call wedged inside
    CUDA never returns to the main thread, which holds no Python lock
    while it waits there.  ``os._exit``: normal shutdown would join the
    wedged call."""
    done = threading.Event()

    def watch():
        if not done.wait(budget_s):
            try:
                fire()
                sys.stdout.flush()
                try:
                    from distributedtensorflowexample_tpu_torch.obs.recorder \
                        import dump_global
                    dump_global("watchdog")
                except Exception:
                    pass
            finally:
                _exit(3)

    threading.Thread(target=watch, daemon=True, name="bench-watchdog").start()
    return done


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the workloads run (no card with cuda: exit "
                        "1; never the CPU in its place)")
    p.add_argument("--dequant", default="auto",
                   choices=("auto", "affine", "onehot", "lut", "pallas"),
                   help="in-step dequant impl for the resident splits; "
                        "auto resolves per split AND A/Bs the "
                        "alternatives at the winning unroll, recording "
                        "the selection in the headline detail")
    p.add_argument("--headline_only", action="store_true",
                   help="measure the headline and its roofline, then "
                        "stop: no sweep's second half, no A/B, no side "
                        "workloads")
    p.add_argument("--baselines", default="",
                   help="a file of the port's own records: each line's "
                        "vs_baseline divides by the newest record of its "
                        "metric on this platform (none: 1.0)")
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken sizes of TINY (every line, a few "
                        "thousand steps)")
    return p


def main(argv: list[str] | None = None) -> int:
    """Each workload is fault-isolated: one failing config must not stop
    the later lines, above all the headline, which is always the last
    line emitted.  Record-survival layers: a provisional sentinel at
    start; the SIGTERM handler emits the held measured headline (or the
    sentinel) and exits 143; the watchdog covers a main thread wedged
    inside a CUDA call."""
    global DEQUANT, HEADLINE_ONLY
    parser = _parser()
    args = parser.parse_args(argv)
    if args.baselines and not os.path.isfile(args.baselines):
        parser.error(f"--baselines {args.baselines!r}: no such file")
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            print(f"bench: {e}", file=sys.stderr, flush=True)
            return 1
    if args.tiny:
        globals().update(TINY)
    DEQUANT, HEADLINE_ONLY = args.dequant, args.headline_only

    errors: dict = {}
    # The headline is measured FIRST and emitted LAST; in between, the
    # finished line waits here, so a watchdog or SIGTERM during a later
    # workload emits the REAL measured headline.
    held_headline: dict = {}
    ctx: dict = {"device": None, "baselines": {}}
    # Exactly-once guard on the final emission; RLock: the SIGTERM
    # handler runs in the main thread and may interrupt it holding it.
    final_guard = threading.RLock()
    final_done = [False]

    def final_once(fn) -> None:
        with final_guard:
            if final_done[0]:
                return
            fn()
            if not _EMIT_RAW:
                sys.stdout.flush()
            final_done[0] = True

    def emit_unavailable(why: str, errors_: dict | None = None,
                         provisional: bool = False) -> None:
        _println(json.dumps(_unavailable(why, errors_, provisional,
                                         ctx["device"])))

    def fire_final(tag: str, why: str) -> None:
        """The line that must survive an abnormal death: the held
        measured headline if one exists, else the sentinel."""
        if held_headline:
            detail = dict(held_headline["detail"])
            detail["errors"] = {k: v[:300] for k, v in list(errors.items())}
            detail[tag] = why
            _emit(HEADLINE, held_headline["per_chip"], ctx["baselines"],
                  detail, ctx["device"])
        else:
            emit_unavailable(why, errors)

    emit_unavailable(
        "provisional: tools.bench started and was killed before it could "
        "emit a real record (measurements supersede this line)",
        provisional=True)
    t_start = time.time()

    def on_sigterm(signum, frame):
        # Every write here goes through os.write (_EMIT_RAW); the bounded
        # acquire: a watchdog wedged mid-print on a buffer the interrupted
        # main thread holds must not hang this handler.
        global _EMIT_RAW
        _EMIT_RAW = True
        try:
            got = final_guard.acquire(timeout=5)
            try:
                os.write(1, b"\n")      # end a line the signal tore
                emit = lambda: fire_final(
                    "sigterm",
                    f"sigterm at t+{time.time() - t_start:.0f}s: killed by "
                    "the outer harness; lines above this one are valid "
                    "completed measurements")
                if got:
                    final_once(emit)
                else:
                    emit()
            finally:
                if got:
                    final_guard.release()
            try:
                from distributedtensorflowexample_tpu_torch.obs.recorder \
                    import dump_global
                dump_global("sigterm")
            except Exception:
                pass
        finally:
            os._exit(143)

    install = threading.current_thread() is threading.main_thread()
    prev_term = signal.signal(signal.SIGTERM, on_sigterm) if install else None
    try:
        rc = _main_run(args, errors, held_headline, ctx, emit_unavailable,
                       final_once, fire_final)
    finally:
        if install:
            signal.signal(signal.SIGTERM,
                          prev_term if prev_term is not None
                          else signal.SIG_DFL)
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    obs_ledger.end_global(rc=rc, errors=errors or None)
    return rc


def _main_run(args, errors: dict, held_headline: dict, ctx: dict,
              emit_unavailable, final_once, fire_final) -> int:
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import (
        recorder as obs_recorder)
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        _platform, describe_device)
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)
    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        audit_step)

    obs_recorder.maybe_install(sigterm=False)
    obs_ledger.maybe_begin("bench", config={
        "headline_only": HEADLINE_ONLY, "dequant": DEQUANT,
        "repeats": REPEATS, "device": args.device, "tiny": args.tiny})
    obs_serve.maybe_start()
    platform = "gpu" if args.device == "cuda" else "cpu"
    device = ctx["device"] = describe_device(args.device)
    baselines = ctx["baselines"] = _load_baselines(
        args.baselines, _platform({"detail": {"device": device,
                                              "platform": platform}}))

    def fire_watchdog():
        final_once(lambda: fire_final(
            "watchdog",
            f"watchdog: measurement phase exceeded {TOTAL_BUDGET_S:.0f}s"
            " — a call blocked without returning; any lines above are "
            "valid completed measurements"))

    watchdog_done = _arm_watchdog(TOTAL_BUDGET_S, fire_watchdog)
    try:
        from distributedtensorflowexample_tpu_torch.parallel.mesh import (
            make_mesh)
        mesh = make_mesh(args.device)
    except Exception as e:
        watchdog_done.set()
        final_once(lambda: emit_unavailable(f"device unavailable: {e!r}"))
        return 1
    on_card = mesh.device.type == "cuda"
    num_chips = mesh.num_chips
    shared = {"platform": platform}

    def attempt(name, fn):
        try:
            fn()
        except Exception as e:
            errors[name] = repr(e)
            traceback.print_exc()

    if on_card:
        # Every source up front, in parallel (else each builds at its
        # first launch, inside a measurement's warm-up).
        from distributedtensorflowexample_tpu_torch.ops.kernels import (
            build as kbuild)
        attempt("kernel_build", kbuild.build)

    def attach_roofline(detail, best, name, batch_per_chip, **roofline_kw):
        """Same-window probe and the measured/roofline ratio (max of the
        probe's repeats), shared by every line that carries it."""
        roof: list = []
        cost: dict = {}
        attempt(name, lambda: roof.extend(
            _roofline_probe(mesh, batch_per_chip, cost_out=cost,
                            **roofline_kw)))
        if roof:
            detail["roofline_probe"] = roof
            detail["vs_roofline"] = round(best / max(roof), 4)
        if cost:
            detail["roofline_cost_per_step"] = cost
            # With the measured step's bytes also present, the bytes
            # ratio bounds the bandwidth-bound share of the vs_roofline
            # gap in the same window (the JAX line's).
            mcost = detail.get("cost_per_step") or {}
            if mcost.get("bytes_accessed") and cost.get("bytes_accessed"):
                detail["roofline_bytes_ratio"] = round(
                    cost["bytes_accessed"] / mcost["bytes_accessed"], 4)

    def run_simple(metric, model, dataset, batch_per_chip, unroll, steps,
                   extra_detail=None, roofline_kw=None, attach_cost=False,
                   **make_kw):
        """Build, measure and emit one workload's line.  ``attach_cost``
        adds the measured step's per-step flops and bytes, audited on a
        build of its own (through the line, so its steps count), after
        the measurement."""
        line = _Line(on_card)
        step, ds, state, u = line.make(model, dataset, batch_per_chip,
                                       unroll, mesh, dequant_impl=DEQUANT,
                                       **make_kw)
        best, rates, _ = _measure(step, ds, state, steps, u)
        detail = {"repeats": rates, "unroll": u,
                  "batch_per_chip": batch_per_chip,
                  "dequant": ds.dequant_impl or "none",
                  **(extra_detail or {}), **shared}
        cost: dict = {}
        if attach_cost:
            def audit():
                own = line.make(model, dataset, batch_per_chip, 1, mesh,
                                dequant_impl=DEQUANT, **make_kw)
                cost.update(audit_step(*own[:3], flops=train_flops_per_step(
                    model, batch_per_chip * mesh.size))[0])
            attempt(f"cost_{metric}", audit)
        line.attach(detail)
        if cost:
            detail["cost_per_step"] = cost
        if roofline_kw is not None:
            attach_roofline(detail, best, f"roofline_{metric}",
                            batch_per_chip, **roofline_kw)
        _emit(metric, best / num_chips, baselines, detail, device)

    def config4():
        b_rn = BATCH["resnet"]
        spe_cifar = TRAIN_N["cifar10"] // (b_rn * mesh.size)
        rn_dequant: dict = {}
        line = _Line(on_card)

        def mk(unroll):
            step, ds, state, u = line.make(
                "resnet20", "cifar10", b_rn, unroll, mesh, augment="cifar",
                lr=0.1, dequant_impl=DEQUANT)
            rn_dequant["dequant"] = ds.dequant_impl or "none"
            return step, ds, state, u

        best_overall, best_unroll, best_rates, sweep = _sweep(
            RESNET_UNROLLS(spe_cifar), mk,
            lambda u: max(MIN_STEPS["resnet"], 2 * u),
            "resnet_sweep_", errors)
        if best_unroll is None:
            return      # every point failed; the errors ride the headline
        flops = train_flops_per_step("resnet20", b_rn * mesh.size)
        per_chip = best_overall / num_chips
        mfu = flops * per_chip / PEAK_FLOPS if on_card else None
        detail = {"repeats": best_rates, "best_unroll": best_unroll,
                  "unroll_sweep": sweep, "batch_per_chip": b_rn,
                  "dequant": rn_dequant.get("dequant", "none"),
                  "flops_per_step": flops,
                  "mfu": round(mfu, 4) if mfu is not None else None,
                  "peak_flops": PEAK_FLOPS,
                  "peak_flops_source": PEAK_FLOPS_SOURCE, **shared}
        line.attach(detail)
        attach_roofline(detail, best_overall, "roofline_resnet", b_rn,
                        length=ROOFLINE_LEN["resnet"], model_name="resnet20",
                        sample=(32, 32, 3), lr=0.1)
        _emit("cifar_resnet20_steps_per_sec_per_chip", per_chip, baselines,
              detail, device)

    b_cnn, b_sm = BATCH["cnn"], BATCH["softmax"]
    spe = TRAIN_N["mnist"] // (b_cnn * mesh.size)
    spe_softmax = TRAIN_N["mnist"] // (b_sm * mesh.size)

    # --- config 3 HEADLINE: MNIST CNN sync, unroll sweep ----------------
    # Measured FIRST, emitted LAST; the likely-best point (the deepest
    # window) first, its same-window roofline right after it.
    dequant_box: dict = {}
    head = _Line(on_card)

    def mk_headline(unroll):
        step, ds, state, u = head.make("mnist_cnn", "mnist", b_cnn, unroll,
                                       mesh, dequant_impl=DEQUANT)
        dequant_box["dequant"] = ds.dequant_impl or "none"
        return step, ds, state, u

    steps_for = lambda u: max(MIN_STEPS["headline"], u * 4)
    best_overall, best_unroll, best_rates, sweep = _sweep(
        {16 * spe}, mk_headline, steps_for, "sweep_", errors)
    headline_detail = {"repeats": best_rates, "best_unroll": best_unroll,
                       "unroll_sweep": sweep, "batch_per_chip": b_cnn,
                       **shared}
    if HEADLINE_ONLY:
        headline_detail["headline_only"] = True

    def hold_best(b, u, r):
        """Record (b, u, r) as the held headline, then re-probe the
        roofline (the ratio means something only within one window; the
        stale keys go first)."""
        nonlocal best_overall, best_unroll, best_rates
        best_overall, best_unroll, best_rates = b, u, r
        headline_detail["repeats"] = r
        headline_detail["best_unroll"] = u
        if "dequant" in dequant_box:
            headline_detail["dequant"] = dequant_box["dequant"]
        headline_detail.pop("roofline_probe", None)
        headline_detail.pop("vs_roofline", None)
        held_headline["per_chip"] = b / num_chips
        held_headline["detail"] = headline_detail
        attach_roofline(headline_detail, b, "roofline", b_cnn,
                        length=ROOFLINE_LEN["headline"])

    if best_unroll is not None:
        hold_best(best_overall, best_unroll, best_rates)

    if not HEADLINE_ONLY:
        b2, u2, r2, s2 = _sweep(HEADLINE_REST_UNROLLS(spe), mk_headline,
                                steps_for, "sweep_", errors)
        sweep.update(s2)    # the same dict as headline_detail's
        if u2 is not None and b2 > best_overall:
            hold_best(b2, u2, r2)

        def dequant_ab():
            """Each ALTERNATIVE dequant impl in the headline config at
            the winning unroll (the resolved default's rate is the held
            headline), the fastest confirmed at the headline's own step
            count before it replaces the held line."""
            base = dequant_box.get("dequant", "affine")
            ab: dict = {}
            promote = None
            for impl in DEQUANT_AB_IMPLS:
                if impl == base:
                    continue
                try:
                    step, ds, state, u = head.make(
                        "mnist_cnn", "mnist", b_cnn, best_unroll, mesh,
                        dequant_impl=impl)
                    ran = ds.dequant_impl or impl
                    b, rates, state = _measure(
                        step, ds, state, max(MIN_STEPS["headline"], u), u)
                    ab[ran] = rates
                    if b > best_overall and (
                            promote is None or b > promote[1]):
                        promote = (ran, b, u, step, ds, state)
                except Exception as e:
                    errors[f"dequant_ab_{impl}"] = repr(e)
                    traceback.print_exc()
            headline_detail["dequant_ab"] = ab
            if promote is not None:
                ran, _b_thin, u, step, ds, state = promote
                try:
                    b2, r2, _ = _measure(step, ds, state, steps_for(u), u)
                    if b2 > best_overall:
                        dequant_box["dequant"] = ran
                        hold_best(b2, u, r2)
                except Exception as e:
                    errors["dequant_ab_confirm"] = repr(e)
                    traceback.print_exc()

        if (DEQUANT == "auto" and best_unroll is not None
                and dequant_box.get("dequant") != "none"):
            attempt("dequant_ab", dequant_ab)

    # The headline's builds are done: its launches, before the side
    # workloads reset the counts.
    attempt("headline_launches", lambda: head.attach(headline_detail))

    if not HEADLINE_ONLY:
        attempt("resnet20", config4)
        attempt("cnn_async", lambda: run_simple(
            "mnist_cnn_async_steps_per_sec_per_chip", "mnist_cnn",
            "mnist", b_cnn, 4 * spe, 8 * spe,
            extra_detail={"async_period": 8}, sync=False))
        attempt("softmax", lambda: run_simple(
            "mnist_softmax_steps_per_sec_per_chip", "softmax", "mnist",
            b_sm, 16 * spe_softmax, 32 * spe_softmax, momentum=0.0,
            lr=0.5, attach_cost=True,
            roofline_kw={"model_name": "softmax", "momentum": 0.0,
                         "lr": 0.5, "length": ROOFLINE_LEN["softmax"]}))
        attempt("pallas_ce", lambda: run_simple(
            "mnist_cnn_sync_pallas_ce_steps_per_sec_per_chip",
            "mnist_cnn", "mnist", b_cnn, 4 * spe, 8 * spe,
            ce_impl="pallas"))
        attempt("fused_sgd", lambda: run_simple(
            "mnist_cnn_sync_fused_sgd_steps_per_sec_per_chip",
            "mnist_cnn", "mnist", b_cnn, 4 * spe, 8 * spe,
            fused_opt=True))

    if best_unroll is None:
        watchdog_done.set()
        final_once(lambda: emit_unavailable(
            "every headline sweep point failed (no measurement; read "
            "detail.errors for the per-point failures)", errors))
        return 1
    if errors:      # attached last, so a side workload's failure shows too
        headline_detail["errors"] = errors
    # Disarm BEFORE the emit: a lapse between the two would print a
    # second final line after the headline.
    watchdog_done.set()
    final_once(lambda: _emit(HEADLINE, best_overall / num_chips, baselines,
                             headline_detail, device))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
