"""Trace capture, and where a training step's time goes on the card.

:class:`ProfilerHook` (the JAX package's ``utils/profiling.ProfilerHook``,
armed by ``--profile_dir``) traces a steady-state window of the live
loop with ``torch.profiler``.  The rest of the module is a profiler of
the train step:

    python -m distributedtensorflowexample_tpu_torch.utils.profiling \
        [--model mnist_cnn | mnist_cnn_async | lm_base | resnet20] \
        [--batch 64 256] [--steps 100] [--warmup 50] [--dequant_impl ...]

Builds the train step with ``Engine.build`` from the trainer's own config
(``build_config``) plus the kernel flags: for ``mnist_cnn`` (the default)
config 3's, synthetic MNIST resident on the card, at B=64 and 256 with
all three kernel flags; for ``lm_base`` ``trainer_lm``'s, the token split
resident on the card, at B=16 with ``--pallas_ce`` and
``--fused_optimizer`` (and ``--bucket_grads ""``, which the fused apply
needs); for ``resnet20`` config 4's
(``trainer_mirrored_cifar``: weight decay, the crop and flip), synthetic
CIFAR-10 resident on the card, at B=128 with ``--dequant_impl pallas``
and ``--pallas_ce`` (weight decay rules out the SGD kernel); for
``mnist_cnn_async`` config 2's (``trainer_ps_mnist``: async local SGD,
one worker) at B=64 with the same two flags (the fused apply is refused
in async mode).  It warms the step up, then for each batch size
prints one JSON line with:

- ``wall_ms_per_step``: host clock around ``--steps`` steps ending in
  ``torch.cuda.synchronize`` (no profiler attached);
- ``device_busy_ms_per_step``: the sum of every kernel's, memset's and
  copy's device time from ``torch.profiler`` over the same number of
  steps, and ``idle_share`` = 1 - busy / wall;
- ``top``: the largest device-time entries per step, ``top_host``: the
  largest host (CPU self) times per step under the profiler,
  ``by_kind``: device time and launches per step by kind of kernel
  (``kind_of``: matrix products, the port's kernels, elementwise and
  copies, reductions, softmax, other),
  ``port_us_per_launch``: each port kernel's device time per launch, and
  ``port_launches_per_step``.

Any flag of the trainer CLI (``config.py``) is accepted after the
script's own.

:func:`collective_ms` times one collective of each kind (all-reduce,
reduce-scatter, all-gather) on a mesh's ranks (``chip_smoke.py`` calls it
in its two gloo ranks, for the replication modes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from distributedtensorflowexample_tpu_torch.device import resolve_device
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.training.hooks import Hook


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class ProfilerHook(Hook):
    """Trace a window of live training steps.

    Starts after step ``start_step`` completes and stops once at least
    ``num_steps`` further steps have run, so the window holds steady-state
    steps only (never the first step's warm-up, given ``start_step`` > 0);
    with ``K`` steps a call the window rounds up to whole calls.  A resume
    that lands inside or past the window slides it forward, and a window
    is captured once.  The loop synchronizes the card before the hook
    starts and stops the profiler (``needs_sync``).  Each boundary inside
    the window opens a ``ProfilerStep#<n>`` span, ``n`` the first step of
    the call.  Each rank writes its own trace:
    ``<logdir>/rank<rank>/trace_<first>_<last>.json``."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 5,
                 rank: int = 0, device: torch.device | str = "cpu"):
        self._dir = os.path.join(logdir, f"rank{rank}")
        self._start = max(0, start_step)
        self._stop = self._start + max(1, num_steps)
        self._device = torch.device(device)
        self._prof = None
        self._span = None
        self._first = None
        self._done = False
        self.path = None

    def _window(self, step: int) -> tuple:
        if self._prof is None and step > self._start:
            width = self._stop - self._start
            return step, step + width
        return self._start, self._stop

    def needs_sync(self, step) -> bool:
        if self._done:
            return False
        start, stop = self._window(step)
        if self._prof is None:
            return start <= step < stop
        return step >= stop

    def _mark(self, step: int) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._span = torch.profiler.record_function(
            f"ProfilerStep#{step + 1}")
        self._span.__enter__()

    def after_step(self, step, state, metrics) -> bool:
        if self._done:
            return False
        self._start, self._stop = self._window(step)
        if self._prof is None and self._start <= step < self._stop:
            self._prof = torch.profiler.profile(
                activities=_activities(self._device))
            self._prof.start()
            self._first = step + 1
            self._mark(step)
        elif self._prof is not None and step >= self._stop:
            self._finish(step)
        elif self._prof is not None:
            self._mark(step)
        return False

    def _finish(self, last: int) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        self.path = os.path.join(self._dir,
                                 f"trace_{self._first}_{last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True

    def end(self, state) -> None:
        if self._prof is not None:      # the loop stopped inside the window
            self._finish(int(state.step))

#: Substrings of the port kernels' device names.
PORT_KERNELS = {"dequant": "dequant_gather_kernel", "ce_fwd": "ce_fwd_kernel",
                "ce_bwd": "ce_bwd_kernel", "sgd": "sgd_momentum_kernel"}
KERNEL_FLAGS = ["--dequant_impl", "pallas", "--pallas_ce", "true",
                "--fused_optimizer", "true"]
MODELS = ("mnist_cnn", "mnist_cnn_async", "lm_base", "resnet20")


def workload(model: str, argv: list) -> tuple:
    """``(spec, default batches)`` for ``--model``: the trainer's config
    with the kernel flags, then ``argv``."""
    from distributedtensorflowexample_tpu_torch.engine import RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_lm, trainer_mirrored_cifar, trainer_ps_mnist,
        trainer_sync_mnist)
    if model == "mnist_cnn":
        cfg = trainer_sync_mnist.build_config(
            KERNEL_FLAGS + ["--dataset", "synthetic"] + argv)
        return RunSpec(model, "mnist", cfg), [64, 256]
    if model == "mnist_cnn_async":
        cfg = trainer_ps_mnist.build_config(
            ["--dequant_impl", "pallas", "--pallas_ce", "true",
             "--dataset", "synthetic"] + argv)
        return RunSpec("mnist_cnn", "mnist", cfg), [64]
    if model == "lm_base":
        size, cfg = trainer_lm.build_config(
            ["--size", model, "--pallas_ce", "true", "--fused_optimizer",
             "true", "--bucket_grads", ""] + argv)
        return RunSpec(size, "lm", cfg), [16]
    if model == "resnet20":
        cfg = trainer_mirrored_cifar.build_config(
            ["--dequant_impl", "pallas", "--pallas_ce", "true",
             "--dataset", "synthetic"] + argv)
        return RunSpec(model, "cifar10", cfg, augment=True), [128]
    raise ValueError(f"unknown model {model!r} (one of {MODELS})")


#: (kind, substrings of the device names that select it), first match wins.
KINDS = (
    ("port", tuple(PORT_KERNELS.values())),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("elementwise_copy", ("elementwise", "copy", "fill", "Memset",
                          "Memcpy")),
)


def kind_of(name: str) -> str:
    for kind, subs in KINDS:
        if any(sub in name for sub in subs):
            return kind
    return "other"


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _on_device(evt) -> bool:
    # Kernels, memsets and copies are CUDA-typed entries; the CPU-side
    # aten ops that launched them also carry their kernels' time, so
    # summing every entry would count each kernel twice.
    return evt.device_type == torch.autograd.DeviceType.CUDA


def profile_step(spec, steps: int, warmup: int) -> dict:
    from distributedtensorflowexample_tpu_torch.engine import Engine
    cfg = spec.config
    device = resolve_device(cfg.device)
    built = Engine(spec).build(Mesh(device))

    def run(n):
        for _ in range(n):
            built.step(built.state, next(built.ds))
            built.ds.prefetch()
        torch.cuda.synchronize(device)

    run(warmup)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(steps)
    averages = prof.key_averages()
    events = [e for e in averages if _on_device(e)]
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / steps
    events.sort(key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "us_per_step": _device_us(e) / steps,
            "calls_per_step": e.count / steps} for e in events[:10]]
    host = sorted((e for e in averages if not _on_device(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    top_host = [{"name": e.key[:60],
                 "self_cpu_us_per_step": e.self_cpu_time_total / steps,
                 "calls_per_step": e.count / steps} for e in host[:10]]
    by_kind: dict = {}
    for e in events:
        k = by_kind.setdefault(kind_of(e.key), {"us_per_step": 0.0,
                                                "launches_per_step": 0.0})
        k["us_per_step"] += _device_us(e) / steps
        k["launches_per_step"] += e.count / steps
    port, port_calls = {}, {}
    for name, sub in PORT_KERNELS.items():
        hits = [e for e in events if sub in e.key]
        calls = sum(e.count for e in hits)
        port[name] = (sum(_device_us(e) for e in hits) / calls
                      if calls else None)
        port_calls[name] = calls / steps
    return {"model": spec.model, "sync_mode": cfg.sync_mode,
            "batch": cfg.batch_size, "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top": top, "top_host": top_host, "by_kind": by_kind,
            "port_us_per_launch": port,
            "port_launches_per_step": port_calls}


def collective_ms(mesh, numel: int, iters: int) -> dict:
    """Host milliseconds per gradient collective of each kind on this
    rank's device, back to back and synchronized: an all-reduce of
    ``numel`` float32, a reduce-scatter of ``numel`` to ``numel / D``,
    an all-gather of ``numel / D`` to ``numel`` (the sizes a step's
    buffers give them; uncounted).  Every rank of ``mesh`` calls it."""
    full = torch.zeros(numel - numel % mesh.size, device=mesh.device)
    row = full[:full.numel() // mesh.size].clone()
    calls = {"all-reduce": lambda: mesh.all_reduce(full, counted=False),
             "reduce-scatter": lambda: mesh.reduce_scatter(full,
                                                           counted=False),
             "all-gather": lambda: mesh.all_gather_into(row, counted=False)}
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)
    out = {}
    for kind, call in calls.items():
        for _ in range(2):
            call()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        sync()
        out[kind] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mnist_cnn", choices=MODELS)
    p.add_argument("--batch", type=int, nargs="+", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=50)
    args, rest = p.parse_known_args(argv)
    spec, batches = workload(args.model, rest)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for batch in args.batch or batches:
        spec.config.batch_size = batch
        row = profile_step(spec, args.steps, args.warmup)
        print(json.dumps({"gpu": gpu, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
