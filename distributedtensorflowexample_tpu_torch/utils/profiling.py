"""Where config 3's step time goes on the card.

    python -m distributedtensorflowexample_tpu_torch.utils.profiling \
        [--batch 64 256] [--steps 100] [--dequant_impl pallas ...]

Builds the main path's train step with ``Engine.build`` (synthetic MNIST
resident on the card, MnistCNN at full width, by default all three
kernel flags), warms it up, then for each batch size prints one JSON
line with:

- ``wall_ms_per_step``: host clock around ``--steps`` steps ending in
  ``torch.cuda.synchronize`` (no profiler attached);
- ``device_busy_ms_per_step``: the sum of every kernel's, memset's and
  copy's device time from ``torch.profiler`` over the same number of
  steps, and ``idle_share`` = 1 - busy / wall;
- ``top``: the largest device-time entries per step, ``top_host``: the
  largest host (CPU self) times per step under the profiler, and
  ``port_us_per_launch``: each port kernel's device time per launch.

Any flag of the trainer CLI (``config.py``) is accepted after the
script's own; the defaults are the trainer's plus the kernel flags.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.device import resolve_device
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec

#: Substrings of the port kernels' device names.
PORT_KERNELS = {"dequant": "dequant_gather_kernel", "ce_fwd": "ce_fwd_kernel",
                "ce_bwd": "ce_bwd_kernel", "sgd": "sgd_momentum_kernel"}
KERNEL_FLAGS = ["--dequant_impl", "pallas", "--pallas_ce", "true",
                "--fused_optimizer", "true"]


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _on_device(evt) -> bool:
    # Kernels, memsets and copies are CUDA-typed entries; the CPU-side
    # aten ops that launched them also carry their kernels' time, so
    # summing every entry would count each kernel twice.
    return evt.device_type == torch.autograd.DeviceType.CUDA


def profile_step(cfg, steps: int, warmup: int) -> dict:
    device = resolve_device(cfg.device)
    built = Engine(RunSpec("mnist_cnn", "mnist", cfg)).build(device)

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
    port = {}
    for name, sub in PORT_KERNELS.items():
        hits = [e for e in events if sub in e.key]
        calls = sum(e.count for e in hits)
        port[name] = (sum(_device_us(e) for e in hits) / calls
                      if calls else None)
    return {"batch": cfg.batch_size, "steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top": top, "top_host": top_host, "port_us_per_launch": port}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=50)
    args, rest = p.parse_known_args(argv)
    cfg = parse_flags(KERNEL_FLAGS + rest, learning_rate=0.05, momentum=0.9,
                      dataset="synthetic")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for batch in args.batch:
        cfg.batch_size = batch
        row = profile_step(cfg, args.steps, args.warmup)
        print(json.dumps({"gpu": gpu, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
