"""Timing of the port's kernels on the card: host time per call, device
time per call and the card's launch floor.

    python -m distributedtensorflowexample_tpu_torch.utils.kernel_timing \\
        [--base DIR]

Three yardsticks, all by CUDA events on the current stream:

- :func:`host_us`: the mean time per call of back-to-back calls from
  Python.  For a kernel shorter than its wrapper's host path this is the
  wrapper's host cost per call, which every training step pays.
- :func:`device_us`: N calls captured in one CUDA graph and replayed; the
  mean device time per call with the host out of the way (the kernel's
  run plus the gap between two dependent launches).
- :func:`floor_device_us`: :func:`device_us` of PyTorch's smallest kernel,
  a 1-element ``zero_()``: the card's launch floor under the same method.
  It is a measurement only; the port never calls it.

Run as a script it prints one JSON line per source with each kernel's
registers and spills from ``ptxas`` (when the script built it), then one
per kernel and shape for the dequant and cross-entropy kernels, each
beside its one-call PyTorch counterpart, timed through the package's
public wrappers: dequant at B = 64, 256 and 1000, cross-entropy forward
and backward at [64, 10], [256, 10] and the LM head's [2048, 250].
Those wrappers have kept their names and signatures since the port
began, so the script times whichever
``distributedtensorflowexample_tpu_torch`` is on the path.  ``--base DIR``
uses that: it runs the script on the package in ``DIR`` (a checkout of
another commit, e.g. ``git archive <commit> | tar -x -C DIR``) and on
this one in turns, base, this, this, base, each in a process of its own
on the same card, so two versions of the kernels are compared in one
call.  Each process builds its own tree's kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F


def host_us(fn, iters: int = 100, rounds: int = 7) -> float:
    """Microseconds per call of ``fn(i)`` issued back to back, by CUDA
    events, after a warm-up: the median over ``rounds`` rounds of the mean
    of ``iters`` calls (the host's clock on a shared machine stalls in
    bursts; the median keeps a burst from setting the number)."""
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) * 1e3 / iters)
    return statistics.median(means)


def host_clock_us(fn, iters: int = 1000, rounds: int = 7) -> float:
    """Host microseconds per call of ``fn()`` by the host's clock alone
    (no device events): the median over ``rounds`` of the mean of
    ``iters`` calls.  For the pieces of a wrapper's host path."""
    fn()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - t0) * 1e6 / iters)
    torch.cuda.synchronize()
    return statistics.median(means)


def device_us(fn, calls: int = 50, replays: int = 20, prepare=None) -> float:
    """Mean device microseconds per call of ``fn(i)``: ``calls`` calls
    (i = 0 .. calls - 1) captured in one CUDA graph, replayed ``replays``
    times between two CUDA events.  ``prepare()``, if given, runs first on
    the capturing stream, outside the capture (an autograd forward whose
    backward ``fn`` captures must run on that stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up outside the capture
        if prepare is not None:
            prepare()
        for i in range(3):
            fn(i)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / (calls * replays)


def floor_device_us() -> float:
    """The card's launch floor: :func:`device_us` of a 1-element
    ``zero_()``."""
    x = torch.zeros(1, device="cuda")
    return device_us(lambda i: x.zero_())


def dequant_inputs(batch: int, calls: int, gen: torch.Generator,
                   shape: tuple = (28, 28, 1), rows: int = 60000,
                   spec: str = "unit"):
    """A resident uint8 split of ``rows`` samples of ``shape`` (config 3's
    60,000 MNIST-shaped ones by default; config 4's is 50,000 of
    [32, 32, 3] under the ``cifar`` spec), ``calls`` rows of ``batch``
    fresh indices each, and the split's dequant constants."""
    from distributedtensorflowexample_tpu_torch.data.dequant import (
        make_dequant_affine)
    images = torch.randint(0, 256, (rows, *shape), dtype=torch.uint8,
                           device="cuda", generator=gen)
    idx = torch.randint(0, rows, (calls, batch), dtype=torch.int32,
                        device="cuda", generator=gen)
    s, b = (torch.from_numpy(a).cuda() for a in make_dequant_affine(spec))
    return images, idx, s, b


def ce_inputs(batch: int, classes: int, gen: torch.Generator):
    """Logits [B, C] of scale 3, int32 labels and upstream row gradients."""
    logits = torch.randn(batch, classes, device="cuda", generator=gen) * 3
    labels = torch.randint(0, classes, (batch,), dtype=torch.int32,
                           device="cuda", generator=gen)
    g = torch.rand(batch, device="cuda", generator=gen) + 0.5
    return logits, labels, g


#: Cross-entropy shapes [B, C]: the main path's B=64, config 4's B=128,
#: the bench's B=256, and the LM head's 16 x 128 rows over its 250-token
#: vocabulary.
CE_SHAPES = ((64, 10), (128, 10), (256, 10), (2048, 250))


def ce_library_backward(logits, labels64, g):
    """``F.cross_entropy(reduction="none")``'s autograd backward on the
    same rows, as ``(fn, prepare)``: ``prepare()`` runs the forward (once
    here, and again by :func:`device_us` on the stream the backward is
    captured on); ``fn(i)`` is one backward with upstream gradients
    ``g``."""
    tape = {}

    def prepare():
        x = logits.clone().requires_grad_(True)
        tape["x"] = x
        tape["rows"] = F.cross_entropy(x, labels64, reduction="none")

    def fn(i):
        return torch.autograd.grad(tape["rows"], tape["x"], g,
                                   retain_graph=True)

    prepare()
    return fn, prepare


def ptxas_summary(log: str | None) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``
    output, keyed by the kernel's name and template arguments (e.g.
    ``ce_bwd_kernel<16,1>``); empty for no output."""
    out, name = {}, None
    for line in (log or "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?E", mangled)
            if base is None:
                name = mangled
            else:
                args = re.findall(r"L[a-z]+(-?\d+)E", base.group(2) or "")
                name = base.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out[name]["spill_stores"] = int(spill.group(1))
            out[name]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name]["registers"] = int(regs.group(1))
    return out


def host_path(batch: int, gen: torch.Generator) -> dict:
    """Where ``ce_fwd``'s host time per call goes at [B, 10]: each piece
    of the wrapper alone, the whole wrapper and ``F.cross_entropy``, by
    the host's clock."""
    from distributedtensorflowexample_tpu_torch.ops.kernels import (
        build, cross_entropy as ce)
    logits, labels, _ = ce_inputs(batch, 10, gen)
    loss = torch.empty(batch, device="cuda")
    fn = build.bind("cross_entropy", "ce_fwd", ce._FWD_ARGTYPES)
    args = (logits.data_ptr(), labels.data_ptr(), batch, 10, 0, 1.0, 0.0,
            loss.data_ptr(), build.stream_of(logits))
    labels64 = labels.long()
    pieces = {
        "checks": lambda: ce._check(logits, labels),
        "on_cuda": lambda: build.on_cuda("cross_entropy", logits, labels),
        "constants": lambda: ce._smoothing_constants(0.0, 10),
        "empty": lambda: torch.empty(batch, dtype=torch.float32,
                                     device=logits.device),
        "new_empty": lambda: logits.new_empty(batch),
        "stream_of": lambda: build.stream_of(logits),
        "ctypes_launch": lambda: fn(*args),
        "wrapper": lambda: ce.ce_fwd(logits, labels),
        "library": lambda: F.cross_entropy(logits, labels64,
                                           reduction="none"),
    }
    return {name: host_clock_us(f) for name, f in pieces.items()}


def _rows(gen: torch.Generator) -> list[dict]:
    from distributedtensorflowexample_tpu_torch.ops.kernels import (
        cross_entropy as ce, dequant as dq)
    rows = [{"kernel": "floor", "device_us": floor_device_us()}]
    for batch in (64, 256, 1000):
        images, idx, s, b = dequant_inputs(batch, 256, gen)
        kern = lambda i: dq.fused_gather_dequant(images, idx[i], s, b)
        lib = lambda i: torch.addcmul(b, images[idx[i]].float(), s)
        rows.append({"kernel": "dequant", "B": batch,
                     "host_us": host_us(kern), "device_us": device_us(kern),
                     "library_host_us": host_us(lib),
                     "library_device_us": device_us(lib)})
    for batch, classes in CE_SHAPES:
        logits, labels, g = ce_inputs(batch, classes, gen)
        labels64 = labels.long()
        fwd = lambda i: ce.ce_fwd(logits, labels)
        lib = lambda i: F.cross_entropy(logits, labels64, reduction="none")
        bwd = lambda i: ce.ce_bwd(logits, labels, g)
        lib_bwd, lib_forward = ce_library_backward(logits, labels64, g)
        rows.append({"kernel": "ce_fwd", "B": batch, "C": classes,
                     "host_us": host_us(fwd), "device_us": device_us(fwd),
                     "library_host_us": host_us(lib),
                     "library_device_us": device_us(lib)})
        rows.append({"kernel": "ce_bwd", "B": batch, "C": classes,
                     "host_us": host_us(bwd), "device_us": device_us(bwd),
                     "library_host_us": host_us(lib_bwd),
                     "library_device_us": device_us(lib_bwd,
                                                    prepare=lib_forward)})
    rows.append({"kernel": "ce_fwd", "B": 64,
                 "host_path_us": host_path(64, gen)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", help="another checkout's root, timed in turns "
                                  "with this one")
    args = p.parse_args(argv)
    if args.base is None:
        if not torch.cuda.is_available():
            print("kernel_timing: no CUDA card", file=sys.stderr)
            return 2
        from distributedtensorflowexample_tpu_torch.ops.kernels import build
        for source, r in build.build().items():
            if r["ptxas"]:
                print(json.dumps({"ptxas": source,
                                  "kernels": ptxas_summary(r["ptxas"])}),
                      flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for row in _rows(gen):
            print(json.dumps(row), flush=True)
        return 0
    here = Path(__file__).resolve().parents[2]
    trees = {"base": Path(args.base).resolve(), "this": here}
    for name in ("base", "this", "this", "base"):
        env = {**os.environ, "PYTHONPATH": str(trees[name])}
        out = subprocess.run([sys.executable, __file__], env=env,
                             cwd=trees[name], capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            print(json.dumps({"tree": name, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
