"""Chip smoke for the PyTorch/CUDA port: proves, on one CUDA card, that the
port builds, that each hand-written kernel agrees with its plain PyTorch
version, and that config 3 (sync-SGD MNIST CNN) trains through all four
kernels.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``distributedtensorflowexample_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build time;
3. each kernel against its plain version on the card at the main path's
   shapes (B=64, and the bench's B=256): dequant bitwise, cross-entropy
   forward and backward within 1e-5 absolute (float32 summation order),
   SGD within 1 ulp (the plain version's float64 route can double-round);
   one JSON line per kernel and batch with the kernel's, the plain
   version's and the comparable PyTorch library call's times and the
   kernel's bound;
4. 5 training steps on the card against the same 5 steps on the CPU
   (plain versions) from one init and one index tape: loss tapes within
   2e-2 relative (both bf16; cuDNN and the CPU round at different places);
5. the main path: ``trainer_sync_mnist.main`` on ``cuda`` at full width
   with ``--dequant_impl pallas --pallas_ce --fused_optimizer``, launch
   counters set to 0 just before and read just after; every kernel must
   have launched the count the steps imply, the loss must be finite and
   fall, and ``final_accuracy`` must be printed;
6. the ``kernels`` JSON line, then the ``ok`` line last.

Times are CUDA-event means over many launches after a warm-up, each
launch on fresh indices (dequant) or buffers (SGD) where the caller
would find them cold in L2.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s memory, 67 TFLOP/s
float32 outside the tensor cores.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from distributedtensorflowexample_tpu_torch.data.dequant import (
    make_dequant_affine)
from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.ops.kernels import build as kbuild
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    cross_entropy as ce, dequant as dq, sgd)

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROOT = Path(__file__).resolve().parent
TRAIN_STEPS = 600
BATCH = 64
SOURCES = {
    "dequant": ("distributedtensorflowexample_tpu_torch/csrc/dequant.cu",
                "distributedtensorflowexample_tpu/ops/pallas/dequant.py:35"),
    "ce_fwd": ("distributedtensorflowexample_tpu_torch/csrc/cross_entropy.cu",
               "distributedtensorflowexample_tpu/ops/pallas/cross_entropy.py:36"),
    "ce_bwd": ("distributedtensorflowexample_tpu_torch/csrc/cross_entropy.cu",
               "distributedtensorflowexample_tpu/ops/pallas/cross_entropy.py:57"),
    "sgd": ("distributedtensorflowexample_tpu_torch/csrc/sgd.cu",
            "distributedtensorflowexample_tpu/ops/pallas/sgd.py:52"),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` calls, by
    CUDA events, after a warm-up."""
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def check_dequant(batch: int, gen: torch.Generator, iters: int) -> dict:
    dev = torch.device("cuda")
    images = torch.randint(0, 256, (60000, 28, 28, 1), dtype=torch.uint8,
                           device=dev, generator=gen)
    idx = torch.randint(0, 60000, (iters + 5, batch), dtype=torch.int32,
                        device=dev, generator=gen)
    s, b = (torch.from_numpy(a).to(dev) for a in make_dequant_affine("unit"))
    got = dq.fused_gather_dequant(images, idx[0], s, b)
    want = dq.gather_dequant_plain(images, idx[0], s, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            f"dequant B={batch} is not bitwise equal to its plain version")
    row = 28 * 28
    nbytes = batch * row * (1 + 4) + batch * 4 + 2 * 4
    b_ms, b_by = bound(nbytes, 2 * batch * row)
    return {"max_abs_err": err,
            "ms": time_ms(lambda i: dq.fused_gather_dequant(
                images, idx[i], s, b), iters),
            "plain_ms": time_ms(lambda i: dq.gather_dequant_plain(
                images, idx[i], s, b), iters),
            "library_ms": time_ms(lambda i: torch.addcmul(
                b, images[idx[i]].float(), s), iters),
            "bound_ms": b_ms, "bound_by": b_by}


def check_ce(batch: int, gen: torch.Generator, iters: int) -> tuple[dict, dict]:
    dev, classes = torch.device("cuda"), 10
    logits = torch.randn(batch, classes, device=dev, generator=gen) * 3
    labels = torch.randint(0, classes, (batch,), dtype=torch.int32,
                           device=dev, generator=gen)
    g = torch.rand(batch, device=dev, generator=gen) + 0.5
    out = {}
    for s in (0.0, 0.1):
        fwd = (ce.ce_fwd(logits, labels, s)
               - ce.ce_fwd_plain(logits, labels, s)).abs().max().item()
        bwd = (ce.ce_bwd(logits, labels, g, s)
               - ce.ce_bwd_plain(logits, labels, g, s)).abs().max().item()
        torch.cuda.synchronize()
        require(fwd <= 1e-5 and bwd <= 1e-5,
                f"cross-entropy B={batch} s={s}: |fwd| {fwd}, |bwd| {bwd} "
                f"exceed 1e-5")
        out[s] = (fwd, bwd)
    labels64 = labels.long()
    x = logits.clone().requires_grad_(True)
    lib_rows = F.cross_entropy(x, labels64, reduction="none")
    n_in = batch * classes
    fb_ms, fb_by = bound(n_in * 4 + batch * 4 + batch * 4, 6 * n_in)
    bb_ms, bb_by = bound(n_in * 4 + batch * 8 + n_in * 4, 11 * n_in)
    fwd = {"max_abs_err": max(v[0] for v in out.values()),
           "ms": time_ms(lambda i: ce.ce_fwd(logits, labels), iters),
           "plain_ms": time_ms(lambda i: ce.ce_fwd_plain(logits, labels),
                               iters),
           "library_ms": time_ms(lambda i: F.cross_entropy(
               logits, labels64, reduction="none"), iters),
           "bound_ms": fb_ms, "bound_by": fb_by}
    bwd = {"max_abs_err": max(v[1] for v in out.values()),
           "ms": time_ms(lambda i: ce.ce_bwd(logits, labels, g), iters),
           "plain_ms": time_ms(lambda i: ce.ce_bwd_plain(logits, labels, g),
                               iters),
           "library_ms": time_ms(lambda i: torch.autograd.grad(
               lib_rows, x, g, retain_graph=True), iters),
           "bound_ms": bb_ms, "bound_by": bb_by}
    return fwd, bwd


def check_sgd(gen: torch.Generator, iters: int) -> dict:
    from distributedtensorflowexample_tpu_torch.models.mnist_cnn import (
        MnistCNN)
    dev = torch.device("cuda")
    shapes = [p.shape for p in MnistCNN().parameters()]
    n = sum(s.numel() for s in shapes)
    lr, mu = 0.05, 0.9
    # Three (p, m, g) sets, 3 x 39 MB of inputs, used in turn: each timed
    # launch finds its buffers out of the 50 MB L2, as one apply per
    # training step does after the forward and backward passes.
    sets = [[torch.randn(n, device=dev, generator=gen) for _ in range(3)]
            for _ in range(3)]
    p, m, g = sets[0]
    pk, mk = p.clone(), m.clone()
    sgd.fused_sgd_apply(pk, mk, g, lr, mu)
    pp, mp = p.clone(), m.clone()
    sgd.sgd_plain(pp, mp, g, lr, mu)
    torch.cuda.synchronize()
    dp, dm = ulps(pk, pp), ulps(mk, mp)
    require(int(dp.max()) <= 1 and int(dm.max()) <= 1,
            f"sgd differs from its plain version by more than 1 ulp "
            f"(p {int(dp.max())}, m {int(dm.max())})")
    offs = np.cumsum([0] + [s.numel() for s in shapes])
    views = lambda t: [t[a:b] for a, b in zip(offs[:-1], offs[1:])]
    per_layer = [[views(t) for t in st] for st in sets]

    def foreach(i):
        ps, ms, gs = per_layer[i % 3]
        torch._foreach_mul_(ms, mu)
        torch._foreach_add_(ms, gs)
        torch._foreach_add_(ps, ms, alpha=-lr)

    b_ms, b_by = bound(20 * n, 4 * n)
    return {"max_abs_err": max((pk - pp).abs().max().item(),
                               (mk - mp).abs().max().item()),
            "ulp_mismatches": int((dp > 0).sum() + (dm > 0).sum()),
            "ms": time_ms(lambda i: sgd.fused_sgd_apply(
                *sets[i % 3], lr, mu), iters),
            "plain_ms": time_ms(lambda i: sgd.sgd_plain(
                *sets[i % 3], lr, mu), iters),
            "library_ms": time_ms(foreach, iters),
            "bound_ms": b_ms, "bound_by": b_by}


def check_card_against_cpu() -> dict:
    """5 steps with the kernels on the card against the same 5 steps with
    the plain versions on the CPU, from one init and one index tape."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    x, y = make_synthetic(256, (28, 28, 1), 10, seed=0, sample_seed=1)
    perm = np.random.RandomState(0).permutation(256)
    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9",
                       "--learning_rate", "0.05", "--batch_size", "8",
                       "--dropout", "0", "--dequant_impl", "pallas",
                       "--pallas_ce", "true"])
    tapes = {}
    for name in ("cuda", "cpu"):
        built = Engine(RunSpec("mnist_cnn", "mnist", cfg)).build(
            torch.device(name), data=(x, y), perm_fn=lambda e: perm)
        tapes[name] = [float(built.step(built.state, next(built.ds))[1]
                             ["loss"]) for _ in range(5)]
    a, b = np.array(tapes["cuda"]), np.array(tapes["cpu"])
    require(np.all(np.isfinite(a)), f"card loss tape not finite: {a}")
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    require(rel <= 2e-2, f"card vs CPU loss tapes differ by {rel:.3g} "
                         f"relative (cuda {a}, cpu {b})")
    return {"cuda": tapes["cuda"], "cpu": tapes["cpu"], "max_rel": rel}


def run_main_path(gpu: str) -> tuple[dict, dict]:
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    log_dir = ROOT / "build" / "chip_smoke"
    argv = ["--device", "cuda", "--dataset", "synthetic",
            "--dequant_impl", "pallas", "--pallas_ce", "true",
            "--fused_optimizer", "true", "--train_steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--log_every", "100",
            "--resume", "false", "--log_dir", str(log_dir)]
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = trainer_sync_mnist.main(argv)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    text = out.getvalue()
    print(text, end="")
    steps, evals = summary["steps"], summary["eval_batches"]
    expect = {"dequant": steps + evals, "ce_fwd": steps, "ce_bwd": steps,
              "sgd": steps}
    require(steps == TRAIN_STEPS, f"trained {steps} of {TRAIN_STEPS} steps")
    require(counts == expect, f"launch counts {counts}, expected {expect} "
                              f"(one of each per step, plus one dequant "
                              f"per eval batch)")
    losses = [l for _, l in summary["loss_tape"]]
    require(len(losses) >= 2 and all(np.isfinite(losses))
            and losses[-1] < losses[0], f"loss tape {losses}")
    require("final_accuracy=" in text, "no final_accuracy line")
    require(summary["final_accuracy"] >= 0.9,
            f"final accuracy {summary['final_accuracy']}")
    result = {"steps": steps, "batch": BATCH,
              "steps_per_call": summary["steps_per_call"],
              "steps_per_sec": summary["steps_per_sec"],
              "wall_s_incl_setup_and_eval": wall,
              "final_accuracy": summary["final_accuracy"],
              "loss_tape": summary["loss_tape"], "launches": counts,
              "gpu": gpu}
    return result, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu, flush=True)

    t0 = time.perf_counter()
    report = kbuild.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_source_s": {k: v["seconds"]
                                       for k, v in report.items()}}),
          flush=True)
    for name, r in report.items():
        regs = [l.strip() for l in (r["ptxas"] or "").splitlines()
                if "registers" in l or "spill" in l]
        print(f"ptxas {name}: {' | '.join(regs)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for batch in (BATCH, 256):
        rows[("dequant", batch)] = check_dequant(batch, gen, 200)
        rows[("ce_fwd", batch)], rows[("ce_bwd", batch)] = check_ce(
            batch, gen, 200)
    rows[("sgd", BATCH)] = check_sgd(gen, 50)
    for (name, batch), r in rows.items():
        extra = ({"ulp_mismatches": r["ulp_mismatches"]}
                 if "ulp_mismatches" in r else {})
        print(json.dumps({"kernel": name, "B": batch, "kernel_ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"],
                          "bound_us": r["bound_ms"] * 1e3,
                          "max_abs_err": r["max_abs_err"], **extra,
                          "gpu": gpu}), flush=True)

    print(json.dumps({"card_vs_cpu_5_steps": check_card_against_cpu()}),
          flush=True)

    result, counts = run_main_path(gpu)
    print(json.dumps({"main_path": result}), flush=True)
    print(f"main path: {result['steps_per_sec']:.1f} steps/s (last "
          f"100-step window, B={BATCH}) on {gpu}", flush=True)

    line = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[(name, BATCH)]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
