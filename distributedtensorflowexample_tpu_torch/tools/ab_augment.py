"""ab_augment — A/B the augmented input path alone, on the card: the
gather from the resident uint8 CIFAR split, the random crop and flip, and
the dequant, with no model (the JAX package's ``tools/ab_augment.py``).

  python -m distributedtensorflowexample_tpu_torch.tools.ab_augment \\
      --out /tmp/records/BENCH_augment_gpu_r16.json

Variants:

  base      config 4's input path (``parallel/sync.make_device_gather``
            with ``augment="cifar"``) at ``--dequant_impl auto`` as it
            resolves on the device (the one-rounding affine), the crop
            and flip one index gather (``data/augment_device.py``)
  selmm     selector-matrix crop and flip (one-hot row and column
            matrices in two batched bfloat16 products, the JAX package's
            form), then the table dequant (``lut[u]``)
  selmm_oh  the selector crop and flip, then the one-hot @ table dequant
            (``apply_dequant_lut``)
  noaug     the gather and the dequant only (what the augment costs)
  kernel    base with ``--dequant_impl pallas``: the CUDA gather+dequant
            kernel, then the crop and flip of its float32 output

Every selector and one-hot form routes each pixel exactly (one nonzero
term per output element, bytes exact in bfloat16), so every variant's
batch is bitwise base's on the same indices and draws; ``noaug`` is
bitwise base's under the identity draws (no shift, no flip).  The tool
asserts both on ``CHECK_STEPS`` steps before it times anything.

Timing: a warm-up window, then ``REPEATS`` windows of ``--steps`` steps,
each between two CUDA events (the host clock on ``--device cpu``); the
median.  One JSON line per variant, ``input_path_<variant>_steps_per_sec``
with ``detail.repeats`` (each window's rate), the batch, the ms a step,
the kernels' launches in the timed windows (``ops/kernels``) and
``detail.device`` (the card's name and power limit); ``--out`` also
writes them.  ``--device cuda`` (the default) with no card exits 1 by
name, never measuring the CPU in its place.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.data.augment_device import (
    PAD, _reflect, step_draws)
from distributedtensorflowexample_tpu_torch.data.cifar10 import load_cifar10
from distributedtensorflowexample_tpu_torch.data.dequant import (
    make_dequant_lut)
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DeviceDataset, apply_dequant_gather, apply_dequant_lut)
from distributedtensorflowexample_tpu_torch.device import (
    DeviceUnavailable, resolve_device)
from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_device_gather)
from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
    describe_device)

REPEATS = 3
CHECK_STEPS = 3
VARIANTS = ("base", "selmm", "selmm_oh", "noaug", "kernel")


def selector_crop_flip(images: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 -> the same, cropped and flipped per the draws
    as two batched products with one-hot selectors over the
    reflect-padded batch: ``R[b, r, hh] = (hh == ys[b] + r)`` picks the
    rows, ``C[b, ww, k] = (ww == xs[b] + (W-1-k if flip else k))`` the
    columns and the flip.  Exact: each output is 1.0 times one byte."""
    if images.dtype != torch.uint8:
        raise TypeError(f"selector_crop_flip routes uint8 bytes; got "
                        f"{images.dtype}")
    b, h, w, _ = images.shape
    dev = images.device
    hp, wp = h + 2 * PAD, w + 2 * PAD
    padded = images[:, _reflect(torch.arange(hp, device=dev), h)][
        :, :, _reflect(torch.arange(wp, device=dev), w)]
    ys, xs, flips = ys.to(dev), xs.to(dev), flips.to(dev)
    rows = ys[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    sel_r = (torch.arange(hp, device=dev)[None, None, :] == rows).to(
        torch.bfloat16)
    k = torch.arange(w, device=dev)[None, None, :]
    src = torch.where(flips[:, None, None], w - 1 - k, k) + xs[:, None, None]
    sel_c = (torch.arange(wp, device=dev)[None, :, None] == src).to(
        torch.bfloat16)
    out = torch.einsum("brh,bhwc->brwc", sel_r, padded.to(torch.bfloat16))
    out = torch.einsum("brwc,bwk->brkc", out, sel_c)
    return out.to(torch.uint8)


def make_gathers(ds: DeviceDataset, batch: int, seed: int = 0,
                 draws_fn=None) -> dict:
    """``variant -> gather(step, data) -> {"image", "label"}`` over ``ds``
    (the ``noaug`` entry is paired with ``base_identity``: base under the
    identity draws, its bitwise reference).  The draws are
    ``step_draws`` from ``seed``, or ``draws_fn(step) -> (ys, xs,
    flips)`` (arrays over the batch) where given."""
    spe, slots = ds.steps_per_epoch, ds.num_slots
    dev = ds.images.device
    lut = torch.from_numpy(make_dequant_lut(ds.dequant)).to(dev)
    gen = torch.Generator(device=dev)

    def common(**kw):
        kw.setdefault("draws_fn", draws_fn)
        return make_device_gather(batch, spe, num_slots=slots, seed=seed,
                                  **kw)

    def draws(step: int) -> tuple:
        if draws_fn is None:
            return step_draws(batch, seed, step, gen)
        return tuple(torch.as_tensor(np.asarray(a)) for a in draws_fn(step))

    def selector(dequant):
        def gather(step: int, data: dict) -> dict:
            slot = (step // spe) % slots
            pos = (step % spe) * batch
            idx = data["perm"][slot, pos:pos + batch]
            img = data["images"].index_select(0, idx)
            img = selector_crop_flip(img, *draws(step))
            return {"image": dequant(img, lut),
                    "label": data["labels"].index_select(0, idx)}
        return gather

    identity = (np.full(batch, PAD), np.full(batch, PAD),
                np.zeros(batch, bool))
    return {
        "base": common(dequant_impl=ds.dequant_impl, augment="cifar"),
        "selmm": selector(apply_dequant_gather),
        "selmm_oh": selector(apply_dequant_lut),
        "noaug": common(dequant_impl=ds.dequant_impl, augment="none"),
        "kernel": common(dequant_impl="pallas", augment="cifar"),
        "base_identity": common(dequant_impl=ds.dequant_impl,
                                augment="cifar",
                                draws_fn=lambda step: identity),
    }


def check_bitwise(gathers: dict, data: dict, variants: tuple,
                  steps: int = CHECK_STEPS) -> None:
    """Raise unless every variant's batch is bitwise base's (``noaug``:
    base's under the identity draws) at steps ``0 .. steps-1``."""
    for step in range(steps):
        want = gathers["base"](step, data)
        for v in variants:
            against = "base_identity" if v == "noaug" else "base"
            ref = gathers[against](step, data) if v == "noaug" else want
            got = gathers[v](step, data)
            same = (got["image"].dtype == ref["image"].dtype
                    and got["image"].shape == ref["image"].shape
                    and torch.equal(got["image"].view(torch.int32),
                                    ref["image"].view(torch.int32))
                    and torch.equal(got["label"], ref["label"]))
            if not same:
                raise AssertionError(f"ab_augment: variant {v!r} differs "
                                     f"from {against} at step {step}")


def time_window(gather, data: dict, steps: int,
                device: torch.device) -> float:
    """Seconds for ``steps`` gathers back to back: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for step in range(steps):
            gather(step, data)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for step in range(steps):
        gather(step, data)
    return time.perf_counter() - t0


def measure(variant: str, gather, data: dict, steps: int,
            device: torch.device, batch: int) -> dict:
    """One variant's line: a warm-up window, then ``REPEATS`` timed
    windows; the median rate, and the launches of all of them."""
    kernels.reset_launch_counts()
    time_window(gather, data, steps, device)            # warm-up
    rates = [steps / time_window(gather, data, steps, device)
             for _ in range(REPEATS)]
    rate = statistics.median(rates)
    return {"metric": f"input_path_{variant}_steps_per_sec",
            "value": round(rate, 2), "unit": "steps/sec",
            "detail": {"repeats": [round(r, 2) for r in rates],
                       "batch": batch, "steps": steps,
                       "ms_per_step": round(1e3 / rate, 4),
                       "images_per_sec": round(rate * batch, 1),
                       "launches": kernels.launch_counts(),
                       "timed_windows": REPEATS + 1,
                       "platform": "gpu" if device.type == "cuda"
                       else "cpu"}}


def build_dataset(rows: int, batch: int, steps: int, device: torch.device,
                  seed: int = 0):
    """The resident split: the port's synthetic CIFAR-10 train split of
    ``rows`` images, normalized (stored as uint8 with the ``cifar``
    dequant), on ``device``, with a ring covering ``steps`` steps."""
    images, labels = load_cifar10("", "train", synthetic_size=rows,
                                  source="synthetic")
    return DeviceDataset(images, labels, batch, device=device, seed=seed,
                         steps_per_next=steps)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=128,
                   help="images a step (config 4's batch on one card)")
    p.add_argument("--steps", type=int, default=390,
                   help="steps a timed window (390: one epoch of 50,000 "
                        "rows at B=128)")
    p.add_argument("--rows", type=int, default=50000,
                   help="rows of the resident uint8 split")
    p.add_argument("--out", default="",
                   help="also write the JSON lines here")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        print(f"ab_augment: {e}", file=sys.stderr, flush=True)
        return 1
    ds = build_dataset(args.rows, args.batch, args.steps, device)
    if ds.dequant_impl != "affine":
        # The kernel variant fuses the affine family's dequant.
        print(f"ab_augment: base's dequant resolved to {ds.dequant_impl!r} "
              f"on {device}, not the affine the kernel variant fuses",
              file=sys.stderr, flush=True)
        return 1
    data = next(ds)
    gathers = make_gathers(ds, args.batch)
    check_bitwise(gathers, data, VARIANTS)
    card = describe_device(args.device)
    lines = []
    for v in VARIANTS:
        line = measure(v, gathers[v], data, args.steps, device, args.batch)
        line["detail"].update(
            device=card, rows=args.rows,
            dequant_impl=("pallas" if v == "kernel" else ds.dequant_impl),
            bitwise_equal_to_base=True)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
