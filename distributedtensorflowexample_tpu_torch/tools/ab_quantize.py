"""ab_quantize — the headline configuration over each resident storage of
its split (the JAX package's ``tools/ab_quantize.py``).

  # on the card (the default device), 16 epochs a call:
  python -m distributedtensorflowexample_tpu_torch.tools.ab_quantize
  # the wiring check (AB_SMOKE=1): a 16-step unroll, no roofline probe:
  python -m distributedtensorflowexample_tpu_torch.tools.ab_quantize --tiny
  python -m distributedtensorflowexample_tpu_torch.tools.ab_quantize --device cpu --tiny

Each variant is config 3 exactly as ``tools.bench`` measures its headline
(``mnist_cnn`` sync, ``tools.bench.BATCH["cnn"]`` a card, the deepest
unroll: ``AB_UNROLL_EPOCHS`` epochs, 16 by default) built by
``tools.bench._make`` with the variant's ``quantize`` and
``dequant_impl`` (``DeviceDataset``'s own knobs) and timed by
``tools.bench._measure`` over ``AB_CALLS`` calls a repeat (2):

  off        float32 resident split        (quantize off)
  auto       uint8, the resolved dequant   (quantize auto: affine here)
  u8_mul     uint8, f32(u) * f32(1/255)    (quantize scale, affine)
  u8_onehot  uint8, one-hot @ the LUT      (dequant_impl onehot)
  u8_lut     uint8, the LUT indexed        (dequant_impl lut)
  u8_kernel  uint8, the CUDA dequant       (dequant_impl pallas)

The first four are the JAX arms, in the JAX order; ``u8_lut`` and
``u8_kernel`` are the port's (ROADMAP item 8).  ``u8_mul`` stands for the
JAX diagnostic ``u8.astype(f32) / 255.0`` (its "not bitwise" arm): the
port computes ``f32(u) * f32(1/255)`` with one rounding, which is what
XLA compiles that division to (a multiply by the float32 reciprocal), so
it equals the jitted JAX ``apply_dequant_multiply`` on all 256 bytes and
differs from an eager float32 division on 126 of them by one ulp
(``tests/test_torch_ab_quantize.py``).  It is therefore bitwise here too,
and its line says so (``bitwise_vs_off``) without being held to it.

Before timing, every other variant's first gathered batch (step 0, the
same seeded index tape) is held bitwise against ``off``'s; a variant
that differs is a failed line.  One ``roofline_probe`` line first (the
JAX line's keys: ``repeats``, ``cost_per_step``), then one
``headline_<name>_steps_per_sec_per_chip`` line per variant, flushed as
it lands; each variant is fault-isolated (a failed one is a line of unit
``error``, and the exit code 1).  ``AB_SMOKE=1`` or ``--tiny``: a 16-step
unroll and no probe.  Each line's ``detail.launches`` is its kernel
launches, held to one a step of the builds that requested a kernel
(``tools.bench._Line``): the dequant kernel on ``u8_kernel`` only (on the
card; the CPU runs its plain version).

Where the port differs from the JAX harness: no monkeypatching (each
arm is a ``DeviceDataset`` configuration); ``--device {cuda,cpu}`` (no
card with cuda: exit 1, never the CPU in its place); each line carries
``detail.device`` (``bench_ratchet.describe_device``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

#: name -> (``quantize``, ``dequant_impl``), in emission order.
VARIANTS = {
    "off": ("off", "auto"),
    "auto": ("auto", "auto"),
    "u8_mul": ("scale", "affine"),
    "u8_onehot": ("auto", "onehot"),
    "u8_lut": ("auto", "lut"),
    "u8_kernel": ("auto", "pallas"),
}
#: Variants not held bitwise to ``off`` (the JAX "not bitwise" arm).
NOT_HELD = ("u8_mul",)


def _emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def first_batch(ds, mesh) -> dict:
    """Step 0's gathered, dequantized batch of ``ds`` (this rank's rows)."""
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        make_device_gather)
    gather = make_device_gather(ds.epoch_len // ds.steps_per_epoch,
                                ds.steps_per_epoch, num_slots=ds.num_slots,
                                dequant_impl=ds.dequant_impl or "auto",
                                mesh=mesh)
    return gather(0, ds.peek())


def bitwise(a: dict, b: dict) -> bool:
    import torch
    x, y = a["image"], b["image"]
    return (x.dtype == y.dtype == torch.float32 and x.shape == y.shape
            and torch.equal(x.view(torch.int32), y.view(torch.int32))
            and torch.equal(a["label"], b["label"]))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the variants run (no card with cuda: exit 1)")
    p.add_argument("--tiny", action="store_true",
                   help="AB_SMOKE=1: a 16-step unroll, no roofline probe")
    args = p.parse_args(argv)
    unroll_epochs = int(os.environ.get("AB_UNROLL_EPOCHS", "16"))
    calls_per_repeat = int(os.environ.get("AB_CALLS", "2"))
    smoke = args.tiny or os.environ.get("AB_SMOKE") == "1"
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            print(f"ab_quantize: {e}", file=sys.stderr, flush=True)
            return 1

    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)

    device = describe_device(args.device)
    mesh = make_mesh(args.device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        from distributedtensorflowexample_tpu_torch.ops.kernels import (
            build as kbuild)
        kbuild.build()      # before any window, not inside u8_kernel's
    b = bench.BATCH["cnn"]
    spe = bench.TRAIN_N["mnist"] // (b * mesh.size)
    unroll = 16 if smoke else unroll_epochs * spe
    if not smoke:
        cost: dict = {}
        probe_rates = bench._roofline_probe(
            mesh, b, length=bench.ROOFLINE_LEN["headline"], cost_out=cost)
        _emit({"metric": "roofline_probe", "repeats": probe_rates,
               "cost_per_step": cost,
               "detail": {"batch_per_chip": b, "device": device}})

    failed = False
    reference = None
    for name, (qmode, impl) in VARIANTS.items():
        try:
            line = bench._Line(on_card)
            step, ds, state, u = line.make("mnist_cnn", "mnist", b, unroll,
                                           mesh, quantize=qmode,
                                           dequant_impl=impl)
            batch = first_batch(ds, mesh)
            if name == "off":
                reference = batch
            same = reference is not None and bitwise(batch, reference)
            if name not in NOT_HELD and not same:
                raise AssertionError(f"variant {name!r}: step 0's batch is "
                                     f"not bitwise off's")
            del batch
            # The check's gather is no step: the line counts from here.
            kernels.reset_launch_counts()
            best, rates, _ = bench._measure(step, ds, state,
                                            calls_per_repeat * unroll, u)
            detail = {"repeats": rates, "unroll": u, "batch_per_chip": b,
                      "quantize": qmode, "dequant": ds.dequant_impl or "none",
                      "storage": str(ds.images.dtype).replace("torch.", ""),
                      "bitwise_vs_off": same, "device": device}
            line.attach(detail)
            _emit({"metric": f"headline_{name}_steps_per_sec_per_chip",
                   "value": round(best / mesh.num_chips, 2),
                   "unit": "steps/sec/chip", "detail": detail})
            del step, ds, state
        except Exception as e:      # fault-isolate: later variants still run
            failed = True
            traceback.print_exc()
            _emit({"metric": f"headline_{name}_steps_per_sec_per_chip",
                   "value": 0.0, "unit": "error",
                   "detail": {"error": repr(e), "device": device}})
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
