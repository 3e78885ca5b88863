"""bytes_audit — each train step's bytes by op and category, raw and
effective (the JAX package's root ``tools/bytes_audit.py``).

  python -m distributedtensorflowexample_tpu_torch.tools.bytes_audit --device cpu
  python -m distributedtensorflowexample_tpu_torch.tools.bytes_audit \\
      --device cpu --workload mnist_cnn --json out.json
  # on the card (the default device):
  python -m distributedtensorflowexample_tpu_torch.tools.bytes_audit --workload resnet20

Builds one of the bench workloads' indexed train step exactly as the
bench does (``tools.bench._make``: the same dataset, the same step
factory), runs one call of it under ``utils/profiling.audit_step`` and
prints a ranked table: the totals, the shares by category (conv, matmul,
gather, collective, cast, layout, reduce, rng, elementwise) and the top
ops.  Raw bytes are every op's inputs at full size plus its outputs (the
XLA cost convention); effective bytes re-price a gather's largest input
at its output's size, since the convention charges an indexed read of a
resident split for the whole split (and a port kernel's row at the bytes
it moves).  The one place the port's count differs from XLA's: eager ops
are unfused, so an intermediate that XLA would keep inside a fusion is
written and read again here.

The record (``--json``) has the JAX tool's keys, with ``device``
(``tools.bench_ratchet.describe_device``: the card's name and power
limit) in place of ``backend``.  ``arith_intensity_*`` divide the FLOPs a
step (``utils/flops.py``, from the layer shapes) by the raw and the
effective bytes; ``bw_roofline_effective_steps_per_sec`` is
``tools.bench.HBM_BYTES_PER_S`` (the H100 SXM5 80GB's HBM3 rate) over the
effective bytes a step, and is null on the CPU, as ``mfu`` is: the byte
counts themselves do not depend on the device.  ``--device cuda`` (the
default) with no card exits 1; it never audits the CPU in its place.
"""

from __future__ import annotations

import argparse
import json
import sys

WORKLOADS = {
    # name -> (model, dataset, default augment, lr, momentum)
    "resnet20": ("resnet20", "cifar10", "cifar", 0.1, 0.9),
    "mnist_cnn": ("mnist_cnn", "mnist", "none", 0.05, 0.9),
    "softmax": ("softmax", "mnist", "none", 0.5, 0.0),
}


def build_and_audit(workload: str, batch_per_chip: int, unroll: int,
                    augment: str | None = None, top_k: int = 15,
                    device: str = "cuda") -> dict:
    """Build the named workload's indexed train step as the bench does,
    audit one call of it, and return the record."""
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)
    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        audit_step)

    model, dataset, default_aug, lr, momentum = WORKLOADS[workload]
    aug = default_aug if augment is None else augment
    mesh = make_mesh(device)
    step, ds, state, u = bench._make(model, dataset, batch_per_chip, unroll,
                                     mesh, augment=aug, lr=lr,
                                     momentum=momentum)
    cost, audit = audit_step(
        step, ds, state, unroll=u, top_k=top_k,
        flops=train_flops_per_step(model, batch_per_chip * mesh.size))
    on_card = mesh.device.type == "cuda"
    eff = audit["bytes_effective_per_step"]
    return {"workload": workload, "model": model, "dataset": dataset,
            "augment": aug, "batch_per_chip": batch_per_chip,
            "unroll": u, "mesh_size": mesh.size,
            "device": describe_device(device),
            "dequant": ds.dequant_impl or "none",
            "cost_per_step": cost, "audit": audit,
            "arith_intensity_raw": round(
                cost["flops"] / audit["bytes_per_step"], 3),
            "arith_intensity_effective": round(cost["flops"] / eff, 3),
            # The bandwidth floor: no step can take less time than its
            # effective bytes over the card's memory rate.
            "bw_roofline_effective_steps_per_sec": (
                round(bench.HBM_BYTES_PER_S / eff, 1) if on_card else None)}


def print_table(record: dict, top_k: int = 15) -> None:
    audit = record["audit"]
    tot, eff = audit["bytes_per_step"], audit["bytes_effective_per_step"]
    dev = record["device"]
    where = dev.get("name") if dev.get("platform") == "gpu" else "cpu"
    print(f"# {record['workload']}  batch/chip={record['batch_per_chip']}  "
          f"unroll={record['unroll']}  device={where}  "
          f"dequant={record['dequant']}")
    flops = record["cost_per_step"].get("flops")
    if flops:
        print(f"flops/step            {flops / 1e6:12.1f} MFLOP")
    print(f"bytes/step (raw)      {tot / 1e6:12.2f} MB")
    print(f"bytes/step (effective){eff / 1e6:12.2f} MB   "
          f"(phantom gather operands: "
          f"{audit['phantom_gather_bytes_per_step'] / 1e6:.2f} MB)")
    roof = record["bw_roofline_effective_steps_per_sec"]
    print(f"arith intensity       raw {record['arith_intensity_raw']} "
          f"-> effective {record['arith_intensity_effective']} flop/B; "
          f"bw roofline "
          + (f"{roof} steps/s at HBM_BYTES_PER_S" if roof is not None
             else "null (the CPU has no card rate)"))
    print("\nby category (effective MB/step, raw in parens):")
    raw_cat = audit["by_category_per_step"]
    for cat, b in audit["by_category_effective_per_step"].items():
        print(f"  {cat:12s} {b / 1e6:10.2f}  ({raw_cat.get(cat, 0) / 1e6:.2f})"
              f"  {100 * b / max(1, eff):5.1f}%")
    print(f"\ntop {min(top_k, len(audit['top_ops']))} ops (raw MB/step):")
    for op in audit["top_ops"][:top_k]:
        tail = op["op_name"].split("/")[-3:]
        print(f"  {op['bytes_per_step'] / 1e6:9.2f}  {op['category']:11s} "
              f"{op['opcode']:14s} {op['out'][:28]:28s} {'/'.join(tail)}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="resnet20",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--batch_per_chip", type=int, default=256)
    ap.add_argument("--unroll", type=int, default=1,
                    help="steps a call; 1 audits the plain step (per-step "
                         "numbers are unroll-normalized either way)")
    ap.add_argument("--augment", default=None,
                    help="override the workload's default augment "
                         "(none|cifar)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", default="",
                    help="also write the full record to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the step runs (no card with cuda: exit 1; "
                         "the byte counts do not depend on it)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            print(f"bytes_audit: {e}", file=sys.stderr, flush=True)
            return 1
    record = build_and_audit(args.workload, args.batch_per_chip,
                             args.unroll, args.augment, top_k=args.top,
                             device=args.device)
    print_table(record, top_k=args.top)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
