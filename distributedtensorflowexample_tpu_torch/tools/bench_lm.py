"""bench_lm — the transformer LM's harness (the JAX package's root
``bench_lm.py``): tokens/s and MFU, and the knob A/B matrix at the scale
where the knobs bind.

  # on the card (the default device): lm_small throughput in this
  # process, then the lm_base matrix over --devices ranks:
  python -m distributedtensorflowexample_tpu_torch.tools.bench_lm --json rec.json
  # shrunken (TINY: lm_tiny throughput, the lm_base matrix over 2 ranks,
  # one timed step a knob):
  python -m distributedtensorflowexample_tpu_torch.tools.bench_lm --tiny
  python -m distributedtensorflowexample_tpu_torch.tools.bench_lm --device cpu \\
      --throughput_size lm_tiny --size lm_tiny --seq_len 16 --devices 2

Two instruments on ``models/transformer_lm.py``, one JSON line each
(``_emit``: the JAX lines' keys), then the matrix's derived lines:

1. **Throughput and MFU** (``--throughput_size``, default lm_small):
   ``<size>_tokens_per_sec_per_chip`` and ``<size>_mfu``.  The step is
   ``Engine.build``'s, with the JAX ``_build`` knobs: momentum SGD 0.9
   at the bare float lr 0.1 (``optax.sgd(0.1, momentum=0.9)``: the
   port's ``MomentumSGD`` from a constant schedule), dropout 0, and the
   bench's deterministic ``load_lm`` split of ``max(8 x global batch,
   256)`` sequences.  Rates are ``tools.bench._measure``'s (best of
   ``--repeats``, each window ending in a synchronize).  MFU is the
   rank's FLOPs a step (``utils/flops.py``: 6 x the LM's MACs) times its
   steps/s over ``tools.bench.PEAK_FLOPS``, with no second division by
   the rank count: each rank computes its own rows.
2. **The knob A/B matrix** (``--size``, default lm_base) over
   ``--devices`` ranks: ``base``, ``remat``, ``shard_update``,
   ``bucket``, ``zero1``, ``zero3`` and ``zero3_nooverlap`` (only base
   and remat on one rank, as in JAX).  Per knob: this rank's momentum
   bytes (``opt_state_bytes_per_device``), the parameters and momentum it
   holds at rest (``residency``), the bytes autograd saves for backward
   over one step (``memory.activation_bytes``) and, on the card, the
   step's ``torch.cuda.max_memory_allocated`` (``memory.peak_bytes``),
   the collectives the step issues by kind, counted through
   ``parallel/mesh.Mesh``, and the FLOPs a step; the knobs in
   ``--ab_timed_knobs`` also get a rate.  Derived lines, under the JAX
   names and conditions: ``<size>_remat_activation_savings_frac``,
   ``_shard_update_optstate_shrink_x``, ``_zero1_optstate_shrink_x``,
   ``_zero3_state_residency_shrink_x``, ``_zero3_overlap_speedup_x`` and
   the closing ``<size>_knob_ab_matrix``.

``--json`` writes every line and a closing ``lm_bench_meta`` line as JSON
lines (the record ``tools.bench_ratchet`` reads).  Every line carries
``detail.device`` (``bench_ratchet.describe_device``: the card's name and
power limit) and its kernel launches: none, since the JAX ``_build``
leaves ``pallas_ce`` and the fused optimizer off; a launch fails the line.

Where the port differs from the JAX harness, on purpose:

- (a) **No ``--real``, no forced CPU mesh.**  ``--device cuda`` (the
  default) with no card prints the unavailable line and exits 1; it never
  measures the CPU in its place.  The throughput instrument runs in this
  process on one rank with no process group.
- (b) **Ranks are processes.**  The matrix's ``--devices`` ranks are one
  group spawned once through ``parallel/launch.spawn``, which builds the
  knobs one after another; the backend follows
  ``tools/bench_collectives.choose_backend`` (NCCL with a card a rank,
  else gloo: ranks sharing one card say so, ``backend``, ``host_staged``,
  ``num_chips``).  A knob's rate is its slowest rank's.
- (c) **No XLA audits.**  The JAX lines' ``bytes_audit``,
  ``bw_roofline_*``, ``arith_intensity_effective`` and
  ``cost_analysis_flops_*`` fields decompose XLA's ``cost_analysis`` and
  are left out (the lines' ``note`` says so); the FLOPs come from the
  shapes.  The compiler's ``temp_bytes`` becomes ``activation_bytes``:
  the distinct storages ``torch.autograd.graph.saved_tensors_hooks`` sees
  packed in one step, parameters excluded (under ``remat`` the
  checkpointed blocks' inputs, which the checkpoint holds by reference,
  are not among them).
- (d) **Collectives are counted, not parsed**: ``per_step`` is ``{kind:
  {"count", "bytes"}}`` (``Mesh.order``'s payload bytes), ``multiset``
  ``{kind: count}``.
- (e) **MFU's denominator** is the H100's dense bf16 peak; on the CPU the
  ratio is only the identity's arithmetic (the line's ``note``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback

_ALL_KNOBS = ("base", "remat", "shard_update", "bucket", "zero1",
              "zero3", "zero3_nooverlap")
#: Each knob in the JAX ``_build``'s keywords (the record's ``config``).
KNOBS = {
    "base": {},
    "remat": {"remat": "block"},
    "shard_update": {"shard_update": True},
    "bucket": {"bucket": True},
    "zero1": {"bucket": True, "shard_update": True},
    "zero3": {"bucket": True, "shard_update": True, "shard_params": True},
    "zero3_nooverlap": {"bucket": True, "shard_update": True,
                        "shard_params": True, "overlap": False},
}
#: ``--tiny``'s defaults: the step counts and the throughput size shrink;
#: the matrix stays at lm_base, over two ranks.
TINY = {"throughput_size": "lm_tiny", "steps": 4, "unroll": 2,
        "repeats": 1, "ab_steps": 1, "ab_repeats": 1, "devices": 2}
NOTE_AUDITS = ("the JAX line's bytes_audit, bw_roofline_* and "
               "cost_analysis fields decompose XLA's cost_analysis and are "
               "left out; FLOPs are counted from the shapes "
               "(utils/flops.py)")


def _emit(metric: str, value: float, unit: str, detail: dict,
          lines: list) -> None:
    # 12 significant digits: a CPU MFU over the card's peak is ~1e-7 and
    # must survive rounding.
    rec = {"metric": metric, "value": float(f"{float(value):.12g}"),
           "unit": unit, "vs_baseline": 1.0, "detail": detail}
    print(json.dumps(rec), flush=True)
    lines.append(rec)


def _unavailable(why: str, json_path: str) -> None:
    """The JAX ``_sentinel`` line (less the probe's attempts)."""
    line = {"metric": "lm_tokens_per_sec_per_chip", "value": 0.0,
            "unit": "unavailable", "vs_baseline": 0.0,
            "detail": {"error": why[:500], "provisional": True}}
    print(json.dumps(line), flush=True)
    if json_path:
        with open(json_path, "w") as f:
            f.write(json.dumps(line) + "\n")


def optstate_bytes_per_device(state) -> int:
    """This rank's momentum bytes (the JAX ``optstate_bytes_per_device``
    of the ``optax.sgd`` trace): the flat buffer, or this rank's rows of
    it under the row layouts."""
    opt = state.optimizer
    bufs = ([opt.momentum_flat] if opt.momentum_flat is not None
            else list(opt.momentum_rows or ()))
    return sum(b.numel() * b.element_size() for b in bufs)


def state_residency_per_device(state) -> dict:
    """The state this rank holds at rest, split as the JAX
    ``state_residency_per_device`` splits it: the parameters (the flat
    buffer, or ZeRO-3's rows: ``parallel/zero3.Zero3Layout.resident_bytes``
    with the momentum), the momentum and the batch-norm statistics."""
    opt = state.optimizer
    params = ([opt.params_flat] if opt.params_flat is not None
              else list(opt.params_rows or ()))
    p = sum(b.numel() * b.element_size() for b in params)
    o = optstate_bytes_per_device(state)
    s = sum(b.numel() * b.element_size() for b in state.model.buffers())
    return {"params_bytes_per_device": p, "opt_state_bytes_per_device": o,
            "batch_stats_bytes_per_device": s,
            "state_bytes_per_device": p + o + s}


def saved_for_backward(run):
    """``(bytes, run())``: the distinct storages autograd packs for
    backward while ``run`` runs, parameters (leaves that require grad)
    excluded."""
    import torch
    seen: dict = {}

    def pack(t):
        if not (t.is_leaf and t.requires_grad):
            s = t.untyped_storage()
            seen[(str(s.device), s.data_ptr())] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    return sum(seen.values()), out


def collectives(order: list, steps: int) -> dict:
    """``Mesh.order`` of ``steps`` steps -> per-step counts and bytes by
    kind."""
    from distributedtensorflowexample_tpu_torch.tools.bench_scaling import (
        traffic)
    per = {k: {"count": v["count"] / steps, "bytes": v["bytes"] / steps}
           for k, v in traffic(order).items()}
    per = {k: {f: int(x) if x == int(x) else x for f, x in v.items()}
           for k, v in per.items()}
    return {"per_step": per,
            "multiset": {k: v["count"] for k, v in sorted(per.items())},
            "total_count_per_step": sum(v["count"] for v in per.values()),
            "total_bytes_per_step": sum(v["bytes"] for v in per.values())}


def _build(size: str, mesh, batch_per_chip: int, seq_len: int,
           unroll: int, *, remat: str = "none", shard_update: bool = False,
           bucket: bool = False, shard_params: bool = False,
           overlap: bool = True, seed: int = 0, split_n: int | None = None):
    """One knob configuration as an Engine declaration (the JAX
    ``_build``): ``(step, ds, state, global_batch)``.  The optimizer is
    the config's: ``MomentumSGD`` at the bare float lr 0.1, momentum 0.9,
    a constant schedule."""
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.data.lm import load_lm
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        Engine, RunSpec)
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        DEFAULT_BUCKET_BYTES)

    global_batch = batch_per_chip * mesh.size
    n = split_n if split_n is not None else max(global_batch * 8, 256)

    def input_fn(cfg, split):
        return load_lm("", split, seed=seed, num=n, seq_len=seq_len)

    cfg = RunConfig(batch_size=batch_per_chip, seed=seed, remat=remat,
                    shard_update=shard_update,
                    bucket_grads=str(DEFAULT_BUCKET_BYTES) if bucket else "",
                    shard_params=shard_params, zero3_overlap=overlap,
                    learning_rate=0.1, momentum=0.9, dropout=0.0,
                    device=mesh.device.type)
    spec = RunSpec(model=size, dataset="lm", config=cfg, input_fn=input_fn)
    built = Engine(spec).build(mesh=mesh, unroll=unroll)
    return built.step, built.ds, built.state, global_batch


def _rate(step, ds, state, steps: int, unroll: int, repeats: int,
          warmup_calls: int = 1):
    """``tools.bench._measure`` over ``repeats`` windows after
    ``warmup_calls`` calls (the JAX ``_measure_rate``: one)."""
    from distributedtensorflowexample_tpu_torch.tools import bench
    return bench._measure(step, ds, state, steps, unroll,
                          warmup_calls=warmup_calls, repeats=max(1, repeats))


def _launches_are_zero() -> dict:
    from distributedtensorflowexample_tpu_torch.ops import kernels
    got = kernels.launch_counts()
    if any(got.values()):
        raise RuntimeError(f"kernel launches {got}: the LM bench requests "
                           f"no kernel")
    return got


def _free(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def knob_entry(name: str, args: dict, mesh, timed: bool) -> dict:
    """One knob on this rank: its bytes, one counted step, and (``timed``)
    its rate; ``build_s`` and ``wall_s`` are this rank's seconds to build
    the knob and in all."""
    import torch

    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)

    kw = KNOBS[name]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    step, ds, state, global_batch = _build(
        args["size"], mesh, args["ab_batch_per_chip"], args["seq_len"],
        args["ab_unroll"], seed=args["seed"], **kw)
    entry = {"build_s": round(time.perf_counter() - t0, 2), "config": kw,
             "global_batch": global_batch,
             "opt_state_bytes_per_device": optstate_bytes_per_device(state),
             "residency": state_residency_per_device(state)}
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.order = []
    try:
        act, (state, metrics) = saved_for_backward(
            lambda: step(state, next(ds)))
        bench._block(metrics)
        order = mesh.order
    finally:
        mesh.order = None
    memory = {"activation_bytes": act}
    if on_card:
        memory["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    entry["memory"] = memory
    entry["collectives"] = collectives(order, args["ab_unroll"])
    entry["model_flops_per_step_per_device"] = train_flops_per_step(
        args["size"], args["ab_batch_per_chip"], args["seq_len"])
    if args["ab_steps"] > 0 and timed:
        # The counted step above is the warm-up call.
        best, rates, _ = _rate(step, ds, state, args["ab_steps"],
                               args["ab_unroll"], args["ab_repeats"],
                               warmup_calls=0)
        entry["steps_per_sec"] = best
        entry["repeats"] = rates
    elif args["ab_steps"] > 0:
        entry["timing"] = "skipped (see --ab_timed_knobs)"
    entry["launches"] = _launches_are_zero()
    del step, ds, state, metrics
    _free(mesh.device)
    entry["wall_s"] = round(time.perf_counter() - t0, 2)
    return entry


def matrix_rank(args: dict) -> dict:
    """Every knob of the matrix, one after another, on this rank of the
    group (or, with no group, on one rank): ``{"rank", "num_chips",
    "entries": {knob: entry}, "errors": {knob: repr}}``."""
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    mesh = make_mesh(args["device"])
    knobs = list(KNOBS) if mesh.size > 1 else ["base", "remat"]
    entries, errors = {}, {}
    for name in knobs:
        if args["knobs"] and name not in args["knobs"]:
            continue
        try:
            entries[name] = knob_entry(name, args, mesh,
                                       name in args["ab_timed_knobs"])
        except Exception as e:
            errors[name] = repr(e)
            traceback.print_exc()
    return {"rank": mesh.rank, "num_chips": mesh.num_chips,
            "entries": entries, "errors": errors}


def run_throughput(args, device: dict, lines: list) -> None:
    from distributedtensorflowexample_tpu_torch.ops import kernels
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributedtensorflowexample_tpu_torch.tools import bench
    from distributedtensorflowexample_tpu_torch.utils.flops import (
        train_flops_per_step)

    mesh = make_mesh(args.device)
    size = args.throughput_size
    kernels.reset_launch_counts()
    step, ds, state, global_batch = _build(
        size, mesh, args.batch_per_chip, args.seq_len, args.unroll,
        seed=args.seed)
    best, rates, state = _rate(step, ds, state, args.steps, args.unroll,
                               args.repeats)
    from distributedtensorflowexample_tpu_torch.obs.anomaly import (
        spread_fraction)
    tokens_per_step = global_batch * args.seq_len
    flops = train_flops_per_step(size, args.batch_per_chip, args.seq_len)
    detail = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "devices": mesh.size, "num_chips": mesh.num_chips, "size": size,
        "global_batch": global_batch, "seq_len": args.seq_len,
        "unroll": args.unroll, "tokens_per_step": tokens_per_step,
        "steps_per_sec": round(best, 4), "repeats": rates,
        "spread_frac": round(spread_fraction(rates), 4),
        "token_storage": str(ds.images.dtype).replace("torch.", ""),
        "model_flops_per_step_per_device": flops,
        "model_flops_per_sec_per_device": round(flops * best),
        "launches": _launches_are_zero(), "device": device,
        "note": NOTE_AUDITS,
    }
    mfu_detail = dict(detail)
    mfu_detail.update(
        peak_flops=bench.PEAK_FLOPS, peak_flops_source=bench.PEAK_FLOPS_SOURCE,
        note=("MFU = the rank's FLOPs a step (utils/flops.py) x its steps/s "
              "/ PEAK_FLOPS, no second division by the ranks; "
              + ("on the cpu this is the identity's arithmetic, not a "
                 "utilization; " if args.device == "cpu" else "")
              + NOTE_AUDITS))
    _emit(f"{size}_tokens_per_sec_per_chip",
          best * tokens_per_step / mesh.num_chips, "tokens/sec/chip",
          detail, lines)
    _emit(f"{size}_mfu", flops * best / bench.PEAK_FLOPS,
          "fraction of PEAK_FLOPS", mfu_detail, lines)
    del step, ds, state
    _free(mesh.device)


def run_ab_matrix(args, device: dict, lines: list, errors: dict) -> None:
    from distributedtensorflowexample_tpu_torch.tools import bench_collectives

    D, size = args.devices, args.size
    rank_args = {k: getattr(args, k) for k in (
        "device", "size", "seq_len", "seed", "ab_batch_per_chip",
        "ab_unroll", "ab_steps", "ab_repeats", "knobs", "ab_timed_knobs")}
    backend = (bench_collectives.choose_backend("auto", args.device, D)
               if D > 1 else None)
    t0 = time.perf_counter()
    if D > 1:
        from distributedtensorflowexample_tpu_torch.parallel import launch
        # By its module's name: run with ``-m`` this module is
        # ``__main__``, and the spawned ranks unpickle the function by name.
        from distributedtensorflowexample_tpu_torch.tools import bench_lm
        ranks = launch.spawn(bench_lm.matrix_rank, D, backend, (rank_args,))
    else:
        ranks = [matrix_rank(rank_args)]
    wall_s = time.perf_counter() - t0      # the group's start-up included
    num_chips = ranks[0]["num_chips"]
    results: dict = {}
    for name in KNOBS:
        for r in ranks:
            if name in r["errors"]:
                errors[f"ab_{name}"] = r["errors"][name]
        if f"ab_{name}" in errors or name not in ranks[0]["entries"]:
            continue
        entry = dict(ranks[0]["entries"][name])
        entry["launches"] = [r["entries"][name]["launches"] for r in ranks]
        entry["wall_s"] = max(r["entries"][name]["wall_s"] for r in ranks)
        if "steps_per_sec" in entry:
            slowest = min((r["entries"][name] for r in ranks),
                          key=lambda e: e["steps_per_sec"])
            best = slowest["steps_per_sec"]
            entry["steps_per_sec"] = round(best, 4)
            entry["repeats"] = slowest["repeats"]
            entry["tokens_per_sec_per_chip"] = round(
                best * entry["global_batch"] * args.seq_len / num_chips, 2)
        results[name] = entry

    shared = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "devices": D, "size": size, "seq_len": args.seq_len,
              "batch_per_chip": args.ab_batch_per_chip, "backend": backend,
              "host_staged": backend == "gloo" and args.device == "cuda",
              "num_chips": num_chips, "device": device}
    base = results.get("base")
    if base:
        base_act = base["memory"]["activation_bytes"]
        base_opt = base["opt_state_bytes_per_device"]
        if "remat" in results and base_act:
            remat_act = results["remat"]["memory"]["activation_bytes"]
            if remat_act:
                _emit(f"{size}_remat_activation_savings_frac",
                      1.0 - remat_act / base_act, "fraction",
                      {**shared, "activation_bytes_base": base_act,
                       "activation_bytes_remat": remat_act,
                       "note": "bytes autograd saves for backward over one "
                               "step (saved_tensors_hooks; the JAX line's "
                               "temp_bytes); remat recomputes block "
                               "forwards instead of keeping them"}, lines)
        for name in ("shard_update", "zero1"):
            if name in results and base_opt:
                opt = results[name]["opt_state_bytes_per_device"]
                if opt:
                    _emit(f"{size}_{name}_optstate_shrink_x", base_opt / opt,
                          "x (1/D ideal = D)",
                          {**shared,
                           "opt_state_bytes_per_device_base": base_opt,
                           f"opt_state_bytes_per_device_{name}": opt,
                           "collectives":
                               results[name]["collectives"]["multiset"]},
                          lines)
        base_res = base["residency"]["state_bytes_per_device"]
        if "zero3" in results and base_res:
            z3 = results["zero3"]
            z3_res = z3["residency"]["state_bytes_per_device"]
            if z3_res:
                _emit(f"{size}_zero3_state_residency_shrink_x",
                      base_res / z3_res, "x (1/D ideal = D)",
                      {**shared,
                       "state_bytes_per_device_base": base_res,
                       "state_bytes_per_device_zero3": z3_res,
                       "residency_base": base["residency"],
                       "residency_zero3": z3["residency"],
                       "activation_bytes_zero3":
                           z3["memory"]["activation_bytes"],
                       "peak_bytes_zero3": z3["memory"].get("peak_bytes"),
                       "collectives": z3["collectives"]["multiset"],
                       "note": "parameters and momentum this rank holds at "
                               "rest (gradients are step-local); 1/D "
                               "ideal = D"}, lines)
    # Outside the base gate, as in JAX: the ratio needs only the pair.
    on = (results.get("zero3") or {}).get("steps_per_sec")
    off = (results.get("zero3_nooverlap") or {}).get("steps_per_sec")
    if on and off:
        _emit(f"{size}_zero3_overlap_speedup_x", on / off,
              "x (overlap-on over overlap-off wall clock)",
              {**shared, "steps_per_sec_overlap_on": on,
               "steps_per_sec_overlap_off": off,
               "note": "bucket gathers issued ahead of their reads against "
                       "each gathered at its read; the same math"
                       + ("; gloo ranks on one card stage every gather "
                          "through the host" if shared["host_staged"]
                          else "")}, lines)
    detail = {**shared, "matrix": results, "note": NOTE_AUDITS,
              "wall_s": round(wall_s, 1)}
    if errors:
        detail["errors"] = dict(errors)
    if D <= 1:
        detail["note"] = ("one rank: the shard_update/bucket/zero A/Bs need "
                          "a group of ranks; " + NOTE_AUDITS)
    _emit(f"{size}_knob_ab_matrix", float(len(results)), "configs", detail,
          lines)


def _parser(tiny: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks run (no card with cuda: exit 1; "
                        "never the CPU in its place)")
    p.add_argument("--json", default="",
                   help="write every line and the meta line here (JSON "
                        "lines)")
    p.add_argument("--tiny", action="store_true",
                   help=f"the shrunken defaults {TINY}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--throughput_size", default="lm_small")
    p.add_argument("--batch_per_chip", type=int, default=4)
    p.add_argument("--unroll", type=int, default=4)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--skip_throughput", action="store_true")
    p.add_argument("--size", default="lm_base",
                   help="the matrix's model size (lm_base: where the knobs "
                        "bind)")
    p.add_argument("--devices", type=int, default=4,
                   help="the matrix's rank count (one process each)")
    p.add_argument("--ab_batch_per_chip", type=int, default=1)
    p.add_argument("--ab_unroll", type=int, default=1)
    p.add_argument("--ab_steps", type=int, default=2,
                   help="timed steps a knob (0: bytes and collectives only)")
    p.add_argument("--ab_repeats", type=int, default=1)
    p.add_argument("--knobs", default="",
                   help=f"comma-separated subset of {_ALL_KNOBS} (default: "
                        f"all)")
    p.add_argument("--ab_timed_knobs",
                   default="base,remat,bucket,zero1,zero3,zero3_nooverlap",
                   help="knobs that also get a rate (shard_update, the "
                        "tree form, is bytes-only by default, as in JAX)")
    p.add_argument("--skip_ab", action="store_true")
    if tiny:
        p.set_defaults(**TINY)
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = _parser("--tiny" in argv)
    args = p.parse_args(argv)
    args.knobs = [k for k in args.knobs.split(",") if k]
    args.ab_timed_knobs = [k for k in args.ab_timed_knobs.split(",") if k]
    for k in args.knobs + args.ab_timed_knobs:
        if k not in _ALL_KNOBS:
            p.error(f"unknown knob {k!r} (one of {_ALL_KNOBS})")
    if args.devices < 1:
        p.error(f"--devices must be >= 1, got {args.devices}")
    if args.device == "cuda":
        from distributedtensorflowexample_tpu_torch.device import (
            DeviceUnavailable, require_cuda)
        try:
            require_cuda()
        except DeviceUnavailable as e:
            _unavailable(f"device unavailable: {e}", args.json)
            print(f"bench_lm: {e}", file=sys.stderr, flush=True)
            return 1

    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    from distributedtensorflowexample_tpu_torch.obs import (
        recorder as obs_recorder)
    from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
    from distributedtensorflowexample_tpu_torch.tools.bench_ratchet import (
        describe_device)

    obs_recorder.maybe_install()
    obs_ledger.maybe_begin("bench_lm", config=vars(args))
    obs_serve.maybe_start()
    device = describe_device(args.device)
    lines: list = []
    errors: dict = {}
    if not args.skip_throughput:
        try:
            run_throughput(args, device, lines)
        except Exception as e:
            errors["throughput"] = repr(e)
            traceback.print_exc()
    if not args.skip_ab:
        try:
            run_ab_matrix(args, device, lines, errors)
        except Exception as e:
            errors["ab_matrix"] = repr(e)
            traceback.print_exc()
    if args.json:
        meta = {"metric": "lm_bench_meta", "value": float(len(lines)),
                "unit": "lines", "vs_baseline": 1.0,
                "detail": {"family": "BENCH_lm",
                           "platform": "gpu" if args.device == "cuda"
                           else "cpu",
                           "device": device,
                           "provisional": True,   # meta, not a measurement
                           "errors": errors,
                           "note": ("CPU numbers check the harness; never "
                                    "read as card throughput"
                                    if args.device == "cpu" else
                                    "card record")}}
        with open(args.json, "w") as f:
            for rec in lines + [meta]:
                f.write(json.dumps(rec) + "\n")
        print(f"bench_lm: wrote {args.json}", file=sys.stderr, flush=True)
    obs_ledger.end_global(rc=1 if errors else 0, errors=errors or None)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
