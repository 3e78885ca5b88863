"""The collective contracts, checked at run time: the port's counterpart
of the JAX package's ``analysis/hlo_lint.py`` (graftlint's second front).

The JAX front reads compiled HLO text.  The port has no compiled program
to read: its steps call the collectives by hand
(``parallel/mesh.Mesh``), so this front runs the steps and reads what
the mesh recorded.  :func:`collect_records` runs one step of each row of
``engine/spec.MODES`` (two for ``async_ps``, one averaging period) for
the softmax model on two gloo ranks on the CPU, with ``Mesh.order`` armed
(every counted collective's kind and payload dtype, in issue order), and
one replicated decode engine of the serving path.  :func:`check_step`
then holds each step to its contract:

* ``collective-budget``: the step's ``Mesh.collectives`` equal
  ``engine/spec.collective_budget`` for its mode and bucket count, kind
  by kind (a kind outside the budget, or a count above or below it, is a
  finding: the budgets are exact);
* ``collective-rs-ag-pair``: zero1 (and ``--shard_update``'s tree form)
  issues each bucket's reduce-scatter before its update-closing
  all-gather, one pair a bucket;
* ``collective-ag-before-rs`` and ``collective-trailing-ag``: zero3
  gathers each bucket before it reduce-scatters, and no all-gather
  closes the step;
* ``collective-dtype``: no collective's payload is wider than the
  declared ceiling (float32);
* ``decode-contract``: the serving decode step updates its KV cache in
  place (the same storage before and after: the counterpart of the JAX
  contract's donation aliasing), keeps its allocated bytes flat on the
  card, issues no collective and computes nothing wider than float32
  (``serving/engine.check_decode_contract``).

Skipped, with no torch meaning: XLA's input/output alias table and the
"no ENTRY copy of a donated parameter" rule (the port updates its state
in place by construction; the decode check above holds the cache's
storage), and the trip-count weighting of collectives inside loops (a
step here is one call).  This module imports torch: the package root
and ``tools/graftlint.py`` load it only for ``--front collective``.
"""

from __future__ import annotations

import hashlib

from distributedtensorflowexample_tpu_torch.analysis import Finding

COLLECTIVE_RULES = ("collective-budget", "collective-ag-before-rs",
                    "collective-trailing-ag", "collective-rs-ag-pair",
                    "collective-dtype", "decode-contract",
                    "collective-contract")

#: The schedule each mode promises beside its budget: zero1 (and the tree
#: form of ``--shard_update``, the same schedule over one bucket) closes
#: each bucket's update with an all-gather after its reduce-scatter;
#: zero3 gathers each bucket in the forward, before the backward's
#: reduce-scatters, and writes the updated rows back with no closing
#: gather.
ORDER_CONTRACTS = {
    "zero1": {"rs_ag_paired": True},
    "sync_dp_tree_form": {"rs_ag_paired": True},
    "zero3": {"ag_rs_paired": True, "no_trailing_all_gather": True},
}

#: The widest payload a collective may carry.
DTYPE_CEILING = "float32"
_WIDTH = {"bool": 1, "uint8": 1, "int8": 1, "bfloat16": 2, "float16": 2,
          "int16": 2, "float32": 4, "int32": 4, "float64": 8, "int64": 8}

#: One step of each MODES row for the suite: (label, extra flags).  The
#: bucket cap is filled in by :func:`collect_records`; at 16 KiB the
#: softmax model splits into two buckets, a real ladder.
MODE_SUITE = (
    ("sync_dp", ()),
    ("sync_dp_tree_form", ("--shard_update", "true")),
    ("bucketed", ("--bucket_grads", "{bb}")),
    ("zero1", ("--bucket_grads", "{bb}", "--shard_update", "true")),
    ("zero3", ("--bucket_grads", "{bb}", "--shard_params", "true")),
    ("async_ps", ("--sync_mode", "async", "--async_period", "2")),
)
#: Steps run per suite entry: one, and one averaging period in async.
_STEPS = {"async_ps": 2}
#: async_ps has no per-step budget (its average is period-gated): one
#: all-reduce of the parameters per period.
ASYNC_PERIOD_BUDGET = {"all-reduce": 1, "reduce-scatter": 0,
                       "all-gather": 0}

def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_step(record: dict, dtype_ceiling: str = DTYPE_CEILING
               ) -> list[Finding]:
    """Hold one recorded step (``{"mode", "budget", "collectives",
    "order": [(kind, dtype), ...]}``) to its contract: the exact budget,
    the mode's :data:`ORDER_CONTRACTS`, and the dtype ceiling."""
    mode = record["mode"]
    path = f"<step:{mode}>"
    findings: list[Finding] = []
    budget = record["budget"]
    if budget is None:
        findings.append(Finding(
            "collective-contract", path, 0,
            f"collective-contract:{mode}:budget",
            f"{mode}: no collective budget declared for this step"))
        budget = {}
    counts = record["collectives"]
    for kind in sorted(set(counts) | set(budget)):
        got, want = counts.get(kind, 0), budget.get(kind, 0)
        if got != want:
            findings.append(Finding(
                "collective-budget", path, 0,
                f"collective-budget:{mode}:{kind}",
                f"{mode}: {got} {kind} a step against the budget of "
                f"{want} (engine/spec.collective_budget) — the schedule "
                f"changed"))
    kinds = [k for k, _ in record["order"]]
    ags = [i for i, k in enumerate(kinds) if k == "all-gather"]
    rss = [i for i, k in enumerate(kinds) if k == "reduce-scatter"]
    contract = ORDER_CONTRACTS.get(mode, {})
    if contract.get("ag_rs_paired"):
        if len(ags) != len(rss):
            findings.append(Finding(
                "collective-ag-before-rs", path, 0,
                f"collective-ag-before-rs:{mode}:count",
                f"{mode}: {len(ags)} all-gathers against {len(rss)} "
                f"reduce-scatters — the per-bucket pairing is broken"))
        else:
            for k, (a, r) in enumerate(zip(ags, rss)):
                if a >= r:
                    findings.append(Finding(
                        "collective-ag-before-rs", path, 0,
                        f"collective-ag-before-rs:{mode}:{k}",
                        f"{mode}: bucket {k}'s all-gather (collective "
                        f"{a}) does not precede its reduce-scatter "
                        f"(collective {r})"))
    if contract.get("no_trailing_all_gather") and rss:
        trailing = [a for a in ags if a > max(rss)]
        if trailing:
            findings.append(Finding(
                "collective-trailing-ag", path, 0,
                f"collective-trailing-ag:{mode}",
                f"{mode}: {len(trailing)} all-gather(s) after the last "
                f"reduce-scatter — a step-closing gather (ZeRO-1's) in a "
                f"schedule that promises none"))
    if contract.get("rs_ag_paired"):
        if not rss or len(ags) != len(rss):
            findings.append(Finding(
                "collective-rs-ag-pair", path, 0,
                f"collective-rs-ag-pair:{mode}:count",
                f"{mode}: expected matched reduce-scatter + all-gather "
                f"pairs, got {len(rss)} reduce-scatter(s) / {len(ags)} "
                f"all-gather(s)"))
        else:
            for k, (r, a) in enumerate(zip(rss, ags)):
                if r >= a:
                    findings.append(Finding(
                        "collective-rs-ag-pair", path, 0,
                        f"collective-rs-ag-pair:{mode}:{k}",
                        f"{mode}: bucket {k}'s update-closing all-gather "
                        f"(collective {a}) does not follow its "
                        f"reduce-scatter (collective {r})"))
    cap = _WIDTH.get(dtype_ceiling)
    if cap is None:
        findings.append(Finding(
            "collective-dtype", path, 0, f"collective-dtype:{mode}:config",
            f"{mode}: dtype ceiling {dtype_ceiling!r} is not a dtype name "
            f"(e.g. 'float32') — the width check cannot run"))
    else:
        for dt in sorted({d for _, d in record["order"]}):
            if _WIDTH.get(dt, 8) > cap:
                findings.append(Finding(
                    "collective-dtype", path, 0,
                    f"collective-dtype:{mode}:{dt}",
                    f"{mode}: a {dt} collective payload exceeds the "
                    f"declared ceiling {dtype_ceiling}"))
    return findings


def decode_findings(messages: list[str], mode: str = "serve_decode"
                    ) -> list[Finding]:
    """``serving/engine.check_decode_contract``'s messages as findings."""
    return [Finding("decode-contract", f"<decode:{mode}>", 0,
                    f"decode-contract:{mode}:"
                    f"{hashlib.sha256(m.encode()).hexdigest()[:8]}", m)
            for m in messages]


def _rank_suite(bucket_bytes: int, plants: dict) -> dict:
    """Every suite entry's step on this rank of the group, recorded, once
    as built and once under each plant: ``{plant name or "": [record,
    ...]}``."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        Engine, RunSpec)
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        collective_budget)
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        make_mesh)
    mesh = make_mesh("cpu")
    data = make_synthetic(256, (28, 28, 1), 10, seed=0)
    out: dict = {}
    for name, plant in [("", None)] + sorted(plants.items()):
        records = []
        for label, extra in MODE_SUITE:
            cfg = parse_flags(["--device", "cpu", "--batch_size", "8"] + [
                a.format(bb=bucket_bytes) for a in extra])
            built = Engine(RunSpec("softmax", "mnist", cfg)).build(
                mesh, data=data)
            num_buckets = None if built.plan is None \
                else built.plan.num_buckets
            step = built.step if plant is None \
                else plant(mesh, label, built.step)
            before = dict(mesh.collectives)
            mesh.order = []
            try:
                for _ in range(_STEPS.get(label, 1)):
                    step(built.state, next(built.ds))
                order = [(kind, _dtype_name(dt))
                         for kind, dt, _ in mesh.order]
            finally:
                mesh.order = None
            records.append({
                "mode": label, "rank": mesh.rank,
                "collectives": {k: mesh.collectives[k] - before[k]
                                for k in before},
                "order": order, "num_buckets": num_buckets,
                "budget": (ASYNC_PERIOD_BUDGET if label == "async_ps"
                           else collective_budget(cfg, mesh.size,
                                                  num_buckets))})
        out[name] = records
    return out


def collect_records(bucket_bytes: int = 16 << 10, plants: dict | None = None,
                    ranks: int = 2) -> dict:
    """Run the suite on ``ranks`` gloo ranks on the CPU; returns rank 0's
    ``{plant name or "": [record, ...]}`` (every rank records the same
    schedule).  ``plants`` maps a name to a module-level function
    ``plant(mesh, label, step) -> step`` that alters a suite entry's step
    (the tests plant violations this way); the suite runs once more under
    each."""
    from distributedtensorflowexample_tpu_torch.parallel.launch import spawn
    return spawn(_rank_suite, ranks, "gloo",
                 args=(bucket_bytes, dict(plants or {})), timeout_s=300)[0]


def decode_messages(step=None) -> list[str]:
    """One replicated lm_tiny decode engine on the CPU (two slots, a
    16-row cache) through ``check_decode_contract``; ``step`` replaces
    its decode step (the tests plant a reallocating one)."""
    import torch

    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine, check_decode_contract)
    model = build_model("lm_tiny").requires_grad_(False)
    generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    engine = DecodeEngine(model, slots=2, cache_len=16)
    return check_decode_contract(
        engine, steps=3, step=None if step is None else
        (lambda: step(engine)))


def run_collective_lint(bucket_bytes: int = 16 << 10) -> list[Finding]:
    """The collective front: the mode suite on two gloo ranks and the
    decode engine, each held to its contract."""
    findings: list[Finding] = []
    for record in collect_records(bucket_bytes)[""]:
        findings += check_step(record)
    findings += decode_findings(decode_messages())
    return findings
