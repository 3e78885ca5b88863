# graftlint: stdlib-only
"""graftlint for the PyTorch port: the source rules and the collective
contracts (the JAX package's ``tools/graftlint.py``).

Source front (``analysis/src_lint.py``, stdlib only, no torch):
  stdlib-only     obs/, sim/ and the tagged modules never reach torch,
                  numpy or jax at import time (whole import graph)
  env-registry    every named os.environ read is declared and
                  documented in analysis/env_registry.py (env-dynamic:
                  dynamic reads resolve; env-dead: no orphan entries)
  named-refusal   mode-legality refusals (messages naming a --flag)
                  raise refusal.ModeRefusal, not a bare ValueError
  clock-seam      no bare time.time()/datetime.now() in obs/ and the
                  control plane outside obs/metrics.py's _now/_wall
  keep-in-sync    paired digest markers agree with their regions
  engine-owns-wiring  the step builders appear only under engine/ and
                  parallel/ (allowlist in src_lint)

Collective front (``analysis/collective_lint.py``, imports torch): one
step of each replication mode of the softmax model on two gloo ranks on
the CPU, each held to ``engine/spec.collective_budget`` and its
schedule (zero1's reduce-scatter + all-gather pairs, zero3's gathers
before its reduce-scatters and no closing gather), payloads no wider
than float32; and a decode step of the serving engine, its KV cache
updated in place.

Findings go through the checked-in waiver file (analysis/waivers.json:
dated and reasoned, at most 5, a stale waiver is a finding).  Exit 0 =
no unwaived findings; 1 = unwaived findings; 2 = internal error.

Usage:
  python -m distributedtensorflowexample_tpu_torch.tools.graftlint
      [--front src|collective|all] [--json PATH|-] [--md PATH|-] [--fix]
      [--root DIR] [--package NAME] [--waivers FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributedtensorflowexample_tpu_torch.analysis import (
    Finding, apply_waivers, load_waivers, src_lint, waivers_path)

PACKAGE = "distributedtensorflowexample_tpu_torch"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _render_md(unwaived, waived, stale, fixes) -> str:
    lines = ["# graftlint report", ""]
    if fixes:
        lines += ["## fixes applied", ""]
        lines += [f"- {d}" for d in fixes]
        lines.append("")

    def table(title, items):
        if not items:
            return
        lines.append(f"## {title} ({len(items)})")
        lines.append("")
        lines.append("| rule | where | message |")
        lines.append("|---|---|---|")
        for f in items:
            where = f"{f.path}:{f.line}" if f.line else f.path
            msg = f.message.replace("|", "\\|")
            lines.append(f"| {f.rule} | {where} | {msg} |")
        lines.append("")

    table("unwaived findings", unwaived)
    table("waived findings", waived)
    table("stale waivers", stale)
    if not (unwaived or waived or stale):
        lines.append("clean: no findings.")
    else:
        lines.append(f"verdict: {len(unwaived)} unwaived, "
                     f"{len(waived)} waived, {len(stale)} stale "
                     f"waiver(s).")
    lines.append("")
    return "\n".join(lines)


def _emit(text: str, dest: str) -> None:
    if dest == "-":
        sys.stdout.write(text)
    else:
        with open(dest, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {dest}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint", description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_REPO,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--package", default=PACKAGE)
    ap.add_argument("--front", choices=("src", "collective", "all"),
                    default="all",
                    help="src = AST rules only (fast, no torch); "
                         "collective = run the mode suite on two gloo "
                         "ranks and check its contracts; all = both "
                         "(default)")
    ap.add_argument("--json", dest="json_out", default="", metavar="PATH",
                    help="write the JSON report here ('-' = stdout)")
    ap.add_argument("--md", dest="md_out", default="", metavar="PATH",
                    help="write the markdown report here ('-' = stdout; "
                         "default when no --json/--md given)")
    ap.add_argument("--fix", action="store_true",
                    help="apply the mechanical fixes (env-registry "
                         "stubs, keep-in-sync digest re-stamp), then "
                         "re-lint")
    ap.add_argument("--waivers", default="",
                    help="waiver file (default: "
                         "<root>/<package>/analysis/waivers.json)")
    ap.add_argument("--bucket_bytes", type=int, default=16 << 10,
                    help="bucket cap of the collective mode suite "
                         "(default 16 KiB: softmax splits into a real "
                         "2-bucket ladder)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    fixes: list[str] = []
    if args.fix:
        if args.front == "collective":
            # --fix mends source rules only; the collective front would
            # not re-lint what it changed.
            print("graftlint: --fix applies to source rules only; "
                  "ignored under --front collective", file=sys.stderr)
        else:
            fixes = src_lint.apply_fixes(root, args.package)

    findings: list[Finding] = []
    ran_rules: set[str] = {"waiver-invalid", "waiver-budget",
                           "waiver-stale"}
    if args.front in ("src", "all"):
        findings += src_lint.run_src_lint(root, args.package)
        ran_rules |= set(src_lint.SRC_RULES)
    if args.front in ("collective", "all"):
        # Imported here: the collective front imports torch.
        from distributedtensorflowexample_tpu_torch.analysis import (
            collective_lint)
        findings += collective_lint.run_collective_lint(args.bucket_bytes)
        ran_rules |= set(collective_lint.COLLECTIVE_RULES)

    wpath = args.waivers or waivers_path(root, args.package)
    waivers, waiver_findings = load_waivers(wpath)
    unwaived, waived, stale = apply_waivers(
        findings, waivers, ran_rules,
        waiver_file=os.path.relpath(wpath, root))
    unwaived += waiver_findings
    payload = {
        "ok": not (unwaived or stale),
        "front": args.front,
        "unwaived": [f.as_dict() for f in unwaived + stale],
        "waived": [f.as_dict() for f in waived],
        "fixes": fixes,
    }
    if args.json_out:
        _emit(json.dumps(payload, indent=1, sort_keys=True) + "\n",
              args.json_out)
    if args.md_out or not args.json_out:
        _emit(_render_md(unwaived, waived, stale, fixes),
              args.md_out or "-")
    return 0 if not (unwaived or stale) else 1


def _cli() -> int:
    """Exit codes: 0 clean, 1 unwaived findings, 2 internal error (a
    crash in the linter or the mode suite never reads as findings)."""
    try:
        return main()
    except SystemExit:
        raise
    except Exception:
        import traceback
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
