# graftlint: stdlib-only
"""graftlint for the PyTorch port: two fronts of checks over the repo's
invariants (the JAX package's ``analysis/``).

* :mod:`.src_lint`: stdlib-only AST rules over the port's source tree
  (the import graph of its torch-free modules, the env-knob registry,
  named refusals, the ``obs/metrics`` clock seam, keep-in-sync digest
  markers, the Engine's ownership of the step wiring).
* :mod:`.collective_lint`: the collective contracts, checked at run
  time on two gloo ranks (the port has no compiled program text to
  read; see its docstring).  It imports torch, so this package root
  never imports it.
* :mod:`.env_registry`: the declared env knobs the env rules read.

Findings go through the checked-in waiver file
(``analysis/waivers.json``: every waiver dated and reasoned, at most
:data:`WAIVER_BUDGET`, a stale waiver is itself a finding);
``python -m distributedtensorflowexample_tpu_torch.tools.graftlint`` is
the command line, and ``tests/test_torch_analysis.py`` runs it under the
``lint`` marker.  This package root imports neither torch nor numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

#: Hard cap on checked-in waivers: the gate ratchets toward zero, it
#: does not accumulate exemptions.
WAIVER_BUDGET = 5

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


@dataclasses.dataclass
class Finding:
    """One lint finding, from either front.

    ``key`` is the stable waiver-match identity — rule plus a content
    token (env name, marker id, message digest), never a line number,
    so waivers survive unrelated edits.  ``fixable`` marks findings
    ``tools.graftlint --fix`` can mend mechanically.
    """

    rule: str
    path: str           # repo-relative (or "<hlo:mode>" for contracts)
    line: int
    key: str
    message: str
    fixable: bool = False

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def waivers_path(repo_root: str,
                 package: str = "distributedtensorflowexample_tpu_torch"
                 ) -> str:
    return os.path.join(repo_root, package, "analysis", "waivers.json")


def load_waivers(path: str) -> tuple[list[dict], list[Finding]]:
    """Read + validate the waiver file.  Malformed waivers are
    themselves findings (rule ``waiver-invalid``) — a waiver that
    doesn't say who/when/why is exactly the folklore this gate exists
    to end.  A missing file is an empty waiver set, never an error
    (the gate must run on seeded tmp trees)."""
    findings: list[Finding] = []
    rel = os.path.basename(path)
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return [], []
    except (OSError, json.JSONDecodeError) as e:
        return [], [Finding("waiver-invalid", rel, 0,
                            "waiver-invalid:file",
                            f"waiver file unreadable: {e}")]
    waivers = payload.get("waivers", [])
    good: list[dict] = []
    for i, w in enumerate(waivers):
        missing = [k for k in ("key", "reason", "date")
                   if not isinstance(w.get(k), str) or not w.get(k)]
        if missing:
            findings.append(Finding(
                "waiver-invalid", rel, 0, f"waiver-invalid:{i}",
                f"waiver #{i} missing {'/'.join(missing)} "
                f"(every waiver is dated + reasoned): {w!r}"))
            continue
        if not _DATE_RE.match(w["date"]):
            findings.append(Finding(
                "waiver-invalid", rel, 0, f"waiver-invalid:{i}",
                f"waiver #{i} date {w['date']!r} is not YYYY-MM-DD"))
            continue
        good.append(w)
    if len(good) > WAIVER_BUDGET:
        findings.append(Finding(
            "waiver-budget", rel, 0, "waiver-budget",
            f"{len(good)} waivers exceed the budget of {WAIVER_BUDGET} "
            f"— fix findings instead of accumulating exemptions"))
    return good, findings


def apply_waivers(findings: list[Finding], waivers: list[dict],
                  ran_rules: set[str] | None = None,
                  waiver_file: str = "waivers.json",
                  ) -> tuple[list[Finding], list[Finding], list[Finding]]:
    """Split *findings* into (unwaived, waived) and flag stale waivers.

    A waiver matches a finding by exact ``key`` equality.  A waiver
    whose key matches nothing is STALE (rule ``waiver-stale``, itself
    unwaivable) — the ratchet: once a finding is fixed its waiver must
    leave the file.  Staleness is only judged for rules that actually
    ran (``ran_rules``; None = all), so a src-only run never flags hlo
    waivers."""
    by_key = {w["key"]: w for w in waivers}
    unwaived, waived = [], []
    used: set[str] = set()
    for f in findings:
        if f.key in by_key:
            waived.append(f)
            used.add(f.key)
        else:
            unwaived.append(f)
    stale: list[Finding] = []
    for key, w in by_key.items():
        if key in used:
            continue
        rule = key.split(":", 1)[0]
        if ran_rules is not None and rule not in ran_rules:
            continue
        stale.append(Finding(
            "waiver-stale", waiver_file, 0, f"waiver-stale:{key}",
            f"waiver {key!r} ({w['date']}: {w['reason']}) matches no "
            f"current finding — delete it (the gate ratchets)"))
    return unwaived, waived, stale
