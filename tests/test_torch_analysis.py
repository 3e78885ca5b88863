"""The port's graftlint (``analysis/``, ``tools.graftlint``) against the
JAX package's.

The source rules run over the seeded trees of the JAX package's
``tests/test_analysis.py`` (one planted violation each) through both
linters, which must give the same finding keys wherever the rule's banned
set is the same (every rule but ``engine-owns-wiring``, whose names are
the port's step builders: there the port's keys are the JAX keys less
``shard_map``'s).  The port's tree is clean under its waivers, the
``--fix`` round trips re-lint clean, the CLI's exit codes are the JAX
ones (0 clean, 1 findings, 2 an internal error), and the collective front
passes on the port's modes on two gloo ranks and fires on a planted extra
all-reduce and on a zero3 step that closes with an all-gather (one group
for the clean and the planted runs, started once).

Marker strings for the keep-in-sync tests are built by concatenation, so
this file never holds a literal marker the repo-wide scans would read.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from distributedtensorflowexample_tpu import analysis as jax_analysis
from distributedtensorflowexample_tpu.analysis import src_lint as jax_src_lint
from distributedtensorflowexample_tpu_torch.analysis import (
    WAIVER_BUDGET, Finding, apply_waivers, load_waivers, src_lint,
    waivers_path)

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "distributedtensorflowexample_tpu_torch"
GRAFTLINT = [sys.executable, "-m", f"{PKG}.tools.graftlint"]

_MARK = "KEEP-IN-" + "SYNC"     # never a literal marker in this file


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(tmp_path, files: dict) -> str:
    """A seeded repo tree with package ``seedpkg``."""
    root = tmp_path / "seedrepo"
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    init = root / "seedpkg" / "__init__.py"
    if not init.exists():
        init.parent.mkdir(parents=True, exist_ok=True)
        init.write_text("")
    return str(root)


def _keys(findings, rule=None):
    return sorted(f.key for f in findings if rule is None or f.rule == rule)


# --- the JAX package's seeded trees -----------------------------------------

_SEEDS = {
    "stdlib-only": {
        "seedpkg/obs/__init__.py": "",
        "seedpkg/obs/bad.py": "import numpy\n",
        "seedpkg/util.py": "import jax\n",
        "seedpkg/tagged.py": ("# graftlint: stdlib-only\n"
                              "from seedpkg.util import thing\n"),
    },
    "stdlib-only-clean": {
        "seedpkg/obs/__init__.py": "",
        "seedpkg/obs/ok.py": ("import json\n"
                              "def lazy():\n    import numpy\n"),
    },
    "env": {
        "seedpkg/knobs.py": """\
            import os

            def _env_float(name, default):
                try:
                    return float(os.environ.get(name, ""))
                except ValueError:
                    return default

            READ = os.environ.get("SEED_UNDECLARED")
            VIA_HELPER = _env_float("SEED_VIA_HELPER", 1.0)

            def orphan_helper(name):
                return os.environ[name]
            """,
        "seedpkg/aliased_knobs.py": """\
            from os import environ as _e, getenv

            A = _e.get("SEED_FROM_IMPORT")
            B = getenv("SEED_GETENV")
            """,
        "seedpkg/analysis/env_registry.py": """\
            ENV_REGISTRY: dict[str, str] = {
                "SEED_DEAD_KNOB": "never read anywhere.",
            }
            """,
    },
    "named-refusal": {
        "seedpkg/modes.py": """\
            class ModeRefusal(ValueError):
                pass

            def check(flag):
                if flag == "bad":
                    raise ValueError(
                        "--seed_knob cannot run with --other_knob")
                if flag == "ok":
                    raise ModeRefusal("--seed_knob refused by name")
                raise ValueError(f"unknown flag {flag!r}")
            """,
    },
    "clock-seam": {
        "seedpkg/obs/__init__.py": "",
        "seedpkg/obs/metrics.py": ("import time\n"
                                   "_now = time.monotonic\n"
                                   "_wall = time.time\n"
                                   "def stamp():\n"
                                   "    return time.time()\n"),
        "seedpkg/obs/leaky.py": ("import time\n"
                                 "from datetime import datetime\n"
                                 "def stamp():\n"
                                 "    return time.time()\n"
                                 "def when():\n"
                                 "    return datetime.now()\n"),
        "seedpkg/obs/aliased.py": ("import time as _t\n"
                                   "from time import time as _wallclock\n"
                                   "def a():\n"
                                   "    return _t.monotonic()\n"
                                   "def b():\n"
                                   "    return _wallclock()\n"
                                   "def now():\n"
                                   "    return 0\n"
                                   "def c():\n"
                                   "    return now()\n"),
    },
    "keep-in-sync": {
        "a.py": (f"# {_MARK}(pairdemo)\n# alpha\n# {_MARK}-END(pairdemo)\n"),
        "b.sh": (f"# {_MARK}(pairdemo)\n# alpha\n# {_MARK}-END(pairdemo)\n"),
        "solo.py": (f"# {_MARK}(loner)\n# body\n# {_MARK}-END(loner)\n"),
        "open.py": f"# {_MARK}(never)\n# body\n",
    },
    "engine-owns-wiring": {
        "seedpkg/trainers/__init__.py": "",
        "seedpkg/trainers/bad.py": """\
            def build():
                from seedpkg.parallel.zero3 import Zero3Layout
                return Zero3Layout
        """,
        "seedpkg/serving/__init__.py": "",
        "seedpkg/serving/attr.py": """\
            import jax

            def f(x):
                return jax.shard_map(x)
        """,
        "seedpkg/engine/__init__.py": "",
        "seedpkg/engine/engine.py":
            "from seedpkg.parallel.sync import make_train_step\n",
        "seedpkg/parallel/__init__.py": "",
        "seedpkg/parallel/sync.py": "def make_train_step():\n    pass\n",
        "seedpkg/docs_only.py":
            '"""Prose may mention make_train_step and shard_map."""\n',
        "tools/wired.py":
            "from seedpkg.parallel.sync import make_train_step\n",
    },
}

_RULES = {
    "stdlib-only": ("stdlib-only",),
    "stdlib-only-clean": ("stdlib-only",),
    "env": ("env-registry", "env-dynamic", "env-dead"),
    "named-refusal": ("named-refusal",),
    "clock-seam": ("clock-seam",),
    "keep-in-sync": ("keep-in-sync",),
    "engine-owns-wiring": ("engine-owns-wiring",),
}


@pytest.mark.parametrize("seed", sorted(_SEEDS))
def test_source_rules_give_the_jax_keys_on_the_jax_seeded_trees(tmp_path,
                                                                seed):
    root = _seed(tmp_path, _SEEDS[seed])
    rules = _RULES[seed]
    mine = _keys(src_lint.run_src_lint(root, "seedpkg", rules=rules))
    theirs = _keys(jax_src_lint.run_src_lint(root, "seedpkg", rules=rules))
    if seed == "engine-owns-wiring":
        # The one rule whose names differ: the port has no shard_map.
        theirs = [k for k in theirs if not k.endswith(":shard_map")]
        assert "engine-owns-wiring:seedpkg/trainers/bad.py:Zero3Layout" \
            in mine
        assert "engine-owns-wiring:tools/wired.py:make_train_step" in mine
    assert mine == theirs
    assert bool(mine) == (seed != "stdlib-only-clean")


def test_stdlib_only_bans_torch_and_triton_with_the_chain(tmp_path):
    """The port's banned set adds torch and triton; a tagged root reaches
    torch through an intermediate module, named in the chain."""
    root = _seed(tmp_path, {
        "seedpkg/sim/__init__.py": "import triton\n",
        "seedpkg/deep.py": "import torch\n",
        "seedpkg/mid.py": "from seedpkg import deep\n",
        "seedpkg/tagged.py": ("# graftlint: stdlib-only\n"
                              "from seedpkg.mid import x\n"),
    })
    fs = src_lint.run_src_lint(root, "seedpkg", rules=("stdlib-only",))
    assert _keys(fs) == ["stdlib-only:deep:torch", "stdlib-only:sim:triton"]
    chain = [f for f in fs if f.key == "stdlib-only:deep:torch"][0]
    assert "tagged <- mid <- deep" in chain.message
    # The JAX linter does not ban them.
    assert jax_src_lint.run_src_lint(root, "seedpkg",
                                     rules=("stdlib-only",)) == []


def test_engine_owns_wiring_reads_the_ports_builders(tmp_path):
    root = _seed(tmp_path, {
        "seedpkg/serving/__init__.py": "",
        "seedpkg/serving/bad.py": ("from seedpkg.parallel.zero3 import "
                                   "build_zero3_step_fn\n"),
        "seedpkg/obs/__init__.py": "",
        "seedpkg/obs/attr.py": ("def f(b):\n"
                                "    return b.bucketed_all_reduce\n"),
        "other_tool.py": "from otherpkg.sync import make_train_step\n",
        "chip_check.py": ("import seedpkg\n"
                          "from seedpkg.parallel import sharded_update\n"),
    })
    keys = _keys(src_lint.run_src_lint(root, "seedpkg",
                                       rules=("engine-owns-wiring",)))
    assert keys == [
        "engine-owns-wiring:chip_check.py:sharded_update",
        "engine-owns-wiring:seedpkg/obs/attr.py:bucketed_all_reduce",
        "engine-owns-wiring:seedpkg/serving/bad.py:build_zero3_step_fn"]


@pytest.mark.parametrize("seed", ["env", "keep-in-sync-pair",
                                  "one-liner"])
def test_fix_relints_clean_as_in_jax(tmp_path, seed):
    """--fix inserts registry stubs and re-stamps marker digests, the
    result re-lints clean of the mechanical findings, and the port's and
    the JAX package's fixes write the same bytes."""
    files = {
        "env": _SEEDS["env"],
        "keep-in-sync-pair": {k: v for k, v in _SEEDS["keep-in-sync"].items()
                              if k in ("a.py", "b.sh")},
        "one-liner": {
            "seedpkg/m.py": 'import os\nX = os.environ.get("SEED_ONE")\n',
            "seedpkg/analysis/env_registry.py":
                "ENV_REGISTRY: dict[str, str] = {}\n"},
    }[seed]
    mine = _seed(tmp_path / "port", files)
    theirs = _seed(tmp_path / "jax", files)
    assert src_lint.apply_fixes(mine, "seedpkg") == \
        jax_src_lint.apply_fixes(theirs, "seedpkg")
    for rel in files:
        with open(os.path.join(mine, rel)) as a, \
                open(os.path.join(theirs, rel)) as b:
            assert a.read() == b.read(), rel
    rules = ("env-registry", "keep-in-sync")
    assert src_lint.run_src_lint(mine, "seedpkg", rules=rules) == []


def test_keep_in_sync_drift_stales_both_sides(tmp_path):
    root = _seed(tmp_path, {k: v for k, v in _SEEDS["keep-in-sync"].items()
                            if k in ("a.py", "b.sh")})
    src_lint.apply_fixes(root, "seedpkg")
    a = os.path.join(root, "a.py")
    with open(a) as f:
        drifted = f.read().replace("# alpha", "# beta")
    with open(a, "w") as f:
        f.write(drifted)
    fs = src_lint.run_src_lint(root, "seedpkg", rules=("keep-in-sync",))
    assert _keys(fs) == ["keep-in-sync:pairdemo:a.py",
                         "keep-in-sync:pairdemo:b.sh"]
    assert all("drifted" in f.message and f.fixable for f in fs)


def test_waivers_validate_and_ratchet_as_in_jax(tmp_path):
    wpath = str(tmp_path / "waivers.json")
    entries = [
        {"key": "env-registry:LIVE", "reason": "r", "date": "2026-08-04"},
        {"key": "env-registry:GONE", "reason": "r", "date": "2026-08-04"},
        {"key": "env-registry:NODATE", "reason": "r"},
        {"key": "collective-budget:zero9:x", "reason": "r",
         "date": "2026-08-04"}]
    with open(wpath, "w") as f:
        json.dump({"waivers": entries}, f)
    waivers, wfs = load_waivers(wpath)
    jwaivers, jwfs = jax_analysis.load_waivers(wpath)
    assert waivers == jwaivers and _keys(wfs) == _keys(jwfs) == [
        "waiver-invalid:2"]
    live = Finding("env-registry", "p.py", 1, "env-registry:LIVE", "m")
    unwaived, waived, stale = apply_waivers([live], waivers,
                                            ran_rules={"env-registry"})
    assert unwaived == [] and _keys(waived) == ["env-registry:LIVE"]
    assert _keys(stale) == ["waiver-stale:env-registry:GONE"]
    with open(wpath, "w") as f:
        json.dump({"waivers": [{"key": f"k:{i}", "reason": "r",
                                "date": "2026-08-04"}
                               for i in range(WAIVER_BUDGET + 1)]}, f)
    assert _keys(load_waivers(wpath)[1]) == ["waiver-budget"]


# --- the port's own tree ---------------------------------------------------

def test_port_src_lint_is_clean_under_checked_in_waivers():
    findings = src_lint.run_src_lint(REPO, PKG)
    waivers, wfs = load_waivers(waivers_path(REPO, PKG))
    assert wfs == [] and len(waivers) <= WAIVER_BUDGET
    unwaived, _, stale = apply_waivers(findings, waivers,
                                       ran_rules=set(src_lint.SRC_RULES))
    assert unwaived == [], "\n".join(
        f"{f.rule} {f.path}:{f.line} {f.message}" for f in unwaived)
    assert stale == []


def test_port_stdlib_roots_are_the_listed_modules():
    """The torch-free roots: obs/, sim/ and the tagged modules, each of
    them importable without torch or numpy (the rule above proves it
    on the import graph)."""
    mods = src_lint._load_package(REPO, PKG)
    tagged = sorted(d for d, m in mods.items() if m.tagged)
    assert tagged == [
        "analysis", "analysis.env_registry", "analysis.src_lint",
        "cluster", "config", "engine.spec", "refusal",
        "resilience.fleet", "resilience.remediate", "resilience.scheduler",
        "resilience.supervisor", "tools.graftlint", "tools.obs_query",
        "tools.obs_report", "tools.schedule", "tools.sim_run",
        "tools.supervise", "tools.supervise_fleet", "version"]
    assert src_lint.STDLIB_ROOT_PACKAGES == ("obs", "sim")


def test_env_registry_has_no_dead_or_missing_knob():
    from distributedtensorflowexample_tpu_torch.analysis.env_registry \
        import ENV_REGISTRY
    assert list(ENV_REGISTRY) == sorted(ENV_REGISTRY)
    assert all(doc.strip() and "TODO" not in doc
               for doc in ENV_REGISTRY.values())
    fs = src_lint.run_src_lint(REPO, PKG, rules=(
        "env-registry", "env-dynamic", "env-dead"))
    assert fs == []


# --- the command line -------------------------------------------------------

def test_graftlint_cli_exit_codes(tmp_path, monkeypatch, capsys):
    out = subprocess.run(GRAFTLINT + ["--front", "src"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout
    root = _seed(tmp_path, {
        "seedpkg/m.py": 'import os\nX = os.environ.get("SEED_NOPE")\n'})
    out = subprocess.run(
        GRAFTLINT + ["--front", "src", "--root", root, "--package",
                     "seedpkg", "--json", "-"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert not payload["ok"]
    assert [f["key"] for f in payload["unwaived"]] == [
        "env-registry:SEED_NOPE"]
    # --fix stubs the knob, and the tree then lints clean.
    md = tmp_path / "report.md"
    out = subprocess.run(
        GRAFTLINT + ["--front", "src", "--root", root, "--package",
                     "seedpkg", "--fix", "--md", str(md)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "stubbed SEED_NOPE" in md.read_text()
    # An internal error is 2, never a finding.
    from distributedtensorflowexample_tpu_torch.tools import graftlint

    def broken(*a, **kw):
        raise RuntimeError("linter crashed")
    monkeypatch.setattr(graftlint.src_lint, "run_src_lint", broken)
    monkeypatch.setattr(sys, "argv", ["graftlint", "--front", "src"])
    assert graftlint._cli() == 2
    assert "linter crashed" in capsys.readouterr().err


# --- the collective front ---------------------------------------------------

def _extra_all_reduce(mesh, label, step):
    """A plant: every step all-reduces one more buffer."""
    def planted(state, batch):
        out = step(state, batch)
        mesh.all_reduce(torch.zeros(1))
        return out
    return planted


def _closing_all_gather(mesh, label, step):
    """A plant: the zero3 step closes with an all-gather of a row."""
    if label != "zero3":
        return step

    def planted(state, batch):
        out = step(state, batch)
        mesh.all_gather_into(state.optimizer.params_rows[0].detach())
        return out
    return planted


@pytest.fixture(scope="module")
def records():
    """The mode suite on two gloo ranks, clean and under each seed (one
    group), and the decode contract, clean and with a step that
    reallocates the cache."""
    from distributedtensorflowexample_tpu_torch.analysis import (
        collective_lint)

    def reallocate(engine):
        out = engine.decode()
        old = engine.cache
        old.k_store = old.k_store.clone()
        old.v_store = old.v_store.clone()
        rows = old.k.shape[1] * old.k.shape[2]
        old.k = old.k_store[:, :rows].view(old.shape)
        old.v = old.v_store[:, :rows].view(old.shape)
        return out

    return {"steps": collective_lint.collect_records(plants={
                "extra-all-reduce": _extra_all_reduce,
                "closing-all-gather": _closing_all_gather}),
            "decode": collective_lint.decode_messages(),
            "realloc": collective_lint.decode_messages(step=reallocate)}


def _check(record):
    from distributedtensorflowexample_tpu_torch.analysis import (
        collective_lint)
    return collective_lint.check_step(record)


def test_collective_front_is_clean_on_the_port(records):
    from distributedtensorflowexample_tpu_torch.analysis import (
        collective_lint)
    steps = records["steps"][""]
    assert [r["mode"] for r in steps] == [m for m, _ in
                                          collective_lint.MODE_SUITE]
    for r in steps:
        assert _check(r) == [], (r["mode"], [f.message for f in _check(r)])
        assert {d for _, d in r["order"]} == {"float32"}
    by_mode = {r["mode"]: r for r in steps}
    assert by_mode["zero3"]["num_buckets"] == 2        # a real ladder
    assert [k for k, _ in by_mode["zero3"]["order"]] == [
        "all-gather", "all-gather", "reduce-scatter", "reduce-scatter"]
    assert [k for k, _ in by_mode["zero1"]["order"]] == [
        "reduce-scatter", "all-gather"] * 2
    assert records["decode"] == []


def test_collective_front_fires_on_an_extra_all_reduce(records):
    for r in records["steps"]["extra-all-reduce"]:
        assert _keys(_check(r)) == [
            f"collective-budget:{r['mode']}:all-reduce"]


def test_collective_front_fires_on_a_closing_all_gather(records):
    by_mode = {r["mode"]: r for r in records["steps"]["closing-all-gather"]}
    assert _keys(_check(by_mode.pop("zero3"))) == [
        "collective-ag-before-rs:zero3:count",
        "collective-budget:zero3:all-gather",
        "collective-trailing-ag:zero3"]
    assert all(_check(r) == [] for r in by_mode.values())


def test_decode_contract_fires_on_a_reallocated_cache(records):
    from distributedtensorflowexample_tpu_torch.analysis import (
        collective_lint)
    fs = collective_lint.decode_findings(records["realloc"])
    assert len(fs) == 1 and fs[0].rule == "decode-contract"
    assert "storage moved" in fs[0].message


def _record(mode, order, budget, counts=None):
    kinds = [k for k, _ in order]
    return {"mode": mode, "order": order, "budget": budget,
            "collectives": counts or {k: kinds.count(k) for k in set(kinds)}}


_AG, _RS, _AR = ("all-gather", "float32"), ("reduce-scatter", "float32"), \
    ("all-reduce", "float32")


@pytest.mark.parametrize("mode,order,budget,want", [
    ("zero3", [_AG, _RS], {"all-gather": 1, "reduce-scatter": 1}, []),
    ("zero3", [_RS, _AG], {"all-gather": 1, "reduce-scatter": 1},
     ["collective-ag-before-rs:zero3:0", "collective-trailing-ag:zero3"]),
    ("zero1", [_RS, _AG], {"all-gather": 1, "reduce-scatter": 1}, []),
    ("zero1", [_RS], {"all-gather": 1, "reduce-scatter": 1},
     ["collective-budget:zero1:all-gather",
      "collective-rs-ag-pair:zero1:count"]),
    ("zero1", [_AG, _RS], {"all-gather": 1, "reduce-scatter": 1},
     ["collective-rs-ag-pair:zero1:0"]),
    ("bucketed", [_AR, _AR, ("all-to-all", "float32")], {"all-reduce": 2},
     ["collective-budget:bucketed:all-to-all"]),
    ("sync_dp", [("all-reduce", "float64")], {"all-reduce": 1},
     ["collective-dtype:sync_dp:float64"]),
    ("sync_dp", [], None, ["collective-contract:sync_dp:budget"]),
])
def test_collective_rules_on_seeded_schedules(mode, order, budget, want):
    assert _keys(_check(_record(mode, order, budget))) == sorted(want)
