# graftlint: stdlib-only
"""The port's source front of graftlint: AST rules over
``distributedtensorflowexample_tpu_torch/`` (the JAX package's
``analysis/src_lint.py``, with the port's roots, banned set and names).

* ``stdlib-only``: from every torch-free root, the whole module-level
  import graph reaches no third-party package of
  :data:`BANNED_THIRD_PARTY` (the JAX package's set plus ``torch`` and
  ``triton``); the finding names the import chain.  The roots are
  ``obs/`` and ``sim/`` (:data:`STDLIB_ROOT_PACKAGES`) and every module
  tagged with the stdlib-only comment line: ``engine/spec.py``,
  ``cluster.py``, ``config.py``, ``refusal.py``, the control plane
  (``resilience/supervisor.py``, ``fleet.py``, ``scheduler.py``,
  ``remediate.py``) and its commands (``tools/supervise.py``,
  ``supervise_fleet.py``, ``schedule.py``), the readers and the
  simulator's driver (``tools/obs_query.py``, ``obs_report.py``,
  ``sim_run.py``), the records' comparator (``tools/bench_ratchet.py``),
  ``tools/graftlint.py`` and ``analysis/`` itself
  (``resilience/faults.py`` injects faults into a training process and
  imports torch).
* ``env-registry`` / ``env-dynamic`` / ``env-dead``: every named
  ``os.environ`` read in the package is declared in
  :mod:`analysis.env_registry` with a line of documentation; a dynamic
  read resolves through constant call sites; an entry nothing reads is
  a dead knob.
* ``named-refusal``: a ``raise ValueError`` whose message names a CLI
  flag (``--token``) is a mode-legality refusal and raises the port's
  :class:`~distributedtensorflowexample_tpu_torch.refusal.ModeRefusal`.
* ``clock-seam``: no bare ``time.time()``/``time.monotonic()``/
  ``datetime.now()`` in ``obs/``, nor in the control plane the
  simulator's virtual clock drives (``resilience/scheduler.py``,
  ``resilience/remediate.py``), outside the ``obs/metrics.py`` seam
  (``_now``/``_wall``).
* ``keep-in-sync``: paired digest markers over the whole repository
  agree with their regions' current content (the marker word is built
  by concatenation below, so no file of the port carries one).
* ``engine-owns-wiring``: the port's step builders, bucketed
  collectives and ZeRO-3 layout (:data:`WIRING_NAMES`) are imported or
  referenced only under ``engine/`` and ``parallel/``, in the package
  and in the repo's root and ``tools/`` scripts that import it
  (``chip_smoke.py``); ``tests/`` are exempt, and
  :data:`WIRING_ALLOWLIST` holds the standing exceptions with their
  reasons.

Stdlib only, and itself a stdlib-only root.  Every function takes the
repo root and the package name, so the tests run the same rules over
seeded trees.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re

from distributedtensorflowexample_tpu_torch.analysis import Finding

SRC_RULES = ("stdlib-only", "env-registry", "env-dynamic", "env-dead",
             "named-refusal", "clock-seam", "keep-in-sync",
             "engine-owns-wiring")

STDLIB_TAG = "graftlint: stdlib-only"
#: Import-time reachability to any of these fails the stdlib-only rule:
#: the JAX package's set, plus the port's own heavy imports.
BANNED_THIRD_PARTY = frozenset({
    "jax", "jaxlib", "numpy", "flax", "optax", "tensorflow", "orbax",
    "scipy", "ml_dtypes", "torch", "triton"})
#: Subpackages whose every module is a stdlib-only root (besides the
#: tagged modules).
STDLIB_ROOT_PACKAGES = ("obs", "sim")

_FLAG_RE = re.compile(r"--[a-z][a-z0-9_]+")
_SKIP_DIRS = frozenset({"__pycache__", ".git", ".pytest_cache", ".claude",
                        "node_modules", ".ipynb_checkpoints"})

# Built by concatenation so this module's own source never matches the
# scanner (the begin form requires a literal "(" right after the word).
_MARK_WORD = "KEEP-IN-" + "SYNC"
_MARK_BEGIN_RE = re.compile(
    _MARK_WORD + r"\(([A-Za-z0-9._\-]+)\)(?:\s+digest=([0-9a-f]{6,}))?")
_MARK_END_RE = re.compile(_MARK_WORD + r"-END\(([A-Za-z0-9._\-]+)\)")
_DIGEST_LEN = 12


def _walk_files(root: str, exts: tuple[str, ...]):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS
                             and not d.startswith("."))
        for name in sorted(filenames):
            if os.path.splitext(name)[1] in exts:
                yield os.path.join(dirpath, name)


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


# ---------------------------------------------------------------------------
# Package model: every module parsed once, shared by the AST rules.

class _Module:
    def __init__(self, dotted: str, path: str, source: str,
                 tree: ast.AST, is_pkg: bool):
        self.dotted = dotted          # "" = the package itself
        self.path = path
        self.source = source
        self.tree = tree
        self.is_pkg = is_pkg
        # The tag must be a COMMENT LINE of its own — prose merely
        # mentioning the phrase (a docstring describing the rule) must
        # not turn a jax-importing module into a stdlib-only root.
        self.tagged = any(line.strip() == "# " + STDLIB_TAG
                          for line in source.splitlines())


def _load_package(repo_root: str, package: str) -> dict[str, _Module]:
    pkg_dir = os.path.join(repo_root, package)
    mods: dict[str, _Module] = {}
    for path in _walk_files(pkg_dir, (".py",)):
        rel = os.path.relpath(path, pkg_dir).replace(os.sep, "/")
        parts = rel[:-3].split("/")
        is_pkg = parts[-1] == "__init__"
        if is_pkg:
            parts = parts[:-1]
        dotted = ".".join(parts)
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue    # not this linter's finding to report
        mods[dotted] = _Module(dotted, path, source, tree, is_pkg)
    return mods


class _ImportCollector(ast.NodeVisitor):
    """Module-level imports only (class bodies and top-level try/if
    execute at import; function bodies are lazy and out of scope —
    exactly the boundary an import in a fresh interpreter measures)."""

    def __init__(self, package: str, mod: _Module, known: set[str]):
        self._package = package
        self._mod = mod
        self._known = known
        self.external: list[tuple[str, int]] = []   # (top name, lineno)
        self.internal: list[tuple[str, int]] = []   # (dotted, lineno)

    def visit_FunctionDef(self, node):      # noqa: N802 - ast API
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _add_internal(self, dotted: str, lineno: int) -> None:
        # Importing a.b.c executes a/__init__ and a.b/__init__ too.
        parts = dotted.split(".") if dotted else []
        for i in range(len(parts) + 1):
            anc = ".".join(parts[:i])
            if anc in self._known:
                self.internal.append((anc, lineno))

    def visit_Import(self, node):           # noqa: N802 - ast API
        for alias in node.names:
            top = alias.name.split(".")[0]
            if top == self._package:
                self._add_internal(alias.name[len(self._package) + 1:],
                                   node.lineno)
            else:
                self.external.append((top, node.lineno))

    def visit_ImportFrom(self, node):       # noqa: N802 - ast API
        if node.level:
            parts = self._mod.dotted.split(".") if self._mod.dotted else []
            pkg_parts = parts if self._mod.is_pkg else parts[:-1]
            up = node.level - 1
            base_parts = pkg_parts[:len(pkg_parts) - up] if up else pkg_parts
            base = ".".join(base_parts + (node.module.split(".")
                                          if node.module else []))
        elif node.module:
            top = node.module.split(".")[0]
            if top != self._package:
                self.external.append((top, node.lineno))
                return
            base = node.module[len(self._package) + 1:]
        else:
            return
        self._add_internal(base, node.lineno)
        for alias in node.names:
            cand = (base + "." if base else "") + alias.name
            if cand in self._known:
                self._add_internal(cand, node.lineno)


def check_stdlib_only(repo_root: str, package: str,
                      mods: dict[str, _Module] | None = None
                      ) -> list[Finding]:
    """The import-graph proof: from every stdlib-only root (obs/, sim/
    and the tagged modules), walk intra-package module-level imports and
    flag any reachable module that imports a banned third-party name.
    The finding message carries the chain."""
    mods = mods if mods is not None else _load_package(repo_root, package)
    known = set(mods)
    imports: dict[str, _ImportCollector] = {}
    for dotted, mod in mods.items():
        col = _ImportCollector(package, mod, known)
        col.visit(mod.tree)
        imports[dotted] = col

    roots = sorted(d for d, m in mods.items() if m.tagged or any(
        d == p or d.startswith(p + ".") for p in STDLIB_ROOT_PACKAGES))
    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for root in roots:
        if root not in mods:
            continue
        parent: dict[str, str | None] = {root: None}
        queue = [root]
        while queue:
            cur = queue.pop(0)
            for name, lineno in imports[cur].external:
                if name in BANNED_THIRD_PARTY and (cur, name) not in seen:
                    seen.add((cur, name))
                    chain: list[str] = []
                    node: str | None = cur
                    while node is not None:
                        chain.append(node or package)
                        node = parent[node]
                    findings.append(Finding(
                        "stdlib-only", _rel(mods[cur].path, repo_root),
                        lineno, f"stdlib-only:{cur or package}:{name}",
                        f"stdlib-only module {chain[-1]} reaches "
                        f"third-party {name!r} at import time via "
                        f"{' <- '.join(reversed(chain))}"))
            for dep, _ in imports[cur].internal:
                if dep not in parent:
                    parent[dep] = cur
                    queue.append(dep)
    return findings


# ---------------------------------------------------------------------------
# Env registry rule.

_ENV_READ_ATTRS = frozenset({"get", "setdefault", "pop"})


class _EnvCollector(ast.NodeVisitor):
    """Collects env-knob uses, resolving the import idioms first:
    ``os.environ`` / ``os.getenv`` through any ``import os as X``
    alias, and ``from os import environ/getenv`` (with or without
    ``as``) — the same no-laundering stance the clock-seam rule takes,
    so a one-line idiom change cannot hide a knob from the registry."""

    def __init__(self, tree: ast.AST):
        self.named: list[tuple[str, int]] = []      # (VAR, lineno)
        self.dynamic: list[tuple[str, int]] = []    # (funcname, lineno)
        self._func_stack: list[str] = []
        self._os_names = {"os"}
        self._environ_names: set[str] = set()
        self._getenv_names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "os":
                        self._os_names.add(a.asname or "os")
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                for a in node.names:
                    if a.name == "environ":
                        self._environ_names.add(a.asname or a.name)
                    elif a.name == "getenv":
                        self._getenv_names.add(a.asname or a.name)

    def _is_environ(self, node) -> bool:
        if (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id in self._os_names):
            return True
        return (isinstance(node, ast.Name)
                and node.id in self._environ_names)

    def _record(self, arg, lineno: int) -> None:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.named.append((arg.value, lineno))
        else:
            self.dynamic.append((self._func_stack[-1]
                                 if self._func_stack else "<module>",
                                 lineno))

    def visit_FunctionDef(self, node):      # noqa: N802 - ast API
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):             # noqa: N802 - ast API
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in _ENV_READ_ATTRS
                and self._is_environ(func.value) and node.args):
            self._record(node.args[0], node.lineno)
        elif (isinstance(func, ast.Attribute) and func.attr == "getenv"
                and isinstance(func.value, ast.Name)
                and func.value.id in self._os_names and node.args):
            self._record(node.args[0], node.lineno)
        elif (isinstance(func, ast.Name)
                and func.id in self._getenv_names and node.args):
            self._record(node.args[0], node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):        # noqa: N802 - ast API
        if self._is_environ(node.value):
            self._record(node.slice, node.lineno)
        self.generic_visit(node)

    def visit_Compare(self, node):          # noqa: N802 - ast API
        if (len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and self._is_environ(node.comparators[0])):
            self._record(node.left, node.lineno)
        self.generic_visit(node)


def load_env_registry(repo_root: str, package: str) -> dict[str, str]:
    """Parse ``<package>/analysis/env_registry.py`` WITHOUT importing it
    (the linter must run over seeded tmp trees that are not on
    sys.path): the ENV_REGISTRY dict literal is extracted by AST."""
    path = os.path.join(repo_root, package, "analysis", "env_registry.py")
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "ENV_REGISTRY":
                try:
                    return ast.literal_eval(node.value)
                except ValueError:
                    return {}
    return {}


def check_env_registry(repo_root: str, package: str,
                       mods: dict[str, _Module] | None = None,
                       registry: dict[str, str] | None = None
                       ) -> list[Finding]:
    mods = mods if mods is not None else _load_package(repo_root, package)
    if registry is None:
        registry = load_env_registry(repo_root, package)

    per_mod: dict[str, _EnvCollector] = {}
    for dotted, mod in mods.items():
        col = _EnvCollector(mod.tree)
        col.visit(mod.tree)
        per_mod[dotted] = col

    # Dynamic reads resolve through their enclosing helper's constant
    # call sites anywhere in the package (obs/ledger.py's _env_float
    # pattern): _env_float("OBS_LEDGER_SAMPLE_S", 30.0) IS a read of
    # that name.  A helper no constant call site names stays a finding.
    dyn_funcs = {fn for col in per_mod.values() for fn, _ in col.dynamic
                 if fn != "<module>"}
    resolved: dict[str, list[tuple[str, str, int]]] = {f: []
                                                       for f in dyn_funcs}
    if dyn_funcs:
        for dotted, mod in mods.items():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                if (fname in dyn_funcs
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    resolved[fname].append(
                        (node.args[0].value, dotted, node.lineno))

    findings: list[Finding] = []
    reported: set[str] = set()
    used_names: set[str] = set()

    def check_name(name: str, path: str, lineno: int) -> None:
        used_names.add(name)
        if name in registry or name in reported:
            return
        reported.add(name)
        findings.append(Finding(
            "env-registry", path, lineno, f"env-registry:{name}",
            f"env knob {name!r} is read but not declared in "
            f"analysis/env_registry.py (one line of doc, or delete the "
            f"knob)", fixable=True))

    for dotted, col in sorted(per_mod.items()):
        rel = _rel(mods[dotted].path, repo_root)
        for name, lineno in col.named:
            check_name(name, rel, lineno)
        for fn, lineno in col.dynamic:
            sites = resolved.get(fn, [])
            if sites:
                for name, site_mod, site_line in sites:
                    check_name(name, _rel(mods[site_mod].path, repo_root),
                               site_line)
            else:
                findings.append(Finding(
                    "env-dynamic", rel, lineno,
                    f"env-dynamic:{rel}:{fn}",
                    f"dynamic os.environ read in {fn}() resolves through "
                    f"no constant call site — name the knob statically "
                    f"or register the helper's call sites"))

    reg_rel = f"{package}/analysis/env_registry.py"
    for name in sorted(set(registry) - used_names):
        findings.append(Finding(
            "env-dead", reg_rel, 0, f"env-dead:{name}",
            f"registry entry {name!r} is read by no package code — a "
            f"dead knob; delete the entry (and any docs)"))
    return findings


# ---------------------------------------------------------------------------
# Named-refusal rule.

def _raise_message_text(call: ast.Call) -> str:
    parts: list[str] = []
    for node in ast.walk(call):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            parts.append(node.value)
    return "".join(parts)


def check_named_refusal(repo_root: str, package: str,
                        mods: dict[str, _Module] | None = None
                        ) -> list[Finding]:
    mods = mods if mods is not None else _load_package(repo_root, package)
    findings: list[Finding] = []
    for dotted in sorted(mods):
        mod = mods[dotted]
        rel = _rel(mod.path, repo_root)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and isinstance(node.exc.func, ast.Name)
                    and node.exc.func.id == "ValueError"):
                continue
            text = _raise_message_text(node.exc)
            m = _FLAG_RE.search(text)
            if not m:
                continue
            digest = hashlib.sha256(text.encode()).hexdigest()[:8]
            findings.append(Finding(
                "named-refusal", rel, node.lineno,
                f"named-refusal:{rel}:{digest}",
                f"mode-legality refusal names {m.group(0)} but raises "
                f"bare ValueError — raise refusal.ModeRefusal so the "
                f"refusal surface stays one grep"))
    return findings


# ---------------------------------------------------------------------------
# Clock-seam rule (obs/ plus the seam-consuming control plane).

_CLOCK_FUNCS = frozenset({"time", "monotonic", "perf_counter",
                          "monotonic_ns", "time_ns"})
_NOW_FUNCS = frozenset({"now", "utcnow", "today"})
#: Modules outside obs/ that the sim's virtual clock must fully own —
#: the scheduler and remediator make every decision through
#: obs/metrics._now/_wall (their ``_sleep = time.sleep`` module seams
#: are assignments, not calls, so the rule never flags the seams
#: themselves).
_CLOCK_SEAM_EXTRA = frozenset({
    "resilience.scheduler", "resilience.remediate"})


def check_clock_seam(repo_root: str, package: str,
                     mods: dict[str, _Module] | None = None
                     ) -> list[Finding]:
    mods = mods if mods is not None else _load_package(repo_root, package)
    findings: list[Finding] = []
    for dotted in sorted(mods):
        # obs/ plus the control-plane modules sim/'s virtual clock must
        # fully own: one bare read in a decision path and two same-seed
        # simulator runs stop being bitwise-identical.
        if not (dotted == "obs" or dotted.startswith("obs.")
                or dotted in _CLOCK_SEAM_EXTRA):
            continue
        if dotted == "obs.metrics":     # the seam's home
            continue
        mod = mods[dotted]
        rel = _rel(mod.path, repo_root)
        # Aliases don't launder the clock: `import time as t` /
        # `from time import time as _t` bind local names that resolve
        # back to the module/function they came from before matching.
        mod_alias: dict[str, str] = {}      # local name -> clock module
        bound: dict[str, str] = {}          # local name -> original func
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in ("time", "datetime"):
                        mod_alias[a.asname or a.name] = a.name
            elif (isinstance(node, ast.ImportFrom)
                    and node.module in ("time", "datetime")):
                for a in node.names:
                    bound[a.asname or a.name] = a.name
        count = 0
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            parts: list[str] = []
            f = node.func
            root_bound = False
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                # Resolve the root through both alias tables: `import
                # time as t` and `from datetime import datetime as dt`
                # must match as their originals; a same-named LOCAL
                # helper (no time/datetime import behind it) must not.
                root_bound = f.id in mod_alias or f.id in bound
                parts.append(mod_alias.get(f.id) or bound.get(f.id)
                             or f.id)
            parts.reverse()
            dotted_call = ".".join(parts)
            bad = False
            if len(parts) >= 2 and parts[-2] == "time" \
                    and parts[-1] in _CLOCK_FUNCS:
                bad = True
            elif parts and parts[-1] in _NOW_FUNCS \
                    and any(p in ("datetime", "date") for p in parts[:-1]):
                bad = True
            elif len(parts) == 1 and root_bound and parts[0] in (
                    _CLOCK_FUNCS | _NOW_FUNCS):
                bad = True
            if bad:
                count += 1
                findings.append(Finding(
                    "clock-seam", rel, node.lineno,
                    f"clock-seam:{rel}:{dotted_call}:{count}",
                    f"bare {dotted_call}() in {dotted} — go through "
                    f"the obs/metrics.py seam (_now/_wall) so flight "
                    f"dumps and sim runs stay bitwise-pinnable"))
    return findings


# ---------------------------------------------------------------------------
# Keep-in-sync digest markers.

class _SyncBlock:
    def __init__(self, path: str, marker_line: int, ident: str,
                 digest: str | None):
        self.path = path                # absolute
        self.marker_line = marker_line  # 1-based line of the BEGIN marker
        self.ident = ident
        self.digest = digest
        self.body: list[str] = []
        self.closed = False


def _norm_sync_line(line: str) -> str | None:
    s = line.strip()
    for prefix in ("#", "//"):
        if s.startswith(prefix):
            s = s[len(prefix):].strip()
    return s or None


def collect_sync_blocks(repo_root: str) -> tuple[list[_SyncBlock],
                                                 list[Finding]]:
    blocks: list[_SyncBlock] = []
    findings: list[Finding] = []
    for path in _walk_files(repo_root, (".py", ".sh", ".md")):
        rel = _rel(path, repo_root)
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except (OSError, UnicodeDecodeError):
            continue
        open_block: _SyncBlock | None = None
        for i, line in enumerate(lines, 1):
            me = _MARK_END_RE.search(line)
            if me:
                if open_block is None or open_block.ident != me.group(1):
                    findings.append(Finding(
                        "keep-in-sync", rel, i,
                        f"keep-in-sync:{me.group(1)}:stray-end",
                        f"{_MARK_WORD}-END({me.group(1)}) without a "
                        f"matching begin marker"))
                else:
                    open_block.closed = True
                    blocks.append(open_block)
                    open_block = None
                continue
            mb = _MARK_BEGIN_RE.search(line)
            if mb:
                if open_block is not None:
                    findings.append(Finding(
                        "keep-in-sync", rel, open_block.marker_line,
                        f"keep-in-sync:{open_block.ident}:unterminated",
                        f"{_MARK_WORD}({open_block.ident}) never "
                        f"terminated before the next marker"))
                open_block = _SyncBlock(path, i, mb.group(1), mb.group(2))
                continue
            if open_block is not None:
                open_block.body.append(line)
        if open_block is not None:
            findings.append(Finding(
                "keep-in-sync", rel, open_block.marker_line,
                f"keep-in-sync:{open_block.ident}:unterminated",
                f"{_MARK_WORD}({open_block.ident}) never terminated"))
    return blocks, findings


def _expected_digest(group: list[_SyncBlock], repo_root: str) -> str:
    group = sorted(group, key=lambda b: (_rel(b.path, repo_root),
                                         b.marker_line))
    h = hashlib.sha256()
    for b in group:
        h.update(_rel(b.path, repo_root).encode())
        h.update(b"\x01")
        for line in b.body:
            norm = _norm_sync_line(line)
            if norm is not None:
                h.update(norm.encode())
                h.update(b"\n")
        h.update(b"\x00")
    return h.hexdigest()[:_DIGEST_LEN]


def check_keep_in_sync(repo_root: str) -> list[Finding]:
    blocks, findings = collect_sync_blocks(repo_root)
    by_id: dict[str, list[_SyncBlock]] = {}
    for b in blocks:
        by_id.setdefault(b.ident, []).append(b)
    for ident in sorted(by_id):
        group = by_id[ident]
        if len(group) < 2:
            b = group[0]
            findings.append(Finding(
                "keep-in-sync", _rel(b.path, repo_root), b.marker_line,
                f"keep-in-sync:{ident}:unpaired",
                f"{_MARK_WORD}({ident}) has no partner block — the "
                f"marker exists to pair mirrored regions across files"))
            continue
        want = _expected_digest(group, repo_root)
        for b in group:
            rel = _rel(b.path, repo_root)
            if b.digest is None:
                findings.append(Finding(
                    "keep-in-sync", rel, b.marker_line,
                    f"keep-in-sync:{ident}:{os.path.basename(rel)}",
                    f"{_MARK_WORD}({ident}) carries no digest= — run "
                    f"tools.graftlint --fix to stamp {want}",
                    fixable=True))
            elif b.digest != want:
                findings.append(Finding(
                    "keep-in-sync", rel, b.marker_line,
                    f"keep-in-sync:{ident}:{os.path.basename(rel)}",
                    f"{_MARK_WORD}({ident}) digest {b.digest} != current "
                    f"pair content {want}: the mirrored regions drifted "
                    f"— re-sync them, then --fix to re-stamp",
                    fixable=True))
    return findings


# ---------------------------------------------------------------------------
# Engine-owns-wiring rule.

#: The port's raw step wiring: the ``parallel/`` step builders
#: (``sync``, ``async_ps``, ``zero3``), the bucketed collectives
#: (``bucketing``) and the ZeRO-3 layout.  Importing or referencing any
#: of them outside ``engine/`` and ``parallel/`` forks the Engine's
#: wiring (``make_mesh``, ``Engine.build`` and ``launch.spawn`` stay
#: legal everywhere).
WIRING_NAMES = frozenset({
    "make_train_step", "make_indexed_train_step", "make_async_train_step",
    "make_indexed_async_train_step", "build_zero3_step_fn", "Zero3Layout",
    "bucketed_all_reduce", "sharded_update"})

#: Standing, reviewed exceptions (repo-relative path -> why raw wiring
#: is that file's job).  Anything else goes through the waiver budget.
WIRING_ALLOWLIST = {
    "distributedtensorflowexample_tpu_torch/serving/sharded.py":
        "the sharded decode engine reads its parameters through the "
        "ZeRO-3 layout's gathers: serving's analogue of parallel/",
    "distributedtensorflowexample_tpu_torch/serving/promote.py":
        "row promotion builds the Zero3Layout its rows are cut by; the "
        "training-side re-layout goes through engine.apply_update_layout",
    "distributedtensorflowexample_tpu_torch/tools/faultline.py":
        "fault-injection drills drive a minimal raw step on purpose",
}


def _imports_package(tree: ast.AST, package: str) -> bool:
    """Whether a script imports ``package`` anywhere (a repo-root or
    ``tools/`` script of another package is not this rule's)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == package for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level \
                and node.module.split(".")[0] == package:
            return True
    return False


def check_engine_owns_wiring(repo_root: str, package: str,
                             mods: dict[str, _Module] | None = None
                             ) -> list[Finding]:
    """Flag imports/attribute references of :data:`WIRING_NAMES`
    outside ``engine/`` and ``parallel/``: package modules, and the
    repo-root and ``tools/`` scripts that import the package
    (function-level imports count: lazy wiring is still wiring).
    Docstrings mentioning the names never match (AST, not grep)."""
    mods = mods if mods is not None else _load_package(repo_root, package)
    targets: list[tuple[str, ast.AST]] = []
    for dotted in sorted(mods):
        if dotted.split(".")[0] in ("engine", "parallel"):
            continue
        targets.append((_rel(mods[dotted].path, repo_root),
                        mods[dotted].tree))
    for sub in ("", "tools"):
        d = os.path.join(repo_root, sub) if sub else repo_root
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            try:
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue
            if _imports_package(tree, package):
                targets.append((_rel(path, repo_root), tree))

    findings: list[Finding] = []
    for rel, tree in targets:
        if rel in WIRING_ALLOWLIST:
            continue
        seen: set[str] = set()

        def hit(name: str, lineno: int, rel=rel, seen=seen) -> None:
            if name in seen:
                return
            seen.add(name)
            findings.append(Finding(
                "engine-owns-wiring", rel, lineno,
                f"engine-owns-wiring:{rel}:{name}",
                f"raw step-wiring name {name!r} referenced outside "
                f"engine/ and parallel/ — declare a RunSpec and let "
                f"engine.Engine own the wiring (standing exceptions: "
                f"src_lint.WIRING_ALLOWLIST)"))

        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name.split(".")[-1] in WIRING_NAMES:
                        hit(a.name.split(".")[-1], node.lineno)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[-1] in WIRING_NAMES:
                        hit(a.name.split(".")[-1], node.lineno)
            elif isinstance(node, ast.Attribute):
                if node.attr in WIRING_NAMES:
                    hit(node.attr, node.lineno)
    return findings


# ---------------------------------------------------------------------------
# Driver + mechanical fixes.

def run_src_lint(repo_root: str,
                 package: str = "distributedtensorflowexample_tpu_torch",
                 registry: dict[str, str] | None = None,
                 rules: tuple[str, ...] | None = None) -> list[Finding]:
    """Run the source front; returns findings sorted (rule, path, line).
    ``rules`` narrows (default: all of :data:`SRC_RULES`)."""
    active = set(rules if rules is not None else SRC_RULES)
    mods = _load_package(repo_root, package)
    findings: list[Finding] = []
    if "stdlib-only" in active:
        findings += check_stdlib_only(repo_root, package, mods)
    if active & {"env-registry", "env-dynamic", "env-dead"}:
        env = check_env_registry(repo_root, package, mods, registry)
        findings += [f for f in env if f.rule in active]
    if "named-refusal" in active:
        findings += check_named_refusal(repo_root, package, mods)
    if "clock-seam" in active:
        findings += check_clock_seam(repo_root, package, mods)
    if "keep-in-sync" in active:
        findings += check_keep_in_sync(repo_root)
    if "engine-owns-wiring" in active:
        findings += check_engine_owns_wiring(repo_root, package, mods)
    findings.sort(key=lambda f: (f.rule, f.path, f.line))
    return findings


def fix_env_registry(repo_root: str, package: str,
                     names: list[str]) -> list[str]:
    """Insert TODO-doc stubs for *names* into env_registry.py (creates
    the file if the seeded tree lacks one).  Mechanical on purpose: the
    stub lints clean so --fix converges, and the TODO text is the
    reviewer's cue to write the real one-liner."""
    if not names:
        return []
    path = os.path.join(repo_root, package, "analysis", "env_registry.py")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write('"""Env-knob registry (graftlint --fix seeded)."""\n\n'
                    "ENV_REGISTRY: dict[str, str] = {\n}\n")
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines(keepends=True)
    stubs = [f'    "{n}": (\n        "TODO: document this knob '
             f'(inserted by graftlint --fix)."),\n'
             for n in sorted(names)]
    # Anchor on the ENV_REGISTRY assignment itself, not the file's
    # last bare brace: the registry may not be the file's final
    # structure, and a one-liner `= {}` form has no bare-brace line.
    start = next((i for i, ln in enumerate(lines)
                  if ln.lstrip().startswith("ENV_REGISTRY")), None)
    if start is None:
        return [f"env-registry: could not find ENV_REGISTRY in {path} "
                f"— add entries for {', '.join(sorted(names))} by hand"]
    if "{}" in lines[start]:
        lines[start] = lines[start].replace(
            "{}", "{\n" + "".join(stubs) + "}", 1)
    else:
        close = next((i for i in range(start, len(lines))
                      if lines[i].rstrip() == "}"), None)
        if close is None:
            return [f"env-registry: could not find the closing brace "
                    f"of ENV_REGISTRY in {path} — add entries for "
                    f"{', '.join(sorted(names))} by hand"]
        lines[close:close] = stubs
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(lines))
    return [f"env-registry: stubbed {n} in {package}/analysis/"
            f"env_registry.py" for n in sorted(names)]


def fix_keep_in_sync(repo_root: str) -> list[str]:
    """Re-stamp every paired marker group's digest to its current pair
    content.  Only the ``digest=`` token on the BEGIN line changes."""
    blocks, _ = collect_sync_blocks(repo_root)
    by_id: dict[str, list[_SyncBlock]] = {}
    for b in blocks:
        by_id.setdefault(b.ident, []).append(b)
    applied: list[str] = []
    by_path: dict[str, list[tuple[_SyncBlock, str]]] = {}
    for ident in sorted(by_id):
        group = by_id[ident]
        if len(group) < 2:
            continue
        want = _expected_digest(group, repo_root)
        for b in group:
            if b.digest != want:
                by_path.setdefault(b.path, []).append((b, want))
    for path, edits in by_path.items():
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines(keepends=True)
        for b, want in edits:
            i = b.marker_line - 1
            line = lines[i]
            marker = f"{_MARK_WORD}({b.ident})"
            if b.digest is not None:
                line = line.replace(f"{marker} digest={b.digest}",
                                    f"{marker} digest={want}", 1)
            else:
                line = line.replace(marker, f"{marker} digest={want}", 1)
            lines[i] = line
            applied.append(f"keep-in-sync: {b.ident} digest={want} in "
                           f"{_rel(path, repo_root)}")
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(lines))
    return applied


def apply_fixes(repo_root: str,
                package: str = "distributedtensorflowexample_tpu_torch",
                findings: list[Finding] | None = None) -> list[str]:
    """The --fix entry point: registry stubs + marker digest refresh
    (the two mechanical rules).  Returns human-readable descriptions;
    run the lint again afterwards — the contract is that the result
    re-lints clean."""
    if findings is None:
        findings = run_src_lint(repo_root, package)
    missing = sorted({f.key.split(":", 1)[1] for f in findings
                      if f.rule == "env-registry" and f.fixable})
    out = fix_env_registry(repo_root, package, missing)
    out += fix_keep_in_sync(repo_root)
    return out
