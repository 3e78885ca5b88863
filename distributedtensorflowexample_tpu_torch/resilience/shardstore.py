"""Shard-redundant crash-consistent snapshots for the 1/D row layouts (the
JAX package's ``resilience/shardstore.py`` over the port's ranks).

``resilience/snapshot.py`` writes ONE monolithic payload per step — the
right recovery format for a tree-layout run, and the wrong one for
zero1/zero3 (``--bucket_grads`` with ``--shard_update`` or
``--shard_params``): there each rank owns a 1/D row of every bucket, so a
full-state payload would gather state the rank does not own and couple
every rank's save to one file.  This store writes what the layout is,
in the JAX store's files and manifest:

- **per-rank shards**: rank r saves only ITS row of every bucket
  (``own.npz`` under ``shards_<step>/rank_<r>/``) — parameter rows under
  zero3 (``params__<b>``), momentum rows under both row layouts
  (``opt_state__<b>``), and this rank's dropout generator
  (``generator__00000``: the port keeps one per rank, where the JAX
  state keeps one replicated key);
- **ring mirrors** (redundancy R, ``SNAPSHOT_REDUNDANCY``, default 2):
  rank r writes the same bytes as ``mirror_<r>.npz`` into the
  directories of its R-1 ring successors, so ANY R-1 lost or corrupt
  rank directories still leave every shard one intact copy;
- **replicated leaves** (step, the optimizer's count, the model's
  buffers — and under zero1 the parameters, which stay replicated, as
  ``params__<i>`` in the JAX package's leaf order) land in ``repl.npz``
  on ranks ``0..R-1``;
- **quorum manifest, written LAST** by rank 0: sha256 per shard, the
  layout facts (mesh width D, bucket plan, leaf specs, bucket_bytes) —
  a step is quorum-valid iff every shard and the replicated payload have
  at least one digest-intact copy.  A write torn anywhere before the
  manifest leaves no manifest and the step reads as absent; a bit flipped
  after commit fails its sha256 and that COPY is refused, never restored.

The directory is shared by the ranks (one host, or a shared file system).
A save is one collective protocol, outside the train step: every rank
brings its rows to the host, encodes and writes its own payloads (the obs
atomic write, tmp + fsync + rename, with bounded retry and backoff on
OSError: ``SNAPSHOT_IO_RETRIES``, ``SNAPSHOT_IO_BACKOFF_S``) and fsyncs
its directories; then ONE all-gather hands every rank every rank's
(success, digests, bytes) — the agreement and the gather of the digests
in one collective — and rank 0 writes the manifest only if every rank
succeeded; one small all-reduce then tells every rank whether the
manifest committed.  A failure anywhere before the agreement (in the
encoding as much as in the writes) skips the manifest and raises on
every rank — OSError on the others, so every rank counts
``ckpt_shard_save_failures`` — and none is left waiting in a
collective.  These collectives are not counted in ``Mesh.collectives``:
the step's budget is unchanged.  npz payloads are written with fixed zip
timestamps, so equal content is equal bytes (the ranks' ``repl.npz``
copies share one digest).

Restore comes in two shapes.  Each reads every copy it needs once, from
the first digest-intact one (own first, ring mirrors after), with no
separate validation pass: asked for the newest set, it falls back to the
next older one where a copy is past redundancy.

- :meth:`ShardStore.restore` — same mesh width only (refused BY NAME
  across widths: the 1/D row layout is structural).  Each rank reads only
  its own shard and ``repl.npz`` and installs its row of every bucket
  into its already-laid-out row state, and its own generator; one small
  all-gather agrees on the outcome, so loss past redundancy refuses on
  every rank;
- :meth:`ShardStore.restore_elastic` — any mesh width; every rank reads
  the whole set and reassembles the bucket flats.  The bucket plan
  is a pure function of the leaf specs and the byte cap
  (``parallel/bucketing.plan_buckets``), so only the per-leaf zero
  padding ``ceil(n/D)`` changes with D: the flats are cut back to exact
  leaf values (:func:`_unbucket`), the parameters go into the fresh tree
  state, the engine's one re-layout pass
  (``engine.apply_update_layout``) lays them out at the new width, and
  the momentum rows are regrouped (:func:`_rebucket`) and grafted in.
  Every move is byte movement around zero padding, so a D=4 set restored
  at D=2 (and back) is bitwise the saver's state
  (``tests/test_torch_shardstore.py``).  Dropout generators: rank r of
  the new mesh takes shard r's saved generator where the saved set has a
  shard r, and otherwise keeps the fresh run's (seeded from the seed and
  its rank, ``training/state.py``), the rule a replicated checkpoint
  restored on more ranks follows.

Loss past redundancy refuses loudly, naming the shard, its copy census
and the knob (``SNAPSHOT_REDUNDANCY``).  ``snapshot.valid_steps`` unions
these quorum-valid steps with the monolithic ones.  Saves, restores,
reconstructions and refusals land in the run ledger (``OBS_LEDGER``) as
``ckpt_*`` rows, from rank 0 (a same-width restore's copy events from the
rank that read the copy).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import sys
import time
import zipfile

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs.trace import span
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    LeafSpec, jax_leaf_order, plan_buckets)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.hooks import Hook, _EveryN

MANIFEST_VERSION = 1
_STEP_DIR_RE = re.compile(r"^shards_(\d{8})$")
_ROW_LAYOUTS = ("zero3_rows", "bucket_rows")

_SAVES = obs_metrics.counter(
    "ckpt_shard_saves_total", "committed shard-set writes "
    "(all rank payloads + manifest)")
_SAVE_FAILURES = obs_metrics.counter(
    "ckpt_shard_save_failures", "shard-set writes refused by the OS "
    "after retries, survived by the run (keep-N covers the gap)")
_RESTORES = obs_metrics.counter(
    "ckpt_shard_restores_total", "successful restores from a shard set "
    "(same-width and elastic)")
_RECONSTRUCTIONS = obs_metrics.counter(
    "ckpt_shard_reconstructions_total",
    "shards rebuilt from a ring mirror (own copy missing or corrupt)")
_DIGEST_MISMATCHES = obs_metrics.counter(
    "ckpt_digest_mismatches_total",
    "shard copies refused by sha256 — bit rot detected, never restored")
_IO_RETRIES = obs_metrics.counter(
    "ckpt_io_retries_total", "payload writes retried after an OSError "
    "(SNAPSHOT_IO_RETRIES bounds the attempts)")
_REFUSALS = obs_metrics.counter(
    "ckpt_restore_refusals_total",
    "restores refused loudly (loss beyond redundancy, width mismatch "
    "on the non-elastic path, structural drift)")


def _log(msg: str) -> None:
    print(f"shardstore: {msg}", file=sys.stderr, flush=True)


def _event(event: str, **fields) -> None:
    obs_ledger.log_event(event, src="shardstore",
                         job=os.environ.get("OBS_PHASE", ""), **fields)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# --- the layout facts the manifest records -----------------------------

class ShardLayout:
    """Plain-data description of a run's row layout: everything the store
    needs to check rows at save time and regroup them at restore time,
    recorded verbatim in the manifest.  Leaves are in the JAX package's
    order (``parallel/bucketing.jax_leaf_order``), as the bucket plan is;
    ``param_names`` are the port's dotted names of those leaves."""

    def __init__(self, update_layout: str, bucket_bytes: int,
                 param_specs: list, num_ranks: int,
                 plan: list | None = None,
                 param_names: list | None = None):
        if update_layout not in _ROW_LAYOUTS:
            raise ValueError(
                f"unknown row layout {update_layout!r} — the shard store "
                f"is the zero1/zero3 snapshot format (tree-layout runs "
                f"use resilience/snapshot.py)")
        if num_ranks < 2:
            raise ValueError(f"row layouts shard over >= 2 ranks, "
                             f"got {num_ranks}")
        self.update_layout = update_layout
        self.bucket_bytes = int(bucket_bytes)
        self.param_specs = list(param_specs)
        self.param_names = None if param_names is None else list(param_names)
        self.num_ranks = int(num_ranks)
        # The plan is a pure function of (leaf specs, byte cap), not of
        # D: the reason a shard set can regroup onto another width.
        self.plan = ([list(b) for b in plan] if plan is not None else
                     plan_buckets(self.param_specs, self.bucket_bytes))

    @classmethod
    def for_params(cls, update_layout: str, bucket_bytes: int, params: dict,
                   num_ranks: int) -> "ShardLayout":
        """From the TREE-form parameters (``{name: tensor}``, e.g. the
        model's ``named_parameters()`` before the row re-layout)."""
        names = jax_leaf_order(params)
        specs = [LeafSpec(tuple(int(d) for d in params[n].shape),
                          np.dtype(str(params[n].dtype).removeprefix(
                              "torch.")))
                 for n in names]
        return cls(update_layout, bucket_bytes, specs, num_ranks,
                   param_names=names)

    def bucket_width(self, b: int, num_ranks: int) -> int:
        """Columns of bucket ``b``'s ``[D, W]`` layout at width
        ``num_ranks`` — per-leaf zero padding to ``ceil(n/D)``, summed
        (the one D-dependent part of the layout)."""
        return sum(-(-self.param_specs[i].size // num_ranks)
                   for i in self.plan[b])

    def to_manifest(self) -> dict:
        out = {"update_layout": self.update_layout,
               "bucket_bytes": self.bucket_bytes,
               "param_specs": [[list(s.shape), s.dtype.name]
                               for s in self.param_specs],
               "plan": [list(b) for b in self.plan]}
        if self.param_names is not None:
            out["param_names"] = list(self.param_names)
        return out

    @classmethod
    def from_manifest(cls, m: dict) -> "ShardLayout":
        specs = [LeafSpec(tuple(shape), np.dtype(dt))
                 for shape, dt in m["param_specs"]]
        return cls(m["update_layout"], m["bucket_bytes"], specs,
                   m["num_ranks"], plan=m["plan"],
                   param_names=m.get("param_names"))


# --- pure-numpy regroup (byte-movement twins of parallel/bucketing) ----

def _unbucket(flat: np.ndarray, specs: list,
              num_ranks: int) -> list[np.ndarray]:
    """Inverse of the bucket row layout at width ``num_ranks``: slice the
    ``[D*W]`` flat back into exact leaf values, padding dropped."""
    rows = np.asarray(flat).reshape(num_ranks, -1)
    out, off = [], 0
    for spec in specs:
        w = -(-spec.size // num_ranks)
        out.append(rows[:, off:off + w].ravel()[:spec.size]
                   .reshape(spec.shape))
        off += w
    if off != rows.shape[1]:
        raise ValueError(
            f"bucket flat has {rows.shape[1]} columns; its leaf specs "
            f"account for {off} — the saved plan does not describe this "
            f"shard set")
    return out


def _rebucket(values: list, num_ranks: int) -> np.ndarray:
    """The bucket flat at width ``num_ranks``: per-leaf zero-pad to a
    multiple of D, ``[D, ceil(n/D)]`` blocks side by side, raveled (the
    numpy twin of ``BucketPlan.pack``)."""
    cols = []
    for v in values:
        flat = np.asarray(v).ravel()
        pad = (-flat.size) % num_ranks
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        cols.append(flat.reshape(num_ranks, -1))
    return np.concatenate(cols, axis=1).ravel()


def _npz(payload: dict) -> bytes:
    """``np.savez`` bytes with fixed zip timestamps (``np.savez`` stamps
    the wall clock), so equal content is equal bytes and equal digests."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, value in payload.items():
            info = zipfile.ZipInfo(f"{key}.npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with z.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(value),
                                          allow_pickle=False)
    return buf.getvalue()


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").numpy()
    return np.asarray(t)


def _classify(state) -> dict:
    """Field -> ``{"rows": [row tensors], "repl": [tensors or ints],
    "own": [per-rank tensors]}``: THE one classification save and restore
    share, so the positional correspondence between a shard set and a
    live state cannot drift.  Rows come bucket-major; replicated
    parameters (zero1) in the JAX package's leaf order."""
    opt = state.optimizer
    if opt.layout not in _ROW_LAYOUTS:
        raise ValueError(
            f"state holds {opt.layout!r} state, no 1/D row leaves — the "
            f"shard store is the row-layout snapshot format; tree-layout "
            f"runs use resilience/snapshot.py SnapshotStore")
    if opt.layout == "zero3_rows":
        params = {"rows": list(opt.params_rows), "repl": []}
    else:
        plan = opt.plan
        params = {"rows": [], "repl": [
            opt.params_flat[off:off + spec.size].view(spec.shape)
            for off, spec in zip(plan.offsets, plan.specs)]}
    return {"step": {"rows": [], "repl": [int(state.step)]},
            "params": params,
            "opt_state": {"rows": list(opt.momentum_rows or ()),
                          "repl": [int(opt.count)]},
            "buffers": {"rows": [], "repl": [
                b for _, b in sorted(state.model.named_buffers())]},
            "generator": {"rows": [], "repl": [],
                          "own": [state.generator.get_state()]}}


# --- the store ---------------------------------------------------------

class ShardStore:
    """Per-rank shard files + ring mirrors + quorum manifest under
    ``directory`` (one ``shards_<step>/`` dir per step; coexists with
    SnapshotStore's monolithic files in the same directory).  Reading
    (steps, validation, census) needs no layout and no group; ``save``
    needs the run's :class:`ShardLayout` and is called on every rank."""

    def __init__(self, directory: str, layout: ShardLayout | None = None,
                 keep: int = 3, redundancy: int | None = None):
        self._dir = directory
        self._layout = layout
        self._keep = keep
        self.last_restore: dict | None = None
        r = (redundancy if redundancy is not None
             else _env_int("SNAPSHOT_REDUNDANCY", 2))
        self._redundancy = max(1, r)
        #: The last committed save's step, seconds and bytes (this rank).
        self.last_save: dict | None = None

    @property
    def layout(self) -> ShardLayout | None:
        return self._layout

    # -- paths ----------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"shards_{step:08d}")

    def _rank_dir(self, step: int, rank: int) -> str:
        return os.path.join(self._step_dir(step), f"rank_{rank:05d}")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), "manifest.json")

    def steps(self) -> list[int]:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _STEP_DIR_RE.match(n)))

    def manifest(self, step: int) -> dict | None:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- write path -----------------------------------------------------

    def _atomic_write(self, path: str, data: bytes) -> None:
        """Monkeypatch seam (tests inject ENOSPC/EIO here), delegating
        to THE atomic-write implementation (obs/recorder.py)."""
        obs_recorder.atomic_write(path, data)

    def _write_retrying(self, path: str, data: bytes) -> None:
        """Bounded retry/backoff around one atomic payload write: a flaky
        disk costs ``SNAPSHOT_IO_RETRIES`` extra attempts with
        ``SNAPSHOT_IO_BACKOFF_S``-doubling sleeps; a dead one re-raises."""
        retries = max(0, _env_int("SNAPSHOT_IO_RETRIES", 2))
        backoff = max(0.0, _env_float("SNAPSHOT_IO_BACKOFF_S", 0.05))
        for attempt in range(retries + 1):
            try:
                self._atomic_write(path, data)
                return
            except OSError as e:
                if attempt == retries:
                    raise
                _IO_RETRIES.inc()
                _log(f"write {os.path.basename(path)} failed ({e}) — "
                     f"retry {attempt + 1}/{retries} in "
                     f"{backoff * (2 ** attempt):.3f}s")
                time.sleep(backoff * (2 ** attempt))

    def _serialize(self, state, mesh) -> tuple:
        """(this rank's own bytes, repl bytes, per-field census).
        Refuses a state whose rows do not match the layout's bucket plan
        — a manifest must describe what is on disk."""
        lay = self._layout
        if lay is None:
            raise ValueError("ShardStore.save needs the run's ShardLayout "
                             "(see ShardLayout.for_params)")
        D = lay.num_ranks
        if mesh.size != D:
            raise ValueError(f"this store's layout shards over {D} ranks; "
                             f"the mesh has {mesh.size}")
        plan = state.optimizer.plan
        if plan is None or [list(b) for b in plan.plan] != lay.plan:
            raise ValueError("the state's bucket plan is not the store's "
                             "layout plan — this state does not match the "
                             "store's bucket plan")
        own: dict[str, np.ndarray] = {}
        repl: dict[str, np.ndarray] = {}
        fields: dict[str, dict] = {}
        n_buckets = len(lay.plan)
        for fname, parts in _classify(state).items():
            rows = parts["rows"]
            if rows:
                if len(rows) % n_buckets:
                    raise ValueError(
                        f"field {fname!r} holds {len(rows)} row leaves "
                        f"over {n_buckets} buckets — not a whole number "
                        f"per bucket; this state does not match the "
                        f"store's bucket plan")
                m_per = len(rows) // n_buckets
                for j, row in enumerate(rows):
                    want = lay.bucket_width(j // m_per, D)
                    if row.numel() != want:
                        raise ValueError(
                            f"field {fname!r} row leaf {j} has "
                            f"{row.numel()} elements; bucket {j // m_per} "
                            f"at D={D} lays out {want} a rank — this state "
                            f"does not match the store's bucket plan")
                    own[f"{fname}__{j:05d}"] = _host(row)
            for j, leaf in enumerate(parts["repl"]):
                repl[f"{fname}__{j:05d}"] = _host(leaf)
            for j, leaf in enumerate(parts.get("own", ())):
                own[f"{fname}__{j:05d}"] = _host(leaf)
            fields[fname] = {"rows": [{"size": int(D * r.numel())}
                                      for r in rows],
                             "repl": len(parts["repl"]),
                             "own": len(parts.get("own", ()))}
        if not any(f["rows"] for f in fields.values()):
            raise ValueError(
                "state holds no 1/D row leaves — the shard store is the "
                "row-layout snapshot format; tree-layout runs use "
                "resilience/snapshot.py SnapshotStore")
        return _npz(own), _npz(repl), fields

    def _fsync_dir(self, path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _write_rank(self, step: int, rank: int, num_ranks: int, R: int,
                    own: bytes, repl: bytes) -> None:
        """This rank's writes: ``own.npz``, the same bytes as its mirror
        in each of the R-1 ring successors' directories, and ``repl.npz``
        on ranks 0..R-1; every touched directory fsynced."""
        touched = []
        rdir = self._rank_dir(step, rank)
        os.makedirs(rdir, exist_ok=True)
        self._write_retrying(os.path.join(rdir, "own.npz"), own)
        touched.append(rdir)
        for m in range(1, R):
            hdir = self._rank_dir(step, (rank + m) % num_ranks)
            os.makedirs(hdir, exist_ok=True)
            self._write_retrying(os.path.join(hdir, f"mirror_{rank:05d}.npz"),
                                 own)
            touched.append(hdir)
        if rank < R:
            self._write_retrying(os.path.join(rdir, "repl.npz"), repl)
        for d in touched:
            self._fsync_dir(d)
        self._fsync_dir(self._step_dir(step))

    def save(self, state, mesh, cursor: dict | None = None,
             meta: dict | None = None) -> int:
        """Write one quorum-committed shard set for ``state``'s step, on
        every rank of ``mesh`` (a collective): each rank's payloads, then
        the agreement, then the manifest LAST from rank 0.  Returns the
        step.  Raises OSError on every rank when any rank's write, or the
        manifest, failed after the bounded retries (hook callers log and
        count it)."""
        lay = self._layout
        step = int(state.step)
        t0 = time.perf_counter()
        D, r = mesh.size, mesh.rank
        R = min(self._redundancy, D)
        with span("shard_snapshot", step=step):
            # A failure here, in the rows' trip to the host and their
            # encoding as much as in the writes, travels in the agreement:
            # no rank is left waiting in it.
            error, own, repl = None, b"", b""
            try:
                own, repl, fields = self._serialize(state, mesh)
                self._write_rank(step, r, D, R, own, repl)
            except Exception as e:
                error = e
            facts = _gather_facts(mesh, error is None, own, repl)
            failed = [s for s, f in enumerate(facts) if not f["ok"]]
            if failed:
                why = f" ({error})" if error is not None else ""
                message = (f"shard set {step}: the writes of rank(s) "
                           f"{failed} failed{why}; no manifest written")
                if error is not None and not isinstance(error, OSError):
                    error.add_note(message)
                    raise error
                raise OSError(message) from error
            if len({f["repl"] for f in facts}) != 1:
                raise ValueError(f"shard set {step}: the ranks' replicated "
                                 f"payloads differ — the state is not "
                                 f"replicated where the layout says it is")
            manifest_error = None
            if r == 0:
                manifest = {"version": MANIFEST_VERSION, "step": step,
                            "num_ranks": D, "redundancy": R,
                            "fields": fields,
                            "digests": {
                                **{f"own_{s:05d}": f["own"]
                                   for s, f in enumerate(facts)},
                                "repl": facts[0]["repl"]},
                            "cursor": dict(cursor or {}),
                            "meta": dict(meta or {}),
                            **lay.to_manifest()}
                try:
                    self._write_retrying(
                        self._manifest_path(step),
                        json.dumps(manifest, sort_keys=True).encode())
                    self._fsync_dir(self._step_dir(step))
                except OSError as e:
                    manifest_error = e
            flag = torch.tensor([float(manifest_error is not None)],
                                device=mesh.device)
            if mesh.all_reduce(flag, counted=False).item():
                raise OSError(f"shard set {step}: the manifest write failed"
                              + (f" ({manifest_error})"
                                 if manifest_error is not None else
                                 " on rank 0"))
        if r == 0:
            self._trim()
        _SAVES.inc()
        nbytes = sum(f["nbytes"] for f in facts)
        self.last_save = {"step": step, "seconds": time.perf_counter() - t0,
                          "own_bytes": len(own), "repl_bytes": len(repl),
                          "total_own_bytes": nbytes}
        if r == 0:
            _event("ckpt_save", step=step, ranks=D, redundancy=R,
                   nbytes=nbytes)
        return step

    def _trim(self) -> None:
        if self._keep <= 0:
            return
        for s in self.steps()[:-self._keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def discard_newer(self, step: int) -> list[int]:
        """Delete every shard set newer than ``step`` (the same contract
        as ``SnapshotStore.discard_newer``)."""
        dropped = []
        for s in self.steps():
            if s > step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                if not os.path.isdir(self._step_dir(s)):
                    dropped.append(s)
        return dropped

    # -- validation / quorum --------------------------------------------

    def _copies(self, step: int, shard: int, manifest: dict):
        """Every on-disk location shard ``shard`` may live at, own first,
        ring mirrors after — ``(path, holder_rank)`` pairs."""
        D = manifest["num_ranks"]
        out = [(os.path.join(self._rank_dir(step, shard), "own.npz"),
                shard)]
        for m in range(1, manifest["redundancy"]):
            h = (shard + m) % D
            out.append((os.path.join(self._rank_dir(step, h),
                                     f"mirror_{shard:05d}.npz"), h))
        return out

    def _good_bytes(self, path: str, want_digest: str):
        """(bytes, why_bad): read one copy and check its sha256 — a
        mismatch is COUNTED and the copy refused."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            return None, f"unreadable ({e.__class__.__name__})"
        if hashlib.sha256(data).hexdigest() != want_digest:
            _DIGEST_MISMATCHES.inc()
            return None, "digest mismatch"
        return data, None

    def shard_census(self, step: int, manifest: dict | None = None):
        """Per-shard intact-copy count + repl count — the quorum facts."""
        manifest = manifest or self.manifest(step)
        if manifest is None:
            return None
        census = {}
        for s in range(manifest["num_ranks"]):
            census[s] = sum(
                self._good_bytes(path, manifest["digests"][
                    f"own_{s:05d}"])[0] is not None
                for path, _holder in self._copies(step, s, manifest))
        repl_ok = sum(
            self._good_bytes(os.path.join(self._rank_dir(step, r),
                                          "repl.npz"),
                             manifest["digests"]["repl"])[0] is not None
            for r in range(manifest["redundancy"]))
        return {"shards": census, "repl": repl_ok}

    def _intact(self, paths, digest: str) -> bool:
        """Whether any of ``paths`` holds a digest-intact copy (reads
        stop at the first one)."""
        return any(self._good_bytes(p, digest)[0] is not None for p in paths)

    def validate(self, step: int):
        """(ok, why): quorum-valid iff the manifest parses AND every shard
        has >= 1 digest-intact copy AND the replicated payload does too
        (the census's verdict, reading each shard's copies only until one
        is intact)."""
        manifest = self.manifest(step)
        if manifest is None:
            return False, "missing or unparseable manifest"
        bad = [s for s in range(manifest["num_ranks"])
               if not self._intact(
                   [p for p, _ in self._copies(step, s, manifest)],
                   manifest["digests"][f"own_{s:05d}"])]
        if bad:
            return False, (f"shards {bad} have no intact copy "
                           f"(R={manifest['redundancy']})")
        if not self._intact(
                [os.path.join(self._rank_dir(step, r), "repl.npz")
                 for r in range(manifest["redundancy"])],
                manifest["digests"]["repl"]):
            return False, "replicated payload has no intact copy"
        return True, "ok"

    def quorum_steps(self) -> list[int]:
        return [s for s in self.steps() if self.validate(s)[0]]

    def latest_valid(self) -> int | None:
        """The newest quorum-valid step (newest first: the older sets
        are not read once one validates)."""
        return next((s for s in reversed(self.steps())
                     if self.validate(s)[0]), None)

    # -- read path ------------------------------------------------------

    def _read(self, step: int, shards, report: bool,
              manifest: dict | None = None):
        """ONE read (and one sha256) of each copy the restore needs:
        ``shards`` of ``step`` (every shard when None), each from its first
        digest-intact copy (own first, ring mirrors after), and the
        replicated payload.  None without a readable manifest, else
        ``(manifest, {shard: arrays}, repl arrays, reconstructed,
        missing)``: ``missing`` is the first shard with no intact copy
        (the reading stops there), ``"repl"`` when the replicated payload
        has none, else None.  ``report``: write the ledger events."""
        manifest = manifest or self.manifest(step)
        if manifest is None:
            return None
        event = _event if report else (lambda *a, **k: None)
        got: dict = {}
        reconstructed: list[int] = []
        for s in range(manifest["num_ranks"]) if shards is None else shards:
            for path, holder in self._copies(step, s, manifest):
                data, why = self._good_bytes(
                    path, manifest["digests"][f"own_{s:05d}"])
                if data is None:
                    event("ckpt_digest_mismatch" if why == "digest mismatch"
                          else "ckpt_copy_unreadable", step=step, shard=s,
                          file=os.path.relpath(path, self._dir))
                    continue
                if holder != s:
                    reconstructed.append(s)
                    _RECONSTRUCTIONS.inc()
                    event("ckpt_reconstruct", step=step, shard=s,
                          source_rank=holder)
                    if report:
                        _log(f"step {step}: shard {s} rebuilt from "
                             f"rank {holder}'s ring mirror")
                with np.load(io.BytesIO(data)) as z:
                    got[s] = {k: z[k] for k in z.files}
                break
            else:
                return manifest, got, None, reconstructed, s
        for r in range(manifest["redundancy"]):
            data, _why = self._good_bytes(
                os.path.join(self._rank_dir(step, r), "repl.npz"),
                manifest["digests"]["repl"])
            if data is not None:
                with np.load(io.BytesIO(data)) as z:
                    return (manifest, got, {k: z[k] for k in z.files},
                            reconstructed, None)
        return manifest, got, None, reconstructed, "repl"

    def _refuse(self, step: int, manifest: dict, missing, report: bool):
        """Refuse loss past redundancy BY NAME: ``missing`` is the shard
        with no intact copy, or ``"repl"``."""
        _REFUSALS.inc()
        R = manifest["redundancy"]
        if missing == "repl":
            raise ModeRefusal(
                f"step {step}: the replicated payload has no intact "
                f"copy on ranks 0..{R - 1} — loss exceeds redundancy R={R}")
        census = self.shard_census(step, manifest)
        if report:
            _event("ckpt_refused", step=step, shard=missing,
                   census=census["shards"], redundancy=R)
        raise ModeRefusal(
            f"shard {missing} of step {step} has NO intact copy (own "
            f"and every ring mirror missing or digest-refused; "
            f"census {census['shards']}) — loss exceeds "
            f"redundancy R={R}. Refusing "
            f"to restore a partial state; resume from an older "
            f"quorum-valid step, or raise SNAPSHOT_REDUNDANCY "
            f"at save time to survive more")

    @staticmethod
    def _fields(manifest: dict, shards: dict, repl: dict) -> tuple:
        """({field: [row flats: the read shards' rows concatenated in
        shard order]}, {field: [repl arrays]}, {field: [[each read
        shard's own leaf] per leaf]})."""
        order = sorted(shards)
        rows, repl_f, own = {}, {}, {}
        for fname, fmeta in manifest["fields"].items():
            key = lambda j: f"{fname}__{j:05d}"
            rows[fname] = [np.concatenate([shards[s][key(j)] for s in order])
                           for j in range(len(fmeta["rows"]))]
            repl_f[fname] = [repl[key(j)] for j in range(fmeta["repl"])]
            own[fname] = [[shards[s][key(j)] for s in order]
                          for j in range(fmeta.get("own", 0))]
        return rows, repl_f, own

    def _load(self, step: int | None, report: bool = True):
        """(manifest, {field: [row flats at D_saved]}, {field: [repl
        arrays]}, {field: [[shard s's own leaves] per leaf]},
        reconstructed shards) of ``step`` — with ``step`` None, of the
        newest set whose every shard and replicated payload has an intact
        copy, or None when there is none (newest first; each copy is read
        once, with no separate validation pass).  Refuses BY NAME when a
        named step's loss exceeds redundancy.  ``report``: write the
        ledger events (one rank of a group reports)."""
        for s in (reversed(self.steps()) if step is None else [step]):
            read = self._read(s, None, report)
            if read is not None and read[4] is None:
                manifest, shards, repl, recon, _ = read
                return (manifest, *self._fields(manifest, shards, repl),
                        recon)
        if step is None:
            return None
        if read is None:
            raise ValueError(f"shard set {step} has no readable "
                             f"manifest — the write never committed")
        self._refuse(step, read[0], read[4], report)

    def restore(self, state, mesh, step: int | None = None):
        """Same-width restore into an already-laid-out ROW state, in place.
        Each rank reads only ITS shard (the own copy, else a ring mirror)
        and the replicated payload, once, and installs its row of every
        bucket, the replicated leaves and its own generator.  One small
        all-gather agrees on the outcome, so a shard lost past redundancy
        is refused by name on every rank.  With ``step`` None: the newest
        set every rank can read (``state`` is returned untouched when
        there is none).  ``last_restore`` holds the step and the
        reconstructed shards.  Refuses a width mismatch by name (the
        sanctioned cross-width path is :meth:`restore_elastic`)."""
        intact, reconstructed, missing, no_manifest = 0, 1, 2, 3
        for s in (reversed(self.steps()) if step is None else [step]):
            manifest = self.manifest(s)
            if manifest is not None and manifest["num_ranks"] != mesh.size:
                _REFUSALS.inc()
                raise ModeRefusal(
                    f"shard set at step {s} was written by "
                    f"{manifest['num_ranks']} ranks; this mesh has "
                    f"{mesh.size} — the 1/D row layout is structural, so a "
                    f"positional restore would interleave rows from the "
                    f"wrong width. Use ShardStore.restore_elastic (the "
                    f"engine layout regroup) to restore across widths")
            read = (None if manifest is None else
                    self._read(s, [mesh.rank], True, manifest))
            codes = mesh.all_gather_int(
                no_manifest if read is None else
                missing if read[4] is not None else
                reconstructed if read[3] else intact)
            if max(codes) <= reconstructed:
                break
            if step is not None:
                if no_manifest in codes:
                    raise ValueError(f"shard set {step} has no readable "
                                     f"manifest")
                gone = [r for r, c in enumerate(codes) if c == missing]
                self._refuse(step, manifest,
                             "repl" if read[4] == "repl" else gone[0],
                             mesh.rank == 0)
        else:
            return state
        manifest, shards, repl_arrays, _, _ = read
        rows, repl, own = self._fields(manifest, shards, repl_arrays)
        recon = [r for r, c in enumerate(codes) if c == reconstructed]
        targets = _classify(state)
        for fname, parts in targets.items():
            fmeta = manifest["fields"].get(fname)
            if fmeta is None:
                raise ValueError(
                    f"shard set {s} has no field {fname!r} — the state "
                    f"structure changed since it was written")
            if (len(rows[fname]) != len(parts["rows"])
                    or len(repl[fname]) != len(parts["repl"])
                    or len(own[fname]) != len(parts.get("own", ()))):
                raise ValueError(
                    f"shard set {s} field {fname!r} holds "
                    f"{len(rows[fname])} row + {len(repl[fname])} "
                    f"replicated leaves; this run's state has "
                    f"{len(parts['rows'])} + {len(parts['repl'])} — the "
                    f"model/optimizer changed since it was written")
        with torch.no_grad():
            for fname in ("params", "opt_state"):
                for row, mine in zip(targets[fname]["rows"], rows[fname]):
                    _copy_into(row, mine, f"{fname} row")
            _install_replicated(state, repl)
        state.generator.set_state(torch.from_numpy(
            np.array(own["generator"][0][0], copy=True)))
        _RESTORES.inc()
        self.last_restore = {"step": s, "reconstructed": recon}
        if mesh.rank == 0:
            _event("ckpt_restore", step=s,
                   from_ranks=manifest["num_ranks"], to_ranks=mesh.size,
                   elastic=False, reconstructed=recon)
        return state

    def restore_elastic(self, state, *, mesh, step: int | None = None,
                        update_layout: str | None = None,
                        required: bool = True):
        """Restore a shard set of ANY width onto ``mesh``: exact
        parameter values from the saved rows into ``state`` (the fresh
        TREE-layout state of this rank, ``Engine.create_state`` — before
        any row re-layout), the engine's ONE re-layout pass
        (``apply_update_layout``) at the new width, and the momentum rows
        regrouped with the same byte movement.  With ``step`` None: the
        newest set with an intact copy of everything, each copy read
        once; when there is none, ValueError, or ``(state, None)`` with
        ``required`` False.  ``update_layout``: the restoring run's row
        layout; a set of the other one is refused by name.

        Returns ``(row_state, aux)`` with ``aux`` carrying the
        ``zero3_layout`` the engine pass built (None for zero1), the
        restored ``step``, the saved dataset ``cursor``, ``from_ranks``
        and the ``reconstructed`` shards."""
        loaded = self._load(step, report=mesh.rank == 0)
        if loaded is None and not required:
            return state, None
        if loaded is None:
            raise ValueError(
                f"no quorum-valid shard step in {self._dir} — nothing "
                f"to restore")
        manifest, rows, repl, own, recon = loaded
        step = manifest["step"]
        lay = ShardLayout.from_manifest(manifest)
        if update_layout is not None and lay.update_layout != update_layout:
            raise ModeRefusal(
                f"shard set at step {step} in SNAPSHOT_DIR holds "
                f"{lay.update_layout!r} state; this run uses "
                f"{update_layout!r} (--shard_update stores the momentum as "
                f"rows, --shard_params the parameters too). Resume with the "
                f"writing run's knobs or point SNAPSHOT_DIR elsewhere")
        d_old, d_new = lay.num_ranks, mesh.size
        opt = state.optimizer
        if opt.layout != "tree" or opt.plan is not None:
            raise ValueError("restore_elastic needs the fresh tree-layout "
                             "state (Engine.create_state), before any row "
                             "re-layout")
        names = jax_leaf_order(opt.slices)
        if lay.param_names is not None and lay.param_names != names:
            raise ValueError(
                f"shard set {step} holds parameters {lay.param_names[:3]}"
                f"...; this run's model has {names[:3]}... — the model "
                f"changed since it was written")

        # (1) Exact parameter values back from the saved width's rows.
        if lay.update_layout == "zero3_rows":
            if len(rows["params"]) != len(lay.plan):
                raise ValueError(
                    f"shard set {step} holds {len(rows['params'])} param "
                    f"buckets; its plan names {len(lay.plan)} — manifest "
                    f"is inconsistent")
            values: list = [None] * len(lay.param_specs)
            for b, flat in enumerate(rows["params"]):
                idxs = lay.plan[b]
                for i, v in zip(idxs, _unbucket(
                        flat, [lay.param_specs[i] for i in idxs], d_old)):
                    values[i] = v
        else:                                  # bucket_rows: params repl
            values = list(repl["params"])
        if len(values) != len(names):
            raise ValueError(
                f"shard set {step} restores {len(values)} param leaves; "
                f"this run's model has {len(names)} — the model changed "
                f"since it was written")
        with torch.no_grad():
            for name, v in zip(names, values):
                off, shape = opt.slices[name]
                if tuple(v.shape) != tuple(shape):
                    raise ValueError(
                        f"shard set {step} param leaf {name} has shape "
                        f"{tuple(v.shape)}; the model's is {tuple(shape)} "
                        f"— the model changed since it was written")
                opt.params_flat[off:off + shape.numel()].copy_(
                    torch.from_numpy(np.ascontiguousarray(v)).reshape(-1))
            # (2) Replicated leaves and, where the set has one, this
            # rank's generator.
            _install_replicated(state, repl)
        if mesh.rank < d_old:
            state.generator.set_state(torch.from_numpy(
                np.array(own["generator"][0][mesh.rank], copy=True)))

        # (3) The engine's one re-layout pass, at the NEW width.
        from distributedtensorflowexample_tpu_torch.engine.engine import (
            apply_update_layout)
        state, zero3_layout = apply_update_layout(
            state, update_layout=lay.update_layout,
            bucket_bytes=lay.bucket_bytes, mesh=mesh)
        if [list(b) for b in state.optimizer.plan.plan] != lay.plan:
            raise ValueError(f"shard set {step}'s bucket plan differs from "
                             f"the one this run lays out — bucket plans "
                             f"diverged")

        # (4) Graft the momentum rows: unbucket at the saved width,
        # rebucket at the new one, take this rank's row.
        saved = rows["opt_state"]
        mine = state.optimizer.momentum_rows or []
        if len(saved) != len(mine):
            raise ValueError(
                f"shard set {step} holds {len(saved)} momentum rows; this "
                f"run's optimizer has {len(mine)} — the optimizer changed "
                f"since it was written")
        with torch.no_grad():
            for b, (row, flat_old) in enumerate(zip(mine, saved)):
                specs = [lay.param_specs[i] for i in lay.plan[b]]
                flat_new = _rebucket(_unbucket(flat_old, specs, d_old),
                                     d_new)
                _copy_into(row, flat_new.reshape(d_new, -1)[mesh.rank],
                           f"regrouped momentum row {b}")
        _RESTORES.inc()
        if mesh.rank == 0:
            _event("ckpt_restore", step=step, from_ranks=d_old,
                   to_ranks=d_new, elastic=d_old != d_new,
                   reconstructed=recon)
            if d_old != d_new:
                _log(f"elastic restore: step {step} regrouped D={d_old} -> "
                     f"D={d_new} through the engine layout pass")
        return state, {"zero3_layout": zero3_layout, "step": step,
                       "cursor": manifest.get("cursor", {}),
                       "from_ranks": d_old, "reconstructed": recon}

    # -- fault seams ------------------------------------------------------

    def drop_rank_dir(self, rank: int, step: int | None = None):
        """Delete one rank's whole directory in the newest shard set (a
        lost host's local disk)."""
        step = self.steps()[-1] if step is None and self.steps() else step
        if step is None:
            return None
        shutil.rmtree(self._rank_dir(step, rank), ignore_errors=True)
        return step

    def flip_payload_byte(self, rank: int, step: int | None = None):
        """Flip one byte in the middle of one rank's ``own.npz``, in place
        and deliberately NOT atomically — silent bit rot the manifest
        digest must catch."""
        step = self.steps()[-1] if step is None and self.steps() else step
        if step is None:
            return None
        path = os.path.join(self._rank_dir(step, rank), "own.npz")
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                off = f.tell() // 2
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
            return step, off
        except OSError:
            return None


def _copy_into(dst: torch.Tensor, src: np.ndarray, what: str) -> None:
    if dst.numel() != src.size:
        raise ValueError(f"{what} has {src.size} elements; this run's "
                         f"layout expects {dst.numel()} — bucket plans "
                         f"diverged")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(src)).reshape(dst.shape))


def _install_replicated(state, repl: dict) -> None:
    """The replicated leaves of :func:`_classify`, in place: the step,
    the optimizer's count, the model's buffers and (zero1) the
    parameters in the JAX package's leaf order."""
    opt = state.optimizer
    state.step = int(repl["step"][0])
    opt.count = int(repl["opt_state"][0])
    buffers = [b for _, b in sorted(state.model.named_buffers())]
    if len(buffers) != len(repl["buffers"]):
        raise ValueError(f"the shard set holds {len(repl['buffers'])} model "
                         f"buffers; this run's model has {len(buffers)}")
    for buf, v in zip(buffers, repl["buffers"]):
        buf.copy_(torch.from_numpy(np.array(v, copy=True)))
    if repl["params"] and opt.params_flat is not None \
            and opt.layout == "bucket_rows":
        for off, spec, v in zip(opt.plan.offsets, opt.plan.specs,
                                repl["params"]):
            opt.params_flat[off:off + spec.size].copy_(
                torch.from_numpy(np.ascontiguousarray(v)).reshape(-1))


def _gather_facts(mesh, ok: bool, own: bytes, repl: bytes) -> list[dict]:
    """Every rank's (write succeeded, own digest, repl digest, own bytes),
    in rank order, by ONE all-gather of a 73-byte record."""
    record = np.zeros(73, np.uint8)
    record[0] = ok
    record[1:33] = np.frombuffer(hashlib.sha256(own).digest(), np.uint8)
    record[33:65] = np.frombuffer(hashlib.sha256(repl).digest(), np.uint8)
    record[65:73] = np.frombuffer(np.int64(len(own)).tobytes(), np.uint8)
    out = []
    for t in mesh.all_gather(torch.from_numpy(record)):
        a = t.numpy()
        out.append({"ok": bool(a[0]), "own": a[1:33].tobytes().hex(),
                    "repl": a[33:65].tobytes().hex(),
                    "nbytes": int(np.frombuffer(a[65:73].tobytes(),
                                                np.int64)[0])})
    return out


# --- module helpers (the quorum seam of snapshot.valid_steps) ----------

def shard_steps(directory: str) -> list[int]:
    return ShardStore(directory).steps()


def quorum_valid_steps(directory: str) -> list[int]:
    """Steps whose shard set reaches quorum (every shard + repl has an
    intact copy) — unioned into ``snapshot.valid_steps``."""
    return ShardStore(directory).quorum_steps()


def discard_newer(directory: str, step: int) -> list[int]:
    return ShardStore(directory).discard_newer(step)


# --- the hook ----------------------------------------------------------

class ShardSnapshotHook(Hook):
    """Periodic + final shard-set save on every rank (SnapshotHook's
    shape, the shard store's format).  An OSError that survives the
    bounded retries is logged and counted on every rank, never raised —
    losing one snapshot interval is recoverable by design; killing the
    run here is not."""

    def __init__(self, store: ShardStore, mesh, every: int = 1,
                 cursor: dict | None = None):
        self._store = store
        self._mesh = mesh
        self._every = every
        self._due = _EveryN(every)
        self._cursor = dict(cursor or {})
        self._last_saved: int | None = None
        #: Seconds of each committed save on this rank, in order.
        self.save_seconds: list[float] = []

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))
        self._last_saved = None

    def needs_sync(self, step) -> bool:
        return self._due.due(step)

    def _save(self, state) -> bool:
        step = int(state.step)
        try:
            self._store.save(state, self._mesh,
                             cursor={**self._cursor, "step": step})
        except OSError as e:
            _SAVE_FAILURES.inc()
            _log(f"shard save at step {step} failed ({e}) — continuing; "
                 f"the newest quorum-valid set on disk is unchanged and "
                 f"the next interval retries")
            return False
        self.save_seconds.append(self._store.last_save["seconds"])
        return True

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step) and self._save(state):
            self._last_saved = int(state.step)
        return False

    def end(self, state) -> None:
        if int(state.step) == self._last_saved:
            return
        self._save(state)
