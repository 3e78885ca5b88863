"""Crash-consistent snapshots: atomic payload + manifest-last commit (the
JAX package's ``resilience/snapshot.py`` over the port's state).

The trainers' checkpoints (``training/checkpoint.py``) stay the resume
format; this store is the recovery format a supervisor, and serving's
promotion (``serving/promote.py``), trust, built so every failure of the
write path is detectable:

- payload first: :func:`~..training.state.saveable_state_dict` (the one
  definition of a resumable state) as one ``.npz`` of CPU numpy arrays
  keyed by the port's names (``params``, ``momentum``, ``buffer/<name>``,
  ``generator/<rank>``, ...), written to a temporary file, ``fsync``ed,
  then ``os.replace``d into place;
- manifest last: a small JSON with step, payload bytes, crc32, leaf
  count, the dataset cursor and the caller's metadata (``model``,
  ``update_layout``).  A manifest exists only once its payload rename
  committed, and validation re-checks size and crc32, so a write torn
  anywhere is detected and that snapshot skipped for the previous valid
  one, never restored.

Restores are bitwise (npz keeps dtype and bits) and go through
``training/state.load_state_dict``, which refuses another model, optimizer
or layout by name.  The store does not read the JAX package's ``.npz``
files: their leaves are a flax tree's.
"""

from __future__ import annotations

import io
import json
import os
import re
import sys
import zlib

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs.trace import span
from distributedtensorflowexample_tpu_torch.training.hooks import Hook, _EveryN
from distributedtensorflowexample_tpu_torch.training.state import (
    TrainState, load_state_dict, saveable_state_dict)

MANIFEST_VERSION = 1
_PAYLOAD_RE = re.compile(r"^snap_(\d{8})\.npz$")
#: The payload key of a ``None`` entry of the state's content (momentum
#: of a plain-SGD run): ``<key>=None``, holding an empty array.
_NONE = "=None"

_SAVES = obs_metrics.counter(
    "snapshot_saves_total", "committed snapshot writes (payload+manifest)")
_SAVE_FAILURES = obs_metrics.counter(
    "snapshot_save_failures", "snapshot writes refused by the OS "
    "(disk full et al.) that the run survived")
_RESTORES = obs_metrics.counter(
    "snapshot_restores_total", "successful restores from a snapshot")
_FALLBACKS = obs_metrics.counter(
    "snapshot_fallbacks_total",
    "invalid (torn/corrupt) snapshots discarded in favor of an older one")


def _log(msg: str) -> None:
    # stderr: tools with a JSON-lines stdout protocol must never see
    # prose on fd 1.
    print(f"snapshot: {msg}", file=sys.stderr, flush=True)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _content_to_arrays(content: dict) -> dict[str, np.ndarray]:
    """``saveable_state_dict``'s content as flat numpy arrays by name."""
    out = {"step": np.asarray(content["step"], np.int64),
           "count": np.asarray(content["count"], np.int64),
           "layout": np.asarray(content["layout"])}
    for name, buf in content["buffers"].items():
        out[f"buffer/{name}"] = _host(buf)
    for rank, gen in content["generators"].items():
        out[f"generator/{int(rank)}"] = _host(gen)
    for key in ("params", "momentum", "params_rows", "momentum_rows"):
        if key not in content:
            continue
        value = content[key]
        if value is None:
            out[key + _NONE] = np.zeros(0, np.uint8)
        elif isinstance(value, list):
            for i, row in enumerate(value):
                out[f"{key}/{i}"] = _host(row)
        else:
            out[key] = _host(value)
    return out


def _arrays_to_content(arrays: dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`_content_to_arrays` (CPU tensors)."""
    content = {"step": int(arrays["step"]), "count": int(arrays["count"]),
               "layout": str(arrays["layout"]), "buffers": {},
               "generators": {}}
    rows: dict[str, dict[int, torch.Tensor]] = {}
    for key, a in arrays.items():
        if key in ("step", "count", "layout"):
            continue
        if key.endswith(_NONE):
            content[key[:-len(_NONE)]] = None
            continue
        t = torch.from_numpy(np.array(a, copy=True))
        head, _, tail = key.partition("/")
        if head == "buffer":
            content["buffers"][tail] = t
        elif head == "generator":
            content["generators"][int(tail)] = t
        elif tail:
            rows.setdefault(head, {})[int(tail)] = t
        else:
            content[head] = t
    for key, by_index in rows.items():
        content[key] = [by_index[i] for i in sorted(by_index)]
    return content


class SnapshotStore:
    """Keep-N rotating store of crash-consistent state snapshots."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep

    # --- paths -----------------------------------------------------------
    def _payload_path(self, step: int) -> str:
        return os.path.join(self._dir, f"snap_{step:08d}.npz")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._dir, f"snap_{step:08d}.json")

    def steps(self) -> list[int]:
        """Steps with a committed payload file, ascending (a payload may
        still fail validation — see :meth:`latest_valid`)."""
        out = []
        for name in os.listdir(self._dir):
            m = _PAYLOAD_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # --- write -----------------------------------------------------------
    def _atomic_write(self, path: str, data: bytes) -> None:
        # A method so fault tests can inject a full disk here.
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def save(self, state: TrainState, cursor: dict | None = None,
             meta: dict | None = None, force: bool = False) -> bool:
        """Write one snapshot of ``state`` (one rank's, replicated: the
        content of :func:`saveable_state_dict` on ``ONE_RANK``); returns
        False if ``step`` already has a valid committed snapshot unless
        ``force``."""
        step = int(state.step)
        if not force and os.path.exists(self._manifest_path(step)):
            if self.validate(step)[0]:
                return False
            # An invalid snapshot at this step must not dedupe away its
            # own repair: redoing the step is what heals it.
            _log(f"re-writing invalid snapshot {step}")
        arrays = _content_to_arrays(saveable_state_dict(state))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        self._atomic_write(self._payload_path(step), payload)
        manifest = {
            "version": MANIFEST_VERSION,
            "step": step,
            "nbytes": len(payload),
            "crc32": zlib.crc32(payload),
            "leaves": len(arrays),
            "cursor": cursor,
            "meta": meta,
        }
        self._atomic_write(self._manifest_path(step),
                           json.dumps(manifest).encode())
        _SAVES.inc()
        self._prune()
        return True

    def _prune(self) -> None:
        for step in self.steps()[:-self._keep] if self._keep else []:
            for p in (self._payload_path(step), self._manifest_path(step)):
                try:
                    os.remove(p)
                except OSError:
                    pass

    # --- validate / read -------------------------------------------------
    def manifest(self, step: int) -> dict | None:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _checked_payload(self, step: int) -> tuple[bytes | None, str]:
        """The payload bytes iff the manifest parses AND size and crc32
        match what it committed, else (None, why)."""
        man = self.manifest(step)
        if man is None:
            return None, "manifest missing or unreadable"
        try:
            with open(self._payload_path(step), "rb") as f:
                payload = f.read()
        except OSError:
            return None, "payload missing"
        if len(payload) != man.get("nbytes"):
            return None, (f"payload torn: {len(payload)} bytes on disk, "
                          f"manifest committed {man.get('nbytes')}")
        if zlib.crc32(payload) != man.get("crc32"):
            return None, "payload corrupt: crc32 mismatch"
        return payload, "ok"

    def validate(self, step: int) -> tuple[bool, str]:
        payload, why = self._checked_payload(step)
        return payload is not None, why

    def latest_valid(self) -> int | None:
        """Newest step that passes validation; every newer invalid one is
        logged as discarded (a torn final write costs one snapshot
        interval, never the run)."""
        for step in reversed(self.steps()):
            ok, why = self.validate(step)
            if ok:
                return step
            _FALLBACKS.inc()
            _log(f"discarding snapshot {step} ({why}); "
                 f"falling back to the previous one")
        return None

    def restore(self, state: TrainState,
                step: int | None = None) -> TrainState:
        """Restore into ``state`` in place (the identity when the store
        is empty).  Content of another model, optimizer or layout is
        refused by name (``load_state_dict``)."""
        step = self.latest_valid() if step is None else step
        if step is None:
            return state
        payload, why = self._checked_payload(step)
        if payload is None:
            raise ValueError(f"snapshot {step} failed validation: {why}")
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
        load_state_dict(state, _arrays_to_content(arrays))
        _RESTORES.inc()
        return state

    def discard_newer(self, step: int) -> list[int]:
        """Delete every snapshot (payload + manifest) newer than
        ``step``: a rank that ran ahead of an agreed resume step holds
        snapshots from a timeline being abandoned, which ``save`` would
        otherwise dedupe against.  Returns the discarded steps,
        ascending; a still-valid snapshot the OS would not delete is not
        reported discarded."""
        dropped = []
        for s in self.steps():
            if s <= step:
                continue
            failed = None
            for p in (self._payload_path(s), self._manifest_path(s)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
                except OSError as e:
                    failed = e
            if failed is not None and self.validate(s)[0]:
                _log(f"FAILED to discard snapshot {s} ({failed}) — it is "
                     f"still restorable as newest")
                continue
            dropped.append(s)
        if dropped:
            _log(f"discarded snapshot(s) {dropped} newer than agreed "
                 f"step {step} (divergent timeline)")
        return dropped

    # --- fault-injection surface -----------------------------------------
    def tear_latest(self) -> int | None:
        """Truncate the newest payload mid-file (a write that died half
        way, or later media loss).  Returns the torn step, or None if the
        store is empty."""
        steps = self.steps()
        if not steps:
            return None
        path = self._payload_path(steps[-1])
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return steps[-1]


def valid_steps(directory: str) -> list[int]:
    """Steps in ``directory`` that pass validation, ascending (reads
    manifests and payload bytes, never deserializes state)."""
    store = SnapshotStore(directory)
    return [s for s in store.steps() if store.validate(s)[0]]


def newest_common_step(manifest_dirs: list[str]) -> int | None:
    """The largest step EVERY directory holds a valid snapshot for: the
    step N independently snapshotting ranks can all resume at after an
    unclean death.  None when no common valid step exists."""
    common: set[int] | None = None
    for d in manifest_dirs:
        steps = set(valid_steps(d))
        common = steps if common is None else common & steps
        if not common:
            return None
    return max(common) if common else None


class SnapshotHook(Hook):
    """Periodic + final snapshot.  ``cursor`` is the static part of the
    dataset cursor (e.g. ``{"seed": cfg.seed}``); the step is stamped at
    save time, so the manifest names the batch-stream position a resume
    rebuilds (``DeviceDataset(..., start_step=cursor["step"])``)."""

    def __init__(self, store: SnapshotStore, every: int = 1,
                 cursor: dict | None = None, meta: dict | None = None):
        self._store = store
        self._every = every
        self._due = _EveryN(every)
        self._cursor = dict(cursor or {})
        self._meta = meta
        self._last_saved: int | None = None

    def begin(self, loop) -> None:
        self._due = _EveryN(self._every, int(loop.start_step))
        self._last_saved = None

    def needs_sync(self, step) -> bool:
        return self._due.due(step)

    def _save(self, state, force: bool = False) -> bool:
        """One guarded write: an OSError (disk full) is logged and
        counted, never raised — losing one interval is recoverable by
        design (keep-N and the manifest fallback), a dead run is not."""
        step = int(state.step)
        try:
            with span("snapshot", step=step):
                self._store.save(state, cursor={**self._cursor,
                                                "step": step},
                                 meta=self._meta, force=force)
            return True
        except OSError as e:
            _SAVE_FAILURES.inc()
            _log(f"save at step {step} failed ({e}) — continuing; the "
                 f"newest valid snapshot on disk is unchanged and the "
                 f"next interval retries")
            return False

    def after_step(self, step, state, metrics) -> bool:
        if self._due(step) and self._save(state):
            self._last_saved = int(state.step)
        return False

    def end(self, state) -> None:
        if int(state.step) == self._last_saved:
            return
        self._save(state, force=True)
