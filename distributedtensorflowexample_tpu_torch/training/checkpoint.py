"""Checkpoints and resume (the JAX package's ``training/checkpoint.py``
``CheckpointManager``), in a torch-native format.

Semantics kept from the reference: periodic saves, keep-N rotation,
restore from the newest checkpoint on start, the run metadata beside the
checkpoints, and saves written on a background thread (the training does
not wait for the disk).

Layout under ``directory``::

    run_metadata.json       the writing run's facts (sync_mode, ...)
    <step>/rank-<r>.pt      one ``torch.save`` of CPU tensors per part

A replicated state (sync mode in the ``tree`` layout) is one part,
``rank-0.pt``, written by rank 0 and carrying every rank's dropout
generator; a per-rank state (async mode: one worker per rank, with its
own batch-norm statistics; the ``bucket_rows`` and ``zero3_rows``
layouts: this rank's rows) is one part per rank.  The parts go to
``.tmp-<step>/`` first, each through a temporary file name; once every
rank has joined its writer (an all-gather of their outcomes), rank 0
renames the directory to ``<step>`` and every rank waits for that (a
second all-gather).  So a ``<step>`` directory exists only with every
part of it complete, and :meth:`CheckpointManager.latest_step` never
names one that is half written.

That step (``wait``) runs on the caller's thread, at the next
:meth:`~CheckpointManager.save` or at :meth:`~CheckpointManager.wait`,
which every rank reaches at the same call boundary.  A write that failed
on any rank is raised there, on every rank, and nothing is renamed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import torch

from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh)
from distributedtensorflowexample_tpu_torch.training.state import (
    TrainState, load_state_dict, saveable_state_dict)

_METADATA = "run_metadata.json"


def _part(rank: int) -> str:
    return f"rank-{rank}.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, run_metadata: dict | None = None,
                 mesh: Mesh = ONE_RANK, per_rank: bool = False):
        """``run_metadata``: small JSON-able facts about the writing run
        (``sync_mode``, the mesh size, the worker count) kept next to the
        checkpoints, so a later run can refuse a restore of another
        layout by name.  ``per_rank``: every rank writes its own part
        (async mode's per-worker state) instead of rank 0 alone.  Every
        rank of ``mesh`` constructs its manager at the same point, before
        any of them saves."""
        self._dir = os.path.abspath(directory)
        self._keep = max(1, max_to_keep)
        self._async = async_save
        self._run_metadata = run_metadata
        self._mesh = mesh
        self._per_rank = per_rank
        # Finalized steps, read once here and then kept in step on every
        # rank (a rank reading the disk could race rank 0's renames).
        self._steps = self._scan()
        self._pending: int | None = None
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self.stats = {"save_s": [], "write_s": [], "restore_s": []}

    def _scan(self) -> list[int]:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def all_steps(self) -> list[int]:
        return list(self._steps)

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def save(self, step: int, state: TrainState) -> bool:
        """Save ``state`` as ``step`` (every rank calls it); False when
        this step is already saved.  The tensors are copied to the host
        here; the write runs on a thread with ``async_save``, else before
        this returns."""
        step = int(step)
        self.wait()                 # the previous save, finalized first
        if step in self._steps:
            return False            # periodic save already covered it
        t0 = time.perf_counter()
        content = saveable_state_dict(state, self._mesh,
                                      replicated=not self._per_rank)
        self._pending = step
        if self._per_rank or self._mesh.rank == 0:
            args = (os.path.join(self._dir, f".tmp-{step}"),
                    _part(self._mesh.rank), content)
            if self._async:
                self._writer = threading.Thread(target=self._write,
                                                args=args, daemon=True)
                self._writer.start()
            else:
                self._write(*args)
        self.stats["save_s"].append(time.perf_counter() - t0)
        if not self._async:
            self.wait()
        return True

    def _write(self, tmp_dir: str, name: str, content: dict) -> None:
        try:
            t0 = time.perf_counter()
            os.makedirs(tmp_dir, exist_ok=True)
            path = os.path.join(tmp_dir, name)
            torch.save(content, path + ".tmp")
            os.replace(path + ".tmp", path)
            self.stats["write_s"].append(time.perf_counter() - t0)
        except BaseException as exc:    # raised again by wait()
            self._error = exc

    def wait(self) -> None:
        """Join the pending save's writer and finalize it: every rank's
        part written, rank 0 renames the step into place (and rewrites the
        metadata, and drops the oldest checkpoints past ``max_to_keep``).
        Raises, on every rank, if any rank's write failed."""
        if self._pending is None:
            return
        step, self._pending = self._pending, None
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        error, self._error = self._error, None
        failed = self._mesh.all_gather_int(error is not None)
        if any(failed):
            ranks = [r for r, f in enumerate(failed) if f]
            raise RuntimeError(
                f"checkpoint save at step {step} failed on rank(s) {ranks}; "
                f"nothing was renamed into {self._dir}") from error
        self._steps = sorted(set(self._steps) | {step})
        drop, self._steps = (self._steps[:-self._keep],
                             self._steps[-self._keep:])
        if self._mesh.rank == 0:
            self._write_run_metadata()
            os.replace(os.path.join(self._dir, f".tmp-{step}"),
                       os.path.join(self._dir, str(step)))
            for old in drop:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        self._mesh.all_gather_int(0)    # the rename is visible to all

    def _write_run_metadata(self) -> None:
        """Keep the metadata describing the CURRENT writer: a reused
        directory whose new (non-resumed) run differs must overwrite it,
        or a later resume of the new checkpoints would be wrongly
        refused.  Rank 0 only, atomically through a rename."""
        if self._run_metadata is None:
            return
        if self.saved_run_metadata() == self._run_metadata:
            return
        path = os.path.join(self._dir, _METADATA)
        with open(path + ".tmp", "w") as f:
            json.dump(self._run_metadata, f)
        os.replace(path + ".tmp", path)

    def saved_run_metadata(self) -> dict | None:
        """Metadata of the run that wrote this directory (None if
        absent)."""
        path = os.path.join(self._dir, _METADATA)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, state: TrainState,
                step: int | None = None) -> TrainState:
        """Restore ``step`` (default: the newest) into ``state`` in place;
        the identity when there is no checkpoint."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return state
        t0 = time.perf_counter()
        rank = self._mesh.rank if self._per_rank else 0
        path = os.path.join(self._dir, str(step), _part(rank))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint step {step} in {self._dir} has no {_part(rank)} "
                f"(written by another number of ranks?)")
        content = torch.load(path, map_location="cpu", weights_only=True)
        load_state_dict(state, content, self._mesh)
        self.stats["restore_s"].append(time.perf_counter() - t0)
        return state

    def close(self) -> None:
        self.wait()
