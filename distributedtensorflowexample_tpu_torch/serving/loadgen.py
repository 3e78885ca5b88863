"""Closed-loop load generator: the measurement half of the serving path
(a copy of the JAX package's ``serving/loadgen.py``).

Open-loop generators (fixed arrival rate) measure a latency curve but
overload the system at will; a CLOSED loop — K client threads, each
submitting one request, waiting for its completion, then immediately
submitting the next — self-limits to the system's actual service rate,
so sweeping K traces out the throughput/latency trade directly:
tokens/sec climbs with K until the slots saturate, then p50/p99 climb
instead.  With the SLO admission knob on, the same sweep yields the
throughput-vs-SLO curve of a serving benchmark (in-SLO goodput vs
the rejection rate at each operating point).

Determinism: prompts are generated from a seeded RNG keyed by request
index, so request #17 is byte-identical across runs, placements, and
resumes — the property the scheduler drill leans on when a TERM'd
serving worker's relaunch re-issues exactly the unfinished ids.

Resumable driving: ``DriveFile`` is the victim-script progress tape of
the serving world — one appended line per COMPLETED request.  A TERM'd
worker drains its in-flight requests (they complete and append), the
relaunch reads the tape, and re-issues only the ids with no line: no
accepted request is ever lost, none is answered twice.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

_DEF_CLIENTS = 2
_DEF_REQUESTS = 16


def load_clients_default() -> int:
    """``SERVE_LOAD_CLIENTS``: default closed-loop client thread count
    for serve_lm --drive (CLI flags override)."""
    try:
        return max(1, int(os.environ.get("SERVE_LOAD_CLIENTS", "")))
    except ValueError:
        return _DEF_CLIENTS


def load_requests_default() -> int:
    """``SERVE_LOAD_REQUESTS``: default request count one drive
    point issues (CLI flags override)."""
    try:
        return max(1, int(os.environ.get("SERVE_LOAD_REQUESTS", "")))
    except ValueError:
        return _DEF_REQUESTS


def make_prompt(index: int, vocab: int, seed: int = 0,
                min_len: int = 4, max_len: int = 12) -> np.ndarray:
    """Deterministic per-index prompt (seeded, index-keyed): the same
    request id always carries the same bytes."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    n = int(rng.integers(min_len, max_len + 1))
    return rng.integers(0, vocab, size=n).astype(np.int32)


class DriveFile:
    """Append-only completed-request tape (torn-tail tolerant like
    every journal reader in the repo): ``{"id": i, "tokens": [...]}``
    per line."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def done_ids(self) -> dict[int, list]:
        out: dict[int, list] = {}
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn tail: that id re-issues
            if isinstance(rec, dict) and isinstance(rec.get("id"), int):
                out[rec["id"]] = rec.get("tokens") or []
        return out

    def append(self, rid: int, tokens: list) -> None:
        line = json.dumps({"id": rid, "tokens": list(tokens)},
                          sort_keys=True)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())


class ClosedLoopLoadGen:
    """K client threads against one RequestQueue, driving a fixed id
    set to completion.  ``run()`` blocks until every target id has a
    completed line (or ``stop`` is set — the TERM path: clients stop
    issuing, in-flight requests drain through the batcher)."""

    def __init__(self, queue, *, total: int, clients: int,
                 max_new: int, vocab: int, seed: int = 0,
                 drive_file: DriveFile | None = None,
                 prompt_min: int = 4, prompt_max: int = 12,
                 max_attempts: int = 5, think_ms: float = 0.0):
        self.queue = queue
        self.total = int(total)
        self.clients = max(1, int(clients))
        self.max_new = int(max_new)
        self.vocab = int(vocab)
        self.seed = seed
        self.drive = drive_file
        self.prompt_min, self.prompt_max = prompt_min, prompt_max
        # Closed-loop clients resubmit a rejected id — but a system
        # whose SLO rejects EVERYTHING (the sweep's tightest points)
        # must end the measurement, not hang it: after max_attempts an
        # id is given up and counted, and the goodput at that operating
        # point is honestly ~0.
        self.max_attempts = max(1, int(max_attempts))
        # Think time: the classic closed-loop load parameter — a client
        # pauses this long after each completion before its next
        # request, so offered load is tunable below saturation (and a
        # drill can hold a worker busy for a predictable span).
        self.think_ms = float(think_ms)
        self.stop = threading.Event()
        self.results: list = []          # finished Request objects
        self.gave_up: list[int] = []
        self._pending: list[int] = []
        self._attempts: dict[int, int] = {}
        self._lock = threading.Lock()

    def _next_id(self) -> int | None:
        with self._lock:
            return self._pending.pop(0) if self._pending else None

    def _requeue(self, rid: int) -> None:
        with self._lock:
            self._pending.append(rid)

    def _client(self) -> None:
        while not self.stop.is_set():
            rid = self._next_id()
            if rid is None:
                return
            prompt = make_prompt(rid, self.vocab, self.seed,
                                 self.prompt_min, self.prompt_max)
            req = self.queue.submit(prompt, self.max_new, rid=f"d{rid}")
            req.done.wait()
            self.results.append(req)
            if req.outcome == "ok":
                if self.drive is not None:
                    self.drive.append(rid, req.tokens)
                if self.think_ms > 0:
                    self.stop.wait(self.think_ms / 1000.0)
            elif req.outcome == "refused":
                # Geometry refusal is deterministic: the same id would
                # be refused forever — give up immediately, loudly.
                self.gave_up.append(rid)
            else:
                # slo_rejected / drained: the id is NOT done — a later
                # client turn (or the next placement) re-issues it,
                # until its attempt budget runs out.  Tiny backoff so
                # an overloaded queue isn't hammered by instant
                # re-submissions of the same id.
                with self._lock:
                    n = self._attempts[rid] = \
                        self._attempts.get(rid, 0) + 1
                if n >= self.max_attempts:
                    self.gave_up.append(rid)
                else:
                    self._requeue(rid)
                    time.sleep(0.002)

    def run(self) -> dict:
        already = self.drive.done_ids() if self.drive is not None else {}
        self._pending = [i for i in range(self.total) if i not in already]
        skipped = self.total - len(self._pending)
        threads = [threading.Thread(target=self._client, daemon=True,
                                    name=f"loadgen-{i}")
                   for i in range(self.clients)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"issued": len(self.results), "resumed_skip": skipped,
                "wall_s": round(time.monotonic() - t0, 3),
                "gave_up": len(self.gave_up),
                "remaining": len(self._pending)}
