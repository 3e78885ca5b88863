"""Prefix-cache sharing: K/V rows keyed on prompt-prefix digest (the JAX
package's ``serving/prefix.py``).

Requests in one deployment overwhelmingly share prompt heads (system
preambles, few-shot scaffolding), and a transformer's K/V rows for a
prefix depend ONLY on that prefix — so the rows one slot computed are
bitwise the rows any other slot would compute for the same head.  This
registry stores each admitted prompt's rows under a chained SHA-256
digest of its token bytes (digest of ``prompt[:i]`` is an incremental
update of ``prompt[:i-1]``'s, so all P prefix keys cost one pass) and
admission consults it first:

- **full hit** — the whole prompt is registered: splice the stored rows
  into the slot (``engine.write_rows``), hand back the stored first
  token + last-position logits, and the request pays ZERO forward work;
- **partial hit** — some proper prefix is registered: splice its rows,
  then run only the SUFFIX through the engine's batched-verify window
  (``engine.extend``) — the forward shrinks from P to P-n tokens;
- **miss** — normal prefill, then the new prompt registers so the next
  request with this head hits.

Exactness is the engine's own pad-row invariant: stored rows beyond the
real prefix are junk the decode mask excludes until overwritten, so a
hit's continuation is bitwise the cold path's (pinned in
tests/test_torch_serving.py).  Hit/miss/partial land on the ``serve_*``
metrics family; eviction is LRU with a bounded entry count (rows are
device memory — the capacity knob is the residency bound).

Replicated-engine feature: the row import/export seams read and write
the slot axis the sharded engine shards over; the batcher refuses the
combination by name.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

_PREFIX_LOOKUPS = obs_metrics.counter(
    "serve_prefix_lookups_total",
    "prefix-cache admissions by outcome (hit / partial / miss)")
_PREFIX_ROWS = obs_metrics.counter(
    "serve_prefix_rows_reused_total",
    "K/V cache rows served from the prefix registry instead of compute")
_PREFIX_ENTRIES = obs_metrics.gauge(
    "serve_prefix_entries", "prompts resident in the prefix registry")


def prefix_digests(prompt) -> list:
    """Chained digests: ``out[i]`` keys ``prompt[:i+1]``.  One
    incremental SHA-256 pass (``copy()`` forks the running state), so
    registering and probing P prefixes costs O(P), not O(P^2)."""
    h = hashlib.sha256()
    out = []
    for t in np.asarray(prompt, np.int32).ravel():
        h.update(int(t).to_bytes(4, "little", signed=True))
        out.append(h.hexdigest())
    return out


class PrefixCache:
    """The per-worker registry.  Single-writer like the engine it
    wraps: the batcher thread is the only caller, so there is no lock
    — concurrency stays in the request queue."""

    def __init__(self, engine, *, capacity: int = 64):
        for seam in ("read_rows", "write_rows", "extend"):
            if not hasattr(engine, seam):
                raise ModeRefusal(
                    "--prefix_cache needs the engine's K/V row "
                    "import/export seams, which the params-stay-sharded "
                    "engine (--sharded_mesh) does not expose — its "
                    "cache rows shard over the slot axis; prefix "
                    "sharing composes with the replicated path only")
        if capacity < 1:
            raise ValueError(f"prefix-cache capacity {capacity} must "
                             f"be >= 1")
        self.engine = engine
        self.capacity = int(capacity)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.rows_reused = 0

    def __len__(self) -> int:
        return len(self._entries)

    def admit(self, slot: int, prompt) -> tuple | None:
        """Try to serve ``slot``'s admission from the registry.
        Returns ``(first_token, last_logits, outcome)`` on a hit
        (engine slot state already set — no prefill needed), or None on
        a miss (the caller prefills, then :meth:`register`s)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        P = len(prompt)
        digests = prefix_digests(prompt)
        entry = self._entries.get(digests[-1])
        if entry is not None:
            self._entries.move_to_end(digests[-1])
            self.engine.write_rows(slot, entry["k"], entry["v"])
            self.engine.set_slot(slot, entry["first_token"], P)
            self.hits += 1
            self.rows_reused += P
            _PREFIX_LOOKUPS.labels(outcome="hit").inc()
            _PREFIX_ROWS.inc(P)
            return entry["first_token"], entry["last_logits"], "hit"
        for n in range(P - 1, 0, -1):
            entry = self._entries.get(digests[n - 1])
            if entry is None:
                continue
            self._entries.move_to_end(digests[n - 1])
            self.engine.write_rows(slot, entry["k"], entry["v"])
            tok, last = self.engine.extend(slot, prompt[n:], start=n)
            self.engine.set_slot(slot, tok, P)
            self.partial_hits += 1
            self.rows_reused += n
            _PREFIX_LOOKUPS.labels(outcome="partial").inc()
            _PREFIX_ROWS.inc(n)
            # The completed prompt is itself a future head.
            self._store(digests[-1], slot, P, tok, last)
            return tok, last, "partial"
        self.misses += 1
        _PREFIX_LOOKUPS.labels(outcome="miss").inc()
        return None

    def register(self, slot: int, prompt, first_token: int,
                 last_logits) -> None:
        """Store a freshly prefilled prompt's rows (the miss path's
        second half; hits re-register nothing — their entry just moved
        to the LRU head)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        self._store(prefix_digests(prompt)[-1], slot, len(prompt),
                    int(first_token), last_logits)

    def _store(self, digest: str, slot: int, length: int,
               first_token: int, last_logits) -> None:
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return
        k, v = self.engine.read_rows(slot, length)
        self._entries[digest] = {
            "length": int(length), "k": k, "v": v,
            "first_token": int(first_token),
            "last_logits": (None if last_logits is None
                            else np.asarray(last_logits)),
        }
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        _PREFIX_ENTRIES.set(len(self._entries))

    def stats(self) -> dict:
        return {"hits": self.hits, "partial_hits": self.partial_hits,
                "misses": self.misses, "rows_reused": self.rows_reused,
                "entries": len(self._entries),
                "capacity": self.capacity}
