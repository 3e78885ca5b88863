"""Params-stay-sharded decode: the ZeRO-3 read path (the JAX package's
``serving/sharded.py``) over the port's ranks.

The replicated engine (``serving/engine.py``) holds the full parameters
on its device.  This engine keeps the TRAINING-side resident layout at
serve time: the parameters stay ``parallel/zero3.Zero3Layout`` rows, rank
r holding its ``[W_b]`` row of every bucket (1/D of the parameters plus
the rows' padding: :meth:`ShardedDecodeEngine.params_residency`), and
every step all-gathers each bucket just before its first read, with at
most two gathers in flight — ZeRO-3's own schedule
(``parallel/zero3._StepGathers`` behind ``_gathered_on_read``), not a
second one.  The gathered leaves are a step-local temporary, dropped when
the step ends; nothing is cached across steps, so a decode step is
exactly B parameter all-gathers (B = the layout's bucket count).

The KV cache is sharded over the slot axis: rank r holds slots
``[r*S/D, (r+1)*S/D)`` in its own ``[L, S/D, T, H, Dh]`` caches, so the
slot count must be a multiple of D (refused by name otherwise).  Each
rank decodes its S/D slots against the gathered parameters, with the
shapes of a replicated engine of S/D slots, so a request's tokens are
bitwise those of such an engine fed the same prompt (the gathered leaves
are bitwise the replicated ones: the gather and the unpack move bytes).
Prefill runs on every rank in lockstep (the gathers are collective): each
rank's forward covers the group's prompts that land in its own slots,
padded to its S/D rows (the S/D-slot engine's shape), and only the slot's
owner writes the K/V rows.

One controller: the batcher, the queue and the front end live on rank 0
(``serving/serve_lm.py``), and the other ranks run :meth:`follow`.  For
every step rank 0 broadcasts ONE ``2 + 3*S`` int64 command — the op
(decode, prefill, stop), the prefill bucket, every slot's last token and
position, and the decode step's busy slots or the prefill's prompt
lengths — and a prefill sends its ``[S, bucket]`` prompt tokens after it
in a second broadcast; the tokens of every rank's slots come back by ONE
all-gather of ``[S/D]`` int64.  These control messages are the only
collectives beside the B parameter all-gathers, and
:data:`SHARDED_DECODE_CONTRACT` counts a decode step's under their own
kinds.
A follower blocked in the command broadcast leaves on the stop command
(:meth:`stop_followers`, which rank 0 sends on every exit path); a rank
that dies takes the group down through ``parallel/launch.spawn``.

Speculative decoding, sampling and the prefix cache need the replicated
engine's logits, verify and K/V-row seams, which this engine does not
have; the batcher, ``SpecDecoder`` and ``PrefixCache`` refuse them by
name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.models.transformer_lm import (
    TransformerLM)
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
    Zero3Layout, _gathered_on_read, _StepGathers)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.serving.engine import (
    DEFAULT_SLOTS, KVCache, SlotHost, _OpAudit)

#: What a sharded decode step may do (the port's form of the JAX
#: package's ``SHARDED_DECODE_HLO_CONTRACT``), checked by
#: :func:`check_sharded_decode_contract`: per step EXACTLY one parameter
#: all-gather per bucket (symbolic ``"B"``: fewer is a regression, more
#: is a finding), one command broadcast and one token all-gather (the
#: control messages, their own kinds), and no other collective; the
#: caches' storage fixed; ``torch.cuda.memory_allocated`` flat across
#: steps on the card; nothing wider than float32.
SHARDED_DECODE_CONTRACT = {
    "mode": "serve_decode_sharded",
    "cache_storage_fixed": True,
    "allocated_bytes_flat": True,
    "dtype_ceiling": torch.float32,
    "collective_budget": {"all-gather": "B", "control-broadcast": 1,
                          "control-gather": 1},
}

#: The dispatcher's collective ops -> the contract's kinds (an op outside
#: these counts under its own name).
_KINDS = {"c10d._allgather_base_.default": "all-gather",
          "c10d.broadcast_.default": "control-broadcast",
          "c10d.allgather_.default": "control-gather"}

_STOP, _DECODE, _PREFILL = 0, 1, 2


def check_slots(slots: int, num_ranks: int) -> None:
    """The by-name refusal of a slot count the ranks do not divide (also
    checked before any rank is started)."""
    if slots < 1:
        raise ValueError(f"slots {slots} must be >= 1")
    if slots % num_ranks != 0:
        raise ModeRefusal(
            f"--slots {slots} does not divide across the {num_ranks}-rank "
            f"mesh — the KV-cache shards over the slot axis (slots/D rows "
            f"per rank), so the slot count must be a multiple of the mesh "
            f"size; use --slots "
            f"{((slots + num_ranks - 1) // num_ranks) * num_ranks}")


class ShardedDecodeEngine(SlotHost):
    """The DecodeEngine's row-resident twin on one rank of ``mesh``: the
    surface the ContinuousBatcher drives (``bucket_for``, ``prefill``,
    ``prefill_many``, ``decode``, ``set_slot``) on rank 0, and
    :meth:`follow` on the others.  ``rows``: this rank's row of each
    bucket of ``layout``; ``model``: the training ``TransformerLM`` whose
    parameters are placeholders (``serving/promote.promote_sharded``)."""

    def __init__(self, model: TransformerLM, rows, layout: Zero3Layout, *,
                 mesh: Mesh, slots: int = DEFAULT_SLOTS,
                 cache_len: int = 128, prefill_smallest: int = 8,
                 overlap: bool = True):
        D = layout.num_devices
        self._init_slots(model, slots, cache_len, prefill_smallest)
        check_slots(slots, D)
        if mesh.size != D:
            raise ValueError(f"the layout shards over {D} ranks; the mesh "
                             f"has {mesh.size}")
        self.layout = layout
        self.mesh = mesh
        self.device = mesh.device
        self.rows = [r.to(self.device) for r in rows]
        self.local_slots = self.slots // D
        self._lo = mesh.rank * self.local_slots
        blk = self.smodel.blocks[0]
        with torch.inference_mode():
            self.cache = KVCache(model.n_layers, self.local_slots,
                                 self.cache_len, blk.n_heads,
                                 blk.qkv.in_features // blk.n_heads,
                                 model.dtype, self.device)
        self.local_cache_bytes = self.cache.nbytes
        self.cache_bytes = self.cache.nbytes * D
        self._depth = 2 if overlap else 0
        self._order = list(range(layout.num_buckets))
        self._stopped = False
        #: Control messages sent or received, by the contract's kinds.
        self.control = {"control-broadcast": 0, "control-gather": 0}

    # --- the command ------------------------------------------------------
    def _command(self, op: int, bucket: int = 0,
                 per_slot=None) -> np.ndarray:
        """The fixed ``2 + 3*S`` header: op, bucket, every slot's last
        token and position, and the busy slots (decode) or the prompt
        lengths (prefill)."""
        S = self.slots
        cmd = np.zeros(2 + 3 * S, np.int64)
        cmd[0], cmd[1] = op, bucket
        cmd[2:2 + S] = self.last_tokens
        cmd[2 + S:2 + 2 * S] = self.positions
        if per_slot is not None:
            cmd[2 + 2 * S:] = per_slot
        return cmd

    def _broadcast(self, a: np.ndarray | None, n: int) -> np.ndarray:
        """Rank 0's ``n`` int64 values on every rank (one broadcast)."""
        t = (torch.from_numpy(np.ascontiguousarray(a, np.int64).reshape(-1))
             if a is not None else torch.empty(n, dtype=torch.int64))
        t = self.mesh.broadcast(t.to(self.device))
        self.control["control-broadcast"] += 1
        return t.cpu().numpy()

    def _exchange(self, cmd: np.ndarray | None = None,
                  prompts: np.ndarray | None = None) -> tuple:
        """Rank 0's command on every rank, and a prefill's ``[S, bucket]``
        prompt tokens after it in a second broadcast (a decode step's
        command is the header alone)."""
        cmd = self._broadcast(cmd, 2 + 3 * self.slots)
        if int(cmd[0]) == _PREFILL:
            bucket = int(cmd[1])
            prompts = self._broadcast(prompts, self.slots * bucket) \
                .reshape(self.slots, bucket)
        return cmd, prompts

    def _gather(self, local: np.ndarray) -> np.ndarray:
        """Every rank's ``[S/D]`` tokens, in slot order (one all-gather)."""
        parts = self.mesh.all_gather(torch.from_numpy(
            np.ascontiguousarray(local, np.int64)))
        self.control["control-gather"] += 1
        return torch.cat(parts).numpy()

    @contextlib.contextmanager
    def _gathered(self):
        """The model's parameters read through this step's bucket gathers
        (ZeRO-3's schedule, the previous step's read order ahead)."""
        gathers = _StepGathers(self.layout, self.rows, self.mesh,
                               self._depth, self._order)
        with _gathered_on_read(self.model, gathers):
            yield
        self._order[:] = gathers.read + [
            b for b in range(self.layout.num_buckets)
            if b not in gathers.read]

    # --- one step, on every rank -----------------------------------------
    @torch.inference_mode()
    def _run(self, cmd: np.ndarray, prompts: np.ndarray | None) \
            -> np.ndarray | None:
        """Execute one command on this rank's slots; returns every slot's
        token (the gathered result), or None for the stop command."""
        op, S, Sl, lo = int(cmd[0]), self.slots, self.local_slots, self._lo
        if op == _STOP:
            self._stopped = True
            return None
        local = np.full(Sl, -1, np.int64)
        if op == _DECODE:
            io = self._upload(np.stack([cmd[2 + lo:2 + lo + Sl],
                                        cmd[2 + S + lo:2 + S + lo + Sl]]))
            with self._gathered():
                logits = self.smodel.decode(io[0], io[1], self.cache)
            local = logits.argmax(-1).to(torch.int64).cpu().numpy()
            self.decode_steps += 1
        elif op == _PREFILL:
            bucket = int(cmd[1])
            lengths = cmd[2 + 2 * S + lo:2 + 2 * S + lo + Sl]
            mine = prompts[lo:lo + Sl]
            group = [i for i in range(Sl) if lengths[i] > 0]
            host = np.zeros((Sl, bucket + 2), np.int64)
            for k, i in enumerate(group):
                host[k, :lengths[i]] = mine[i, :lengths[i]]
                host[k, bucket:] = i, lengths[i]
            dev = self._upload(host)
            with self._gathered():
                logits, k_rows, v_rows = self.smodel.prefill(dev[:, :bucket])
            n = len(group)
            if n:
                slots_ix = dev[:n, bucket]
                self.cache.k[:, slots_ix, :bucket] = k_rows[:, :n]
                self.cache.v[:, slots_ix, :bucket] = v_rows[:, :n]
                last = logits[torch.arange(n, device=self.device),
                              dev[:n, bucket + 1] - 1].cpu().numpy()
                local[group] = np.argmax(last, axis=-1)
            self.prefills += n
        else:
            raise ValueError(f"unknown sharded-engine command {op}")
        return self._gather(local)

    def follow(self) -> int:
        """A follower rank's loop: execute rank 0's commands until the
        stop command; returns the decode steps run."""
        if self.mesh.rank == 0:
            raise RuntimeError("rank 0 drives the engine; follow() is for "
                               "the other ranks")
        while self._run(*self._exchange()) is not None:
            pass
        return self.decode_steps

    def stop_followers(self) -> None:
        """Rank 0: send the stop command (once); the followers' loops
        return."""
        if self.mesh.rank == 0 and not self._stopped:
            self._run(*self._exchange(self._command(_STOP)))

    def _drive(self, cmd: np.ndarray,
               prompts: np.ndarray | None = None) -> np.ndarray:
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 drives the sharded engine")
        if self._stopped:
            raise RuntimeError("the followers were stopped")
        return self._run(*self._exchange(cmd, prompts))

    # --- the steps (DecodeEngine's surface, rank 0) ------------------------
    def prefill_many(self, assignments: list) -> dict:
        """Prompts sharing a padding bucket share ONE step (one command,
        the ``[S, bucket]`` prompts, B gathers, one token gather), each
        rank computing its own slots' prompts.  Returns {slot:
        (first_token, None)}: no last-logits seam (sampling is refused
        with this engine by name)."""
        out: dict = {}
        for bucket, group in self._bucket_groups(assignments):
            lengths = np.zeros(self.slots, np.int64)
            prompts = np.zeros((self.slots, bucket), np.int64)
            for slot, prompt in group:
                lengths[slot] = len(prompt)
                prompts[slot, :len(prompt)] = prompt
            toks = self._drive(self._command(_PREFILL, bucket, lengths),
                               prompts)
            for slot, prompt in group:
                self.positions[slot] = len(prompt)
                self.last_tokens[slot] = int(toks[slot])
                out[slot] = (int(toks[slot]), None)
        return out

    def decode(self, busy=None) -> np.ndarray:
        """One decode step over ALL slots (every rank its own); returns
        the next token per slot and advances the BUSY slots' frontiers
        (``busy=None`` advances all)."""
        advance = np.zeros(self.slots, bool)
        advance[list(range(self.slots)) if busy is None else list(busy)] = True
        out = self._drive(self._command(_DECODE, per_slot=advance))
        out = out.astype(np.int32)
        self.positions = self.positions + advance.astype(np.int32)
        self.last_tokens = np.where(advance, out, self.last_tokens) \
            .astype(np.int32)
        return out

    # --- the contract surface ---------------------------------------------
    def params_residency(self) -> dict:
        """The 1/D claim from the live rows: this rank's bytes against the
        rows' total over the group (``frac_per_device`` is exactly 1/D;
        a replication regression would show 1.0), and the unpadded
        parameter bytes."""
        per_dev = sum(r.numel() * r.element_size() for r in self.rows)
        total = per_dev * self.layout.num_devices
        unpadded = sum(s.size * 4 for s in self.layout.plan.specs)
        return {"params_bytes_total": int(total),
                "params_bytes_per_device": int(per_dev),
                "frac_per_device": per_dev / total if total else 0.0,
                "params_bytes_unpadded": int(unpadded),
                "padding_bytes": int(self.layout.padding_bytes),
                "num_devices": self.layout.num_devices,
                "num_buckets": self.layout.num_buckets}


def check_sharded_decode_contract(
        engine: ShardedDecodeEngine, steps: int = 20, step=None,
        contract: dict = SHARDED_DECODE_CONTRACT) -> list[str]:
    """Run ``steps`` decode steps on rank 0 (``step``, default
    ``engine.decode``; the followers must be in :meth:`follow`) and
    return what broke ``contract`` (empty: it holds).  The collectives
    are counted twice: by the dispatcher's ops under an audit, and by
    the mesh's and the engine's own counters.  The first step is the
    warm-up for the allocated bytes (read after it and after the last,
    on the card only).  Run it with no live request: the steps overwrite
    cache rows (positions and last tokens are put back)."""
    if steps < 2:
        raise ValueError(f"steps {steps} must be >= 2")
    step = step or engine.decode
    B = engine.layout.num_buckets
    count_bytes = contract["allocated_bytes_flat"] \
        and engine.device.type == "cuda"
    saved = engine.positions.copy(), engine.last_tokens.copy()
    ptrs = engine.cache.storage_ptrs()
    counters = lambda: {"all-gather": engine.mesh.collectives["all-gather"],
                        **engine.control}
    audit = _OpAudit(contract["dtype_ceiling"])
    try:
        with audit:
            before_counts = counters()
            step()
            if count_bytes:
                torch.cuda.synchronize(engine.device)
                before = torch.cuda.memory_allocated(engine.device)
            for _ in range(steps - 1):
                step()
            if count_bytes:
                torch.cuda.synchronize(engine.device)
                after = torch.cuda.memory_allocated(engine.device)
            counted = {k: v - before_counts[k] for k, v in counters().items()}
    finally:
        engine.positions, engine.last_tokens = saved
    budget = {k: (B if v == "B" else v) * steps
              for k, v in contract["collective_budget"].items()}
    kinds: dict = {}
    for op in audit.collectives:
        kinds[_KINDS.get(op, op)] = kinds.get(_KINDS.get(op, op), 0) + 1
    findings = []
    for kind in sorted(budget.keys() | kinds.keys()):
        got = kinds.get(kind, 0)
        if got != budget.get(kind, 0):
            findings.append(f"{got} {kind} collective(s) in {steps} decode "
                            f"steps; the budget is {budget.get(kind, 0)} "
                            f"(B={B})")
    for kind, want in budget.items():
        if counted.get(kind, 0) != want:
            findings.append(f"the engine counted {counted.get(kind, 0)} "
                            f"{kind} in {steps} decode steps, budget {want}")
    if contract["cache_storage_fixed"] \
            and engine.cache.storage_ptrs() != ptrs:
        findings.append(f"cache storage moved over {steps} decode steps: "
                        f"the step reallocates its cache")
    if count_bytes and after != before:
        findings.append(f"torch.cuda.memory_allocated went {before} -> "
                        f"{after} bytes over {steps - 1} decode steps")
    if audit.wide:
        findings.append(f"tensors wider than {contract['dtype_ceiling']} "
                        f"from {sorted(audit.wide)}")
    return findings
