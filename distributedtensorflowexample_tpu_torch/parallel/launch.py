"""Start ranks on this host, one process each, joined by one process
group: the engine's ``--num_devices N`` (``engine/engine.py``), its
N-process x M-local-rank layout under the cluster flags, and the harness
of the multi-rank checks (``chip_smoke.py``, the tests).

:func:`spawn` runs ``fn(*args)`` in fresh interpreters through
``torch.multiprocessing.spawn`` (the ``spawn`` start method: a parent
holding CUDA or OpenMP threads must not fork; a rank that fails gets the
other ranks terminated), one per local rank.  Each child takes an equal
part of the caller's intra-op threads, joins the group, runs ``fn`` and
puts its result on a queue.  By default the call starts the whole group,
``world`` ranks numbered from 0, over a file store in a temporary
directory (no TCP port to collide with another run).  Given ``local``,
``offset`` and ``init_method``, it starts only ``local`` ranks, numbered
``offset .. offset + local - 1``, into a group of ``world`` ranks that
other callers (processes, hosts) fill: the N x M layout, where process p
starts global ranks ``p*M .. p*M + M - 1`` and every rank joins over
``tcp://<coordinator_address>``, the store that global rank 0 hosts.
The caller itself joins no group.  A rank that raises puts its exception
there too, and the caller gets the first one raised, with the rank's
traceback attached.  ``fn`` and its arguments are pickled, so ``fn`` is a
module-level function.

Preemption: a SIGTERM to the caller (on its main thread) is forwarded to
every rank.  A rank whose ``fn`` raises ``SystemExit(143)`` (the engine's
exit after its preemption save) reports itself preempted and exits
cleanly, and the caller then raises ``SystemExit(143)`` too, rather than
a rank failure.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from distributedtensorflowexample_tpu_torch.utils.signals import (
    installed_signal_handler)

#: The exit code of a preempted run (128 + SIGTERM).
PREEMPTED = 143


def _rank_main(local: int, offset: int, world: int, backend: str,
               init_method: str, threads: int, fn, args, queue) -> None:
    torch.set_num_threads(threads)
    rank = offset + local
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        queue.put((rank, True, fn(*args)))
    except Exception as exc:
        # Re-raised in the caller, with this rank's traceback.
        queue.put((rank, False, (exc, traceback.format_exc())))
        raise
    except SystemExit as exc:
        if exc.code != PREEMPTED:
            raise
        # Saved and stopped: reported, and a clean exit, so that the
        # caller's join does not take it for a failed rank and kill the
        # others while they finish their own exit.
        queue.put((rank, None, PREEMPTED))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, args: tuple = (),
          timeout_s: float | None = None, *, local: int | None = None,
          offset: int = 0, init_method: str | None = None) -> list:
    """``[fn(*args) on rank offset, ..., on rank offset+local-1]``, each
    computed in its own process inside a ``backend`` group of ``world``
    ranks.  ``local`` defaults to ``world`` (the whole group, over a file
    store of its own); with ``init_method`` the ranks join that
    rendezvous instead."""
    local = world if local is None else local
    if not 0 <= offset <= world - local:
        raise ValueError(f"ranks {offset}..{offset + local - 1} do not fit "
                         f"a group of {world}")
    queue = mp.get_context("spawn").SimpleQueue()
    # The ranks share this host's cores: an equal part of the caller's
    # intra-op threads each (idle OpenMP threads spin on the others).
    threads = max(1, torch.get_num_threads() // local)
    results, errors, preempted = {}, [], []
    procs: list = []
    terminated = []

    def drain() -> None:
        # Read while the ranks run: a rank blocks on a result larger than
        # the pipe's buffer until it is read.
        while not queue.empty():
            rank, ok, out = queue.get()
            if ok:
                results[rank - offset] = out
            elif ok is None:
                preempted.append(rank)
            else:
                errors.append((rank, out))

    def forward(signum, frame) -> None:
        terminated.append(signum)
        for p in procs:
            if p.is_alive():
                p.terminate()

    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp, \
            installed_signal_handler(signal.SIGTERM, forward):
        store = init_method or "file://" + os.path.join(tmp, "store")
        ranks = mp.spawn(_rank_main, nprocs=local, join=False, args=(
            offset, world, backend, store, threads, fn, args, queue))
        procs.extend(ranks.processes)
        if terminated:              # the signal came while they started
            forward(signal.SIGTERM, None)
        try:
            while not ranks.join(timeout=1):
                drain()
                if deadline is not None and time.monotonic() > deadline:
                    for p in ranks.processes:
                        p.kill()
                        p.join()
                    raise TimeoutError(f"{local} ranks sent no result "
                                       f"within {timeout_s} s")
        except ProcessException as failed:
            drain()
            if terminated and not errors:
                # A rank the forwarded signal ended before its handler
                # was in place: preempted all the same.
                raise SystemExit(PREEMPTED) from None
            if not errors:          # a crash or a signal: nothing was sent
                raise
            # The first exception raised is the cause; the other ranks'
            # follow from it (a peer leaving a collective).
            rank, (exc, tb) = errors[0]
            exc.add_note(f"raised on rank {rank}:\n{tb}")
            raise exc from None
        drain()
    if preempted:
        raise SystemExit(PREEMPTED)
    return [results[r] for r in range(local)]
