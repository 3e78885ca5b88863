"""The data-parallel mesh (the port's counterpart of the JAX package's
``parallel/mesh.py``): one rank per process, each on its own device,
joined by the default ``torch.distributed`` process group.

``--num_devices`` is the size of the GLOBAL mesh, as in JAX: under the
cluster flags N processes each start M = ``--num_devices / N`` ranks
(:func:`ranks_per_process`), and process p's ranks are the global ranks
``p*M .. p*M + M - 1``, the JAX mesh's process-grouped device order.

Where the JAX mesh lets XLA insert the psum, the port calls the
collectives it needs by hand, on the rank's device:

* :meth:`Mesh.all_reduce` sums a flat buffer in place (the gradient once
  a step, or once per bucket under ``--bucket_grads``);
* :meth:`Mesh.reduce_scatter` sums a flat ``[D*W]`` buffer and hands
  rank d its row ``[d*W, (d+1)*W)``, and :meth:`Mesh.all_gather_into`
  concatenates every rank's ``[W]`` row (the ZeRO modes,
  ``parallel/bucketing.py`` and ``parallel/zero3.py``); with
  ``async_op=True`` the gather returns a handle whose ``wait()`` gives
  the result;
* :meth:`Mesh.broadcast` sends rank 0's flat parameters to every rank;
* :meth:`Mesh.all_gather` gathers one tensor per rank (the config
  digest through :meth:`Mesh.all_gather_int`, the dropout generators'
  states for a checkpoint).

``Mesh.collectives`` counts the gradient and parameter collectives by
kind (``all-reduce``, ``reduce-scatter``, ``all-gather``): the port's
counterpart of the JAX package's compiled-program contracts, held to
each mode's budget per step (``engine/spec.MODES``).  ``all_reduces``
is the first of them.  With ``Mesh.order`` set to a list, each counted
collective is also appended to it in issue order, as its kind, its
payload's dtype and the payload's bytes (the tensor the rank hands the
collective: the all-reduce's buffer, the reduce-scatter's whole input,
the all-gather's row); the collective contracts of
``analysis/collective_lint.py`` read the schedule there, and
``tools/bench_scaling.py`` the bytes.  Metrics, the
eval's correct count, checkpoints and the eval's parameter gathers pass
``counted=False``.  A run with no
process group is one rank (:data:`ONE_RANK`, or an ungrouped
``Mesh(device)``), whose collectives are the identity.

Both backends take the rank's device tensors for every collective: one
implementation.  NCCL runs them on the card; gloo (two ranks on one
card, and the CPU) copies CUDA tensors through host memory inside its
own ops (``reduce_scatter_tensor`` and ``all_gather_into_tensor`` take
CUDA tensors, synchronously and with ``async_op``: checked on torch
2.11 on an H100), so its times on a card are host-staged.

Placement: each rank runs on the card of its index among the ranks on
ITS OWN host (``host_names`` exchanges the hosts' names before the first
NCCL collective, which needs the card already set), so two one-card
hosts each put their rank on ``cuda:0``.  Under NCCL that must be a card
of its own: a host with more NCCL ranks than visible cards is refused by
name before NCCL fails on it.  A ``gloo`` group may put several ranks on
one card (it reduces CUDA tensors through host memory), which is how two
ranks run on a one-card machine; ``num_chips`` then counts that card
once.
"""

from __future__ import annotations

import socket
import zlib

import torch
import torch.distributed as dist

from distributedtensorflowexample_tpu_torch.device import (
    require_cuda, resolve_device)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal


class Mesh:
    """This rank's place in the data-parallel group: ``rank``, ``size``
    (the world size), ``device``, whether a process group backs it
    (``grouped``; a one-rank group still runs its collectives), and the
    number of distinct devices its ranks run on (``num_chips``; set by
    :func:`make_mesh`), and this rank's index among the ranks of its
    host (``host_rank``; on ``cuda`` set by :func:`make_mesh`)."""

    def __init__(self, device: torch.device, rank: int = 0, size: int = 1,
                 grouped: bool = False):
        self.device = device
        self.rank = rank
        self.size = size
        self.grouped = grouped
        self.num_chips = size
        self.host_rank = rank
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.order: list | None = None

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    @property
    def all_reduces(self) -> int:
        return self.collectives["all-reduce"]

    def _count(self, kind: str, counted: bool,
               payload: torch.Tensor) -> None:
        self.collectives[kind] += counted
        if counted and self.order is not None:
            self.order.append((kind, payload.dtype,
                               payload.numel() * payload.element_size()))

    def all_reduce(self, flat: torch.Tensor,
                   counted: bool = True) -> torch.Tensor:
        """Sum ``flat`` over the ranks, in place.  The gradient all-reduce
        (the counterpart of the JAX step's psum) is counted in
        ``all_reduces``; the metrics' and the eval's sums pass
        ``counted=False``."""
        if self.grouped:
            dist.all_reduce(flat)
            self._count("all-reduce", counted, flat)
        return flat

    def reduce_scatter(self, flat: torch.Tensor,
                       counted: bool = True) -> torch.Tensor:
        """This rank's row ``[W]`` of the sum over the ranks of ``flat``
        (``[D*W]``; the JAX ``psum_scatter``, tiled)."""
        if not self.grouped:
            return flat
        row = flat.new_empty(flat.numel() // self.size)
        dist.reduce_scatter_tensor(row, flat.contiguous())
        self._count("reduce-scatter", counted, flat)
        return row

    def all_gather_into(self, row: torch.Tensor, counted: bool = True,
                        async_op: bool = False):
        """Every rank's ``row`` (``[W]``), concatenated in rank order:
        ``[D*W]`` (the JAX ``all_gather``, tiled).  With ``async_op`` a
        handle whose ``wait()`` returns it once it has arrived."""
        if not self.grouped:
            full, work = row, None
        else:
            full = row.new_empty(row.numel() * self.size)
            work = dist.all_gather_into_tensor(full, row.contiguous(),
                                               async_op=async_op)
            self._count("all-gather", counted, row)
        return _Pending(full, work) if async_op else full

    def broadcast(self, flat: torch.Tensor) -> torch.Tensor:
        """Overwrite ``flat`` with rank 0's, in place."""
        if self.grouped:
            dist.broadcast(flat, 0)
        return flat

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape and dtype on every rank), in rank
        order, on the host.  The exchange runs on this rank's device,
        which NCCL needs."""
        if not self.grouped:
            return [t.cpu()]
        mine = t.to(self.device)
        out = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(out, mine)
        return [o.cpu() for o in out]

    def all_gather_int(self, value: int) -> list[int]:
        """Every rank's ``value``, in rank order."""
        return [int(t.item()) for t in self.all_gather(
            torch.tensor([int(value)], dtype=torch.int64))]

    def sum_metrics(self, metrics: dict) -> dict:
        """Each rank's share of the step metrics -> the global metrics, in
        one collective; the values stay on the device."""
        if not self.grouped or not metrics:
            return metrics
        names = list(metrics)
        stacked = self.all_reduce(torch.stack(
            [torch.as_tensor(metrics[k], device=self.device).float()
             for k in names]), counted=False)
        return dict(zip(names, stacked.unbind()))


#: The kinds ``Mesh.collectives`` counts, in the JAX package's names.
COLLECTIVE_KINDS = ("all-reduce", "reduce-scatter", "all-gather")


class _Pending:
    """An issued collective: ``wait()`` returns its output."""

    def __init__(self, out: torch.Tensor, work):
        self._out, self._work = out, work

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out


# The mesh of a run with no process group: one rank, whose collectives
# are the identity (the gather and the step never read its device).
ONE_RANK = Mesh(torch.device("cpu"))


def local_world_size(num_devices: int, device: str) -> int:
    """The ranks ``--num_devices`` starts on this host: on ``cuda`` one
    per card, 0 = every visible card, and asking for more cards than are
    visible raises the JAX package's ``ValueError`` (and a host with no
    card at all ``DeviceUnavailable``); on ``cpu`` 0 or 1 is one rank and
    ``N`` is N gloo ranks."""
    if device != "cuda":
        return max(1, num_devices)
    visible = torch.cuda.device_count()
    if not visible:
        require_cuda()
    if num_devices > visible:
        raise ValueError(
            f"requested {num_devices} devices, only {visible} visible")
    return num_devices if num_devices > 0 else max(1, visible)


def ranks_per_process(num_devices: int, num_processes: int,
                      device: str) -> int:
    """M, the ranks each of ``num_processes`` cluster processes starts
    when ``--num_devices`` is the global rank count N*M (the JAX meaning:
    ``make_mesh(num_devices)`` over every process's devices).  0 is every
    visible card on ``cuda`` and one rank on ``cpu``, as the JAX default
    device count; on ``cuda`` an M above the visible cards raises the JAX
    ``ValueError`` (:func:`local_world_size`).  A count that N does not
    divide is refused by name: the JAX package has no clean behaviour
    there (its ``make_mesh`` takes the first ``num_devices`` devices in
    process order, so some processes would own no device of the mesh and
    still be asked to feed a slice of the batch)."""
    if num_devices % num_processes:
        raise ModeRefusal(
            f"--num_devices {num_devices} across {num_processes} processes: "
            f"--num_devices is the global rank count N*M, and each process "
            f"starts the same number M of ranks; pass a multiple of "
            f"{num_processes} (or 0: every visible card on each process)")
    return local_world_size(num_devices // num_processes, device)


def host_names(backend: str) -> list[str]:
    """Every rank's host name, in rank order.  Over the default group when
    it is ``gloo``; under NCCL, whose collectives need each rank's card
    set first, over a ``gloo`` side group made for the exchange and
    destroyed after it."""
    names: list = [None] * dist.get_world_size()
    if backend == "gloo":
        dist.all_gather_object(names, socket.gethostname())
        return names
    side = dist.new_group(backend="gloo")
    try:
        dist.all_gather_object(names, socket.gethostname(), group=side)
    finally:
        dist.destroy_process_group(side)
    return names


def card_of(rank: int, hosts: list[str], backend: str) -> int:
    """The card index of ``rank``, given every rank's host name: its
    index among the ranks on its host, modulo the visible cards.  Under
    NCCL a host with more ranks than visible cards would put two of them
    on one card, which NCCL cannot run: refused by name."""
    visible = torch.cuda.device_count()
    host = hosts[rank]
    local = hosts[:rank].count(host)
    count = hosts.count(host)
    if backend == "nccl" and count > visible:
        raise ModeRefusal(
            f"{count} NCCL ranks on host {host!r} with {visible} visible "
            f"card(s) would place two ranks on one card, and NCCL runs one "
            f"rank per card; start at most {visible} NCCL ranks per host, "
            f"or join several ranks on one card with a gloo group")
    return local % max(1, visible)


def make_mesh(device: str) -> Mesh:
    """The mesh over the default process group, or a one-rank mesh when
    there is none; sets this rank's card as the current CUDA device.  On
    ``cuda`` the ranks all-gather which card of which host they run on,
    so ``num_chips`` counts a card that several gloo ranks share once."""
    if not dist.is_initialized():
        return Mesh(resolve_device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    local, host_rank = 0, rank
    if device == "cuda":
        backend = dist.get_backend()
        hosts = host_names(backend)
        local = card_of(rank, hosts, backend)
        host_rank = hosts[:rank].count(hosts[rank])
    mesh = Mesh(resolve_device(device, local), rank=rank, size=world,
                grouped=True)
    mesh.host_rank = host_rank
    if device == "cuda":
        card = zlib.crc32(f"{socket.gethostname()}/cuda:{local}".encode())
        mesh.num_chips = len(set(mesh.all_gather_int(card)))
    return mesh
