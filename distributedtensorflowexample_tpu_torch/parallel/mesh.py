"""The data-parallel mesh (the port's counterpart of the JAX package's
``parallel/mesh.py``): one rank per process, each on its own device,
joined by the default ``torch.distributed`` process group.

Where the JAX mesh lets XLA insert the psum, the port calls the three
collectives it needs by hand, on the rank's device:

* :meth:`Mesh.all_reduce` sums the flat gradient buffer (one call per
  step, counted in ``all_reduces``);
* :meth:`Mesh.broadcast` sends rank 0's flat parameters to every rank;
* :meth:`Mesh.all_gather_int` gathers one integer per rank (the config
  digest).

Metrics and the eval's correct count are summed with the same
collective, once per host read (:meth:`Mesh.sum_metrics`), uncounted.
A run with no process group is one rank (:data:`ONE_RANK`, or an
ungrouped ``Mesh(device)``), whose collectives are the identity.

Placement: rank ``r`` runs on ``cuda:<r % device_count>``.  Under NCCL
that must be a card of its own: a group with more ranks than visible
cards is refused by name before NCCL fails on it.  A ``gloo`` group may
put several ranks on one card (it reduces CUDA tensors through host
memory), which is how two ranks run on a one-card machine; ``num_chips``
then counts that card once.
"""

from __future__ import annotations

import socket
import zlib

import torch
import torch.distributed as dist

from distributedtensorflowexample_tpu_torch.device import resolve_device
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal


class Mesh:
    """This rank's place in the data-parallel group: ``rank``, ``size``
    (the world size), ``device``, whether a process group backs it
    (``grouped``; a one-rank group still runs its collectives), and the
    number of distinct devices its ranks run on (``num_chips``; set by
    :func:`make_mesh`)."""

    def __init__(self, device: torch.device, rank: int = 0, size: int = 1,
                 grouped: bool = False):
        self.device = device
        self.rank = rank
        self.size = size
        self.grouped = grouped
        self.num_chips = size
        self.all_reduces = 0

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def all_reduce(self, flat: torch.Tensor,
                   counted: bool = True) -> torch.Tensor:
        """Sum ``flat`` over the ranks, in place.  The gradient all-reduce
        (the counterpart of the JAX step's psum) is counted in
        ``all_reduces``; the metrics' and the eval's sums pass
        ``counted=False``."""
        if self.grouped:
            dist.all_reduce(flat)
            self.all_reduces += counted
        return flat

    def broadcast(self, flat: torch.Tensor) -> torch.Tensor:
        """Overwrite ``flat`` with rank 0's, in place."""
        if self.grouped:
            dist.broadcast(flat, 0)
        return flat

    def all_gather_int(self, value: int) -> list[int]:
        """Every rank's ``value``, in rank order."""
        if not self.grouped:
            return [int(value)]
        mine = torch.tensor([int(value)], dtype=torch.int64,
                            device=self.device)
        out = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(out, mine)
        return [int(t.item()) for t in out]

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


# The mesh of a run with no process group: one rank, whose collectives
# are the identity (the gather and the step never read its device).
ONE_RANK = Mesh(torch.device("cpu"))


def local_world_size(num_devices: int, device: str) -> int:
    """The ranks ``--num_devices`` starts on this host: on ``cuda`` one
    per card, 0 = every visible card, and asking for more cards than are
    visible raises the JAX package's ``ValueError``; on ``cpu`` 0 or 1 is
    one rank and ``N`` is N gloo ranks."""
    if device != "cuda":
        return max(1, num_devices)
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(
            f"requested {num_devices} devices, only {visible} visible")
    return num_devices if num_devices > 0 else max(1, visible)


def card_of(rank: int, world: int, backend: str) -> int:
    """The card index of ``rank`` in a ``world``-rank group.  Under NCCL a
    group larger than the visible cards would put rank ``r`` and rank
    ``r + visible`` on one card, which NCCL cannot run: refused by name."""
    visible = torch.cuda.device_count()
    if backend == "nccl" and world > visible:
        raise ModeRefusal(
            f"an NCCL group of {world} ranks on {visible} visible card(s) "
            f"would place ranks 0 and {visible} on one card (cuda:0), and "
            f"NCCL runs one rank per card; start at most {visible} NCCL "
            f"ranks, or join several ranks on one card with a gloo group")
    return rank % max(1, visible)


def make_mesh(device: str) -> Mesh:
    """The mesh over the default process group, or a one-rank mesh when
    there is none; sets this rank's card as the current CUDA device.  On
    ``cuda`` the ranks all-gather which card of which host they run on,
    so ``num_chips`` counts a card that several gloo ranks share once."""
    if not dist.is_initialized():
        return Mesh(resolve_device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    local = 0
    if device == "cuda":
        local = card_of(rank, world, dist.get_backend())
    mesh = Mesh(resolve_device(device, local), rank=rank, size=world,
                grouped=True)
    if device == "cuda":
        card = zlib.crc32(f"{socket.gethostname()}/cuda:{local}".encode())
        mesh.num_chips = len(set(mesh.all_gather_int(card)))
    return mesh
