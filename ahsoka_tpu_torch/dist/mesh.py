"""Device mesh, process group and collectives of the port.

Counterpart of ``ahsoka_tpu/dist/mesh.py``.  The graph, bubble index and
allele-path tables are small and every process holds them whole; the
alignments of a chain are the data-parallel axis (projection, scoring row
blocks) and the chains of a DP group the chain-parallel axis.

A process passes its own device list (``devices``: torch devices, which
may repeat, e.g. ``["cpu"] * 8`` for a CPU run of an 8-device layout);
on CUDA it defaults to every visible card in one process and to the
rank's own card (``own_card``) in a group of more than one.  Every process of a group passes the same number of devices, so the
global device list is ``len(devices) * world_size`` entries, rank by
rank.  A ``Mesh`` is the first ``data * chain`` of them as a grid of
shards; a process computes its ``local_shards()`` and the collectives
below merge the results on every process:

- ``min_merge``: ``torch.minimum`` over the local parts, then
  ``all_reduce(MIN)`` whenever a process group is initialized;
- ``gather_rows``: the local parts concatenated, then ``all_gather``
  (uneven row counts allowed), in global shard order;
- ``barrier``.

``initialize_distributed`` starts the process group over TCP: NCCL for
the mesh layout on CUDA, gloo for the mesh layout on the CPU and for the
chain layout (``--process-sharding chains``), which moves no tensor and
meets only at barriers, so several of its ranks may share one card.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ahsoka_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DATA_AXIS = "data"
CHAIN_AXIS = "chain"


def group_backend(device, chains: bool) -> str:
    """The process-group backend of a layout: gloo for the chain layout
    and for CPU devices, NCCL for the mesh layout on CUDA."""
    return "gloo" if chains or torch.device(device).type == "cpu" \
        else "nccl"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` from the arguments or the
    ``AHSOKA_COORDINATOR`` (host:port), ``AHSOKA_NUM_PROCESSES`` and
    ``AHSOKA_PROCESS_ID`` environment variables; a no-op at one
    process."""
    if num_processes is None:
        num_processes = int(os.environ.get("AHSOKA_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    address = coordinator or os.environ.get("AHSOKA_COORDINATOR",
                                            "localhost:12345")
    rank = (process_id if process_id is not None
            else int(os.environ.get("AHSOKA_PROCESS_ID", "0")))
    dist.init_process_group(backend=backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=rank)
    if backend == "nccl":
        # NCCL takes one card a rank and issues on the current device
        torch.cuda.set_device(own_card("cuda"))


def world() -> Tuple[int, int]:
    """(world size, rank) of the initialized process group; (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def own_card(device) -> torch.device:
    """``device``, where a bare ``cuda`` in a process group of more than
    one rank names this rank's own card: rank modulo the visible cards."""
    dev = torch.device(device)
    nproc, rank = world()
    if dev.type == "cuda" and dev.index is None and nproc > 1:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def local_devices(devices, device) -> List[torch.device]:
    """This process's device list: ``devices`` when given, else for a
    CUDA ``device`` every visible card, or in a process group of more
    than one rank this rank's own card (``own_card``), and ``device``
    alone for the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if world()[0] > 1:
        return [own_card(dev)]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One cell of the mesh: its global index (data-major), the rank that
    owns it, and its device on that rank (None on other ranks)."""
    index: int
    rank: int
    device: Optional[torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    chain: int
    shards: Tuple[Shard, ...]
    rank: int
    home: torch.device          # where merged results land on this rank

    @property
    def size(self) -> int:
        return self.data * self.chain

    def local_shards(self) -> List[Shard]:
        return [s for s in self.shards if s.rank == self.rank]


def make_mesh(data: int, chain: int = 1, devices: Sequence = ("cpu",),
              home=None) -> Mesh:
    """A ``data x chain`` mesh over the first ``data * chain`` entries of
    the global device list built from every rank's ``devices``."""
    devices = [torch.device(d) for d in devices]
    nproc, rank = world()
    n = len(devices) * nproc
    if data < 1 or chain < 1 or data * chain > n:
        raise ValueError(f"mesh {data}x{chain} needs more than the {n} "
                         "global devices")
    shards = tuple(
        Shard(i, i // len(devices),
              devices[i % len(devices)] if i // len(devices) == rank
              else None)
        for i in range(data * chain))
    return Mesh(data, chain, shards, rank,
                torch.device(home) if home is not None else devices[0])


@functools.lru_cache(maxsize=None)
def _log_fallback(what: str, shards: int, reason: str) -> None:
    log.info("%s: %d shards asked for, %s; running unsharded", what,
             shards, reason)


def gated_mesh(shards: int, axis: str, devices, home, what: str,
               reason: Optional[str] = None) -> Optional[Mesh]:
    """The JAX package's device-count gate: a one-axis mesh of ``shards``
    when the global device list holds that many and nothing else
    (``reason``) rules it out, else None, and the fallback is logged at
    info level (once per stage, shard count and reason)."""
    shards = max(int(shards), 1)
    if shards <= 1:
        return None
    n = len(devices) * world()[0]
    if reason is None and n < shards:
        reason = f"only {n} device(s)"
    if reason is not None:
        _log_fallback(what, shards, reason)
        return None
    if axis == DATA_AXIS:
        return make_mesh(data=shards, chain=1, devices=devices, home=home)
    return make_mesh(data=1, chain=shards, devices=devices, home=home)


def min_merge(parts: Sequence[torch.Tensor],
              identity: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of ``identity`` (the merge's neutral value, on
    the home device) and this rank's ``parts``, then over every rank."""
    out = identity.clone()
    for p in parts:
        out = torch.minimum(out, p.to(out.device))
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(out, op=dist.ReduceOp.MIN)
    return out


def gather_rows(parts: Sequence[torch.Tensor],
                empty: torch.Tensor) -> torch.Tensor:
    """Rows of every shard in global shard order: this rank's ``parts``
    concatenated (onto ``empty``, a [0, ...] tensor on the home device),
    then gathered over every rank."""
    local = torch.cat([empty] + [p.to(empty.device) for p in parts])
    if not (dist.is_available() and dist.is_initialized()):
        return local
    nproc = dist.get_world_size()
    sizes = torch.tensor([local.shape[0]], dtype=torch.int64,
                         device=empty.device)
    all_sizes = [torch.zeros_like(sizes) for _ in range(nproc)]
    dist.all_gather(all_sizes, sizes)
    counts = [int(s.item()) for s in all_sizes]
    top = max(counts)
    if top == 0:
        return local
    padded = torch.zeros((top,) + tuple(local.shape[1:]), dtype=local.dtype,
                         device=local.device)
    padded[:local.shape[0]] = local
    bufs = [torch.empty_like(padded) for _ in range(nproc)]
    dist.all_gather(bufs, padded)
    return torch.cat([b[:c] for b, c in zip(bufs, counts)])


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
