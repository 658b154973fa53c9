"""Multi-process runtime entry: one process per rank, one card per rank.

Counterpart of ``metagraph_tpu/parallel/multihost.py``. The JAX package
joins its hosts into one JAX runtime (``jax.distributed.initialize``)
and runs ``shard_map`` steps over a global device mesh; here every rank
is a process of its own in one ``torch.distributed`` process group, and
``parallel/distributed.py`` runs its steps over a ``Mesh`` of that
group's ranks (collectives over NCCL between cards, over gloo on the
CPU). A single process skips ``initialize()``: its ``global_mesh()`` is
one rank without collectives.

Under ``torchrun --nproc-per-node N`` the arguments come from its
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); elsewhere pass them::

    initialize("10.0.0.1:29500", num_processes=4, process_id=rank)
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..common import device as devmod


@dataclass
class Mesh:
    """A 1-D mesh of ranks: ``group`` is their process group (None: one
    process without collectives), ``rank`` this process's rank in it (-1
    when it is not a member), ``device`` where its tensors live.
    ``routes`` records, per route name of ``distributed.exchange`` (and
    ``gather``), the calls, rows and bytes this rank received and the
    host seconds it spent in them (staging copies included; an NCCL
    transfer is counted until it is enqueued); ``shard_rows`` the rows
    each rank gave to the last gather (a build's edges or k-mers per
    rank)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    routes: dict = field(default_factory=dict)
    shard_rows: list = field(default_factory=list)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """gloo moves host tensors only: a rank on a card copies its send
        buffers to the host and what it receives back."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        if self.group is None:
            return "none (one process)"
        if self.staged:
            return "gloo, staged through host memory"
        return self.backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = 60.0) -> bool:
    """Join the process group. Arguments default to torchrun's
    environment; returns False (and does nothing) when neither names a
    multi-process run. The backend defaults to NCCL for a CUDA device
    and gloo for the CPU; ``backend="gloo"`` with a CUDA device lets
    several ranks share one card (NCCL refuses two ranks on a device).
    An NCCL rank takes card ``LOCAL_RANK`` (else ``process_id`` modulo
    the cards). A rendezvous or collective that waits longer than
    ``timeout_s`` fails instead of hanging."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if not coordinator_address and num_processes is None:
        return False
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id")
    dev = devmod.resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the process group (one rank
    without collectives when the group was never joined)."""
    dev = devmod.resolve(device)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
