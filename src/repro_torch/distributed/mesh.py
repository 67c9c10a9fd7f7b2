"""The data-parallel mesh of the PyTorch port: a ``torch.distributed``
process group where the JAX package has a 1-D ``Mesh(devices,
("data",))`` (``repro.launch.mesh``, ``repro.runtime.elastic``).

Each rank is one process that holds a full replica of the parameters
and optimizer state on its own device and runs its own shard of every
global batch; the mesh carries the group, the rank's position in it
(``rank``, what ``jax.lax.axis_index("data")`` gives inside
``shard_map``), the number of positions (``size``), the rank's
``device`` and the axis name.

The backend follows the device: ``cuda`` -> NCCL, ``cpu`` -> gloo.
``backend=`` is honoured only where the caller names it (two ranks that
share one card need gloo: NCCL refuses two ranks on a device), and
nothing switches backend or device when one fails.  Rendezvous is a
``file://`` path (a ``FileStore``), so that concurrent jobs on one host
never race for a TCP port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(eq=False)
class DataMesh:
    """A 1-D data-parallel mesh over ranks of a ``torch.distributed``
    job.  ``ranks`` are the global ranks at each position, in order;
    ``rank`` is this process's position."""

    group: Any
    ranks: tuple[int, ...]
    rank: int
    device: torch.device
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """In-place all-reduce of ``tensor`` over the mesh (``op``:
        ``sum`` or ``max``); returns it."""
        dist.all_reduce(tensor, op={"sum": dist.ReduceOp.SUM,
                                    "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """In place: every rank receives position 0's ``tensor``."""
        dist.broadcast(tensor, src=self.ranks[0], group=self.group)
        return tensor

    def barrier(self) -> None:
        """Return once every rank of the mesh has reached this call (an
        all-reduce read back to the host: the same on both backends)."""
        self.all_reduce(torch.zeros(1, device=self.device)).item()

    def surviving(self, failed_index: int) -> "DataMesh | None":
        """The mesh over the survivors after losing position
        ``failed_index``, as ``repro.runtime.elastic.surviving_mesh``:
        the order is kept and positions renumber, so that a second drop
        names a position of the new mesh.  Every rank of this mesh calls
        it; the dropped rank gets ``None``."""
        if not 0 <= failed_index < self.size:
            raise ValueError(f"failed_index {failed_index} out of range "
                             f"for {self.size}-device mesh")
        survivors = tuple(r for i, r in enumerate(self.ranks)
                          if i != failed_index)
        if not survivors:
            raise ValueError("no surviving devices")
        # only the members synchronise: ranks dropped earlier have left
        group = dist.new_group(list(survivors),
                               use_local_synchronization=True)
        if self.rank == failed_index:
            return None
        return DataMesh(group, survivors,
                        survivors.index(self.ranks[self.rank]), self.device,
                        self.axis)


def init_data_mesh(device, *, rank: int, world_size: int, init_method: str,
                   backend: str | None = None) -> DataMesh:
    """Join a ``world_size``-rank job as ``rank`` (``init_method`` a
    ``file://`` path shared by the ranks) and return the mesh over all of
    them.  ``device`` is this rank's (``cuda:r`` or ``cpu``); the backend
    is NCCL for a CUDA device and gloo for the CPU unless ``backend``
    names another."""
    device = torch.device(device)
    if backend is None:
        if device.type not in _BACKENDS:
            raise ValueError(f"no default backend for device {device}")
        backend = _BACKENDS[device.type]
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_data_mesh(device={str(device)!r}) "
                               "needs CUDA, which is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return DataMesh(dist.group.WORLD, tuple(range(world_size)), rank, device)
