"""Meshes of the PyTorch port: the production mesh as data, and a mesh
over the ranks of a running ``torch.distributed`` job (PyTorch port of
``repro.launch.mesh``).

``make_production_mesh`` returns a ``LogicalMesh``: the shape and axis
names of JAX's production mesh, ``(16, 16)`` ``("data", "model")`` (256
chips) or ``(2, 16, 16)`` with ``"pod"`` (512), standing for as many
H100s.  It holds no device and no process group: the dry run
(``launch.dryrun``) reads its sizes to state each leaf's bytes a rank.

``make_host_mesh`` lays the job's ranks out row-major on ``shape`` and
gives every axis its sub-groups (``dist.new_group``, one a line of the
axis, created by every rank in the same order).  A 1-D ``("data",)``
mesh is the ``distributed.mesh.DataMesh`` over the whole job; any other
mesh is a ``HostMesh``, whose ``line(axis)`` is this rank's line along
``axis`` as a ``DataMesh`` (its group, its members' global ranks, this
rank's position).  The groups take the job's backend, which
``distributed.mesh.init_data_mesh`` sets by the device: NCCL for CUDA,
gloo for the CPU, gloo on CUDA only where the caller names it (ranks
that share one card).  Nothing switches backend or device on failure.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import DataMesh


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A mesh's shape and axis names, with no devices behind it."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(eq=False)
class HostMesh:
    """An N-D mesh over the ranks of a ``torch.distributed`` job.
    ``coords`` is this rank's position on each axis; ``lines`` maps each
    axis name to this rank's line along it (a ``DataMesh``)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]
    lines: dict
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def line(self, axis: str) -> DataMesh:
        if axis not in self.lines:
            raise ValueError(f"no axis {axis!r} in mesh {self.axis_names}")
        return self.lines[axis]


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16x16 = 256 chips a pod ('data', 'model'); 2 pods add 'pod'."""
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def _default_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_host_mesh(shape=None, axes=("data",), *, device=None):
    """A mesh of ``shape`` (default: all ranks on one axis) with axis
    names ``axes`` over the running job, whose process group the caller
    has initialised (``distributed.mesh.init_data_mesh``).  ``device`` is
    this rank's (default: the current CUDA device under NCCL, the CPU
    under gloo; a gloo job on the card names it).  Every rank calls this
    with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (distributed.mesh.init_data_mesh)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} {axes} does not lay out "
                         f"{world} ranks")
    device = _default_device() if device is None else torch.device(device)
    if axes == ("data",):
        return DataMesh(dist.group.WORLD, tuple(range(world)), rank, device)
    ranks = torch.arange(world).reshape(shape)
    coords = tuple(int(c) for c in torch.nonzero(ranks == rank)[0])
    lines = {}
    for a, name in enumerate(axes):
        others = [range(n) for i, n in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(a, slice(None))
            members = tuple(int(r) for r in ranks[tuple(index)])
            group = dist.new_group(list(members))
            if rank in members:
                lines[name] = DataMesh(group, members, members.index(rank),
                                       device, name)
    return HostMesh(shape, axes, coords, lines, device)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, for a ``LogicalMesh``, a ``HostMesh`` or a
    ``DataMesh``."""
    if isinstance(mesh, DataMesh):
        return {mesh.axis: mesh.size}
    return dict(zip(mesh.axis_names, mesh.shape))
