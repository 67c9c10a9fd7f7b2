"""Elastic data parallelism, PyTorch port of ``repro.runtime.elastic``.

Checkpoints are mesh-independent (full host trees), so resuming on
another device count is: restore the tree, place it on each rank's
device as a replica (``reshard``, checked against rank 0), and rescale
what depends on the device count (``per_device_batch``: the global
batch, and so the Eq. 14 LR, is kept; only each rank's share changes).

In-run elasticity (DESIGN.md §6): a device drop surfaces as
``fault.DeviceLossError`` on every rank at the same step (the port's
``DeviceDropInjector`` fires by step, so every rank's fires alike).
``elastic_train`` builds the survivors' process group
(``surviving_mesh``); the dropped rank returns and leaves, and the
survivors re-bin-pack the data through ``batches_fn(num_devices)`` and go
on at the same step with the same optimizer state, no checkpoint round
trip.  A process that really dies is not survived in the run: its peers
block in the next collective until the backend's timeout, and the job
restarts from the newest checkpoint on the devices that are left
(``elastic_restore``), the restart path of ``fault.run_with_restarts``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from repro_torch.distributed import DataMesh
from repro_torch.optim.tree import leaves, unflatten

from .checkpoint import restore_checkpoint
from .fault import DeviceLossError


@torch.no_grad()
def reshard(tree: Any, mesh: DataMesh) -> Any:
    """The tree's leaves on the rank's device, as the replica of data
    parallelism (every leaf replicated: the JAX package's ``spec_fn``
    gives ``P()`` for all of them under DP).  Raises unless every rank
    holds rank 0's values bit for bit (one broadcast of the flattened
    replica)."""
    flat = [x.to(mesh.device) for x in leaves(tree)]
    mine = torch.cat([x.reshape(-1).view(torch.uint8) for x in flat]) \
        if flat else torch.zeros(0, dtype=torch.uint8, device=mesh.device)
    if not torch.equal(mesh.broadcast(mine.clone()), mine):
        raise ValueError(f"the replica of rank {mesh.rank} differs from "
                         "rank 0's")
    return unflatten(tree, flat)


def elastic_restore(directory: str, template: Any, mesh: DataMesh, *,
                    step: int | None = None):
    """``restore_checkpoint`` + ``reshard`` in one call: ``(tree, step,
    meta)``, the tree this rank's checked replica."""
    tree, step, meta = restore_checkpoint(directory, template, step=step)
    return reshard(tree, mesh), step, meta


def per_device_batch(global_batch: int, num_devices: int) -> int:
    if global_batch % num_devices != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_devices} "
            "devices")
    return global_batch // num_devices


def surviving_mesh(mesh: DataMesh, failed_index: int) -> DataMesh | None:
    """The 1-D mesh over the survivors after losing position
    ``failed_index`` (``DataMesh.surviving``): order kept, positions
    renumbered, so that a second drop names a position of the new mesh;
    ``None`` on the dropped rank.  Every rank of ``mesh`` calls it."""
    return mesh.surviving(failed_index)


def elastic_train(
    trainer,
    batches_fn: Callable[[int], Iterable],
    *,
    max_steps: int,
    fault_injector=None,
    max_shrinks: int | None = None,
) -> list[dict]:
    """Train to ``max_steps``, shrinking the mesh on every device drop.

    ``batches_fn(num_devices)`` must build a fresh batch iterable of this
    rank's shards for that device count (``data.BalancedBatchIterator(...,
    num_devices, shard=trainer.mesh.rank)``): there the re-bin-packing over
    the survivors happens.  On :class:`fault.DeviceLossError` every rank
    builds the survivors' mesh; the trainer is re-targeted through
    ``Trainer.rebuild_mesh`` and resumes at the same step with the same
    optimizer state.  The dropped rank's trainer leaves the mesh
    (``trainer.mesh`` becomes ``None``) and it returns the history it has,
    its ``trainer.step`` short of ``max_steps``.
    """
    history: list[dict] = []
    shrinks = 0
    while trainer.step < max_steps:
        before = trainer.step
        try:
            history.extend(trainer.train(
                batches_fn(trainer.num_devices),
                max_steps=max_steps,
                fault_injector=fault_injector,
            ))
        except DeviceLossError as loss_err:
            history.extend(getattr(loss_err, "partial_history", []))
            shrinks += 1
            if max_shrinks is not None and shrinks > max_shrinks:
                raise
            if trainer.mesh is None:
                raise  # one device has nothing to shrink to
            mesh = surviving_mesh(trainer.mesh, loss_err.failed_index)
            trainer.rebuild_mesh(mesh)
            if mesh is None:
                return history  # this rank's device is the one lost
            continue
        if trainer.step == before:
            break  # the batches ran out without progress: the epoch ended
    return history
