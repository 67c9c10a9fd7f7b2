"""Collectives of the data-parallel steps, PyTorch port of
``repro.distributed.collectives`` (paper C8).

``bucketed_all_reduce``: all-reduce the gradient leaves in buckets of
about ``bucket_bytes``, by the JAX package's greedy rule in leaf order
(``bucket_plan``), one flat ``all_reduce`` a bucket, unflattened into the
leaves in place.  ``compressed_all_reduce``: cast to bf16, all-reduce in
bf16 (as ``psum`` does on bf16 operands: each partial sum rounds to
bf16) and cast back (half the bytes on the wire).  ``mean_metrics`` is
``pmean_metrics``; ``stack_over_ranks`` gives the serve step's outputs a
leading device axis, as ``shard_map``'s ``out_specs=P("data")`` does.

Everything here is built on ``all_reduce`` (and the mesh's
``broadcast``): gloo offers only those two on CUDA tensors, and two
ranks that share one card run gloo.
"""
from __future__ import annotations

import torch

from repro_torch.optim.tree import leaves

from .mesh import DataMesh

GRAD_REDUCE = ("plain", "bucketed", "compressed")


def bucket_plan(tree, bucket_bytes: int = 4 << 20) -> list[list[int]]:
    """Leaf positions of each bucket: leaves in order, a bucket closed
    when the next leaf would take it past ``bucket_bytes`` (a leaf larger
    than that gets a bucket of its own)."""
    buckets: list[list[int]] = []
    size = 0
    for i, leaf in enumerate(leaves(tree)):
        nbytes = leaf.numel() * leaf.element_size()
        if buckets and size + nbytes <= bucket_bytes:
            buckets[-1].append(i)
            size += nbytes
        else:
            buckets.append([i])
            size = nbytes
    return buckets


@torch.no_grad()
def bucketed_all_reduce(tree, mesh: DataMesh,
                        bucket_bytes: int = 4 << 20) -> list:
    """Sum the leaves of ``tree`` over the mesh, in place, one flat
    all-reduce per bucket of ``bucket_plan`` (per dtype within a bucket,
    should its leaves differ).  Returns the leaves."""
    flat = leaves(tree)
    for bucket in bucket_plan(flat, bucket_bytes):
        for dtype in dict.fromkeys(flat[i].dtype for i in bucket):
            members = [flat[i] for i in bucket if flat[i].dtype == dtype]
            buf = mesh.all_reduce(torch.cat([x.reshape(-1)
                                             for x in members]))
            for x, part in zip(members, buf.split([x.numel()
                                                   for x in members])):
                x.copy_(part.view_as(x))
    return flat


@torch.no_grad()
def compressed_all_reduce(tree, mesh: DataMesh,
                          dtype: torch.dtype = torch.float32) -> list:
    """bf16-compressed all-reduce: the leaves rounded to bf16, summed in
    bf16 in one flat all-reduce, returned as new leaves in ``dtype``."""
    flat = leaves(tree)
    buf = mesh.all_reduce(torch.cat([x.reshape(-1).to(torch.bfloat16)
                                     for x in flat]))
    return [part.view_as(x).to(dtype)
            for x, part in zip(flat, buf.split([x.numel() for x in flat]))]


@torch.no_grad()
def all_reduce_grads(grads, mesh: DataMesh, how: str) -> list:
    """The gradient all-reduce of ``TrainConfig.grad_reduce``: ``plain``
    (one all-reduce a leaf), ``bucketed`` or ``compressed``.  A sum, not
    a mean: the callers divide where the JAX package does."""
    if how == "plain":
        return [mesh.all_reduce(g) for g in leaves(grads)]
    if how == "bucketed":
        return bucketed_all_reduce(grads, mesh)
    if how == "compressed":
        return compressed_all_reduce(grads, mesh)
    raise ValueError(f"grad_reduce {how!r} is none of {GRAD_REDUCE}")


@torch.no_grad()
def sum_scalars(values: dict, mesh: DataMesh) -> dict:
    """Each 0-d value of ``values`` summed over the mesh, all in one
    all-reduce of an f32 vector on the mesh's device."""
    buf = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                       .to(mesh.device) for v in values.values()])
    return dict(zip(values, mesh.all_reduce(buf).unbind()))


def mean_metrics(metrics: dict, mesh: DataMesh) -> dict:
    """``pmean`` of scalar metrics: the sum over the mesh over its size."""
    return {k: v / mesh.size for k, v in sum_scalars(metrics, mesh).items()}


@torch.no_grad()
def stack_over_ranks(outputs: dict, mesh: DataMesh) -> dict:
    """Each output with a leading device axis of the mesh's size, every
    rank's slot filled: each rank writes its own slot of a zero tensor
    and the mesh sums them (x + 0 is exact)."""
    out = {}
    for k, x in outputs.items():
        buf = torch.zeros((mesh.size, *x.shape), dtype=x.dtype,
                          device=x.device)
        buf[mesh.rank] = x
        out[k] = mesh.all_reduce(buf)
    return out
