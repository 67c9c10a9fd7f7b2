"""GPipe pipeline parallelism over a ``"pipe"`` mesh axis of
``torch.distributed`` ranks: PyTorch port of
``repro.distributed.pipeline``.

The layers are split into S stages (``split_stages``: stage s owns the
contiguous block of L/S layers of every stacked leaf), one a rank of the
axis; M microbatches stream through them.  ``gpipe_apply`` keeps JAX's
schedule: M + S - 1 steps; stage 0 takes microbatch t while t < M; the
last stage's output at step t is microbatch t - (S - 1); a ring hop
(rank i to i + 1 mod S) after every step; at the end the last stage's
outputs reach every rank.  The fill / drain bubble is (S - 1) / (M + S -
1) of the steps (``bubble_fraction``).  JAX's SPMD body runs every stage
at every step, on zeros where it holds no microbatch, and nothing reads
those results; here a stage runs only at the M steps where it holds one
(stage s holds microbatch t - s at step t) and sends zeros otherwise, so
the output and the gradients are JAX's, and a stage runs ``stage_fn`` M
times.

Gradients.  JAX differentiates through ``scan`` + ``ppermute`` (whose
transpose is the inverse permutation).  Here the hop is a
``torch.autograd.Function`` whose backward sends the cotangent of what a
rank received back to its sender and receives the cotangent of what it
sent, and the closing broadcast is one whose backward hands the last
stage its own cotangent: every rank computes the same loss from the
replicated outputs, so that cotangent is the gradient (a sum over the
ranks would count it S times).  The microbatches' own gradient reaches
the first stage's rank only.

Order of the collectives.  A hop takes and returns a 0-d chain token
that records gradients, and the broadcast takes the last one, so every
rank's graph holds every hop whether or not its own result is read (the
first stage never reads what it receives), and hop t's backward cannot
run before hop t + 1's: autograd then runs the hops of every rank in the
one order M + S - 2, ..., 0, each an exchange in which every rank of the
axis takes part.  The broadcast's backward issues no collective.

Backends.  Under NCCL a hop is one ``batch_isend_irecv`` on the device
tensors.  Gloo offers send / recv only on CPU tensors: on a CPU device
the hop is the same call; on CUDA (ranks that share one card run gloo:
NCCL refuses two ranks on one device) the hop copies the tensor to the
host explicitly, exchanges it there and copies what it received back to
the device.  The broadcast is ``dist.broadcast`` on the device tensor
under both (gloo offers it on CUDA tensors).  Nothing falls back to
another backend or device.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import DataMesh


def pipe_line(mesh, axis: str = "pipe") -> DataMesh:
    """This rank's line along ``axis``: the mesh itself for a 1-D
    ``DataMesh`` on that axis, else ``mesh.line(axis)``."""
    if isinstance(mesh, DataMesh):
        if mesh.axis != axis:
            raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
        return mesh
    return mesh.line(axis)


def ring_shift(line: DataMesh, t: torch.Tensor, shift: int = 1):
    """Rank at position i sends ``t`` to position i + ``shift`` (mod S)
    and returns what position i - ``shift`` sent (JAX's ``ppermute``
    with that ring permutation)."""
    t = t.detach().contiguous()
    s = line.size
    if s == 1:
        return t.clone()
    dst = line.ranks[(line.rank + shift) % s]
    src = line.ranks[(line.rank - shift) % s]
    staged = t.is_cuda and line.backend == "gloo"
    send = t.cpu() if staged else t
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, line.group),
        dist.P2POp(dist.irecv, recv, src, line.group)])
    for r in reqs:
        r.wait()
    return recv.to(t.device) if staged else recv


class _Hop(torch.autograd.Function):
    """The ring hop: (y, token) -> (what the previous stage sent, token);
    backward sends the cotangent the other way round."""

    @staticmethod
    def forward(ctx, y, token, line):
        ctx.line = line
        return ring_shift(line, y, 1), torch.zeros_like(token)

    @staticmethod
    def backward(ctx, g_buf, g_token):
        g_y = ring_shift(ctx.line, g_buf, -1)
        return (g_y if ctx.needs_input_grad[0] else None), g_token, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs to every rank of the axis; backward gives
    the last stage its own cotangent (see the module's docstring)."""

    @staticmethod
    def forward(ctx, outputs, token, line):
        ctx.last = line.rank == line.size - 1
        out = outputs.detach().clone()
        if line.size > 1:
            dist.broadcast(out, src=line.ranks[-1], group=line.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), torch.zeros(
            (), dtype=g.dtype, device=g.device), None


def gpipe_apply(stage_params, x_microbatches: torch.Tensor,
                stage_fn: Callable, *, mesh, axis: str = "pipe"):
    """Run (M, mb, ...) microbatches through the S stages of ``axis``.

    stage_params: this rank's stage (the leaves of ``split_stages(...)``
        at this rank's position on ``axis``: leading dim = its layers).
    x_microbatches: (M, mb, ...) inputs, the same on every rank (only the
        first stage reads them).
    stage_fn(stage_params, x) -> y: applies ONE stage's layers; y has
        x's shape and dtype.
    mesh: a ``DataMesh`` on ``axis`` or a ``launch.mesh.HostMesh``.

    Returns the (M, mb, ...) outputs on every rank of the axis.  Every
    rank of the axis calls this together (and, to train, runs backward
    from the same loss of the outputs).
    """
    line = pipe_line(mesh, axis)
    s, idx = line.size, line.rank
    m = x_microbatches.shape[0]
    token = torch.zeros((), device=x_microbatches.device,
                        requires_grad=torch.is_grad_enabled())
    buf = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(m + s - 1):
        if 0 <= t - idx < m:   # this stage holds microbatch t - idx
            y = stage_fn(stage_params, x_microbatches[t] if idx == 0
                         else buf)
            if idx == s - 1:
                outs.append(y)
        else:                   # fill / drain: nothing reads it
            y = torch.zeros_like(buf)
        buf, token = _Hop.apply(y, token, line)
    outputs = torch.stack(outs) if idx == s - 1 \
        else torch.zeros_like(x_microbatches)
    return _Broadcast.apply(outputs, token, line)


def split_stages(layer_params, num_stages: int):
    """Reshape every stacked (L, ...) leaf into (S, L/S, ...): stage s
    owns layers s L/S ... (s + 1) L/S - 1 (views, no copy)."""
    if isinstance(layer_params, dict):
        return {k: split_stages(v, num_stages)
                for k, v in layer_params.items()}
    n = layer_params.shape[0]
    if n % num_stages:
        raise ValueError(f"{n} layers do not split into {num_stages} "
                         "stages")
    return layer_params.reshape(num_stages, n // num_stages,
                                *layer_params.shape[1:])


def stage_params(staged, index: int):
    """Stage ``index`` of ``split_stages``' tree: leading dim = its
    layers."""
    if isinstance(staged, dict):
        return {k: stage_params(v, index) for k, v in staged.items()}
    return staged[index]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe fill/drain overhead: (S-1) / (M+S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
