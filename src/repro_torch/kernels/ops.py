"""Public wrappers of the hand-written CUDA kernels.

Each wrapper has the calling convention of its ``repro.kernels.ops``
counterpart and is a ``torch.autograd.Function``.  Its forward picks the
path from the device of the tensors it is given:

  - CPU tensors go to the plain PyTorch version in ``kernels.ref``;
  - CUDA tensors launch the kernel, after checking device, dtype (f32
    features, int32 ids), contiguity and shapes, or raise.  There is no
    fallback from the card to the plain version.

The convs and the force readout without the virial (kernels 2, 3 and 4a)
also take bf16 features (DESIGN.md §4, the mixed tiers): every float
operand of a call in one dtype, bf16 kernels in the same templates
(f32 sums, the result rounded to bf16 once), the output in the operand
dtype.  Their backwards widen the operands to f32, recompute in f32 and
cast each cotangent to its operand's dtype, as the JAX package's custom
VJPs do.  The other wrappers take f32 only.

The backward is the same code on both devices and mirrors the JAX
package's custom VJPs: it keeps the operands, never the messages, and
recomputes the messages (or the GatedMLP, or the basis) chunk by chunk of
rows in PyTorch, pulling the output cotangent back through each chunk
with ``torch.autograd.grad`` (``_recompute_vjp``); the segment sum's
backward is a gather.  No backward is a kernel: a hand-written backward
kernel is an optimization for later.  Every backward is built from torch
ops, so it is itself differentiable: the autodiff readout trains through
a double backward.

Two tiers use them: the fused convs and force readouts
(``conv_impl="fused"``, ``csrc/message_passing.cu``) and the unfused
tier's segment sum, GatedMLP and bases (``agg_impl="pallas"``,
``mlp_impl="pallas"``; ``csrc/segment_sum.cu``, ``gated_mlp.cu``,
``basis.cu``).

The convs also take the mirror-map operands of the undirected bond store
(``pair``, DESIGN.md §5) and the symmetric trunk (``und_features``, §10),
whose symmetric bond conv (``fused_sym_bond_conv``) is two kernels:
phase A (``sym_msg``) and phase B (``sym_accum``).

The LM substrate's two kernels, the fused gated feed-forward
(``fused_swiglu``, ``csrc/swiglu.cu``) and flash attention
(``flash_attention``, ``csrc/flash_attention.cu``), take f32 or bf16 and
serve only: they are plain functions with no backward, and refuse inputs
that require a gradient (LM training is ROADMAP item 14).

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, incremented only where a kernel is launched.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import build, ref

_LIB = "message_passing"
_LIB_BF16 = "message_passing_bf16"  # the bf16 entries of kernels 2, 3, 4a

# Bytes of the widest per-edge tensor of one recompute chunk (the
# concatenated GatedMLP input).  The JAX package's chunk of 256 edges is
# a TPU tile; here one training batch of ~10^5 bonds takes one to a few
# chunks, so the backward launches a few hundred ops, not tens of
# thousands, and no message tensor lives from forward to backward.
CHUNK_BYTES = 64 << 20


def _default_chunk(row_floats: int) -> int:
    return max(1, CHUNK_BYTES // (4 * max(1, row_floats)))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _operand_dtype(t: torch.Tensor) -> torch.dtype:
    """The float operand type of a call to a kernel with a bf16 path (the
    convs, kernels 2 and 3, and the force readout, 4a): f32 or bf16, which
    every float operand of the call must share (``_check`` raises a
    ``TypeError`` otherwise).  The other kernels take f32 only."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"operands of dtype {t.dtype}: the CUDA kernel takes "
                        "float32 or bfloat16")
    return t.dtype


def _upcast(tensors) -> list:
    """f32 views of the recompute backward's operands: a bf16 operand is
    widened (exactly) and its chunks recomputed in f32, as the JAX
    package's custom VJPs do; f32 and float64 operands pass through."""
    return [t.float() if t is not None and t.dtype == torch.bfloat16 else t
            for t in tensors]


def _cast_like(grads, operands) -> tuple:
    """Cotangents accumulated in f32, cast to their operands' dtypes."""
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, operands))


def _check_aligned(**tables) -> None:
    # the split-f32 kernels gather rows with 16-byte cp.async copies
    for name, t in tables.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "the CUDA conv kernels")


# ---------------------------------------------------------------------------
# Launch plan of the split-f32 message-passing kernels (2, 3, 4 and 5)
# ---------------------------------------------------------------------------

# feature widths D the message-passing kernels are built for (their
# accumulators are 2D / 8 or D / 8 tiles of 8 columns, the convs'
# reduction D / 4 float4 columns)
CONV_WIDTHS = (8, 16, 32, 64, 128)
# csrc/message_passing.cu's kernels: warps a block, input columns a K
# chunk, cp.async stages; the H100's shared memory a SM and the part CUDA
# reserves for each resident block
_CONV_WARPS, _CONV_KC, _CONV_STAGES = 4, 32, 2
_SM_SHARED, _BLOCK_RESERVED = 233_472, 1_024
_PLAN_MODES = ("atom", "bond", "sym", "force")


def _check_conv_dim(dim: int) -> None:
    if dim not in CONV_WIDTHS:
        raise ValueError(f"feature width {dim}: the CUDA conv kernels are "
                         f"built for D in {CONV_WIDTHS}")


class ConvPlan(NamedTuple):
    """One launch of a split-f32 message-passing kernel on the card
    (``csrc/message_passing.cu``: ``conv_split_kernel`` for ``fused_atom_conv``
    / ``fused_bond_conv`` / ``sym_msg``, ``force_split_kernel`` for the
    force readouts)."""
    tm: int             # edges (sym: rows) a tile
    t: int              # least edges a chunk (see ``conv_chunks``)
    warps: int
    grid: int           # persistent blocks
    smem: int           # dynamic shared memory of a block, bytes
    k_chunks: int       # cp.async stages a tile
    blocks_per_sm: int


def conv_plan(mode: str, dim: int, n_rows: int, sms: int,
              itemsize: int = 4) -> ConvPlan:
    """The launch geometry of the message-passing kernels, the numbers the
    kernel checks ``tm`` and ``smem`` against.  ``itemsize`` is the
    operand type's: 4 (f32, split f32) or 2 (bf16: the convs and the
    force readout without the virial).

    ``"atom"`` / ``"bond"`` (kernels 2, 3): a tile of ``tm`` edges is 4
    warps of two m16 tiles (one at D = 128) by all 2D columns; a stage of
    its K loop holds the tile's 32 input columns (row stride 40 elements)
    and W's 32 rows (2D elements and 16 bytes); beside the two stages lie
    the f32 message tile (D + 8), bias and LayerNorm parameters (f32), two
    carry rows and the tile's row starts and runs.  Two blocks a SM (the
    registers of the accumulators: in bf16 the stages take half the bytes,
    and three blocks would still not fit at D = 64).

    ``"sym"`` (kernel 5, ``n_rows`` the dedup rows of the output; f32
    only): no reduction, so no message tile; 64-row tiles (one m16 tile a
    warp), whose K loop takes the v and a parts 32 columns a stage and the
    e part 16 columns of e[du1] beside the same 16 of e[du2] (``k_chunks``
    = 8 at D = 64), two blocks a SM for D <= 64.  The real rows are
    counted on the device, so the tile does not follow them: a training
    batch's 40.6k real rows are 636 tiles, 4.8 a SM, and a serving batch's
    11.9k are 187, where 128-row tiles would be 318 (1.2 waves of 264
    blocks) and 94 (38 SMs idle).  The grid is those blocks on every SM,
    at most one a tile of ``n_rows``.

    ``"force"`` (kernel 4, both variants in f32, 4a in bf16): tiles of 64
    bonds (one m16 tile a warp) whose e rows (stride max(D, 32) + 8
    elements), x_hat and distances (f32) are one stage; W1 lies in shared
    memory split into TF32 (hi, lo) pairs, (D / 2, D + 2) uint4, or in
    bf16 as packed m16n8k16 B fragments, (4 ceil(D / 16), 32 ceil(D / 32)
    + 8) uint2; bias, w2, two carry rows of 12 floats, the row starts and
    runs.  Three blocks a SM for D <= 64 (12 warps: a tile's products are
    short, K = D, so one block's scans and run sums overlap another's
    products).

    The reducing kernels' grid is their blocks on every SM (at most
    ``n_rows``: a chunk owns at least one row)."""
    if mode not in _PLAN_MODES:
        raise ValueError(f"mode must be one of {_PLAN_MODES}, got {mode!r}")
    if itemsize not in (2, 4) or (itemsize == 2 and mode == "sym"):
        raise ValueError(f"no {mode!r} kernel for operands of {itemsize} "
                         "bytes")
    _check_conv_dim(dim)
    kc, stages, reserved = _CONV_KC, _CONV_STAGES, _BLOCK_RESERVED
    if mode == "sym":
        tm = _CONV_WARPS * 16
        stage = tm * (kc + 8) + kc * (2 * dim + 4)
        smem = 4 * (stages * stage + 6 * dim)
        per_sm = min(2, _SM_SHARED // (smem + reserved))
        k_chunks = 2 * (dim // min(dim, kc)) + dim // min(dim, 16)
        return ConvPlan(tm, tm, _CONV_WARPS,
                        max(1, min(per_sm * sms, -(-n_rows // tm))), smem,
                        k_chunks, per_sm)
    if mode == "force":
        tm = _CONV_WARPS * 16
        if itemsize == 4:
            w_bytes = 16 * (dim // 2) * (dim + 2)
        else:
            w_bytes = 8 * 4 * -(-dim // 16) * (-(-dim // 32) * 32 + 8)
        stage = itemsize * tm * (max(dim, kc) + 8) + 16 * tm
        smem = w_bytes + stages * stage + 4 * (2 * dim + 4 + 24) \
            + 4 * (3 * tm + 8)
        k_chunks, blocks = 1, 3 if dim <= 64 else 2
    else:
        tm = _CONV_WARPS * 16 * (2 if dim <= 64 else 1)
        stage = itemsize * (tm * (kc + 8) + kc * (2 * dim + 16 // itemsize))
        smem = stages * stage + 4 * (tm * (dim + 8) + 6 * dim + 2 * dim) \
            + 4 * (3 * tm + 8)
        k_chunks = -(-(3 if mode == "atom" else 4) * dim // kc)
        blocks = 2
    per_sm = min(blocks, _SM_SHARED // (smem + reserved))
    return ConvPlan(tm, tm, _CONV_WARPS, max(1, min(per_sm * sms, n_rows)),
                    smem, k_chunks, per_sm)


def conv_chunks(offsets, plan: ConvPlan) -> list[tuple[int, int, int, int]]:
    """The reducing kernels' partition of the work (the convs, the force
    readouts), computed on the host: ``(row_lo, row_hi, edge_lo,
    edge_hi)`` for each block of ``plan``.

    With ``n_real = offsets[-1]`` and ``T = max(plan.t, ceil(n_real /
    plan.grid))`` (the kernel reads ``n_real`` on the device), block c
    owns the non-empty rows r in ``[row_lo, row_hi)``, those with
    ``offsets[r]`` in ``[c T, (c + 1) T)``, and walks their edges
    ``[edge_lo, edge_hi) = [offsets[row_lo], offsets[row_hi])``.  A row
    stays whole in the block where it starts; the empty rows are zeroed
    by a pass shared by all blocks."""
    offs = torch.as_tensor(offsets).long().cpu()
    n_real = int(offs[-1])
    t = max(plan.t, -(-n_real // plan.grid))
    out = []
    for c in range(plan.grid):
        lo, hi = (torch.tensor(min(x, n_real)) for x in (c * t, (c + 1) * t))
        r_lo = int(torch.searchsorted(offs, lo))
        r_hi = int(torch.searchsorted(offs, hi))
        out.append((r_lo, r_hi, int(offs[r_lo]), int(offs[r_hi])))
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _conv_launch_plan(mode: str, dim: int, n_rows: int, dev,
                      itemsize: int = 4) -> ConvPlan:
    return conv_plan(mode, dim, n_rows, _sm_count(dev.index), itemsize)


def _launch(lib: str, fn: str, *args) -> None:
    err = build.entry(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Chunked recompute backward
# ---------------------------------------------------------------------------

def _recompute_vjp(fn, dense, edge, needs, cotangents, n_real: int,
                   chunk: int):
    """Pull output cotangents back through ``fn``, one edge chunk at a time.

    ``fn(dense, edge_chunk, sl)`` recomputes chunk ``sl``'s outputs from
    the dense operands (whole tensors: their cotangents are summed over the
    chunks, in chunk order) and the chunk's slices of the per-edge
    operands (their cotangents are concatenated).  ``cotangents(sl)`` are
    the outputs' cotangents for the chunk.  ``needs`` flags, dense first
    then edge, which cotangents to return; the others come back as None.

    Only the first ``n_real`` edges are recomputed: the convs pass the
    real-edge count ``offsets[-1]``, since the padded tail contributes
    nothing forward and its cotangents are zeros.  (The JAX package's loop
    runs a static trip count over every chunk and masks the tail instead;
    reading ``offsets[-1]`` costs one device read here, and the batch
    capacities are several times the real counts.)  Row-wise ops with no
    padding of their own (the GatedMLP, the bases) pass every row.

    With grad mode on (a double backward), the recompute is recorded
    against the saved operands themselves, so the cotangents returned are
    differentiable; otherwise it runs on detached copies.
    """
    out = [None] * (len(dense) + len(edge))
    if not any(needs):
        return out
    create = torch.is_grad_enabled()

    def leaf(t, need):
        return t if create else t.detach().requires_grad_(need)

    nd = len(dense)
    parts = [[] for _ in edge]
    with torch.enable_grad():
        d_in = [leaf(t, n) for t, n in zip(dense, needs[:nd])]
        for i0 in range(0, n_real, chunk):
            sl = slice(i0, min(i0 + chunk, n_real))
            e_in = [leaf(t[sl], n) for t, n in zip(edge, needs[nd:])]
            wrt = [x for x, n in zip(d_in + e_in, needs) if n]
            grads = iter(torch.autograd.grad(fn(d_in, e_in, sl), wrt,
                                             cotangents(sl),
                                             create_graph=create))
            for k, need in enumerate(needs):
                if not need:
                    continue
                gk = next(grads)
                if k >= nd:
                    parts[k - nd].append(gk)
                else:
                    out[k] = gk if out[k] is None else out[k] + gk
    for k, need in enumerate(needs):
        if need and k >= nd:
            t = edge[k - nd]
            tail = t.new_zeros((t.shape[0] - n_real,) + tuple(t.shape[1:]))
            out[k] = torch.cat(parts[k - nd] + [tail])
        elif need and out[k] is None:
            out[k] = torch.zeros_like(dense[k])
    return out


# ---------------------------------------------------------------------------
# Atom conv (Eq. 4)
# ---------------------------------------------------------------------------

def _atom_conv_cuda(v, e, e_a, w, b, ln_scale, ln_bias, bond_center,
                    bond_nbr, bond_offsets, pair, und):
    a_rows, dim = v.shape
    n_edges = bond_center.shape[0]
    dev, ft, i32 = v.device, _operand_dtype(v), torch.int32
    _check_conv_dim(dim)
    # the undirected store reads e_a (and, with und, e) at Eu rows
    eu = n_edges if pair is None else e_a.shape[0]
    for name, t, dt, shape in (
            ("v", v, ft, (a_rows, dim)),
            ("e", e, ft, (eu if und else n_edges, dim)),
            ("e_a", e_a, ft, (eu, dim)),
            ("w", w, ft, (3 * dim, 2 * dim)), ("b", b, ft, (2 * dim,)),
            ("ln_scale", ln_scale, ft, (2 * dim,)),
            ("ln_bias", ln_bias, ft, (2 * dim,)),
            ("bond_center", bond_center, i32, (n_edges,)),
            ("bond_nbr", bond_nbr, i32, (n_edges,)),
            ("bond_offsets", bond_offsets, i32, (a_rows + 1,))):
        _check(name, t, dt, shape, dev)
    if pair is not None:
        _check("pair", pair, i32, (n_edges,), dev)
    _check_aligned(v=v, e=e, e_a=e_a, w=w)
    out = torch.empty((a_rows, dim), dtype=ft, device=dev)
    plan = _conv_launch_plan("atom", dim, a_rows, dev, v.element_size())
    lib, entry = (_LIB, "atom_conv_fwd") if ft == torch.float32 \
        else (_LIB_BF16, "atom_conv_bf16_fwd")
    _launch(lib, entry, v.data_ptr(), e.data_ptr(),
            e_a.data_ptr(), w.data_ptr(), b.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), bond_center.data_ptr(), bond_nbr.data_ptr(),
            None if pair is None else pair.data_ptr(),
            bond_offsets.data_ptr(), out.data_ptr(), a_rows, dim, int(und),
            plan.grid, plan.t, plan.tm, plan.smem, _stream(dev))
    fused_atom_conv.launches += 1
    return out


class _AtomConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, e, e_a, w, b, ln_scale, ln_bias, bond_center,
                bond_nbr, offsets, pair, und, chunk):
        # operands only: the messages are recomputed in the backward
        ctx.save_for_backward(v, e, e_a, w, b, ln_scale, ln_bias,
                              bond_center, bond_nbr, offsets, pair)
        ctx.und = und
        ctx.chunk = chunk or _default_chunk(3 * v.shape[1])
        if v.device.type == "cpu":
            return ref.fused_atom_conv_ref(v, e, e_a, w, b, ln_scale,
                                           ln_bias, bond_center, bond_nbr,
                                           offsets, pair, und)
        return _atom_conv_cuda(v, e, e_a, w, b, ln_scale, ln_bias,
                               bond_center, bond_nbr, offsets, pair, und)

    @staticmethod
    def backward(ctx, g):
        *floats, center, nbr, offs, pair = ctx.saved_tensors
        v, e, e_a, w, b, lns, lnb = _upcast(floats)
        (g,) = _upcast([g])
        c = center.long()
        nig = ctx.needs_input_grad
        # e and e_a are per-edge operands (chunks of rows), or Eu tables
        # read through pair, whose cotangents sum over the chunks
        operands = {"e": (e, ctx.und, nig[1]),
                    "e_a": (e_a, pair is not None, nig[2])}
        tables = [n for n, (_, tab, _) in operands.items() if tab]
        rows = [n for n, (_, tab, _) in operands.items() if not tab]

        def msgs(dense, edge, sl):
            vv, ww, bb, ss, oo = dense[:5]
            got = {n: ref.gather_rows(t, pair[sl])
                   for n, t in zip(tables, dense[5:])}
            got.update(zip(rows, edge))
            x = torch.cat([ref.gather_rows(vv, center[sl]),
                           ref.gather_rows(vv, nbr[sl]), got["e"]], dim=-1)
            return ref.gated_mlp_packed_ref(x, ww, bb, ss, oo) * got["e_a"]

        dv, dw, db, dls, dlb, *rest = _recompute_vjp(
            msgs, [v, w, b, lns, lnb] + [operands[n][0] for n in tables],
            [operands[n][0] for n in rows],
            [nig[0], nig[3], nig[4], nig[5], nig[6]]
            + [operands[n][2] for n in tables + rows],
            lambda sl: g[c[sl]], int(offs[-1]), ctx.chunk)
        grads = dict(zip(tables + rows, rest))
        return _cast_like((dv, grads["e"], grads["e_a"], dw, db, dls, dlb),
                          floats) + (None,) * 6


def fused_atom_conv(v, e, e_a, w, b, ln_scale, ln_bias,
                    bond_center, bond_nbr, bond_offsets,
                    *, pair=None, und_features: bool = False,
                    block_rows: int = 1, chunk: int | None = None):
    """Fused Eq. 4 message path: sum_j e^a_ij * phi(v_i, v_j, e_ij) -> (A, D).

    Requires the sorted-segment layout (DESIGN.md §1): bonds sorted by
    ``bond_center`` with CSR ``bond_offsets`` whose last entry is the
    real-bond count.  On the card the kernel balances its blocks by edges
    (``conv_plan``, ``conv_chunks``); ``block_rows`` is accepted for the
    callers of the earlier kernel and no longer shapes the launch.
    The backward recomputes ``chunk`` edges at a time (default: sized by
    ``CHUNK_BYTES``); the result does not depend on it.

    ``pair`` (the undirected store, DESIGN.md §5): the directed ->
    undirected mirror map; ``e_a`` is then the (Eu, D) envelope table,
    read per bond through it inside the kernel.  ``und_features`` (the
    symmetric trunk, §10; requires ``pair``): ``e`` is an (Eu, D) table
    read the same way.  The directed (E, D) expansions never exist; the
    backward sums the cotangents of those tables through the same reads.
    """
    if und_features and pair is None:
        raise ValueError("und_features needs the pair mirror map")
    return _AtomConv.apply(v, e, e_a, w, b, ln_scale, ln_bias, bond_center,
                           bond_nbr, bond_offsets, pair, und_features, chunk)


# ---------------------------------------------------------------------------
# Bond conv (Eq. 5)
# ---------------------------------------------------------------------------

def _bond_conv_cuda(v, e, a, e_b, w, b, ln_scale, ln_bias, angle_ij,
                    angle_ik, center_ids, angle_offsets, env_ij, env_ik,
                    mirror):
    a_rows, dim = v.shape
    b_rows = e.shape[0]
    n_ang = angle_ij.shape[0]
    dev, ft, i32 = v.device, _operand_dtype(v), torch.int32
    _check_conv_dim(dim)
    for name, t, dt, shape in (
            ("v", v, ft, (a_rows, dim)), ("e", e, ft, (b_rows, dim)),
            ("a", a, ft, (n_ang, dim)),
            # the undirected store reads e_b at Eu rows
            ("e_b", e_b, ft, (e_b.shape[0] if mirror else b_rows, dim)),
            ("w", w, ft, (4 * dim, 2 * dim)), ("b", b, ft, (2 * dim,)),
            ("ln_scale", ln_scale, ft, (2 * dim,)),
            ("ln_bias", ln_bias, ft, (2 * dim,)),
            ("angle_ij", angle_ij, i32, (n_ang,)),
            ("angle_ik", angle_ik, i32, (n_ang,)),
            ("center_ids", center_ids, i32, (n_ang,)),
            ("env_ij", env_ij, i32, (n_ang,)),
            ("env_ik", env_ik, i32, (n_ang,)),
            ("angle_offsets", angle_offsets, i32, (b_rows + 1,))):
        _check(name, t, dt, shape, dev)
    _check_aligned(v=v, e=e, a=a, e_b=e_b, w=w)
    out = torch.empty((b_rows, dim), dtype=ft, device=dev)
    plan = _conv_launch_plan("bond", dim, b_rows, dev, v.element_size())
    lib, entry = (_LIB, "bond_conv_fwd") if ft == torch.float32 \
        else (_LIB_BF16, "bond_conv_bf16_fwd")
    _launch(lib, entry, v.data_ptr(), e.data_ptr(),
            a.data_ptr(), e_b.data_ptr(), w.data_ptr(), b.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), angle_ij.data_ptr(),
            angle_ik.data_ptr(), center_ids.data_ptr(), env_ij.data_ptr(),
            env_ik.data_ptr(), angle_offsets.data_ptr(), out.data_ptr(),
            b_rows, dim, plan.grid, plan.t, plan.tm, plan.smem, _stream(dev))
    fused_bond_conv.launches += 1
    return out


class _BondConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, e, a, e_b, w, b, ln_scale, ln_bias, angle_ij,
                angle_ik, center_ids, offsets, pair, chunk):
        # the rows of e_b each angle reads: its bonds on the directed
        # store, their undirected ids on the undirected one
        env_ij, env_ik = (angle_ij, angle_ik) if pair is None else (
            pair[angle_ij.long()], pair[angle_ik.long()])
        ctx.save_for_backward(v, e, a, e_b, w, b, ln_scale, ln_bias,
                              angle_ij, angle_ik, center_ids, offsets,
                              env_ij, env_ik)
        ctx.chunk = chunk or _default_chunk(4 * v.shape[1])
        if v.device.type == "cpu":
            return ref.fused_bond_conv_ref(v, e, a, e_b, w, b, ln_scale,
                                           ln_bias, angle_ij, angle_ik,
                                           center_ids, offsets, pair)
        return _bond_conv_cuda(v, e, a, e_b, w, b, ln_scale, ln_bias,
                               angle_ij, angle_ik, center_ids, offsets,
                               env_ij, env_ik, pair is not None)

    @staticmethod
    def backward(ctx, g):
        (*floats, angle_ij, angle_ik, center_ids, offs, env_ij,
         env_ik) = ctx.saved_tensors
        v, e, a, e_b, w, b, lns, lnb = _upcast(floats)
        (g,) = _upcast([g])
        ij = angle_ij.long()

        def msgs(dense, edge, sl):
            vv, ee, eb, ww, bb, ss, oo = dense
            (ac,) = edge
            i, k = angle_ij[sl], angle_ik[sl]
            x = torch.cat([ref.gather_rows(vv, center_ids[sl]),
                           ref.gather_rows(ee, i), ref.gather_rows(ee, k), ac],
                          dim=-1)
            phi = ref.gated_mlp_packed_ref(x, ww, bb, ss, oo)
            return phi * ref.gather_rows(eb, env_ij[sl]) \
                * ref.gather_rows(eb, env_ik[sl])

        nig = ctx.needs_input_grad
        dv, de, deb, dw, db, dls, dlb, da = _recompute_vjp(
            msgs, [v, e, e_b, w, b, lns, lnb], [a],
            [nig[0], nig[1], nig[3], nig[4], nig[5], nig[6], nig[7], nig[2]],
            lambda sl: g[ij[sl]], int(offs[-1]), ctx.chunk)
        return _cast_like((dv, de, da, deb, dw, db, dls, dlb), floats) \
            + (None,) * 6


def fused_bond_conv(v, e, a, e_b, w, b, ln_scale, ln_bias,
                    angle_ij, angle_ik, center_ids, angle_offsets,
                    *, pair=None, block_rows: int = 32,
                    chunk: int | None = None):
    """Fused Eq. 5 message path:
    sum_k e^b_ij e^b_ik phi(v_c, e_ij, e_ik, a_ijk) -> (E, D).

    ``center_ids = bond_center[angle_ij]`` (a cheap int gather the caller
    performs).  Requires angles sorted by ``angle_ij`` with CSR
    ``angle_offsets`` (DESIGN.md §1).  On the card the kernel balances its
    blocks by edges (``conv_plan``, ``conv_chunks``); ``block_rows`` is
    accepted for the callers of the earlier kernel and no longer shapes
    the launch.  ``chunk`` is the backward's recompute chunk, in angles.
    ``pair`` (the undirected store, DESIGN.md §5): ``e_b`` is the (Eu, D)
    envelope table and both factors read rows ``pair[angle_ij]`` /
    ``pair[angle_ik]`` (int gathers this wrapper composes).
    """
    return _BondConv.apply(v, e, a, e_b, w, b, ln_scale, ln_bias, angle_ij,
                           angle_ik, center_ids, angle_offsets, pair, chunk)


# ---------------------------------------------------------------------------
# Symmetric bond conv (DESIGN.md §10): phase A messages, phase B CSR sum
# ---------------------------------------------------------------------------

def sym_msg(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2, offsets,
            *, block_rows: int = 32):
    """Phase A, forward only: the (Au, D) messages of the dedup angle rows,
    ``phi([v[ctr] | e_s | e_s | a_u]) * e_b[du1] * e_b[du2]``, ``e_s =
    e[du1] + e[du2]`` (``kernels.ref.sym_msg_ref``).  On the card only the
    real rows ``[0, offsets[-1] // 2)`` are computed, the count read on the
    device (``offsets`` is the (Eu + 1,) incidence CSR); the rows past it
    are left unwritten.  The kernel's persistent blocks stride over
    64-row tiles of them (``conv_plan("sym", ...)``); ``block_rows`` is
    accepted for the callers of the earlier kernel and no longer shapes
    the launch."""
    if v.device.type == "cpu":
        return ref.sym_msg_ref(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr,
                               du1, du2)
    return _sym_msg_cuda(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1,
                         du2, offsets)


def _sym_msg_cuda(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2,
                  offsets):
    a_rows, dim = v.shape
    eu, au = e.shape[0], a_u.shape[0]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _check_conv_dim(dim)
    for name, t, dt, shape in (
            ("v", v, f32, (a_rows, dim)), ("e", e, f32, (eu, dim)),
            ("a_u", a_u, f32, (au, dim)), ("e_b", e_b, f32, (eu, dim)),
            ("w", w, f32, (4 * dim, 2 * dim)), ("b", b, f32, (2 * dim,)),
            ("ln_scale", ln_scale, f32, (2 * dim,)),
            ("ln_bias", ln_bias, f32, (2 * dim,)),
            ("ctr", ctr, i32, (au,)), ("du1", du1, i32, (au,)),
            ("du2", du2, i32, (au,)), ("offsets", offsets, i32, (eu + 1,))):
        _check(name, t, dt, shape, dev)
    # both e slots read e_s: their weight blocks add once per call, K = 3D
    w23 = torch.cat([w[:dim], w[dim:2 * dim] + w[2 * dim:3 * dim],
                     w[3 * dim:]])
    _check_aligned(v=v, e=e, a_u=a_u, e_b=e_b, w23=w23)
    out = torch.empty((au, dim), dtype=f32, device=dev)
    plan = _conv_launch_plan("sym", dim, au, dev)
    _launch(_LIB, "sym_msg_fwd", v.data_ptr(), e.data_ptr(), a_u.data_ptr(),
            e_b.data_ptr(), w23.data_ptr(), b.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), ctr.data_ptr(),
            du1.data_ptr(), du2.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), eu, au, dim, plan.grid, plan.tm, plan.smem,
            _stream(dev))
    sym_msg.launches += 1
    return out


def sym_accum(msg, rep, dest, offsets, eu_rows: int):
    """Phase B, forward only: ``out[u] = sum of msg[rep[t]]`` over u's
    incidences ``t`` in ``[offsets[u], offsets[u+1])``, in CSR order ->
    (Eu, D) (``kernels.ref.sym_accum_ref``).  The walks are bounded by the
    offsets, so no padded incidence is read; ``dest`` is read by the plain
    version only."""
    if msg.device.type == "cpu":
        return ref.sym_accum_ref(msg, rep, dest, offsets, eu_rows)
    n_incid = rep.shape[0]
    au, dim = msg.shape
    dev, f32, i32 = msg.device, torch.float32, torch.int32
    for name, t, dt, shape in (
            ("msg", msg, f32, (au, dim)), ("rep", rep, i32, (n_incid,)),
            ("dest", dest, i32, (n_incid,)),
            ("offsets", offsets, i32, (eu_rows + 1,))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((eu_rows, dim), dtype=f32, device=dev)
    vec4 = int(dim % 4 == 0 and msg.data_ptr() % 16 == 0)
    _launch("segment_sum", "sym_accum_fwd", msg.data_ptr(), rep.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), eu_rows, dim, vec4,
            _stream(dev))
    sym_accum.launches += 1
    return out


class _SymBondConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2,
                rep, dest, offsets, chunk):
        ctx.save_for_backward(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr,
                              du1, du2, offsets)
        ctx.chunk = chunk or _default_chunk(4 * v.shape[1])
        if v.device.type == "cpu":
            return ref.fused_sym_bond_conv_ref(v, e, a_u, e_b, w, b,
                                               ln_scale, ln_bias, ctr, du1,
                                               du2, rep, dest, offsets)
        msg = sym_msg(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr, du1, du2,
                      offsets)
        out = sym_accum(msg, rep, dest, offsets, e.shape[0])
        fused_sym_bond_conv.launches += 2
        return out

    @staticmethod
    def backward(ctx, g):
        """Recompute over the real dedup rows ``[0, offsets[-1] // 2)``.
        The incidence store is not walked: each real row's message lands
        on exactly its two pair destinations, so its cotangent is ``g[du1]
        + g[du2]`` (``2 g`` for a self-image pair, its forward double
        count)."""
        (v, e, a_u, e_b, w, b, lns, lnb, ctr, du1, du2,
         offs) = ctx.saved_tensors

        def msgs(dense, edge, sl):
            vv, ee, eb, ww, bb, ss, oo = dense
            (ac,) = edge
            i1, i2 = du1[sl], du2[sl]
            e_s = ref.gather_rows(ee, i1) + ref.gather_rows(ee, i2)
            x = torch.cat([ref.gather_rows(vv, ctr[sl]), e_s, e_s, ac],
                          dim=-1)
            phi = ref.gated_mlp_packed_ref(x, ww, bb, ss, oo)
            return phi * ref.gather_rows(eb, i1) * ref.gather_rows(eb, i2)

        nig = ctx.needs_input_grad
        dv, de, deb, dw, db, dls, dlb, da = _recompute_vjp(
            msgs, [v, e, e_b, w, b, lns, lnb], [a_u],
            [nig[0], nig[1], nig[3], nig[4], nig[5], nig[6], nig[7], nig[2]],
            lambda sl: ref.gather_rows(g, du1[sl])
            + ref.gather_rows(g, du2[sl]),
            int(offs[-1]) // 2, ctx.chunk)
        return (dv, de, da, deb, dw, db, dls, dlb) + (None,) * 7


def fused_sym_bond_conv(v, e, a_u, e_b, w, b, ln_scale, ln_bias,
                        ctr, du1, du2, rep, dest, offsets,
                        *, msg_block: int = 32, chunk: int | None = None):
    """Fused symmetric-trunk Eq. 5 message path (DESIGN.md §10):

        msg_w  = e^b[du1] e^b[du2] phi(v_c, e_s, e_s, a_w),
        e_s    = e[du1] + e[du2],
        agg[u] = sum over incidences (u, w) of msg_w        -> (Eu, D)

    with one GatedMLP row per dedup angle, scattered to both undirected
    bonds of its pair through the sym-incidence store (``dest`` / ``rep``
    sorted by destination, CSR ``offsets``).  On the card two launches:
    phase A (``sym_msg``) and phase B (``sym_accum``); ``msg_block`` is
    accepted for the callers of the earlier phase A kernel and no longer
    shapes its launch.  ``ctr = bond_center[und_angle_ij]``, ``du1 / du2 =
    bond_pair[und_angle_ij / und_angle_ik]``.  The backward recomputes
    ``chunk`` dedup rows at a time and is twice differentiable.
    """
    return _SymBondConv.apply(v, e, a_u, e_b, w, b, ln_scale, ln_bias, ctr,
                              du1, du2, rep, dest, offsets, chunk)


# ---------------------------------------------------------------------------
# Force readout (Eq. 7) and its virial epilogue (§7)
# ---------------------------------------------------------------------------

def _force_checks(e, x_hat, w1, b1, w2, b2, bond_center, bond_offsets,
                  num_atoms, ft=torch.float32):
    n_edges, dim = e.shape
    dev, i32 = e.device, torch.int32
    _check_conv_dim(dim)
    for name, t, dt, shape in (
            ("e", e, ft, (n_edges, dim)), ("x_hat", x_hat, ft, (n_edges, 3)),
            ("w1", w1, ft, (dim, dim)), ("b1", b1, ft, (dim,)),
            ("w2", w2, ft, (dim, 1)), ("b2", b2, ft, (1,)),
            ("bond_center", bond_center, i32, (n_edges,)),
            ("bond_offsets", bond_offsets, i32, (num_atoms + 1,))):
        _check(name, t, dt, shape, dev)
    _check_aligned(e=e)
    return _conv_launch_plan("force", dim, num_atoms, dev, e.element_size())


def _force_readout_cuda(e, x_hat, w1, b1, w2, b2, bond_center, bond_offsets,
                        num_atoms):
    ft = _operand_dtype(e)
    plan = _force_checks(e, x_hat, w1, b1, w2, b2, bond_center,
                         bond_offsets, num_atoms, ft)
    out = torch.empty((num_atoms, 3), dtype=ft, device=e.device)
    lib, entry = _LIB, "force_readout_fwd"
    if ft == torch.bfloat16:
        # the bf16 kernel reads x_hat in f32: its 6-byte bf16 rows do not
        # suit the kernel's 4-byte copies, and widening bf16 is exact
        x_hat = x_hat.float()
        lib, entry = _LIB_BF16, "force_readout_bf16_fwd"
    _launch(lib, entry, e.data_ptr(), x_hat.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            bond_offsets.data_ptr(), out.data_ptr(), num_atoms, e.shape[1],
            plan.grid, plan.t, plan.tm, plan.smem, _stream(e.device))
    fused_force_readout.launches += 1
    return out


def _bond_scalars(e, w1, b1, w2, b2):
    """n_ij = w2 . silu(e W1 + b1) + b2, as (chunk, 1)."""
    return torch.nn.functional.silu(e @ w1 + b1) @ w2 + b2


class _ForceReadout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, x_hat, w1, b1, w2, b2, bond_center, offsets,
                num_atoms, chunk):
        ctx.save_for_backward(e, x_hat, w1, b1, w2, b2, bond_center,
                              offsets)
        ctx.chunk = chunk or _default_chunk(e.shape[1])
        if e.device.type == "cpu":
            return ref.fused_force_readout_ref(e, x_hat, w1, b1, w2, b2,
                                               bond_center, offsets,
                                               num_atoms)
        return _force_readout_cuda(e, x_hat, w1, b1, w2, b2, bond_center,
                                   offsets, num_atoms)

    @staticmethod
    def backward(ctx, g):
        *floats, center, offs = ctx.saved_tensors
        e, x_hat, w1, b1, w2, b2 = _upcast(floats)
        (g,) = _upcast([g])
        c = center.long()

        def contribs(dense, edge, sl):
            ec, xc = edge
            return _bond_scalars(ec, *dense) * xc

        nig = ctx.needs_input_grad
        dw1, db1, dw2, db2, de, dxh = _recompute_vjp(
            contribs, [w1, b1, w2, b2], [e, x_hat],
            [nig[2], nig[3], nig[4], nig[5], nig[0], nig[1]],
            lambda sl: g[c[sl]], int(offs[-1]), ctx.chunk)
        return _cast_like((de, dxh, dw1, db1, dw2, db2), floats) \
            + (None,) * 4


def fused_force_readout(e, x_hat, w1, b1, w2, b2, bond_center, bond_offsets,
                        num_atoms: int, *, block_rows: int = 1,
                        chunk: int | None = None):
    """Fused Eq. 7 direct-force readout: F_i = sum_j n_ij x_hat_ij -> (A, 3).

    The per-bond scalar MLP (w1/b1 -> silu -> w2/b2), the x_hat weighting
    and the per-atom reduction run in one kernel over the sorted CSR rows;
    ``n_ij`` never reaches device memory.  On the card the kernel balances
    its blocks by edges as the convs do (``conv_plan("force", ...)``,
    ``conv_chunks``); ``block_rows`` is accepted for the callers of the
    earlier kernel and no longer shapes the launch.  The kernel walks rows
    by ``bond_offsets``; ``bond_center`` is checked and used by the plain
    version and the backward.
    """
    return _ForceReadout.apply(e, x_hat, w1, b1, w2, b2, bond_center,
                               bond_offsets, num_atoms, chunk)


def _force_virial_cuda(e, x_hat, dist, w1, b1, w2, b2, bond_center,
                       bond_crystal, bond_offsets, num_atoms, num_crystals):
    plan = _force_checks(e, x_hat, w1, b1, w2, b2, bond_center,
                         bond_offsets, num_atoms)
    n_edges, dev = e.shape[0], e.device
    _check("dist", dist, torch.float32, (n_edges,), dev)
    _check("bond_crystal", bond_crystal, torch.int32, (n_edges,), dev)
    out = torch.empty((num_atoms, 3), dtype=torch.float32, device=dev)
    rows = torch.empty((num_atoms, 9), dtype=torch.float32, device=dev)
    raw = torch.empty((num_crystals, 3, 3), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    _launch(_LIB, "force_virial_fwd", e.data_ptr(), x_hat.data_ptr(),
            dist.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), bond_offsets.data_ptr(), out.data_ptr(),
            rows.data_ptr(), num_atoms, e.shape[1], plan.grid, plan.t,
            plan.tm, plan.smem, stream)
    fused_force_virial_readout.launches += 1
    _launch(_LIB, "virial_crystal_sum", rows.data_ptr(),
            bond_crystal.data_ptr(), bond_offsets.data_ptr(), raw.data_ptr(),
            num_atoms, num_crystals, stream)
    fused_force_virial_readout.launches += 1
    return out, raw


class _ForceVirial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, x_hat, dist, w1, b1, w2, b2, bond_center,
                bond_crystal, offsets, num_atoms, num_crystals, chunk):
        ctx.save_for_backward(e, x_hat, dist, w1, b1, w2, b2, bond_center,
                              bond_crystal, offsets)
        ctx.chunk = chunk or _default_chunk(e.shape[1])
        ctx.num_crystals = num_crystals
        if e.device.type == "cpu":
            return ref.fused_force_virial_readout_ref(
                e, x_hat, dist, w1, b1, w2, b2, bond_center, bond_crystal,
                offsets, num_atoms, num_crystals)
        return _force_virial_cuda(e, x_hat, dist, w1, b1, w2, b2,
                                  bond_center, bond_crystal, offsets,
                                  num_atoms, num_crystals)

    @staticmethod
    def backward(ctx, g_f, g_s):
        (e, x_hat, dist, w1, b1, w2, b2, center, crystal,
         offs) = ctx.saved_tensors
        c, cr = center.long(), crystal.long()
        g_s = g_s.reshape(ctx.num_crystals, 9)

        def contribs(dense, edge, sl):
            ec, xc, dc = edge
            n = _bond_scalars(ec, *dense)
            outer = (xc[:, :, None] * xc[:, None, :]).reshape(-1, 9)
            return n * xc, (n * dc[:, None]) * outer

        nig = ctx.needs_input_grad
        dw1, db1, dw2, db2, de, dxh, dd = _recompute_vjp(
            contribs, [w1, b1, w2, b2], [e, x_hat, dist],
            [nig[3], nig[4], nig[5], nig[6], nig[0], nig[1], nig[2]],
            lambda sl: (g_f[c[sl]], g_s[cr[sl]]), int(offs[-1]), ctx.chunk)
        return (de, dxh, dd, dw1, db1, dw2, db2) + (None,) * 6


def fused_force_virial_readout(e, x_hat, dist, w1, b1, w2, b2, bond_center,
                               bond_crystal, bond_offsets, num_atoms: int,
                               num_crystals: int, *, block_rows: int = 1,
                               chunk: int | None = None):
    """Force readout + bond-virial partials (DESIGN.md §7).

    Returns the (A, 3) forces of ``fused_force_readout`` and the raw
    (B, 3, 3) f32 per-crystal sums ``sum n_ij d_ij x_hat ⊗ x_hat`` over the
    real bonds.  On the card it takes two launches: the force kernel with
    a virial epilogue that sums each atom row's nine partials while
    ``n_ij`` and ``x_hat`` are in shared memory (the (E, 3, 3) products
    never reach device memory), then an ordered per-crystal sum of those
    rows, a row counted in the crystal of its first bond.  Crystal ids may
    come in any order over the rows (slots permuted, crystals
    interleaved, empty slots).  Precondition, which the JAX kernel does
    not have: every real bond of an atom row carries the crystal of the
    row's first bond, as a bond lies in its center atom's crystal
    (``bond_crystal[b]`` is ``atom_crystal[bond_center[b]]``);
    ``batching.validate_layout`` checks it.  ``block_rows`` is accepted and
    unused, as in ``fused_force_readout``.  Volume normalization and units
    live in ``core.heads``.  The backward takes both cotangents, the force
    one gathered through ``bond_center`` and the stress one through
    ``bond_crystal``.
    """
    return _ForceVirial.apply(e, x_hat, dist, w1, b1, w2, b2, bond_center,
                              bond_crystal, bond_offsets, num_atoms,
                              num_crystals, chunk)


# ---------------------------------------------------------------------------
# The unfused tier's kernels: segment sum, GatedMLP, RBF and Fourier bases
# ---------------------------------------------------------------------------

def _segment_sum_cuda(values, segment_ids, offsets, num_segments):
    n_edges, dim = values.shape
    dev, f32, i32 = values.device, torch.float32, torch.int32
    for name, t, dt, shape in (
            ("values", values, f32, (n_edges, dim)),
            ("segment_ids", segment_ids, i32, (n_edges,)),
            ("offsets", offsets, i32, (num_segments + 1,))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((num_segments, dim), dtype=f32, device=dev)
    # 16-byte loads where rows are whole float4s (not the force head's D=3)
    vec4 = int(dim % 4 == 0 and values.data_ptr() % 16 == 0)
    _launch("segment_sum", "segment_sum_fwd", values.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), num_segments, dim, vec4,
            _stream(dev))
    fused_segment_sum.launches += 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, offsets, num_segments):
        ctx.save_for_backward(segment_ids, offsets)
        ctx.num_segments = num_segments
        if values.device.type == "cpu":
            return ref.sorted_segment_sum_ref(values, segment_ids, offsets,
                                              num_segments)
        return _segment_sum_cuda(values, segment_ids, offsets, num_segments)

    @staticmethod
    def backward(ctx, g):
        # d/dv[e] of a sum into rows is a gather: g[seg[e]] on the real
        # edges [0, offsets[S]), zero on the padded tail.  gather_rows, not
        # indexing: its backward (a double backward's) splits a repeated
        # id's rows into parallel segments
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        seg, offs = ctx.saved_tensors
        n_real = int(offs[ctx.num_segments])
        dv = ref.gather_rows(g, seg[:n_real])
        tail = dv.new_zeros((seg.shape[0] - n_real, g.shape[1]))
        return torch.cat([dv, tail]), None, None, None


def fused_segment_sum(values, segment_ids, offsets, num_segments: int):
    """Sorted-segment reduction: (E, D) edges -> (num_segments, D) rows.

    Requires the sorted-segment layout (DESIGN.md §1): real edges sorted
    by ``segment_ids`` with CSR ``offsets`` of shape (num_segments + 1,),
    ``offsets[-1]`` the number of real edges; the padded tail past it is
    never read.  Any width D >= 1 (the force head reduces D = 3).  The
    backward is the gather ``g[segment_ids]`` over the real edges.
    """
    return _SegmentSum.apply(values, segment_ids, offsets, num_segments)


# output widths D the GatedMLP kernel is built for (its accumulators are
# 2D / 8 tiles of 8 columns); any d_in
GATED_MLP_WIDTHS = (8, 16, 32, 64, 128)


def _gated_mlp_cuda(x, w, b, ln_scale, ln_bias):
    m, d_in = x.shape
    dim = w.shape[1] // 2
    dev, f32 = x.device, torch.float32
    if w.shape[1] % 2 or dim not in GATED_MLP_WIDTHS:
        raise ValueError(f"packed width {w.shape[1]}: the CUDA kernel takes "
                         f"D = width / 2 in {GATED_MLP_WIDTHS}")
    for name, t, shape in (
            ("x", x, (m, d_in)), ("w", w, (d_in, 2 * dim)),
            ("b", b, (2 * dim,)), ("ln_scale", ln_scale, (2 * dim,)),
            ("ln_bias", ln_bias, (2 * dim,))):
        _check(name, t, f32, shape, dev)
    out = torch.empty((m, dim), dtype=f32, device=dev)
    _launch("gated_mlp", "gated_mlp_fwd", x.data_ptr(), w.data_ptr(),
            b.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            out.data_ptr(), m, d_in, dim, _stream(dev))
    fused_gated_mlp_packed.launches += 1
    return out


class _GatedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, ln_scale, ln_bias, chunk):
        # operands only: the backward recomputes the MLP chunk by chunk
        ctx.save_for_backward(x, w, b, ln_scale, ln_bias)
        ctx.chunk = chunk or _default_chunk(x.shape[1])
        if x.device.type == "cpu":
            return ref.gated_mlp_packed_ref(x, w, b, ln_scale, ln_bias)
        return _gated_mlp_cuda(x, w, b, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, g):
        x, w, b, lns, lnb = ctx.saved_tensors

        def mlp(dense, edge, sl):
            return ref.gated_mlp_packed_ref(edge[0], *dense)

        nig = ctx.needs_input_grad
        dw, db, dls, dlb, dx = _recompute_vjp(
            mlp, [w, b, lns, lnb], [x],
            [nig[1], nig[2], nig[3], nig[4], nig[0]],
            lambda sl: g[sl], x.shape[0], ctx.chunk)
        return dx, dw, db, dls, dlb, None


def fused_gated_mlp_packed(x, w, b, ln_scale, ln_bias, *,
                           chunk: int | None = None):
    """CHGNet GatedMLP from packed parameters: (M, d_in) -> (M, D),
    ``silu(LN(x Wc + bc)) * sigmoid(LN(x Wg + bg))`` with ``w = [Wc ‖ Wg]``
    (d_in, 2D) and ``b`` / ``ln_*`` packed [core ‖ gate] (2D,).  Every row
    is computed.  The backward recomputes ``chunk`` rows at a time
    (default: sized by ``CHUNK_BYTES``) through the plain version."""
    return _GatedMLP.apply(x, w, b, ln_scale, ln_bias, chunk)


def fused_gated_mlp(x, wc, bc, wg, bg, sc, oc, sg, og, *,
                    chunk: int | None = None):
    """GatedMLP from separate core/gate parameters (the legacy calling
    convention): packs them and calls ``fused_gated_mlp_packed``, whose
    counter counts the launch."""
    return fused_gated_mlp_packed(
        x, torch.cat([wc, wg], dim=1), torch.cat([bc, bg]),
        torch.cat([sc, sg]), torch.cat([oc, og]), chunk=chunk)


# Kernels 8 and 9 (csrc/basis.cu): 256-thread blocks, at most 8 an SM
# (the RBF's 32 registers a thread let 8 stay resident; more blocks hide
# a tile's barriers better than 4 in a probe on the H100), strided over
# tiles of rows; the RBF's tile and largest basis, the Fourier basis'
# shared output tile (floats) and largest tile.  basis.cu holds the same
# numbers and refuses another tile.
BASIS_BLOCKS_PER_SM = 8
RBF_TILE = 128
RBF_MAX_BASIS = 1024
FOURIER_TILE_FLOATS = 8192
FOURIER_MAX_TILE = 256


class BasisPlan(NamedTuple):
    tile: int  # rows a tile, a multiple of 4: 16-byte aligned tile starts
    grid: int  # persistent blocks


def basis_plan(kind: str, n: int, k: int, sms: int) -> BasisPlan:
    """Launch plan of the RBF (``kind="rbf"``, K basis functions) or the
    Fourier basis (``"fourier"``, K odd) over ``n`` rows on a card with
    ``sms`` SMs: the rows a tile (the RBF 128; the Fourier basis the most,
    a multiple of 4 and at most 256, whose T x K floats fit its shared
    tile) and a grid of at most ``BASIS_BLOCKS_PER_SM`` blocks an SM."""
    if kind == "rbf":
        if not 0 <= k <= RBF_MAX_BASIS:
            raise ValueError(f"the RBF kernel takes at most {RBF_MAX_BASIS} "
                             f"basis functions, got {k}")
        tile = RBF_TILE
    elif kind == "fourier":  # K odd, at most 127: fused_fourier checks
        tile = min(FOURIER_MAX_TILE, FOURIER_TILE_FLOATS // k // 4 * 4)
    else:
        raise ValueError(f"unknown basis kernel {kind!r}")
    tiles = -(-n // tile)
    return BasisPlan(tile, max(1, min(tiles, BASIS_BLOCKS_PER_SM * sms)))


def _rbf_cuda(dist, freqs, r_cut, p):
    (n,), (k,) = dist.shape, freqs.shape
    dev = dist.device
    _check("dist", dist, torch.float32, (n,), dev)
    _check("freqs", freqs, torch.float32, (k,), dev)
    plan = basis_plan("rbf", n, k, _sm_count(dev.index))
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    _launch("basis", "rbf_fwd", dist.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), n, k, float(r_cut), math.sqrt(2.0 / r_cut), p,
            plan.tile, plan.grid, _stream(dev))
    fused_rbf.launches += 1
    return out


class _RBF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dist, freqs, r_cut, p, chunk):
        ctx.save_for_backward(dist, freqs)
        ctx.r_cut, ctx.p = r_cut, p
        ctx.chunk = chunk or _default_chunk(freqs.shape[0])
        if dist.device.type == "cpu":
            return ref.fused_rbf_ref(dist, freqs, r_cut, p)
        return _rbf_cuda(dist, freqs, r_cut, p)

    @staticmethod
    def backward(ctx, g):
        dist, freqs = ctx.saved_tensors

        def basis(dense, edge, sl):
            return ref.fused_rbf_ref(edge[0], dense[0], ctx.r_cut, ctx.p)

        nig = ctx.needs_input_grad
        dfreqs, ddist = _recompute_vjp(
            basis, [freqs], [dist], [nig[1], nig[0]], lambda sl: g[sl],
            dist.shape[0], ctx.chunk)
        return ddist, dfreqs, None, None, None


def fused_rbf(dist, freqs, r_cut: float, p: int = 8, *,
              chunk: int | None = None):
    """(N,) x (K,) -> (N, K) smooth-RBF basis with the factored envelope.

    Differentiable with respect to the distances and the trainable
    frequencies: the forces/stress autodiff readout and training at
    ``mlp_impl="pallas"`` both pass through its recompute backward.  The
    kernel takes K up to ``RBF_MAX_BASIS`` and raises above it.
    """
    return _RBF.apply(dist, freqs, r_cut, p, chunk)


def _fourier_cuda(theta, num_basis):
    (n,) = theta.shape
    dev = theta.device
    _check("theta", theta, torch.float32, (n,), dev)
    plan = basis_plan("fourier", n, num_basis, _sm_count(dev.index))
    out = torch.empty((n, num_basis), dtype=torch.float32, device=dev)
    _launch("basis", "fourier_fwd", theta.data_ptr(), out.data_ptr(), n,
            num_basis, plan.tile, plan.grid, _stream(dev))
    fused_fourier.launches += 1
    return out


class _Fourier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, num_basis, chunk):
        ctx.save_for_backward(theta)
        ctx.num_basis = num_basis
        ctx.chunk = chunk or _default_chunk(num_basis)
        if theta.device.type == "cpu":
            return ref.fused_fourier_ref(theta, num_basis)
        return _fourier_cuda(theta, num_basis)

    @staticmethod
    def backward(ctx, g):
        (theta,) = ctx.saved_tensors

        def basis(dense, edge, sl):
            return ref.fused_fourier_ref(edge[0], ctx.num_basis)

        (dtheta,) = _recompute_vjp(
            basis, [], [theta], [ctx.needs_input_grad[0]], lambda sl: g[sl],
            theta.shape[0], ctx.chunk)
        return dtheta, None, None


def fused_fourier(theta, num_basis: int, *, chunk: int | None = None):
    """(N,) -> (N, num_basis) Fourier angle basis, ``num_basis`` odd and at
    most 127 (the JAX kernel's bound); differentiable with respect to
    ``theta``."""
    if num_basis % 2 != 1 or not 0 < num_basis <= 127:
        raise ValueError(f"num_basis must be odd and at most 127, got "
                         f"{num_basis}")
    return _Fourier.apply(theta, num_basis, chunk)


# ---------------------------------------------------------------------------
# LM substrate: the fused gated feed-forward (kernel 10) and flash
# attention (kernel 11), f32 or bf16, forward only
# ---------------------------------------------------------------------------

_LM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTIVATIONS = {"silu": 0, "gelu": 1}
# csrc/swiglu.cu's schedules: bf16 wgmma tiles (rows, gate/up columns,
# down columns) of the wide (M > 64) and narrow (decode) plans, K per ring
# stage and ring stages; the split-f32 plans (rows, gate/up columns, down
# columns, K per stage, stages), wide for M > 16, else narrow
_SW_WIDE, _SW_NARROW, _SW_BK, _SW_STAGES = (128, 128, 256), (64, 64, 64), \
    64, 4
_SW_F32_WIDE, _SW_F32_NARROW = (128, 64, 128, 64, 3), (16, 64, 64, 32, 4)
_SW_F32_NARROW_M = 16


class SwigluPlan(NamedTuple):
    """One ``fused_swiglu`` call on the card (``csrc/swiglu.cu``): the
    gate/up GEMM over (row tile, F tile) blocks, then the down GEMM over
    (row tile, D tile, K split) blocks, then, with ``splits`` > 1, the
    fixed-order sum of the f32 partials."""
    wide: bool          # 128-row tiles (bf16: two consumer warpgroups)
    producer: str       # "tma", "elementwise" (bf16) or "cp.async" (f32)
    rows: int           # rows of a tile (both GEMMs)
    gate_cols: int      # F columns of a gate/up tile
    down_cols: int      # D columns of a down tile
    row_tiles: int
    gate_tiles: int     # F tiles
    down_tiles: int     # D tiles
    splits: int         # K slices of the down product
    k_split: int        # K = F rows per slice, a multiple of 64
    stages: int
    smem_gate: int      # dynamic shared memory of a block, bytes
    smem_down: int
    scratch_bytes: int  # h (M, F) in the operand type + f32 partials

    @property
    def gate_blocks(self) -> int:
        return self.row_tiles * self.gate_tiles

    @property
    def down_blocks(self) -> int:
        return self.row_tiles * self.down_tiles * self.splits


def swiglu_plan(m: int, d: int, f: int, itemsize: int, sms: int,
                aligned: bool = True) -> SwigluPlan:
    """The schedule of one ``fused_swiglu`` call on the card.  bf16 runs on
    wgmma: 128-row tiles (128-column gate/up, 256-column down) for M > 64;
    at decode (M <= 64, bound by bytes) 64-row, 64-column tiles.  Its
    producer is TMA where rows are 16-byte aligned (D, F multiples of 8,
    ``aligned`` bases), else element by element.  f32 runs split f32
    (3xTF32) on ``mma.sync``: 128-row tiles (64-column gate/up, 128-column
    down) for M > 16, at decode 16-row, 64-column tiles.  When the down
    product has fewer tiles than the card has SMs, its K = F is split so
    that at least (bf16) or at most (f32) ``2 * sms`` blocks stream Wd;
    the slices' f32 partials are summed in split order."""
    bf16 = itemsize == 2
    if bf16:
        wide = m > 64
        rows, gate_cols, down_cols = _SW_WIDE if wide else _SW_NARROW
        stages = _SW_STAGES
        producer = "tma" if aligned and d % 8 == 0 and f % 8 == 0 \
            else "elementwise"

        def ring(cols, operands):
            return stages * (rows + operands * cols) * _SW_BK * 2 \
                + 2 * stages * 8 + 1024
        smem_gate, smem_down = ring(gate_cols, 2), ring(down_cols, 1)
    else:
        wide = m > _SW_F32_NARROW_M
        rows, gate_cols, down_cols, bk, stages = \
            _SW_F32_WIDE if wide else _SW_F32_NARROW
        producer = "cp.async"

        # a stage: the A tile with rows of bk + 8 floats, the B tiles with
        # rows of cols + 4 (csrc/swiglu.cu SplitShape)
        def ring(cols, operands):
            return stages * (rows * (bk + 8) + operands * bk * (cols + 4)) \
                * 4
        smem_gate, smem_down = ring(gate_cols, 2), ring(down_cols, 1)
    row_tiles = -(-m // rows)
    gate_tiles, down_tiles = -(-f // gate_cols), -(-d // down_cols)
    k_steps = -(-f // _SW_BK)
    splits = 1
    if row_tiles * down_tiles < sms:
        # bf16: at least two blocks an SM (2-3 are resident); f32, one
        # block an SM (its ring takes 150 KB): at most two waves
        tiles = row_tiles * down_tiles
        want = -(-2 * sms // tiles) if bf16 else 2 * sms // tiles
        per = -(-k_steps // min(k_steps, want))
        splits = -(-k_steps // per)
    k_split = -(-k_steps // splits) * _SW_BK
    scratch = m * f * itemsize + (splits * m * d * 4 if splits > 1 else 0)
    return SwigluPlan(wide, producer, rows, gate_cols, down_cols, row_tiles,
                      gate_tiles, down_tiles, splits, k_split, stages,
                      smem_gate, smem_down, scratch)


def _lm_operands(names, tensors, ndims):
    """One float dtype (f32 or bf16) and one device for all operands, each
    of the given rank, none requiring a gradient (no backward yet)."""
    dtype, device = tensors[0].dtype, tensors[0].device
    for name, t, nd in zip(names, tensors, ndims):
        if t.dtype not in _LM_DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; the LM kernels take "
                            "float32 or bfloat16")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype} "
                            f"like {names[0]}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dimensions, got "
                             f"{tuple(t.shape)}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name} requires a gradient; the LM kernels "
                               "have no backward yet (ROADMAP item 14)")


def _swiglu_cuda(x, w_gate, w_up, w_down, activation):
    m, d = x.shape
    f = w_gate.shape[1]
    dev = x.device
    operands = (("x", x, (m, d)), ("w_gate", w_gate, (d, f)),
                ("w_up", w_up, (d, f)), ("w_down", w_down, (f, d)))
    for name, t, shape in operands:
        _check(name, t, x.dtype, shape, dev)
    out = torch.empty((m, d), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    plan = swiglu_plan(
        m, d, f, x.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        aligned=all(t.data_ptr() % 16 == 0 for _, t, _ in operands))
    h = torch.empty((m, f), dtype=x.dtype, device=dev)
    partial = torch.empty((plan.splits, m, d), dtype=torch.float32,
                          device=dev) if plan.splits > 1 else None
    _launch("swiglu", "swiglu_fwd", x.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), out.data_ptr(), h.data_ptr(),
            None if partial is None else partial.data_ptr(), m, d, f,
            int(plan.wide), plan.splits, plan.k_split, _LM_DTYPES[x.dtype],
            _ACTIVATIONS[activation], int(plan.producer == "tma"),
            _stream(dev))
    fused_swiglu.launches += 1
    return out


def fused_swiglu(x, w_gate, w_up, w_down, *, activation: str = "silu"):
    """LM gated MLP ``(act(x Wg) * (x Wu)) Wd``: x (M, D), w_gate / w_up
    (D, F), w_down (F, D) -> (M, D), act ``"silu"`` (SwiGLU) or ``"gelu"``
    (GeGLU, tanh form); f32 or bf16, all operands alike.

    g and u accumulate in f32, h is rounded to the operand dtype, the down
    product accumulates in f32 and rounds once (the TPU kernel sums its F
    blocks in the operand dtype: in bf16 the two agree to bf16 rounding).
    Any M, D, F >= 1: the Pallas wrapper's padding of M to 128 and its F %
    256 assertion, like its block sizes, are TPU tiling and do not carry
    over.  On the card one call is one launch, counted once: the gate/up
    and down GEMMs of ``swiglu_plan`` (and, with split-K, the sum of the
    partials) through an (M, F) scratch h."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be 'silu' or 'gelu', got "
                         f"{activation!r}")
    _lm_operands(("x", "w_gate", "w_up", "w_down"),
                 (x, w_gate, w_up, w_down), (2, 2, 2, 2))
    (m, d), f = x.shape, w_gate.shape[-1]
    for name, t, shape in (("w_gate", w_gate, (d, f)), ("w_up", w_up, (d, f)),
                           ("w_down", w_down, (f, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if x.device.type == "cpu":
        return ref.fused_swiglu_ref(x, w_gate, w_up, w_down, activation)
    return _swiglu_cuda(x, w_gate, w_up, w_down, activation)


def _flash_cuda(q, k, v, causal, scale):
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    if d not in (64, 128, 256):
        raise ValueError(f"head dim {d}: the CUDA kernel takes 64, 128 or "
                         "256")
    for name, t, shape in (("q", q, (bh, sq, d)), ("k", k, (bh, sk, d)),
                           ("v", v, (bh, sk, d))):
        _check(name, t, q.dtype, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    _launch("flash_attention", "flash_attention_fwd", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk, d,
            float(scale), int(causal), _LM_DTYPES[q.dtype], _stream(dev))
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """(B, H, S, D) flash attention (online softmax); folds B and H into
    the kernel's grid.  q (B, H, Sq, D), k / v (B, H, Sk, D), f32 or bf16.
    ``scale`` defaults to ``1 / sqrt(D)``.  Causal keeps column j <= row i
    counted from the top-left corner, the TPU kernel's convention.  Any
    Sq >= 0 and Sk >= 1 (the Pallas wrapper asserts multiples of its
    blocks); on the card D is 64, 128 or 256."""
    _lm_operands(("q", "k", "v"), (q, k, v), (4, 4, 4))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, sk, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, h, sk, d)}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    out = _flash_cuda(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
                      v.reshape(b * h, sk, d), causal, scale)
    return out.reshape(b, h, sq, d)


WRAPPERS = (fused_atom_conv, fused_bond_conv, fused_sym_bond_conv, sym_msg,
            sym_accum, fused_force_readout, fused_force_virial_readout,
            fused_segment_sum,
            fused_gated_mlp_packed, fused_rbf, fused_fourier,
            fused_swiglu, flash_attention)
for _fn in WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
