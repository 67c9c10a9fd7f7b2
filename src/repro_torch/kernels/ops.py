"""Public wrappers of the hand-written CUDA kernels.

Each wrapper has the calling convention of its ``repro.kernels.ops``
counterpart and picks its path from the device of the tensors it is
given:

  - CPU tensors go to the plain PyTorch version in ``kernels.ref``;
  - CUDA tensors launch the kernel, after checking device, dtype (f32
    features, int32 ids), contiguity and shapes, or raise.  There is no
    fallback from the card to the plain version.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, incremented only where the kernel is launched.

The wrappers are forward-only so far: an input that would record a
gradient raises, so that no caller silently gets none.  The mirror-map
operands of the undirected bond store (``pair``) and the symmetric trunk
(``und_features``) are not ported yet.
"""
from __future__ import annotations

import torch

from . import build, ref

_LIB = "message_passing"


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("backward: next slice")


def _no_mirror(pair, und_features: bool) -> None:
    if pair is not None:
        raise NotImplementedError(
            "pair= (undirected bond store) is ROADMAP 'Modules to port' "
            "item 5")
    if und_features:
        raise NotImplementedError(
            "und_features= (symmetric trunk) is ROADMAP 'Modules to port' "
            "item 6")


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


def _check_dim(dim: int) -> None:
    # float4 row loads need dim % 4 == 0; the bond conv's shared-memory
    # tile, 32 * 6 * dim floats, must stay within a block's 227 KB
    if dim % 4 or not 0 < dim <= 256:
        raise ValueError(f"feature width {dim} must be a multiple of 4 in "
                         "[4, 256] for the CUDA kernels")


def _launch(fn: str, *args) -> None:
    err = build.entry(_LIB, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_atom_conv(v, e, e_a, w, b, ln_scale, ln_bias,
                    bond_center, bond_nbr, bond_offsets,
                    *, pair=None, und_features: bool = False,
                    block_rows: int = 1):
    """Fused Eq. 4 message path: sum_j e^a_ij * phi(v_i, v_j, e_ij) -> (A, D).

    Requires the sorted-segment layout (DESIGN.md §1): bonds sorted by
    ``bond_center`` with CSR ``bond_offsets`` whose last entry is the
    real-bond count.  ``block_rows`` atom rows go to one CUDA block.
    """
    _no_mirror(pair, und_features)
    _forward_only(v, e, e_a, w, b, ln_scale, ln_bias)
    if v.device.type == "cpu":
        return ref.fused_atom_conv_ref(v, e, e_a, w, b, ln_scale, ln_bias,
                                       bond_center, bond_nbr, bond_offsets)
    a_rows, dim = v.shape
    n_edges = bond_center.shape[0]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _check_dim(dim)
    for name, t, dt, shape in (
            ("v", v, f32, (a_rows, dim)), ("e", e, f32, (n_edges, dim)),
            ("e_a", e_a, f32, (n_edges, dim)),
            ("w", w, f32, (3 * dim, 2 * dim)), ("b", b, f32, (2 * dim,)),
            ("ln_scale", ln_scale, f32, (2 * dim,)),
            ("ln_bias", ln_bias, f32, (2 * dim,)),
            ("bond_center", bond_center, i32, (n_edges,)),
            ("bond_nbr", bond_nbr, i32, (n_edges,)),
            ("bond_offsets", bond_offsets, i32, (a_rows + 1,))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((a_rows, dim), dtype=f32, device=dev)
    _launch("atom_conv_fwd", v.data_ptr(), e.data_ptr(), e_a.data_ptr(),
            w.data_ptr(), b.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), bond_center.data_ptr(), bond_nbr.data_ptr(),
            bond_offsets.data_ptr(), out.data_ptr(), a_rows, dim, block_rows,
            _stream(dev))
    fused_atom_conv.launches += 1
    return out


def fused_bond_conv(v, e, a, e_b, w, b, ln_scale, ln_bias,
                    angle_ij, angle_ik, center_ids, angle_offsets,
                    *, pair=None, block_rows: int = 32):
    """Fused Eq. 5 message path:
    sum_k e^b_ij e^b_ik phi(v_c, e_ij, e_ik, a_ijk) -> (E, D).

    ``center_ids = bond_center[angle_ij]`` (a cheap int gather the caller
    performs).  Requires angles sorted by ``angle_ij`` with CSR
    ``angle_offsets`` (DESIGN.md §1).  Few angles fall on each bond, so
    ``block_rows`` bond rows share one CUDA block.
    """
    _no_mirror(pair, False)
    _forward_only(v, e, a, e_b, w, b, ln_scale, ln_bias)
    if v.device.type == "cpu":
        return ref.fused_bond_conv_ref(v, e, a, e_b, w, b, ln_scale,
                                       ln_bias, angle_ij, angle_ik,
                                       center_ids, angle_offsets)
    a_rows, dim = v.shape
    b_rows = e.shape[0]
    n_ang = angle_ij.shape[0]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _check_dim(dim)
    for name, t, dt, shape in (
            ("v", v, f32, (a_rows, dim)), ("e", e, f32, (b_rows, dim)),
            ("a", a, f32, (n_ang, dim)), ("e_b", e_b, f32, (b_rows, dim)),
            ("w", w, f32, (4 * dim, 2 * dim)), ("b", b, f32, (2 * dim,)),
            ("ln_scale", ln_scale, f32, (2 * dim,)),
            ("ln_bias", ln_bias, f32, (2 * dim,)),
            ("angle_ij", angle_ij, i32, (n_ang,)),
            ("angle_ik", angle_ik, i32, (n_ang,)),
            ("center_ids", center_ids, i32, (n_ang,)),
            ("angle_offsets", angle_offsets, i32, (b_rows + 1,))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((b_rows, dim), dtype=f32, device=dev)
    _launch("bond_conv_fwd", v.data_ptr(), e.data_ptr(), a.data_ptr(),
            e_b.data_ptr(), w.data_ptr(), b.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), angle_ij.data_ptr(), angle_ik.data_ptr(),
            center_ids.data_ptr(), angle_offsets.data_ptr(), out.data_ptr(),
            b_rows, dim, block_rows, _stream(dev))
    fused_bond_conv.launches += 1
    return out


def fused_force_readout(e, x_hat, w1, b1, w2, b2, bond_center, bond_offsets,
                        num_atoms: int, *, block_rows: int = 1):
    """Fused Eq. 7 direct-force readout: F_i = sum_j n_ij x_hat_ij -> (A, 3).

    The per-bond scalar MLP (w1/b1 -> silu -> w2/b2), the x_hat weighting
    and the per-atom reduction run in one kernel over the sorted CSR rows;
    ``n_ij`` never reaches device memory.  The kernel walks rows by
    ``bond_offsets``; ``bond_center`` is checked and used only by the
    plain version.
    """
    _forward_only(e, x_hat, w1, b1, w2, b2)
    if e.device.type == "cpu":
        return ref.fused_force_readout_ref(e, x_hat, w1, b1, w2, b2,
                                           bond_center, bond_offsets,
                                           num_atoms)
    n_edges, dim = e.shape
    dev, f32, i32 = e.device, torch.float32, torch.int32
    _check_dim(dim)
    for name, t, dt, shape in (
            ("e", e, f32, (n_edges, dim)), ("x_hat", x_hat, f32, (n_edges, 3)),
            ("w1", w1, f32, (dim, dim)), ("b1", b1, f32, (dim,)),
            ("w2", w2, f32, (dim, 1)), ("b2", b2, f32, (1,)),
            ("bond_center", bond_center, i32, (n_edges,)),
            ("bond_offsets", bond_offsets, i32, (num_atoms + 1,))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((num_atoms, 3), dtype=f32, device=dev)
    _launch("force_readout_fwd", e.data_ptr(), x_hat.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            bond_offsets.data_ptr(), out.data_ptr(), num_atoms, dim,
            block_rows, _stream(dev))
    fused_force_readout.launches += 1
    return out


WRAPPERS = (fused_atom_conv, fused_bond_conv, fused_force_readout)
for _fn in WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
