"""Multi-target Huber loss (paper §IV: prefactors E:2, F:1.5, S:0.1, M:0.1),
PyTorch port of ``repro.core.losses``.

Energy is supervised per atom; every reduction is mask-aware, so padding
never contributes.  Predictions and targets are upcast to f32 before the
error terms and reduced in f32 (DESIGN.md §4).

``chgnet_loss`` is the mean-reduced loss of one batch.  The accumulation
path (DESIGN.md §6) divides each microbatch's masked sums by the
denominators of the whole step (``global_denominators``), so that
microbatch losses and gradients add up to the big-batch ones
(``chgnet_loss_sums``, ``metrics_from_sums``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import CrystalGraphBatch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    energy: float = 2.0
    force: float = 1.5
    stress: float = 0.1
    magmom: float = 0.1
    huber_delta: float = 0.1


def huber(x, delta):
    absx = torch.abs(x)
    quad = 0.5 * x * x
    lin = delta * (absx - 0.5 * delta)
    return torch.where(absx <= delta, quad, lin)


def _masked_mean(x, mask):
    x = x.float()
    mask = mask.float()
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _error_terms(pred: dict, graph: CrystalGraphBatch):
    """Masked f32 error terms shared by the mean- and sum-reduced losses."""
    n = torch.clamp(graph.n_atoms_per_crystal.float(), min=1.0)
    e_err = (pred["energy"].float() - graph.energy.float()) / n  # eV/atom
    f_err = pred["forces"].float() - graph.forces.float()
    s_err = pred["stress"].float() - graph.stress.float()
    m_err = pred["magmom"].float() - graph.magmoms.float()

    cmask = graph.crystal_mask
    amask = graph.atom_mask
    fmask = amask[..., None] * torch.ones_like(f_err)
    smask = cmask[:, None, None] * torch.ones_like(s_err)
    return (e_err, cmask), (f_err, fmask), (s_err, smask), (m_err, amask)


def chgnet_loss(pred: dict, graph: CrystalGraphBatch, w: LossWeights):
    """Returns (scalar loss, metrics dict with per-target MAEs)."""
    (e_err, cmask), (f_err, fmask), (s_err, smask), (m_err, amask) = \
        _error_terms(pred, graph)

    l_e = _masked_mean(huber(e_err, w.huber_delta), cmask)
    l_f = _masked_mean(huber(f_err, w.huber_delta), fmask)
    l_s = _masked_mean(huber(s_err, w.huber_delta), smask)
    l_m = _masked_mean(huber(m_err, w.huber_delta), amask)
    loss = w.energy * l_e + w.force * l_f + w.stress * l_s + w.magmom * l_m

    metrics = {
        "loss": loss,
        "mae_e_per_atom": _masked_mean(torch.abs(e_err), cmask),
        "mae_f": _masked_mean(torch.abs(f_err), fmask),
        "mae_s": _masked_mean(torch.abs(s_err), smask),
        "mae_m": _masked_mean(torch.abs(m_err), amask),
    }
    return loss, metrics


def global_denominators(num_crystals: int, num_atoms: int) -> dict:
    """Loss denominators of a global batch with these real counts: the mask
    totals of ``_masked_mean`` (crystals, 3 x atoms, 9 x crystals, atoms),
    each at least 1."""
    c = float(max(num_crystals, 1))
    a = float(max(num_atoms, 1))
    return {
        "energy": np.float32(c),
        "force": np.float32(3.0 * a),
        "stress": np.float32(9.0 * c),
        "magmom": np.float32(a),
    }


def chgnet_loss_sums(pred: dict, graph: CrystalGraphBatch, w: LossWeights,
                     denoms: dict):
    """Partial loss of one microbatch against the step's denominators.

    Returns ``(loss, sums)``: the masked Huber sums over ``denoms``, so
    that losses and gradients add up exactly across the microbatches of
    one step, and the absolute-error sums for ``metrics_from_sums``.
    """
    (e_err, cmask), (f_err, fmask), (s_err, smask), (m_err, amask) = \
        _error_terms(pred, graph)

    def msum(x, mask):
        return torch.sum(x.float() * mask.float())

    d = {k: float(v) for k, v in denoms.items()}
    loss = (
        w.energy * msum(huber(e_err, w.huber_delta), cmask) / d["energy"]
        + w.force * msum(huber(f_err, w.huber_delta), fmask) / d["force"]
        + w.stress * msum(huber(s_err, w.huber_delta), smask) / d["stress"]
        + w.magmom * msum(huber(m_err, w.huber_delta), amask) / d["magmom"]
    )
    sums = {
        "loss": loss,
        "abs_e": msum(torch.abs(e_err), cmask),
        "abs_f": msum(torch.abs(f_err), fmask),
        "abs_s": msum(torch.abs(s_err), smask),
        "abs_m": msum(torch.abs(m_err), amask),
    }
    return loss, sums


def metrics_from_sums(sums: dict, denoms: dict) -> dict:
    """Accumulated microbatch sums -> the ``chgnet_loss`` metrics dict."""
    d = {k: float(v) for k, v in denoms.items()}
    return {
        "loss": sums["loss"],
        "mae_e_per_atom": sums["abs_e"] / d["energy"],
        "mae_f": sums["abs_f"] / d["force"],
        "mae_s": sums["abs_s"] / d["stress"],
        "mae_m": sums["abs_m"] / d["magmom"],
    }
