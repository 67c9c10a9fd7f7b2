"""Per-crystal step-cost model for load-balanced sharding (DESIGN.md §6),
a copy of ``repro.batching.cost`` (numpy only, so a model fitted by either
package predicts the same costs).

Crystal graphs vary wildly in bond/angle counts, so "equal sample counts
per device" leaves the slowest shard gating every step (the paper's
32-GPU headline depends on fixing exactly this).  The balancer therefore
assigns structures by *predicted compute cost*, the same measured-cost
partitioning that lets spatial MD codes scale (Plimpton 1995):

    cost(crystal) = c0 + c_atoms * atoms + c_bonds * bonds
                       + c_angles * angles

An affine model is the right shape because every hot stage of the step is
linear in one of the three feature counts: embeddings and per-atom heads
in ``atoms``, geometry/RBF/bond-conv in ``bonds``, the Fourier basis and
angle updates in ``angles`` (angles dominate on dense structures).  The
default coefficients reduce to the paper's Fig. 9 load metric
(atoms + bonds + angles); :func:`fit_cost_model` refines them from a few
profiled steps via least squares.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CostModel", "DEFAULT_COST_MODEL", "fit_cost_model"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Affine per-crystal (or per-shard) step-cost predictor.

    Coefficients are unit-free: only *ratios* of predicted costs matter
    to the bin-packer, so a model fitted in seconds and the default
    feature-count model are interchangeable as balancing objectives.
    """

    c0: float = 0.0
    atoms: float = 1.0
    bonds: float = 1.0
    angles: float = 1.0

    def predict(self, n_atoms, n_bonds, n_angles) -> np.ndarray:
        """Vectorized predicted cost; accepts scalars or arrays."""
        return (
            self.c0
            + self.atoms * np.asarray(n_atoms, np.float64)
            + self.bonds * np.asarray(n_bonds, np.float64)
            + self.angles * np.asarray(n_angles, np.float64)
        )

    def predict_dataset(self, ds) -> np.ndarray:
        """Per-sample costs for any dataset with ``crystals``/``graphs``."""
        return self.predict(
            np.array([c.num_atoms for c in ds.crystals]),
            np.array([g.num_bonds for g in ds.graphs]),
            np.array([g.num_angles for g in ds.graphs]),
        )


DEFAULT_COST_MODEL = CostModel()


def fit_cost_model(
    sizes: np.ndarray,
    times: np.ndarray,
    *,
    keep_intercept: bool = True,
) -> CostModel:
    """Least-squares fit of the affine cost model from profiled steps.

    ``sizes``: (K, 3) per-step totals of (atoms, bonds, angles) —
    *real* counts, not padded capacities; ``times``: (K,) measured step
    seconds.  Negative coefficients (possible when the probe steps don't
    separate the features) are clamped to zero, so the fitted model can
    never rank a strictly larger structure as cheaper.  Needs K >= 4
    distinct step shapes for a full-rank fit; with fewer the lstsq
    minimum-norm solution still yields a usable (if degenerate) model.
    """
    sizes = np.asarray(sizes, np.float64)
    times = np.asarray(times, np.float64)
    if sizes.ndim != 2 or sizes.shape[1] != 3:
        raise ValueError(f"sizes must be (K, 3), got {sizes.shape}")
    if times.shape != (sizes.shape[0],):
        raise ValueError(
            f"times shape {times.shape} != ({sizes.shape[0]},)")
    cols = [sizes[:, 0], sizes[:, 1], sizes[:, 2]]
    if keep_intercept:
        cols.insert(0, np.ones(sizes.shape[0]))
    a_mat = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(a_mat, times, rcond=None)
    coef = np.maximum(coef, 0.0)
    if keep_intercept:
        c0, ca, cb, cg = coef
    else:
        c0, (ca, cb, cg) = 0.0, coef
    return CostModel(c0=float(c0), atoms=float(ca), bonds=float(cb),
                     angles=float(cg))
