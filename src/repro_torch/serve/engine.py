"""Batched MD serving engine, PyTorch port of ``repro.serve.engine``.

Charge-informed MD is a serving workload: many one-step E/F/sigma
predictions with the direct-force readout.  Three levers over the naive
"rebuild the neighbor list every step" loop:

  1. **Verlet skin reuse** (``core.neighbors.VerletNeighborList``):
     candidate pairs are built once with ``r_cut + skin`` and only
     re-measured per step.
  2. **Multi-replica batching**: independent simulations are stepped as
     one padded batch per capacity bucket — one forward per group.
  3. **A step cache per bucket** keyed on ``(bucket, slots, config)``.

Packing stays on the host; each packed batch goes to the device with
``.to(device)`` and outputs come back with ``.cpu().numpy()`` only when
they are collected.  Inference runs under ``torch.inference_mode()``.
The JAX package's VMEM admission gate has no counterpart: every table
lives in device memory on the GPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.batching import (
    BatchCapacities,
    BatchingEngine,
    CapacityLadder,
    atom_offsets,
    ladder_from_stats,
)
from repro_torch.core.chgnet import CHGNet, CHGNetConfig
from repro_torch.core.neighbors import (
    Crystal,
    GraphIndices,
    VerletNeighborList,
    build_graph,
)


def _next_pow2(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def structure_ladder(
    graphs: list[GraphIndices],
    crystals: list[Crystal],
    *,
    num_buckets: int = 3,
    margin: float = 1.5,
    align: int = 32,
) -> CapacityLadder:
    """Per-structure capacity ladder sized from observed structures.

    ``margin`` leaves headroom for bond/angle-count fluctuation as atoms
    move during MD (the overflow path still catches outliers).
    """
    atoms = np.array([c.num_atoms for c in crystals])
    bonds = np.array([g.num_bonds for g in graphs])
    angles = np.array([g.num_angles for g in graphs])
    return ladder_from_stats(
        atoms, bonds, angles, per_device_batch=1,
        num_buckets=num_buckets, margin=margin, align=align,
    )


class ServeEngine:
    """One-step E/F/sigma/magmom prediction over bucketed padded batches.

    ``params`` is a parameter tree (``chgnet_init`` or
    ``convert.params_from_numpy``); ``device=None`` means the card.
    ``precision`` overrides ``model_cfg.precision`` for serving (DESIGN.md
    §4): MD inference may take ``"mixed"`` (bf16 operands, f32 sums and
    f32 outputs, so integrators see no change); the parameters may stay in
    their training dtype, the model casts them at their use sites.
    """

    def __init__(
        self,
        params: dict,
        model_cfg: CHGNetConfig,
        ladder: CapacityLadder,
        *,
        device=None,
        validate_layout: bool = True,
        precision: str | None = None,
    ):
        if precision is not None:
            model_cfg = model_cfg.with_(precision=precision)
        self.model = CHGNet(model_cfg, params, device=device)
        self.model_cfg = model_cfg
        self.device = self.model.device
        self.engine = BatchingEngine(ladder, validate_layout=validate_layout)

    @classmethod
    def for_structures(
        cls,
        params: dict,
        model_cfg: CHGNetConfig,
        crystals: list[Crystal],
        graphs: list[GraphIndices] | None = None,
        *,
        device=None,
        validate_layout: bool = True,
        precision: str | None = None,
        **ladder_kw,
    ) -> "ServeEngine":
        graphs = graphs or [
            build_graph(c, model_cfg.r_cut_atom, model_cfg.r_cut_bond)
            for c in crystals
        ]
        return cls(params, model_cfg,
                   structure_ladder(graphs, crystals, **ladder_kw),
                   device=device, validate_layout=validate_layout,
                   precision=precision)

    def step_fn(self, caps: BatchCapacities, num_slots: int):
        """Serve step for (bucket, slots, config): a packed CPU batch in,
        device outputs out (not synchronized)."""
        model, device = self.model, self.device
        # the autodiff readout differentiates the energy with respect to
        # the positions and the strain: its batch must not be made of
        # inference tensors, which autograd refuses, so it runs under
        # no_grad (the readout turns autograd on for itself); the direct
        # readout keeps inference_mode
        mode = (torch.no_grad if self.model_cfg.readout == "autodiff"
                else torch.inference_mode)

        def build():
            def step(batch):
                with mode():
                    return model(batch.to(device))
            return step

        return self.engine.step("serve", caps, num_slots, self.model_cfg,
                                build)

    def predict(
        self,
        crystals: list[Crystal],
        graphs: list[GraphIndices] | None = None,
    ) -> dict:
        """Predict E/F/sigma/magmom for a list of structures as one batch.

        Returns host-side per-structure arrays: ``energy`` (R,), ``forces``
        a list of (N_i, 3), ``stress`` (R, 3, 3), ``magmom`` list of (N_i,).
        """
        if graphs is None:
            graphs = [
                build_graph(c, self.model_cfg.r_cut_atom,
                            self.model_cfg.r_cut_bond)
                for c in crystals
            ]
        slots = _next_pow2(len(crystals))
        bucket = self.engine.ladder.bucket_for(
            max(c.num_atoms for c in crystals),
            max(g.num_bonds for g in graphs),
            max(g.num_angles for g in graphs),
        )
        batch, _ = self.engine.pack(
            crystals, graphs, caps=bucket.scaled(slots),
            num_crystal_slots=slots)
        out = {k: x.cpu().numpy()
               for k, x in self.step_fn(bucket, slots)(batch).items()}
        offs = atom_offsets(crystals)
        return {
            "energy": out["energy"][: len(crystals)],
            "forces": [out["forces"][o:o + c.num_atoms]
                       for o, c in zip(offs, crystals)],
            "stress": out["stress"][: len(crystals)],
            "magmom": [out["magmom"][o:o + c.num_atoms]
                       for o, c in zip(offs, crystals)],
        }

    def stats(self) -> dict:
        return self.engine.stats()


@dataclasses.dataclass
class _Replica:
    crystal: Crystal
    velocities: np.ndarray
    nlist: VerletNeighborList
    inv_lattice: np.ndarray


class BatchedMD:
    """Multi-replica MD: independent simulations stepped as padded batches.

    Replicas are grouped per step by their capacity bucket; each group is
    packed into one batch (slots padded to a power of two so the step
    cache stays small) and stepped on the serve engine's device.
    Integration is the toy NVE velocity update of ``repro.serve`` (unit
    masses) — the point is the serving substrate, not the integrator.
    """

    def __init__(
        self,
        serve: ServeEngine,
        crystals: list[Crystal],
        *,
        dt: float = 1e-3,
        skin: float = 0.5,
        max_group: int = 16,
    ):
        self.serve = serve
        self.dt = dt
        self.max_group = max_group
        cfg = serve.model_cfg
        self.replicas = [
            _Replica(
                crystal=c,
                velocities=np.zeros((c.num_atoms, 3)),
                nlist=VerletNeighborList(
                    c, cfg.r_cut_atom, cfg.r_cut_bond, skin
                ),
                inv_lattice=np.linalg.inv(c.lattice),
            )
            for c in crystals
        ]
        self.steps_done = 0

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def groups(self, graphs: list[GraphIndices]):
        """Group replica ids by per-structure bucket, chunked to max_group."""
        ladder = self.serve.engine.ladder
        by_bucket: dict[BatchCapacities, list[int]] = {}
        for i, (r, g) in enumerate(zip(self.replicas, graphs)):
            b = ladder.bucket_for(
                r.crystal.num_atoms, g.num_bonds, g.num_angles
            )
            by_bucket.setdefault(b, []).append(i)
        for bucket, ids in by_bucket.items():
            for s in range(0, len(ids), self.max_group):
                yield bucket, ids[s:s + self.max_group]

    def step(self, n_steps: int = 1) -> dict:
        """Advance every replica ``n_steps``; returns last-step outputs."""
        last = {}
        for _ in range(n_steps):
            graphs = [r.nlist.update(r.crystal) for r in self.replicas]
            energies = np.zeros(self.num_replicas)
            forces_by_replica: list[np.ndarray | None] = \
                [None] * self.num_replicas
            # launch every group first (CUDA launches are asynchronous) so
            # device compute of group k overlaps host packing of group k+1
            dispatched = []
            for bucket, ids in self.groups(graphs):
                crystals = [self.replicas[i].crystal for i in ids]
                slots = _next_pow2(len(ids))
                batch, _ = self.serve.engine.pack(
                    crystals, graphs=[graphs[i] for i in ids],
                    caps=bucket.scaled(slots), num_crystal_slots=slots,
                )
                out = self.serve.step_fn(bucket, slots)(batch)
                dispatched.append((ids, crystals, out))
            # ... then collect (each .cpu() waits for its group)
            for ids, crystals, out in dispatched:
                f = out["forces"].cpu().numpy()
                e = out["energy"].cpu().numpy()
                offs = atom_offsets(crystals)
                for k, i in enumerate(ids):
                    na = crystals[k].num_atoms
                    forces_by_replica[i] = f[offs[k]:offs[k] + na]
                    energies[i] = e[k]
            # toy NVE update (unit masses) — exercises the serve path
            for r, f in zip(self.replicas, forces_by_replica):
                r.velocities += f * self.dt
                cart = r.crystal.cart_coords() + r.velocities * self.dt
                r.crystal.frac_coords = (cart @ r.inv_lattice) % 1.0
            self.steps_done += 1
            last = {"energy": energies, "forces": forces_by_replica}
        return last

    def stats(self) -> dict:
        s = self.serve.stats()
        s.update(
            steps_done=self.steps_done,
            nlist_rebuilds=sum(r.nlist.rebuilds for r in self.replicas),
            nlist_updates=sum(r.nlist.updates for r in self.replicas),
        )
        return s
