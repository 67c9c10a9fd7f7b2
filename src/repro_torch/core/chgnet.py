"""CHGNet / FastCHGNet model (paper §II-B, §III), PyTorch port of
``repro.core.chgnet``.

``chgnet_init`` builds the parameter tree (nested dicts and lists of
tensors, the names and layout of the JAX package's pytree) and
``chgnet_apply`` runs the forward pass with the direct Force/Stress heads
(FastCHGNet C1), the bond-virial stress (DESIGN.md §7) or the autodiff
readout of reference CHGNet.  ``CHGNet`` wraps the same tree as an
``nn.Module`` whose parameter names follow it (``blocks.0.atom_mlp.w``,
...).

``CHGNetConfig`` mirrors the JAX config field for field; every tier runs
at every precision.  ``table_residency`` is a TPU mechanic and is
accepted and ignored.

``precision`` selects the policy of ``repro_torch.precision`` (DESIGN.md
§4): parameters are stored in its ``param`` dtype (``rbf_freqs`` always
f32), the geometry and the bases run in f32 and are cast to the compute
dtype before the embeddings, the masks take the features' dtype, and the
outputs are cast to the ``output`` dtype.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.ref import gather_rows
from repro_torch.optim.tree import leaves
from repro_torch.precision import cast_float_tree, resolve_policy
from . import basis, heads
from .graph import CrystalGraphBatch
from .interaction import (
    atom_conv,
    interaction_block_apply,
    interaction_block_init,
    linear_apply,
    linear_init,
)

MAX_Z = 95  # elements supported (MPtrj has 89)


@dataclasses.dataclass(frozen=True)
class CHGNetConfig:
    """Model + implementation-tier selection (see ``repro.core.chgnet``)."""

    dim: int = 64
    num_rbf: int = 31
    num_fourier: int = 31
    num_blocks: int = 3          # full interaction blocks (+1 final atom conv)
    r_cut_atom: float = 6.0
    r_cut_bond: float = 3.0
    envelope_p: int = 8
    readout: str = "direct"      # "direct" (F/S heads) | "autodiff" (reference)
    block_variant: str = "fast"  # "fast" (dep. elimination) | "reference"
    mlp_impl: str = "packed"     # "ref" | "packed" | "pallas"
    agg_impl: str = "scatter"    # "scatter" | "matmul" | "sorted" | "pallas"
    # "fused": one hand-written kernel per conv and for the direct force
    # readout (DESIGN.md §3); requires the §1 sorted-segment layout
    conv_impl: str = "unfused"   # "unfused" | "fused"
    bond_store: str = "directed"  # "directed" | "undirected"
    envelope_impl: str = "factored"  # "factored" | "reference"
    precision: str = "f32"       # "f32" | "bf16" | "mixed"
    stress_mode: str = "mlp"     # "mlp" | "bond_virial"
    stress_scale: float = 0.1
    # TPU operand-table residency (DESIGN.md §9): accepted so configs carry
    # over, ignored — every table sits in device memory on the GPU
    table_residency: str = "auto"  # "auto" | "vmem" | "hbm"
    bond_features: str = "directed"  # "directed" | "undirected"

    def __post_init__(self):
        if self.bond_features not in ("directed", "undirected"):
            raise ValueError(
                f"bond_features must be 'directed' or 'undirected', "
                f"got {self.bond_features!r}")
        if self.bond_features == "undirected" and \
                self.bond_store != "undirected":
            raise ValueError(
                'bond_features="undirected" (the symmetric half-graph '
                "trunk, DESIGN.md §10) requires the undirected bond store: "
                'pass bond_store="undirected" as well — the bond_pair / '
                "angle_pair mirror maps are its compute indices, got "
                f"bond_store={self.bond_store!r}")

    def with_(self, **kw) -> "CHGNetConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """``None`` means the card; without CUDA that is an error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def chgnet_init(seed: int | torch.Generator, cfg: CHGNetConfig) -> dict:
    """Parameter tree (on the CPU) from a seed or a ``torch.Generator``,
    drawn in f32 and stored in ``cfg.precision``'s param dtype, except
    ``rbf_freqs``: they feed the f32 basis and stay f32 under every
    policy (a bf16 round trip would move them by ~0.4% a step)."""
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(seed)
    params = {
        # the three bond linears are packed into one (num_rbf -> 3*dim)
        # weight (Fig. 3a): [e^0 | e^a | e^b]
        "atom_embed": torch.randn((MAX_Z, cfg.dim), generator=gen) * 0.02,
        "bond_embed": linear_init(gen, cfg.num_rbf, 3 * cfg.dim),
        "angle_embed": linear_init(gen, cfg.num_fourier, cfg.dim),
        "rbf_freqs": basis.rbf_frequencies(cfg.num_rbf),
        "blocks": [interaction_block_init(gen, cfg.dim)
                   for _ in range(cfg.num_blocks)],
        # final block: atom conv only (CHGNet v0.3.0 has a last atom update)
        "final_block": interaction_block_init(gen, cfg.dim),
        "energy_head": heads.energy_head_init(gen, cfg.dim),
        "magmom_head": heads.magmom_head_init(gen, cfg.dim),
    }
    if cfg.readout == "direct":
        params["force_head"] = heads.force_head_init(gen, cfg.dim)
        if cfg.stress_mode == "mlp":
            params["stress_head"] = heads.stress_head_init(
                gen, cfg.dim, cfg.stress_scale)
        # stress_mode="bond_virial" shares the force head's n_ij: that
        # tier has no stress parameters (DESIGN.md §7)
    param = resolve_policy(cfg.precision).param
    if param != torch.float32:
        freqs = params.pop("rbf_freqs")
        params = dict(cast_float_tree(params, param), rbf_freqs=freqs)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed(params, cfg: CHGNetConfig, graph: CrystalGraphBatch, *,
          displacement=None, strain=None):
    """Geometry, bases and feature embedding (Eq. 2).

    Returns ``(v, e, a, e_a, e_b, vec, dist, vec_und, dist_und)``: atom,
    bond and angle features, the two envelope tables, the directed bond
    geometry the heads read and, on the undirected store, its once-per-pair
    geometry (else ``None``).  The envelope tables are made contiguous once
    here, because every block's kernels read them row by row.
    ``mlp_impl="pallas"`` takes the bases from their kernels, whose
    envelope is always the factored one, as in the JAX package.
    ``displacement`` / ``strain`` perturb the geometry for the autodiff
    readout.  The geometry and the bases are f32; the features from the
    embeddings on, and the masks that multiply them, are in the policy's
    compute dtype (DESIGN.md §4).

    ``bond_store="undirected"`` (DESIGN.md §5): the RBF and the bond
    embedding run once per undirected pair (Eu rows), the Fourier basis
    and the angle embedding once per angle-pair dedup row (Au rows); e^a
    and e^b stay at Eu.  With ``bond_features="directed"`` e and a expand
    to the directed rows through ``bond_pair`` / ``angle_pair``; with
    ``"undirected"`` (§10) e stays at Eu and a at Au.
    """
    undirected = cfg.bond_store == "undirected"
    if undirected:
        vec_und, dist_und, vec, dist, _cos, theta = \
            basis.compute_geometry_undirected(
                graph, displacement=displacement, strain=strain,
                angle_rows="undirected")
        rbf_dist = dist_und
    elif cfg.bond_store == "directed":
        vec, dist, _cos, theta = basis.compute_geometry(
            graph, displacement=displacement, strain=strain)
        vec_und = dist_und = None
        rbf_dist = dist
    else:
        raise ValueError(f"unknown bond store {cfg.bond_store!r}")
    if cfg.mlp_impl == "pallas":
        from repro_torch.kernels import ops as kops

        rbf = kops.fused_rbf(rbf_dist, params["rbf_freqs"], cfg.r_cut_atom,
                             cfg.envelope_p)
        four = kops.fused_fourier(theta, cfg.num_fourier)
    else:
        env = (basis.envelope_factored if cfg.envelope_impl == "factored"
               else basis.envelope_reference)
        rbf = basis.smooth_rbf(rbf_dist, params["rbf_freqs"], cfg.r_cut_atom,
                               cfg.envelope_p, envelope=env)
        four = basis.fourier_basis(theta, cfg.num_fourier)
    # the precision boundary: f32 geometry and bases above, the compute
    # dtype from the embeddings on
    cd = resolve_policy(cfg.precision).compute
    rbf, four = rbf.to(cd), four.to(cd)

    def mask(m):
        return m[..., None].to(cd)

    packed = linear_apply(params["bond_embed"], rbf)  # (Nb or Eu, 3*dim)
    e0, e_a, e_b = packed.chunk(3, dim=-1)
    v = gather_rows(params["atom_embed"].to(cd), graph.atom_z) \
        * mask(graph.atom_mask)
    a = linear_apply(params["angle_embed"], four)
    if undirected:
        umask = mask(graph.und_mask)
        e_a, e_b = e_a * umask, e_b * umask
        a = a * mask(graph.und_angle_mask)
        if cfg.bond_features == "undirected":
            e = e0 * umask
        else:
            # padded angles and bonds carry pair 0: re-mask after expanding
            a = gather_rows(a, graph.angle_pair) * mask(graph.angle_mask)
            e = gather_rows(e0, graph.bond_pair) * mask(graph.bond_mask)
    else:
        a = a * mask(graph.angle_mask)
        e = e0 * mask(graph.bond_mask)
    return (v, e, a, e_a.contiguous(), e_b.contiguous(), vec, dist, vec_und,
            dist_und)


def _trunk(params, cfg: CHGNetConfig, graph: CrystalGraphBatch, *,
           displacement=None, strain=None):
    v, e, a, e_a, e_b, vec, dist, vec_und, dist_und = embed(
        params, cfg, graph, displacement=displacement, strain=strain)
    for blk in params["blocks"]:
        v, e, a = interaction_block_apply(
            blk, graph, v, e, a, e_a, e_b,
            variant=cfg.block_variant,
            mlp_impl=cfg.mlp_impl,
            agg_impl=cfg.agg_impl,
            conv_impl=cfg.conv_impl,
            bond_store=cfg.bond_store,
            bond_features=cfg.bond_features,
        )
    # last block updates atoms only (matches CHGNet's final atom conv)
    v = atom_conv(params["final_block"], graph, v, e, e_a,
                  mlp_impl=cfg.mlp_impl, agg_impl=cfg.agg_impl,
                  conv_impl=cfg.conv_impl, bond_store=cfg.bond_store,
                  bond_features=cfg.bond_features)
    return v, e, a, vec, dist, vec_und, dist_und


def _autodiff_readout(params, cfg: CHGNetConfig, graph: CrystalGraphBatch):
    """Energy, and forces and stress as its derivatives (reference CHGNet):
    F = -dE/dx and sigma = dE/d(strain) / V, with x displaced by zeros
    (atom_cap, 3) and the lattice strained by zeros (B, 3, 3).

    Autograd is on for the trunk whatever the caller's grad mode, so the
    readout also runs under ``torch.no_grad()`` (serving, evaluation).
    The derivative's own graph is kept only where a loss will be
    differentiated through it: grad mode on and parameters that record
    gradients (a training step's second-order backward); otherwise the
    outputs come back detached.
    """
    create = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params))
    with torch.enable_grad():
        disp = torch.zeros_like(graph.frac_coords, requires_grad=True)
        strain = torch.zeros_like(graph.lattice, requires_grad=True)
        v = _trunk(params, cfg, graph, displacement=disp, strain=strain)[0]
        energy = heads.energy_head_apply(params["energy_head"], graph, v)
        de_ddisp, de_dstrain = torch.autograd.grad(
            energy.sum(), (disp, strain), create_graph=create)
    if not create:
        v, energy = v.detach(), energy.detach()
    magmom = heads.magmom_head_apply(params["magmom_head"], graph, v)
    forces = -de_ddisp * graph.atom_mask[..., None]
    vol = torch.abs(torch.linalg.det(graph.lattice))[:, None, None]
    stress = de_dstrain / (vol + 1e-12) * heads.EV_A3_TO_GPA
    stress = stress * graph.crystal_mask[:, None, None]
    return {"energy": energy, "forces": forces, "stress": stress,
            "magmom": magmom}


def chgnet_apply(params, cfg: CHGNetConfig, graph: CrystalGraphBatch):
    """Energy (B,), forces (A,3), stress (B,3,3), magmom (A,), in the
    policy's output dtype (f32 under every built-in policy).

    ``readout="direct"``: one forward pass with the direct Force/Stress
    heads (FastCHGNet); ``stress_mode="bond_virial"`` takes the stress
    from the force head's per-bond scalars (DESIGN.md §7).
    ``readout="autodiff"``: forces and stress by differentiating the
    energy (reference CHGNet), so training through them is second order.
    The outputs are differentiable with respect to ``params`` (training
    backpropagates through the kernels' recompute backwards).  ``params``
    and ``graph`` must be on the same device.
    """
    out = resolve_policy(cfg.precision).output
    if cfg.readout == "autodiff":
        return {k: x.to(out) for k, x in
                _autodiff_readout(params, cfg, graph).items()}
    if cfg.readout != "direct":
        raise ValueError(f"unknown readout {cfg.readout!r}")
    v, e, _a, vec, dist, vec_und, dist_und = _trunk(params, cfg, graph)
    if cfg.bond_features == "undirected":
        # the heads read per-directed-bond features: expand the Eu-resident
        # e once, at the heads boundary (DESIGN.md §10)
        e = gather_rows(e, graph.bond_pair) \
            * graph.bond_mask[..., None].to(e.dtype)
    energy = heads.energy_head_apply(params["energy_head"], graph, v)
    magmom = heads.magmom_head_apply(params["magmom_head"], graph, v)
    if cfg.stress_mode == "bond_virial":
        forces, stress = heads.force_virial_head_apply(
            params["force_head"], graph, e, vec, dist,
            vec_und=vec_und, dist_und=dist_und,
            agg_impl=cfg.agg_impl, conv_impl=cfg.conv_impl,
            bond_store=cfg.bond_store)
    elif cfg.stress_mode == "mlp":
        forces = heads.force_head_apply(
            params["force_head"], graph, e, vec, dist,
            agg_impl=cfg.agg_impl, conv_impl=cfg.conv_impl)
        stress = heads.stress_head_apply(params["stress_head"], graph, v)
    else:
        raise ValueError(f"unknown stress mode {cfg.stress_mode!r}")
    return {"energy": energy.to(out), "forces": forces.to(out),
            "stress": stress.to(out), "magmom": magmom.to(out)}


def param_count(params) -> int:
    """Number of elements over the tree's tensor leaves."""
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------------------
# nn.Module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A dict of the parameter tree as a module: tensors become
    parameters, dicts sub-modules, lists ``nn.ModuleList``s of them."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, val in tree.items():
            if isinstance(val, dict):
                self.add_module(k, _Tree(val))
            elif isinstance(val, list):
                self.add_module(k, nn.ModuleList(_Tree(x) for x in val))
            else:
                self.register_parameter(k, nn.Parameter(val))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = [x.tree() for x in m] if isinstance(m, nn.ModuleList) \
                else m.tree()
        return out


class CHGNet(_Tree):
    """FastCHGNet as an ``nn.Module``.

    ``params`` is a parameter tree (``chgnet_init`` or
    ``convert.params_from_numpy``); without it the model is initialized
    from ``seed``.  ``device=None`` means the card.  ``tree()`` returns
    the parameters as nested dicts and lists of tensors.
    """

    def __init__(self, cfg: CHGNetConfig, params: dict | None = None, *,
                 seed: int = 0, device=None):
        device = resolve_device(device)
        super().__init__(params if params is not None
                         else chgnet_init(seed, cfg))
        self.cfg = cfg
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.rbf_freqs.device

    def forward(self, graph: CrystalGraphBatch) -> dict:
        return chgnet_apply(self.tree(), self.cfg, graph)
