"""Plain PyTorch CHGNet / FastCHGNet: the benchmark's reference model.

Written from the papers (Deng et al., CHGNet, Nat. Mach. Intell. 2023;
FastCHGNet, Eqs. 2-11): no kernel, no padding, no batching tricks, only
the real atoms, bonds and angles of ``graph.concat``.  It imports nothing
of the program.  The parameter tree has the program's names and shapes,
so both sides take one tree made by the benchmark from the seed.

  - Embedding (Eq. 2): v = W_z[z]; [e | e^a | e^b] = sRBF(r) W + b with
    sRBF_n(r) = sqrt(2/rc) sin(f_n r/rc)/r u(r/rc) and the smooth
    envelope u(x) = 1 - x^p/2 [(p+1)(p+2) - 2p(p+2) x + p(p+1) x^2]
    (Eq. 13); a = FT(theta) W + b, FT = [1/sqrt2, cos n theta,
    sin n theta]/sqrt(pi).
  - GatedMLP phi(x) = silu(LN(x Wc + bc)) sigmoid(LN(x Wg + bg)), the two
    weights stored side by side as w = [Wc | Wg].
  - Interaction block, dependency-eliminated ("fast", Eq. 11): every
    update reads the layer-t features:
      v_i += L_v(sum_j e^a_ij phi_v([v_i, v_j, e_ij]))             (Eq. 4)
      e_ij += L_e(sum_k e^b_ij e^b_ik phi_e([v_i, e_ij, e_ik, a]))  (Eq. 5)
      a_ijk += phi_a([v_i, e_ij, e_ik, a_ijk])                       (Eq. 6)
    then a last atom update (CHGNet v0.3.0's final atom conv).
  - Readout "direct" (FastCHGNet C1): E = sum_i MLP(v_i); F_i =
    sum_j MLP(e_ij) x_hat_ij (Eq. 7); sigma = scale sum_i MLP9(v_i) *
    N(L), N = s s^T, s = sum_a L_a/|L_a| (Eq. 9); m_i = |MLP(v_i)|.
    Readout "autodiff" (CHGNet): F = -dE/dx, sigma = dE/d(strain)/V.
  - Loss: Huber (delta 0.1) on energy per atom, forces, stress and
    magmoms, weighted 2 / 1.5 / 0.1 / 0.1, each a mean over real entries.

``tf32=True`` computes every matrix product on operands rounded to TF32
(10-bit mantissa, round to nearest even) and sums in f32, forward and
backward alike: the control that must come out wrong.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EV_A3_TO_GPA = 160.21766
MAX_Z = 95


# -- parameters --------------------------------------------------------------

def _linear(d_in, d_out):
    return {"w": ("randn", (d_in, d_out), math.sqrt(2.0 / (d_in + d_out))),
            "b": ("zeros", (d_out,))}


def _gated(d_in, d):
    # each half glorot-scaled with fan-out d
    return {"w": ("randn", (d_in, 2 * d), math.sqrt(2.0 / (d_in + d))),
            "b": ("zeros", (2 * d,)), "ln_scale": ("ones", (2 * d,)),
            "ln_bias": ("zeros", (2 * d,))}


def _mlp(dims):
    return [_linear(a, b) for a, b in zip(dims[:-1], dims[1:])]


def _block(d):
    return {"atom_mlp": _gated(3 * d, d), "atom_out": _linear(d, d),
            "bond_mlp": _gated(4 * d, d), "bond_out": _linear(d, d),
            "angle_mlp": _gated(4 * d, d)}


def param_template(model: dict) -> dict:
    """The tree of (kind, shape, ...) specs that ``init_params`` fills."""
    d = model["dim"]
    tree = {
        "atom_embed": ("randn", (MAX_Z, d), 0.02),
        "bond_embed": _linear(model["num_rbf"], 3 * d),
        "angle_embed": _linear(model["num_fourier"], d),
        "rbf_freqs": ("freqs", (model["num_rbf"],)),
        "blocks": [_block(d) for _ in range(model["num_blocks"])],
        "final_block": _block(d),
        "energy_head": {"mlp": _mlp((d, d, d, 1))},
        "magmom_head": {"mlp": _mlp((d, d, 1))},
    }
    if model["readout"] == "direct":
        tree["force_head"] = {"mlp": _mlp((d, d, 1))}
        tree["stress_head"] = {"mlp": _mlp((d, d, 9)),
                               "scale": ("const", (), model["stress_scale"])}
    return tree


def leaves(tree) -> list:
    """Leaves in sorted-key order of dicts, list order of lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def init_params(model: dict, seed: int, device) -> dict:
    """Parameters from ``seed``: every random leaf cut from one normal
    draw of a generator on ``device``."""
    tmpl = param_template(model)
    specs = leaves(tmpl)
    sizes = [math.prod(s[1]) for s in specs if s[0] == "randn"]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = iter(torch.randn(sum(sizes), generator=gen, device=device)
                .split(sizes))
    out = []
    for s in specs:
        kind, shape = s[0], s[1]
        if kind == "randn":
            out.append(next(draw).reshape(shape) * s[2])
        elif kind == "zeros":
            out.append(torch.zeros(shape, device=device))
        elif kind == "ones":
            out.append(torch.ones(shape, device=device))
        elif kind == "freqs":
            out.append(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                    device=device) * math.pi)
        else:
            out.append(torch.tensor(float(s[2]), device=device))
    return unflatten(tmpl, out)


# -- products ----------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """x @ w on TF32-rounded operands, f32 sums; its backward is made of
    the same products, so a double backward stays in TF32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return round_tf32(x) @ round_tf32(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (_TF32Product.apply(g, w.transpose(-1, -2)),
                _TF32Product.apply(x.transpose(-1, -2), g))


def product(x, w, tf32: bool):
    return _TF32Product.apply(x, w) if tf32 else x @ w


# -- model -------------------------------------------------------------------

class Model:
    """The forward pass of one configuration (``model`` dict of the
    config file), f32 products, or TF32 ones with ``tf32``."""

    def __init__(self, model: dict, tf32: bool = False):
        if model["block_variant"] != "fast":
            raise ValueError("the reference runs the fast block variant")
        self.m = model
        self.tf32 = tf32

    def linear(self, p, x):
        return product(x, p["w"], self.tf32) + p["b"]

    def mlp(self, layers, x):
        for i, p in enumerate(layers):
            x = self.linear(p, x)
            if i < len(layers) - 1:
                x = F.silu(x)
        return x

    @staticmethod
    def layer_norm(x, scale, bias):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * scale + bias

    def gated(self, p, x):
        d = p["w"].shape[1] // 2
        y = product(x, p["w"], self.tf32) + p["b"]
        core = self.layer_norm(y[:, :d], p["ln_scale"][:d], p["ln_bias"][:d])
        gate = self.layer_norm(y[:, d:], p["ln_scale"][d:], p["ln_bias"][d:])
        return F.silu(core) * torch.sigmoid(gate)

    @staticmethod
    def seg_sum(values, ids, n):
        return values.new_zeros((n,) + values.shape[1:]).index_add(0, ids,
                                                                   values)

    def atom_update(self, p, g, v, e, e_a):
        x = torch.cat([v[g["center"]], v[g["nbr"]], e], dim=-1)
        msg = self.gated(p["atom_mlp"], x) * e_a
        return v + self.linear(p["atom_out"],
                               self.seg_sum(msg, g["center"], v.shape[0]))

    def trunk(self, p, g, lattice, cart):
        m = self.m
        shift = torch.einsum("ei,eij->ej", g["image"],
                             lattice[g["bond_crystal"]])
        vec = cart[g["nbr"]] + shift - cart[g["center"]]
        dist = torch.sqrt((vec * vec).sum(-1) + 1e-16)
        ij, ik = g["angle_ij"], g["angle_ik"]
        cos = (vec[ij] * vec[ik]).sum(-1) / (dist[ij] * dist[ik] + 1e-12)
        theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
        # Eq. 2 with the smooth envelope of Eq. 13
        rc, pw = m["r_cut_atom"], m["envelope_p"]
        xi = dist / rc
        env = 1.0 - 0.5 * xi ** pw * ((pw + 1) * (pw + 2)
                                      - 2 * pw * (pw + 2) * xi
                                      + pw * (pw + 1) * xi * xi)
        r_safe = torch.where(dist > 1e-8, dist, torch.ones_like(dist))
        rbf = (math.sqrt(2.0 / rc) * torch.sin(xi[:, None] * p["rbf_freqs"])
               / r_safe[:, None] * env[:, None])
        n = torch.arange(1, (m["num_fourier"] - 1) // 2 + 1,
                         device=theta.device, dtype=theta.dtype)
        ang = theta[:, None] * n
        four = torch.cat([torch.full_like(theta[:, None], 1 / math.sqrt(2)),
                          torch.cos(ang), torch.sin(ang)], -1) / math.sqrt(
                              math.pi)
        e, e_a, e_b = self.linear(p["bond_embed"], rbf).chunk(3, dim=-1)
        v = p["atom_embed"][g["z"]]
        a = self.linear(p["angle_embed"], four)
        ctr = g["center"][ij]
        for blk in p["blocks"]:
            v_new = self.atom_update(blk, g, v, e, e_a)
            x = torch.cat([v[ctr], e[ij], e[ik], a], dim=-1)
            msg = self.gated(blk["bond_mlp"], x) * e_b[ij] * e_b[ik]
            e_new = e + self.linear(blk["bond_out"],
                                    self.seg_sum(msg, ij, e.shape[0]))
            a = a + self.gated(blk["angle_mlp"], x)
            v, e = v_new, e_new
        v = self.atom_update(p["final_block"], g, v, e, e_a)
        return v, e, vec, dist

    def energy(self, p, g, v):
        site = self.mlp(p["energy_head"]["mlp"], v)[:, 0]
        return self.seg_sum(site, g["atom_crystal"], g["lattice"].shape[0])

    def __call__(self, p, g, create_graph: bool = True) -> dict:
        lattice, frac = g["lattice"], g["frac"]
        atom_lat = lambda lat: lat[g["atom_crystal"]]  # noqa: E731
        if self.m["readout"] == "autodiff":
            disp = torch.zeros_like(frac, requires_grad=True)
            strain = torch.zeros_like(lattice, requires_grad=True)
            eye = torch.eye(3, device=lattice.device)
            lat = lattice @ (eye + strain)
            cart = torch.einsum("ai,aij->aj", frac, atom_lat(lat)) + disp
            v, _, _, _ = self.trunk(p, g, lat, cart)
            energy = self.energy(p, g, v)
            dx, ds = torch.autograd.grad(energy.sum(), (disp, strain),
                                         create_graph=create_graph)
            vol = torch.abs(torch.linalg.det(lattice))[:, None, None]
            return {"energy": energy, "forces": -dx,
                    "stress": ds / (vol + 1e-12) * EV_A3_TO_GPA,
                    "magmom": torch.abs(self.mlp(p["magmom_head"]["mlp"],
                                                 v)[:, 0])}
        cart = torch.einsum("ai,aij->aj", frac, atom_lat(lattice))
        v, e, vec, dist = self.trunk(p, g, lattice, cart)
        n_ij = self.mlp(p["force_head"]["mlp"], e)[:, 0]
        x_hat = vec / (dist[:, None] + 1e-12)
        forces = self.seg_sum(n_ij[:, None] * x_hat, g["center"],
                              v.shape[0])
        l_hat = lattice / (torch.linalg.norm(lattice, dim=-1, keepdim=True)
                           + 1e-12)
        s = l_hat.sum(1)
        normal = s[:, :, None] * s[:, None, :]
        per_atom = self.mlp(p["stress_head"]["mlp"], v)
        stress = (p["stress_head"]["scale"] * self.seg_sum(
            per_atom, g["atom_crystal"], lattice.shape[0]).reshape(-1, 3, 3)
            * normal)
        return {"energy": self.energy(p, g, v), "forces": forces,
                "stress": stress,
                "magmom": torch.abs(self.mlp(p["magmom_head"]["mlp"],
                                             v)[:, 0])}


def huber(x, delta):
    ax = torch.abs(x)
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def loss(pred: dict, g: dict, w: dict):
    """(loss, {"loss", "mae_e_per_atom", "mae_f", "mae_s", "mae_m"})."""
    errs = {"e": (pred["energy"] - g["energy"]) / g["n_atoms"],
            "f": pred["forces"] - g["forces"],
            "s": pred["stress"] - g["stress"],
            "m": pred["magmom"] - g["magmoms"]}
    weights = {"e": w["energy"], "f": w["force"], "s": w["stress"],
               "m": w["magmom"]}
    total = sum(weights[k] * huber(x, w["huber_delta"]).mean()
                for k, x in errs.items())
    metrics = {"loss": total, "mae_e_per_atom": errs["e"].abs().mean()}
    metrics.update({f"mae_{k}": errs[k].abs().mean() for k in "fsm"})
    return total, metrics


def device_graph(g: dict, device) -> dict:
    """``graph.concat`` arrays as tensors: ids int64, floats f32."""
    ints = ("z", "atom_crystal", "center", "nbr", "bond_crystal",
            "angle_ij", "angle_ik")
    return {k: torch.as_tensor(x, device=device,
                               dtype=torch.long if k in ints
                               else torch.float32)
            for k, x in g.items()}
