"""Plain PyTorch training steps of the reference model: loss, gradients by
autograd (a double backward for the autodiff readout), the global-norm
clip, Adam and the paper's cosine learning rate (Eq. 14: init_LR =
batch / k * base_lr).

``replay`` follows the program's first steps from the same initial
parameters on the same crystals, and ``compare`` turns the two sides'
readings into the numbers that decide ``correct``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import chgnet

# the model's outputs that the loss reads, as both sides name them
TARGETS = ("energy", "forces", "stress", "magmom")


def lr_at(step: int, train: dict, total_steps: int) -> float:
    """Cosine annealing from the Eq. 14 initial LR, computed in f32."""
    init = train["batch"] / train["lr_k"] * train["base_lr"]
    prog = np.float32(min(max(step / max(total_steps, 1), 0.0), 1.0))
    return float(np.float32(init) * np.float32(0.5) * (np.float32(1.0)
                 + np.cos(np.float32(math.pi) * prog, dtype=np.float32)))


def replay(params: dict, model: dict, train: dict, total_steps: int,
           graphs: list[dict], *, tf32: bool = False) -> dict:
    """Train a copy of ``params`` for one step on each of ``graphs``
    (``chgnet.device_graph``).  Returns, as the program's readings are
    gathered: each step's metrics, the first step's outputs (``TARGETS``),
    clipped gradient and change of the parameters, the parameters' change
    and Adam's moments after the last step (lists of leaves)."""
    net = chgnet.Model(model, tf32=tf32)
    adam = train["adam"]
    b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
    p0 = [x.detach().clone() for x in chgnet.leaves(params)]
    flat = [x.clone().requires_grad_() for x in p0]
    tree = chgnet.unflatten(params, flat)
    mu = [torch.zeros_like(x) for x in flat]
    nu = [torch.zeros_like(x) for x in flat]
    out = {"metrics": []}
    for t, g in enumerate(graphs):
        pred = net(tree, g)
        if t == 0:
            out["outputs"] = {k: pred[k].detach().clone() for k in TARGETS}
        loss, metrics = chgnet.loss(pred, g, train["loss"])
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(x) if d is None else d
                     for x, d in zip(flat, grads)]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(d) for d in grads]))
            scale = torch.clamp(train["grad_clip"] / (norm + 1e-12), max=1.0)
            grads = [d * scale for d in grads]
            if t == 0:
                out["grad"] = [d.clone() for d in grads]
            c = np.float32(t + 1)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            lr = lr_at(t, train, total_steps)
            for x, d, m, v in zip(flat, grads, mu, nu):
                m.mul_(b1).add_(d * (1 - b1))
                v.mul_(b2).add_(d * d * (1 - b2))
                x.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
            if t == 0:
                out["delta_first"] = [x.detach() - x0
                                      for x, x0 in zip(flat, p0)]
        out["metrics"].append({k: float(x.detach())
                               for k, x in metrics.items()})
    out["delta"] = [x.detach() - x0 for x, x0 in zip(flat, p0)]
    out["mu"], out["nu"] = mu, nu
    return out


def _norms(xs) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(x.double())) for x in xs])


def leaf_gaps(got, want, keep=None) -> np.ndarray:
    """Each counted leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; ``keep`` masks the leaves that count."""
    a, b = _norms(got), _norms(want)
    keep = np.ones(len(b), bool) if keep is None else np.asarray(keep)
    med = float(np.median(b[keep]))
    return (np.abs(a - b) / np.maximum(b, med))[keep]


def element_keep(grad) -> list:
    """Per leaf, the elements whose reference gradient is at least a
    thousandth of the median leaf's (root mean square): Adam moves the
    others by the rounding of a gradient that is nought, by a whole step
    of either sign."""
    rms = [float(torch.sqrt(torch.mean(g.double() ** 2))) for g in grad]
    floor = 1e-3 * float(np.median(rms))
    return [g.abs() >= floor for g in grad]


def output_gap(got: dict, want: dict) -> float:
    """The largest relative norm of the difference between the two sides'
    output tensors; infinite where their shapes differ."""
    worst = 0.0
    for k in TARGETS:
        a, b = got[k].double(), want[k].double()
        if a.shape != b.shape:
            return math.inf
        worst = max(worst, float(torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b)))
    return worst


def compare(got: dict, want: dict) -> dict:
    """The numbers that decide ``correct``; both sides as ``replay``
    returns them.

    ``loss``: each step's loss, the largest relative gap.  ``outputs``:
    the first step's energies, forces, stresses and magmoms, the largest
    relative norm of the difference (``output_gap``).  ``grad``: the first
    clipped gradient, by the worst leaf.  ``update``: the parameters'
    change after the last step, and ``moments``: Adam's two moments then,
    by the median leaf; ``update_worst``: the change by the worst leaf,
    counting only the elements that ``element_keep`` keeps, so that a
    fault in a few leaves shows; ``update_first``: the first step's
    change, the same way: a step taken from the first gradient alone, so
    that a learning rate or a bias correction wrong in a few leaves shows
    whatever the later steps do.

    The later steps start from parameters that Adam has moved by a whole
    step wherever a gradient element is nought to rounding, whatever its
    sign, so their outputs and the worst leaf's change swing from seed to
    seed by far more than the first step's: hence the first step's
    outputs, the median leaf, and the worst leaf only over the elements
    whose first gradient is not nought.  Leaves whose first reference gradient
    is under a thousandth of the median leaf's are left out of ``update``
    and ``moments``: Adam moves them by the rounding of a gradient that is
    nought (the last block's unused angle MLP, for one).
    """
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    g_ref = _norms(want["grad"])
    keep = g_ref >= 1e-3 * np.median(g_ref)
    elems = element_keep(want["grad"])
    return {
        "loss": max(rel(a["loss"], b["loss"])
                    for a, b in zip(got["metrics"], want["metrics"])),
        "outputs": output_gap(got["outputs"], want["outputs"]),
        "grad": float(leaf_gaps(got["grad"], want["grad"]).max()),
        "update": float(np.median(leaf_gaps(got["delta"], want["delta"],
                                            keep))),
        "update_worst": float(leaf_gaps(
            [d * m for d, m in zip(got["delta"], elems)],
            [d * m for d, m in zip(want["delta"], elems)],
            [bool(m.any()) for m in elems]).max()),
        "update_first": float(leaf_gaps(
            [d * m for d, m in zip(got["delta_first"], elems)],
            [d * m for d, m in zip(want["delta_first"], elems)],
            [bool(m.any()) for m in elems]).max()),
        "moments": float(max(np.median(leaf_gaps(got["mu"], want["mu"],
                                                 keep)),
                             np.median(leaf_gaps(got["nu"], want["nu"],
                                                 keep)))),
    }
