"""Model FLOP utilization of the window's training steps: the matrix
products the model needs at each step's real rows, over (window x the
configuration's datasheet peak: f32 67 TFLOP/s, bf16 989).

Forward products at A atoms, E bonds, N angles (dim D, K_r RBF and K_f
Fourier functions, B blocks); a linear d_in -> d_out on M rows is
2 M d_in d_out:
  - embeddings: 2E K_r 3D + 2N K_f D
  - each block: atom MLP 2E 3D 2D, atom out 2A D D, bond MLP 2N 4D 2D,
    bond out 2E D D, angle MLP 2N 4D 2D (the last block's angle MLP
    feeds nothing: forward only)
  - final atom update: 2E 3D 2D + 2A D D
  - energy head 2A (D D + D D + D), magmom head 2A (D D + D)
  - direct readout: force head 2E (D D + D), stress head 2A (D D + 9D)
A training step multiplies them:
  - direct readout: forward + backward = 3x (the backward takes the
    inputs' and the weights' gradients, each one product as large).
  - autodiff readout: the trunk and energy head T run 6x: forward T, the
    backward that gives forces and stress (inputs only) T, and the
    loss's backward through both, 2T for the forward and 2T for the
    first backward (each of its products X W^T differentiated in X and
    in W).  The magmom head runs 3x, as in the direct readout.
The chunked recompute of the backward is not counted.
"""

PEAKS = {"f32": "f32_flops", "bf16": "bf16_flops", "mixed": "bf16_flops"}


def step_flops(model: dict, rows: dict) -> float:
    d, nb = model["dim"], model["num_blocks"]
    a, e, n = rows["atoms"], rows["bonds"], rows["angles"]
    embed = 2 * e * model["num_rbf"] * 3 * d + 2 * n * model["num_fourier"] * d
    block = (2 * e * 3 * d * 2 * d + 2 * a * d * d + 2 * n * 4 * d * 2 * d
             + 2 * e * d * d + 2 * n * 4 * d * 2 * d)
    dead = 2 * n * 4 * d * 2 * d
    final = 2 * e * 3 * d * 2 * d + 2 * a * d * d
    energy = 2 * a * (2 * d * d + d)
    magmom = 2 * a * (d * d + d)
    trunk = embed + nb * block - dead + final + energy
    if model["readout"] == "autodiff":
        return 6 * trunk + 3 * magmom + dead
    heads = 2 * e * (d * d + d) + 2 * a * (d * d + 9 * d)
    return 3 * (trunk + magmom + heads) + dead


def read(ctx):
    w, peaks = ctx["window"], ctx["peaks"]
    if peaks is None or not w["rows"]:
        return None
    flops = sum(step_flops(ctx["model"], r) for r in w["rows"])
    peak = peaks[PEAKS[ctx["model"]["precision"]]]
    return 100.0 * flops / (w["seconds"] * peak)
