"""Kernel 7: the GatedMLP of the unfused tier (``csrc/gated_mlp.cu``,
``gated_mlp_split_kernel`` in f32).

Operations and bytes of each launch at its real rows, a frozen copy of
``chip_smoke.py``'s arithmetic: x read once, the packed weights and the
bias and LayerNorm vectors once, the output written once.  Split f32
products on the tensor cores (3 TF32 products each).
"""

PATTERN = r"gated_mlp_split_kernel<\s*\d+\s*,\s*float\s*>"
SPLIT = 3


def _launch(m: int, d_in: int, d: int) -> dict:
    d2 = 2 * d
    return {"mode": "", "flops": 2 * m * d_in * d2 + m * d2,
            "bytes": 4 * (m * d_in + d_in * d2 + 3 * d2 + m * d)}


def launches(model: dict, rows: dict) -> list[dict]:
    """The launches of one training step: each block's atom (bond rows,
    3D wide), bond and angle MLPs (angle rows, 4D wide), and the final
    block's atom MLP; the recompute backwards launch none."""
    d = model["dim"]
    atom = _launch(rows["bonds"], 3 * d, d)
    angle = _launch(rows["angles"], 4 * d, d)
    return ([atom, angle, angle] * model["num_blocks"]) + [atom]
