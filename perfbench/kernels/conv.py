"""Kernels 2 and 3: the fused atom and bond convs (``csrc/message_passing
.cu``, ``conv_split_kernel`` in f32, modes 0 and 1).

Operations and bytes of each launch at the batch's real rows, a frozen
copy of ``chip_smoke.py``'s ``kernel_cases`` arithmetic: each table row
that the real edges reach is read once, the ids once per real edge, the
CSR offsets whole, each output row written once (padded rows included).
The f32 products run split on the tensor cores (3 TF32 products each).
"""

# the profiler's name of an f32 launch; the group is the mode
PATTERN = r"conv_split_kernel<\s*([01])\s*,\s*\d+\s*,\s*float\s*>"
# TF32 products per f32 product
SPLIT = 3


def launches(model: dict, rows: dict) -> list[dict]:
    """The launches of one training step: the forward's atom conv of each
    block and of the final block (mode 0) and bond conv of each block
    (mode 1); the recompute backward launches none."""
    d = model["dim"]
    atoms, bonds, angles = rows["atoms"], rows["bonds"], rows["angles"]
    atom_cap, bond_cap = rows["atom_cap"], rows["bond_cap"]
    atom = {"mode": "0", "flops": 2 * bonds * 3 * d * 2 * d,
            "bytes": 4 * (atoms * d + 2 * bonds * d + 3 * d * 2 * d
                          + 6 * d + atom_cap * d
                          + 2 * bonds + atom_cap + 1)}
    bond = {"mode": "1", "flops": 2 * angles * 4 * d * 2 * d,
            "bytes": 4 * (atoms * d + 2 * bonds * d + angles * d
                          + 4 * d * 2 * d + 6 * d + bond_cap * d
                          + 3 * angles + bond_cap + 1)}
    n = model["num_blocks"]
    return [atom] * (n + 1) + [bond] * n
