"""Kernels 2 and 3 backward: the fused atom and bond convs' backward
kernel (``csrc/message_passing_bwd.cu``, ``conv_bwd_kernel``, f32, modes 0
and 1).  The two small kernels after it, which sum its blocks' partials
(``block_partial_sum_kernel``) and its edge rows into the rows they read
(``sorted_row_sum_kernel``), are not counted, and the pattern matches
neither.

Operations and bytes of each launch at the batch's real rows, the least
the work needs: three products of 2 E K 2D each (z recomputed, dx = dz
W^T, dW = x^T dz; E the real edges, K = 3D for the atom conv and 4D for
the bond conv), each in split f32 (3 TF32 products); bytes: each operand
row the real edges reach read once and its cotangent row written once
(atoms, bonds and angles at their real counts), the output's cotangent at
the real rows read once, W and the three vectors read once and their
cotangents written once, the ids once per real edge, the CSR offsets over
the real rows.
"""

# the profiler's name of a launch; the group is the mode
PATTERN = r"conv_bwd_kernel<\s*([01])\s*,\s*\d+\s*>"
# TF32 products per f32 product
SPLIT = 3


def launches(model: dict, rows: dict) -> list[dict]:
    """The launches of one training step: the backward of each block's
    and the final block's atom conv (mode 0) and of each block's bond
    conv (mode 1)."""
    d = model["dim"]
    d2 = 2 * d
    atoms, bonds, angles = rows["atoms"], rows["bonds"], rows["angles"]
    atom_k, bond_k = 3 * d, 4 * d
    # operands and their cotangents: v, e, e_a, W | b, ln_scale, ln_bias;
    # then g at the atom rows; ints: center and nbr, offsets
    atom = {"mode": "0", "flops": 3 * 2 * bonds * atom_k * d2,
            "bytes": 4 * (2 * (atoms * d + 2 * bonds * d + atom_k * d2
                               + 3 * d2) + atoms * d
                          + 2 * bonds + atoms + 1)}
    # v, e, a, e_b, W | vectors; g at the bond rows; ints: ij, ik, the
    # centers, both envelope rows, offsets
    bond = {"mode": "1", "flops": 3 * 2 * angles * bond_k * d2,
            "bytes": 4 * (2 * (atoms * d + 2 * bonds * d + angles * d
                               + bond_k * d2 + 3 * d2) + bonds * d
                          + 5 * angles + bonds + 1)}
    n = model["num_blocks"]
    return [atom] * (n + 1) + [bond] * n
