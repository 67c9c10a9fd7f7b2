"""Kernels 2 and 3 (the fused atom and bond convs, f32) over their
roofline in the traced steps; moves ``train_crystals_per_s``."""
from perfbench.roofline import share


def read(ctx):
    return share(ctx, "conv")
