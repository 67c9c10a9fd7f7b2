"""Kernel 7 (the unfused tier's GatedMLP, f32) over its roofline in the
traced steps; moves ``train_crystals_per_s``."""
from perfbench.roofline import share


def read(ctx):
    return share(ctx, "gated_mlp")
