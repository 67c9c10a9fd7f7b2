"""Kernels 2 and 3 backward (the fused convs' backward kernel, f32) over
its roofline in the traced steps; moves ``train_crystals_per_s``.  None
where the traced steps launch no such kernel (a program whose convs'
backward is the chunked recompute)."""
from perfbench.roofline import share


def read(ctx):
    return share(ctx, "conv_bwd")
