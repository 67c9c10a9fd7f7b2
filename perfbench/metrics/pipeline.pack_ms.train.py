"""Milliseconds an item spends in the prefetch worker's span
``prefetch.pack`` (the source's sampling and packing of one batch), the
mean over the items begun during the traced steps; moves
``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.worker_ms(ctx, "prefetch.pack")
