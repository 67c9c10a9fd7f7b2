"""Share of the card's idle time in the traced window during which the
prefetch worker was inside ``prefetch.pack`` or ``prefetch.copy`` (the
worker's spans mapped onto the profiler's clock by the traced
``trainer.step`` spans); moves ``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.idle_worker_share(ctx)
