"""Host milliseconds a traced step spends in the program's span
``trainer.optimizer``: ``apply_grads``, the global norm, the clip
and Adam; moves ``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.per_step_ms(ctx, "trainer.optimizer")
