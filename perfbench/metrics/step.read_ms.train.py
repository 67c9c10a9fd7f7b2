"""Host milliseconds a traced step spends in the program's span
``trainer.read``: the step's one device read, the time the host
waits for the device; moves ``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.per_step_ms(ctx, "trainer.read")
