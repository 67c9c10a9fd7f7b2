"""Host milliseconds a traced step spends in the program's span
``trainer.forward``: ``chgnet_loss_fn`` (with the autodiff readout, its
create-graph backward that gives forces and stress); moves
``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.per_step_ms(ctx, "trainer.forward")
