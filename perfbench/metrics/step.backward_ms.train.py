"""Host milliseconds a traced step spends in the program's span
``trainer.backward``: ``grads_of``, the loss's backward (the host
blocks in ``torch.autograd.grad`` while autograd dispatches); moves
``train_crystals_per_s``."""
from perfbench import progspans


def read(ctx):
    return progspans.per_step_ms(ctx, "trainer.backward")
