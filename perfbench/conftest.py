"""Shared helpers of the benchmark's CPU tests."""
import pytest
import torch

from perfbench import harness


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test of the benchmark runs: the suite
    runs in several worker processes at once, and each would otherwise
    start a thread for every core.  Restored after the test."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tiny():
    """A cell of ``BENCHMARK.json`` on a mix cut to a CPU test's size:
    8 crystals of 2-6 atoms, batches of 2 (the configuration as it is
    run, at its full widths)."""
    return tiny_spec


def tiny_spec(cell: str) -> dict:
    spec = harness.cell_spec(cell)
    spec["mix"] = dict(
        spec["mix"], pool=8, batch=2, trace_seconds=0.2,
        sizes=dict(spec["mix"]["sizes"], lognormal_mu=1.3, min_atoms=2,
                   max_atoms=6))
    return spec
