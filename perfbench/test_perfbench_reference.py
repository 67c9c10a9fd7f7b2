"""The reference against the port at a CPU test's size, for both
readouts (no chip: the kernels' plain versions run), and the control and
a fault that must come out wrong."""
import functools

import pytest

from perfbench import calibrate, harness
from perfbench.conftest import tiny_spec

CELLS = ["fastchgnet.mptrj_b128", "fastchgnet_wo_head.mptrj_b128"]


@functools.cache
def _readings(cell: str) -> tuple:
    """The first steps' numbers of the program, of the reference in TF32
    in its place, and of the program with half of each batch left out."""
    spec = tiny_spec(cell)
    got = dict(calibrate.readings(spec, 2**31 + 3, "cpu",
                                  ["program", "control", "half_batch"]))
    return spec["limits"], got


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    limits, got = _readings(cell)
    assert harness.judge(got["program"], limits), got["program"]
    assert got["program"]["graph"] == 0
    # f32 sums in another order: far under every limit
    for k in ("loss", "outputs", "grad", "moments"):
        assert got["program"][k] < 1e-4, (k, got["program"])


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    limits, got = _readings(cell)
    assert not harness.judge(got["control"], limits), got["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(cell):
    limits, got = _readings(cell)
    assert got["half_batch"]["graph"] > 0
    assert not harness.judge(got["half_batch"], limits)
