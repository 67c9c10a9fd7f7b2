"""The counts of the convs' backward kernel (``kernels/conv_bwd.py``)
against cases worked by hand, its launch names, and the roofline share
they give on a made-up trace."""
import re

import pytest

from perfbench import harness
from perfbench.kernels import conv, conv_bwd
from perfbench.roofline import share

# D 2, 1 block; 3 real atoms, 4 bonds, 6 angles
MODEL = {"dim": 2, "num_blocks": 1}
ROWS = {"crystals": 1, "atoms": 3, "bonds": 4, "angles": 6,
        "atom_cap": 8, "bond_cap": 16, "angle_cap": 32}
FWD = "void (anonymous namespace)::conv_split_kernel<{}, 64, float>(x)"
BWD = "void (anonymous namespace)::conv_bwd_kernel<{}, 64>(x)"
SUM = "(anonymous namespace)::block_partial_sum_kernel(float const*, ...)"
ROWS_SUM = "void (anonymous namespace)::sorted_row_sum_kernel<64>(x)"


def test_conv_bwd_launches_by_hand():
    got = conv_bwd.launches(MODEL, ROWS)
    # atom: 3 products of 2 * 4 bonds * 6 * 4 = 576 flops; floats 2 * (3*2
    # + 2*4*2 + 6*4 + 3*4) + 3*2 = 122, ints 2*4 + 3 + 1 = 12 -> 536 bytes
    atom = {"mode": "0", "flops": 576, "bytes": 536}
    # bond: 3 * 2 * 6 angles * 8 * 4 = 1152 flops; floats 2 * (6 + 16 + 12
    # + 32 + 12) + 4*2 = 164, ints 5*6 + 4 + 1 = 35 -> 796 bytes
    bond = {"mode": "1", "flops": 1152, "bytes": 796}
    assert got == [atom, atom, bond]


def test_patterns_keep_forward_and_backward_apart():
    """The backward's pattern takes the backward kernel's launches, with
    the mode as its group, and neither the forward's nor the partial
    sum's nor the row sums'; the forward's pattern takes none of the
    backward's."""
    bwd, fwd = re.compile(conv_bwd.PATTERN), re.compile(conv.PATTERN)
    assert bwd.search(BWD.format(0)).group(1) == "0"
    assert bwd.search(BWD.format(1)).group(1) == "1"
    for name in (FWD.format(0), FWD.format(1), SUM, ROWS_SUM):
        assert bwd.search(name) is None
    for name in (BWD.format(0), BWD.format(1), SUM, ROWS_SUM):
        assert fwd.search(name) is None


def test_conv_bwd_share():
    peaks = {"tf32_flops": 2000.0, "hbm_bytes_per_s": 100.0}
    device = [(BWD.format(0), 0.0, 6e6), (SUM, 6e6, 7e6),
              (BWD.format(0), 7e6, 13e6), (SUM, 13e6, 14e6),
              (BWD.format(1), 14e6, 24e6), (SUM, 24e6, 25e6),
              (FWD.format(0), 25e6, 26e6)]
    ctx = {"model": MODEL, "peaks": peaks,
           "kernels": lambda k: {"conv_bwd": conv_bwd}[k],
           "trace": {"rows": [ROWS], "trace": {"device": device}}}
    # bounds: atom max(3*576/2000, 536/100) = 5.36 s twice, bond
    # max(3*1152/2000, 796/100) = 7.96 s; measured 6 + 6 + 10 = 22 s
    assert share(ctx, "conv_bwd") == pytest.approx(100 * 18.68 / 22)
    # a trace of a program whose backward recomputes: no share
    ctx["trace"]["trace"]["device"] = device[-1:]
    assert share(ctx, "conv_bwd") is None


def test_metric_reads_the_share():
    metric = harness.load_file(harness.BENCH / "metrics"
                               / "roofline.conv_bwd.train.py")
    ctx = {"model": MODEL, "peaks": None, "trace": None,
           "kernels": lambda k: {"conv_bwd": conv_bwd}[k]}
    assert metric.read(ctx) is None
