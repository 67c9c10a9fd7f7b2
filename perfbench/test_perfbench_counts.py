"""The benchmark's operation and byte counts against cases worked by
hand, and the roofline share they give on a made-up trace."""
import pytest

from perfbench import harness
from perfbench.kernels import conv, gated_mlp

MFU = harness.load_file(harness.BENCH / "metrics" / "step.mfu.train.py")
# D 2, 1 block; 3 real atoms, 4 bonds, 6 angles in capacities 8 / 16 / 32
MODEL = {"dim": 2, "num_blocks": 1, "num_rbf": 3, "num_fourier": 3,
         "readout": "direct", "precision": "f32"}
ROWS = {"crystals": 1, "atoms": 3, "bonds": 4, "angles": 6,
        "atom_cap": 8, "bond_cap": 16, "angle_cap": 32}


def test_conv_launches_by_hand():
    got = conv.launches(MODEL, ROWS)
    # atom conv: 2 * 4 bonds * (3*2) * (2*2) = 192 flops; floats: 3*2
    # atoms + 2*4*2 edge tables + 6*4 W + 6*2 vectors + 8*2 out = 74,
    # ints: 2*4 ids + 8 + 1 offsets = 17 -> 4 * 91 = 364 bytes
    atom = {"mode": "0", "flops": 192, "bytes": 364}
    # bond conv: 2 * 6 * 8 * 4 = 384 flops; floats: 6 + 16 + 6*2 angles
    # + 8*4 W + 12 + 16*2 out = 110, ints: 3*6 + 16 + 1 = 35 -> 580
    bond = {"mode": "1", "flops": 384, "bytes": 580}
    assert got == [atom, atom, bond]


def test_gated_mlp_launches_by_hand():
    got = gated_mlp.launches(MODEL, ROWS)
    # atom MLP: 4 rows, d_in 6, 2D = 4: 2*4*6*4 + 4*4 = 208 flops;
    # floats 4*6 + 6*4 + 3*4 + 4*2 = 68 -> 272 bytes
    atom = {"mode": "", "flops": 208, "bytes": 272}
    # bond / angle MLP: 6 rows, d_in 8: 2*6*8*4 + 6*4 = 408;
    # floats 6*8 + 8*4 + 12 + 6*2 = 104 -> 416 bytes
    angle = {"mode": "", "flops": 408, "bytes": 416}
    assert got == [atom, angle, angle, atom]


@pytest.mark.parametrize("readout,want", [
    # forward: embed 2*4*3*6 + 2*6*3*2 = 216; block: atom MLP 2*4*6*4 =
    # 192, atom out 2*3*2*2 = 24, bond MLP 2*6*8*4 = 384, bond out
    # 2*4*2*2 = 32, angle MLP 384 (it feeds nothing: forward only);
    # final 192 + 24 = 216; energy 2*3*(8+2) = 60; magmom 2*3*(4+2) = 36;
    # force head 2*4*(4+2) = 48, stress head 2*3*(4+18) = 132.
    # trunk 216 + 632 + 216 + 60 = 1124
    # direct: 3 * (1124 + 36 + 48 + 132) + 384 = 4404
    ("direct", 4404),
    # autodiff: 6 * 1124 + 3 * 36 + 384 = 7236
    ("autodiff", 7236),
])
def test_step_flops_by_hand(readout, want):
    assert MFU.step_flops(dict(MODEL, readout=readout), ROWS) == want


def test_mfu_and_roofline_share():
    peaks = {"f32_flops": 1000.0, "tf32_flops": 2000.0,
             "bf16_flops": 4000.0, "hbm_bytes_per_s": 100.0}
    ctx = {"model": MODEL, "peaks": peaks,
           "window": {"seconds": 2.0, "rows": [ROWS, ROWS], "wait_s": 0.1},
           "kernels": lambda k: {"conv": conv}[k],
           "trace": {"rows": [ROWS], "trace": {"device": [
               ("void conv_split_kernel<0, 2, float>(ConvArgs<float>)",
                0.0, 2e6),
               ("void conv_split_kernel<0, 2, float>(ConvArgs<float>)",
                3e6, 5e6),
               ("void conv_split_kernel<1, 2, float>(ConvArgs<float>)",
                6e6, 10e6),
               ("void conv_split_kernel<1, 2, __nv_bfloat16>(x)", 0, 1e6),
               ("elementwise", 1e6, 2e6)]}}}
    # 2 steps of 4404 flops over 2 s at 1000 flop/s
    assert MFU.read(ctx) == pytest.approx(100 * 8808 / 2000)
    # bounds: atom max(3*192/2000, 364/100) = 3.64 s twice, bond
    # max(3*384/2000, 580/100) = 5.8 s; measured 2 + 2 + 4 = 8 s
    from perfbench.roofline import share
    assert share(ctx, "conv") == pytest.approx(100 * 13.08 / 8)


@pytest.mark.parametrize("extra", [
    "void conv_split_kernel<0, 2, float>(ConvArgs<float>)",
    "void conv_split_kernel<1, 2, float>(ConvArgs<float>)",
])
def test_roofline_silent_when_launches_differ(extra):
    """One launch more than the kernel's file counts, in either mode: the
    bound and the time would cover different launches, so no share."""
    from perfbench.roofline import share
    peaks = {"tf32_flops": 2000.0, "hbm_bytes_per_s": 100.0}
    device = [("void conv_split_kernel<0, 2, float>(ConvArgs<float>)",
               0.0, 2e6)] * 2 + [
        ("void conv_split_kernel<1, 2, float>(ConvArgs<float>)", 6e6, 10e6)]
    ctx = {"model": MODEL, "peaks": peaks,
           "kernels": lambda k: {"conv": conv}[k],
           "trace": {"rows": [ROWS], "trace": {"device": device}}}
    assert share(ctx, "conv") is not None
    ctx["trace"]["trace"]["device"] = device + [(extra, 11e6, 12e6)]
    assert share(ctx, "conv") is None


@pytest.mark.parametrize("name, want", [
    # 2 steps of 1 crystal over 2 s
    ("step.crystals_per_s.host_paced", 1.0),
    # 1 - (3 + 4 + 6) / (8 + 16 + 32), as batching.pad_share.train
    ("batching.pad_share.memory", 100 * (1 - 13 / 56)),
])
def test_window_readers_by_hand(name, want):
    read = harness.load_file(harness.BENCH / "metrics" / f"{name}.py").read
    window = {"seconds": 2.0, "rows": [ROWS, ROWS], "wait_s": 0.0}
    assert read({"window": window}) == pytest.approx(want)
    assert read({"window": dict(window, rows=[])}) is None
