"""The numbers that decide ``correct``, on made-up readings: a fault in a
few leaves, outputs of another shape, and the elements left out."""
import math

import pytest
import torch

from perfbench import harness
from perfbench.reference import train as ref_train


def _readings(seed: int = 0, leaves: int = 20) -> dict:
    """Readings as ``ref_train.replay`` returns them, for ``leaves``
    leaves of 16 elements."""
    gen = torch.Generator().manual_seed(seed)

    def tensors(scale=1.0):
        return [scale * torch.randn(16, generator=gen) for _ in range(leaves)]

    return {"metrics": [{"loss": 2.0}, {"loss": 1.5}, {"loss": 1.25}],
            "outputs": {"energy": torch.randn(4, generator=gen),
                        "forces": torch.randn(9, 3, generator=gen),
                        "stress": torch.randn(4, 3, 3, generator=gen),
                        "magmom": torch.rand(9, generator=gen)},
            "grad": tensors(), "delta": tensors(1e-3),
            "delta_first": tensors(1e-3), "mu": tensors(), "nu": tensors()}


def _copy(r: dict) -> dict:
    out = {k: [x.clone() for x in v] if isinstance(v, list)
           and isinstance(v[0], torch.Tensor) else v for k, v in r.items()}
    out["outputs"] = {k: x.clone() for k, x in r["outputs"].items()}
    return out


def test_identical_readings_read_nought():
    want = _readings()
    got = ref_train.compare(_copy(want), want)
    assert all(v == 0 for v in got.values()), got


@pytest.mark.parametrize("key", ["delta", "delta_first"])
def test_learning_rate_wrong_in_two_leaves(key):
    """Twice the step in 2 leaves of 20 (a head's): the median leaf reads
    nothing, the worst leaf reads the fault."""
    want = _readings()
    got = _copy(want)
    for i in (3, 17):
        got[key][i] = 2 * got[key][i]
    nums = ref_train.compare(got, want)
    assert nums["update"] == 0
    name = "update_worst" if key == "delta" else "update_first"
    # the leaf's norm doubled, over the larger of its own and the median's
    assert 0.5 < nums[name] <= 1.0
    for cell in ("fastchgnet.mptrj_b128", "fastchgnet_wo_head.mptrj_b128"):
        limits = harness.cell_spec(cell)["limits"]
        assert not harness.judge(dict(graph=0, **nums), limits)


def test_outputs_by_relative_norm_and_shape():
    want = _readings()
    got = _copy(want)
    got["outputs"]["forces"] = got["outputs"]["forces"] * (1 + 1e-3)
    assert ref_train.output_gap(got["outputs"], want["outputs"]) == \
        pytest.approx(1e-3, rel=1e-3)
    # a force's sign flipped moves the MAE against the labels little,
    # the tensors a lot
    got = _copy(want)
    got["outputs"]["forces"][0] = -got["outputs"]["forces"][0]
    assert ref_train.output_gap(got["outputs"], want["outputs"]) > 0.1
    got["outputs"]["magmom"] = got["outputs"]["magmom"][:5]
    assert math.isinf(ref_train.output_gap(got["outputs"], want["outputs"]))


def test_nought_elements_left_out():
    """An element whose reference gradient is nought to rounding may move
    a whole step on one side: it is not counted."""
    want = _readings()
    want["grad"][5][0] = 1e-12
    keep = ref_train.element_keep(want["grad"])
    assert not keep[5][0] and keep[5][1:].all()
    got = _copy(want)
    got["delta"][5][0] = got["delta"][5][0] + 1.0
    got["delta_first"][5][0] = -got["delta_first"][5][0] + 1.0
    nums = ref_train.compare(got, want)
    assert nums["update_worst"] == 0 and nums["update_first"] == 0


def test_judge_reads_only_the_numbers_limited():
    limits = {"loss": 1e-6}
    assert harness.judge({"loss": 1e-7, "other": 5.0}, limits)
    assert not harness.judge({"loss": math.nan}, limits)
    assert not harness.judge({"loss": 1e-5}, limits)
