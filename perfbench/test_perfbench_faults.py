"""A whole run of the harness with the timed path broken underneath
(the look for a chip skipped: the CPU's plain kernels), which must come
out not correct."""
import pytest
import torch

from perfbench import harness


def _frozen_step(grads, opt_state, params, lr, train_cfg, scale_kind="none",
                 metrics=None):
    """A training step that returns its state unchanged."""
    return params, opt_state, {"grad_norm": torch.zeros(())}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_is_not_correct(tiny, monkeypatch, fault):
    spec = tiny("fastchgnet.mptrj_b128")
    if fault == "unchanged":
        monkeypatch.setattr("repro_torch.train.trainer.apply_grads",
                            _frozen_step)
    res = harness.run(spec, 2**31 + 5, 0.2, False, device="cpu",
                      fault=None if fault == "unchanged" else fault)
    assert not res["correct"]
    if fault == "unchanged":
        # the state moved by nothing: the first gradient reads 1 by the
        # worst leaf, the change and the moments about 1 by the median leaf
        assert res["checks"]["grad"]["value"] == pytest.approx(1.0)
        assert res["checks"]["update"]["value"] > 0.5
        assert res["checks"]["moments"]["value"] > 0.5
