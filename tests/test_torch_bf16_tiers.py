"""The tiers whose kernels gained bf16 operand paths (CUDA kernels 7 and 1:
the unfused Pallas tier; 5 and 6: the fused symmetric trunk; 4b: the fused
bond virial) at DESIGN.md §4's precisions, on the CPU: the port at
``precision="mixed"`` against the JAX package at "mixed" (forward within
3e-2 absolute, every gradient leaf within 5% relative global norm and
cosine >= 0.999) and against the port's own f32 run, and the forward at
"bf16" (bf16 parameters) against JAX at "bf16".  The batch and the bounds
are tests/test_torch_precision.py's; each JAX reference is computed once.
The port runs its plain versions here, JAX its Pallas kernels in
interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import chgnet_mptrj as JC  # noqa: E402
from repro.core.chgnet import CHGNetConfig as JConfig  # noqa: E402
from repro.core.chgnet import chgnet_apply as j_apply  # noqa: E402
from repro.core.chgnet import chgnet_init as j_init  # noqa: E402
from repro.core.losses import LossWeights as JWeights  # noqa: E402
from repro.core.losses import chgnet_loss as j_loss  # noqa: E402
from repro_torch.configs import chgnet_mptrj as TC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import CHGNet  # noqa: E402
from repro_torch.core.chgnet import CHGNetConfig, chgnet_apply  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402

from test_torch_precision import (  # noqa: E402
    FWD_ATOL,
    SMALL,
    _assert_grads_close,
    _port_run,
    batches,  # noqa: F401 (module-scoped fixture)
    params,  # noqa: F401 (module-scoped fixture)
)

# (JAX config, port config) of each tier, narrowed to SMALL: the unfused
# Pallas tier at tests/test_precision.py's corner ("pallas", "pallas",
# "unfused", directed store), then the fused symmetric trunk and the fused
# bond virial
_PALLAS = dict(mlp_impl="pallas", agg_impl="pallas", conv_impl="unfused",
               bond_store="directed")
TIERS = {
    "pallas-pallas-unfused": (JConfig(**SMALL, **_PALLAS),
                              CHGNetConfig(**SMALL, **_PALLAS)),
    "FAST_FUSED_SYM": (JC.FAST_FUSED_SYM.with_(**SMALL),
                       TC.FAST_FUSED_SYM.with_(**SMALL)),
    "FAST_FUSED_VIRIAL": (JC.FAST_FUSED_VIRIAL.with_(**SMALL),
                          TC.FAST_FUSED_VIRIAL.with_(**SMALL)),
}


@pytest.fixture(scope="module")
def jax_mixed(batches, params):
    """JAX at "mixed" per tier, computed on first use: the outputs and the
    loss's gradient leaves."""
    jb, _ = batches
    jp, _ = params
    cache = {}

    def run(tier):
        if tier not in cache:
            jcfg = TIERS[tier][0].with_(precision="mixed")

            def loss(p):
                out = j_apply(p, jcfg, jb)
                return j_loss(out, jb, JWeights())[0], out

            (_, out), grads = jax.value_and_grad(loss, has_aux=True)(jp)
            cache[tier] = ({k: np.asarray(v) for k, v in out.items()},
                           [np.asarray(g) for g in jax.tree.leaves(grads)])
        return cache[tier]
    return run


@pytest.mark.parametrize("tier", list(TIERS))
def test_mixed_matches_jax(batches, params, jax_mixed, tier):
    """Forward and every gradient leaf at "mixed", the port against the
    JAX package at "mixed", within §4's bounds; the outputs and the
    gradients are f32."""
    _, tb = batches
    _, tp = params
    want, jgrads = jax_mixed(tier)
    got, grads = _port_run(tp, TIERS[tier][1].with_(precision="mixed"), tb)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=FWD_ATOL,
                                   err_msg=k)
    assert all(g.dtype == torch.float32 for g in grads)
    _assert_grads_close([g.numpy() for g in grads], jgrads)


@pytest.mark.parametrize("tier", list(TIERS))
def test_mixed_matches_f32(batches, params, tier):
    """The port at "mixed" against the port at f32 on one parameter tree,
    within §4's bounds."""
    _, tb = batches
    _, tp = params
    cfg = TIERS[tier][1]
    got, g_mx = _port_run(tp, cfg.with_(precision="mixed"), tb)
    want, g_32 = _port_run(tp, cfg, tb)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=FWD_ATOL, err_msg=k)
    _assert_grads_close([g.numpy() for g in g_mx], [g.numpy() for g in g_32])


@pytest.fixture(scope="module")
def bf16_params():
    """A parameter tree at the bf16 policy (bf16 leaves, rbf_freqs f32),
    the same values on both sides."""
    jp = j_init(jax.random.PRNGKey(0), JConfig(**SMALL, precision="bf16"))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("tier", list(TIERS))
def test_bf16_forward_matches_jax(batches, bf16_params, tier):
    """The forward at "bf16" on bf16 parameters, the port against JAX,
    within §4's forward bound; outputs f32.  The model builds and the
    trainer starts at the tier (no tier is refused)."""
    jb, tb = batches
    jp, tp = bf16_params
    jcfg, tcfg = (c.with_(precision="bf16") for c in TIERS[tier])
    want = j_apply(jp, jcfg, jb)
    with torch.no_grad():
        got = chgnet_apply(tp, tcfg, tb)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=FWD_ATOL, err_msg=k)
    assert CHGNet(tcfg, tp, device="cpu").cfg.precision == "bf16"
    tr = ttrain.Trainer(tcfg, ttrain.TrainConfig(global_batch=4,
                                                 total_steps=2),
                        device="cpu")
    assert "master" in tr.opt_state
