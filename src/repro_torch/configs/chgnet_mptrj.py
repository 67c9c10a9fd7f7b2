"""The paper's own model: CHGNet v0.3.0-style config for MPtrj training
(paper §IV Parameters Setting) + the FastCHGNet variants of Table I.

A copy of ``repro.configs.chgnet_mptrj``.  Every config is defined here;
those whose tiers are not ported yet raise ``NotImplementedError`` when a
model is built or applied with them (``core.chgnet.check_supported``).
"""
from repro_torch.core.chgnet import CHGNetConfig
from repro_torch.core.losses import LossWeights

# reference CHGNet (autodiff force/stress, sequential blocks)
REFERENCE = CHGNetConfig(
    dim=64, num_rbf=31, num_fourier=31, num_blocks=3,
    r_cut_atom=6.0, r_cut_bond=3.0, envelope_p=8,
    readout="autodiff", block_variant="reference", mlp_impl="ref",
    envelope_impl="reference",
)

# FastCHGNet "w/o head": all system optimizations, physics-consistent readout
FAST_WO_HEAD = REFERENCE.with_(
    block_variant="fast", mlp_impl="packed", envelope_impl="factored",
)

# FastCHGNet "F/S head": + decoupled Force/Stress heads (paper C1)
FAST_FS_HEAD = FAST_WO_HEAD.with_(readout="direct")

# + fused message-passing kernels (DESIGN.md §3); the serving path of
# this port
FAST_FUSED = FAST_FS_HEAD.with_(conv_impl="fused", agg_impl="pallas")

# + end-to-end mixed precision (DESIGN.md §4)
FAST_MIXED = FAST_FS_HEAD.with_(precision="mixed")
FAST_FUSED_MIXED = FAST_FUSED.with_(precision="mixed")

# + undirected-bond redundancy bypass (DESIGN.md §5)
FAST_HALF = FAST_FS_HEAD.with_(bond_store="undirected")
FAST_FUSED_HALF = FAST_FUSED.with_(bond_store="undirected")
FAST_FUSED_HALF_MIXED = FAST_FUSED_MIXED.with_(bond_store="undirected")

# + symmetric half-graph trunk (DESIGN.md §10)
FAST_SYM = FAST_HALF.with_(bond_features="undirected")
FAST_FUSED_SYM = FAST_FUSED_HALF.with_(bond_features="undirected")

# + per-bond virial stress (DESIGN.md §7)
FAST_VIRIAL = FAST_FS_HEAD.with_(stress_mode="bond_virial")
FAST_FUSED_VIRIAL = FAST_FUSED.with_(stress_mode="bond_virial")

LOSS = LossWeights(energy=2.0, force=1.5, stress=0.1, magmom=0.1,
                   huber_delta=0.1)

# paper training recipe
BATCH_SIZE = 128          # reference single-GPU recipe
LARGE_BATCH = 2048        # multi-GPU recipe (Fig. 6)
EPOCHS = 30
BASE_LR = 3e-4
LR_K = 128                # Eq. 14

# multi-GPU sharding recipe (DESIGN.md §6, paper Fig. 4/9)
BALANCE = "cost"
ACCUM_MICROS = 2          # microbatches per optimizer step at LARGE_BATCH
