"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert
vocab=102400, 2 shared + 64 routed top-6 (fine-grained) [arXiv:2401.06066].
NOTE: the real model's first layer is dense; we keep a homogeneous MoE
stack (layer-0 dense is a <2% FLOP detail at this scale)."""
from repro_torch.models.config import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=102400, activation="silu",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, vocab_size=128,
    compute_dtype="float32",
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32),
)
