"""zamba2-1.2b [hybrid]: 38L d_model=2048 (Mamba2 backbone, ssm_state=64)
+ one SHARED attention block (32H MHA, d_ff=8192) applied every 6 layers
[arXiv:2411.15242]. Sub-quadratic decode => long_500k runs."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, activation="silu",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, attn_every=6,
)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=160,
    vocab_size=128, ssm_state=16, ssm_head_dim=16, attn_every=2,
    compute_dtype="float32",
)
