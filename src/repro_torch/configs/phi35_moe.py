"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400/expert vocab=32064, 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=0, vocab_size=32064, activation="silu",
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_ff_expert=6400),
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, vocab_size=128,
    compute_dtype="float32",
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_ff_expert=32),
)
