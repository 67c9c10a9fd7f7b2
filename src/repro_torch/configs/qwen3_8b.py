"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12288, vocab_size=151936, activation="silu", qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=128, compute_dtype="float32",
)
