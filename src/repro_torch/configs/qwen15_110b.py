"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, activation="silu", qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=128, compute_dtype="float32",
)
