"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, activation="silu", rope_theta=500000.0,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=128, compute_dtype="float32",
)
