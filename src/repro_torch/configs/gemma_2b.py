"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, activation="gelu", rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=160, vocab_size=128, compute_dtype="float32",
)
