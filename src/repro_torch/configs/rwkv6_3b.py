"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free, 40 wkv heads of 64)
d_ff=8960 vocab=65536 — Finch: data-dependent decay [arXiv:2404.05892].
O(1) decode state => long_500k runs (and is trivially cheap)."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="rwkv6-3b", family="rwkv",
    num_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
    num_heads=40, num_kv_heads=40, rwkv_head_dim=64,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, d_ff=160, vocab_size=128, num_heads=4,
    num_kv_heads=4, rwkv_head_dim=16, compute_dtype="float32",
)
