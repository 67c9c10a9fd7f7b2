"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE (t,h,w)=(16,24,24) over head_dim/2=64; dynamic-res
vision frontend is a STUB (positions carry the 3D M-RoPE coordinates)
[arXiv:2409.12191]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, activation="silu",
    mrope_sections=(16, 24, 24), rope_theta=1000000.0,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=128, mrope_sections=(4, 2, 2), compute_dtype="float32",
)
