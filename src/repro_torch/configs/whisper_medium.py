"""whisper-medium [audio]: 24L(enc)+24L(dec) d_model=1024 16H (MHA)
d_ff=4096 vocab=51865 — enc-dec; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, num_decoder_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
    activation="gelu",
)

SMOKE = CONFIG.with_(
    num_layers=2, num_decoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=160, vocab_size=128, compute_dtype="float32",
)
