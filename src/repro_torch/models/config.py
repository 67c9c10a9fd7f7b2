"""Unified LM architecture config covering all 10 assigned families.

The port's own copy of ``repro.models.config`` (plain dataclasses; the
port never imports the JAX package).  One dataclass; family-specific
fields are ignored by other families.  ``configs/<arch>.py`` instantiates
these with the exact assigned values and provides a ``SMOKE`` reduction
for CPU tests.  The port runs every family (``models.api``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 => dense)
    top_k: int = 2
    num_shared: int = 0           # always-on shared experts (deepseek)
    d_ff_expert: int = 0          # ff dim per (routed/shared) expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                   # dense | moe | encdec | vlm | hybrid | rwkv
    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0             # 0 => d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000
    activation: str = "silu"      # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen1.5
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig = MoEConfig()
    # encoder-decoder (whisper)
    num_decoder_layers: int = 0   # >0 => enc-dec; num_layers = encoder layers
    # SSM / hybrid (zamba2, rwkv6)
    ssm_state: int = 0            # mamba2 state size per head
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0           # hybrid: a (shared) attention block every N
    rwkv_head_dim: int = 64
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # embedding tables padded up so the vocab dim shards on the mesh
    # (odd vocabs like whisper's 51865 otherwise force replicated logits)
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.num_decoder_layers > 0

    def with_(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP model (for roofline §Roofline) --------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + self.num_heads * hd * d
        if self.family == "rwkv":
            # r,k,v,g,w projections + output + channel-mix
            blk = 6 * d * d + 3 * d * self.d_ff
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            mamba = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d \
                + self.ssm_conv * (d_in + 2 * self.ssm_state)
            blk = mamba + 3 * d * self.d_ff
        elif self.is_moe:
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff_expert
            shared = m.num_shared * 3 * d * m.d_ff_expert
            blk = attn + routed + shared + d * m.num_experts
        else:
            blk = attn + 3 * d * self.d_ff
        layers = self.num_layers + self.num_decoder_layers
        n = layers * blk + v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:  # cross-attention in decoder
            n += self.num_decoder_layers * attn
        return n

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6 N_active D)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        m = self.moe
        hd = self.resolved_head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + self.num_heads * hd * d
        blk = attn + (m.top_k + m.num_shared) * 3 * d * m.d_ff_expert \
            + d * m.num_experts
        return self.num_layers * blk + self.vocab_size * d * 2
