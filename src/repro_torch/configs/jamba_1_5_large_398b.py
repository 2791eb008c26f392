"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_period=2,                  # every other layer MoE
    attn_period=8,                 # 1 attention layer per 8 (1:7 attn:mamba)
    ssm_d_state=16,
    ssm_expand=2,
    act="swiglu",
    norm="rms",
)
