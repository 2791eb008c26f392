"""rwkv6-1.6b — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                  # rwkv heads = d_model / rwkv_head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_size=64,
    act="relu_sq",                 # rwkv channel-mix uses squared relu
    norm="ln",
)
