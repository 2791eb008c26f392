"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                     # per-expert intermediate
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    first_layer_dense=True,
    act="swiglu",
    norm="rms",
)
