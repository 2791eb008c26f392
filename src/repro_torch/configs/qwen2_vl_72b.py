"""qwen2-vl-72b — M-RoPE, dynamic resolution (backbone only) [arXiv:2409.12191]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    frontend="vision_stub",        # patch embeddings precomputed by input_specs
    mrope=True,                    # 3D (t, h, w) position ids
    act="swiglu",
    norm="rms",
)
