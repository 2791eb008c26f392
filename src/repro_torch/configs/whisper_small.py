"""whisper-small — enc-dec, conv frontend (stubbed) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                 # decoder layers
    encoder_layers=12,
    cross_attention=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    frontend="audio_stub",         # precomputed mel-frame embeddings
    num_frames=1500,
    act="gelu",
    norm="ln",
    tie_embeddings=True,
)
