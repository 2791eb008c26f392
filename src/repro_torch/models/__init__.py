"""The LM zoo, ported so far for the dense attention models, the MoE models
and RWKV6: the full-sequence forward and decode against a KV/state
cache."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
