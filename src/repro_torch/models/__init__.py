"""The LM zoo, ported so far for the full-sequence forward of the dense
attention models and RWKV6."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
