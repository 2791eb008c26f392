"""The LM zoo, ported so far for RWKV6's full-sequence forward."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
