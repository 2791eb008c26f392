from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_int8,
    compressed_psum,
    decompress_int8,
    topk_densify,
    topk_sparsify,
)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "compress_int8", "decompress_int8", "compressed_psum", "topk_sparsify",
    "topk_densify",
]
