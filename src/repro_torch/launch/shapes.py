"""Input stand-ins for every (arch x shape) cell.

``input_specs(arch, shape)`` returns the batch tree the step functions
take as tensors on the ``meta`` device (JAX's ``ShapeDtypeStruct``s), and
``make_batch`` a concrete random batch of the same structure, drawn from
a ``torch.Generator``. The modality frontends are stubs, as in the JAX
package:

  whisper   ``frames`` carries precomputed log-mel frame embeddings
            (B, num_frames, d_model)
  qwen2-vl  ``mrope_positions`` carries the 3D (temporal, height, width)
            position ids the vision frontend would emit
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeSpec,
                batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """Batch tree of ``meta`` tensors for one cell."""
    B = batch_override or shape.global_batch
    mode = shape.mode
    S = shape.seq_len if mode != "decode" else 1

    batch = {"tokens": _meta((B, S), torch.int32)}
    if mode == "train":
        batch["labels"] = _meta((B, S), torch.int32)

    if arch.frontend == "audio_stub" and mode != "decode":
        F = arch.num_frames or 1500
        batch["frames"] = _meta((B, F, arch.d_model), torch.bfloat16)
    if arch.mrope:
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
    return batch


def make_batch(arch: ArchConfig, shape: ShapeSpec,
               generator: torch.Generator, batch_override: int = 0
               ) -> Dict[str, torch.Tensor]:
    """Concrete random batch with the same structure, drawn from
    ``generator`` in the specs' order on its device: integers uniform
    below the vocabulary (or the last axis's length), floats standard
    normal."""
    out: Dict[str, torch.Tensor] = {}
    for name, spec in input_specs(arch, shape, batch_override).items():
        if spec.dtype == torch.int32:
            hi = arch.vocab_size if name in ("tokens", "labels") else max(
                spec.shape[-1], 2)
            out[name] = torch.randint(0, hi, spec.shape, generator=generator,
                                      dtype=torch.int32,
                                      device=generator.device)
        else:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=generator.device).to(spec.dtype)
    return out


__all__ = ["input_specs", "make_batch"]
