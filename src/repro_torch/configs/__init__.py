"""Architecture registry: ``get_arch("<id>")`` resolves --arch flags."""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig,
    ShapeSpec,
    SHAPES,
    SHAPES_BY_NAME,
    reduced,
    shape_applicable,
)

from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite

ARCHS = {
    c.name: c
    for c in (
        _tinyllama,
        _llama32,
        _minitron,
        _stablelm,
        _jamba,
        _rwkv6,
        _qwen2vl,
        _whisper,
        _kimi,
        _granite,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every applicable (arch, shape) pair — the dry-run/roofline cells."""
    for arch in ARCHS.values():
        for shape in SHAPES:
            if shape_applicable(arch, shape):
                yield arch, shape


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ARCHS",
    "get_arch",
    "all_cells",
    "reduced",
    "shape_applicable",
]
