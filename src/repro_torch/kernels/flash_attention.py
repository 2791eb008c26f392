"""Flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention(q, k, v, causal=...)`` takes the model's layout: q of
shape (B, Sq, H, dh), k and v of shape (B, Skv, Hkv, dh), H a multiple of
Hkv (query head h reads KV head h // (H // Hkv)), scale 1/sqrt(dh), and
returns (B, Sq, H, dh) in q's dtype. It replaces the JAX package's Pallas
kernel (``repro/kernels/flash_attention.py``, ``_flash_kernel`` /
``flash_attention_bh``), which takes (B·H, S, dh) rows padded to its
blocks and to a head size of 128; this kernel indexes (b, s, h) itself and
masks ragged tails, so nothing is transposed, padded or copied around it.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/flash_attn.cu``, built at first use by ``cuda_build``) on the
current stream, or raises; there is no fallback. float32 goes to an exact
CUDA-core kernel, bfloat16 to a tensor-core kernel (``mma.sync``, float32
accumulators), which copies 16 bytes at a time and so takes q, k, v that
start on 16-byte boundaries (fresh tensors do). Only a CPU tensor takes
the plain version, ``flash_attention_plain``, which is the oracle
``ref.attention``. ``LAUNCHES`` counts kernel launches, so a run can show
that the model went through the kernel.

The kernel has no backward, as its Pallas original has none: with grad
mode on and an input that requires grad, the wrapper raises on either
device, so that the CPU's plain route never differentiates where the card
could not. A model that trains takes ``attn_impl="chunked"``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

#: head sizes the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention``."""
    return ref.attention(q, k, v, causal=causal)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, dh) and k, v (B, Skv, Hkv, "
                         f"dh), got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k and v must be (B, Skv, Hkv, dh) = "
                         f"{(B, Skv, Hkv, dh)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} KV "
                         f"heads")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} is not one of {HEAD_DIMS}")
    if not (0 < B * H < 2 ** 16 and 0 < Sq < 2 ** 31 and 0 < Skv < 2 ** 31):
        raise ValueError(f"(B*H, Sq, Skv) = ({B * H}, {Sq}, {Skv}) is outside "
                         f"the kernel's range")
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("q, k, v must lie on one device")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """(B, Sq, H, dh) q and (B, Skv, Hkv, dh) k, v (float32 or bfloat16, all
    alike) -> (B, Sq, H, dh) in q's dtype. CUDA tensors launch the kernel;
    CPU tensors take the plain version; any other device raises."""
    global LAUNCHES
    _check(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (nor has its Pallas original): "
            "call it under torch.no_grad() or torch.inference_mode(); a "
            "model that trains takes attn_impl='chunked'")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("bfloat16 q, k, v must start on 16-byte "
                         "boundaries (the kernel copies 16 bytes at a time)")
    from repro_torch.core.accel import cuda_build
    fn = getattr(cuda_build.load("flash_attn"), _ENTRY[q.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, Hkv, dh, int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, "
                           f"Hkv={Hkv}, dh={dh}, dtype={q.dtype})")
    LAUNCHES += 1
    return out


__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES",
           "HEAD_DIMS"]
