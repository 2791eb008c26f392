"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

``wkv6(r, k, v, w, u)`` takes the model's layout: r, k, v, w of shape
(B, T, H, hs), u of shape (H, hs), a zero initial state, and returns the
outputs only, (B, T, H, hs) in r's dtype. It replaces the JAX package's
Pallas kernel (``repro/kernels/rwkv6_scan.py``, ``_wkv6_kernel`` /
``wkv6_bh``), which takes (B·H, T, hs) rows; this kernel indexes (b, t, h)
itself, so nothing is transposed, padded or copied around it.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/wkv6.cu``, built at first use by ``cuda_build``) on the current
stream, or raises; there is no fallback. bfloat16 r, k, v go to the
chunked tensor-core kernel, float32 to the step-by-step recurrence. Only a
CPU tensor takes the plain version, ``wkv6_plain``, which is the oracle
``ref.rwkv6``. ``LAUNCHES`` counts kernel launches, so a run can show that
the model went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

#: head sizes the kernel is instantiated for
HEAD_SIZES = (32, 64, 128)

_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: dtype -> the typed ctypes entry point, resolved at first launch
_FNS: dict = {}


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.rwkv6``'s outputs."""
    return ref.rwkv6(r, k, v, w, u)[0]


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hs), got {tuple(r.shape)}")
    B, T, H, hs = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} is {tuple(x.shape)}, r is "
                             f"{tuple(r.shape)}")
    if u.shape != (H, hs):
        raise ValueError(f"u must be (H, hs) = {(H, hs)}, got "
                         f"{tuple(u.shape)}")
    if r.dtype not in _ENTRY or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} is not one of {HEAD_SIZES}")
    if not (0 < B * H < 2 ** 31 and 0 < T < 2 ** 31):
        raise ValueError(f"(B*H, T) = ({B * H}, {T}) is outside the "
                         f"kernel's range")
    if len({x.device for x in (r, k, v, w, u)}) != 1:
        raise ValueError("r, k, v, w, u must lie on one device")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError("r, k, v, w, u must be contiguous")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hs) r, k, v (float32 or bfloat16) and float32 w, plus
    float32 u (H, hs) -> (B, T, H, hs) outputs in r's dtype. CUDA tensors
    launch the kernel; CPU tensors take the plain version; any other device
    raises."""
    global LAUNCHES
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu tensors, got "
                         f"{r.device}")
    if r.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (r, k, v, w)):
        # the chunked kernel stages its inputs with 16-byte copies
        raise ValueError("bfloat16 r, k, v and their w must start on a "
                         "16-byte boundary on the card")
    fn = _FNS.get(r.dtype)
    if fn is None:
        from repro_torch.core.accel import cuda_build
        fn = getattr(cuda_build.load("wkv6"), _ENTRY[r.dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[r.dtype] = fn
    B, T, H, hs = r.shape
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), out.data_ptr(), B, T, H, hs, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, H={H}, hs={hs}, "
                           f"dtype={r.dtype})")
    LAUNCHES += 1
    return out


__all__ = ["wkv6", "wkv6_plain", "LAUNCHES", "HEAD_SIZES"]
