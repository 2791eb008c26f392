"""Partition-time segmented reduction: the CUDA kernel's wrapper and its
plain PyTorch version.

``segmented_reduce(vals, pid, op)`` computes, for every candidate row r,
``T[r, p] = reduce_{j: pid[r, j] == p} vals[r, j]`` — max under the
streaming model, sum under spmd — with the identity (-inf for max, 0 for
sum) on segments with no member. It replaces the JAX package's Pallas
kernel (``repro/core/accel/pallas_segred.py``).

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/segred.cu``, built at first use by ``cuda_build``) on the current
stream, or raises; there is no fallback. Only a CPU tensor takes
``segmented_reduce_plain``. ``LAUNCHES`` counts kernel launches, so a run
can show that the main path went through the kernel, and ``SHAPES`` counts
them by [N, n] (which tells which of the kernel's two routes ran: staged
rows past N n^2 = 2^22, one thread an output below).

At the descent's shapes ([28, 47]) a call's time is the wrapper's host
work, so the wrapper keeps it small: the C entry point of each dtype is
resolved and typed once, and the current stream is taken without entering
a device context when the tensor's device is already the current one.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes

import torch

#: kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0
#: the same launches by (N, n), until a caller clears it
SHAPES: collections.Counter = collections.Counter()

OPS = {"max": 0, "sum": 1}

_ENTRY = {torch.float32: "segred_f32", torch.float64: "segred_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
#: the kernel's longest row (``kMaxN`` in ``csrc/segred.cu``)
MAX_N = 8192

#: dtype -> the typed ctypes entry point, resolved at first launch
_FNS: dict = {}


def segmented_reduce_plain(vals: torch.Tensor, pid: torch.Tensor,
                           op: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch. Max: one [N, n, n] partition
    one-hot and a masked max over the node axis. Sum: node j's value is
    added into its segment for j = 0 .. n-1 in turn, the kernel's (and
    ``np.add.at``'s) order, so the two agree bitwise."""
    n = vals.shape[1]
    iota = torch.arange(n, dtype=pid.dtype, device=pid.device)
    if op == "max":
        onehot = pid[:, :, None] == iota[None, None, :]      # [N, j, p]
        return torch.where(onehot, vals[:, :, None], -torch.inf).amax(dim=1)
    out = torch.zeros_like(vals)
    for j in range(n):
        out = out + torch.where(pid[:, j, None] == iota[None, :],
                                vals[:, j, None], 0.0)
    return out


def _check(vals: torch.Tensor, pid: torch.Tensor, op: str) -> None:
    """Raise on what the kernel does not take; each property is read once
    (at the mapper's shapes this is a good part of a call)."""
    if op not in OPS:
        raise ValueError(f"op must be 'max' or 'sum', got {op!r}")
    if vals.dtype not in _ENTRY:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if pid.dtype is not torch.int64:
        raise TypeError(f"pid must be int64, got {pid.dtype}")
    shape = vals.shape
    if len(shape) != 2 or pid.shape != shape:
        raise ValueError(f"vals and pid must both be [N, n]; got "
                         f"{tuple(shape)} and {tuple(pid.shape)}")
    N, n = shape
    if not (0 < N and 0 < n <= MAX_N and N * n < 2 ** 31):
        raise ValueError(f"[N, n] = [{N}, {n}] is outside the kernel's range "
                         f"(1 <= n <= {MAX_N}, 1 <= N * n < 2**31)")
    if vals.device != pid.device:
        raise ValueError(f"vals on {vals.device} but pid on {pid.device}")
    if not (vals.is_contiguous() and pid.is_contiguous()):
        raise ValueError("vals and pid must be contiguous")


def segmented_reduce(vals: torch.Tensor, pid: torch.Tensor,
                     op: str) -> torch.Tensor:
    """[N, n] vals + [N, n] int64 monotone segment ids -> [N, n] per-segment
    max or sum. CUDA tensors launch the kernel; CPU tensors take the plain
    version; any other device raises."""
    global LAUNCHES
    _check(vals, pid, op)
    if vals.device.type == "cpu":
        return segmented_reduce_plain(vals, pid, op)
    if vals.device.type != "cuda":
        raise ValueError(f"segmented_reduce runs on cuda or cpu tensors, "
                         f"got {vals.device}")
    fn = _FNS.get(vals.dtype)
    if fn is None:
        from repro_torch.core.accel import cuda_build
        fn = getattr(cuda_build.load("segred"), _ENTRY[vals.dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[vals.dtype] = fn
    N, n = vals.shape
    out = torch.empty_like(vals)
    index = vals.device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = fn(vals.data_ptr(), pid.data_ptr(), out.data_ptr(), N, n,
                 OPS[op], stream)
    if err != 0:
        raise RuntimeError(f"segred kernel launch failed: CUDA error {err} "
                           f"(N={N}, n={n}, dtype={vals.dtype}, op={op})")
    LAUNCHES += 1
    SHAPES[(N, n)] += 1
    return out


__all__ = ["segmented_reduce", "segmented_reduce_plain", "LAUNCHES",
           "SHAPES", "OPS", "MAX_N"]
