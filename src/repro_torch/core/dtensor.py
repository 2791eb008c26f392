"""DTensor helpers of the model code: a block's input may be a DTensor
(the sharded steps, ``launch/steps.py``), and then the tensors that the
block makes for itself (positions, rotary tables, masks, accumulators,
the MoE dispatch buffers) must live on the same ``DeviceMesh``.

On plain tensors every helper returns its argument unchanged, so the
one-device path computes exactly what it computed before.

  mesh_of       the ``DeviceMesh`` of a DTensor, None for a plain tensor
  replicated    a plain tensor, the same on every rank, as a replicated
                DTensor on ``ref``'s mesh
  placed_like   a plain tensor laid out like ``ref`` on the dimensions
                they share (each rank keeps its own slice: no
                communication)
  full_local    a DTensor gathered to every rank, as a plain tensor: for
                ops with no DTensor sharding rule (sort, cummax, scatter),
                which then run on the whole tensor on every rank
  whole_along   a DTensor gathered along one tensor dimension
  gather_last   ``x[..., idx]`` along the last dimension, shard by shard
  logsumexp_last  ``logsumexp`` over the last dimension, shard by shard
  reduced       a DTensor's pending partial sums taken
  local         a DTensor's local shard (a plain tensor as it is)
  local_offset  where this rank's shard starts along a dimension
  matmul        an activation times a weight, shard by shard where
                DTensor's own product cannot
  embed         ``table[tokens]``, shard by shard
  split_heads   the last dimension split into heads
"""
from __future__ import annotations

from typing import Dict

import torch


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and isinstance(x, _dtensor())


def mesh_of(x):
    return x.device_mesh if is_dtensor(x) else None


def replicated(ref, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor (every rank must hold the same ``t``); else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = ref.device_mesh
    return _dtensor().from_local(t, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)


def placed_like(ref, t: torch.Tensor, dims: Dict[int, int]) -> torch.Tensor:
    """``t`` laid out like ``ref`` where ``ref`` is a DTensor: ``ref``'s
    dimension ``d`` sharded over a mesh dimension shards ``t``'s
    ``dims[d]`` over it; the rest is replicated. A plain ``t`` (the same
    on every rank) is sliced by each rank, with no communication; a
    DTensor ``t`` is redistributed."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in ref.placements:
        if isinstance(p, Shard) and p.dim in dims:
            out.append(Shard(dims[p.dim]))
        else:
            out.append(Replicate())
    t = replicated(ref, t)
    return t if list(t.placements) == out else \
        t.redistribute(ref.device_mesh, out)


def full_local(x) -> torch.Tensor:
    """A DTensor gathered to every rank, as a plain tensor (its
    gradient flows back as the replicated DTensor's); else ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def replicated_on(mesh, t: torch.Tensor) -> torch.Tensor:
    """The plain ``t`` (the same on every rank) as a replicated DTensor on
    ``mesh``; ``t`` itself when ``mesh`` is None."""
    if mesh is None:
        return t
    from torch.distributed.tensor import Replicate
    return _dtensor().from_local(t, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)


def whole_along(x, dim: int):
    """A DTensor gathered along tensor dimension ``dim`` (replicated on
    the mesh dimensions that shard it, laid out as before on the others);
    else ``x``. For a loop that slices ``dim``: one gather, not one a
    slice."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last dimension:
    ``torch.gather(x, -1, idx[..., None])[..., 0]``. On a DTensor ``x``
    each rank gathers from its own shards, ``idx`` laid out to match: a
    leading dimension sharded stays so; the last dimension (a vocabulary)
    sharded over a mesh dimension gives each rank the entries it holds and
    zeros elsewhere, a partial sum there, as ``embed`` does; nothing is
    gathered whole. (DTensor's own gather there gathers the last dimension
    whole, and its backward makes a zero tensor of the global shape on
    every rank.)"""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    x = reduced(x)
    mesh = x.device_mesh
    i_want, out, x_grad = [], [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim < last:
            i_want.append(p)
            out.append(p)
        else:
            i_want.append(Replicate())
            out.append(Partial() if isinstance(p, Shard) else Replicate())
        x_grad.append(p)
    idx = replicated(x, idx)
    if list(idx.placements) != i_want:
        idx = idx.redistribute(mesh, i_want)
    lx, li = x.to_local(grad_placements=x_grad), idx.to_local()
    if any(isinstance(p, Shard) and p.dim == last for p in x.placements):
        rel = li - local_offset(x, last)
        inside = (rel >= 0) & (rel < lx.shape[-1])
        g = torch.gather(lx, -1, rel.clamp(0, max(lx.shape[-1] - 1, 0))
                         [..., None])[..., 0]
        g = torch.where(inside, g, torch.zeros_like(g))
    else:
        g = torch.gather(lx, -1, li[..., None])[..., 0]
    return _dtensor().from_local(g, mesh, out, run_check=False,
                                 shape=idx.shape, stride=idx.stride())


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``. On a DTensor whose last dimension
    is sharded over more than one rank: each rank's shard maximum, taken
    over the ranks (an all-reduce of one value a row), then the sums of
    ``exp(x - max)``, summed over the ranks the same way; nothing is
    gathered whole (DTensor's own ``logsumexp`` gathers the last
    dimension). Otherwise ``torch.logsumexp``."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Shard
    last = x.ndim - 1
    if not any(isinstance(p, Shard) and p.dim == last
               and x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements)):
        return torch.logsumexp(x, dim=-1)
    m = reduced(x.detach().amax(dim=-1, keepdim=True))
    s = reduced(torch.sum(torch.exp(x - m), dim=-1))
    return torch.log(s) + m[..., 0]


def reduced(x):
    """A DTensor's pending (partial) sums taken over their mesh dimensions,
    so that it is replicated there; else ``x``. (DTensor's gather over a
    sharded dimension leaves a masked partial sum that its later
    reductions mishandle once a dimension is indexed away.)"""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def local(x) -> torch.Tensor:
    return x.to_local() if is_dtensor(x) else x


def local_offset(x, dim: int) -> int:
    """The global index of the first row of this rank's shard of DTensor
    ``x`` along ``dim`` (0 for a plain tensor): DTensor's shards are
    ``torch.chunk``'s, ceil(n / k) rows each and the last ones short or
    empty, taken mesh dimension by mesh dimension. Pure arithmetic on the
    mesh coordinate, so it also runs on fake tensors."""
    if not is_dtensor(x):
        return 0
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    size, off = int(x.shape[dim]), 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            chunk = -(-size // k)
            start = min(coord[i] * chunk, size)
            size, off = max(min(size, start + chunk) - start, 0), off + start
    return off


def matmul(x, w):
    """``x @ w`` for an activation (..., K) and a weight (K, N). On a
    DTensor ``x`` each rank multiplies its shards: DTensor's own product
    flattens the leading dimensions, and a shard of any but the first
    becomes a strided shard that its ``mm`` rule refuses. Per mesh
    dimension: a leading dimension of ``x`` sharded stays so (the weight
    gathered there); the weight's columns sharded stay so; ``K`` sharded
    (``x``'s last dimension, or the weight's rows, the other operand then
    sliced to match) leaves a partial sum. Otherwise ``x @ w``."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    x = reduced(x)
    w = replicated(x, w)
    mesh = x.device_mesh
    # per mesh dimension: the operands' layouts, the product's, and the
    # layouts of the gradients that each rank's local product gives (a
    # partial sum where the other operand's shard saw part of it)
    x_want, w_want, out, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            x_want.append(xp)
            w_want.append(Replicate())
            out.append(xp)
            x_grad.append(xp)
            w_grad.append(Partial())
        elif isinstance(xp, Shard) or (isinstance(wp, Shard)
                                       and wp.dim == 0):
            x_want.append(Shard(last))
            w_want.append(Shard(0))
            out.append(Partial())
            x_grad.append(Shard(last))
            w_grad.append(Shard(0))
        elif isinstance(wp, Shard):
            x_want.append(Replicate())
            w_want.append(wp)
            out.append(Shard(last))
            x_grad.append(Partial())
            w_grad.append(wp)
        else:
            x_want.append(Replicate())
            w_want.append(Replicate())
            out.append(Replicate())
            x_grad.append(Replicate())
            w_grad.append(Replicate())
    if list(x.placements) != x_want:
        x = x.redistribute(mesh, x_want)
    if list(w.placements) != w_want:
        w = w.redistribute(mesh, w_want)
    o = x.to_local(grad_placements=x_grad) @ \
        w.to_local(grad_placements=w_grad)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    return _dtensor().from_local(o, mesh, out, run_check=False,
                                 shape=shape, stride=_contiguous(shape))


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, out = 1, []
    for n in reversed(shape):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On DTensors each rank looks up its own shards
    (DTensor's rule for the index's backward varies between PyTorch
    versions): a table whose rows (the vocabulary) are sharded over a
    mesh dimension gives each rank the rows it holds and zeros elsewhere,
    a partial sum there (the tokens gathered there); a table sharded on
    its columns gives the output's last dimension sharded (the tokens
    gathered); a replicated table keeps the tokens' layout."""
    if not is_dtensor(table) and not is_dtensor(tokens):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    table, tokens = replicated(tokens, table), replicated(table, tokens)
    mesh = table.device_mesh
    last = tokens.ndim
    k_want, out, t_grad = [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        if isinstance(tp, Shard):
            k_want.append(Replicate())
            out.append(Partial() if tp.dim == 0 else Shard(last))
            t_grad.append(tp)
        else:
            k_want.append(kp)
            out.append(kp)
            t_grad.append(Partial() if isinstance(kp, Shard) else Replicate())
    if list(tokens.placements) != k_want:
        tokens = tokens.redistribute(mesh, k_want)
    lt, li = table.to_local(grad_placements=t_grad), tokens.to_local()
    if any(isinstance(p, Shard) and p.dim == 0 for p in table.placements):
        rel = li - local_offset(table, 0)
        inside = (rel >= 0) & (rel < lt.shape[0])
        rows = lt[rel.clamp(0, max(lt.shape[0] - 1, 0))]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    else:
        rows = lt[li]
    shape = tuple(tokens.shape) + (table.shape[1],)
    return _dtensor().from_local(rows, mesh, out, run_check=False,
                                 shape=shape, stride=_contiguous(shape))


def split_heads(x, shape):
    """``x.reshape(shape)``, the last dimension split into (heads, head
    size). A DTensor whose last dimension is sharded over more shards than
    the heads divide into is gathered along it first (DTensor cannot split
    an uneven shard)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        last, k = x.ndim - 1, 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                k *= x.device_mesh.size(i)
        if shape[-2] % k:
            x = whole_along(x, last)
    return x.reshape(shape)


__all__ = ["is_dtensor", "mesh_of", "replicated", "placed_like",
           "full_local", "replicated_on", "whole_along", "gather_last",
           "logsumexp_last", "reduced", "local", "local_offset", "matmul",
           "embed", "split_heads"]
