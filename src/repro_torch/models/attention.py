"""GQA attention (self / cross / encoder) with an optional decode cache.

The PyTorch counterpart of the JAX package's ``models/attention.py``. The
scaled-dot-product core (``sdpa``) dispatches to the hand-written
flash-attention kernel through ``kernels/ops.py`` (``impl="flash"``), to
the online-softmax oracle (``"chunked"``) or to the full-softmax oracle
(``"ref"``).

The decode cache is written in place: this step's K/V go into the
caller's buffers at ``cache_pos`` (self-attention), and a prefill's
cross-attention K/V into the cross cache's buffers where they fit; the
returned cache holds the same tensors. JAX's ``attend`` returns a new
cache instead, and its serve loop donates the old one, so nothing of the
caller sees the difference; a caller that wants the old cache again clones
it first.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.dtensor import (is_dtensor, local_offset, matmul,
                                     placed_like, replicated, split_heads,
                                     whole_along)
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (apply_mrope, apply_rope, block_norm,
                                       dense_init, init_norm)


def init_attention(gen: Optional[torch.Generator], d_model: int,
                   num_heads: int, num_kv_heads: int, head_dim: int,
                   norm: str, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }
    p.update({f"ln_{k}": v
              for k, v in init_norm(d_model, norm, dtype, device).items()})
    return p


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         q_offset: int = 0, impl: str = "ref") -> torch.Tensor:
    """q: (B,Sq,H,dh) k,v: (B,Skv,Hkv,dh) -> (B,Sq,H,dh).

    impl: ref     — naive S x S softmax (oracle; O(S^2) memory)
          chunked — online softmax over KV blocks in plain PyTorch
          flash   — the hand-written CUDA kernel (its plain version on CPU
                    tensors)

    DTensors (a sharded step) run on each rank's shards
    (``_sdpa_on_shards``; the chunked oracle over a decode cache sharded
    along its length: ``_sdpa_split_kv``).
    """
    if is_dtensor(q):
        split = _split_kv_dims(q, k) if impl == "chunked" else []
        if split:
            return _sdpa_split_kv(q, k, v, split, causal, q_offset)
        return _sdpa_on_shards(q, k, v, causal, q_offset, impl)
    if impl == "flash":
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "chunked":
        return ref.attention_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return ref.attention(q, k, v, causal=causal, q_offset=q_offset)


def _sdpa_on_shards(q, k, v, causal: bool, q_offset, impl: str):
    """``sdpa`` of DTensors, rank by rank: attention is independent across
    batch rows and heads, so each rank attends its own (batch, query,
    head) shard of q over K/V whole along the keys, laid out as q's batch,
    with the KV heads its query heads read (``_local_kv_heads``): K/V keep
    their heads' shards where each rank's query heads read exactly its own
    KV heads (``_heads_aligned``), else are gathered along the heads; the
    causal offset is shifted by where the rank's query rows start. The
    output has q's layout."""
    from torch.distributed.tensor import DTensor, Partial

    group = q.shape[2] // k.shape[2]
    q = whole_along(q, 3)
    aligned = _heads_aligned(q, k)

    def kv(t):
        t = whole_along(t, 1)
        t = placed_like(q, t if aligned else whole_along(t, 2),
                        {0: 0, 2: 2} if aligned else {0: 0})
        # where q's query rows, or heads that the K/V heads do not follow,
        # are sharded, each rank's K/V gradient is the part its rows and
        # heads give: a partial sum there
        grad = [Partial() if getattr(p, "dim", None) == 1 or
                (getattr(p, "dim", None) == 2 and not aligned) else tp
                for p, tp in zip(q.placements, t.placements)]
        return _local_kv_heads(q, t.to_local(grad_placements=grad), group)

    k, v = kv(k), kv(v)
    o = sdpa(q.to_local(), k, v, causal, q_offset + local_offset(q, 1),
             impl)
    return DTensor.from_local(o.contiguous(), q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def _heads_aligned(q, k) -> bool:
    """Whether K/V may keep their heads sharded as q's: the query heads
    and the KV heads both divide evenly over the ranks that shard q's
    heads, so that each rank's query heads read exactly its own KV heads
    (GQA's groups do not straddle ranks)."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 2:
            n *= q.device_mesh.size(i)
    return q.shape[2] % n == 0 and k.shape[2] % n == 0


def _local_kv_heads(q, t: torch.Tensor, group: int) -> torch.Tensor:
    """The KV heads of ``t`` (a rank's K or V: its own KV heads, or every
    KV head) that this rank's query heads of the DTensor ``q`` read, GQA's
    ``group`` query heads a KV head: ``t`` itself where it holds just
    those; a slice where the rank's heads cover whole groups (in both
    cases ``sdpa`` repeats them in float32, as on one device, and a
    gradient is summed as there); else the heads repeated to one a query
    head."""
    h0, hl = local_offset(q, 2), q.to_local().shape[2]
    if t.shape[2] * group == hl:
        return t
    if h0 % group == 0 and hl % group == 0:
        return t[:, :, h0 // group:(h0 + hl) // group]
    return t.repeat_interleave(group, dim=2)[:, :, h0:h0 + hl]


def _split_kv_dims(q, k) -> list:
    """The mesh dimensions over which ``k``'s length is sharded (over more
    than one rank) while ``q`` is replicated: a decode step against a cache
    sharded along its length."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(k):
        return []
    mesh = k.device_mesh
    return [i for i, (qp, kp) in enumerate(zip(q.placements, k.placements))
            if isinstance(kp, Shard) and kp.dim == 1 and mesh.size(i) > 1
            and isinstance(qp, Replicate)]


def _sdpa_split_kv(q, k, v, split, causal: bool, q_offset):
    """``sdpa`` of DTensors with the keys split (JAX's program does the
    same): over the mesh dimensions ``split`` each rank attends to its own
    shard of the cache's length with the chunked oracle, and the ranks'
    outputs are combined by their log-sum-exps (an all-reduce of the
    maximum, then of the weighted sums: one value a row and the rows'
    outputs), so that no rank gathers the cache. Elsewhere K/V are laid
    out as q's batch and, as in ``_sdpa_on_shards``, with the KV heads of
    the rank's query heads. For inference: the combine runs on plain
    local tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    group = q.shape[2] // k.shape[2]
    q = whole_along(q, 3)
    mesh = q.device_mesh
    aligned = _heads_aligned(q, k)
    want = [Shard(1) if i in split else
            (p if isinstance(p, Shard) and (p.dim == 0 or
                                            (p.dim == 2 and aligned)) else
             Replicate()) for i, p in enumerate(q.placements)]

    def kv(t):
        t = t if aligned else whole_along(t, 2)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return _local_kv_heads(q, t.to_local(), group)

    start = local_offset(k, 1)
    lk, lv = kv(k), kv(v)
    o, lse = ref.attention_chunked(
        q.to_local().float(), lk, lv, causal=causal,
        q_offset=q_offset + local_offset(q, 1) - start, with_lse=True)

    # the ranks' rows combined: lse (B, H, Sq) is laid out as q (B, Sq, H)
    def over(t, op, dims):
        place = [Partial(op) if i in split else
                 (Shard(dims[p.dim]) if isinstance(p, Shard) and
                  p.dim in dims else Replicate())
                 for i, p in enumerate(q.placements)]
        d = DTensor.from_local(t, mesh, place, run_check=False)
        return d.redistribute(mesh, [Replicate() if i in split else pl
                                     for i, pl in enumerate(place)]
                              ).to_local()

    top = over(lse, "max", {0: 0, 1: 2, 2: 1})
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lse - top).transpose(1, 2)[..., None]     # (B, Sq, H, 1)
    num = over(o * w, "sum", {0: 0, 1: 1, 2: 2})
    den = over(w, "sum", {0: 0, 1: 1, 2: 2})
    out = (num / torch.where(den == 0.0, 1.0, den)).to(q.dtype)
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def attend(x: torch.Tensor, p: Dict[str, torch.Tensor], *,
           num_heads: int, num_kv_heads: int, head_dim: int,
           norm: str, causal: bool = True,
           positions: Optional[torch.Tensor] = None,
           rope_theta: float = 10000.0,
           mrope_positions: Optional[torch.Tensor] = None,
           kv_src: Optional[torch.Tensor] = None,
           cache: Optional[Dict[str, torch.Tensor]] = None,
           cache_pos: Optional[torch.Tensor] = None,
           write_cross: bool = False,
           attn_impl: str = "ref",
           shard_fn=lambda a, role=None: a):
    """One attention block with pre-norm and residual. Returns
    (y, new_cache): x plus the attention output, in x's dtype.

    positions        (B, S) rotary positions; None applies no rotation.
    mrope_positions  (3, B, S) multimodal positions, used instead of
                     ``positions`` when given.
    kv_src           cross-attention source (the encoder's output, (B, F,
                     D)); None is self-attention. Cross-attention has no
                     rotation and is as causal as ``causal`` says (the
                     model passes False).
    cache            self-attention: {"k", "v"}: (B, L, Hkv, dh) decode
                     caches. With ``cache_pos`` (an int or a 0-d integer
                     tensor) this step's K/V are written at that position,
                     cast to the cache's dtype, in place, and the queries
                     attend over the whole cache from ``q_offset =
                     cache_pos``. Without it the new cache is this step's
                     K/V in the cache's dtype.
                     cross-attention: {"k", "v"}: (B, F, Hkv, dh).
    write_cross      prefill: compute the cross K/V from ``kv_src``, attend
                     to them as computed and store them in the cache's
                     dtype (in place where they fit the buffers); without
                     it a cross-attention with a cache reads the stored
                     K/V and leaves them as they are (decode). JAX's model
                     passes no ``kv_src`` at decode, so its cross-attention
                     then attends to the decoded token's own K/V and
                     replaces the stored ones by them, against this
                     docstring's contract (ROADMAP Queue 3); the port's
                     model passes the cached encoder output and
                     ``write_cross=False``, and so reads the stored K/V."""
    B, Sq, _ = x.shape
    h = block_norm(x, p, norm)
    q = split_heads(matmul(h, p["wq"]), (B, Sq, num_heads, head_dim))
    if cache is not None and kv_src is not None and not write_cross:
        # cross-attention with the K/V the prefill stored
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        src = kv_src if kv_src is not None else h
        S = src.shape[1]
        k = split_heads(matmul(src, p["wk"]), (B, S, num_kv_heads, head_dim))
        v = split_heads(matmul(src, p["wv"]), (B, S, num_kv_heads, head_dim))
        if kv_src is None and positions is not None:
            if mrope_positions is not None:
                q = apply_mrope(q, mrope_positions, rope_theta)
                k = apply_mrope(k, mrope_positions[:, :, :S]
                                if mrope_positions.shape[-1] != S
                                else mrope_positions, rope_theta)
            else:
                q = apply_rope(q, positions, rope_theta)
                k = apply_rope(k, positions[:, :S]
                               if positions.shape[-1] != S else positions,
                               rope_theta)
        new_cache = cache
        if cache is not None and kv_src is None and cache_pos is not None:
            # prefill/decode: insert this step's K/V at cache_pos
            k = _write(cache["k"], k, cache_pos)
            v = _write(cache["v"], v, cache_pos)
        elif cache is not None:
            new_cache = {"k": _fill(cache["k"], k), "v": _fill(cache["v"], v)}
    q = shard_fn(q, role="heads")
    q_offset = cache_pos if cache_pos is not None else 0
    o = sdpa(q, k, v, causal=causal and kv_src is None, q_offset=q_offset,
             impl=attn_impl)
    y = matmul(o.reshape(B, Sq, num_heads * head_dim), p["wo"])
    return x + shard_fn(y, role="boundary"), new_cache


def _fill(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new`` in buf's dtype: copied into ``buf`` in place where it has
    buf's shape (returns buf), else a new tensor."""
    if new.shape == buf.shape:
        return buf.copy_(new)
    return new.to(buf.dtype)


def _write(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """``buf[:, pos:pos + S] = new`` in place, in buf's dtype, with the
    start clamped to [0, L - S] as ``dynamic_update_slice`` clamps it; a
    tensor ``pos`` stays on the device (no host sync). Returns buf. A
    DTensor ``buf`` is written shard by shard (``_write_shards``)."""
    if is_dtensor(buf):
        return _write_shards(buf, new, pos)
    S, L = new.shape[1], buf.shape[1]
    idx = torch.arange(S, device=buf.device)
    if isinstance(pos, int):
        idx = idx + min(max(pos, 0), L - S)
    else:
        idx = idx + pos.to(buf.device).clamp(0, L - S)
    return buf.index_copy_(1, idx, new.to(buf.dtype))


def _write_shards(buf, new, pos):
    """``_write`` on a DTensor cache (B, L, Hkv, dh): ``new`` is laid out
    as ``buf`` but whole along the length, and each rank writes the rows
    of its own shard. Where the length is not sharded that is ``_write``
    on the local tensors; where it is, each rank's shard takes the rows
    of ``new`` that fall in it by a ``where`` over the shard (a tensor
    ``pos`` needs no host sync)."""
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in buf.placements]
    if not is_dtensor(new):
        new = replicated(buf, new)
    ln = new.redistribute(buf.device_mesh, want).to_local()
    lb = buf.to_local()
    S, L, n = new.shape[1], buf.shape[1], lb.shape[1]
    if n == L:
        _write(lb, ln, pos)
        return buf
    start = (min(max(pos, 0), L - S) if isinstance(pos, int)
             else pos.to(lb.device).clamp(0, L - S))
    j = torch.arange(n, device=lb.device) + local_offset(buf, 1) - start
    inside = ((j >= 0) & (j < S))[None, :, None, None]
    rows = ln.index_select(1, j.clamp(0, S - 1)).to(lb.dtype)
    lb.copy_(torch.where(inside, rows, lb))
    return buf


__all__ = ["init_attention", "sdpa", "attend"]
