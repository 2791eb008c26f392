"""The LM zoo's model, ported for the dense attention models, the MoE
models and RWKV6: the full-sequence forward and decode against a cache.

The PyTorch counterpart of the JAX package's ``models/model.py``. A model
is a chain of *segments*; each segment is a homogeneous stack of
layer-groups over stacked parameters (leading ``count`` axis), walked by a
Python loop where JAX runs ``lax.scan``. ``Segment`` and ``build_segments``
are verbatim copies.

``Model`` is an ``nn.Module`` that holds its parameters: its
``state_dict()`` keys are the JAX parameter tree's paths joined by ``.``
(``dec0.p0_rwkv_tmix.wr``), with JAX's shapes and dtypes, so weights carry
across key for key (``models/convert.py``). ``forward(batch)`` and
``loss(batch)`` take JAX's batch dict (``tokens``, ``labels``, optional
``loss_mask``) and return what JAX's ``forward(params, batch)`` and
``loss(params, batch)`` return, under ``torch.inference_mode()``: there is
no backward in the port yet.

Ported so far: the ``attn`` / ``ffn`` blocks (rotary self-attention and
the feed-forward, as dense models such as tinyllama-1.1b chain them), the
``moe`` block and the ``rwkv_tmix`` / ``rwkv_cmix`` blocks. With
``use_flash=True`` attention runs in the hand-written flash-attention
kernel (``csrc/flash_attn.cu``) and the WKV recurrence in the WKV kernel
(``csrc/wkv6.cu``), as JAX's ``use_flash`` runs its Pallas kernels;
``attn_impl`` picks ``ref``, ``chunked`` or ``flash`` attention directly.

Decode: ``init_cache`` builds JAX's cache tree, and ``forward(batch,
cache=..., cache_pos=...)`` returns ``(logits, new_cache)`` in that tree.
The cache is updated in place wherever the new value fits its buffer
(shape and dtype): attention writes this step's K/V into the caller's
buffers, and a carried RWKV state is copied into its buffer. Where it does
not fit, the new leaf is a new tensor, as JAX's is: a float32 model's RWKV
``shift`` after a prefill into the default bfloat16 cache keeps ``h``'s
float32. JAX returns a new cache every call and its serve loop donates the
old one, so in place changes nothing its callers see; a caller that wants
an old cache again clones it first. Cache-carrying decode takes the
oracles, as JAX's does: a tensor ``cache_pos`` sends flash attention to
``ref.attention`` and a carried RWKV state to ``ref.rwkv6``. The ``ssm``
(ROADMAP Queue 1 item 13c), ``cross_attn`` and ``enc_*`` (item 13d) blocks
raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class Segment:
    name: str
    pattern: Tuple[str, ...]        # block kinds per layer-group
    count: int                      # scan length
    layer_of: Tuple[int, ...]       # global layer index offset of each pattern pos
    encoder: bool = False


def build_segments(arch: ArchConfig,
                   layer_range: Optional[Tuple[int, int]] = None) -> List[Segment]:
    lo, hi = layer_range if layer_range else (0, arch.num_layers)
    segs: List[Segment] = []

    if arch.encoder_layers and (layer_range is None or lo == 0):
        segs.append(Segment("enc", ("enc_attn", "enc_ffn"),
                            arch.encoder_layers,
                            (0, 0), encoder=True))

    def block_pattern(i: int) -> Tuple[str, ...]:
        kinds = []
        mixer = arch.layer_kind(i)
        if mixer == "attn":
            kinds.append("attn")
            if arch.cross_attention:
                kinds.append("cross_attn")
        elif mixer == "ssm":
            kinds.append("ssm")
        else:
            kinds.append("rwkv_tmix")
        fk = arch.ffn_kind(i)
        if mixer == "rwkv":
            kinds.append("rwkv_cmix")
        else:
            kinds.append(fk)
        return tuple(kinds)

    # group layers into runs with a repeating pattern of period `attn_period`
    period = max(arch.attn_period, 1)
    i = lo
    while i < hi:
        if arch.first_layer_dense and i == 0:
            segs.append(Segment("dec0", block_pattern(0), 1, (0,)))
            i += 1
            continue
        # find the maximal run starting at i where pattern repeats with
        # period `period` (jamba needs i aligned to the period)
        if period > 1 and i % period != 0:
            run = period - (i % period)
            run = min(run, hi - i)
        else:
            run = hi - i
            if period > 1:
                run -= run % period
                if run == 0:
                    run = hi - i
        group = min(period, run) if period > 1 else 1
        n_groups = max(1, run // group)
        pattern: Tuple[str, ...] = ()
        layer_of: Tuple[int, ...] = ()
        for j in range(group):
            pat = block_pattern(i + j)
            pattern += pat
            layer_of += (j,) * len(pat)
        segs.append(Segment(f"dec{i}", pattern, n_groups, layer_of))
        i += group * n_groups
    return segs


_INIT = {
    "attn": lambda gen, arch, device: A.init_attention(
        gen, arch.d_model, arch.num_heads, arch.num_kv_heads, arch.head_dim,
        arch.norm, device=device),
    "ffn": lambda gen, arch, device: L.init_ffn(
        gen, arch.d_model, arch.d_ff, arch.act, arch.norm, device=device),
    "moe": lambda gen, arch, device: M.init_moe(
        gen, arch.d_model, arch.d_ff, arch.num_experts, arch.act, arch.norm,
        device=device),
    "rwkv_tmix": lambda gen, arch, device: R.init_rwkv_tmix(
        gen, arch.d_model, arch.rwkv_head_size, arch.norm, device=device),
    "rwkv_cmix": lambda gen, arch, device: R.init_rwkv_cmix(
        gen, arch.d_model, arch.d_ff, arch.norm, device=device),
}


#: ROADMAP Queue 1 items of the block kinds still to port
_ITEM = {"ssm": "13c", "cross_attn": "13d", "enc_attn": "13d",
         "enc_ffn": "13d"}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port runs the attn, "
        f"ffn, moe and RWKV6 blocks, with and without a decode cache "
        f"(ROADMAP Queue 1 item {_ITEM.get(kind, '13')}: item 13c the ssm "
        f"block, item 13d the cross_attn and enc_* blocks)")


def _module(tree: Dict[str, Any]) -> nn.Module:
    """Nested dicts of tensors as nested ``ModuleDict`` / ``ParameterDict``,
    so that ``state_dict()`` keys are the tree's paths joined by ``.``."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _tree(mod: nn.Module) -> Dict[str, Any]:
    if isinstance(mod, nn.ParameterDict):
        return dict(mod.items())
    return {k: _tree(m) for k, m in mod.items()}


class Model(nn.Module):
    """``Model(arch, ..., device=None, generator=None)``: the JAX ``Model``'s
    arguments, plus where the parameters live and what draws them.
    ``device=None`` is the card (``runtime.resolve_device``: no card, no
    CPU fallback); ``device="meta"`` allocates nothing, for shapes, or for
    ``load_state_dict(..., assign=True)``. ``remat`` and ``unroll`` are kept
    for the signature and do nothing: there is no backward and no scan."""

    def __init__(self, arch: ArchConfig,
                 layer_range: Optional[Tuple[int, int]] = None,
                 include_embed: bool = True, include_head: bool = True,
                 use_flash: bool = False, remat: bool = True,
                 unroll: bool = False, attn_impl: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = arch
        self.segments = build_segments(arch, layer_range)
        for seg in self.segments:
            for kind in seg.pattern:
                if kind not in _INIT:
                    raise _not_ported(kind)
        self.include_embed = include_embed
        self.include_head = include_head
        self.use_flash = use_flash
        # attention implementation: ref | chunked | flash (JAX's sdpa)
        self.attn_impl = attn_impl or ("flash" if use_flash else "ref")
        self.remat = remat
        self.unroll = unroll
        for name, sub in self.init_params(generator, device).items():
            self.add_module(name, _module(sub))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, Any]:
        """The JAX ``init_params`` tree (names, shapes, dtypes) as tensors
        on ``device``, drawn from ``generator``."""
        arch = self.arch
        device = resolve_device(device)
        params: Dict[str, Any] = {}
        need_embed = self.include_embed or (self.include_head
                                            and arch.tie_embeddings)
        if need_embed:
            params["embed"] = {"table": L.dense_init(
                generator, arch.vocab_size, arch.d_model, device=device)}
        for seg in self.segments:
            seg_params = {}
            for j, kind in enumerate(seg.pattern):
                layers = [_INIT[kind](generator, arch, device)
                          for _ in range(seg.count)]
                seg_params[f"p{j}_{kind}"] = {
                    k: torch.stack([p[k] for p in layers])
                    for k in layers[0]}
            params[seg.name] = seg_params
        if self.include_head:
            params["final_norm"] = {
                f"ln_{k}": v for k, v in
                L.init_norm(arch.d_model, arch.norm, device=device).items()}
            if not arch.tie_embeddings:
                params["head"] = {"w": L.dense_init(
                    generator, arch.d_model, arch.vocab_size, device=device)}
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return self.init_params(None, "meta")

    def params(self) -> Dict[str, Any]:
        """The parameters this module holds, as the JAX tree."""
        return {name: _tree(mod) for name, mod in self.named_children()}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, batch: Dict[str, torch.Tensor],
                cache: Optional[Dict[str, Any]] = None,
                cache_pos: Optional[torch.Tensor] = None,
                shard_fns: Optional[Dict[str, Callable]] = None,
                embedded: Optional[torch.Tensor] = None,
                head_last_only: bool = False):
        """Returns (logits, new_cache); new_cache is None without a
        ``cache``. ``cache`` enables decode from ``cache_pos`` (an int or a
        0-d integer tensor); ``embedded`` lets multi-partition callers feed
        boundary activations; ``head_last_only`` computes logits for the
        final position only (prefill serving: (B, 1, V))."""
        arch = self.arch
        params = self.params()
        sf = shard_fns or {}

        def get_sf(kind):
            return sf.get(kind, lambda a, role=None: a)

        if embedded is not None:
            x = embedded
        else:
            tokens = batch["tokens"]
            x = params["embed"]["table"][tokens.long()] \
                if self.include_embed else None
            x = get_sf("embed")(x, role="boundary")

        B, Sq = x.shape[0], x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            base = cache_pos if cache_pos is not None else 0
            positions = (base + torch.arange(Sq, dtype=torch.int32,
                                             device=x.device))
            positions = positions[None, :].expand(B, Sq)
        mrope = batch.get("mrope_positions") if arch.mrope else None

        new_cache: Dict[str, Any] = {}
        for seg in self.segments:
            seg_cache = cache.get(seg.name) if cache is not None else None
            x, seg_new_cache = self._run_segment(
                params[seg.name], seg, x, positions, mrope, get_sf,
                seg_cache, cache_pos)
            if cache is not None:
                new_cache[seg.name] = seg_new_cache
        new_cache = new_cache if cache is not None else None

        if not self.include_head:
            return x, new_cache

        if head_last_only:
            x = x[:, -1:]
        x = L.apply_norm(x, params["final_norm"]["ln_scale"],
                         params["final_norm"].get("ln_bias"), arch.norm)
        w_head = (params["embed"]["table"].T if arch.tie_embeddings
                  else params["head"]["w"])
        logits = x @ w_head
        logits = get_sf("head")(logits, role="inner")
        return logits, new_cache

    def _run_segment(self, seg_params, seg: Segment, x, positions, mrope,
                     get_sf, seg_cache=None, cache_pos=None):
        """Runs the segment's layers; returns (x, new segment cache), the
        cache None when ``seg_cache`` is None. Only blocks that have an
        entry in ``seg_cache`` emit one (ffn and moe are stateless)."""
        arch = self.arch
        new_leaves: Dict[str, Dict[str, List[torch.Tensor]]] = {}
        for i in range(seg.count):
            for j, kind in enumerate(seg.pattern):
                pk = f"p{j}_{kind}"
                p = {name: t[i] for name, t in seg_params[pk].items()}
                c = None
                if seg_cache is not None and pk in seg_cache:
                    c = {name: t[i] for name, t in seg_cache[pk].items()}
                sfk = get_sf(kind)
                if kind == "attn":
                    x, nc = A.attend(
                        x, p, num_heads=arch.num_heads,
                        num_kv_heads=arch.num_kv_heads,
                        head_dim=arch.head_dim, norm=arch.norm, causal=True,
                        positions=positions, rope_theta=arch.rope_theta,
                        mrope_positions=mrope, cache=c, cache_pos=cache_pos,
                        attn_impl=self.attn_impl, shard_fn=sfk)
                elif kind == "ffn":
                    x = L.apply_ffn(x, p, arch.act, arch.norm, shard_fn=sfk)
                    nc = None
                elif kind == "moe":
                    x = M.apply_moe(x, p, top_k=arch.experts_per_token,
                                    act=arch.act, norm=arch.norm,
                                    shard_fn=sfk)
                    nc = None
                elif kind == "rwkv_tmix":
                    # the sum goes on in float32 to the channel mix
                    x, nc = R.apply_rwkv_tmix(
                        x, p, head_size=arch.rwkv_head_size, norm=arch.norm,
                        state=c, use_kernel=self.use_flash, shard_fn=sfk)
                elif kind == "rwkv_cmix":
                    x, nc = R.apply_rwkv_cmix(x, p, norm=arch.norm, state=c,
                                              shard_fn=sfk)
                else:
                    raise ValueError(kind)
                if c is not None:
                    nc = nc if nc is not None else c
                    for name, t in nc.items():
                        new_leaves.setdefault(pk, {}).setdefault(
                            name, []).append(t)
        if seg_cache is None:
            return x, None
        return x, {pk: {name: _store(seg_cache[pk][name], layers)
                        for name, layers in leaves.items()}
                   for pk, leaves in new_leaves.items()}

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def loss(self, batch, shard_fns=None) -> torch.Tensor:
        logits, _ = self.forward(batch, shard_fns=shard_fns)
        labels = batch["labels"].long()
        lf = logits.float()
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(lf[..., 0]) if mask is None else mask.float()
        return torch.sum((logz - gold) * mask) / \
            torch.clamp(torch.sum(mask), min=1.0)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
        """JAX's ``init_cache`` tree: per decoder segment, per block with a
        state, zeros with a leading ``count`` axis; K/V and RWKV ``shift``
        in ``dtype``, the RWKV ``wkv`` state in float32. ``device=None`` is
        where the model's parameters are."""
        arch = self.arch
        if device is None:
            device = next(self.parameters()).device

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        cache: Dict[str, Any] = {}
        for seg in self.segments:
            seg_cache = {}
            for j, kind in enumerate(seg.pattern):
                pk = f"p{j}_{kind}"
                if kind == "attn":
                    shape = (seg.count, batch_size, max_len,
                             arch.num_kv_heads, arch.head_dim)
                    seg_cache[pk] = {"k": zeros(shape), "v": zeros(shape)}
                elif kind == "rwkv_tmix":
                    hs = arch.rwkv_head_size
                    H = arch.d_model // hs
                    seg_cache[pk] = {
                        "shift": zeros((seg.count, batch_size, arch.d_model)),
                        "wkv": zeros((seg.count, batch_size, H, hs, hs),
                                     torch.float32),
                    }
                elif kind == "rwkv_cmix":
                    seg_cache[pk] = {"shift": zeros(
                        (seg.count, batch_size, arch.d_model))}
            cache[seg.name] = seg_cache
        return cache

    def cache_shapes(self, batch_size: int, max_len: int,
                     dtype=torch.bfloat16) -> Dict[str, Any]:
        """The cache tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return self.init_cache(batch_size, max_len, dtype, device="meta")


def _store(buf: torch.Tensor, layers: List[torch.Tensor]) -> torch.Tensor:
    """A segment's new cache leaf from its layers' new values: ``buf``
    itself where every layer wrote into it or each value fits ``buf[i]``
    (copied in place), else the values stacked into a new tensor (a new
    dtype, as the RWKV ``shift`` of a float32 model after a prefill)."""
    if all(t.data_ptr() == buf[i].data_ptr() and t.shape == buf[i].shape
           and t.dtype == buf.dtype for i, t in enumerate(layers)):
        return buf
    if all(t.shape == buf.shape[1:] and t.dtype == buf.dtype
           for t in layers):
        for i, t in enumerate(layers):
            buf[i].copy_(t)
        return buf
    return torch.stack(layers)


def build_model(arch: ArchConfig, **kw) -> Model:
    return Model(arch, **kw)


__all__ = ["Model", "Segment", "build_model", "build_segments"]
