"""The LM zoo's model, ported for every block kind of the ten registry
archs: the full-sequence forward and decode against a cache.

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
``loss_mask``, ``frames`` for the audio encoder) and return what JAX's
``forward(params, batch)`` and ``loss(params, batch)`` return. The
parameters are trainable: with grad mode on, ``forward`` and ``loss``
build an autograd graph (the train step,
``launch/steps.py::make_train_step``), and with ``remat`` (JAX's default)
each layer group runs under ``torch.utils.checkpoint``, as JAX's scan body
runs under ``jax.checkpoint``: only the group's inputs are kept, and its
activations are recomputed in the backward. Scoring and serving run under
``torch.inference_mode()`` (``launch/serve.py``), which builds nothing. The
hand-written kernels have no backward (nor have their Pallas originals), so
their wrappers raise under grad: a model that trains takes
``attn_impl="chunked"`` and ``use_flash=False``, as JAX's train loop does.

The blocks: ``attn`` / ``ffn`` (rotary self-attention and the
feed-forward), ``moe``, ``rwkv_tmix`` / ``rwkv_cmix``, ``ssm`` (jamba's
mamba mixer, ``models/ssm.py``) and whisper's encoder-decoder blocks
(``enc_attn`` / ``enc_ffn`` over ``batch["frames"]``, no rotation, not
causal; ``cross_attn`` from the decoder to the encoder's output). With
``use_flash=True`` attention runs in the hand-written flash-attention
kernel (``csrc/flash_attn.cu``) and the WKV recurrence in the WKV kernel
(``csrc/wkv6.cu``), as JAX's ``use_flash`` runs its Pallas kernels;
``attn_impl`` picks ``ref``, ``chunked`` or ``flash`` attention directly.
The SSM scan is plain PyTorch, as JAX's is.

Sharding: ``param_specs(plan, partition)`` and ``cache_specs(plan,
partition)`` give JAX's ``PartitionSpec`` trees of the parameters and
the cache from a plan (``core/partition_spec.py``); on one device each
places the whole tensor.

Decode: ``init_cache`` builds JAX's cache tree, and ``forward(batch,
cache=..., cache_pos=...)`` returns ``(logits, new_cache)`` in that tree.
The cache is updated in place wherever the new value fits its buffer
(shape and dtype): attention writes this step's K/V into the caller's
buffers, a prefill's encoder output and cross K/V go into theirs, and a
carried RWKV or SSM state is copied into its buffer. Where it does not
fit, the new leaf is a new tensor, as JAX's is: a float32 model's RWKV
``shift`` or SSM ``conv`` history after a prefill into the default
bfloat16 cache keeps float32. JAX returns a new cache every call and its
serve loop donates the old one, so in place changes nothing its callers
see; a caller that wants an old cache again clones it first. Cache-carrying
decode takes the oracles, as JAX's does: a tensor ``cache_pos`` sends
flash attention to ``ref.attention`` and a carried RWKV state to
``ref.rwkv6``.

Whisper's decode (a batch without ``frames``) gives the decoder the cached
encoder output with ``write_cross=False``, so cross-attention reads the
K/V its prefill stored. JAX's forward gives the decoder no encoder output
there, so its cross-attention attends to the decoded token alone and
overwrites the stored K/V (ROADMAP Queue 3); the port follows
``attend``'s documented contract instead. JAX's encoder casts ``frames``
to bfloat16 and cannot then run float32 parameters (its scan's carry
changes dtype); the port casts them to bfloat16 too, then to the
parameters' dtype, so a float32 model runs its encoder in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.exporter import _axes
from repro_torch.core.partition_spec import PartitionSpec
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
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


def _attention(gen, arch, device):
    return A.init_attention(gen, arch.d_model, arch.num_heads,
                            arch.num_kv_heads, arch.head_dim, arch.norm,
                            device=device)


_INIT = {
    "attn": _attention,
    "cross_attn": _attention,
    "enc_attn": _attention,
    "ffn": lambda gen, arch, device: L.init_ffn(
        gen, arch.d_model, arch.d_ff, arch.act, arch.norm, device=device),
    # JAX's ``"gelu" if arch.act == "gelu" else arch.act`` is the arch's act
    "enc_ffn": lambda gen, arch, device: L.init_ffn(
        gen, arch.d_model, arch.d_ff, arch.act, arch.norm, device=device),
    "moe": lambda gen, arch, device: M.init_moe(
        gen, arch.d_model, arch.d_ff, arch.num_experts, arch.act, arch.norm,
        device=device),
    "ssm": lambda gen, arch, device: S.init_ssm(
        gen, arch.d_model, arch.ssm_expand, arch.ssm_d_state, arch.ssm_conv,
        arch.norm, device=device),
    "rwkv_tmix": lambda gen, arch, device: R.init_rwkv_tmix(
        gen, arch.d_model, arch.rwkv_head_size, arch.norm, device=device),
    "rwkv_cmix": lambda gen, arch, device: R.init_rwkv_cmix(
        gen, arch.d_model, arch.d_ff, arch.norm, device=device),
}


def _module(tree: Dict[str, Any]) -> nn.Module:
    """Nested dicts of tensors as nested ``ModuleDict`` / ``ParameterDict``,
    so that ``state_dict()`` keys are the tree's paths joined by ``.``."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
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
    ``load_state_dict(..., assign=True)``. ``remat`` recomputes each layer
    group's activations in the backward (``torch.utils.checkpoint``);
    ``unroll`` is kept for the signature and does nothing: a Python loop
    walks the layers where JAX scans them."""

    def __init__(self, arch: ArchConfig,
                 layer_range: Optional[Tuple[int, int]] = None,
                 include_embed: bool = True, include_head: bool = True,
                 use_flash: bool = False, remat: bool = True,
                 unroll: bool = False, attn_impl: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = arch
        self.segments = build_segments(arch, layer_range)
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

    def param_specs(self, plan, partition: int = 0) -> Dict[str, Any]:
        """``PartitionSpec`` tree mirroring ``param_shapes()``, from a
        ``ShardingPlan``'s kind plans for ``partition``: each leaf's role
        (``layers.PARAM_ROLES``) on its block kind's axes, the stacked
        ``count`` axis never sharded."""
        def spec(path: Tuple[str, ...], leaf):
            top = path[0]
            name = path[-1]
            if top == "embed":
                return plan.spec_for_role("table", leaf.ndim, "embed",
                                          partition)
            if top == "head":
                return plan.spec_for_role("head", leaf.ndim, "head",
                                          partition)
            if top == "final_norm":
                return plan.spec_for_role("replicate", leaf.ndim, "norm",
                                          partition)
            kind = path[1].split("_", 1)[1]          # "p{j}_{kind}"
            role = L.PARAM_ROLES[kind].get(name, "replicate")
            return plan.spec_for_role(role, leaf.ndim, kind, partition,
                                      stacked=1)

        return _tree_map_with_path(spec, self.param_shapes())

    def params(self) -> Dict[str, Any]:
        """The parameters this module holds, as the JAX tree."""
        return {name: _tree(mod) for name, mod in self.named_children()}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
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
        # ---------------- encoder (whisper) ----------------
        enc_out, write_cross = None, False
        for seg in self.segments:
            if not seg.encoder:
                continue
            if cache is not None and "frames" not in batch:
                # decode: the encoder output and the cross K/V are cached
                enc_out = cache.get("enc_out")
                if enc_out is not None:
                    new_cache["enc_out"] = enc_out
                continue
            dt = params[seg.name]["p0_enc_attn"]["wq"].dtype
            h = batch["frames"].to(torch.bfloat16).to(dt)
            enc_out = self._run_segment(params[seg.name], seg, h, None, None,
                                        get_sf)[0]
            write_cross = True
            if cache is not None:
                new_cache["enc_out"] = _fill(cache.get("enc_out"), enc_out)

        # ---------------- decoder ----------------
        for seg in self.segments:
            if seg.encoder:
                continue
            seg_cache = cache.get(seg.name) if cache is not None else None
            x, seg_new_cache = self._run_segment(
                params[seg.name], seg, x, positions, mrope, get_sf,
                seg_cache, cache_pos, enc_out, write_cross)
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
                     get_sf, seg_cache=None, cache_pos=None, enc_out=None,
                     write_cross=False):
        """Runs the segment's layers; returns (x, new segment cache), the
        cache None when ``seg_cache`` is None. Only blocks that have an
        entry in ``seg_cache`` emit one (ffn and moe are stateless).
        ``enc_out`` is what cross-attention reads (the encoder's output),
        and ``write_cross`` says that it is new (a prefill: the cross K/V
        are computed and stored) rather than cached (a decode step: the
        stored K/V are read). With ``remat``, grad mode on and no cache,
        each layer group runs under ``torch.utils.checkpoint`` (JAX:
        ``jax.checkpoint`` of the scan body). Without, the blocks run here
        one after another, so that a block's input is freed as soon as the
        next block has its output."""
        remat = self.remat and seg_cache is None and torch.is_grad_enabled()
        new_leaves: Dict[str, Dict[str, List[torch.Tensor]]] = {}
        for i in range(seg.count):
            p = {pk: {name: t[i] for name, t in leaves.items()}
                 for pk, leaves in seg_params.items()}
            if remat:
                x = checkpoint(self._layer_group, x, seg, p, positions,
                               mrope, get_sf, enc_out, use_reentrant=False)
                continue
            c = None
            if seg_cache is not None:
                c = {pk: {name: t[i] for name, t in leaves.items()}
                     for pk, leaves in seg_cache.items()}
            for j, kind in enumerate(seg.pattern):
                x = self._block(j, kind, x, p, c, positions, mrope, get_sf,
                                cache_pos, new_leaves, enc_out, write_cross)
        if seg_cache is None:
            return x, None
        return x, {pk: {name: _store(seg_cache[pk][name], layers)
                        for name, layers in leaves.items()}
                   for pk, leaves in new_leaves.items()}

    def _layer_group(self, x, seg: Segment, seg_p, positions, mrope, get_sf,
                     enc_out=None):
        """One layer group without a cache (the segment's pattern once,
        JAX's scan body): what ``remat`` recomputes in the backward."""
        for j, kind in enumerate(seg.pattern):
            x = self._block(j, kind, x, seg_p, None, positions, mrope,
                            get_sf, None, {}, enc_out, True)
        return x

    def _block(self, j, kind, x, seg_p, seg_c, positions, mrope, get_sf,
               cache_pos, new_leaves, enc_out=None, write_cross=False):
        """Block ``j`` of a layer group on ``x``; ``seg_p`` / ``seg_c`` are
        the group's slices of the segment's parameters and cache. A block
        with a cache entry appends its new cache leaves to
        ``new_leaves[block][leaf]``. Returns the block's output."""
        arch = self.arch
        pk = f"p{j}_{kind}"
        p = seg_p[pk]
        c = seg_c.get(pk) if seg_c is not None else None
        sfk = get_sf(kind)
        heads = dict(num_heads=arch.num_heads,
                     num_kv_heads=arch.num_kv_heads, head_dim=arch.head_dim,
                     norm=arch.norm, attn_impl=self.attn_impl, shard_fn=sfk)
        if kind == "attn":
            x, nc = A.attend(
                x, p, causal=True, positions=positions,
                rope_theta=arch.rope_theta, mrope_positions=mrope, cache=c,
                cache_pos=cache_pos, **heads)
        elif kind == "enc_attn":
            x, nc = A.attend(x, p, causal=False, **heads)
        elif kind == "cross_attn":
            if enc_out is None:
                raise ValueError(
                    "cross_attn reads the encoder's output: run a layer "
                    "range that starts at 0 with batch['frames'], or decode "
                    "against a cache that holds 'enc_out'")
            x, nc = A.attend(x, p, causal=False, kv_src=enc_out, cache=c,
                             write_cross=write_cross, **heads)
        elif kind in ("ffn", "enc_ffn"):
            x = L.apply_ffn(x, p, arch.act, arch.norm, shard_fn=sfk)
            nc = None
        elif kind == "moe":
            x = M.apply_moe(x, p, top_k=arch.experts_per_token,
                            act=arch.act, norm=arch.norm, shard_fn=sfk)
            nc = None
        elif kind == "ssm":
            x, nc = S.apply_ssm(x, p, d_state=arch.ssm_d_state,
                                d_conv=arch.ssm_conv, norm=arch.norm,
                                state=c, shard_fn=sfk)
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
            for name, t in (nc if nc is not None else c).items():
                new_leaves.setdefault(pk, {}).setdefault(name, []).append(t)
        return x

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------
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
        """JAX's ``init_cache`` tree: the encoder output ``enc_out`` (B, F,
        D) where the arch has an encoder, then per decoder segment, per
        block with a state, zeros with a leading ``count`` axis: self K/V
        (B, max_len, Hkv, dh), cross K/V (B, F, Hkv, dh), RWKV ``shift``
        and SSM ``conv`` in ``dtype``; the RWKV ``wkv`` and SSM ``ssm``
        states in float32. F is the arch's ``num_frames`` (1500 when 0).
        ``device=None`` is where the model's parameters are."""
        arch = self.arch
        if device is None:
            device = next(self.parameters()).device

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        frames = arch.num_frames or 1500
        cache: Dict[str, Any] = {}
        if arch.encoder_layers:
            cache["enc_out"] = zeros((batch_size, frames, arch.d_model))
        for seg in self.segments:
            if seg.encoder:
                continue
            seg_cache = {}
            for j, kind in enumerate(seg.pattern):
                pk = f"p{j}_{kind}"
                if kind in ("attn", "cross_attn"):
                    shape = (seg.count, batch_size,
                             max_len if kind == "attn" else frames,
                             arch.num_kv_heads, arch.head_dim)
                    seg_cache[pk] = {"k": zeros(shape), "v": zeros(shape)}
                elif kind == "ssm":
                    di = arch.ssm_expand * arch.d_model
                    seg_cache[pk] = {
                        "ssm": zeros((seg.count, batch_size, di,
                                      arch.ssm_d_state), torch.float32),
                        "conv": zeros((seg.count, batch_size,
                                       arch.ssm_conv - 1, di)),
                    }
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

    def cache_specs(self, plan, partition: int = 0) -> Dict[str, Any]:
        """``PartitionSpec`` tree mirroring ``init_cache``'s: K/V (count, B,
        length, Hkv, dh) with batch, rows (self-attention's length only)
        and the KV heads on the attention kind's axes (the heads only
        where its cols fold divides them); RWKV and SSM states on their
        kind's batch and cols axes; ``enc_out`` on the encoder's batch
        axes."""
        arch = self.arch
        P = PartitionSpec
        cache: Dict[str, Any] = {}
        akp = plan.kind_plan("attn", partition)
        kv_heads_ax = _axes(akp.cols_axes) if (
            akp.s_out <= arch.num_kv_heads
            and arch.num_kv_heads % max(akp.s_out, 1) == 0) else None
        batch_ax = _axes(akp.batch_axes)
        rows_ax = _axes(akp.rows_axes)
        if arch.encoder_layers:
            ekp = plan.kind_plan("enc_attn", partition)
            cache["enc_out"] = P(_axes(ekp.batch_axes), None, None)
        for seg in self.segments:
            if seg.encoder:
                continue
            seg_specs = {}
            for j, kind in enumerate(seg.pattern):
                pk = f"p{j}_{kind}"
                if kind in ("attn", "cross_attn"):
                    kv = P(None, batch_ax, rows_ax if kind == "attn" else None,
                           kv_heads_ax, None)
                    seg_specs[pk] = {"k": kv, "v": kv}
                elif kind == "ssm":
                    skp = plan.kind_plan("ssm", partition)
                    seg_specs[pk] = {
                        "ssm": P(None, _axes(skp.batch_axes),
                                 _axes(skp.cols_axes), None),
                        "conv": P(None, _axes(skp.batch_axes), None,
                                  _axes(skp.cols_axes)),
                    }
                elif kind == "rwkv_tmix":
                    rkp = plan.kind_plan("rwkv_tmix", partition)
                    seg_specs[pk] = {
                        "shift": P(None, _axes(rkp.batch_axes), None),
                        "wkv": P(None, _axes(rkp.batch_axes),
                                 _axes(rkp.cols_axes), None, None),
                    }
                elif kind == "rwkv_cmix":
                    rkp = plan.kind_plan("rwkv_cmix", partition)
                    seg_specs[pk] = {"shift": P(None, _axes(rkp.batch_axes),
                                                None)}
            cache[seg.name] = seg_specs
        return cache


def _fill(buf: Optional[torch.Tensor], new: torch.Tensor) -> torch.Tensor:
    """``new`` as a cache leaf: copied into ``buf`` in place where it fits
    (shape and dtype; returns buf), else ``new`` itself, as JAX stores the
    encoder output whatever the cache's dtype."""
    if buf is not None and buf.shape == new.shape and buf.dtype == new.dtype:
        return buf.copy_(new)
    return new


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


def _tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


__all__ = ["Model", "Segment", "build_model", "build_segments"]
