"""Parser: (ArchConfig, ShapeSpec) -> HD-Graph (paper §IV-A).

The backends' "customised IR" is our ArchConfig + execution mode; this module
translates every layer into HD-Graph computation nodes carrying the base
workload quantities (FLOPs, weight/activation/state bytes) from which the
performance and resource models derive t(n|s_I,s_O,k) and r(n|s_I,s_O,k).

Byte quantities assume bf16 (2B) activations/weights; fp32 (4B) SSM states.
Traffic conventions consumed by core/perfmodel.py:
  act_bytes    boundary featuremap traffic  -> folds by (k, boundary s_I)
  inner_bytes  node-internal traffic        -> folds by (k, s_I, s_O)
  state_bytes  KV / recurrent state         -> kind-specific folding
  weight_stream=True adds the node's weight shard to HBM traffic (inference
  reads weights every invocation; training accounting is handled separately).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.hdgraph import HDGraph, Node

BF16 = 2.0
FP32 = 4.0

# scan-group ids per node kind (nodes of the same kind within one partition
# tie their folding variables: they live in one stacked lax.scan).
_SCAN_GROUP = {
    "attn": 0,
    "ssm": 1,
    "ffn": 2,
    "moe": 3,
    "rwkv_tmix": 4,
    "rwkv_cmix": 5,
    "cross_attn": 6,
    "enc_attn": 7,
    "enc_ffn": 8,
}


def _n_ffn_mats(arch: ArchConfig) -> int:
    return 3 if arch.act == "swiglu" else 2


def build_hdgraph(arch: ArchConfig, shape: ShapeSpec) -> HDGraph:
    mode = shape.mode
    B = shape.global_batch
    S = shape.seq_len if mode != "decode" else 1      # query rows this step
    L = shape.seq_len                                  # context length
    tm = 3.0 if mode == "train" else 1.0               # fwd+bwd FLOP multiplier
    stream = mode != "train"                           # weights re-read per step

    nodes: List[Node] = []

    # ------------------------- encoder (whisper) ----------------------
    if arch.encoder_layers and mode != "decode":
        Se = arch.num_frames or 1500
        for i in range(arch.encoder_layers):
            nodes.append(_attn_node(arch, f"enc{i}.attn", i, B, Se, Se, tm,
                                    mode="prefill", kind="enc_attn"))
            nodes.append(_ffn_node(arch, f"enc{i}.ffn", i, B, Se, tm, stream,
                                   kind="enc_ffn"))

    # --------------------------- embedding ----------------------------
    nodes.append(Node(
        name="embed", kind="embed", layer=-1,
        rows=S, cols=arch.vocab_size, batch=B,
        flops=B * S * arch.d_model,        # gather/copy cost, negligible compute
        weight_bytes=arch.vocab_size * arch.d_model * BF16,
        act_bytes=B * S * arch.d_model * BF16 + B * S * 4.0,
        col_divisor=arch.vocab_size,
        collective_kind="vocab_allreduce",
        train_multiplier=1.0,
        fm_width=arch.d_model,
    ))

    # ------------------------- decoder layers -------------------------
    for i in range(arch.num_layers):
        mixer = arch.layer_kind(i)
        if mixer == "attn":
            nodes.append(_attn_node(arch, f"l{i}.attn", i, B, S, L, tm, mode=mode))
            if arch.cross_attention:
                Se = arch.num_frames or 1500
                nodes.append(_attn_node(arch, f"l{i}.xattn", i, B, S, Se, tm,
                                        mode=mode, kind="cross_attn", causal=False))
        elif mixer == "ssm":
            nodes.append(_ssm_node(arch, f"l{i}.ssm", i, B, S, tm, mode))
        elif mixer == "rwkv":
            nodes.append(_rwkv_tmix_node(arch, f"l{i}.tmix", i, B, S, tm, mode))
        # channel mixer
        fk = arch.ffn_kind(i)
        if mixer == "rwkv":
            nodes.append(_rwkv_cmix_node(arch, f"l{i}.cmix", i, B, S, tm, stream))
        elif fk == "moe":
            nodes.append(_moe_node(arch, f"l{i}.moe", i, B, S, tm))
        else:
            nodes.append(_ffn_node(arch, f"l{i}.ffn", i, B, S, tm, stream))

    # -------------------------- final norm + head ---------------------
    D, V = arch.d_model, arch.vocab_size
    nodes.append(Node(
        name="final_norm", kind="norm", layer=-1,
        rows=S, cols=D, batch=B,
        flops=5.0 * B * S * D * tm,
        weight_bytes=D * BF16,
        act_bytes=2.0 * B * S * D * BF16,
        elementwise=True,
        fm_width=D,
        train_multiplier=tm,
    ))
    # Prefill only needs the LAST position's logits (the serve step slices
    # before the head matmul) — decode computes its single new token.
    S_head = 1 if mode == "prefill" else S
    nodes.append(Node(
        name="lm_head", kind="head", layer=-1,
        rows=S, cols=V, batch=B,
        flops=2.0 * B * S_head * D * V * tm,
        weight_bytes=0.0 if arch.tie_embeddings else V * D * BF16,
        act_bytes=B * S_head * D * BF16,
        inner_bytes=B * S_head * V * BF16     # logits in vocab-sharded space
                    + (V * D * BF16 if arch.tie_embeddings and stream else 0.0),
        col_divisor=V,
        collective_kind="vocab_head",
        train_multiplier=tm,
        weight_stream=stream,
        fm_width=D,
    ))

    return HDGraph(nodes=nodes, arch_name=arch.name, shape_name=shape.name, mode=mode)


# ----------------------------------------------------------------------
# per-kind node constructors
# ----------------------------------------------------------------------

def _attn_node(arch: ArchConfig, name: str, layer: int, B: int, S: int, L: int,
               tm: float, mode: str, kind: str = "attn",
               causal: bool = True) -> Node:
    D, H, Hkv, dh = arch.d_model, arch.num_heads, arch.num_kv_heads, arch.head_dim
    qkv_flops = 2.0 * B * S * D * (H * dh + 2 * Hkv * dh)
    out_flops = 2.0 * B * S * (H * dh) * D
    causal_f = 0.5 if (causal and mode in ("train", "prefill") and S == L) else 1.0
    sdpa_flops = 2.0 * B * H * S * L * dh * 2.0 * causal_f
    wb = (D * H * dh + 2 * D * Hkv * dh + H * dh * D) * BF16
    kv_state = B * L * 2 * Hkv * dh * BF16
    decode = mode == "decode"
    return Node(
        name=name, kind=kind, layer=layer,
        rows=L if decode else S,              # decode: split-KV folding dim
        cols=H, batch=B,
        flops=(qkv_flops + out_flops + sdpa_flops) * tm,
        weight_bytes=wb,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=2.0 * B * S * H * dh * BF16,
        state_bytes=kv_state if mode != "train" else 0.0,
        kv_bytes=kv_state,
        col_divisor=H,
        kv_limit=Hkv,
        scan_group=_SCAN_GROUP[kind],
        collective_kind="tp_allreduce",
        train_multiplier=tm,
        weight_stream=(mode != "train"),
        internal_rows=decode,
        fm_width=D,
    )


def _ffn_node(arch: ArchConfig, name: str, layer: int, B: int, S: int,
              tm: float, stream: bool, kind: str = "ffn") -> Node:
    D, F = arch.d_model, arch.d_ff
    n = _n_ffn_mats(arch)
    return Node(
        name=name, kind=kind, layer=layer,
        rows=S, cols=F, batch=B,
        flops=2.0 * B * S * D * F * n * tm,
        weight_bytes=n * D * F * BF16,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=(n - 1) * B * S * F * BF16,
        col_divisor=F,
        scan_group=_SCAN_GROUP[kind],
        collective_kind="tp_allreduce",
        train_multiplier=tm,
        weight_stream=stream,
        fm_width=D,
    )


def _moe_node(arch: ArchConfig, name: str, layer: int, B: int, S: int,
              tm: float) -> Node:
    D, F, E, K = arch.d_model, arch.d_ff, arch.num_experts, arch.experts_per_token
    n = _n_ffn_mats(arch)
    tokens = B * S
    router_flops = 2.0 * tokens * D * E
    expert_flops = 2.0 * tokens * K * D * F * n
    wb = (E * n * D * F + D * E) * BF16
    touched = min(E, tokens * K)              # experts whose weights stream
    return Node(
        name=name, kind="moe", layer=layer,
        rows=S, cols=E, batch=B,
        flops=(router_flops + expert_flops) * tm,
        weight_bytes=wb,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=(touched * n * D * F * BF16   # touched expert weight reads
                     + tokens * K * (D + (n - 1) * F) * BF16),
        col_divisor=E,
        ep_topk=K,
        scan_group=_SCAN_GROUP["moe"],
        collective_kind="ep_alltoall",
        train_multiplier=tm,
        fm_width=D,
    )


def _ssm_node(arch: ArchConfig, name: str, layer: int, B: int, S: int,
              tm: float, mode: str) -> Node:
    D = arch.d_model
    di = arch.ssm_expand * D
    ds = arch.ssm_d_state
    dtr = max(1, D // 16)
    flops = (2.0 * B * S * D * 2 * di              # in_proj (x, z)
             + 2.0 * B * S * di * (dtr + 2 * ds)   # x_proj
             + 2.0 * B * S * dtr * di              # dt_proj
             + 2.0 * B * S * di * arch.ssm_conv    # depthwise conv
             + 9.0 * B * S * di * ds               # selective scan
             + 2.0 * B * S * di * D)               # out_proj
    wb = (D * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * arch.ssm_conv
          + di * ds + 2 * di + di * D) * BF16
    state = B * di * ds * FP32 + B * di * arch.ssm_conv * BF16
    return Node(
        name=name, kind="ssm", layer=layer,
        rows=S, cols=di, batch=B,
        flops=flops * tm,
        weight_bytes=wb,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=3.0 * B * S * di * BF16,
        state_bytes=state if mode != "train" else 0.0,
        carry_bytes=B * di * ds * FP32,
        col_divisor=di,
        scan_group=_SCAN_GROUP["ssm"],
        collective_kind="tp_allreduce",
        train_multiplier=tm,
        weight_stream=(mode != "train"),
        fm_width=D,
    )


def _rwkv_tmix_node(arch: ArchConfig, name: str, layer: int, B: int, S: int,
                    tm: float, mode: str) -> Node:
    D = arch.d_model
    hs = arch.rwkv_head_size
    Hr = D // hs
    proj_flops = 2.0 * B * S * D * D * 5.0         # r,k,v,g,o
    wkv_flops = 6.0 * B * S * D * hs               # state update + readout
    wb = (5.0 * D * D + 2.0 * D + D * hs) * BF16   # + decay lora (approx)
    state = B * Hr * hs * hs * FP32
    return Node(
        name=name, kind="rwkv_tmix", layer=layer,
        rows=S, cols=Hr, batch=B,
        flops=(proj_flops + wkv_flops) * tm,
        weight_bytes=wb,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=3.0 * B * S * D * BF16,
        state_bytes=state if mode != "train" else 0.0,
        carry_bytes=B * Hr * hs * hs * FP32,
        col_divisor=Hr,
        scan_group=_SCAN_GROUP["rwkv_tmix"],
        collective_kind="tp_allreduce",
        train_multiplier=tm,
        weight_stream=(mode != "train"),
        fm_width=D,
    )


def _rwkv_cmix_node(arch: ArchConfig, name: str, layer: int, B: int, S: int,
                    tm: float, stream: bool) -> Node:
    D, F = arch.d_model, arch.d_ff
    flops = 2.0 * B * S * (D * F + F * D + D * D)  # k, v, receptance
    wb = (2.0 * D * F + D * D) * BF16
    return Node(
        name=name, kind="rwkv_cmix", layer=layer,
        rows=S, cols=F, batch=B,
        flops=flops * tm,
        weight_bytes=wb,
        act_bytes=4.0 * B * S * D * BF16,
        inner_bytes=B * S * F * BF16,
        col_divisor=F,
        scan_group=_SCAN_GROUP["rwkv_cmix"],
        collective_kind="tp_allreduce",
        train_multiplier=tm,
        weight_stream=stream,
        fm_width=D,
    )
