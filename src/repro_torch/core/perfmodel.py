"""Backend performance & resource models (paper §III-D/E).

``node_time`` is the roofline latency of one node at folding (s_I, s_O, k):
the max of its compute / HBM / collective terms, using the same hardware
constants as the §Roofline analysis of the compiled dry-run — the analytic
model and the HLO-derived roofline cross-validate each other.

Execution models (see DESIGN.md §2):
  streaming — the paper's subject. Each node occupies its own disjoint chip
      group of size s_I*s_O*k; microbatches stream through; a partition's
      steady-state interval is max-over-nodes (Eq. 2). Spatial resource
      constraint: sum of chip groups <= mesh chips.
  spmd — systolic-array-style comparison point: all chips execute the nodes
      sequentially; partition latency is the sum over nodes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.hdgraph import HDGraph, Node, Variables, partitions_from_cuts
from repro_torch.core.platform import Platform

BF16 = 2.0
FP32 = 4.0

# Training-state bytes per bf16 parameter byte: bf16 param (1x) + fp32 grad
# (2x) + fp32 Adam m (2x) + fp32 Adam v (2x) = 7x.  With ZeRO-1 the fp32
# master/m/v shard over the data-parallel fold k, but the bf16 params AND
# the transient bf16 gradient tree (alive between backward and the
# reduce-scatter) stay per-chip — the compiled buffer assignment confirms.
TRAIN_STATE_MULT = 7.0
ZERO1_RESIDENT = 2.0        # bf16 params + transient bf16 grads
ZERO1_SHARDED = 6.0         # fp32 master + m + v shard over k


@dataclass(frozen=True)
class NodeEval:
    """Roofline decomposition of one node at a given folding."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float          # per-chip
    collective_bytes: float   # per-chip operand bytes (HLO parse convention)
    hbm_resident: float       # per-chip residency for Eq. 6
    chips: int

    @property
    def time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)


@dataclass(frozen=True)
class ModelOptions:
    """Beyond-baseline modelling switches (exposed to the optimiser)."""

    zero1: bool = False               # shard optimiser state over k
    grad_compression: float = 1.0     # 1.0=fp32 allreduce; 0.25=int8; <0.25=top-k
    mxu_efficiency: float = 0.72      # achievable fraction of peak on MXU matmuls
    overlap_collectives: float = 0.0  # fraction of collective hidden under compute
    seq_parallel_stash: bool = False  # Megatron-SP: boundary activations (and
                                      # their remat stash) shard over the TP
                                      # axis too, not just (s_in, k)


def _state_sharding(node: Node, s_in: int, s_out: int, kern: int):
    """(divisor, replication) for KV / recurrent state under the folding."""
    if node.kind in ("attn", "cross_attn", "enc_attn"):
        kv_div = min(s_out, node.kv_limit) if node.kv_limit else s_out
        # KV shards over batch (k), kv-heads (up to kv_limit) and — when the
        # rows dim is the cache (decode split-KV) or the sequence (prefill) —
        # over s_in as well.
        div = kern * max(kv_div, 1) * s_in
        repl = (s_out / kv_div) if (node.kv_limit and s_out > node.kv_limit) else 1.0
        return div, repl
    # SSM / RWKV recurrent state shards over batch and channels.
    return kern * s_out, 1.0


def node_eval(node: Node, s_in: int, s_out: int, kern: int,
              platform: Platform, mode: str,
              opts: ModelOptions = ModelOptions()) -> NodeEval:
    c = s_in * s_out * kern
    b_in = 1 if node.internal_rows else s_in   # boundary-layout row fold

    # ---------------- compute term ----------------
    flops_per_chip = node.flops / c
    compute_s = flops_per_chip / (platform.peak_flops * opts.mxu_efficiency)

    # ---------------- memory term ----------------
    w_per_chip = node.weight_bytes / s_out
    act_per_chip = node.act_bytes / (b_in * kern)
    inner_per_chip = node.inner_bytes / c
    state_div, state_repl = _state_sharding(node, s_in, s_out, kern)
    state_per_chip = node.state_bytes * state_repl / state_div

    # Backward re-touches activations (~3x); weights read fwd+bwd in train.
    train_mult = 3.0 if mode == "train" else 1.0
    hbm_bytes = (act_per_chip + inner_per_chip) * train_mult
    if mode == "train":
        hbm_bytes += 2.0 * w_per_chip
    else:
        if node.weight_stream:
            hbm_bytes += w_per_chip
        hbm_bytes += state_per_chip        # KV/state read (decode) or write (prefill)
    memory_s = hbm_bytes / platform.hbm_bw

    # ---------------- collective term ----------------
    coll = _collective_bytes(node, s_in, s_out, kern, platform, mode, opts)
    collective_s = coll / platform.ici_bw
    collective_s *= (1.0 - opts.overlap_collectives)

    # ---------------- residency (Eq. 6) ----------------
    resident = w_per_chip
    if mode == "train":
        if opts.zero1:
            resident = w_per_chip * ZERO1_RESIDENT \
                + w_per_chip * ZERO1_SHARDED / kern
        else:
            resident = w_per_chip * TRAIN_STATE_MULT
        # remat activation stash: one boundary featuremap per node
        stash_div = s_in * kern
        if opts.seq_parallel_stash:
            stash_div *= max(s_out, 1)      # Megatron-SP residency
        resident += node.batch * node.rows * node.fm_width * BF16 / stash_div
        if node.kind == "head":
            # logits live bf16 + fp32 during the loss (inner_bytes = the
            # bf16 logits): 3x inner per chip at the head's folding
            resident += 3.0 * node.inner_bytes / (b_in * kern * max(s_out, 1))
    else:
        resident += state_per_chip
        # double-buffered boundary activations (decode rows are 1 token wide)
        rows = 1 if mode == "decode" else node.rows
        resident += 2.0 * node.batch * rows * node.fm_width * BF16 / (b_in * kern)

    return NodeEval(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        flops=node.flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=coll,
        hbm_resident=resident,
        chips=c,
    )


def _collective_bytes(node: Node, s_in: int, s_out: int, kern: int,
                      platform: Platform, mode: str,
                      opts: ModelOptions) -> float:
    """Per-chip collective operand bytes (ring-algorithm traffic)."""
    B, D = node.batch, node.fm_width
    b_in = 1 if node.internal_rows else s_in
    rows = node.rows if mode != "decode" else 1
    fm_shard = B * rows * D * BF16 / (b_in * kern)
    total = 0.0
    train_mult = 2.0 if mode == "train" else 1.0   # bwd re-runs the collective

    if s_out > 1:
        if node.collective_kind == "tp_allreduce":
            total += 2.0 * (s_out - 1) / s_out * fm_shard * train_mult
        elif node.collective_kind == "ep_alltoall":
            tokens_shard = B * rows / (b_in * kern)
            # dispatch + combine, top-k copies of the hidden vector
            fanout = max(node.ep_topk, 1)
            total += (2.0 * tokens_shard * fanout * D * BF16
                      * (s_out - 1) / s_out * train_mult)
        elif node.collective_kind == "vocab_allreduce":
            # the backward pass re-runs this all-reduce exactly like
            # tp_allreduce above — the two must stay consistent (the
            # batched and jax evaluators mirror this line verbatim)
            total += 2.0 * (s_out - 1) / s_out * fm_shard * train_mult
        elif node.collective_kind == "vocab_head":
            if mode == "decode":
                # all-gather sharded logits for sampling
                total += node.cols * BF16 * B / kern * (s_out - 1) / s_out
            else:
                # distributed softmax: two scalar stats per token
                total += 2.0 * 8.0 * B * rows / (b_in * kern)

    # sequence/context parallelism (s_in > 1) is NOT free on TPU:
    #   attention  — ring KV exchange: each chip must see the whole KV of its
    #                batch shard ((s_in-1)/s_in of it arrives over ICI);
    #   SSM/RWKV   — chunk-boundary recurrent state pass (tiny);
    #   decode     — split-KV partial-softmax combine (tiny, flash-decode).
    if s_in > 1:
        if node.internal_rows:
            # decode split-KV: combine (out, m, l) per q row over the s_in
            # group. Heads shard only up to the KV-head cap (GQA): beyond
            # kv_limit the partials replicate, so the combine traffic divides
            # by kv_div, not s_out.
            kv_div = min(s_out, node.kv_limit) if node.kv_limit else max(s_out, 1)
            dh = node.fm_width / max(node.cols, 1)
            total += (node.batch / kern) * node.cols / max(kv_div, 1) \
                * (dh + 2.0) * 4.0 * (s_in - 1) / s_in
        elif node.kv_bytes:
            kv_div = (min(s_out, node.kv_limit) if node.kv_limit
                      else max(s_out, 1)) * kern
            total += node.kv_bytes / kv_div * (s_in - 1) / s_in * train_mult
        elif node.carry_bytes:
            total += node.carry_bytes / kern * (s_in - 1) / s_in * train_mult

    # data-parallel gradient all-reduce (per step, ring over k)
    if mode == "train" and kern > 1 and node.weight_bytes:
        grad_bytes = node.weight_bytes / s_out * 2.0 * opts.grad_compression
        total += 2.0 * (kern - 1) / kern * grad_bytes

    return total


# ----------------------------------------------------------------------
# Partition- and graph-level models
# ----------------------------------------------------------------------

def eval_nodes(graph: HDGraph, variables: Variables, platform: Platform,
               opts: ModelOptions = ModelOptions()) -> List[NodeEval]:
    return [
        node_eval(n, variables.s_in[i], variables.s_out[i], variables.kern[i],
                  platform, graph.mode, opts)
        for i, n in enumerate(graph.nodes)
    ]


def partition_time(graph: HDGraph, part: Sequence[int], evals: List[NodeEval],
                   exec_model: str) -> float:
    """Eq. 2 (streaming: max) or systolic comparison (spmd: sum)."""
    times = [evals[i].time for i in part]
    return max(times) if exec_model == "streaming" else sum(times)


def partition_weight_bytes_per_chip(graph: HDGraph, part: Sequence[int],
                                    variables: Variables) -> float:
    total = 0.0
    for i in part:
        total += graph.nodes[i].weight_bytes / variables.s_out[i]
    return total


def t_conf(graph: HDGraph, part: Sequence[int], variables: Variables,
           platform: Platform) -> float:
    """Reconfiguration time: fixed per-swap overhead (program switch + global
    barrier — the bitstream-load analogue) + weight-streaming of the
    partition's shards (each chip DMAs its own shard in parallel)."""
    stream = partition_weight_bytes_per_chip(graph, part, variables) \
        / platform.dma_bw
    return platform.reconf_fixed_s + stream
