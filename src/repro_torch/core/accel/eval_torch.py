"""Batched design-point evaluation on a torch device (the port of
``repro.core.accel.eval_jax``).

``_eval_core`` is a line-for-line port of the JAX array program, itself a
port of ``BatchedEvaluator.evaluate_batch`` + ``_collective_bytes``: pure
elementwise ops, kind-masked column terms (``torch.where`` over masks kept
in ``DeviceTensors``, so the same program serves any architecture and
padded columns add exactly zero), and segmented partition reductions.

The partition-time reduction takes the kernel route when
``StaticSpec.use_kernel`` is set (the default): ``segred.segmented_reduce``,
which launches the hand-written CUDA kernel on a card and runs its plain
version on the CPU. Otherwise it takes the dense one-hot route, exactly as
the JAX program does without Pallas. The other segment sums stay one-hot
einsums.

Large integer products (batch x rows x fm_width) are formed in the float
dtype, as in the JAX program. Python float constants meeting a float32
tensor do not promote it, so every comparison (``thr_time > 0`` and the
like) stays in the working dtype.

Precision contract (tests/test_torch_eval.py):
  float32 (default)   agrees with the JAX float32 engine to 1e-5 relative,
                      feasibility exact.
  float64             agrees with the numpy ``BatchedEvaluator`` at 1e-9.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.accel import segred
from repro_torch.core.accel.lowering import (
    DeviceTensors,
    StaticSpec,
    build_static_spec,
    lower_program,
)
from repro_torch.core.batched_eval import BatchResult
from repro_torch.core.perfmodel import (
    BF16,
    TRAIN_STATE_MULT,
    ZERO1_RESIDENT,
    ZERO1_SHARDED,
)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


# ----------------------------------------------------------------------
# the array program
# ----------------------------------------------------------------------

def _frac(x):
    return (x - 1.0) / x


def _madd(total, mask, term):
    """Masked column add: exact (+0.0 off-mask), pad-safe."""
    return total + torch.where(mask[None, :], term, torch.zeros_like(term))


def _collective_bytes(static: StaticSpec, A: DeviceTensors,
                      si, so, kk, sif, sof, kkf, b_in):
    """Port of BatchedEvaluator._collective_bytes (mask-driven)."""
    fdt = sif.dtype
    train_mult = 2.0 if static.train else 1.0
    total = torch.zeros_like(sif)
    batchf = A.batch.to(fdt)
    rowsf = A.rows.to(fdt)
    colsf = A.cols.to(fdt)
    fmf = A.fm_width.to(fdt)
    rows_eff = torch.ones_like(rowsf) if static.decode else rowsf

    fm_shard = (batchf * rows_eff * fmf)[None, :] * BF16 / (b_in * kkf)

    total = _madd(total, A.m_tp, 2.0 * _frac(sof) * fm_shard * train_mult)

    tokens_shard = (batchf * rows_eff)[None, :] / (b_in * kkf)
    fanout = torch.clamp(A.ep_topk, min=1).to(fdt)
    total = _madd(total, A.m_ep,
                  2.0 * tokens_shard * (fanout * fmf)[None, :] * BF16
                  * _frac(sof) * train_mult)

    total = _madd(total, A.m_vocab,
                  2.0 * _frac(sof) * fm_shard * train_mult)

    if static.decode:
        vhead = (colsf * batchf)[None, :] * BF16 / kkf * _frac(sof)
    else:
        # distributed softmax stats: constant in s_out, so the scalar
        # path's s_out > 1 guard must be kept explicitly
        vh = 2.0 * 8.0 * (batchf * rowsf)[None, :] / (b_in * kkf)
        vhead = torch.where(so > 1, vh, torch.zeros_like(vh))
    total = _madd(total, A.m_vhead, vhead)

    # sequence/context parallelism (s_in > 1): all terms carry the
    # (s_in-1)/s_in factor, vanishing at s_in = 1
    kvlf = A.kv_limit.to(fdt)
    kv_div = torch.where(A.kv_limit[None, :] > 0,
                         torch.minimum(sof, kvlf[None, :]),
                         torch.clamp(sof, min=1.0))
    dh = fmf / torch.clamp(colsf, min=1.0)
    total = _madd(total, A.internal,
                  (batchf[None, :] / kkf) * colsf[None, :]
                  / torch.clamp(kv_div, min=1.0) * ((dh + 2.0) * 4.0)[None, :]
                  * _frac(sif))
    total = _madd(total, A.m_kv,
                  A.kv_bytes[None, :] / (kv_div * kkf) * _frac(sif)
                  * train_mult)
    total = _madd(total, A.m_carry,
                  A.carry_bytes[None, :] / kkf * _frac(sif) * train_mult)

    # data-parallel gradient all-reduce (per step, ring over k)
    if static.train:
        grad = A.weight_bytes / sof * 2.0 * static.grad_compression
        total = total + 2.0 * _frac(kkf) * grad
    return total


def _realizable(static: StaticSpec, A: DeviceTensors, si, so, kk):
    cap = A.val_cap                           # sentinel lut slot (-1)
    lut = A.val_lut
    ia = lut[torch.minimum(si, cap)]
    ib = lut[torch.minimum(so, cap)]
    ic = lut[torch.minimum(kk, cap)]
    known = (ia >= 0) & (ib >= 0) & (ic >= 0)
    return known & A.real_table[ia.clamp(min=0), ib.clamp(min=0),
                                ic.clamp(min=0)]


def _eval_core(static: StaticSpec, A: DeviceTensors,
               si, so, kk, cb, single_partition: bool = False
               ) -> Dict[str, torch.Tensor]:
    """The batched array program; [N, n] fold tensors + [N, n-1] cut
    bitmask -> per-candidate results (a dict of tensors on A's device).

    ``single_partition`` promises that every row of ``cb`` is all-False:
    the partition machinery collapses to one max/sum over the node axis."""
    n = static.n_nodes
    N = si.shape[0]
    fdt = A.flops.dtype
    idt = A.batch.dtype
    dev = A.flops.device
    si = si.to(idt)
    so = so.to(idt)
    kk = kk.to(idt)
    cb = cb.to(torch.bool)
    sif = si.to(fdt)
    sof = so.to(fdt)
    kkf = kk.to(fdt)

    # ---------------- node roofline (perfmodel.node_eval) ----------
    c = sif * sof * kkf
    b_in = torch.where(A.internal[None, :],
                       torch.ones((), dtype=fdt, device=dev), sif)
    compute_s = (A.flops / c) / (A.peak_flops * static.mxu_efficiency)

    w_per_chip = A.weight_bytes / sof
    act_per_chip = A.act_bytes / (b_in * kkf)
    inner_per_chip = A.inner_bytes / c

    # _state_sharding (KV sharding applies on attention-kind columns)
    kvlf = A.kv_limit.to(fdt)
    kv_div_a = torch.where(A.kv_limit[None, :] > 0,
                           torch.minimum(sof, kvlf[None, :]), sof)
    state_div = torch.where(A.m_attn[None, :],
                            kkf * torch.clamp(kv_div_a, min=1.0) * sif,
                            kkf * sof)
    state_repl = torch.where(
        A.m_attn[None, :] & (A.kv_limit[None, :] > 0)
        & (so > A.kv_limit[None, :]),
        sof / kv_div_a, torch.ones_like(sof))
    state_per_chip = A.state_bytes * state_repl / state_div

    train_mult = 3.0 if static.train else 1.0
    hbm = (act_per_chip + inner_per_chip) * train_mult
    if static.train:
        hbm = hbm + 2.0 * w_per_chip
    else:
        hbm = hbm + torch.where(A.weight_stream, w_per_chip,
                                torch.zeros_like(w_per_chip))
        hbm = hbm + state_per_chip
    memory_s = hbm / A.hbm_bw

    coll = _collective_bytes(static, A, si, so, kk, sif, sof, kkf, b_in)
    collective_s = coll / A.ici_bw * (1.0 - static.overlap_collectives)

    # ---------------- residency (Eq. 6) ----------------------------
    if static.train:
        if static.zero1:
            resident = w_per_chip * ZERO1_RESIDENT \
                + w_per_chip * ZERO1_SHARDED / kkf
        else:
            resident = w_per_chip * TRAIN_STATE_MULT
        stash_div = sif * kkf
        if static.seq_parallel_stash:
            stash_div = stash_div * torch.clamp(sof, min=1.0)
        fm = A.node_d / BF16                   # batch*rows*fm_width, exact
        resident = resident + fm * BF16 / stash_div
        resident = _madd(resident, A.m_head,
                         3.0 * A.inner_bytes[None, :]
                         / (b_in * kkf * torch.clamp(sof, min=1.0)))
    else:
        rows = (torch.ones_like(A.rows) if static.decode
                else A.rows).to(fdt)
        resident = w_per_chip + state_per_chip \
            + 2.0 * (A.batch.to(fdt) * rows * A.fm_width.to(fdt)
                     * BF16)[None, :] / (b_in * kkf)

    node_time = torch.maximum(torch.maximum(compute_s, memory_s),
                              collective_s)

    # ---------------- partition structure ---------------------------
    if n > 1:
        edge_valid = A.node_valid[:-1] & A.node_valid[1:]
        mism = ((b_in[:, :-1] != b_in[:, 1:]) | (kk[:, :-1] != kk[:, 1:])) \
            & edge_valid[None, :]
    else:
        mism = torch.zeros((N, 0), dtype=torch.bool, device=dev)
    iota_n = torch.arange(n, dtype=idt, device=dev)
    # padded columns are neutral everywhere EXCEPT the streaming chip
    # count (their fold product is 1, not 0) — zero them explicitly there
    c_eff = torch.where(A.node_valid[None, :], c, torch.zeros_like(c))

    if single_partition:
        # every candidate is one partition — no segment reductions, no
        # reconfiguration, no boundary staging
        pid = torch.zeros((N, n), dtype=idt, device=dev)
        nparts = torch.ones((N,), dtype=idt, device=dev)
        part_valid = iota_n[None, :] < 1
        t0 = node_time.amax(dim=1) if static.exec_model == "streaming" \
            else node_time.sum(dim=1)
        if not static.inter_matching and n > 1:
            t0 = t0 + torch.where(
                mism, A.reshard_full[:-1] / A.ici_bw, 0.0).sum(dim=1)
        t_part = torch.zeros((N, n), dtype=t0.dtype, device=dev)
        t_part[:, 0] = t0
        reconf = torch.zeros((N,), dtype=fdt, device=dev)
        sum_t = t0
    else:
        pid = torch.cat(
            [torch.zeros((N, 1), dtype=idt, device=dev),
             torch.cumsum(cb.to(idt), dim=1)], dim=1)
        nparts = pid[:, -1] + 1
        part_valid = iota_n[None, :] < nparts[:, None]
        # dense [N, n_src, n_part] partition one-hot: seg-sum becomes a
        # batched matvec, seg-max a masked max
        onehot = pid[:, :, None] == iota_n[None, None, :]
        onehot_f = onehot.to(fdt)

        def seg_sum(vals):
            return torch.einsum("rj,rjp->rp", vals, onehot_f)

        def seg_max(vals):
            return torch.where(onehot, vals[:, :, None],
                               -torch.inf).amax(dim=1)

        if static.use_kernel:
            t_raw = segred.segmented_reduce(
                node_time.contiguous(), pid,
                "max" if static.exec_model == "streaming" else "sum")
            t_base = torch.where(part_valid, t_raw, 0.0) \
                if static.exec_model == "streaming" else t_raw
        elif static.exec_model == "streaming":
            t_base = torch.where(part_valid, seg_max(node_time), 0.0)
        else:
            t_base = seg_sum(node_time)

        t_part = t_base
        if not static.inter_matching and n > 1:
            # resharding collectives at intra-partition layout changes
            edge_t = torch.where(~cb & mism,
                                 A.reshard_full[:-1] / A.ici_bw, 0.0)
            reshard = torch.einsum("rj,rjp->rp", edge_t, onehot_f[:, :-1, :])
            t_part = t_part + reshard
        t_part = torch.where(part_valid, t_part, 0.0)

        # reconfiguration (Eq. 3): first configuration is pre-loaded
        w_part = seg_sum(w_per_chip)
        t_conf_part = A.reconf_fixed_s + w_part / A.dma_bw
        later = part_valid & (iota_n[None, :] >= 1)
        reconf = torch.where(later, t_conf_part, 0.0).sum(dim=1)

        sum_t = t_part.sum(dim=1)
    latency = sum_t + reconf
    # objective configuration is per-problem data: both Eq. 3 and Eq. 4
    # are computed and a where selects
    Bam = A.batch_amortisation
    thr_time = Bam * sum_t + reconf
    throughput = torch.where(thr_time > 0,
                             Bam / torch.where(thr_time > 0, thr_time, 1.0),
                             0.0)
    obj = torch.where(A.obj_latency, latency, -throughput)

    # ---------------- constraints ----------------------------------
    bad = torch.zeros(N, dtype=torch.bool, device=dev)
    # channel factor (Eq. 8) + cut legality + mesh realisability
    if n > 1:
        bad |= (cb & ~A.cut_allowed[None, :]).any(dim=1)
    bad |= (A.rows % si != 0).any(dim=1)
    bad |= (A.col_div % so != 0).any(dim=1)
    bad |= (A.batch % kk != 0).any(dim=1)
    if static.strict_kv:
        bad |= ((A.kv_limit > 0) & (so > A.kv_limit)).any(dim=1)
    bad |= ~_realizable(static, A, si, so, kk).all(dim=1)
    # intra matching (Eq. 9)
    if static.intra_matching:
        bad |= (A.elementwise & (si != so)).any(dim=1)
    # inter matching (Eq. 10), partition-local
    if static.inter_matching and n > 1:
        bad |= (~cb & mism).any(dim=1)
    # scan tying, partition-local (consecutive member pairs, padded with
    # (0, 0) self-pairs which can never differ)
    if static.scan_tying:
        a, b = A.pair_a, A.pair_b
        differ = (si[:, a] != si[:, b]) | (so[:, a] != so[:, b]) \
            | (kk[:, a] != kk[:, b])
        differ &= pid[:, a] == pid[:, b]
        bad |= differ.any(dim=1)
    # resource (Eq. 6) + streaming chip budget + bandwidth (Eq. 7)
    if single_partition:
        bad |= resident.sum(dim=1) > A.hbm_bytes
        if static.exec_model == "streaming":
            bad |= c_eff.sum(dim=1) > A.chips
        # single partition: no boundary staging, bandwidth never binds
    else:
        res_part = seg_sum(resident)
        multi = nparts > 1
        ones = torch.ones((N, 1), dtype=torch.bool, device=dev)
        start = torch.cat([ones, cb], dim=1)
        end = torch.cat([cb, ones], dim=1)
        d_io = seg_sum(A.node_d[None, :]
                       * (start.to(fdt) + end.to(fdt)))
        res_tot = res_part + torch.where(multi[:, None],
                                         d_io / A.chips, 0.0)
        bad |= (part_valid & (res_tot > A.hbm_bytes)).any(dim=1)
        if static.exec_model == "streaming":
            chips_part = seg_sum(c_eff)
            bad |= (part_valid & (chips_part > A.chips)).any(dim=1)
        # bandwidth uses the pre-resharding partition interval, exactly
        # like constraints.check_bandwidth
        bw = A.hbm_bw * A.chips
        bw_bad = multi[:, None] & part_valid & (t_base > 0) \
            & (d_io / torch.where(t_base > 0, t_base, 1.0) > bw)
        bad |= bw_bad.any(dim=1)

    return {
        "objective": obj, "feasible": ~bad, "latency": latency,
        "throughput": throughput, "part_times": t_part, "nparts": nparts,
        "reconf_time": reconf, "node_resident": resident,
        "node_times": node_time, "node_collective": coll,
    }


@torch.no_grad()
def evaluate_batch_torch(static: StaticSpec, arrays: DeviceTensors,
                         si, so, kk, cb) -> Dict[str, torch.Tensor]:
    """Standalone batched evaluate on ``arrays``' device."""
    return _eval_core(static, arrays, si, so, kk, cb)


# ----------------------------------------------------------------------
# host-facing wrapper
# ----------------------------------------------------------------------

class TorchEvaluator:
    """Device-resident counterpart of ``BatchedEvaluator``.

    Shares the host lowering (packing helpers, base designs, clamp/scope
    semantics) and evaluates through the torch array program on
    ``device`` (default: the card). Results come back as a numpy
    ``BatchResult`` so callers are engine-agnostic.

    ``pad_nodes`` pads the node axis; callers still pass unpadded [N, n]
    fold arrays — the wrapper pads candidates with neutral fold-1 columns
    and slices results back to the real node count. ``arrays`` replaces
    the lowered constants with given ``DeviceTensors`` (for instance the
    JAX package's, through ``lowering.tensors_from_numpy``); its node axis
    sets the padding.
    """

    def __init__(self, bev, *, device=None, dtype=None,
                 use_kernel: bool = True, pad_nodes=None, pad_pairs=None,
                 pad_vals=None, pad_lut=None,
                 arrays: Optional[DeviceTensors] = None):
        self.bev = bev
        if arrays is None:
            self.static, self.arrays = lower_program(
                bev, device=device, dtype=dtype, use_kernel=use_kernel,
                pad_nodes=pad_nodes, pad_pairs=pad_pairs,
                pad_vals=pad_vals, pad_lut=pad_lut)
        else:
            self.static = build_static_spec(
                bev, use_kernel=use_kernel,
                pad_nodes=int(arrays.flops.shape[0]))
            self.arrays = arrays
        self.device = self.arrays.flops.device
        self.n_pad = self.static.n_nodes

    @classmethod
    def from_problem(cls, problem, **kw) -> "TorchEvaluator":
        return cls(problem.batched(), **kw)

    # packing delegates to the host evaluator (same layout)
    def pack(self, designs):
        return self.bev.pack(designs)

    def unpack_row(self, si, so, kk, cb, row):
        return self.bev.unpack_row(si, so, kk, cb, row)

    def evaluate_batch(self, s_in, s_out, kern, cuts) -> BatchResult:
        si = np.asarray(s_in)
        so = np.asarray(s_out)
        kk = np.asarray(kern)
        cb = np.asarray(cuts, bool)
        N, n = si.shape
        if n != self.bev.n_nodes or so.shape != si.shape \
                or kk.shape != si.shape or cb.shape != (N, max(n - 1, 0)):
            raise ValueError(
                f"expected fold arrays [N, {self.bev.n_nodes}] and cut mask "
                f"[N, {self.bev.n_nodes - 1}]; got s_in {si.shape}, s_out "
                f"{so.shape}, kern {kk.shape}, cuts {cb.shape}")
        if self.n_pad > n:
            pad = ((0, 0), (0, self.n_pad - n))
            si = np.pad(si, pad, constant_values=1)
            so = np.pad(so, pad, constant_values=1)
            kk = np.pad(kk, pad, constant_values=1)
            cb = np.pad(cb, ((0, 0), (0, self.n_pad - 1 - cb.shape[1])),
                        constant_values=False)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        with _metrics.device_dispatch("eval_batch", batch=N):
            out = evaluate_batch_torch(
                self.static, self.arrays, t(si.astype(np.int64)),
                t(so.astype(np.int64)), t(kk.astype(np.int64)), t(cb))
        with _trace.span("accel.d2h.eval_batch", batch=N):
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return BatchResult(
            objective=np.asarray(out["objective"], np.float64),
            feasible=np.asarray(out["feasible"], bool),
            latency=np.asarray(out["latency"], np.float64),
            throughput=np.asarray(out["throughput"], np.float64),
            part_times=np.asarray(out["part_times"], np.float64)[:, :n],
            nparts=np.asarray(out["nparts"], np.int64),
            reconf_time=np.asarray(out["reconf_time"], np.float64),
            node_resident=np.asarray(out["node_resident"],
                                     np.float64)[:, :n],
            node_times=np.asarray(out["node_times"], np.float64)[:, :n],
            node_collective=np.asarray(out["node_collective"],
                                       np.float64)[:, :n],
        )


__all__ = ["_eval_core", "evaluate_batch_torch", "TorchEvaluator"]
