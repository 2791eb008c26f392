"""Batched design-point evaluation on a torch device (the port of
``repro.core.accel.eval_jax``).

``_eval_core`` is a line-for-line port of the JAX array program, itself a
port of ``BatchedEvaluator.evaluate_batch`` + ``_collective_bytes``: pure
elementwise ops, kind-masked column terms (``torch.where`` over masks kept
in ``DeviceTensors``, so the same program serves any architecture and
padded columns add exactly zero), and segmented partition reductions.

Lanes: the program takes ``DeviceTensors`` with a leading problem ("lane")
axis and [P, R, n] candidates, so a fleet bucket's problems evaluate in one
pass; one problem's tensors and [R, n] candidates are the P = 1 case (a
lane axis is added and taken off again). What JAX gets from ``jax.vmap`` is
written out here.

The partition-time reduction takes the kernel route when
``StaticSpec.use_kernel`` is set (the default): ``segred.segmented_reduce``
over the [P·R, n] rows of all lanes in one launch, which launches the
hand-written CUDA kernel on a card and runs its plain version on the CPU.
Otherwise it takes the dense one-hot route, exactly as the JAX program does
without Pallas.

Every other float sum is order-fixed, so that a row's result does not
depend on how many rows or lanes share the call, on the node padding or on
the device. A candidate's total time and reconfiguration time add its
partitions left to right, as the scalar reference does
(``_sequential_sums``; callers that know how many partitions a batch can
have say so with ``max_parts``, which bounds the adds). Segment sums are a segmented Hillis-Steele scan
read at each partition's last real node (``_seg_sums``), and the other sums
over one axis a pairwise tree over the axis padded with zeros to a power of
two (``_tree_sum``). Adding a padded zero is exact, so the association of a
row's real terms is the same at any padding. (A matrix product or
``torch.sum`` picks its reduction order by shape: on the card a fleet's
rows and an unpadded problem's rows would round differently.)

Large integer products (batch x rows x fm_width) are formed in the float
dtype, as in the JAX program. Python float constants meeting a float32
tensor do not promote it, so every comparison (``thr_time > 0`` and the
like) stays in the working dtype.

Precision contract (tests/test_torch_eval.py):
  float32 (default)   agrees with the JAX float32 engine to 1e-5 relative,
                      feasibility exact.
  float64             agrees with the numpy ``BatchedEvaluator`` at 1e-9.
  padding, lanes      bitwise: a padded problem, or a problem among other
                      lanes, gives the unpadded single problem's bits.
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
    lift_tensors,
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
# lanes and order-fixed reductions
# ----------------------------------------------------------------------

def lifted(A):
    """``A`` with a lane axis: one problem's ``DeviceTensors`` get a lane
    axis of 1; tensors that have one, or any other object, are returned as
    they are."""
    if isinstance(A, DeviceTensors) and A.flops.dim() == 1:
        return lift_tensors(A)
    return A


def _nd(x):
    """A lane's per-node row [P, n] against [P, R, n] candidates."""
    return x[:, None, :]


def _sc(x):
    """A lane scalar [P] against [P, R, n]."""
    return x[:, None, None]


def _take(table: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``table[p, i0, i1, ...]`` for each lane p: ``table`` has a leading
    lane axis and one axis per index; the indices (tensors or ints)
    broadcast against each other to [P, ...]."""
    if table.shape[0] == 1:
        return table[0][idx]
    shape = torch.broadcast_shapes(*(i.shape for i in idx
                                     if isinstance(i, torch.Tensor)))
    flat = torch.arange(table.shape[0], device=table.device).view(
        (-1,) + (1,) * (len(shape) - 1))
    for k, i in enumerate(idx):
        flat = flat * table.shape[k + 1] + i
    return table.reshape(-1)[flat]


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree of neighbours: the
    axis is padded with zeros to a power of two, then elements 2i and 2i+1
    are added, level by level, until one is left. Terms past the last
    nonzero one only add zeros, so the result is the same at any padding of
    the axis, for any number of rows, on any device; up to three terms add
    left to right."""
    L = x.shape[-1]
    L2 = 1
    while L2 < L:
        L2 *= 2
    if L2 != L:
        x = torch.nn.functional.pad(x, (0, L2 - L))
    while L2 > 1:
        L2 //= 2
        x = x.reshape(x.shape[:-1] + (L2, 2))
        x = x[..., 0] + x[..., 1]
    return x[..., 0]


def _seg_sums(vals: torch.Tensor, pid: torch.Tensor,
              is_end: torch.Tensor) -> torch.Tensor:
    """Per-partition sums of [..., P, R, n] node values over [P, R, n]
    monotone partition ids: out[..., p] is the sum over the nodes of
    partition p (0 for p past the last). A segmented Hillis-Steele scan
    (step d adds the node d places before, within the segment) read at
    each partition's last real node (``is_end``): a node's sum depends only
    on its offset in its partition, never on the padded nodes after it."""
    n = vals.shape[-1]
    d = 1
    while d < n:
        same = pid[..., d:] == pid[..., :-d]
        vals = torch.cat([vals[..., :d], vals[..., d:] + torch.where(
            same, vals[..., :-d], 0.0)], dim=-1)
        d *= 2
    slot = torch.where(is_end, pid, n).expand(vals.shape)
    out = torch.zeros(vals.shape[:-1] + (n + 1,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, slot, vals)[..., :n]


def _sequential_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sums over the last axis of [..., n] whose terms past the first ``k``
    are zero, added left to right (as the scalar reference adds partition
    times): ``k - 1`` element-wise adds, the same bits at any padding."""
    acc = x[..., 0]
    for q in range(1, k):
        acc = acc + x[..., q]
    return acc


# ----------------------------------------------------------------------
# the array program
# ----------------------------------------------------------------------

def _frac(x):
    return (x - 1.0) / x


def _madd(total, mask, term):
    """Masked column add: exact (+0.0 off-mask), pad-safe."""
    return total + torch.where(_nd(mask), term, torch.zeros_like(term))


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

    fm_shard = _nd(batchf * rows_eff * fmf) * BF16 / (b_in * kkf)

    total = _madd(total, A.m_tp, 2.0 * _frac(sof) * fm_shard * train_mult)

    tokens_shard = _nd(batchf * rows_eff) / (b_in * kkf)
    fanout = torch.clamp(A.ep_topk, min=1).to(fdt)
    total = _madd(total, A.m_ep,
                  2.0 * tokens_shard * _nd(fanout * fmf) * BF16
                  * _frac(sof) * train_mult)

    total = _madd(total, A.m_vocab,
                  2.0 * _frac(sof) * fm_shard * train_mult)

    if static.decode:
        vhead = _nd(colsf * batchf) * BF16 / kkf * _frac(sof)
    else:
        # distributed softmax stats: constant in s_out, so the scalar
        # path's s_out > 1 guard must be kept explicitly
        vh = 2.0 * 8.0 * _nd(batchf * rowsf) / (b_in * kkf)
        vhead = torch.where(so > 1, vh, torch.zeros_like(vh))
    total = _madd(total, A.m_vhead, vhead)

    # sequence/context parallelism (s_in > 1): all terms carry the
    # (s_in-1)/s_in factor, vanishing at s_in = 1
    kvlf = A.kv_limit.to(fdt)
    kv_div = torch.where(_nd(A.kv_limit) > 0,
                         torch.minimum(sof, _nd(kvlf)),
                         torch.clamp(sof, min=1.0))
    dh = fmf / torch.clamp(colsf, min=1.0)
    total = _madd(total, A.internal,
                  (_nd(batchf) / kkf) * _nd(colsf)
                  / torch.clamp(kv_div, min=1.0) * _nd((dh + 2.0) * 4.0)
                  * _frac(sif))
    total = _madd(total, A.m_kv,
                  _nd(A.kv_bytes) / (kv_div * kkf) * _frac(sif)
                  * train_mult)
    total = _madd(total, A.m_carry,
                  _nd(A.carry_bytes) / kkf * _frac(sif) * train_mult)

    # data-parallel gradient all-reduce (per step, ring over k)
    if static.train:
        grad = _nd(A.weight_bytes) / sof * 2.0 * static.grad_compression
        total = total + 2.0 * _frac(kkf) * grad
    return total


def _realizable(static: StaticSpec, A: DeviceTensors, si, so, kk):
    cap = _sc(A.val_cap)                      # sentinel lut slot (-1)
    lut = A.val_lut
    ia = _take(lut, torch.minimum(si, cap))
    ib = _take(lut, torch.minimum(so, cap))
    ic = _take(lut, torch.minimum(kk, cap))
    known = (ia >= 0) & (ib >= 0) & (ic >= 0)
    return known & _take(A.real_table, ia.clamp(min=0), ib.clamp(min=0),
                         ic.clamp(min=0))


def _eval_core(static: StaticSpec, A: DeviceTensors,
               si, so, kk, cb, single_partition: bool = False,
               max_parts: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The batched array program; [P, R, n] fold tensors + [P, R, n-1] cut
    bitmask over lane-stacked ``A`` -> per-candidate results (a dict of
    [P, R] and [P, R, n] tensors on A's device). One problem's ``A`` with
    [R, n] candidates is the P = 1 case and returns [R] and [R, n].

    ``single_partition`` promises that every row of ``cb`` is all-False:
    the partition machinery collapses to one max/sum over the node axis.
    ``max_parts`` (a host int) promises that no candidate has more
    partitions: the left-to-right sums over partitions stop there (the
    terms past it are zero, so the bits are the same)."""
    if si.dim() == 2:
        out = _eval_core(static, lifted(A), si[None], so[None], kk[None],
                         cb[None], single_partition, max_parts)
        return {k: v[0] for k, v in out.items()}
    n = static.n_nodes
    P, N = si.shape[:2]
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
    b_in = torch.where(_nd(A.internal),
                       torch.ones((), dtype=fdt, device=dev), sif)
    compute_s = (_nd(A.flops) / c) / _sc(A.peak_flops
                                         * static.mxu_efficiency)

    w_per_chip = _nd(A.weight_bytes) / sof
    act_per_chip = _nd(A.act_bytes) / (b_in * kkf)
    inner_per_chip = _nd(A.inner_bytes) / c

    # _state_sharding (KV sharding applies on attention-kind columns)
    kvl = _nd(A.kv_limit)
    kvlf = _nd(A.kv_limit.to(fdt))
    kv_div_a = torch.where(kvl > 0, torch.minimum(sof, kvlf), sof)
    state_div = torch.where(_nd(A.m_attn),
                            kkf * torch.clamp(kv_div_a, min=1.0) * sif,
                            kkf * sof)
    state_repl = torch.where(
        _nd(A.m_attn) & (kvl > 0) & (so > kvl),
        sof / kv_div_a, torch.ones_like(sof))
    state_per_chip = _nd(A.state_bytes) * state_repl / state_div

    train_mult = 3.0 if static.train else 1.0
    hbm = (act_per_chip + inner_per_chip) * train_mult
    if static.train:
        hbm = hbm + 2.0 * w_per_chip
    else:
        hbm = hbm + torch.where(_nd(A.weight_stream), w_per_chip,
                                torch.zeros_like(w_per_chip))
        hbm = hbm + state_per_chip
    memory_s = hbm / _sc(A.hbm_bw)

    coll = _collective_bytes(static, A, si, so, kk, sif, sof, kkf, b_in)
    collective_s = coll / _sc(A.ici_bw) * (1.0 - static.overlap_collectives)

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
        fm = _nd(A.node_d) / BF16              # batch*rows*fm_width, exact
        resident = resident + fm * BF16 / stash_div
        resident = _madd(resident, A.m_head,
                         3.0 * _nd(A.inner_bytes)
                         / (b_in * kkf * torch.clamp(sof, min=1.0)))
    else:
        rows = (torch.ones_like(A.rows) if static.decode
                else A.rows).to(fdt)
        resident = w_per_chip + state_per_chip \
            + 2.0 * _nd(A.batch.to(fdt) * rows * A.fm_width.to(fdt)
                        * BF16) / (b_in * kkf)

    node_time = torch.maximum(torch.maximum(compute_s, memory_s),
                              collective_s)

    # ---------------- partition structure ---------------------------
    if n > 1:
        edge_valid = A.node_valid[:, :-1] & A.node_valid[:, 1:]
        mism = ((b_in[..., :-1] != b_in[..., 1:])
                | (kk[..., :-1] != kk[..., 1:])) & _nd(edge_valid)
    else:
        mism = torch.zeros((P, N, 0), dtype=torch.bool, device=dev)
    iota_n = torch.arange(n, dtype=idt, device=dev)
    # padded columns are neutral everywhere EXCEPT the streaming chip
    # count (their fold product is 1, not 0) — zero them explicitly there
    c_eff = torch.where(_nd(A.node_valid), c, torch.zeros_like(c))
    reshard_s = A.reshard_full[:, :-1] / A.ici_bw[:, None]

    if single_partition:
        # every candidate is one partition — no segment reductions, no
        # reconfiguration, no boundary staging
        pid = torch.zeros((P, N, n), dtype=idt, device=dev)
        nparts = torch.ones((P, N), dtype=idt, device=dev)
        t0 = node_time.amax(dim=-1) if static.exec_model == "streaming" \
            else _tree_sum(node_time)
        if not static.inter_matching and n > 1:
            t0 = t0 + _tree_sum(torch.where(mism, _nd(reshard_s), 0.0))
        t_part = torch.zeros((P, N, n), dtype=t0.dtype, device=dev)
        t_part[..., 0] = t0
        reconf = torch.zeros((P, N), dtype=fdt, device=dev)
        sum_t = t0
    else:
        pid = torch.cat(
            [torch.zeros((P, N, 1), dtype=idt, device=dev),
             torch.cumsum(cb.to(idt), dim=-1)], dim=-1)
        nparts = pid[..., -1] + 1
        part_valid = iota_n < nparts[..., None]
        # a partition ends at a cut or at the last REAL node (padded nodes
        # continue the last partition and never end one)
        last_real = _nd(iota_n == (A.n_valid - 1)[:, None])
        ones = torch.ones((P, N, 1), dtype=torch.bool, device=dev)
        is_end = torch.cat([cb, ~ones], dim=-1) | last_real

        # the segment sums of this candidate batch, one scan for all
        start = torch.cat([ones, cb], dim=-1)
        end = torch.cat([cb, ones], dim=-1) | last_real
        seg_in = [w_per_chip, resident,
                  _nd(A.node_d) * (start.to(fdt) + end.to(fdt))]
        if static.exec_model == "streaming":
            seg_in.append(c_eff)
        reshard_at = len(seg_in)
        if not static.inter_matching and n > 1:
            # resharding collectives at intra-partition layout changes,
            # each edge in the partition of its source node
            edge_t = torch.where(~cb & mism, _nd(reshard_s), 0.0)
            seg_in.append(torch.cat(
                [edge_t, torch.zeros((P, N, 1), dtype=fdt, device=dev)],
                dim=-1))
        if not static.use_kernel and static.exec_model != "streaming":
            seg_in.append(node_time)
        sums = _seg_sums(torch.stack(seg_in), pid, is_end)
        w_part, res_part, d_io = sums[0], sums[1], sums[2]

        if static.use_kernel:
            t_raw = segred.segmented_reduce(
                node_time.reshape(P * N, n), pid.reshape(P * N, n),
                "max" if static.exec_model == "streaming" else "sum"
            ).view(P, N, n)
            t_base = torch.where(part_valid, t_raw, 0.0) \
                if static.exec_model == "streaming" else t_raw
        elif static.exec_model == "streaming":
            onehot = pid[..., :, None] == iota_n
            t_base = torch.where(part_valid, torch.where(
                onehot, node_time[..., None], -torch.inf).amax(dim=-2), 0.0)
        else:
            t_base = sums[-1]

        t_part = t_base
        if not static.inter_matching and n > 1:
            t_part = t_part + sums[reshard_at]
        t_part = torch.where(part_valid, t_part, 0.0)

        # reconfiguration (Eq. 3): first configuration is pre-loaded
        t_conf_part = _sc(A.reconf_fixed_s) + w_part / _sc(A.dma_bw)
        later = part_valid & (iota_n >= 1)
        sum_t, reconf = _sequential_sums(torch.stack(
            [t_part, torch.where(later, t_conf_part, 0.0)]),
            n if max_parts is None else max(1, min(int(max_parts), n)))
    latency = sum_t + reconf
    # objective configuration is per-problem data: both Eq. 3 and Eq. 4
    # are computed and a where selects
    Bam = A.batch_amortisation[:, None]
    thr_time = Bam * sum_t + reconf
    throughput = torch.where(thr_time > 0,
                             Bam / torch.where(thr_time > 0, thr_time, 1.0),
                             0.0)
    obj = torch.where(A.obj_latency[:, None], latency, -throughput)

    # ---------------- constraints ----------------------------------
    bad = torch.zeros((P, N), dtype=torch.bool, device=dev)
    # channel factor (Eq. 8) + cut legality + mesh realisability
    if n > 1:
        bad |= (cb & ~_nd(A.cut_allowed)).any(dim=-1)
    bad |= (_nd(A.rows) % si != 0).any(dim=-1)
    bad |= (_nd(A.col_div) % so != 0).any(dim=-1)
    bad |= (_nd(A.batch) % kk != 0).any(dim=-1)
    if static.strict_kv:
        bad |= ((kvl > 0) & (so > kvl)).any(dim=-1)
    bad |= ~_realizable(static, A, si, so, kk).all(dim=-1)
    # intra matching (Eq. 9)
    if static.intra_matching:
        bad |= (_nd(A.elementwise) & (si != so)).any(dim=-1)
    # inter matching (Eq. 10), partition-local
    if static.inter_matching and n > 1:
        bad |= (~cb & mism).any(dim=-1)
    # scan tying, partition-local (consecutive member pairs, padded with
    # (0, 0) self-pairs which can never differ)
    if static.scan_tying:
        pp = A.pair_a.shape[-1]
        a = _nd(A.pair_a).expand(P, N, pp)
        b = _nd(A.pair_b).expand(P, N, pp)
        at = lambda x, i: torch.gather(x, 2, i)
        differ = (at(si, a) != at(si, b)) | (at(so, a) != at(so, b)) \
            | (at(kk, a) != at(kk, b))
        differ &= at(pid, a) == at(pid, b)
        bad |= differ.any(dim=-1)
    # resource (Eq. 6) + streaming chip budget + bandwidth (Eq. 7)
    if single_partition:
        tot = _tree_sum(torch.stack([resident, c_eff]))
        bad |= tot[0] > A.hbm_bytes[:, None]
        if static.exec_model == "streaming":
            bad |= tot[1] > A.chips[:, None]
        # single partition: no boundary staging, bandwidth never binds
    else:
        multi = nparts > 1
        res_tot = res_part + torch.where(multi[..., None],
                                         d_io / _sc(A.chips), 0.0)
        bad |= (part_valid & (res_tot > _sc(A.hbm_bytes))).any(dim=-1)
        if static.exec_model == "streaming":
            bad |= (part_valid & (sums[3] > _sc(A.chips))).any(dim=-1)
        # bandwidth uses the pre-resharding partition interval, exactly
        # like constraints.check_bandwidth
        bw = _sc(A.hbm_bw * A.chips)
        bw_bad = multi[..., None] & part_valid & (t_base > 0) \
            & (d_io / torch.where(t_base > 0, t_base, 1.0) > bw)
        bad |= bw_bad.any(dim=-1)

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
