"""Batched design-space evaluation engine (Table-IV throughput path).

The optimisers' wall-clock is dominated by ``Problem.evaluate`` — scalar
Python over dataclasses, one candidate at a time. This module lowers an
``HDGraph`` + ``Platform`` + ``ModelOptions`` ONCE into flat numpy arrays
(per-node flops, weight/act/inner/state/kv/carry bytes, kind masks,
collective-kind one-hots) and then evaluates a *batch* of candidate designs
``(s_in, s_out, kern)[N, nodes]`` plus a cut bitmask ``[N, edges]`` as one
vectorised array program: roofline terms, collective bytes, Eq. 6 residency,
constraint masks, partition times via segmented max/sum, and the Eq. 5
objective.

The scalar path (core/perfmodel.py + core/objectives.py) stays the reference
implementation; tests/test_batched_eval.py asserts batched == scalar within
1e-9 on objective, feasibility, partition times and residency. All arrays are
float64 and the per-element operation order mirrors the scalar code, so the
agreement is near-bit-exact (only reduction orders differ).

The array layout is deliberately JAX-compatible (pure elementwise ops +
segment reductions over a static node axis) so a future PR can jit the hot
loop onto an accelerator for GPU/TPU-resident search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.hdgraph import HDGraph, Variables
from repro_torch.core.perfmodel import (
    BF16,
    ModelOptions,
    TRAIN_STATE_MULT,
    ZERO1_RESIDENT,
    ZERO1_SHARDED,
)
from repro_torch.core.platform import Platform

_ATTN_KINDS = ("attn", "cross_attn", "enc_attn")

#: the platform-derived scalars the accel lowering consumes as per-problem
#: DEVICE DATA (core/accel/lowering.py), in ``platform_scalars()`` order.
#: Everything a candidate evaluation needs from the platform beyond the
#: fold-value menu reduces to this vector plus the realisability cube —
#: which is what lets one jitted executable serve any platform.
PLATFORM_SCALAR_FIELDS = ("peak_flops", "hbm_bw", "hbm_bytes", "ici_bw",
                          "dma_bw", "reconf_fixed_s", "chips")


@dataclass
class BatchResult:
    """Vectorised analogue of ``objectives.Evaluation`` for N candidates."""

    objective: np.ndarray          # [N] O(V), lower is better (Eq. 5)
    feasible: np.ndarray           # [N] bool
    latency: np.ndarray            # [N] Eq. 3
    throughput: np.ndarray         # [N] positive items/s (Eq. 4 un-negated)
    part_times: np.ndarray         # [N, nodes] T(P_i); entries >= nparts are 0
    nparts: np.ndarray             # [N] number of partitions
    reconf_time: np.ndarray        # [N] |C| * t_conf
    node_resident: np.ndarray      # [N, nodes] per-chip Eq. 6 residency
    node_times: np.ndarray         # [N, nodes] roofline node latency
    node_collective: np.ndarray = None  # [N, nodes] per-chip collective bytes

    def __len__(self) -> int:
        return int(self.objective.shape[0])


class BatchedEvaluator:
    """One-time lowering of (graph, platform, backend rules, objective) into
    flat arrays + a vectorised ``evaluate_batch``."""

    def __init__(self, graph: HDGraph, platform: Platform, *,
                 strict_kv: bool, intra_matching: bool, inter_matching: bool,
                 scan_tying: bool, objective: str = "throughput",
                 exec_model: str = "streaming", batch_amortisation: int = 256,
                 opts: ModelOptions = ModelOptions()):
        self.graph = graph
        self.platform = platform
        self.strict_kv = strict_kv
        self.intra_matching = intra_matching
        self.inter_matching = inter_matching
        self.scan_tying = scan_tying
        self.objective = objective
        self.exec_model = exec_model
        self.batch_amortisation = batch_amortisation
        self.opts = opts
        self.mode = graph.mode
        self._real_memo: Dict[Tuple[int, int, int], bool] = {}
        self._lower()

    @classmethod
    def from_problem(cls, problem) -> "BatchedEvaluator":
        b = problem.backend
        return cls(problem.graph, problem.platform,
                   strict_kv=b.strict_kv, intra_matching=b.intra_matching,
                   inter_matching=b.inter_matching, scan_tying=b.scan_tying,
                   objective=problem.objective, exec_model=problem.exec_model,
                   batch_amortisation=problem.batch_amortisation,
                   opts=problem.opts)

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------
    def _lower(self) -> None:
        nodes = self.graph.nodes
        n = len(nodes)
        self.n_nodes = n
        f = lambda attr: np.array([getattr(x, attr) for x in nodes], np.float64)
        i = lambda attr: np.array([getattr(x, attr) for x in nodes], np.int64)
        m = lambda attr: np.array([bool(getattr(x, attr)) for x in nodes])

        self.flops = f("flops")
        self.weight_bytes = f("weight_bytes")
        self.act_bytes = f("act_bytes")
        self.inner_bytes = f("inner_bytes")
        self.state_bytes = f("state_bytes")
        self.kv_bytes = f("kv_bytes")
        self.carry_bytes = f("carry_bytes")
        self.batch = i("batch")
        self.rows = i("rows")
        self.cols = i("cols")
        self.fm_width = i("fm_width")
        self.col_div = np.array([x.col_div for x in nodes], np.int64)
        self.kv_limit = i("kv_limit")
        self.ep_topk = i("ep_topk")
        self.scan_group = i("scan_group")

        self.internal = m("internal_rows")
        self.elementwise = m("elementwise")
        self.weight_stream = m("weight_stream")
        self.attnlike = np.array([x.kind in _ATTN_KINDS for x in nodes])
        self.is_head = np.array([x.kind == "head" for x in nodes])
        ck = lambda kind: np.array([x.collective_kind == kind for x in nodes])
        self.c_tp = ck("tp_allreduce")
        self.c_ep = ck("ep_alltoall")
        self.c_vocab = ck("vocab_allreduce")
        self.c_vhead = ck("vocab_head")

        allowed = np.zeros(max(n - 1, 0), bool)
        for e in self.graph.cut_edges:
            allowed[e] = True
        self.cut_allowed = allowed

        # static column index sets — kind-specific terms run on slices, not
        # full-width masked arrays (most kinds touch a handful of nodes)
        w = lambda mask: np.nonzero(mask)[0]
        self.i_attn = w(self.attnlike)
        self.i_head = w(self.is_head)
        self.i_tp = w(self.c_tp)
        self.i_ep = w(self.c_ep)
        self.i_vocab = w(self.c_vocab)
        self.i_vhead = w(self.c_vhead)
        self.i_int = w(self.internal)
        self.i_kv = w(~self.internal & (self.kv_bytes > 0))
        self.i_carry = w(~self.internal & (self.kv_bytes == 0)
                         & (self.carry_bytes > 0))
        self.i_ew = w(self.elementwise)
        self.i_kvlim = w(self.kv_limit > 0)

        # mesh-realisability lookup table over the platform fold menu (small
        # for real meshes: products of axis subsets). Falls back to the
        # memoised unique-triple path for very rich menus.
        vals = self.platform.fold_values()
        if len(vals) <= 24:
            nv = len(vals)
            table = np.zeros((nv, nv, nv), bool)
            for a, fa in enumerate(vals):
                for b, fb in enumerate(vals):
                    for d, fd in enumerate(vals):
                        table[a, b, d] = self.platform.folds_realizable(
                            (fa, fb, fd))
            self._real_table = table
            # value -> menu index (-1 = not a platform fold value)
            self._val_max = vals[-1]
            lut = np.full(self._val_max + 2, -1, np.int64)
            lut[np.array(vals)] = np.arange(nv)
            self._val_lut = lut
        else:
            self._real_table = None

        # Boundary featuremap bytes (Eq. 7 convention: full rows, bf16).
        self.node_d = (self.batch * self.rows * self.fm_width).astype(
            np.float64) * 2.0
        # Resharding all-gather bytes when edge layouts mismatch (spmd
        # backend): full featuremap of the upstream node at its mode rows.
        r_rows = np.where(self.internal, 1,
                          1 if self.mode == "decode" else self.rows)
        self.reshard_full = (self.batch * r_rows * self.fm_width).astype(
            np.float64) * 2.0

        # scan-group consecutive member pairs (pid is monotone along the
        # chain, so same-partition members of a group are consecutive in its
        # ordered member list — pairwise equality is a complete check).
        pairs = []
        by_group: Dict[int, List[int]] = {}
        for j, g in enumerate(self.scan_group.tolist()):
            if g >= 0:
                by_group.setdefault(g, []).append(j)
        for members in by_group.values():
            pairs.extend(zip(members[:-1], members[1:]))
        self.scan_pairs = np.array(pairs, np.int64).reshape(-1, 2)

    # ------------------------------------------------------------------
    def platform_scalars(self) -> np.ndarray:
        """The platform scalar vector, ``PLATFORM_SCALAR_FIELDS`` order.

        float64 [7]; ``chips`` is float (exact for any real mesh). The jax
        lowering turns each entry into a scalar device array so platform
        identity never enters the traced program.
        """
        p = self.platform
        return np.array([float(getattr(p, f)) for f in
                         PLATFORM_SCALAR_FIELDS], np.float64)

    # ------------------------------------------------------------------
    # packing helpers
    # ------------------------------------------------------------------
    def pack(self, designs: Sequence[Variables]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        n, N = self.n_nodes, len(designs)
        si = np.empty((N, n), np.int64)
        so = np.empty((N, n), np.int64)
        kk = np.empty((N, n), np.int64)
        cb = np.zeros((N, max(n - 1, 0)), bool)
        for r, v in enumerate(designs):
            si[r] = v.s_in
            so[r] = v.s_out
            kk[r] = v.kern
            for c in v.cuts:
                cb[r, c] = True
        return si, so, kk, cb

    def unpack_row(self, si, so, kk, cb, row: int) -> Variables:
        cuts = tuple(int(e) for e in np.nonzero(cb[row])[0])
        return Variables(cuts, tuple(int(x) for x in si[row]),
                         tuple(int(x) for x in so[row]),
                         tuple(int(x) for x in kk[row]))

    # ------------------------------------------------------------------
    # mesh realisability over unique fold triples (memoised)
    # ------------------------------------------------------------------
    def _realizable(self, si, so, kk) -> np.ndarray:
        if self._real_table is not None:
            cap = self._val_max + 1               # sentinel lut slot (-1)
            lut = self._val_lut
            ia = lut[np.minimum(si, cap)]
            ib = lut[np.minimum(so, cap)]
            ic = lut[np.minimum(kk, cap)]
            known = (ia >= 0) & (ib >= 0) & (ic >= 0)
            return known & self._real_table[np.maximum(ia, 0),
                                            np.maximum(ib, 0),
                                            np.maximum(ic, 0)]
        enc = (si.astype(np.int64) << 40) | (so << 20) | kk
        uniq, inv = np.unique(enc, return_inverse=True)
        ok = np.empty(len(uniq), bool)
        memo = self._real_memo
        for u, e in enumerate(uniq.tolist()):
            t = (e >> 40, (e >> 20) & 0xFFFFF, e & 0xFFFFF)
            r = memo.get(t)
            if r is None:
                r = self.platform.folds_realizable(t)
                memo[t] = r
            ok[u] = r
        return ok[inv].reshape(si.shape)

    # ------------------------------------------------------------------
    # the batched array program
    # ------------------------------------------------------------------
    def evaluate_batch(self, s_in, s_out, kern, cuts) -> BatchResult:
        """Evaluate N candidates. ``s_in/s_out/kern``: int arrays [N, nodes];
        ``cuts``: bool bitmask [N, nodes-1] over chain edges."""
        si = np.asarray(s_in, np.int64)
        so = np.asarray(s_out, np.int64)
        kk = np.asarray(kern, np.int64)
        cb = np.asarray(cuts, bool)
        N, n = si.shape
        if n != self.n_nodes or so.shape != si.shape or kk.shape != si.shape \
                or cb.shape != (N, max(n - 1, 0)):
            raise ValueError(
                f"expected fold arrays [N, {self.n_nodes}] and cut mask "
                f"[N, {self.n_nodes - 1}]; got s_in {si.shape}, s_out "
                f"{so.shape}, kern {kk.shape}, cuts {cb.shape}")
        plat, opts, mode = self.platform, self.opts, self.mode
        train = mode == "train"
        decode = mode == "decode"

        sif = si.astype(np.float64)
        sof = so.astype(np.float64)
        kkf = kk.astype(np.float64)

        # ---------------- node roofline (perfmodel.node_eval) ----------
        c = sif * sof * kkf
        b_in = np.where(self.internal, 1.0, sif)
        compute_s = (self.flops / c) / (plat.peak_flops * opts.mxu_efficiency)

        w_per_chip = self.weight_bytes / sof
        act_per_chip = self.act_bytes / (b_in * kkf)
        inner_per_chip = self.inner_bytes / c

        # _state_sharding (KV sharding applies on attention-kind columns)
        state_div = kkf * sof
        state_repl = np.ones_like(sof)
        ia = self.i_attn
        if len(ia):
            kvl = self.kv_limit[ia]
            kv_div_a = np.where(kvl > 0,
                                np.minimum(sof[:, ia], kvl.astype(np.float64)),
                                sof[:, ia])
            state_div[:, ia] = kkf[:, ia] * np.maximum(kv_div_a, 1.0) \
                * sif[:, ia]
            state_repl[:, ia] = np.where((kvl > 0) & (so[:, ia] > kvl),
                                         sof[:, ia] / kv_div_a, 1.0)
        state_per_chip = self.state_bytes * state_repl / state_div

        train_mult = 3.0 if train else 1.0
        hbm_bytes = (act_per_chip + inner_per_chip) * train_mult
        if train:
            hbm_bytes = hbm_bytes + 2.0 * w_per_chip
        else:
            hbm_bytes = hbm_bytes + np.where(self.weight_stream, w_per_chip, 0.0)
            hbm_bytes = hbm_bytes + state_per_chip
        memory_s = hbm_bytes / plat.hbm_bw

        coll = self._collective_bytes(si, so, kk, sif, sof, kkf, b_in)
        collective_s = coll / plat.ici_bw * (1.0 - opts.overlap_collectives)

        # ---------------- residency (Eq. 6) ----------------------------
        if train:
            if opts.zero1:
                resident = w_per_chip * ZERO1_RESIDENT \
                    + w_per_chip * ZERO1_SHARDED / kkf
            else:
                resident = w_per_chip * TRAIN_STATE_MULT
            stash_div = sif * kkf
            if opts.seq_parallel_stash:
                stash_div = stash_div * np.maximum(sof, 1.0)
            fm = (self.batch * self.rows * self.fm_width).astype(np.float64)
            resident = resident + fm * BF16 / stash_div
            ih = self.i_head
            if len(ih):
                resident[:, ih] += 3.0 * self.inner_bytes[ih] \
                    / (b_in[:, ih] * kkf[:, ih] * np.maximum(sof[:, ih], 1.0))
        else:
            rows = np.where(decode, 1, self.rows).astype(np.float64)
            resident = w_per_chip + state_per_chip \
                + 2.0 * self.batch * rows * self.fm_width * BF16 / (b_in * kkf)

        node_time = np.maximum(np.maximum(compute_s, memory_s), collective_s)

        # ---------------- partition structure ---------------------------
        any_cut = n > 1 and bool(cb.any())
        if n > 1 and self.n_nodes > 1:
            mism = (b_in[:, :-1] != b_in[:, 1:]) | (kk[:, :-1] != kk[:, 1:])
        else:
            mism = np.zeros((N, max(n - 1, 0)), bool)

        if not any_cut:
            # fast path: every candidate is one partition — no segment
            # scatter, no reconfiguration, no boundary staging/bandwidth
            nparts = np.ones(N, np.int64)
            pid = None
            part_valid = np.zeros((N, n), bool)
            part_valid[:, 0] = True
            t_part = np.zeros((N, n))
            if self.exec_model == "streaming":
                t_part[:, 0] = node_time.max(axis=1)
            else:
                t_part[:, 0] = node_time.sum(axis=1)
            t_base = t_part
            if not self.inter_matching and n > 1:
                edge_t = np.where(mism, self.reshard_full[:-1] / plat.ici_bw,
                                  0.0)
                t_part = t_part.copy()
                t_part[:, 0] += edge_t.sum(axis=1)
            reconf = np.zeros(N)
            sum_t = t_part[:, 0]
        else:
            pid = np.zeros((N, n), np.int64)
            pid[:, 1:] = np.cumsum(cb, axis=1)
            nparts = pid[:, -1] + 1
            part_valid = np.arange(n)[None, :] < nparts[:, None]
            flat = (np.arange(N)[:, None] * n + pid)

            def seg_sum(vals: np.ndarray) -> np.ndarray:
                out = np.zeros(N * n)
                np.add.at(out, flat.ravel(), vals.ravel())
                return out.reshape(N, n)

            def seg_max(vals: np.ndarray) -> np.ndarray:
                out = np.full(N * n, -np.inf)
                np.maximum.at(out, flat.ravel(), vals.ravel())
                return out.reshape(N, n)

            if self.exec_model == "streaming":
                t_base = np.where(part_valid, seg_max(node_time), 0.0)
            else:
                t_base = seg_sum(node_time)

            t_part = t_base
            if not self.inter_matching:
                # resharding collectives at intra-partition layout changes
                edge_t = np.where(~cb & mism,
                                  self.reshard_full[:-1] / plat.ici_bw, 0.0)
                reshard = np.zeros(N * n)
                np.add.at(reshard, flat[:, :-1].ravel(), edge_t.ravel())
                t_part = t_part + reshard.reshape(N, n)
            t_part = np.where(part_valid, t_part, 0.0)

            # reconfiguration (Eq. 3): first configuration is pre-loaded
            w_part = seg_sum(w_per_chip)
            t_conf_part = plat.reconf_fixed_s + w_part / plat.dma_bw
            later = part_valid & (np.arange(n)[None, :] >= 1)
            reconf = np.where(later, t_conf_part, 0.0).sum(axis=1)

            sum_t = t_part.sum(axis=1)
        latency = sum_t + reconf
        Bam = self.batch_amortisation
        thr_time = Bam * sum_t + reconf
        throughput = np.where(thr_time > 0, Bam / np.where(thr_time > 0,
                                                           thr_time, 1.0), 0.0)
        obj = latency if self.objective == "latency" else -throughput

        # ---------------- constraints ----------------------------------
        bad = np.zeros(N, bool)
        # channel factor (Eq. 8) + cut legality + mesh realisability
        if any_cut:
            bad |= (cb & ~self.cut_allowed[None, :]).any(axis=1)
        bad |= (self.rows % si != 0).any(axis=1)
        bad |= (self.col_div % so != 0).any(axis=1)
        bad |= (self.batch % kk != 0).any(axis=1)
        if self.strict_kv:
            bad |= ((self.kv_limit > 0) & (so > self.kv_limit)).any(axis=1)
        bad |= ~self._realizable(si, so, kk).all(axis=1)
        # intra matching (Eq. 9)
        if self.intra_matching:
            bad |= (self.elementwise & (si != so)).any(axis=1)
        # inter matching (Eq. 10), partition-local
        if self.inter_matching and n > 1:
            bad |= ((~cb & mism).any(axis=1) if any_cut else mism.any(axis=1))
        # scan tying, partition-local
        if self.scan_tying and len(self.scan_pairs):
            a = self.scan_pairs[:, 0]
            b = self.scan_pairs[:, 1]
            differ = (si[:, a] != si[:, b]) | (so[:, a] != so[:, b]) \
                | (kk[:, a] != kk[:, b])
            if any_cut:
                differ &= pid[:, a] == pid[:, b]
            bad |= differ.any(axis=1)
        # resource (Eq. 6) + streaming chip budget + bandwidth (Eq. 7)
        if not any_cut:
            bad |= resident.sum(axis=1) > plat.hbm_bytes
            if self.exec_model == "streaming":
                bad |= c.sum(axis=1) > plat.chips
            # single partition: no boundary staging, bandwidth never binds
        else:
            res_part = seg_sum(resident)
            multi = nparts > 1
            start = np.zeros((N, n), bool)
            start[:, 0] = True
            start[:, 1:] = cb
            end = np.zeros((N, n), bool)
            end[:, -1] = True
            end[:, :-1] = cb
            d_io = seg_sum(self.node_d[None, :] * (start.astype(np.float64)
                                                   + end.astype(np.float64)))
            res_tot = res_part \
                + np.where(multi[:, None], d_io / plat.chips, 0.0)
            bad |= (part_valid & (res_tot > plat.hbm_bytes)).any(axis=1)
            if self.exec_model == "streaming":
                chips_part = seg_sum(c)
                bad |= (part_valid & (chips_part > plat.chips)).any(axis=1)
            # bandwidth uses the pre-resharding partition interval, exactly
            # like constraints.check_bandwidth
            bw = plat.hbm_bw * plat.chips
            bw_bad = multi[:, None] & part_valid & (t_base > 0) \
                & (d_io / np.where(t_base > 0, t_base, 1.0) > bw)
            bad |= bw_bad.any(axis=1)

        return BatchResult(
            objective=obj, feasible=~bad, latency=latency,
            throughput=throughput, part_times=t_part, nparts=nparts,
            reconf_time=reconf, node_resident=resident, node_times=node_time,
            node_collective=coll)

    # ------------------------------------------------------------------
    def _collective_bytes(self, si, so, kk, sif, sof, kkf, b_in
                          ) -> np.ndarray:
        """Vectorised perfmodel._collective_bytes."""
        mode, opts = self.mode, self.opts
        train = mode == "train"
        train_mult = 2.0 if train else 1.0
        total = np.zeros_like(sif)

        # The (s-1)/s ring fractions vanish at fold 1, so each term can be
        # added unconditionally on its column slice: adding 0.0 is exact.
        def frac(x):
            return (x - 1.0) / x

        def fm_shard(ix):
            rows = self.rows[ix] if mode != "decode" else 1
            return (self.batch[ix] * rows * self.fm_width[ix]) * BF16 \
                / (b_in[:, ix] * kkf[:, ix])

        if len(self.i_tp):
            ix = self.i_tp
            total[:, ix] += 2.0 * frac(sof[:, ix]) * fm_shard(ix) * train_mult
        if len(self.i_ep):
            ix = self.i_ep
            rows = self.rows[ix] if mode != "decode" else 1
            tokens_shard = (self.batch[ix] * rows) / (b_in[:, ix] * kkf[:, ix])
            fanout = np.maximum(self.ep_topk[ix], 1)
            total[:, ix] += (2.0 * tokens_shard * fanout * self.fm_width[ix]
                             * BF16 * frac(sof[:, ix]) * train_mult)
        if len(self.i_vocab):
            ix = self.i_vocab
            total[:, ix] += 2.0 * frac(sof[:, ix]) * fm_shard(ix) * train_mult
        if len(self.i_vhead):
            ix = self.i_vhead
            if mode == "decode":
                total[:, ix] += self.cols[ix] * BF16 * self.batch[ix] \
                    / kkf[:, ix] * frac(sof[:, ix])
            else:
                # distributed softmax stats: constant in s_out, so the scalar
                # path's s_out > 1 guard must be kept explicitly
                rows = self.rows[ix]
                vh = 2.0 * 8.0 * (self.batch[ix] * rows) \
                    / (b_in[:, ix] * kkf[:, ix])
                total[:, ix] += np.where(so[:, ix] > 1, vh, 0.0)

        # sequence/context parallelism (s_in > 1): all terms carry the
        # (s_in-1)/s_in factor, vanishing at s_in = 1
        if len(self.i_int):
            ix = self.i_int
            kvl = self.kv_limit[ix]
            kv_div = np.where(kvl > 0,
                              np.minimum(sof[:, ix], kvl.astype(np.float64)),
                              np.maximum(sof[:, ix], 1.0))
            dh = self.fm_width[ix] / np.maximum(self.cols[ix], 1)
            total[:, ix] += (self.batch[ix] / kkf[:, ix]) * self.cols[ix] \
                / np.maximum(kv_div, 1.0) * (dh + 2.0) * 4.0 \
                * frac(sif[:, ix])
        if len(self.i_kv):
            ix = self.i_kv
            kvl = self.kv_limit[ix]
            kv_div2 = np.where(kvl > 0,
                               np.minimum(sof[:, ix], kvl.astype(np.float64)),
                               np.maximum(sof[:, ix], 1.0)) * kkf[:, ix]
            total[:, ix] += self.kv_bytes[ix] / kv_div2 * frac(sif[:, ix]) \
                * train_mult
        if len(self.i_carry):
            ix = self.i_carry
            total[:, ix] += self.carry_bytes[ix] / kkf[:, ix] \
                * frac(sif[:, ix]) * train_mult

        # data-parallel gradient all-reduce (per step, ring over k)
        if train:
            grad = self.weight_bytes / sof * 2.0 * opts.grad_compression
            total += 2.0 * frac(kkf) * grad
        return total


# ----------------------------------------------------------------------
# Multi-network co-mapping mirror (docs/comapping.md)
# ----------------------------------------------------------------------

@dataclass
class CoMapBatchResult:
    """Vectorised analogue of ``objectives.CoMapEvaluation`` for N joint
    candidates under ONE split."""

    objective: np.ndarray            # [N] composite, lower is better
    feasible: np.ndarray             # [N] bool (budget mask applied)
    budget_ok: bool                  # the split's shared-budget mask bit
    per_net: List[BatchResult]       # one BatchResult per net

    def __len__(self) -> int:
        return int(self.objective.shape[0])


class CoMapBatchedEvaluator:
    """Vectorised host mirror of ``CoMapProblem.evaluate``.

    The N nets' node arrays conceptually concatenate along one node axis
    — ``seg_ids``/``offsets`` map positions to nets, which is how joint
    fold/cut vectors address the combined graph — and every net's slice
    of a joint candidate evaluates through that net's per-sub-problem
    array program. The shared chip budget enters as an explicit per-split
    constraint mask (``budget_mask``) applied INSIDE the candidate:
    a candidate on an over-budget split is infeasible no matter how good
    its per-net designs are. The composite combine is the same float64
    host arithmetic as the scalar reference (``combine_composite``), so
    per-net agreement at 1e-9 implies joint agreement at 1e-9.
    """

    def __init__(self, cp) -> None:
        self.cp = cp
        counts = [len(g.nodes) for g in cp.graphs]
        #: net index of every position on the concatenated node axis
        self.seg_ids = np.repeat(np.arange(len(counts)), counts)
        #: net i's nodes live at [offsets[i], offsets[i+1])
        self.offsets = np.concatenate(([0], np.cumsum(counts)))
        self.n_nodes = int(self.offsets[-1])
        self._bevs: Dict[Tuple[int, int], BatchedEvaluator] = {}

    def evaluator(self, split_index: int, net: int) -> BatchedEvaluator:
        """The (split, net) sub-problem's array program (memoised)."""
        key = (split_index, net)
        bev = self._bevs.get(key)
        if bev is None:
            bev = self.cp.subproblem(split_index, net).batched()
            self._bevs[key] = bev
        return bev

    def budget_mask(self) -> np.ndarray:
        """[S] bool: splits whose per-net chip allocations fit the shared
        budget. True for the whole generated menu by construction;
        user-supplied menus may carry False entries."""
        return np.array(
            [not self.cp.budget_violations(s)
             for s in range(len(self.cp.resolved_splits()))], bool)

    def split_variables(self, joint: "Variables") -> List[Variables]:
        """Slice ONE joint design (folds/cuts over the concatenated node
        axis; cut indices on the joint edge numbering) back into per-net
        ``Variables`` — the segment-id decode of a joint candidate."""
        if len(joint.s_in) != self.n_nodes:
            raise ValueError(f"joint design has {len(joint.s_in)} fold "
                             f"entries for a {self.n_nodes}-node axis")
        out = []
        for i in range(len(self.cp.graphs)):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            cuts = tuple(c - lo for c in joint.cuts
                         if lo <= c < hi - 1)
            out.append(Variables(cuts, joint.s_in[lo:hi],
                                 joint.s_out[lo:hi], joint.kern[lo:hi]))
        return out

    def join_variables(self, per_net: Sequence[Variables]) -> Variables:
        """Inverse of ``split_variables``: concatenate per-net designs
        onto the joint node axis (boundary edges between nets carry no
        cut — partitions never span nets)."""
        cuts, si, so, kk = [], [], [], []
        for i, v in enumerate(per_net):
            lo = int(self.offsets[i])
            cuts.extend(lo + c for c in v.cuts)
            si.extend(v.s_in)
            so.extend(v.s_out)
            kk.extend(v.kern)
        return Variables(tuple(cuts), tuple(si), tuple(so), tuple(kk))

    def evaluate_batch(self, split_index: int,
                       designs: Sequence[Sequence["Variables"]]
                       ) -> CoMapBatchResult:
        """Evaluate B joint candidates under one split.

        ``designs`` is a B-long sequence of N-long per-net design rows
        (use ``split_variables`` first for candidates expressed on the
        joint node axis). Returns float64 composites identical to the
        scalar reference at 1e-9.
        """
        cp = self.cp
        N = cp.n_nets
        rows = [tuple(row) for row in designs]
        if any(len(r) != N for r in rows):
            raise ValueError(f"every design row must carry {N} per-net "
                             f"designs")
        budget_ok = not cp.budget_violations(split_index)
        per_net: List[BatchResult] = []
        for i in range(N):
            bev = self.evaluator(split_index, i)
            res = bev.evaluate_batch(*bev.pack([r[i] for r in rows]))
            cp.subproblem(split_index, i).note_batch_evals(len(res))
            per_net.append(res)
        B = len(rows)
        weights = cp.net_weights
        feas = np.full(B, budget_ok, bool)
        for res in per_net:
            feas &= res.feasible.astype(bool)
        if cp.objective == "worst_latency":
            comp = np.max(np.stack([r.latency for r in per_net]), axis=0)
        else:
            thr = np.stack([w * r.throughput
                            for w, r in zip(weights, per_net)])
            comp = (-np.min(thr, axis=0)
                    if cp.objective == "maxmin_throughput"
                    else -np.sum(thr, axis=0))
        return CoMapBatchResult(objective=comp.astype(np.float64),
                                feasible=feas, budget_ok=budget_ok,
                                per_net=per_net)
