"""On-device candidate construction of the three optimisers (the port of
``repro.core.accel.search_loops``): brute-force chunks, multi-chain SA and
the rule-based greedy descent.

  brute force   a mixed-radix digit decode. The host reduces the (possibly
                > 2^63-point) global enumeration index to one small
                descriptor per decision slot per chunk; the device expands
                it to per-candidate digits, gathers the precomputed
                construction tables and evaluates the chunk. The
                enumeration order is the numpy/scalar engines', so the
                optimum and the improvement history are theirs. The host
                reads back one chunk's objectives at a time.

  annealing     a multi-chain sweep loop on the device: each sweep proposes
                one move per chain (cut add/remove/move or a joint
                fold-triple redraw scattered over the backend's tying
                scope), repairs it (strict-KV clamp and one propagate
                pass), evaluates all chains in one batch, applies the
                Eq. 11 Metropolis rule per chain on a geometric temperature
                ladder and tracks per-chain incumbents. A sweep takes its
                random draws as an input (``SweepDraws``); ``DeviceSA.run``
                draws them from one ``torch.Generator`` on the engine's
                device in a fixed order, never from the global generator,
                and no sweep waits on the host. ``run`` returns its
                traces on the device; the optimiser reads them back once a
                call. Every draw is shaped by the chain count.

  rule based    each greedy step on the device: evaluate the incumbent,
                pick the slowest unblocked partition node, expand its joint
                fold menu (s_in-major — the scalar probe order) through the
                scoped scatter + one propagate pass, evaluate all probes
                WITH the incumbent in the same batch, and apply the
                feasible strictly-improving probe with the smallest
                lexicographic (collective, residency) resource delta. The
                chosen move sequence is the scalar reference's. Algorithm
                2's outer merge loop stays on the host
                (``optimizers/rule_based._algorithm2``). The JAX package
                runs a whole descent as one ``lax.while_loop``; here the
                loop is a host loop that reads the loop condition once per
                step. Removing those round-trips is ROADMAP Queue 4,
                item 8.

Lanes: every device body takes ``DeviceTensors``, tables and states with a
leading problem ("lane") axis, so a fleet bucket (``fleet.py``) runs as one
pass of each body, with one segred launch a step, sweep or chunk whatever
the number of lanes. A single problem is the P = 1 case: its engine calls
the same bodies with a lane axis of 1, and a body given one problem's
tensors without a lane axis adds it and takes it off again. What JAX gets
from ``jax.vmap`` is written out here; there is one copy of each body.

Every "first index of" selection (``jnp.argmax`` on bools, ``argmax`` /
``argmin`` on values with ties) is written as the minimum index where a
mask holds (``_first_true``), so it does not depend on how a backend
breaks ties. Integer ``//`` and ``%`` floor, as ``jnp``'s do.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accel.eval_torch import (
    TorchEvaluator,
    _eval_core,
    _nd,
    _take,
    _tree_sum,
    lifted,
)
from repro_torch.core.accel.lowering import DeviceTensors, StaticSpec
from repro_torch.core.hdgraph import Variables
from repro_torch.core.optimizers.common import OptimResult
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

VARS = ("s_in", "s_out", "kern")
_DIMS = {"s_in": "rows", "s_out": "col_div", "kern": "batch"}


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim``, 0 where there is none —
    ``jnp.argmax`` of a bool array."""
    size = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = size
    iota = torch.arange(size, dtype=torch.int64,
                        device=mask.device).view(shape)
    first = torch.where(mask, iota, size).amin(dim=dim)
    return torch.where(first == size, 0, first)


def _pid(cb: torch.Tensor, idt: torch.dtype) -> torch.Tensor:
    """[..., n-1] cut bitmask -> [..., n] monotone partition ids."""
    return torch.cat([torch.zeros(cb.shape[:-1] + (1,), dtype=idt,
                                  device=cb.device),
                      torch.cumsum(cb.to(idt), dim=-1)], dim=-1)


# ----------------------------------------------------------------------
# dynamic-cut constraint propagation (Backend.propagate on device)
# ----------------------------------------------------------------------

def propagate_torch(static: StaticSpec, A: DeviceTensors, si, so, kk, cb,
                    single_partition: bool = False):
    """Port of ``Backend.propagate`` for per-candidate cut bitmasks:
    [P, C, n] folds and [P, C, n-1] cuts over lane-stacked ``A`` (one
    problem's [C, n] is the P = 1 case).

    Anchors (scan-group first member, partition first node, partition first
    non-internal node) are gathered from the pre-mutation tensors, matching
    the host's copy-then-assign order. ``single_partition`` promises cb is
    all-False, collapsing the partition ids to a constant.
    """
    if si.dim() == 2:
        out = propagate_torch(static, lifted(A), si[None], so[None],
                              kk[None], cb[None], single_partition)
        return tuple(x[0] for x in out)
    n = static.n_nodes
    P, C = si.shape[:2]
    idt = A.batch.dtype
    dev = A.batch.device
    one = torch.ones((), dtype=idt, device=dev)
    iota = torch.arange(n, dtype=idt, device=dev)
    if not single_partition:
        pid = _pid(cb, idt)

    if static.scan_tying:
        # harmonise scan-group folds within each partition: for member a the
        # anchor is the first member b with pid[b] == pid[a] (pid is
        # monotone and members ascend, so that b is the group's first
        # member in a's partition). Non-members anchor to themselves.
        sg = A.scan_group
        grp = (sg[:, :, None] == sg[:, None, :]) \
            & (sg[:, :, None] >= 0)                            # [P, n, n]
        if single_partition:
            ok = grp[:, None].expand(P, C, n, n)
        else:
            ok = grp[:, None] & (pid[..., :, None] == pid[..., None, :])
        anchor = _first_true(ok, dim=-1)
        anchor = torch.where(_nd(sg) >= 0, anchor, iota.expand(P, C, n))
        si = torch.gather(si, 2, anchor)
        so = torch.gather(so, 2, anchor)
        kk = torch.gather(kk, 2, anchor)

    if static.intra_matching:
        so = torch.where(_nd(A.elementwise), si, so)

    if static.inter_matching:
        if single_partition:
            anchor_k = kk[..., :1]
            # partition's first non-internal node (padded columns are
            # non-internal with fold 1, so an all-internal real graph
            # anchors at fold 1 either way — the host's fallback value)
            f1 = torch.where(A.internal, n, iota)
            f1_min = f1.amin(dim=-1, keepdim=True)
            ni = _first_true(f1 == f1_min)
            anchor_si = torch.where(
                (f1_min < n)[:, :, None],
                torch.gather(si, 2, ni[:, None, None].expand(P, C, 1)), one)
        else:
            is_start = torch.cat(
                [torch.ones((P, C, 1), dtype=torch.bool, device=dev), cb],
                dim=-1)
            start_idx = torch.cummax(
                torch.where(is_start, iota, 0), dim=-1).values
            anchor_k = torch.gather(kk, 2, start_idx)
            # first non-internal node of each partition (may be after j):
            # dense per-partition min of (j | internal -> n), gathered back
            f = _nd(torch.where(A.internal, n, iota)).expand(P, C, n)
            onehot = pid[..., :, None] == iota
            segmin = torch.where(onehot, f[..., :, None], n).amin(dim=-2)
            anchor_ni = torch.gather(segmin, 2, pid)
            anchor_si = torch.where(
                anchor_ni < n,
                torch.gather(si, 2, anchor_ni.clamp(max=n - 1)),
                one)
        kk = torch.where(_nd(A.batch) % anchor_k == 0, anchor_k, one)
        si_new = torch.where(_nd(A.rows) % anchor_si == 0, anchor_si, one)
        si = torch.where(_nd(A.internal), si, si_new)
        if static.intra_matching:
            so = torch.where(_nd(A.elementwise), si, so)
    return si, so, kk


def _scope_mask(g: str, same_part, scan_groups, sg_i, oh_i):
    """``Backend.scope`` as a node mask for one granularity: which nodes
    share a variable with the chosen node — the whole partition
    (``global``), the node's scan group within the partition (``group``,
    falling back to the node itself when it has no group), or the node
    alone. Shape-generic (operands [n] or broadcast [C, n]); shared by the
    scatter and the rule-based unblock step so the two cannot drift."""
    if g == "global":
        return same_part
    if g == "group":
        return torch.where(sg_i >= 0, same_part & (scan_groups == sg_i),
                           oh_i)
    return oh_i


def _scatter_triple(static: StaticSpec, gran: Tuple[str, str, str],
                    A: DeviceTensors, clamp, si, so, kk, cb, i, v3):
    """``Backend.set_fold`` of a joint fold triple, batched on device.

    Scatters the (per-node clamped) values of ``v3`` [P, 3, C] over node
    ``i`` [P, C]'s tying scope in each of the C rows of each lane — global
    granularity writes the whole partition, group granularity the node's
    scan group within the partition, node granularity the node itself;
    globally-tied s_in skips decode split-KV (internal-rows) nodes exactly
    like the host — then ONE ``propagate_torch`` pass restores the
    backend's matching and tying invariants. One problem's [C, n] folds,
    [3, C] values and [C] nodes are the P = 1 case.
    """
    if si.dim() == 2:
        out = _scatter_triple(static, gran, lifted(A), clamp[None],
                              si[None], so[None], kk[None], cb[None],
                              i[None], v3[None])
        return tuple(x[0] for x in out)
    n = static.n_nodes
    idt = A.batch.dtype
    iota_n = torch.arange(n, dtype=idt, device=A.batch.device)
    pid = _pid(cb, idt)
    pid_i = torch.gather(pid, 2, i[..., None])
    same_part = pid == pid_i
    sg_i = torch.gather(A.scan_group, 1, i)
    oh_i = iota_n == i[..., None]
    fold = {"s_in": si, "s_out": so, "kern": kk}
    for vi, var in enumerate(VARS):
        g = gran[vi]
        m = _scope_mask(g, same_part, _nd(A.scan_group), sg_i[..., None],
                        oh_i)
        if var == "s_in" and g == "global":
            m = m & ~_nd(A.internal)         # decode split-KV keeps s_I
        clamped = _take(clamp, vi, iota_n[None, None, :],
                        v3[:, vi, :, None])
        fold[var] = torch.where(m, clamped, fold[var])
    return propagate_torch(static, A, fold["s_in"], fold["s_out"],
                           fold["kern"], cb)


def repair_torch(static: StaticSpec, A: DeviceTensors, kv_fix, si, so, kk,
                 cb):
    """On-device feasibility repair: one masked clamp-and-propagate step.

    Strict-KV backends can propose s_out values that a tying-scope scatter
    clamped legally for the drawn node but that exceed another node's KV
    head limit (Eq. 8 side constraint). The violating columns clamp to
    ``kv_fix`` (the node's largest menu value <= its KV limit, computed by
    the host) and ONE ``propagate_torch`` pass restores the backend's
    tying/matching invariants — tied scopes share kind and KV limit, so
    every member of a violating scope clamps to the same value. The SA
    sweep never leaves the device to repair a move. [P, C, n] folds and
    [P, n] ``kv_fix``, or one problem's [C, n] and [n].
    """
    if not static.strict_kv:
        return si, so, kk
    if si.dim() == 2:
        out = repair_torch(static, lifted(A), kv_fix[None], si[None],
                           so[None], kk[None], cb[None])
        return tuple(x[0] for x in out)
    kvl = _nd(A.kv_limit)
    viol = (kvl > 0) & (so > kvl)
    so = torch.where(viol, _nd(kv_fix).to(so.dtype), so)
    return propagate_torch(static, A, si, so, kk, cb)


# ----------------------------------------------------------------------
# brute force: mixed-radix decode + evaluate, one device program per chunk
# (the numpy helpers are copied from the JAX package)
# ----------------------------------------------------------------------

def _construction_tables(graph, backend, slots, scopes, tabs_py, menus,
                         cuts, base, max_menu, idt):
    """Fold the scatter + ``Backend.propagate`` composition for one fixed
    cut set into per-(var, node) value tables.

    After ``set_fold``'s scatter, propagation rewrites every node from a
    single source: scan tying copies the group's first member in the
    node's partition; inter matching reads the partition's first node
    (kern) / first non-internal node (s_in); intra copies s_in into s_out
    on elementwise nodes. Each source is one node whose scattered value is
    a function of exactly ONE slot's digit — so the final value at
    (var, j) is ``T[var][j][digit of slot sigma[var][j]]``, with a
    sentinel slot index S whose digit is always 0 for constants. The
    device construction then needs one gather per variable and no
    propagation at all.
    """
    n = len(graph.nodes)
    S = len(slots)
    base_vals = {"s_in": base.s_in, "s_out": base.s_out, "kern": base.kern}
    sigma0 = {var: np.full(n, -1, np.int64) for var in VARS}
    for s, (_, var) in enumerate(slots):
        for j in scopes[s]:
            sigma0[var][j] = s

    def value0(var, m):
        """(slot or -1, value-over-digit array) as scattered at node m."""
        s = int(sigma0[var][m])
        if s < 0:
            return -1, np.full(max_menu, base_vals[var][m], np.int64)
        tab = tabs_py[s][m]                 # clamped menu values at node m
        out = np.full(max_menu, tab[-1], np.int64)   # padding never hit
        out[:len(tab)] = tab
        return s, out

    bounds = [0] + [c + 1 for c in sorted(cuts)] + [n]
    part_start = np.zeros(n, np.int64)
    part_ni = np.full(n, -1, np.int64)      # first non-internal in partition
    anchor = np.arange(n)                   # scan-tying source node
    for b in range(len(bounds) - 1):
        first = {}
        ni = -1
        for j in range(bounds[b], bounds[b + 1]):
            if ni < 0 and not graph.nodes[j].internal_rows:
                ni = j
        for j in range(bounds[b], bounds[b + 1]):
            part_start[j] = bounds[b]
            part_ni[j] = ni
            g = graph.nodes[j].scan_group
            if backend.scan_tying and g >= 0:
                if g not in first:
                    first[g] = j
                anchor[j] = first[g]

    sigma = np.full((3, n), S, idt)
    T = np.ones((3, n, max_menu), idt)

    def assign(vi, j, src_slot, vals):
        if src_slot < 0:
            T[vi, j, :] = vals[0]           # constant: sentinel digit 0
        else:
            sigma[vi, j] = src_slot
            T[vi, j, :] = vals

    for j in range(n):
        node = graph.nodes[j]
        # ---- kern: inter anchors at the partition's first node ----------
        if backend.inter_matching:
            src = int(anchor[part_start[j]])
            s_src, vals = value0("kern", src)
            vals = np.where(node.batch % np.maximum(vals, 1) == 0, vals, 1)
        else:
            src = int(anchor[j])
            s_src, vals = value0("kern", src)
        assign(2, j, s_src, vals)
        # ---- s_in: inter anchors at the first non-internal node ---------
        if backend.inter_matching and not node.internal_rows:
            ni = int(part_ni[j])
            if ni < 0:
                s_src, vals = -1, np.ones(max_menu, np.int64)
            else:
                s_src, vals = value0("s_in", int(anchor[ni]))
            vals = np.where(node.rows % np.maximum(vals, 1) == 0, vals, 1)
        else:
            s_src, vals = value0("s_in", int(anchor[j]))
        assign(0, j, s_src, vals)
        si_slot, si_vals = (sigma[0, j], T[0, j].copy())
        # ---- s_out: intra copies the final s_in on elementwise nodes ----
        if backend.intra_matching and node.elementwise:
            sigma[1, j] = si_slot
            T[1, j, :] = si_vals
        else:
            s_src, vals = value0("s_out", int(anchor[j]))
            assign(1, j, s_src, vals)
    return sigma, T


def chunk_descriptor(strides, sizes, produced: int, take: int,
                     s_pad: int, idt) -> np.ndarray:
    """Host-side mixed-radix descriptor for one enumeration chunk.

    One row per decision slot, padded to ``s_pad`` rows (padded rows
    decode to digit 0 — see ``_bf_decode_digits``). Shared by the
    per-problem engine and the fleet so the subtle slow-slot carry term
    can never drift between them (their bit-identity depends on it).
    """
    desc = np.zeros((s_pad, 4), idt)
    desc[:, 0] = 1
    desc[:, 2] = 1
    desc[:, 3] = 1
    for s in range(len(sizes)):
        stride, size = strides[s], sizes[s]
        if stride >= take:
            # slow slot: at most one digit boundary inside the chunk
            q, r = divmod(produced, stride)
            desc[s] = (0, q % size, min(stride - r, take + 1), size)
        else:
            # fast slot: the digit is periodic with period stride*size
            # (small, since stride < take <= chunk)
            desc[s] = (1, produced % (stride * size), stride, size)
    return desc


def absorb_improvements(objs: np.ndarray, best_obj: float, points: int,
                        history: List[Tuple[int, float]]):
    """Exact scalar-engine history bookkeeping for one evaluated chunk:
    record every strict improvement over the running best, in enumeration
    order. Returns (row of the last improvement or None, new best).
    Shared by the per-problem engine and the fleet."""
    prefix = np.minimum.accumulate(
        np.concatenate(([best_obj], objs)))[:-1]
    imp = np.nonzero(objs < prefix)[0]
    for r in imp:
        history.append((points + int(r) + 1, float(objs[r])))
    if len(imp):
        return int(imp[-1]), float(objs[imp[-1]])
    return None, best_obj


def _bf_decode_digits(B: int, idt, desc, start: int = 0):
    """Per-slot digits of a chunk, [..., B, S+1] from [..., S, 4]
    descriptors (last column: the sentinel slot, always digit 0).

    ``desc[s] = (kind, a, b, size)``: for a slow slot (stride >= chunk) the
    digit is ``(a + (off >= b)) % size`` (one carry inside the chunk, at
    offset ``b``); for a fast slot it is ``((a + off) // b) % size``. The
    host reduced the global index modulo stride/period BEFORE building the
    descriptor, so everything here is small even for > 2^63 spaces.

    ``start`` offsets the chunk-local rows: shard d of a sharded chunk
    decodes rows ``[start, start + B)`` of the SAME descriptor, so D
    shards reproduce the unsharded digits exactly.
    """
    off = start + torch.arange(B, dtype=idt, device=desc.device)[:, None]
    row = lambda k: desc[..., k].unsqueeze(-2)                  # [..., 1, S]
    kind, a, b, size = row(0), row(1), row(2), row(3)
    digit_slow = torch.remainder(a + (off >= b).to(idt), size)
    digit_fast = torch.remainder(
        torch.div(a + off, b.clamp(min=1), rounding_mode="floor"), size)
    digits = torch.where(kind == 1, digit_fast, digit_slow)   # [..., B, S]
    return torch.cat([digits, torch.zeros(digits.shape[:-1] + (1,),
                                          dtype=idt, device=desc.device)],
                     dim=-1)


def _bf_eval_part(static: StaticSpec, B: int, no_cut: bool,
                  A: DeviceTensors, si, so, kk, cb_row, take,
                  max_parts: Optional[int] = None, start: int = 0):
    """Evaluate one decoded chunk of each lane ([P, B, n] folds, [P, n-1]
    cut rows, ``take`` an int or [P]): [P, B] objectives (inf where
    infeasible or past the lane's ``take``) and each lane's fold rows of
    its first minimum (an all-inf chunk gives row 0, which the host
    ignores: nothing improved). One problem's [B, n] is the P = 1 case.
    ``max_parts`` bounds the partitions of the chunk (``_eval_core``);
    ``start`` is the rows' offset in a sharded chunk, so that the
    ``off < take`` mask stays chunk-global."""
    if si.dim() == 2:
        out = _bf_eval_part(static, B, no_cut, lifted(A), si[None],
                            so[None], kk[None], cb_row[None], take,
                            max_parts, start)
        return tuple(x[0] for x in out)
    n = static.n_nodes
    P = si.shape[0]
    off = start + torch.arange(B, dtype=A.batch.dtype,
                               device=A.batch.device)
    cb = cb_row[:, None, :].expand(P, B, max(n - 1, 0))
    res = _eval_core(static, A, si, so, kk, cb, single_partition=no_cut,
                     max_parts=max_parts)
    lim = take if isinstance(take, int) else take[:, None]
    objs = torch.where(res["feasible"] & (off < lim), res["objective"],
                       torch.inf).expand(P, B)
    r = _first_true(objs == objs.amin(dim=-1, keepdim=True))
    lanes = torch.arange(P, device=si.device)
    return objs, si[lanes, r], so[lanes, r], kk[lanes, r]


def _bf_chunk_core(static: StaticSpec, B: int, no_cut: bool,
                   A: DeviceTensors, desc, sigma, T, cb_row, take,
                   max_parts: Optional[int] = None, start: int = 0):
    """Decode + evaluate one enumeration chunk of B candidates of each lane
    on device: [P, S, 4] descriptors, [P, 3, n] slot tables ``sigma``,
    [P, 3, n, mm] value tables ``T`` (one problem's, without the lane
    axis, is the P = 1 case). ``start`` makes it rows
    ``[start, start + B)`` of the chunk (one shard of a sharded chunk).

    Construction is three gathers through the precomputed propagation
    tables (see ``_construction_tables``); no on-device propagation.
    """
    if desc.dim() == 2:
        out = _bf_chunk_core(static, B, no_cut, lifted(A), desc[None],
                             sigma[None], T[None], cb_row[None], take,
                             max_parts, start)
        return tuple(x[0] for x in out)
    n = static.n_nodes
    P = desc.shape[0]
    digits = _bf_decode_digits(B, A.batch.dtype, desc,
                               start).transpose(1, 2)
    S1 = digits.shape[1]                                  # [P, S+1, B]
    dig = torch.gather(digits[:, None].expand(P, 3, S1, B), 2,
                       sigma[..., None].expand(P, 3, n, B))
    val = torch.gather(T, 3, dig)                         # [P, 3, n, B]
    si, so, kk = (val[:, v].transpose(1, 2).contiguous() for v in range(3))
    return _bf_eval_part(static, B, no_cut, A, si, so, kk, cb_row, take,
                         max_parts, start)


def _bf_chunk_shards(static: StaticSpec, B: int, no_cut: bool, shards,
                     desc, take, max_parts: Optional[int]) -> list:
    """One chunk of one problem split over D shards (the port of the JAX
    package's ``_bf_shard_chunk``): shard d decodes and evaluates rows
    ``[d B/D, (d+1) B/D)`` of the same descriptor on its device
    (``shards[d] = (device, (A, sigma, T, cb_row))``, lanes of 1). Every
    shard is launched before anything is read back; returns each shard's
    ``_bf_chunk_core`` output, for ``_bf_shard_combine``."""
    Bl = B // len(shards)
    return [_bf_chunk_core(static, Bl, no_cut, A, desc.to(dev), sigma, T,
                           cb_row, take, max_parts, start=d * Bl)
            for d, (dev, (A, sigma, T, cb_row)) in enumerate(shards)]


def _bf_shard_combine(outs: list):
    """The chunk's [B] objectives on the host (one readback) and the
    winning shard's fold rows of its first minimum.

    The combine is JAX's ``pmin`` and masked ``psum``: the first shard
    whose minimum is the chunk's minimum wins. Shard order is enumeration
    order and each shard's pick is its first minimum, so the winner's row
    is the chunk's first minimum; an all-inf chunk gives shard 0's row 0,
    as the unsharded chunk gives its row 0. A shard wholly past ``take``
    holds only inf and cannot win a tie."""
    home = outs[0][0].device
    objs = torch.cat([o[0].to(home) for o in outs], dim=-1)[0].cpu().numpy()
    local = objs.reshape(len(outs), -1).min(axis=1)
    win = int(np.argmax(local == local.min()))
    return objs, outs[win][1:]


@torch.no_grad()
def brute_force_torch(problem, include_cuts: bool, max_cuts: int,
                      max_points: Optional[int],
                      time_budget_s: Optional[float], batch_size: int,
                      device=None, dtype=None,
                      devices: Optional[int] = None) -> OptimResult:
    """The torch engine behind ``optimizers.brute_force(engine="torch")``.

    Same enumeration order (hence the same optimum and history) as the
    numpy engine; candidate construction and evaluation run on ``device``
    (default: the card) in ``dtype`` (default float32). Each cut set is
    enumerated in chunks of
    ``B = min(batch_size, pow2ceil(points per cut set))`` rows. The empty
    cut set is evaluated as one partition, which needs no segmented
    reduction; a cut set with a cut takes the segred kernel.

    ``devices=D`` splits each chunk's row axis over the D shards of
    ``runtime.device_mesh(D, device)`` (``_bf_chunk_shards``), with ``B``
    rounded up to a multiple of D; the history is chunking-invariant, so
    the results are bitwise those of ``devices=None`` for any D.
    """
    from repro_torch.core.optimizers.brute_force import (
        _clamp_tables,
        _cut_sets,
        _slot_scopes,
    )

    graph, backend = problem.graph, problem.backend
    slots, menus = backend.space(graph, problem.platform)
    sizes = [len(m) for m in menus]
    strides = [1] * len(slots)                    # itertools.product order:
    for s in range(len(slots) - 2, -1, -1):       # last slot varies fastest
        strides[s] = strides[s + 1] * sizes[s + 1]
    total = 1
    for s in sizes:
        total *= s
    max_menu = max(sizes, default=1)
    n = len(graph.nodes)

    mesh = None
    if devices is not None:
        from repro_torch.runtime import device_mesh
        mesh = device_mesh(devices, device)
        device = mesh[0]
    tev = TorchEvaluator.from_problem(problem, device=device, dtype=dtype)
    static, A = tev.static, lifted(tev.arrays)
    dev = tev.device
    idt = np.int64                                # A's integers are int64
    B = min(batch_size, _pow2ceil(total))
    if mesh is not None:
        D = len(mesh)
        B = -(-B // D) * D        # D | B (chunk boundaries may move; the
        #                           history is chunking-invariant)
    t = lambda a: torch.from_numpy(a).to(dev)

    base = backend.initial(graph).with_cuts(())

    best_v: Optional[Variables] = None
    best_obj = np.inf
    points = 0
    history: List[Tuple[int, float]] = []
    stop = False

    with _trace.span("optim.brute_force.torch", total=total,
                     batch=B) as run_sp:
        for cuts in _cut_sets(graph.cut_edges, include_cuts, max_cuts):
            if stop:
                break
            scopes = _slot_scopes(backend, graph, slots, cuts)
            tabs_py = _clamp_tables(graph, slots, scopes, menus)
            sigma, T = _construction_tables(graph, backend, slots, scopes,
                                            tabs_py, menus, cuts, base,
                                            max_menu, idt)
            sigma_d, T_d = t(sigma)[None], t(T)[None]
            cb_row = np.zeros(max(n - 1, 0), bool)
            for c in cuts:
                cb_row[c] = True
            cb_row_d = t(cb_row)[None]
            if mesh is not None:    # (``.to`` its own device is a no-op)
                shards = [(d, (DeviceTensors(*(x.to(d) for x in A)),
                               sigma_d.to(d), T_d.to(d), cb_row_d.to(d)))
                          for d in mesh]

            produced = 0
            while produced < total:
                take = min(B, total - produced)
                if max_points is not None:
                    take = min(take, max_points - points)
                if take <= 0:
                    stop = True
                    break
                desc = chunk_descriptor(strides, sizes, produced, take,
                                        len(slots), idt)
                if mesh is None:
                    with _metrics.device_dispatch("bf_chunk", take=take):
                        objs, bi_si, bi_so, bi_kk = _bf_chunk_core(
                            static, B, not cuts, A, t(desc)[None], sigma_d,
                            T_d, cb_row_d, take, len(cuts) + 1)
                    # the chunk's one blocking readback
                    with _trace.span("accel.d2h.bf_chunk", take=take):
                        objs = objs[0, :take].cpu().numpy().astype(
                            np.float64)
                else:
                    with _metrics.device_dispatch("bf_chunk_shard",
                                                  take=take, devices=D):
                        outs = _bf_chunk_shards(static, B, not cuts, shards,
                                                t(desc)[None], take,
                                                len(cuts) + 1)
                    with _trace.span("accel.d2h.bf_chunk", take=take):
                        objs, (bi_si, bi_so, bi_kk) = \
                            _bf_shard_combine(outs)
                        objs = objs[:take].astype(np.float64)
                if _trace.enabled():
                    _metrics.histogram("accel.bf.feasible_fraction").observe(
                        float(np.isfinite(objs).mean()) if take else 0.0)
                problem.note_batch_evals(take)
                last_imp, best_obj = absorb_improvements(objs, best_obj,
                                                         points, history)
                if last_imp is not None:
                    best_v = Variables(
                        tuple(int(e) for e in np.nonzero(cb_row)[0]),
                        tuple(int(x) for x in bi_si[0].tolist()),
                        tuple(int(x) for x in bi_so[0].tolist()),
                        tuple(int(x) for x in bi_kk[0].tolist()))
                points += take
                produced += take
                if max_points is not None and points >= max_points:
                    stop = True
                    break
                if time_budget_s is not None and \
                        run_sp.elapsed_s() > time_budget_s:
                    stop = True
                    break

    elapsed = run_sp.elapsed_s()
    if best_v is None:                         # no feasible point found
        best_v = backend.initial(graph)
    best_eval = problem.evaluate(best_v)
    return OptimResult(best_v, best_eval, points, elapsed, history,
                       name="brute_force")


# ----------------------------------------------------------------------
# host move tables (numpy; copied from the JAX package)
# ----------------------------------------------------------------------

def build_sa_tables(problem, *, pad_nodes: Optional[int] = None,
                    pad_menu: Optional[int] = None,
                    pad_val: Optional[int] = None):
    """Host-precomputed move tables for the device SA sweep.

    Returns numpy arrays (menus [3, n, mm], menu_sizes [3, n], clamp
    [3, n, max_val+1], kv_fix [n]) plus the backend's granularity triple
    and cut-edge flag. ``pad_nodes``/``pad_menu`` pad the node / menu axes
    with neutral single-value menus so fleet buckets can stack problems of
    different sizes (padded nodes are never drawn: the sweep bounds its
    node draw by ``DeviceArrays.n_valid``). ``pad_val`` extends the clamp
    table's value axis to a larger platform's maximum fold value — the
    divisor walk-down is pure node arithmetic, so the extra entries are
    exact (and unreachable: this problem's menus never draw them), which
    lets heterogeneous-platform buckets stack their clamp tables.
    """
    graph, backend, platform = \
        problem.graph, problem.backend, problem.platform
    n = len(graph.nodes)
    n_pad = n if pad_nodes is None else int(pad_nodes)

    max_val = max(platform.fold_values())
    if pad_val is not None:
        if pad_val < max_val:
            raise ValueError(f"pad_val={pad_val} < max fold value {max_val}")
        max_val = int(pad_val)
    menu_lists = {}
    max_menu = 1
    for vi, var in enumerate(VARS):
        for j in range(n):
            cands = backend.candidates(graph, j, var, platform)
            menu_lists[(vi, j)] = cands
            max_menu = max(max_menu, len(cands))
    if pad_menu is not None:
        if pad_menu < max_menu:
            raise ValueError(f"pad_menu={pad_menu} < menu size {max_menu}")
        max_menu = int(pad_menu)
    menus = np.ones((3, n_pad, max_menu), np.int64)
    menu_sizes = np.ones((3, n_pad), np.int64)
    for (vi, j), cands in menu_lists.items():
        menus[vi, j, :len(cands)] = cands
        menu_sizes[vi, j] = len(cands)
    # clamp[var, node, v] = set_fold's divisor walk-down of value v
    clamp = np.ones((3, n_pad, max_val + 1), np.int64)
    for vi, var in enumerate(VARS):
        for j in range(n):
            dim = getattr(graph.nodes[j], _DIMS[var])
            for v in range(max_val + 1):
                val = v
                while val > 1 and dim % val != 0:
                    val -= 1
                clamp[vi, j, v] = val
    # kv_fix[j]: largest s_out menu value within the node's KV limit — the
    # on-device repair target for strict-KV violations (see repair_jax)
    kv_fix = np.ones(n_pad, np.int64)
    for j in range(n):
        kvl = graph.nodes[j].kv_limit
        if kvl > 0:
            legal = [c for c in menu_lists[(1, j)] if c <= kvl]
            kv_fix[j] = max(legal) if legal else 1
    gran = tuple(backend.granularity[var] for var in VARS)
    return menus, menu_sizes, clamp, kv_fix, gran, \
        bool(len(graph.cut_edges) > 0)


def _pad_row(values, n: int) -> np.ndarray:
    """A design's per-node folds padded to ``n`` nodes with fold 1."""
    a = np.asarray(values, np.int64)
    return np.pad(a, (0, n - len(a)), constant_values=1)


# ----------------------------------------------------------------------
# multi-chain simulated annealing: a device loop of sweeps
# ----------------------------------------------------------------------

class SweepDraws(NamedTuple):
    """The random inputs of one SA sweep, each shaped by the chain count C
    (the seven draws of the JAX sweep's ``jax.random.split(key, 8)``):
    the cut-move type ``r2``, the masked-choice uniforms of the removed and
    the added cut, the drawn node ``i`` in ``[0, n_valid)``, the fold-menu
    draws ``fold`` [8, 3, C] in ``[0, 2^30)``, the move type ``r_type``
    and the Metropolis uniform ``u``. Uniforms are in the working float
    dtype, integers int64. A fleet sweep takes them with a leading lane
    axis ([P, C], ``fold`` [P, 8, 3, C])."""
    r2: torch.Tensor
    u_rem: torch.Tensor
    u_add: torch.Tensor
    i: torch.Tensor
    fold: torch.Tensor
    r_type: torch.Tensor
    u: torch.Tensor


def sa_draws(gen: torch.Generator, chains: int, n_valid: int,
             dtype: torch.dtype) -> SweepDraws:
    """One sweep's draws from ``gen``, on its device, always in the order
    of ``SweepDraws`` and all seven of them (a problem without cut edges
    consumes the same stream)."""
    dev = gen.device
    uni = lambda: torch.rand(chains, generator=gen, dtype=dtype, device=dev)
    r2, u_rem, u_add = uni(), uni(), uni()
    i = torch.randint(0, n_valid, (chains,), generator=gen, device=dev)
    fold = torch.randint(0, 1 << 30, (8, 3, chains), generator=gen,
                         device=dev)
    return SweepDraws(r2, u_rem, u_add, i, fold, uni(), uni())


def _lane_draws(draws: Sequence[SweepDraws]) -> SweepDraws:
    """Per-lane draws stacked on a leading lane axis."""
    if len(draws) == 1:
        return SweepDraws(*(x[None] for x in draws[0]))
    return SweepDraws(*(torch.stack(xs) for xs in zip(*draws)))


class DeviceSA:
    """Device-resident multi-chain SA: move tables + the sweep loop.

    One instance per Problem; ``run`` advances a chain-state dict by
    ``n_sweeps`` sweeps and is resumable (the host can interleave calls
    with wall-clock budget checks). Incumbents are tracked per chain on
    device and read back with ``best_variables``. ``device`` defaults to
    the card; ``dtype`` to float32. Padding (``pad_nodes``/``pad_menu``/
    ...) and ``tables`` follow the fleet stacking contract
    (``fleet.fleet_annealing``); padded nodes are never drawn.
    """

    def __init__(self, problem, *, device=None, dtype=None,
                 pad_nodes: Optional[int] = None,
                 pad_menu: Optional[int] = None,
                 pad_pairs: Optional[int] = None,
                 pad_vals: Optional[int] = None,
                 pad_lut: Optional[int] = None, tables=None):
        self.problem = problem
        self.tev = TorchEvaluator.from_problem(
            problem, device=device, dtype=dtype, pad_nodes=pad_nodes,
            pad_pairs=pad_pairs, pad_vals=pad_vals, pad_lut=pad_lut)
        self.static, self.A = self.tev.static, self.tev.arrays
        self.device = self.tev.device
        self.n_real = len(problem.graph.nodes)
        if tables is None:
            tables = build_sa_tables(problem, pad_nodes=self.static.n_nodes,
                                     pad_menu=pad_menu)
        menus, menu_sizes, clamp, kv_fix, gran, has_cuts = tables
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                      device=self.device)
        self.menus = t(menus)
        self.menu_sizes = t(menu_sizes)
        self.clamp = t(clamp)
        self.kv_fix = t(kv_fix)
        self.gran = gran
        self.has_cut_edges = has_cuts
        #: no chain has more partitions than this
        self.max_parts = 1 + len(problem.graph.cut_edges)
        # the same tensors with a lane axis of 1, for the lane bodies
        self._lane = (lifted(self.A), self.menus[None],
                      self.menu_sizes[None], self.clamp[None],
                      self.kv_fix[None])

    # ------------------------------------------------------------------
    def init_state(self, v0: Variables, ev0, chains: int, seed: int):
        """Every chain at ``v0`` (padded nodes at fold 1); the sweep draws
        come from a generator on the engine's device seeded with
        ``seed``."""
        n = self.static.n_nodes
        dev = self.device
        row = lambda a: torch.as_tensor(_pad_row(a, n),
                                        device=dev)[None, :].expand(chains, n)
        si, so, kk = row(v0.s_in), row(v0.s_out), row(v0.kern)
        cb_row = np.zeros(max(n - 1, 0), bool)
        for c in v0.cuts:
            cb_row[c] = True
        cb = torch.as_tensor(cb_row, device=dev)[None, :].expand(
            chains, max(n - 1, 0))
        obj = torch.full((chains,), float(ev0.objective),
                         dtype=self.A.flops.dtype, device=dev)
        feas = torch.full((chains,), bool(ev0.feasible), device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "si": si, "so": so, "kk": kk, "cb": cb,
            "obj": obj, "feas": feas,
            "best_si": si, "best_so": so, "best_kk": kk, "best_cb": cb,
            "best_obj": obj, "best_feas": feas,
            "gen": gen,
        }

    def run(self, state, temps, scale: float, cooling: float, k_min: float,
            n_sweeps: int, draws: Optional[Sequence[SweepDraws]] = None):
        """Advance all chains by ``n_sweeps``; returns (state, temps,
        (best_obj, best_feas) traces [n_sweeps, C]), all on the device.
        ``draws`` (one ``SweepDraws`` a sweep) replaces the generator's."""
        lane = {k: v[None] for k, v in state.items() if k != "gen"}
        lane["gen"] = [state["gen"]]
        if draws is not None:
            draws = [_lane_draws([d]) for d in draws]
        A, menus, menu_sizes, clamp, kv_fix = self._lane
        with _metrics.device_dispatch("sa_sweeps", sweeps=n_sweeps):
            st, temps, (t_obj, t_feas) = _sa_sweeps(
                self.static, self.gran, self.has_cut_edges, n_sweeps,
                [self.n_real], A, menus, menu_sizes, clamp, kv_fix, lane,
                temps[None], [scale], cooling, k_min, draws, self.max_parts)
        st = {k: v[0] for k, v in st.items() if k != "gen"}
        st["gen"] = state["gen"]
        return st, temps[0], (t_obj[:, 0], t_feas[:, 0])

    # ------------------------------------------------------------------
    def best_variables(self, state):
        """Per-chain incumbents as host ``Variables`` + (objective,
        feasible)."""
        nr = self.n_real
        si = state["best_si"].cpu().numpy()[:, :nr]
        so = state["best_so"].cpu().numpy()[:, :nr]
        kk = state["best_kk"].cpu().numpy()[:, :nr]
        cb = state["best_cb"].cpu().numpy()[:, :max(nr - 1, 0)]
        objs = state["best_obj"].cpu().numpy().astype(np.float64)
        feas = state["best_feas"].cpu().numpy()
        out = []
        for c in range(si.shape[0]):
            cuts = tuple(int(e) for e in np.nonzero(cb[c])[0])
            out.append((Variables(cuts, tuple(int(x) for x in si[c]),
                                  tuple(int(x) for x in so[c]),
                                  tuple(int(x) for x in kk[c])),
                        float(objs[c]), bool(feas[c])))
        return out


def _masked_choice(u, mask):
    """Uniform index among True entries along the last axis, from one
    uniform ``u`` per row: the k-th True entry via a cumulative count. Rows
    with an empty mask return 0 — callers gate on the count."""
    cnt = mask.sum(dim=-1)
    k = torch.minimum(torch.floor(u * cnt).to(cnt.dtype),
                      (cnt - 1).clamp(min=0))
    cum = torch.cumsum(mask.to(cnt.dtype), dim=-1)
    return _first_true((cum == (k + 1)[..., None]) & mask, dim=-1)


def _sa_sweep_step(static: StaticSpec, gran: Tuple[str, str, str],
                   has_cut_edges: bool, A: DeviceTensors, menus, menu_sizes,
                   clamp, kv_fix, scale, cooling: float, k_min: float,
                   st, temps, dr: SweepDraws,
                   max_parts: Optional[int] = None):
    """One SA sweep for all chains of all lanes: propose, repair,
    evaluate, accept. Lane-stacked tables, [P, C, ...] states, [P, C]
    temperatures and draws; ``scale`` is a [P] tensor of the working
    dtype. Returns (state, temps, (best_obj, best_feas))."""
    si, so, kk, cb = st["si"], st["so"], st["kk"], st["cb"]
    P, C = si.shape[:2]
    dev = si.device

    # ---------------- cut proposal --------------------------------
    if has_cut_edges:
        removable = cb
        addable = _nd(A.cut_allowed) & ~cb
        n_rem = removable.sum(dim=-1)
        n_add = addable.sum(dim=-1)
        do_rem = (dr.r2 < 0.45) & (n_rem > 0)
        do_add = ~do_rem & (dr.r2 < 0.9) & (n_add > 0)
        do_move = ~do_rem & ~do_add & (n_rem > 0) & (n_add > 0)
        rem_i = _masked_choice(dr.u_rem, removable)
        add_i = _masked_choice(dr.u_add, addable)
        iota_e = torch.arange(cb.shape[-1], device=dev)
        oh_rem = iota_e == rem_i[..., None]
        oh_add = iota_e == add_i[..., None]
        cb_cut = cb & ~(oh_rem & (do_rem | do_move)[..., None])
        cb_cut = cb_cut | (oh_add & (do_add | do_move)[..., None])
    else:
        cb_cut = cb

    # ---------------- fold proposal (joint triple redraw) ---------
    i = dr.i                                                   # [P, C]
    sizes_i = torch.gather(menu_sizes, 2, i[:, None, :].expand(P, 3, C))
    mi = torch.remainder(dr.fold, sizes_i[:, None])            # [P, 8, 3, C]
    vals = _take(menus, torch.arange(3, device=dev)[None, None, :, None],
                 i[:, None, None, :], mi)                      # [P, 8, 3, C]
    iv = _take(A.val_lut, torch.minimum(vals, A.val_cap[:, None, None, None]))
    known = (iv >= 0).all(dim=2)
    ok = known & _take(A.real_table, iv[:, :, 0].clamp(min=0),
                       iv[:, :, 1].clamp(min=0), iv[:, :, 2].clamp(min=0))
    sel = torch.where(ok.any(dim=1), _first_true(ok, dim=1), 7)
    v3 = torch.gather(vals, 1,
                      sel[:, None, None, :].expand(P, 1, 3, C))[:, 0]

    p_si, p_so, p_kk = _scatter_triple(static, gran, A, clamp,
                                       si, so, kk, cb, i, v3)
    # on-device repair: masked clamp-and-propagate (no host round-trip)
    p_si, p_so, p_kk = repair_torch(static, A, kv_fix, p_si, p_so, p_kk, cb)

    # ---------------- select + evaluate ---------------------------
    if has_cut_edges:
        is_cut = dr.r_type < 0.25
    else:
        is_cut = torch.zeros((P, C), dtype=torch.bool, device=dev)
    p_si = torch.where(is_cut[..., None], si, p_si)
    p_so = torch.where(is_cut[..., None], so, p_so)
    p_kk = torch.where(is_cut[..., None], kk, p_kk)
    p_cb = torch.where(is_cut[..., None], cb_cut, cb)
    res = _eval_core(static, A, p_si, p_so, p_kk, p_cb, max_parts=max_parts)
    p_obj = res["objective"].to(st["obj"].dtype)
    p_feas = res["feasible"]

    # ---------------- Metropolis (Eq. 11) -------------------------
    delta = (st["obj"] - p_obj) / scale[:, None]
    psi = torch.exp(torch.clamp(delta / temps, max=0.0))
    accept = p_feas & (psi >= dr.u)
    acc2 = accept[..., None]
    st = dict(st)
    st["si"] = torch.where(acc2, p_si, si)
    st["so"] = torch.where(acc2, p_so, so)
    st["kk"] = torch.where(acc2, p_kk, kk)
    st["cb"] = torch.where(acc2, p_cb, cb)
    st["obj"] = torch.where(accept, p_obj, st["obj"])
    st["feas"] = torch.where(accept, p_feas, st["feas"])

    # incumbents consider every proposal, accepted or not (a feasible
    # evaluation always beats an infeasible incumbent)
    better = (p_feas & ~st["best_feas"]) \
        | ((p_feas == st["best_feas"]) & (p_obj < st["best_obj"]))
    b2 = better[..., None]
    st["best_si"] = torch.where(b2, p_si, st["best_si"])
    st["best_so"] = torch.where(b2, p_so, st["best_so"])
    st["best_kk"] = torch.where(b2, p_kk, st["best_kk"])
    st["best_cb"] = torch.where(b2, p_cb, st["best_cb"])
    st["best_obj"] = torch.where(better, p_obj, st["best_obj"])
    st["best_feas"] = st["best_feas"] | p_feas
    temps = torch.clamp(temps * cooling, min=k_min)   # lockstep ladder cool
    return st, temps, (st["best_obj"], st["best_feas"])


@torch.no_grad()
def _sa_sweeps(static: StaticSpec, gran: Tuple[str, str, str],
               has_cut_edges: bool, n_sweeps: int, n_valid: Sequence[int],
               A: DeviceTensors, menus, menu_sizes, clamp, kv_fix, state,
               temps, scale: Sequence[float], cooling: float, k_min: float,
               draws: Optional[Sequence[SweepDraws]] = None,
               max_parts: Optional[int] = None):
    """``n_sweeps`` sweeps of every lane as a host loop that never waits
    on the device; returns (state, temps, traces [n_sweeps, P, C]), the
    traces stacked on the device. ``state["gen"]`` holds one generator a
    lane and ``n_valid`` / ``scale`` one value a lane: each lane draws
    from its own generator exactly what its single-problem run draws."""
    C = state["si"].shape[1]
    fdt = state["obj"].dtype
    dev = state["obj"].device
    # the scales as device fills, not a copy: a tensor divisor divides,
    # where a Python one would multiply by its reciprocal on cuda
    scale_t = torch.stack([torch.full((), s, dtype=fdt, device=dev)
                           for s in scale])
    gens = state["gen"]
    objs, feas = [], []
    for k in range(n_sweeps):
        dr = draws[k] if draws is not None else _lane_draws(
            [sa_draws(g, C, nv, fdt) for g, nv in zip(gens, n_valid)])
        state, temps, (o, f) = _sa_sweep_step(
            static, gran, has_cut_edges, A, menus, menu_sizes, clamp,
            kv_fix, scale_t, cooling, k_min, state, temps, dr, max_parts)
        objs.append(o)
        feas.append(f)
    return state, temps, (torch.stack(objs), torch.stack(feas))


# ----------------------------------------------------------------------
# rule-based (Algorithm 2): one greedy step on device, a host step loop
# ----------------------------------------------------------------------

def _rb_step(static: StaticSpec, gran: Tuple[str, str, str],
             A: DeviceTensors, menus, menu_sizes, clamp, cb_row, part_mask,
             pidx, amort, si, so, kk, blocked, points,
             max_parts: Optional[int] = None):
    """One Algorithm-2 greedy step of every lane, entirely on device
    ([P, n] folds, cut rows, masks; [P] partition indices, amortisations
    and point counts).

    Mirrors the scalar ``optimise_partition`` step: pick the slowest
    unblocked node of the partition, enumerate its joint fold menu
    (s_in-major, the scalar probe order), construct every probe through
    the scoped scatter + propagate, evaluate probes WITH the incumbent as
    row 0, and select the feasible, strictly-improving probe with the
    lexicographically smallest (collective-bytes, residency) resource
    delta — earliest probe wins ties, as in the scalar loop. A step with
    no winning probe blocks the node; a winning move unblocks the node's
    tying scopes.
    """
    n = static.n_nodes
    idt = A.batch.dtype
    fdt = A.flops.dtype
    dev = A.batch.device
    P = si.shape[0]
    lanes = torch.arange(P, device=dev)
    iota_n = torch.arange(n, dtype=idt, device=dev)
    mm = menus.shape[-1]
    B = mm * mm * mm
    E = cb_row.shape[-1]

    # ---- slowest unblocked node of the partition ---------------------
    ev0 = _eval_core(static, A, si[:, None], so[:, None], kk[:, None],
                     cb_row[:, None], max_parts=max_parts)
    cand = part_mask & ~blocked
    nt = torch.where(cand, ev0["node_times"][:, 0], -torch.inf)
    j = _first_true(nt == nt.amax(dim=-1, keepdim=True))      # [P]

    # ---- the node's joint fold menu, in scalar probe order -----------
    p = torch.arange(B, dtype=idt, device=dev)
    a, b, c = p // (mm * mm), (p // mm) % mm, p % mm
    mj = menus[lanes, :, j]                                    # [P, 3, mm]
    v3 = torch.stack([mj[:, 0, a], mj[:, 1, b], mj[:, 2, c]], dim=1)
    sj = menu_sizes[lanes, :, j]                               # [P, 3]
    in_menu = (a < sj[:, 0:1]) & (b < sj[:, 1:2]) & (c < sj[:, 2:3])
    cur = torch.stack([si[lanes, j], so[lanes, j], kk[lanes, j]], dim=1)
    not_cur = (v3 != cur[..., None]).any(dim=1)
    iv = _take(A.val_lut, torch.minimum(v3, A.val_cap[:, None, None]))
    known = (iv >= 0).all(dim=1)
    realiz = known & _take(A.real_table, iv[:, 0].clamp(min=0),
                           iv[:, 1].clamp(min=0), iv[:, 2].clamp(min=0))
    probe_ok = in_menu & not_cur & realiz                      # [P, B]
    n_cands = probe_ok.sum(dim=-1)

    # ---- construct + evaluate (incumbent as row 0) -------------------
    p_si, p_so, p_kk = _scatter_triple(
        static, gran, A, clamp,
        si[:, None].expand(P, B, n), so[:, None].expand(P, B, n),
        kk[:, None].expand(P, B, n), cb_row[:, None].expand(P, B, E),
        j[:, None].expand(P, B), v3)
    SI = torch.cat([si[:, None], p_si], dim=1)                 # [P, B+1, n]
    SO = torch.cat([so[:, None], p_so], dim=1)
    KK = torch.cat([kk[:, None], p_kk], dim=1)
    res = _eval_core(static, A, SI, SO, KK,
                     cb_row[:, None].expand(P, B + 1, E), max_parts=max_parts)

    # ---- decision quantities (the scalar b_cost / resource vector) ---
    t_row = torch.gather(res["part_times"], 2,
                         pidx[:, None, None].expand(P, B + 1, 1))[..., 0]
    w = _tree_sum(torch.where(part_mask[:, None],
                              _nd(A.weight_bytes) / SO.to(fdt), 0.0))
    tcost = A.reconf_fixed_s[:, None] + w / A.dma_bw[:, None]  # t_conf(part)
    cost = t_row + torch.where(pidx[:, None] > 0, amort[:, None] * tcost,
                               0.0)
    t_part = cost[:, :1]
    coll, resd = _tree_sum(torch.stack([res["node_collective"],
                                        res["node_resident"]]))
    dr0 = coll - coll[:, :1]
    dr1 = resd - resd[:, :1]
    improving = res["feasible"] & (cost < t_part - 1e-15)
    valid = improving & torch.cat(
        [torch.zeros((P, 1), dtype=torch.bool, device=dev), probe_ok], dim=1)
    any_valid = valid.any(dim=-1)

    # lexicographic (dr0, dr1) argmin over valid rows, first index wins —
    # exactly the scalar `dr < best[0]` strict-less update in probe order
    d0 = torch.where(valid, dr0, torch.inf)
    m0 = d0.amin(dim=-1, keepdim=True)
    tie0 = valid & (dr0 == m0)
    d1 = torch.where(tie0, dr1, torch.inf)
    m1 = d1.amin(dim=-1, keepdim=True)
    sel = _first_true(tie0 & (dr1 == m1))

    # ---- apply the move / block the node -----------------------------
    av = any_valid[:, None]
    si2 = torch.where(av, SI[lanes, sel], si)
    so2 = torch.where(av, SO[lanes, sel], so)
    kk2 = torch.where(av, KK[lanes, sel], kk)
    pid1 = _pid(cb_row, idt)
    same_part = pid1 == pid1[lanes, j][:, None]
    sg_j = A.scan_group[lanes, j][:, None]
    oh_j = iota_n == j[:, None]
    unblock = torch.zeros((P, n), dtype=torch.bool, device=dev)
    for g in gran:
        # NOTE: scope here is the raw Backend.scope — no decode split-KV
        # exclusion, matching the scalar unblock loop
        unblock = unblock | _scope_mask(g, same_part, A.scan_group, sg_j,
                                        oh_j)
    blocked2 = torch.where(av, blocked & ~unblock, blocked | oh_j)
    return si2, so2, kk2, blocked2, points + n_cands


@torch.no_grad()
def _rb_descend_core(static: StaticSpec, gran: Tuple[str, str, str],
                     A: DeviceTensors, menus, menu_sizes, clamp,
                     si, so, kk, cb_row, part_mask, pidx, amort, cap,
                     max_parts: Optional[int] = None):
    """Algorithm 2 lines 1-8 for every lane: a host loop over the device
    step (``_rb_step``). A lane steps while its step count is below its
    cap (``max(512, 16·|part|)``, computed by the host) and its partition
    has an unblocked node, exactly like the scalar loop; the loop runs
    while any lane does, reading that condition from the device once a
    step for all lanes. A lane that has converged, reached its cap or has
    ``cap == 0`` is an explicit no-op: a ``torch.where`` on its own
    condition carries its folds, blocked nodes and points through the
    step. Returns (si, so, kk, probe_points), [P, n] and [P]; [n] folds
    with an int ``pidx`` and ``cap`` are one problem, the P = 1 case.
    ``max_parts`` bounds the lanes' partition counts (``_eval_core``)."""
    if si.dim() == 1:
        dev = si.device
        lane = lambda x: torch.as_tensor(x, dtype=torch.int64,
                                         device=dev).reshape(1)
        out = _rb_descend_core(static, gran, lifted(A), menus[None],
                               menu_sizes[None], clamp[None], si[None],
                               so[None], kk[None], cb_row[None],
                               part_mask[None], lane(pidx), amort.reshape(1),
                               lane(cap), max_parts)
        return tuple(x[0] for x in out)
    P, n = si.shape
    dev = A.batch.device
    blocked = torch.zeros((P, n), dtype=torch.bool, device=dev)
    points = torch.zeros((P,), dtype=A.batch.dtype, device=dev)
    step = 0
    live = (cap > step) & (part_mask & ~blocked).any(dim=-1)
    while bool(live.any()):
        si2, so2, kk2, blocked2, points2 = _rb_step(
            static, gran, A, menus, menu_sizes, clamp, cb_row, part_mask,
            pidx, amort, si, so, kk, blocked, points, max_parts)
        on = live[:, None]
        si = torch.where(on, si2, si)
        so = torch.where(on, so2, so)
        kk = torch.where(on, kk2, kk)
        blocked = torch.where(on, blocked2, blocked)
        points = torch.where(live, points2, points)
        step += 1
        live = (cap > step) & (part_mask & ~blocked).any(dim=-1)
    return si, so, kk, points


class DeviceRuleBased:
    """Device-resident Algorithm-2 greedy descent for one Problem.

    ``descend(v, part)`` answers one ``rule_based._algorithm2`` request;
    the chosen move sequence is the scalar reference's. Reuses the SA move
    tables (``build_sa_tables``): menus, sizes and the per-node clamp are
    exactly ``backend.candidates`` + ``set_fold``'s divisor walk-down.
    ``device`` defaults to the card; ``dtype`` to float32; ``use_kernel``
    routes the partition-time reduction through the segred kernel. Padding
    (``pad_nodes``/``pad_menu``/...) and ``tables`` follow the fleet
    stacking contract (``fleet.fleet_rule_based``); padded nodes are never
    in ``part`` and padded menu slots fail the in-menu test, so they
    cannot be probed.
    """

    def __init__(self, problem, *, device=None, dtype=None,
                 use_kernel: bool = True, pad_nodes: Optional[int] = None,
                 pad_menu: Optional[int] = None,
                 pad_pairs: Optional[int] = None,
                 pad_vals: Optional[int] = None,
                 pad_lut: Optional[int] = None, tables=None):
        self.problem = problem
        self.tev = TorchEvaluator.from_problem(
            problem, device=device, dtype=dtype, use_kernel=use_kernel,
            pad_nodes=pad_nodes, pad_pairs=pad_pairs, pad_vals=pad_vals,
            pad_lut=pad_lut)
        self.static, self.A = self.tev.static, self.tev.arrays
        self.device = self.tev.device
        self.n_real = len(problem.graph.nodes)
        if tables is None:
            tables = build_sa_tables(problem, pad_nodes=self.static.n_nodes,
                                     pad_menu=pad_menu)
        menus, menu_sizes, clamp, _kv_fix, gran, _ = tables
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                      device=self.device)
        self.menus = t(menus)
        self.menu_sizes = t(menu_sizes)
        self.clamp = t(clamp)
        self.gran = gran
        # Eq. 3/4 reconfiguration amortisation, as in optimise_partition,
        # as a working-dtype scalar like the JAX engine's
        amort = (1.0 if problem.objective == "latency"
                 else 1.0 / max(problem.batch_amortisation, 1))
        self.amort = torch.tensor(amort, dtype=self.A.flops.dtype,
                                  device=self.device)
        # the same tensors with a lane axis of 1, for the lane bodies
        self._lane = (lifted(self.A), self.menus[None],
                      self.menu_sizes[None], self.clamp[None],
                      self.amort[None])

    # ------------------------------------------------------------------
    def pack_request(self, v: Variables, part):
        """Host lowering of one descent request (shared with the fleet);
        padded nodes at fold 1."""
        n = self.static.n_nodes
        cb_row = np.zeros(max(n - 1, 0), bool)
        for cut in v.cuts:
            cb_row[cut] = True
        part_mask = np.zeros(n, bool)
        part_mask[list(part)] = True
        pidx = sum(1 for cut in v.cuts if cut < part[0])
        cap = max(512, 16 * len(part))
        return (_pad_row(v.s_in, n), _pad_row(v.s_out, n),
                _pad_row(v.kern, n), cb_row, part_mask, pidx, cap)

    def unpack(self, v: Variables, o_si, o_so, o_kk, pts):
        nr = self.n_real
        v2 = Variables(v.cuts,
                       tuple(int(x) for x in np.asarray(o_si)[:nr]),
                       tuple(int(x) for x in np.asarray(o_so)[:nr]),
                       tuple(int(x) for x in np.asarray(o_kk)[:nr]))
        self.problem.note_batch_evals(int(pts))
        return v2, int(pts)

    def descend(self, v: Variables, part):
        si, so, kk, cb_row, part_mask, pidx, cap = self.pack_request(v, part)
        t = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)[None]
        A, menus, menu_sizes, clamp, amort = self._lane
        with _metrics.device_dispatch("rb_descend", part=len(part)):
            o_si, o_so, o_kk, pts = _rb_descend_core(
                self.static, self.gran, A, menus, menu_sizes, clamp, t(si),
                t(so), t(kk), t(cb_row), t(part_mask),
                t(np.int64(pidx)), amort, t(np.int64(cap)),
                len(v.cuts) + 1)
            o_si, o_so, o_kk, pts = (x[0].cpu().numpy()
                                     for x in (o_si, o_so, o_kk, pts))
        return self.unpack(v, o_si, o_so, o_kk, pts)


__all__ = ["VARS", "propagate_torch", "repair_torch", "build_sa_tables",
           "chunk_descriptor", "absorb_improvements", "brute_force_torch",
           "SweepDraws", "sa_draws", "DeviceSA", "DeviceRuleBased",
           "_bf_decode_digits", "_bf_eval_part", "_bf_chunk_core",
           "_bf_chunk_shards", "_bf_shard_combine",
           "_construction_tables", "_masked_choice", "_sa_sweep_step",
           "_sa_sweeps", "_rb_step", "_rb_descend_core", "_scatter_triple",
           "_scope_mask", "_pad_row"]
