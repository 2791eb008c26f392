"""On-device rule-based search: Algorithm 2's greedy descent (the port of
the rule-based part of ``repro.core.accel.search_loops``).

Each greedy step runs on the device: evaluate the incumbent, pick the
slowest unblocked partition node, expand its joint fold menu (s_in-major —
the scalar probe order) through the scoped scatter + one propagate pass,
evaluate all probes WITH the incumbent in the same batch, and apply the
feasible strictly-improving probe with the smallest lexicographic
(collective, residency) resource delta. The chosen move sequence is the
scalar reference's. Algorithm 2's outer merge loop stays on the host
(``optimizers/rule_based._algorithm2``), shared verbatim by every engine.

The JAX package runs a whole descent as one ``lax.while_loop``; here the
loop is a host loop over a device step that reads the loop condition once
per step (one synchronisation per move). Removing those round-trips is
ROADMAP Queue 1, item 8.

Every "first index of" selection (``jnp.argmax`` on bools, ``argmax`` /
``argmin`` on values with ties) is written as the minimum index where a
mask holds (``_first_true``), so it does not depend on how a backend
breaks ties.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.accel.eval_torch import TorchEvaluator, _eval_core
from repro_torch.core.accel.lowering import DeviceTensors, StaticSpec
from repro_torch.core.hdgraph import Variables
from repro_torch.obs import metrics as _metrics

VARS = ("s_in", "s_out", "kern")
_DIMS = {"s_in": "rows", "s_out": "col_div", "kern": "batch"}


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
    """[C, n-1] cut bitmask -> [C, n] monotone partition ids."""
    C = cb.shape[0]
    return torch.cat([torch.zeros((C, 1), dtype=idt, device=cb.device),
                      torch.cumsum(cb.to(idt), dim=1)], dim=1)


# ----------------------------------------------------------------------
# dynamic-cut constraint propagation (Backend.propagate on device)
# ----------------------------------------------------------------------

def propagate_torch(static: StaticSpec, A: DeviceTensors, si, so, kk, cb,
                    single_partition: bool = False):
    """Port of ``Backend.propagate`` for per-candidate cut bitmasks.

    Anchors (scan-group first member, partition first node, partition first
    non-internal node) are gathered from the pre-mutation tensors, matching
    the host's copy-then-assign order. ``single_partition`` promises cb is
    all-False, collapsing the partition ids to a constant.
    """
    n = static.n_nodes
    C = si.shape[0]
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
        grp = (sg[:, None] == sg[None, :]) & (sg[:, None] >= 0)   # [n, n]
        if single_partition:
            ok = grp[None, :, :].expand(C, n, n)
        else:
            ok = grp[None, :, :] & (pid[:, :, None] == pid[:, None, :])
        anchor = _first_true(ok, dim=2)
        anchor = torch.where(sg[None, :] >= 0, anchor,
                             iota[None, :].expand(C, n))
        si = torch.gather(si, 1, anchor)
        so = torch.gather(so, 1, anchor)
        kk = torch.gather(kk, 1, anchor)

    if static.intra_matching:
        so = torch.where(A.elementwise[None, :], si, so)

    if static.inter_matching:
        if single_partition:
            anchor_k = kk[:, 0][:, None]
            # partition's first non-internal node (padded columns are
            # non-internal with fold 1, so an all-internal real graph
            # anchors at fold 1 either way — the host's fallback value)
            f1 = torch.where(A.internal, n, iota)
            ni = _first_true(f1 == f1.amin())
            anchor_si = torch.where(f1.amin() < n, si[:, ni], one)[:, None]
        else:
            is_start = torch.cat(
                [torch.ones((C, 1), dtype=torch.bool, device=dev), cb], dim=1)
            start_idx = torch.cummax(
                torch.where(is_start, iota[None, :], 0), dim=1).values
            anchor_k = torch.gather(kk, 1, start_idx)
            # first non-internal node of each partition (may be after j):
            # dense per-partition min of (j | internal -> n), gathered back
            f = torch.where(A.internal, n, iota)[None, :].expand(C, n)
            onehot = pid[:, :, None] == iota[None, None, :]
            segmin = torch.where(onehot, f[:, :, None], n).amin(dim=1)
            anchor_ni = torch.gather(segmin, 1, pid)
            anchor_si = torch.where(
                anchor_ni < n,
                torch.gather(si, 1, anchor_ni.clamp(max=n - 1)),
                one)
        kk = torch.where(A.batch % anchor_k == 0, anchor_k, one)
        si_new = torch.where(A.rows % anchor_si == 0, anchor_si, one)
        si = torch.where(A.internal[None, :], si, si_new)
        if static.intra_matching:
            so = torch.where(A.elementwise[None, :], si, so)
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

    Scatters the (per-node clamped) values of ``v3`` [3, C] over node
    ``i``'s tying scope in each of the C rows — global granularity writes
    the whole partition, group granularity the node's scan group within
    the partition, node granularity the node itself; globally-tied s_in
    skips decode split-KV (internal-rows) nodes exactly like the host —
    then ONE ``propagate_torch`` pass restores the backend's matching and
    tying invariants.
    """
    n = static.n_nodes
    idt = A.batch.dtype
    iota_n = torch.arange(n, dtype=idt, device=A.batch.device)
    pid = _pid(cb, idt)
    pid_i = torch.gather(pid, 1, i[:, None])
    same_part = pid == pid_i
    sg_i = A.scan_group[i]
    oh_i = iota_n[None, :] == i[:, None]
    fold = {"s_in": si, "s_out": so, "kern": kk}
    for vi, var in enumerate(VARS):
        g = gran[vi]
        m = _scope_mask(g, same_part, A.scan_group[None, :],
                        sg_i[:, None], oh_i)
        if var == "s_in" and g == "global":
            m = m & ~A.internal[None, :]     # decode split-KV keeps s_I
        clamped = clamp[vi][iota_n[None, :], v3[vi][:, None]]
        fold[var] = torch.where(m, clamped, fold[var])
    return propagate_torch(static, A, fold["s_in"], fold["s_out"],
                           fold["kern"], cb)


# ----------------------------------------------------------------------
# host move tables (numpy; copied from the JAX package)
# ----------------------------------------------------------------------

def build_sa_tables(problem):
    """Host-precomputed move tables for the device search.

    Returns numpy arrays (menus [3, n, mm], menu_sizes [3, n], clamp
    [3, n, max_val+1], kv_fix [n]) plus the backend's granularity triple
    and cut-edge flag.
    """
    graph, backend, platform = \
        problem.graph, problem.backend, problem.platform
    n = len(graph.nodes)

    max_val = max(platform.fold_values())
    menu_lists = {}
    max_menu = 1
    for vi, var in enumerate(VARS):
        for j in range(n):
            cands = backend.candidates(graph, j, var, platform)
            menu_lists[(vi, j)] = cands
            max_menu = max(max_menu, len(cands))
    menus = np.ones((3, n, max_menu), np.int64)
    menu_sizes = np.ones((3, n), np.int64)
    for (vi, j), cands in menu_lists.items():
        menus[vi, j, :len(cands)] = cands
        menu_sizes[vi, j] = len(cands)
    # clamp[var, node, v] = set_fold's divisor walk-down of value v
    clamp = np.ones((3, n, max_val + 1), np.int64)
    for vi, var in enumerate(VARS):
        for j in range(n):
            dim = getattr(graph.nodes[j], _DIMS[var])
            for v in range(max_val + 1):
                val = v
                while val > 1 and dim % val != 0:
                    val -= 1
                clamp[vi, j, v] = val
    # kv_fix[j]: largest s_out menu value within the node's KV limit
    kv_fix = np.ones(n, np.int64)
    for j in range(n):
        kvl = graph.nodes[j].kv_limit
        if kvl > 0:
            legal = [c for c in menu_lists[(1, j)] if c <= kvl]
            kv_fix[j] = max(legal) if legal else 1
    gran = tuple(backend.granularity[var] for var in VARS)
    return menus, menu_sizes, clamp, kv_fix, gran, \
        bool(len(graph.cut_edges) > 0)


# ----------------------------------------------------------------------
# rule-based (Algorithm 2): one greedy step on device, a host step loop
# ----------------------------------------------------------------------

def _rb_step(static: StaticSpec, gran: Tuple[str, str, str],
             A: DeviceTensors, menus, menu_sizes, clamp, cb_row, part_mask,
             pidx: int, amort, si, so, kk, blocked, points):
    """One Algorithm-2 greedy step, entirely on device.

    Mirrors the scalar ``optimise_partition`` step: pick the slowest
    unblocked node of the partition, enumerate its joint fold menu
    (s_in-major, the scalar probe order), construct every probe through
    the scoped scatter + propagate, evaluate probes WITH the incumbent as
    row 0, and select the feasible, strictly-improving probe with the
    lexicographically smallest (collective-bytes, residency) resource
    delta — earliest probe wins ties, as in the scalar loop. A step with
    no winning probe blocks the node; a winning move unblocks the node's
    tying scopes. ``pidx`` (the partition's index) is a host int.
    """
    n = static.n_nodes
    idt = A.batch.dtype
    fdt = A.flops.dtype
    dev = A.batch.device
    iota_n = torch.arange(n, dtype=idt, device=dev)
    mm = menus.shape[-1]
    B = mm * mm * mm

    # ---- slowest unblocked node of the partition ---------------------
    ev0 = _eval_core(static, A, si[None, :], so[None, :], kk[None, :],
                     cb_row[None, :])
    cand = part_mask & ~blocked
    nt = torch.where(cand, ev0["node_times"][0], -torch.inf)
    j = _first_true(nt == nt.amax())

    # ---- the node's joint fold menu, in scalar probe order -----------
    p = torch.arange(B, dtype=idt, device=dev)
    a, b, c = p // (mm * mm), (p // mm) % mm, p % mm
    v3 = torch.stack([menus[0, j, a], menus[1, j, b], menus[2, j, c]])
    in_menu = (a < menu_sizes[0, j]) & (b < menu_sizes[1, j]) \
        & (c < menu_sizes[2, j])
    cur = torch.stack([si[j], so[j], kk[j]])
    not_cur = (v3 != cur[:, None]).any(dim=0)
    lut, cap = A.val_lut, A.val_cap
    iv = lut[torch.minimum(v3, cap)]
    known = (iv >= 0).all(dim=0)
    realiz = known & A.real_table[iv[0].clamp(min=0), iv[1].clamp(min=0),
                                  iv[2].clamp(min=0)]
    probe_ok = in_menu & not_cur & realiz                      # [B]
    n_cands = probe_ok.sum()

    # ---- construct + evaluate (incumbent as row 0) -------------------
    E = cb_row.shape[0]
    cbB = cb_row[None, :].expand(B, E)
    p_si, p_so, p_kk = _scatter_triple(
        static, gran, A, clamp,
        si[None, :].expand(B, n), so[None, :].expand(B, n),
        kk[None, :].expand(B, n), cbB, j.expand(B), v3)
    SI = torch.cat([si[None, :], p_si], dim=0)                 # [B+1, n]
    SO = torch.cat([so[None, :], p_so], dim=0)
    KK = torch.cat([kk[None, :], p_kk], dim=0)
    res = _eval_core(static, A, SI, SO, KK,
                     cb_row[None, :].expand(B + 1, E))

    # ---- decision quantities (the scalar b_cost / resource vector) ---
    t_row = res["part_times"][:, pidx]                         # [B+1]
    w = torch.where(part_mask[None, :],
                    A.weight_bytes[None, :] / SO.to(fdt), 0.0).sum(dim=1)
    tcost = A.reconf_fixed_s + w / A.dma_bw                    # t_conf(part)
    cost = t_row + (amort * tcost if pidx > 0
                    else torch.zeros((), dtype=fdt, device=dev))
    t_part = cost[0]
    coll = res["node_collective"].sum(dim=1)
    resd = res["node_resident"].sum(dim=1)
    dr0 = coll - coll[0]
    dr1 = resd - resd[0]
    improving = res["feasible"] & (cost < t_part - 1e-15)
    valid = improving & torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=dev), probe_ok])
    any_valid = valid.any()

    # lexicographic (dr0, dr1) argmin over valid rows, first index wins —
    # exactly the scalar `dr < best[0]` strict-less update in probe order
    d0 = torch.where(valid, dr0, torch.inf)
    m0 = d0.amin()
    tie0 = valid & (dr0 == m0)
    d1 = torch.where(tie0, dr1, torch.inf)
    m1 = d1.amin()
    sel = _first_true(tie0 & (dr1 == m1))

    # ---- apply the move / block the node -----------------------------
    si2 = torch.where(any_valid, SI[sel], si)
    so2 = torch.where(any_valid, SO[sel], so)
    kk2 = torch.where(any_valid, KK[sel], kk)
    pid1 = _pid(cb_row[None, :], idt)[0]
    same_part = pid1 == pid1[j]
    sg_j = A.scan_group[j]
    oh_j = iota_n == j
    unblock = torch.zeros(n, dtype=torch.bool, device=dev)
    for g in gran:
        # NOTE: scope here is the raw Backend.scope — no decode split-KV
        # exclusion, matching the scalar unblock loop
        unblock = unblock | _scope_mask(g, same_part, A.scan_group, sg_j,
                                        oh_j)
    blocked2 = torch.where(any_valid, blocked & ~unblock, blocked | oh_j)
    return si2, so2, kk2, blocked2, points + n_cands


@torch.no_grad()
def _rb_descend_core(static: StaticSpec, gran: Tuple[str, str, str],
                     A: DeviceTensors, menus, menu_sizes, clamp,
                     si, so, kk, cb_row, part_mask, pidx: int, amort,
                     cap: int):
    """Algorithm 2 lines 1-8: a host loop over the device step
    (``_rb_step``), ending — exactly like the scalar loop — when every
    partition node is blocked or the step cap (``max(512, 16·|part|)``,
    computed by the host) is reached. The loop condition is read from the
    device once per step. Returns (si, so, kk, probe_points); ``cap == 0``
    makes the whole descent a no-op."""
    n = static.n_nodes
    dev = A.batch.device
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    points = torch.zeros((), dtype=A.batch.dtype, device=dev)
    step = 0
    while step < cap and bool((part_mask & ~blocked).any()):
        si, so, kk, blocked, points = _rb_step(
            static, gran, A, menus, menu_sizes, clamp, cb_row, part_mask,
            pidx, amort, si, so, kk, blocked, points)
        step += 1
    return si, so, kk, points


class DeviceRuleBased:
    """Device-resident Algorithm-2 greedy descent for one Problem.

    ``descend(v, part)`` answers one ``rule_based._algorithm2`` request;
    the chosen move sequence is the scalar reference's. Reuses the SA move
    tables (``build_sa_tables``): menus, sizes and the per-node clamp are
    exactly ``backend.candidates`` + ``set_fold``'s divisor walk-down.
    ``device`` defaults to the card; ``dtype`` to float32; ``use_kernel``
    routes the partition-time reduction through the segred kernel.
    """

    def __init__(self, problem, *, device=None, dtype=None,
                 use_kernel: bool = True):
        self.problem = problem
        self.tev = TorchEvaluator.from_problem(
            problem, device=device, dtype=dtype, use_kernel=use_kernel)
        self.static, self.A = self.tev.static, self.tev.arrays
        self.device = self.tev.device
        menus, menu_sizes, clamp, _kv_fix, gran, _ = build_sa_tables(problem)
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

    # ------------------------------------------------------------------
    def pack_request(self, v: Variables, part):
        """Host lowering of one descent request."""
        n = self.static.n_nodes
        av = lambda t: np.asarray(t, np.int64)
        cb_row = np.zeros(max(n - 1, 0), bool)
        for cut in v.cuts:
            cb_row[cut] = True
        part_mask = np.zeros(n, bool)
        part_mask[list(part)] = True
        pidx = sum(1 for cut in v.cuts if cut < part[0])
        cap = max(512, 16 * len(part))
        return (av(v.s_in), av(v.s_out), av(v.kern), cb_row, part_mask,
                pidx, cap)

    def unpack(self, v: Variables, o_si, o_so, o_kk, pts):
        v2 = Variables(v.cuts, tuple(int(x) for x in np.asarray(o_si)),
                       tuple(int(x) for x in np.asarray(o_so)),
                       tuple(int(x) for x in np.asarray(o_kk)))
        self.problem.note_batch_evals(int(pts))
        return v2, int(pts)

    def descend(self, v: Variables, part):
        si, so, kk, cb_row, part_mask, pidx, cap = self.pack_request(v, part)
        t = lambda a: torch.from_numpy(a).to(self.device)
        with _metrics.device_dispatch("rb_descend", part=len(part)):
            o_si, o_so, o_kk, pts = _rb_descend_core(
                self.static, self.gran, self.A, self.menus, self.menu_sizes,
                self.clamp, t(si), t(so), t(kk), t(cb_row), t(part_mask),
                int(pidx), self.amort, int(cap))
            o_si, o_so, o_kk, pts = (x.cpu().numpy()
                                     for x in (o_si, o_so, o_kk, pts))
        return self.unpack(v, o_si, o_so, o_kk, pts)


__all__ = ["VARS", "propagate_torch", "build_sa_tables", "DeviceRuleBased",
           "_rb_step", "_rb_descend_core", "_scatter_triple", "_scope_mask"]
