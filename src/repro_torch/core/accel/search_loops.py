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
                step. Removing those round-trips is ROADMAP Queue 1,
                item 8.

Every "first index of" selection (``jnp.argmax`` on bools, ``argmax`` /
``argmin`` on values with ties) is written as the minimum index where a
mask holds (``_first_true``), so it does not depend on how a backend
breaks ties. Integer ``//`` and ``%`` floor, as ``jnp``'s do.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.accel.eval_torch import TorchEvaluator, _eval_core
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
    sweep never leaves the device to repair a move.
    """
    if not static.strict_kv:
        return si, so, kk
    kvl = A.kv_limit
    viol = (kvl[None, :] > 0) & (so > kvl[None, :])
    so = torch.where(viol, kv_fix[None, :].to(so.dtype), so)
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


def _bf_decode_digits(B: int, idt, desc):
    """Per-slot digits of a chunk, [B, S+1] (last column: the sentinel
    slot, always digit 0).

    ``desc[s] = (kind, a, b, size)``: for a slow slot (stride >= chunk) the
    digit is ``(a + (off >= b)) % size`` (one carry inside the chunk, at
    offset ``b``); for a fast slot it is ``((a + off) // b) % size``. The
    host reduced the global index modulo stride/period BEFORE building the
    descriptor, so everything here is small even for > 2^63 spaces.
    """
    off = torch.arange(B, dtype=idt, device=desc.device)
    kind, a, b, size = desc[:, 0], desc[:, 1], desc[:, 2], desc[:, 3]
    digit_slow = torch.remainder(
        a[None, :] + (off[:, None] >= b[None, :]).to(idt), size[None, :])
    digit_fast = torch.remainder(
        torch.div(a[None, :] + off[:, None], b.clamp(min=1)[None, :],
                  rounding_mode="floor"), size[None, :])
    digits = torch.where(kind[None, :] == 1, digit_fast,
                         digit_slow)                           # [B, S]
    return torch.cat([digits, torch.zeros((B, 1), dtype=idt,
                                          device=desc.device)], dim=1)


def _bf_eval_part(static: StaticSpec, B: int, no_cut: bool,
                  A: DeviceTensors, si, so, kk, cb_row, take: int):
    """Evaluate one decoded chunk: [B] objectives (inf where infeasible or
    past ``take``) and the fold rows of the first minimum (an all-inf
    chunk gives row 0, which the host ignores: nothing improved)."""
    n = static.n_nodes
    off = torch.arange(B, dtype=A.batch.dtype, device=A.batch.device)
    cb = cb_row[None, :].expand(B, max(n - 1, 0))
    res = _eval_core(static, A, si, so, kk, cb, single_partition=no_cut)
    objs = torch.where(res["feasible"] & (off < take), res["objective"],
                       torch.inf)
    r = _first_true(objs == objs.amin())
    return objs, si[r], so[r], kk[r]


def _bf_chunk_core(static: StaticSpec, B: int, no_cut: bool,
                   A: DeviceTensors, desc, sigma, T, cb_row, take: int):
    """Decode + evaluate one enumeration chunk of B candidates on device.

    Construction is three gathers through the precomputed propagation
    tables (see ``_construction_tables``); no on-device propagation.
    """
    n = static.n_nodes
    idt = A.batch.dtype
    digits = _bf_decode_digits(B, idt, desc).T                 # [S+1, B]
    iota_n = torch.arange(n, dtype=idt, device=A.batch.device)
    si = T[0][iota_n[:, None], digits[sigma[0]]].T.contiguous()  # [B, n]
    so = T[1][iota_n[:, None], digits[sigma[1]]].T.contiguous()
    kk = T[2][iota_n[:, None], digits[sigma[2]]].T.contiguous()
    return _bf_eval_part(static, B, no_cut, A, si, so, kk, cb_row, take)


@torch.no_grad()
def brute_force_torch(problem, include_cuts: bool, max_cuts: int,
                      max_points: Optional[int],
                      time_budget_s: Optional[float], batch_size: int,
                      device=None, dtype=None) -> OptimResult:
    """The torch engine behind ``optimizers.brute_force(engine="torch")``.

    Same enumeration order (hence the same optimum and history) as the
    numpy engine; candidate construction and evaluation run on ``device``
    (default: the card) in ``dtype`` (default float32). Each cut set is
    enumerated in chunks of
    ``B = min(batch_size, pow2ceil(points per cut set))`` rows. The empty
    cut set is evaluated as one partition, which needs no segmented
    reduction; a cut set with a cut takes the segred kernel.
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

    tev = TorchEvaluator.from_problem(problem, device=device, dtype=dtype)
    static, A = tev.static, tev.arrays
    dev = tev.device
    idt = np.int64                                # A's integers are int64
    B = min(batch_size, _pow2ceil(total))
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
            sigma_d, T_d = t(sigma), t(T)
            cb_row = np.zeros(max(n - 1, 0), bool)
            for c in cuts:
                cb_row[c] = True
            cb_row_d = t(cb_row)

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
                with _metrics.device_dispatch("bf_chunk", take=take):
                    objs, bi_si, bi_so, bi_kk = _bf_chunk_core(
                        static, B, not cuts, A, t(desc), sigma_d, T_d,
                        cb_row_d, take)
                # the chunk's one blocking readback
                with _trace.span("accel.d2h.bf_chunk", take=take):
                    objs = objs[:take].cpu().numpy().astype(np.float64)
                if _trace.enabled():
                    _metrics.histogram("accel.bf.feasible_fraction").observe(
                        float(np.isfinite(objs).mean()) if take else 0.0)
                problem.note_batch_evals(take)
                last_imp, best_obj = absorb_improvements(objs, best_obj,
                                                         points, history)
                if last_imp is not None:
                    best_v = Variables(
                        tuple(int(e) for e in np.nonzero(cb_row)[0]),
                        tuple(int(x) for x in bi_si.tolist()),
                        tuple(int(x) for x in bi_so.tolist()),
                        tuple(int(x) for x in bi_kk.tolist()))
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
# multi-chain simulated annealing: a device loop of sweeps
# ----------------------------------------------------------------------

class SweepDraws(NamedTuple):
    """The random inputs of one SA sweep, each shaped by the chain count C
    (the seven draws of the JAX sweep's ``jax.random.split(key, 8)``):
    the cut-move type ``r2``, the masked-choice uniforms of the removed and
    the added cut, the drawn node ``i`` in ``[0, n_valid)``, the fold-menu
    draws ``fold`` [8, 3, C] in ``[0, 2^30)``, the move type ``r_type``
    and the Metropolis uniform ``u``. Uniforms are in the working float
    dtype, integers int64."""
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


class DeviceSA:
    """Device-resident multi-chain SA: move tables + the sweep loop.

    One instance per Problem; ``run`` advances a chain-state dict by
    ``n_sweeps`` sweeps and is resumable (the host can interleave calls
    with wall-clock budget checks). Incumbents are tracked per chain on
    device and read back with ``best_variables``. ``device`` defaults to
    the card; ``dtype`` to float32.
    """

    def __init__(self, problem, *, device=None, dtype=None):
        self.problem = problem
        self.tev = TorchEvaluator.from_problem(problem, device=device,
                                               dtype=dtype)
        self.static, self.A = self.tev.static, self.tev.arrays
        self.device = self.tev.device
        self.n_real = len(problem.graph.nodes)
        menus, menu_sizes, clamp, kv_fix, gran, has_cuts = \
            build_sa_tables(problem)
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                      device=self.device)
        self.menus = t(menus)
        self.menu_sizes = t(menu_sizes)
        self.clamp = t(clamp)
        self.kv_fix = t(kv_fix)
        self.gran = gran
        self.has_cut_edges = has_cuts

    # ------------------------------------------------------------------
    def init_state(self, v0: Variables, ev0, chains: int, seed: int):
        """Every chain at ``v0``; the sweep draws come from a generator on
        the engine's device seeded with ``seed``."""
        n = self.static.n_nodes
        dev = self.device
        row = lambda a: torch.as_tensor(np.asarray(a, np.int64),
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
        with _metrics.device_dispatch("sa_sweeps", sweeps=n_sweeps):
            return _sa_sweeps(self.static, self.gran, self.has_cut_edges,
                              n_sweeps, self.n_real, self.A, self.menus,
                              self.menu_sizes, self.clamp, self.kv_fix,
                              state, temps, scale, cooling, k_min, draws)

    # ------------------------------------------------------------------
    def best_variables(self, state):
        """Per-chain incumbents as host ``Variables`` + (objective,
        feasible)."""
        si = state["best_si"].cpu().numpy()
        so = state["best_so"].cpu().numpy()
        kk = state["best_kk"].cpu().numpy()
        cb = state["best_cb"].cpu().numpy()
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
    """Uniform index among True entries per row, from one uniform ``u``
    [rows] per row: the k-th True entry via a cumulative count. Rows with
    an empty mask return 0 — callers gate on the count."""
    cnt = mask.sum(dim=1)
    k = torch.minimum(torch.floor(u * cnt).to(cnt.dtype),
                      (cnt - 1).clamp(min=0))
    cum = torch.cumsum(mask.to(cnt.dtype), dim=1)
    return _first_true((cum == (k + 1)[:, None]) & mask, dim=1)


def _sa_sweep_step(static: StaticSpec, gran: Tuple[str, str, str],
                   has_cut_edges: bool, A: DeviceTensors, menus, menu_sizes,
                   clamp, kv_fix, scale, cooling: float, k_min: float,
                   st, temps, dr: SweepDraws):
    """One SA sweep for all chains: propose, repair, evaluate, accept.
    ``scale`` is a 0-d tensor of the working dtype. Returns (state, temps,
    (best_obj, best_feas))."""
    si, so, kk, cb = st["si"], st["so"], st["kk"], st["cb"]
    C = si.shape[0]
    dev = si.device

    # ---------------- cut proposal --------------------------------
    if has_cut_edges:
        removable = cb
        addable = A.cut_allowed[None, :] & ~cb
        n_rem = removable.sum(dim=1)
        n_add = addable.sum(dim=1)
        do_rem = (dr.r2 < 0.45) & (n_rem > 0)
        do_add = ~do_rem & (dr.r2 < 0.9) & (n_add > 0)
        do_move = ~do_rem & ~do_add & (n_rem > 0) & (n_add > 0)
        rem_i = _masked_choice(dr.u_rem, removable)
        add_i = _masked_choice(dr.u_add, addable)
        iota_e = torch.arange(cb.shape[1], device=dev)
        oh_rem = iota_e[None, :] == rem_i[:, None]
        oh_add = iota_e[None, :] == add_i[:, None]
        cb_cut = cb & ~(oh_rem & (do_rem | do_move)[:, None])
        cb_cut = cb_cut | (oh_add & (do_add | do_move)[:, None])
    else:
        cb_cut = cb

    # ---------------- fold proposal (joint triple redraw) ---------
    i = dr.i
    sizes_i = menu_sizes[:, i]                       # [3, C]
    mi = torch.remainder(dr.fold, sizes_i[None, :, :])            # [8, 3, C]
    vals = menus[torch.arange(3, device=dev)[None, :, None],
                 i[None, None, :], mi]               # [8, 3, C]
    lut, cap = A.val_lut, A.val_cap
    iv = lut[torch.minimum(vals, cap)]
    known = (iv >= 0).all(dim=1)
    ok = known & A.real_table[iv[:, 0].clamp(min=0), iv[:, 1].clamp(min=0),
                              iv[:, 2].clamp(min=0)]
    sel = torch.where(ok.any(dim=0), _first_true(ok, dim=0), 7)
    v3 = torch.gather(vals, 0, sel[None, None, :].expand(1, 3, C))[0]

    p_si, p_so, p_kk = _scatter_triple(static, gran, A, clamp,
                                       si, so, kk, cb, i, v3)
    # on-device repair: masked clamp-and-propagate (no host round-trip)
    p_si, p_so, p_kk = repair_torch(static, A, kv_fix, p_si, p_so, p_kk, cb)

    # ---------------- select + evaluate ---------------------------
    if has_cut_edges:
        is_cut = dr.r_type < 0.25
    else:
        is_cut = torch.zeros((C,), dtype=torch.bool, device=dev)
    p_si = torch.where(is_cut[:, None], si, p_si)
    p_so = torch.where(is_cut[:, None], so, p_so)
    p_kk = torch.where(is_cut[:, None], kk, p_kk)
    p_cb = torch.where(is_cut[:, None], cb_cut, cb)
    res = _eval_core(static, A, p_si, p_so, p_kk, p_cb)
    p_obj = res["objective"].to(st["obj"].dtype)
    p_feas = res["feasible"]

    # ---------------- Metropolis (Eq. 11) -------------------------
    delta = (st["obj"] - p_obj) / scale
    psi = torch.exp(torch.clamp(delta / temps, max=0.0))
    accept = p_feas & (psi >= dr.u)
    acc2 = accept[:, None]
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
    b2 = better[:, None]
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
               has_cut_edges: bool, n_sweeps: int, n_valid: int,
               A: DeviceTensors, menus, menu_sizes, clamp, kv_fix, state,
               temps, scale: float, cooling: float, k_min: float,
               draws: Optional[Sequence[SweepDraws]] = None):
    """``n_sweeps`` sweeps as a host loop that never waits on the device;
    returns (state, temps, traces), the traces stacked on the device."""
    C = state["si"].shape[0]
    fdt = state["obj"].dtype
    # the scale as a device scalar (a fill, not a copy): a tensor divisor
    # divides, where a Python one would multiply by its reciprocal on cuda
    scale_t = torch.full((), scale, dtype=fdt, device=state["obj"].device)
    objs, feas = [], []
    for k in range(n_sweeps):
        dr = draws[k] if draws is not None \
            else sa_draws(state["gen"], C, n_valid, fdt)
        state, temps, (o, f) = _sa_sweep_step(
            static, gran, has_cut_edges, A, menus, menu_sizes, clamp,
            kv_fix, scale_t, cooling, k_min, state, temps, dr)
        objs.append(o)
        feas.append(f)
    return state, temps, (torch.stack(objs), torch.stack(feas))


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


__all__ = ["VARS", "propagate_torch", "repair_torch", "build_sa_tables",
           "chunk_descriptor", "absorb_improvements", "brute_force_torch",
           "SweepDraws", "sa_draws", "DeviceSA", "DeviceRuleBased",
           "_bf_decode_digits", "_bf_eval_part", "_bf_chunk_core",
           "_construction_tables", "_masked_choice", "_sa_sweep_step",
           "_sa_sweeps", "_rb_step", "_rb_descend_core", "_scatter_triple",
           "_scope_mask"]
