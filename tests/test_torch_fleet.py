"""The port's fleet (``repro_torch.core.accel.fleet``) and
``optimise_portfolio(engine="torch")``: bucketing as the JAX package's,
padded move tables and searches bitwise the unpadded ones, each fleet
bitwise its per-problem torch loop and equal to the numpy engine and to the
JAX fleet, converged and ``cap == 0`` lanes as no-ops, the fingerprint
partition as JAX's, and one segred launch a step, sweep or chunk whatever
the number of lanes. Reduced problems on the JAX fleet tests' platforms
(``tests/test_accel_engine.py``); the card-only cases run the three fleets
on a card against the card's per-problem loop."""
import numpy as np
import pytest
import torch

from _torch_support import MESH_4X4, TINY_SHAPES  # noqa: F401
from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.core.accel import fleet as TF
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel import segred
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.optimizers.common import repair

#: float32-on-device agreement vs the float64 reference
F32_RTOL = 1e-5

#: (name, Platform class, kwargs) of the JAX fleet tests' platforms
PLATFORMS = {
    "t-4x4": ("Platform", dict(mesh_axes=MESH_4X4)),
    "t-2x8": ("Platform", dict(mesh_axes=(("data", 2), ("model", 8)),
                               hbm_bytes=8 * 2**30, hbm_bw=400e9)),
    "t-abs16": ("AbstractPlatform", dict(mesh_axes=MESH_4X4)),
}


def _problems(specs, package="repro_torch"):
    """Reduced problems of ``package`` from (arch, platform, backend,
    objective, exec_model, mode) specs."""
    from importlib import import_module
    cfg = import_module(f"{package}.configs")
    base = import_module(f"{package}.configs.base")
    bk = import_module(f"{package}.core.backends")
    gb = import_module(f"{package}.core.graph_builder")
    ob = import_module(f"{package}.core.objectives")
    pm = import_module(f"{package}.core.perfmodel")
    pl = import_module(f"{package}.core.platform")
    out = []
    for arch, plat, backend, objective, exec_model, mode in specs:
        cls, kw = PLATFORMS[plat]
        graph = gb.build_hdgraph(cfg.reduced(cfg.get_arch(arch)),
                                 base.ShapeSpec(*TINY_SHAPES[mode]))
        out.append(ob.Problem(graph=graph,
                              platform=getattr(pl, cls)(name=plat, **kw),
                              backend=bk.BACKENDS[backend],
                              objective=objective, exec_model=exec_model,
                              opts=pm.ModelOptions()))
    return out


def _spec(arch, plat="t-4x4", backend="spmd", objective="throughput",
          exec_model="streaming", mode="train"):
    return (arch, plat, backend, objective, exec_model, mode)


def _jax_fleet():
    pytest.importorskip("jax")
    from repro.core.accel import fleet as JF
    return JF


def _same(a, b):
    """Points, design, history and the float64 evaluation, exactly."""
    return (a.points, tuple(a.variables.cuts), a.variables.s_in,
            a.variables.s_out, a.variables.kern, a.history,
            a.evaluation.objective, a.evaluation.feasible) == \
        (b.points, tuple(b.variables.cuts), b.variables.s_in,
         b.variables.s_out, b.variables.kern, b.history,
         b.evaluation.objective, b.evaluation.feasible)


def _same_search(got, want, rtol):
    """Points, design and history indices equal; the history's recorded
    objectives within ``rtol`` (the port's float32 against float64)."""
    assert got.points == want.points
    assert (tuple(got.variables.cuts), got.variables.s_in,
            got.variables.s_out, got.variables.kern) == \
        (tuple(want.variables.cuts), want.variables.s_in,
         want.variables.s_out, want.variables.kern)
    assert [i for i, _ in got.history] == [i for i, _ in want.history]
    np.testing.assert_allclose([o for _, o in got.history],
                               [o for _, o in want.history], rtol=rtol)


# ----------------------------------------------------------------------
# bucketing and fingerprints
# ----------------------------------------------------------------------

#: the worked example of ``bucket_indices``' docstring
WORKED = [_spec("tinyllama-1.1b"),
          _spec("llama3.2-1b", plat="t-abs16"),
          _spec("stablelm-3b"),
          _spec("tinyllama-1.1b", backend="megatron"),
          _spec("jamba-1.5-large-398b"),
          _spec("tinyllama-1.1b", plat="t-2x8", mode="decode")]


def test_bucketing_matches_jax_on_the_worked_example():
    JF = _jax_fleet()
    port, ref = _problems(WORKED), _problems(WORKED, "repro")
    for tiered, want in ((True, [[0, 1, 2], [3], [4], [5]]),
                         (False, [[0, 1, 2, 4], [3], [5]])):
        assert TF.bucket_indices(port, tiered) == want
        assert JF.bucket_indices(ref, tiered) == want
        assert [TF.bucket_key(p, tiered) for p in port] == \
            [JF.bucket_key(p, tiered) for p in ref]


def _partition(keys):
    """Indices grouped by equal key, in first-seen order."""
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return sorted(out.values())


def test_fingerprint_partition_matches_jax():
    """Two problems share a port fingerprint exactly when they share a JAX
    one: true duplicates, and near-duplicates (the same arch on another
    platform, with another objective, backend or mode) that must not."""
    pytest.importorskip("jax")
    from repro.core.accel.lowering import problem_fingerprint as jax_fp
    from repro_torch.core.accel.lowering import problem_fingerprint
    specs = [_spec("tinyllama-1.1b"), _spec("tinyllama-1.1b"),
             _spec("tinyllama-1.1b", plat="t-2x8"),
             _spec("tinyllama-1.1b", objective="latency"),
             _spec("tinyllama-1.1b", backend="megatron"),
             _spec("tinyllama-1.1b", mode="decode"),
             _spec("tinyllama-1.1b", plat="t-abs16"),
             _spec("tinyllama-1.1b", plat="t-abs16"),
             _spec("llama3.2-1b"), _spec("tinyllama-1.1b", plat="t-2x8")]
    port = [problem_fingerprint(p) for p in _problems(specs)]
    ref = [jax_fp(p) for p in _problems(specs, "repro")]
    assert _partition(port) == _partition(ref) == \
        [[0, 1], [2, 9], [3], [4], [5], [6, 7], [8]]
    # the engine knob does not enter it
    p = _problems(specs[:1])[0]
    assert problem_fingerprint(p) == problem_fingerprint(p.batched())


# ----------------------------------------------------------------------
# padding
# ----------------------------------------------------------------------

def test_padded_move_tables_extend_exactly():
    """``build_sa_tables`` padded: the real block unchanged, padded nodes
    and menu entries fold 1 with menu size 1, and the clamp's extended
    value axis the divisor walk-down (as the JAX package's tables)."""
    pytest.importorskip("jax")
    from repro.core.accel.search_loops import build_sa_tables as jax_tables
    (port,), (ref,) = _problems([_spec("jamba-1.5-large-398b", "t-2x8",
                                       "megatron")]), \
        _problems([_spec("jamba-1.5-large-398b", "t-2x8", "megatron")],
                  "repro")
    base = TS.build_sa_tables(port)
    n, mm, V = base[0].shape[1], base[0].shape[2], base[2].shape[2]
    kw = dict(pad_nodes=n + 5, pad_menu=mm + 2, pad_val=V - 1 + 9)
    pad = TS.build_sa_tables(port, **kw)
    for a, b in zip(pad[:4], jax_tables(ref, **kw)[:4]):
        np.testing.assert_array_equal(a, b)
    menus, sizes, clamp, kv_fix = pad[:4]
    np.testing.assert_array_equal(menus[:, :n, :mm], base[0])
    assert (menus[:, n:] == 1).all() and (menus[:, :, mm:] == 1).all()
    np.testing.assert_array_equal(sizes[:, :n], base[1])
    assert (sizes[:, n:] == 1).all()
    np.testing.assert_array_equal(clamp[:, :n, :V], base[2])
    np.testing.assert_array_equal(kv_fix[:n], base[3])
    dims = {"s_in": "rows", "s_out": "col_div", "kern": "batch"}
    for vi, var in enumerate(TS.VARS):
        for j in range(n):
            dim = getattr(port.graph.nodes[j], dims[var])
            for v in range(V, clamp.shape[2]):
                w = v
                while w > 1 and dim % w != 0:
                    w -= 1
                assert clamp[vi, j, v] == w
    with pytest.raises(ValueError, match="pad_val"):
        TS.build_sa_tables(port, pad_val=V - 2)


def _pads(problem, grow):
    bev = problem.batched()
    return dict(pad_nodes=len(problem.graph.nodes) + grow,
                pad_pairs=max(bev.scan_pairs.shape[0], 1) + grow,
                pad_vals=len(problem.platform.fold_values()) + grow,
                pad_lut=max(problem.platform.fold_values()) + 2 + grow)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_padded_descent_and_sweeps_are_bitwise_unpadded(dtype):
    """``DeviceRuleBased.descend`` on every partition of the start design
    and ``DeviceSA.run`` over 25 sweeps: padded nodes, menus, scan pairs
    and fold tables give the unpadded results bit for bit."""
    specs = [_spec("jamba-1.5-large-398b", backend="megatron",
                   objective="latency", exec_model="spmd"),
             _spec("tinyllama-1.1b", plat="t-2x8", backend="spmd")]
    from repro_torch.core.hdgraph import partitions_from_cuts
    for p in _problems(specs):
        mm = TS.build_sa_tables(p)[0].shape[2]
        rb0 = TS.DeviceRuleBased(p, device="cpu", dtype=dtype)
        rb1 = TS.DeviceRuleBased(p, device="cpu", dtype=dtype,
                                 pad_menu=mm + 2, **_pads(p, 5))
        v0 = repair(p, p.backend.initial(p.graph))
        for part in partitions_from_cuts(p.graph, v0.cuts):
            assert rb1.descend(v0, part) == rb0.descend(v0, part)
        sa0 = TS.DeviceSA(p, device="cpu", dtype=dtype)
        sa1 = TS.DeviceSA(p, device="cpu", dtype=dtype, pad_menu=mm + 1,
                          **_pads(p, 7))
        ev0 = p.evaluate(v0)
        temps = torch.tensor([5.0, 8.0, 12.8], dtype=dtype)
        out = [sa.run(sa.init_state(v0, ev0, 3, 4), temps, 0.01, 0.95, 1.0,
                      25) for sa in (sa0, sa1)]
        (s0, _, (o0, f0)), (s1, _, (o1, f1)) = out
        assert torch.equal(o0, o1) and torch.equal(f0, f1)
        n = len(p.graph.nodes)
        for k in ("si", "so", "kk", "best_si", "best_so", "best_kk"):
            assert torch.equal(s1[k][:, :n], s0[k])
            assert (s1[k][:, n:] == 1).all()
        assert torch.equal(s1["best_obj"], s0["best_obj"])
        assert sa1.best_variables(s1) == sa0.best_variables(s0)


# ----------------------------------------------------------------------
# the fleets against the per-problem loop, numpy and the JAX fleet
# ----------------------------------------------------------------------

BF_SPECS = [_spec("tinyllama-1.1b", backend="megatron", objective="latency",
                  exec_model="spmd"),
            _spec("llama3.2-1b", plat="t-abs16", backend="megatron",
                  objective="latency", exec_model="spmd"),
            _spec("stablelm-3b", plat="t-2x8", backend="megatron",
                  exec_model="spmd"),
            _spec("granite-moe-1b-a400m", backend="megatron",
                  objective="latency", exec_model="spmd")]
BF_KW = dict(include_cuts=True, max_cuts=1, max_points=3000, batch_size=256)


def test_fleet_brute_force_equals_loop_numpy_and_jax():
    """Brute force with cuts over mixed platforms and objectives: the
    fleet equals the per-problem torch loop exactly, and the numpy engine
    and the JAX fleet in points, design and history indices (recorded
    objectives at the float32 contract)."""
    from repro.core.optimizers import brute_force as ref_bf
    JF = _jax_fleet()
    probs = _problems(BF_SPECS)
    assert len(TF.bucket_indices(probs)) < len(probs)
    got = TF.fleet_brute_force(probs, device="cpu", **BF_KW)
    loop = [OPTIMIZERS["brute_force"](p, device="cpu", **BF_KW)
            for p in _problems(BF_SPECS)]
    numpy = [ref_bf(p, engine="numpy", **BF_KW)
             for p in _problems(BF_SPECS, "repro")]
    jax_fleet = JF.fleet_brute_force(_problems(BF_SPECS, "repro"), **BF_KW)
    for g, lp, nu, jf in zip(got, loop, numpy, jax_fleet):
        assert _same(g, lp)
        _same_search(g, nu, F32_RTOL)
        _same_search(g, jf, F32_RTOL)
        assert g.evaluation.objective == nu.evaluation.objective


@pytest.mark.parametrize("backend", ["spmd", "megatron"])
def test_fleet_annealing_equals_loop(backend):
    """SA over lanes of different node counts, platforms and objectives
    (megatron is strict-KV, so the on-device repair runs): each lane draws
    what its per-problem run draws and ends bitwise where it ends."""
    specs = [_spec("tinyllama-1.1b", backend=backend),
             _spec("jamba-1.5-large-398b", plat="t-2x8", backend=backend,
                   objective="latency"),
             _spec("llama3.2-1b", plat="t-abs16", backend=backend)]
    kw = dict(seed=11, max_iters=150, chains=3)
    probs = _problems(specs)
    assert TF.bucket_indices(probs, tiered=False) == [[0, 1, 2]]
    got = TF.fleet_annealing(probs, device="cpu", **kw)
    loop = [OPTIMIZERS["annealing"](p, device="cpu", **kw)
            for p in _problems(specs)]
    for g, lp in zip(got, loop):
        assert _same(g, lp) and g.name == lp.name == "annealing-torch3"


RB_SPECS = [_spec("tinyllama-1.1b"),
            _spec("tinyllama-1.1b", plat="t-2x8", objective="latency"),
            _spec("llama3.2-1b", plat="t-2x8", objective="latency"),
            _spec("stablelm-3b")]


def test_fleet_rule_based_mixed_platforms_and_objectives():
    """One bucket over mixed platforms and objectives: every problem's
    merge sequence, design, points and history equal the per-problem torch
    loop's, the numpy engine's and the JAX fleet's."""
    from repro.core.optimizers import rule_based as ref_rb
    JF = _jax_fleet()
    probs = _problems(RB_SPECS)
    assert TF.bucket_indices(probs, tiered=False) == [[0, 1, 2, 3]]
    got = TF.fleet_rule_based(probs, device="cpu")
    loop = [OPTIMIZERS["rule_based"](p, device="cpu")
            for p in _problems(RB_SPECS)]
    numpy = [ref_rb(p, engine="numpy") for p in _problems(RB_SPECS, "repro")]
    jax_fleet = JF.fleet_rule_based(_problems(RB_SPECS, "repro"))
    for g, lp, nu, jf in zip(got, loop, numpy, jax_fleet):
        assert _same(g, lp)
        for want in (nu, jf):
            assert (g.points, g.history, g.evaluation.objective) == \
                (want.points, want.history, want.evaluation.objective)
            assert (g.variables.cuts, g.variables.s_in, g.variables.s_out,
                    g.variables.kern) == \
                (want.variables.cuts, want.variables.s_in,
                 want.variables.s_out, want.variables.kern)


def _lane_descents():
    """Three rule-based lanes of one bucket and a request each: a one-node
    partition (converges in a few steps), a whole-graph partition (many
    steps), and the third lane's request, which the caller may mask."""
    specs = [_spec("jamba-1.5-large-398b"),
             _spec("llama3.2-1b", plat="t-2x8"),
             _spec("tinyllama-1.1b", objective="latency")]
    probs = _problems(specs)
    n_pad, pairs_pad, vals_pad, lut_pad, tabs = TF._bucket_tables(probs)
    rbs = [TS.DeviceRuleBased(p, device="cpu", pad_nodes=n_pad,
                              pad_pairs=pairs_pad, pad_vals=vals_pad,
                              pad_lut=lut_pad, tables=tb)
           for p, tb in zip(probs, tabs)]
    reqs = []
    for p in probs:
        v0 = repair(p, p.backend.initial(p.graph))
        reqs.append(v0.with_cuts(()))
    parts = [[3], list(range(len(probs[1].graph.nodes))),
             list(range(len(probs[2].graph.nodes)))]
    return probs, rbs, reqs, parts


def _run_lanes(rbs, reqs, parts, lanes, cap_zero=()):
    packed = [rbs[i].pack_request(reqs[i], parts[i]) for i in lanes]
    cols = list(zip(*packed))
    t = lambda a: torch.from_numpy(np.stack(a))
    cap = np.array([0 if i in cap_zero else c
                    for i, c in zip(lanes, cols[6])], np.int64)
    sub = [rbs[i] for i in lanes]
    st = lambda xs: torch.stack(list(xs))
    from repro_torch.core.accel.lowering import stack_tensors
    out = TS._rb_descend_core(
        sub[0].static, sub[0].gran, stack_tensors([r.A for r in sub]),
        st(r.menus for r in sub), st(r.menu_sizes for r in sub),
        st(r.clamp for r in sub), t(cols[0]), t(cols[1]), t(cols[2]),
        t(cols[3]), t(cols[4]), t(np.array(cols[5], np.int64)),
        st(r.amort for r in sub), torch.from_numpy(cap),
        1 + max(len(reqs[i].cuts) for i in lanes))
    return [x.numpy() for x in out], cols


def test_lane_that_converges_early_is_left_untouched(monkeypatch):
    """In one lane-stacked descent, a lane that converges many steps before
    the others ends exactly where its own descent ends: the steps after its
    convergence carry it through unchanged."""
    _, rbs, reqs, parts = _lane_descents()
    steps = []
    step = TS._rb_step
    monkeypatch.setattr(TS, "_rb_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    alone = []
    for i in range(3):
        steps.clear()
        out, _ = _run_lanes(rbs, reqs, parts, [i])
        alone.append((out, len(steps)))
    steps.clear()
    out, _ = _run_lanes(rbs, reqs, parts, [0, 1, 2])
    assert alone[0][1] < alone[1][1]           # lane 0 converges first
    assert len(steps) == max(n for _, n in alone)
    for i in range(3):
        for got, want in zip(out, alone[i][0]):
            np.testing.assert_array_equal(got[i], want[0])


def test_cap_zero_lane_is_a_no_op():
    """A lane with no request this round (``cap == 0``) keeps its folds
    and scores no points while the other lanes descend."""
    _, rbs, reqs, parts = _lane_descents()
    out, cols = _run_lanes(rbs, reqs, parts, [0, 1, 2], cap_zero=(1,))
    for x, col in zip(out[:3], cols[:3]):
        np.testing.assert_array_equal(x[1], col[1])
    assert out[3][1] == 0
    alone, _ = _run_lanes(rbs, reqs, parts, [2])
    for got, want in zip(out, alone):
        np.testing.assert_array_equal(got[2], want[0])


# ----------------------------------------------------------------------
# one segred launch a step, sweep or chunk
# ----------------------------------------------------------------------

def test_flattened_launch_equals_per_lane_launches(monkeypatch):
    """The lanes of a bucket fold into the rows of ONE segmented reduction,
    which equals reducing each lane on its own; a fleet SA run reduces
    once a sweep whatever the number of lanes."""
    rng = np.random.default_rng(3)
    P, R, n = 4, 6, 13
    vals = torch.from_numpy(rng.random((P, R, n)))
    cuts = rng.random((P, R, n - 1)) < 0.3
    pid = torch.from_numpy(np.concatenate(
        [np.zeros((P, R, 1), np.int64), np.cumsum(cuts, axis=2)], axis=2))
    for op in ("max", "sum"):
        flat = segred.segmented_reduce(vals.reshape(P * R, n),
                                       pid.reshape(P * R, n), op)
        for p in range(P):
            assert torch.equal(flat.view(P, R, n)[p],
                               segred.segmented_reduce(vals[p], pid[p], op))
    calls = []
    plain = segred.segmented_reduce
    monkeypatch.setattr(segred, "segmented_reduce",
                        lambda v, p, op: calls.append(v.shape) or
                        plain(v, p, op))
    specs = [_spec("tinyllama-1.1b", backend="megatron"),
             _spec("jamba-1.5-large-398b", plat="t-2x8",
                   backend="megatron")]
    for k in (1, 2):
        calls.clear()
        TF.fleet_annealing(_problems(specs[:k]), chains=4, max_iters=40,
                           device="cpu")
        assert calls == [(4 * k, 35 if k == 2 else 11)] * 10


# ----------------------------------------------------------------------
# optimise_portfolio
# ----------------------------------------------------------------------

def _shape():
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec(*TINY_SHAPES["train"])


def _plat(name="t-4x4"):
    from repro_torch.core import platform as pl
    cls, kw = PLATFORMS[name]
    return getattr(pl, cls)(name=name, **kw)


def _archs(*names):
    from repro_torch.configs import get_arch, reduced
    return [reduced(get_arch(n)) for n in names]


@pytest.mark.parametrize("optimiser,kw", [
    ("brute_force", dict(include_cuts=True, max_points=800,
                         batch_size=128)),
    ("annealing", dict(seed=5, max_iters=60, chains=2)),
    ("rule_based", {})])
def test_optimise_portfolio_equals_optimise_mapping_loop(optimiser, kw):
    from repro_torch.core.pipeline import optimise_mapping, optimise_portfolio
    archs = _archs("tinyllama-1.1b", "llama3.2-1b", "jamba-1.5-large-398b")
    # (an abstract platform's 16-value menus make 4,096 probes a step)
    plats = [_plat("t-4x4"), _plat("t-2x8"),
             _plat("t-4x4" if optimiser == "rule_based" else "t-abs16")]
    objectives = ["throughput", "latency", "latency"]
    results = []
    plans = optimise_portfolio(archs, _shape(), plats, optimiser=optimiser,
                               objective=objectives, device="cpu",
                               results=results, **kw)
    loop = [optimise_mapping(a, _shape(), p, optimiser=optimiser,
                             objective=o, device="cpu", **kw)
            for a, p, o in zip(archs, plats, objectives)]
    assert plans == loop
    from repro_torch.core.pipeline import make_problem
    for r, a, p, o in zip(results, archs, plats, objectives):
        want = OPTIMIZERS[optimiser](make_problem(a, _shape(), p, "spmd", o),
                                     device="cpu", **kw)
        assert _same(r, want)


def test_optimise_portfolio_validation_and_devices():
    from repro_torch.core.pipeline import optimise_portfolio
    archs, S, PLAT = _archs("tinyllama-1.1b", "tinyllama-1.1b"), _shape(), \
        _plat()
    kw = dict(optimiser="brute_force", engine="numpy", max_points=8,
              batch_size=8)
    with pytest.raises(ValueError, match="shapes"):
        optimise_portfolio(archs, [S] * 3, PLAT, **kw)
    with pytest.raises(ValueError, match="platforms"):
        optimise_portfolio(archs, S, [PLAT], **kw)
    with pytest.raises(ValueError, match="objectives"):
        optimise_portfolio(archs, S, PLAT, objective=["latency"] * 3, **kw)
    with pytest.raises(ValueError, match="single string"):
        optimise_portfolio("tinyllama-1.1b", S, PLAT, **kw)
    with pytest.raises(ValueError, match="shapes must not be a string"):
        optimise_portfolio(archs, "train", PLAT, **kw)
    with pytest.raises(ValueError, match="platform must not be a string"):
        optimise_portfolio(archs, S, "t-4x4", **kw)
    plans = optimise_portfolio(archs, (s for s in [S, S]),
                               (p for p in [PLAT, PLAT]),
                               objective=(o for o in
                                          ["latency", "throughput"]), **kw)
    assert len(plans) == 2
    # devices=: the torch engine's fleets shard their lanes, bitwise the
    # unsharded call; another engine raises as the JAX package's does
    with pytest.raises(ValueError, match="requires the torch engine"):
        optimise_portfolio(archs, S, PLAT, devices=2, **kw)
    torch_kw = dict(kw, engine="torch", device="cpu")
    assert optimise_portfolio(archs, S, PLAT, devices=2, **torch_kw) == \
        optimise_portfolio(archs, S, PLAT, **torch_kw)
    for fleet in (TF.fleet_brute_force, TF.fleet_annealing,
                  TF.fleet_rule_based):
        assert fleet([], devices=2, device="cpu") == []


def test_optimise_portfolio_coalesces_and_routes_budgets_to_the_loop(
        monkeypatch):
    """Duplicates run once (``pipeline.portfolio.coalesced``) on the fleet;
    ``time_budget_s`` takes the per-problem loop with every duplicate; no
    card and no ``device="cpu"`` raises."""
    from repro_torch.core.accel import EngineUnavailable
    from repro_torch.core.pipeline import optimise_portfolio
    from repro_torch.obs import metrics
    archs = _archs("tinyllama-1.1b", "llama3.2-1b", "tinyllama-1.1b")
    seen = []
    real = TF.fleet_rule_based
    monkeypatch.setattr(TF, "fleet_rule_based",
                        lambda ps, **k: seen.append(len(ps)) or real(ps, **k))
    plans = optimise_portfolio(archs, _shape(), _plat(),
                               optimiser="rule_based", device="cpu")
    assert seen == [2] and plans[0] == plans[2]
    assert metrics.counter("pipeline.portfolio.coalesced").value == 1
    seen.clear()
    budget = optimise_portfolio(archs, _shape(), _plat(),
                                optimiser="rule_based", device="cpu",
                                time_budget_s=60.0)
    assert seen == [] and len(budget) == 3
    assert metrics.counter("pipeline.portfolio.coalesced").value == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable):
        optimise_portfolio(archs, _shape(), _plat(), optimiser="rule_based")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("optimiser", ["brute_force", "annealing",
                                       "rule_based"])
def test_card_fleet_equals_card_loop_one_launch_a_step(optimiser,
                                                       monkeypatch):
    """Each fleet on the card equals the card's per-problem loop exactly,
    and launches segred once a sweep (SA), once a chunk of a cut set with
    a cut (brute force) and once an evaluation of a step (rule-based: two
    a step), whatever the number of lanes."""
    _card_or_skip()
    specs = BF_SPECS if optimiser == "brute_force" else RB_SPECS
    kw = {"brute_force": BF_KW,
          "annealing": dict(seed=3, max_iters=256, chains=8),
          "rule_based": {}}[optimiser]
    fleet = {"brute_force": TF.fleet_brute_force,
             "annealing": TF.fleet_annealing,
             "rule_based": TF.fleet_rule_based}[optimiser]
    steps, cut_chunks = [], []
    rb_step, bf_chunk = TS._rb_step, TF._bf_chunk_core
    monkeypatch.setattr(TS, "_rb_step", lambda *a, **k: steps.append(1)
                        or rb_step(*a, **k))
    monkeypatch.setattr(TF, "_bf_chunk_core", lambda *a, **k:
                        cut_chunks.append(not a[2]) or bf_chunk(*a, **k))
    segred.LAUNCHES = 0
    got = fleet(_problems(specs), device="cuda", **kw)
    launches, n_steps, n_cut_chunks = segred.LAUNCHES, len(steps), \
        sum(cut_chunks)
    loop = [OPTIMIZERS[optimiser](p, engine="torch", device="cuda", **kw)
            for p in _problems(specs)]
    for g, lp in zip(got, loop):
        assert _same(g, lp)
    if optimiser == "annealing":
        buckets = len(TF.bucket_indices(_problems(specs), tiered=False))
        assert launches == buckets * 32
    elif optimiser == "brute_force":
        assert 0 < launches == n_cut_chunks
    else:
        assert 0 < launches == 2 * n_steps
