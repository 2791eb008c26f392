"""The port's co-mapping (``repro_torch.core.comap``,
``core/accel/comap_fleet.py``, ``pipeline.optimise_comapping``) held
against the JAX package on the CPU.

For reduced nets on a 4x4 mesh (``tests/test_comap.py``'s problems), the
port's ``joint_search(engine="torch", device="cpu")`` gives the same split,
per-net designs, composite objective, points and history as repro's numpy
engine and as repro's jax engine (the JAX co-map fleet), for brute force
and rule based, and is bitwise the port's per-lane torch loop, for every
composite objective. Where a lane's float32 descent walks another move
sequence than the float64 numpy engine (a float32 near-tie, ROADMAP Queue
3), the port must equal the JAX engine, which shares its float32
arithmetic: the joint results are compared with the JAX engine's exactly
in every case, and with the numpy engine's exactly too, since no such tie
falls in these problems. SA is held to determinism for a seed, to its
per-lane loop bitwise, and to the numpy engine's float64 re-evaluation of
every lane's incumbent. The card-only case runs the joint search on the
card against the CPU."""
import math

import numpy as np
import pytest
import torch

from _torch_support import TINY_SHAPES, port_obs_reset  # noqa: F401
from repro_torch.core import comap as TCM
from repro_torch.core import pipeline as TP
from repro_torch.core.accel import EngineUnavailable, comap_fleet
from repro_torch.core.accel import fleet as TF
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel import segred
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.obs import metrics

#: float32-on-device agreement of recorded objectives with float64
F32_RTOL = 1e-5
MESH = (("data", 4), ("model", 4))
COMAP_OBJECTIVES = ("weighted_throughput", "worst_latency",
                    "maxmin_throughput")


def _archs(package, n=2):
    from importlib import import_module
    cfg = import_module(f"{package}.configs")
    names = ["tinyllama-1.1b", "llama3.2-1b", "granite-moe-1b-a400m"]
    return [cfg.reduced(cfg.get_arch(names[i % 3]), num_layers=2)
            for i in range(n)]


def _cp(package="repro_torch", n=2, **kw):
    """``tests/test_comap.py``'s co-mapping problem, built by ``package``."""
    from importlib import import_module
    base = import_module(f"{package}.configs.base")
    pipe = import_module(f"{package}.core.pipeline")
    plat = import_module(f"{package}.core.platform")
    return pipe.make_comap_problem(
        _archs(package, n), base.ShapeSpec(*TINY_SHAPES["train"]),
        plat.Platform(name="t", mesh_axes=MESH), **kw)


def _jax_comap():
    pytest.importorskip("jax")
    from repro.core import comap as JCM
    return JCM


def _fields(r):
    """Split, per-net designs, composite, points and history."""
    return (r.split_index, r.split, r.evaluation.objective,
            r.evaluation.feasible, r.points, r.history,
            [(tuple(x.variables.cuts), tuple(x.variables.s_in),
              tuple(x.variables.s_out), tuple(x.variables.kern))
             for x in r.per_net])


def _bitwise(a, b):
    """The joint fields and every per-net result, exactly."""
    return _fields(a) == _fields(b) and all(
        (x.points, x.history, x.evaluation.objective) ==
        (y.points, y.history, y.evaluation.objective)
        for x, y in zip(a.per_net, b.per_net))


def test_comap_objectives_are_the_reference_s():
    from repro.core.objectives import COMAP_OBJECTIVES as ref
    from repro_torch.core.objectives import COMAP_OBJECTIVES as port
    assert tuple(port) == tuple(ref) == COMAP_OBJECTIVES


@pytest.mark.parametrize("objective", COMAP_OBJECTIVES)
@pytest.mark.parametrize("optimiser,kw", [
    ("brute_force", dict(max_points=150, batch_size=64)),
    ("rule_based", {}),
])
def test_joint_search_equals_numpy_jax_and_the_lane_loop(optimiser, kw,
                                                         objective):
    """The fleet joint search equals repro's numpy and jax engines and is
    bitwise the port's per-lane loop (``time_budget_s=None``, outside the
    fleet's kwargs, forces the loop)."""
    JCM = _jax_comap()
    weights = None if objective == "worst_latency" else [2.0, 1.0]
    got = TCM.joint_search(_cp(objective=objective, weights=weights),
                           optimiser=optimiser, engine="torch",
                           device="cpu", **kw)
    loop = TCM.joint_search(_cp(objective=objective, weights=weights),
                            optimiser=optimiser, engine="torch",
                            device="cpu", time_budget_s=None, **kw)
    assert _bitwise(got, loop)
    assert got.evaluation.feasible and got.history
    rcp = lambda: _cp("repro", objective=objective, weights=weights)
    for engine in ("numpy", "jax"):
        want = JCM.joint_search(rcp(), optimiser=optimiser, engine=engine,
                                **kw)
        g, w = _fields(got), _fields(want)
        if optimiser == "brute_force":
            # history objectives are the float32 chunk values
            assert [p for p, _ in got.history] == \
                [p for p, _ in want.history], engine
            np.testing.assert_allclose([o for _, o in got.history],
                                       [o for _, o in want.history],
                                       rtol=F32_RTOL)
            g, w = g[:5] + g[6:], w[:5] + w[6:]
        assert g == w, engine


def test_joint_search_is_one_fleet_call_in_lane_order(monkeypatch):
    """All S x N lanes go through ONE call of the fleet entry point, split
    major, and each lane's result is the fleet's; the descent reduces with
    segred twice a lockstep step whatever the lane count."""
    calls, outs, steps, reduces = [], [], [], []
    fleet, step, plain = TF.fleet_rule_based, TS._rb_step, \
        segred.segmented_reduce

    def spy(lanes, **kw):
        calls.append(lanes)
        outs.append(fleet(lanes, **kw))
        return outs[-1]

    monkeypatch.setattr(comap_fleet, "_FLEETS",
                        dict(comap_fleet._FLEETS, rule_based=spy))
    monkeypatch.setattr(TS, "_rb_step", lambda *a, **k: steps.append(1)
                        or step(*a, **k))
    monkeypatch.setattr(segred, "segmented_reduce",
                        lambda v, p, op: reduces.append(v.shape[0])
                        or plain(v, p, op))
    cp = _cp()
    got = TCM.joint_search(cp, optimiser="rule_based", engine="torch",
                           device="cpu")
    S, N = len(cp.resolved_splits()), cp.n_nets
    assert len(calls) == 1 and len(calls[0]) == S * N == 6
    for k, lane in enumerate(calls[0]):
        assert lane.platform == cp.subproblem(k // N, k % N).platform
    assert len(reduces) == 2 * len(steps) > 0
    # [P, n] at the incumbent, then [P x probes, n]; P = S x N lanes
    assert set(reduces[::2]) == {S * N}
    snap = metrics.snapshot()["counters"]
    assert snap["comap.lanes"] == S * N
    assert snap["optim.rule_based[fleet].runs"] == S * N
    assert snap["comap.searches"] == 1
    s = got.split_index
    assert all(x is y for x, y in zip(got.per_net,
                                      outs[0][s * N:(s + 1) * N]))


def test_annealing_fleet_is_its_lane_loop_and_deterministic():
    """SA: the fleet joint search is bitwise its per-lane loop and the
    same for a seed; every lane's incumbent, re-evaluated in float64 by
    repro's numpy engine, has the card engine's feasibility and its float32
    objective within 1e-5."""
    kw = dict(seed=3, max_iters=30, chains=2)
    cp = _cp()
    lanes = [cp.subproblem(s, i) for s in range(len(cp.resolved_splits()))
             for i in range(cp.n_nets)]
    got = comap_fleet.fleet_comap(lanes, "annealing", device="cpu", **kw)
    again = TCM.joint_search(_cp(), optimiser="annealing", engine="torch",
                             device="cpu", **kw)
    loop = TCM.joint_search(_cp(), optimiser="annealing", engine="torch",
                            device="cpu", time_budget_s=None, **kw)
    assert _bitwise(again, loop)
    # the same seed gives the same lanes: the fleet call made here again
    # inside the joint search
    N, s = cp.n_nets, again.split_index
    assert again.points == sum(r.points for r in got)
    for x, y in zip(again.per_net, got[s * N:(s + 1) * N]):
        assert (x.variables, x.points, x.history) == \
            (y.variables, y.points, y.history)
    rcp = _cp("repro")
    for k, r in enumerate(got):
        ref = rcp.subproblem(k // cp.n_nets, k % cp.n_nets)
        bev = ref.batched()
        want = bev.evaluate_batch(*bev.pack([r.variables]))
        assert bool(want.feasible[0]) == r.evaluation.feasible
        assert r.evaluation.objective == ref.evaluate(r.variables).objective
        if r.evaluation.feasible:
            assert r.history[-1][1] == pytest.approx(
                float(want.objective[0]), rel=F32_RTOL)


def test_optimise_comapping_plans_and_infeasible_menu():
    """One ShardingPlan a net against its own sub-platform, objective
    values the lanes', equal to repro's numpy plan; five nets on four rows
    give no plans and ``objective_value == inf`` without raising."""
    pytest.importorskip("jax")
    from repro.configs.base import ShapeSpec as RShape
    from repro.core import pipeline as RP
    from repro.core import platform as RPl
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.platform import Platform
    shape, plat = ShapeSpec(*TINY_SHAPES["train"]), \
        Platform(name="t", mesh_axes=MESH)
    plan = TP.optimise_comapping(_archs("repro_torch"), shape, plat,
                                 device="cpu")
    want = RP.optimise_comapping(_archs("repro"),
                                 RShape(*TINY_SHAPES["train"]),
                                 RPl.Platform(name="t", mesh_axes=MESH),
                                 engine="numpy")
    assert plan.feasible and len(plan.plans) == 2
    assert (plan.split_index, plan.split, plan.objective_value) == \
        (want.split_index, want.split, want.objective_value)
    assert sum(p.platform.chips for p in plan.plans) == plat.chips
    for p, w, r in zip(plan.plans, want.plans, plan.result.per_net):
        assert p.objective_value == r.evaluation.objective == \
            w.objective_value
        assert p.platform.mesh_axes == w.platform.mesh_axes
        assert len(p.partitions) == len(w.partitions)
    bad = TP.optimise_comapping(_archs("repro_torch", 5), shape, plat,
                                device="cpu")
    assert not bad.feasible and bad.plans == () and bad.split_index == -1
    assert bad.objective_value == math.inf
    assert any("cannot host 5 nets" in m
               for m in bad.result.evaluation.violations)


def test_over_budget_user_split_rejected_inside_candidate():
    cp = _cp(splits=[(2, 2), (4, 4)])
    assert any("shared budget" in m for m in cp.budget_violations(1))
    r = TCM.joint_search(cp, optimiser="rule_based", engine="torch",
                         device="cpu")
    assert r.split_index == 0 and r.split == (2, 2)


def test_rule_based_terminates_on_non_pow2_submesh():
    """The 3-row sub-mesh that made the reference's merge loop livelock
    terminates on the torch engine, equal to repro's numpy engine."""
    from repro.core.optimizers import OPTIMIZERS as ROPT
    sub = _cp().subproblem(0, 1)
    assert sub.platform.mesh_axes[0] == ("data", 3)
    r = OPTIMIZERS["rule_based"](sub, device="cpu")
    want = ROPT["rule_based"](_cp("repro").subproblem(0, 1),
                              engine="numpy")
    assert r.evaluation.feasible
    assert (r.variables.cuts, r.variables.s_in, r.variables.s_out,
            r.variables.kern, r.points, r.history) == \
        (want.variables.cuts, want.variables.s_in, want.variables.s_out,
         want.variables.kern, want.points, want.history)


def test_engines_devices_and_no_fallback(monkeypatch):
    """``jax`` is an unknown engine here; ``devices=2`` shards the fleet's
    lanes, bitwise the unsharded search; with no card and no
    ``device="cpu"`` the torch engine raises ``EngineUnavailable`` instead
    of running on the CPU."""
    with pytest.raises(ValueError, match="unknown engine"):
        TCM.joint_search(_cp(), engine="jax")
    with pytest.raises(ValueError, match="unknown optimiser"):
        TCM.joint_search(_cp(), optimiser="magic")
    kw = dict(engine="torch", multi_start=False, device="cpu")
    assert _bitwise(TCM.joint_search(_cp(), devices=2, **kw),
                    TCM.joint_search(_cp(), **kw))
    from repro_torch.configs.base import ShapeSpec
    plans = [TP.optimise_comapping(_archs("repro_torch"),
                                   ShapeSpec(*TINY_SHAPES["train"]),
                                   devices=devices, **kw).plans
             for devices in (2, None)]
    assert plans[0] == plans[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable):
        TCM.joint_search(_cp(), optimiser="rule_based")
    assert set(TCM.FLEET_KWARGS) == set(TP.FLEET_KWARGS)
    for k, v in TCM.FLEET_KWARGS.items():
        assert v == TP.FLEET_KWARGS[k]


@pytest.mark.gpu
def test_card_joint_search_equals_cpu_two_launches_a_step(monkeypatch):
    """On the card, the rule-based joint search is bitwise the CPU's, and
    K1 launches twice a lockstep step of the fleet."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")
    steps = []
    step = TS._rb_step
    monkeypatch.setattr(TS, "_rb_step", lambda *a, **k: steps.append(1)
                        or step(*a, **k))
    segred.LAUNCHES = 0
    got = TCM.joint_search(_cp(), optimiser="rule_based", engine="torch",
                           device="cuda")
    launches, n_steps = segred.LAUNCHES, len(steps)
    cpu = TCM.joint_search(_cp(), optimiser="rule_based", engine="torch",
                           device="cpu")
    assert _bitwise(got, cpu)
    assert 0 < launches == 2 * n_steps
