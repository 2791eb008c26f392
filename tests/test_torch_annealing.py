"""Simulated annealing on the port: the host engines (copied) against the
reference's, and the torch engine (``device="cpu"``: the segred kernel's
plain version) against the JAX package's device sweep — sweep by sweep,
both fed the same draws (recomputed from the JAX sweep's keys): the integer
chain state equal after every sweep, objectives at the float32 contract.
In float64 every accepted state re-evaluates through the numpy
``BatchedEvaluator`` to its stored objective at 1e-9. Reduced problems are
built like ``tests/test_accel_engine.py::_problem``."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401
    port_obs_reset,
    problem_pair,
    to_port,
)
from repro.core.optimizers import simulated_annealing as ref_annealing
from repro_torch.core.accel import EngineUnavailable
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel.eval_torch import TorchEvaluator
from repro_torch.core.optimizers import simulated_annealing
from repro_torch.core.optimizers.annealing import LADDER_SPREAD, _scale_for
from repro_torch.core.optimizers.common import repair

#: float32-on-device agreement vs the float64 reference
#: (tests/test_accel_engine.py)
F32_RTOL = 1e-5


def _jax():
    """The JAX package's device modules, imported in the test that needs
    them (JAX_PLATFORMS=cpu here; the card's machine has no jax, and its
    ``-m gpu`` cases need none)."""
    jax = pytest.importorskip("jax")
    from repro.core.accel import search_loops as JS
    return jax, JS


def _start(problem, chains, k_start):
    """The repaired initial design, its evaluation, the objective scale and
    the temperature ladder, as ``_optimise_torch`` makes them."""
    v0 = repair(problem, problem.backend.initial(problem.graph))
    ev0 = problem.evaluate(v0)
    temps = [k_start * (LADDER_SPREAD ** c) for c in range(chains)]
    return v0, ev0, _scale_for(ev0, None), temps


def _jax_draws(jax, key, chains, n_valid):
    """The seven draws of one JAX sweep, recomputed from its key exactly as
    ``_sa_sweep_step`` and ``_masked_choice`` draw them, as the port's
    ``SweepDraws`` (float32 uniforms, int64 integers)."""
    _, kt, kc1, kc2, kc3, kn, km, kacc = jax.random.split(key, 8)
    uni = lambda k: torch.from_numpy(np.array(
        jax.random.uniform(k, (chains,)), np.float32))
    ints = lambda a: torch.from_numpy(np.array(a, np.int64))
    return TS.SweepDraws(
        r2=uni(kc1), u_rem=uni(kc2), u_add=uni(kc3),
        i=ints(jax.random.randint(kn, (chains,), 0, n_valid)),
        fold=ints(jax.random.randint(km, (8, 3, chains), 0, 1 << 30)),
        r_type=uni(kt), u=uni(kacc))


#: (arch, mode, backend, start marked feasible): every backend, a
#: strict-KV scan-tied graph, and a start marked infeasible (as the
#: full-width streaming / throughput request's is), so that the first
#: feasible proposal must take every chain's incumbent
SWEEP_CASES = [
    ("tinyllama-1.1b", "train", "simple", True),
    ("tinyllama-1.1b", "train", "megatron", True),
    ("tinyllama-1.1b", "train", "spmd", True),
    ("tinyllama-1.1b", "train", "spmd", False),
    ("jamba-1.5-large-398b", "decode", "megatron", True),
    ("jamba-1.5-large-398b", "decode", "spmd", True),
]


def _assert_incumbents_equal_or_tied(problem, got, want, label):
    """Each chain's incumbent design in ``got`` equals the one in ``want``,
    or both designs have the same float64 objective and feasibility: a tie
    that rounding broke differently (two engines' objectives may differ in
    the last bit, and ``p_obj < best_obj`` is strict). Returns the number
    of tied chains."""
    names = ("best_si", "best_so", "best_kk", "best_cb")
    g = [np.asarray(got[x]) for x in names]
    w = [np.asarray(want[x]) for x in names]
    differ = np.zeros(g[0].shape[0], bool)
    for a, b in zip(g, w):
        differ |= (a != b).any(axis=1)
    rows = np.nonzero(differ)[0]
    if len(rows):
        bev = problem.batched()
        rg = bev.evaluate_batch(*(a[rows] for a in g))
        rw = bev.evaluate_batch(*(b[rows] for b in w))
        np.testing.assert_array_equal(rg.feasible, rw.feasible,
                                      err_msg=label)
        np.testing.assert_allclose(rg.objective, rw.objective, rtol=1e-12,
                                   err_msg=label)
    return len(rows)


@pytest.mark.parametrize("arch,mode,backend,feasible", SWEEP_CASES)
def test_sweeps_equal_jax_under_injected_draws(arch, mode, backend,
                                               feasible):
    """40 sweeps of 16 chains on a ladder from K = 5 (hot chains accept
    most moves, cold ones reject many): after every sweep the port's chain
    folds, cuts and feasibility equal JAX's, objectives within the float32
    contract. The incumbents equal JAX's too, except where a proposal ties
    the incumbent in float64 and float32 rounding breaks the tie the other
    way (``_assert_incumbents_equal_or_tied``)."""
    jax, JS = _jax()
    ref, port = problem_pair(arch, mode, backend=backend,
                             objective="latency", exec_model="spmd")
    C, sweeps, cooling, k_min = 16, 40, 0.95, 1.0
    jsa, tsa = JS.DeviceSA(ref), TS.DeviceSA(port, device="cpu")
    v0, ev0, scale, temps = _start(ref, C, 5.0)
    if not feasible:
        ev0 = SimpleNamespace(objective=ev0.objective, feasible=False)
    j_state = jsa.init_state(v0, ev0, C, seed=3)
    j_temps = jax.numpy.asarray(temps, jax.numpy.float32)
    t_state = tsa.init_state(to_port(v0), ev0, C, seed=3)
    t_temps = torch.tensor(temps, dtype=torch.float32)
    folds = lambda st: torch.cat([st[x].to(torch.int64)
                                  for x in ("si", "so", "kk", "cb")], dim=1)
    accepted = 0
    for k in range(sweeps):
        dr = _jax_draws(jax, j_state["key"], C, jsa.A.n_valid)
        before = folds(t_state)
        j_state, j_temps, _ = JS._sa_sweeps(
            jsa.static, jsa.gran, jsa.has_cut_edges, 1, jsa.A, jsa.menus,
            jsa.menu_sizes, jsa.clamp, jsa.kv_fix, j_state, j_temps, scale,
            cooling, k_min)
        t_state, t_temps, (t_obj, t_feas) = tsa.run(
            t_state, t_temps, scale, cooling, k_min, 1, draws=[dr])
        assert t_obj.shape == (1, C) and t_feas.shape == (1, C)
        label = f"after sweep {k}"
        for name in ("si", "so", "kk", "cb", "feas", "best_feas"):
            np.testing.assert_array_equal(
                t_state[name].numpy(), np.asarray(j_state[name]),
                err_msg=f"{name} {label}")
        _assert_incumbents_equal_or_tied(port, t_state, j_state, label)
        for name in ("obj", "best_obj"):
            np.testing.assert_allclose(
                t_state[name].numpy(), np.asarray(j_state[name]),
                rtol=F32_RTOL, err_msg=f"{name} {label}")
        np.testing.assert_array_equal(t_temps.numpy(), np.asarray(j_temps))
        accepted += int((folds(t_state) != before).any(dim=1).sum())
    assert accepted > 0 and bool(t_state["best_feas"].all())


@pytest.mark.parametrize("backend", ["megatron", "spmd"])
def test_float64_accepted_states_reevaluate_at_1e9(backend):
    """In float64, after every sweep, each chain's state and incumbent
    re-evaluate through the numpy ``BatchedEvaluator`` to their stored
    objective at 1e-9, with the stored feasibility."""
    _, port = problem_pair("jamba-1.5-large-398b", "decode",
                           backend=backend, objective="latency",
                           exec_model="spmd")
    C = 8
    sa = TS.DeviceSA(port, device="cpu", dtype=torch.float64)
    v0, ev0, scale, temps = _start(port, C, 5.0)
    state = sa.init_state(v0, ev0, C, seed=5)
    temps = torch.tensor(temps, dtype=torch.float64)
    bev = port.batched()
    for k in range(30):
        state, temps, _ = sa.run(state, temps, scale, 0.95, 1.0, 1)
        for pre in ("", "best_"):
            res = bev.evaluate_batch(*(state[pre + x].numpy()
                                       for x in ("si", "so", "kk", "cb")))
            np.testing.assert_array_equal(res.feasible,
                                          state[pre + "feas"].numpy())
            np.testing.assert_allclose(state[pre + "obj"].numpy(),
                                       res.objective, rtol=1e-9,
                                       err_msg=f"{pre}obj, sweep {k}")


def test_masked_choice_matches_jax():
    """The k-th True entry for a uniform draw, empty rows giving 0."""
    jax, JS = _jax()
    rng = np.random.default_rng(11)
    for cols in (1, 5, 46):
        mask = rng.random((64, cols)) < rng.random((64, 1))
        mask[:3] = False                       # empty rows
        mask[3] = True
        key = jax.random.PRNGKey(cols)
        want = JS._masked_choice(key, jax.numpy.asarray(mask))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
        got = TS._masked_choice(u, torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got[:3] == 0).all()


@pytest.mark.parametrize("backend", ["simple", "megatron", "spmd"])
def test_repair_matches_jax(backend):
    """``repair_torch`` against ``repair_jax`` on random folds (s_out drawn
    past the KV limits too) and random legal cuts: megatron clamps and
    propagates, spmd (not strict-KV) returns its inputs."""
    jax, JS = _jax()
    from repro.core.accel.eval_jax import JaxEvaluator
    # full width: the reduced graphs' KV limits leave kv_fix at 1
    ref, port = problem_pair("tinyllama-1.1b", "decode", backend=backend,
                             reduce=False)
    jev = JaxEvaluator.from_problem(ref)
    tev = TorchEvaluator.from_problem(port, device="cpu")
    menus, sizes, _, kv_fix, _, _ = TS.build_sa_tables(port)
    assert (kv_fix > 1).any() or backend == "simple"   # s_out fixed at 1
    rng = np.random.default_rng(len(backend))
    C, n = 64, len(port.graph.nodes)
    pick = lambda vi: np.take_along_axis(
        menus[vi], rng.integers(0, sizes[vi][:, None], (n, C)), 1).T
    si, so, kk = pick(0), pick(1), pick(2)
    cb = (rng.random((C, n - 1)) < 0.2) & \
        np.asarray(jev.arrays.cut_allowed)[None, :]
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))
    j = jax.numpy.asarray
    got = TS.repair_torch(tev.static, tev.arrays, t(kv_fix), t(si), t(so),
                          t(kk), torch.from_numpy(cb))
    want = JS.repair_jax(jev.static, jev.arrays, j(kv_fix), j(si), j(so),
                         j(kk), j(cb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if backend == "spmd":
        assert all(np.array_equal(g.numpy(), x)
                   for g, x in zip(got, (si, so, kk)))
    elif backend == "megatron":                # simple fixes s_out at 1
        assert not np.array_equal(got[1].numpy(), so)


def test_fixed_seed_determinism_and_per_chain_incumbents():
    """A seed fixes the path; another seed changes it. Every chain's
    incumbent round-trips through the scalar reference."""
    _, port = problem_pair("tinyllama-1.1b", "train", objective="latency",
                           exec_model="spmd")
    kw = dict(max_iters=300, chains=4, device="cpu")
    r1 = simulated_annealing(port, seed=7, **kw)
    r2 = simulated_annealing(port, seed=7, **kw)
    assert (r1.variables, r1.history, r1.points) == \
        (r2.variables, r2.history, r2.points)
    assert r1.points == 300 and r1.evaluation.feasible
    assert r1.name == "annealing-torch4"

    sa = TS.DeviceSA(port, device="cpu")
    v0, ev0, scale, temps = _start(port, 3, 1000.0)
    traces = {}
    for seed in (11, 11, 12):
        state = sa.init_state(v0, ev0, 3, seed)
        state, _, tr = sa.run(state, torch.tensor(temps), scale, 0.98, 1.0,
                              150)
        traces.setdefault(seed, []).append(
            (tr[0].numpy(), state["si"].numpy()))
    (o1, s1), (o2, s2) = traces[11]
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(traces[12][0][0], o1)
    incumbents = sa.best_variables(state)
    assert len(incumbents) == 3
    for v, obj, feas in incumbents:
        ev = port.evaluate(v)
        assert ev.feasible == feas
        if feas:
            assert ev.objective == pytest.approx(obj, rel=F32_RTOL)
            assert ev.objective <= ev0.objective + 1e-12


@pytest.mark.parametrize("chains", [1, 4])
@pytest.mark.parametrize("backend", ["megatron", "spmd"])
def test_host_engines_equal_reference(backend, chains):
    """The copied host engines walk the reference's path for a seed:
    ``host`` (and ``scalar`` by name) with one chain, tempering with
    four."""
    kw = dict(seed=5, chains=chains, max_iters=240)
    ref, port = problem_pair("tinyllama-1.1b", "train", backend=backend,
                             objective="latency", exec_model="spmd")
    want = ref_annealing(ref, engine="host", **kw)
    for engine in ("host", "scalar"):
        _, port = problem_pair("tinyllama-1.1b", "train", backend=backend,
                               objective="latency", exec_model="spmd")
        got = simulated_annealing(port, engine=engine, **kw)
        assert got.variables == to_port(want.variables)
        assert got.history == want.history
        assert got.points == want.points and got.name == want.name
        assert got.evaluation.objective == want.evaluation.objective


def test_optimise_mapping_plans_equal_repro(monkeypatch):
    """Through ``optimise_mapping``: the host engine's plan is the
    reference's for a seed; the torch engine's plan is the reference's
    ``export_plan`` of the design the port's SA returns."""
    from repro.configs import get_arch as r_arch, reduced as r_reduced
    from repro.configs.base import ShapeSpec as RShape
    from repro.core.exporter import export_plan as r_export
    from repro.core.pipeline import make_problem as r_make
    from repro.core.pipeline import optimise_mapping as r_optimise
    from repro.core.platform import Platform as RPlat
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import make_problem, optimise_mapping
    from repro_torch.core.platform import Platform
    from test_torch_rule_based import _plan_fields

    mesh = (("data", 4), ("model", 4))
    r_args = (r_reduced(r_arch("whisper-small")),
              RShape("train_tiny", 256, 16, "train"),
              RPlat(name="t-4x4", mesh_axes=mesh))
    t_args = (reduced(get_arch("whisper-small")),
              ShapeSpec("train_tiny", 256, 16, "train"),
              Platform(name="t-4x4", mesh_axes=mesh))
    kw = dict(backend="megatron", objective="latency", exec_model="spmd")
    sa = dict(seed=2, chains=4, max_iters=200)
    want = r_optimise(*r_args, optimiser="annealing", engine="host", **kw,
                      **sa)
    got = optimise_mapping(*t_args, optimiser="annealing", engine="host",
                           **kw, **sa)
    assert _plan_fields(got) == _plan_fields(want)

    got = optimise_mapping(*t_args, optimiser="annealing", engine="torch",
                           device="cpu", **kw, **sa)
    res = simulated_annealing(make_problem(*t_args, **kw), device="cpu",
                              **sa)
    ref = r_make(*r_args, **kw)
    v = res.variables
    from repro.core.hdgraph import Variables as RVariables
    rv = RVariables(v.cuts, v.s_in, v.s_out, v.kern)
    want = r_export(ref.graph, rv, ref.platform, "spmd", ref.evaluate(rv))
    assert _plan_fields(got) == _plan_fields(want)


def test_engine_selection_and_errors(monkeypatch):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import optimise_mapping
    _, port = problem_pair("tinyllama-1.1b", "train")
    with pytest.raises(ValueError, match="unknown engine"):
        simulated_annealing(port, engine="jax")
    with pytest.raises(ValueError, match="device= applies"):
        simulated_annealing(port, engine="host", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"engine": "auto"}, {"engine": "torch"}):
        with pytest.raises(EngineUnavailable):
            simulated_annealing(port, max_iters=4, **kw)
    with pytest.raises(EngineUnavailable):
        optimise_mapping(reduced(get_arch("tinyllama-1.1b")),
                         ShapeSpec("train_tiny", 256, 16, "train"),
                         optimiser="annealing")


def _card_draws(gen, chains, n_valid, sweeps):
    """float64 draws from a CPU generator, for a run on both devices."""
    return [TS.sa_draws(gen, chains, n_valid, torch.float64)
            for _ in range(sweeps)]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["megatron", "spmd"])
def test_card_sweeps_equal_cpu_sweeps_float64(backend):
    """The same float64 draws on the card and on the CPU: the chains'
    folds, cuts and feasibility equal after every sweep, objectives within
    1e-9, incumbents equal or tied in the float64 re-evaluation (the last
    bit of a sum, cuBLAS's order against the CPU's, can break a tie either
    way); the card's run launches segred and, under
    ``set_sync_debug_mode("error")``, never waits on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")
    from repro_torch.core.accel import segred
    _, port = problem_pair("jamba-1.5-large-398b", "decode",
                           backend=backend, objective="latency",
                           exec_model="spmd")
    C = 16
    runs = {}
    for dev in ("cpu", "cuda"):
        sa = TS.DeviceSA(port, device=dev, dtype=torch.float64)
        v0, ev0, scale, temps = _start(port, C, 5.0)
        state = sa.init_state(v0, ev0, C, seed=0)
        runs[dev] = (sa, state,
                     torch.tensor(temps, dtype=torch.float64, device=dev))
    draws = _card_draws(torch.Generator().manual_seed(4), C,
                        len(port.graph.nodes), 40)
    segred.LAUNCHES = 0
    for k, dr in enumerate(draws):
        out = {}
        for dev, (sa, state, temps) in runs.items():
            d = TS.SweepDraws(*(x.to(dev) for x in dr))
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, temps, _ = sa.run(state, temps, scale, 0.95, 1.0,
                                         1, draws=[d])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            runs[dev] = (sa, state, temps)
            out[dev] = {kk: v.cpu() for kk, v in state.items()
                        if kk != "gen"}
        for name in ("si", "so", "kk", "cb", "feas", "best_feas"):
            assert torch.equal(out["cuda"][name], out["cpu"][name]), \
                (name, k)
        _assert_incumbents_equal_or_tied(port, out["cuda"], out["cpu"],
                                         f"sweep {k}")
        for name in ("obj", "best_obj"):
            np.testing.assert_allclose(out["cuda"][name].numpy(),
                                       out["cpu"][name].numpy(), rtol=1e-9)
    assert segred.LAUNCHES >= len(draws)
