"""Brute force on the port's torch engine (``device="cpu"``: the segred
kernel's plain version) against the JAX package: the copied numpy helpers,
the chunk decode and evaluation, and whole runs against the numpy and jax
engines — identical points, optimum and history indices, objectives at the
float32 contract (float64: 1e-9) — on reduced problems built like
``tests/test_accel_engine.py::_problem``."""
import math
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401
    MESH_4X4,
    port_obs_reset,
    problem_pair,
    to_port,
)
from repro.core.optimizers import brute_force as ref_brute_force
from repro_torch.core.accel import EngineUnavailable
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel.eval_torch import TorchEvaluator
from repro_torch.core.optimizers import brute_force

#: the optimiser modules (the packages' ``brute_force`` attribute is the
#: entry point, which shadows the module for ``import ... as``)
JBF = import_module("repro.core.optimizers.brute_force")
TBF = import_module("repro_torch.core.optimizers.brute_force")

#: float32-on-device agreement vs the float64 reference
#: (tests/test_accel_engine.py)
F32_RTOL = 1e-5


def _jax():
    """The JAX package's device modules, imported in the test that needs
    them (JAX_PLATFORMS=cpu here; the card's machine has no jax, and its
    ``-m gpu`` cases need none)."""
    jax = pytest.importorskip("jax")
    from repro.core.accel import search_loops as JS
    from repro.core.accel.eval_jax import JaxEvaluator
    return jax.numpy, JS, JaxEvaluator


def _space(problem):
    slots, menus = problem.backend.space(problem.graph, problem.platform)
    sizes = [len(m) for m in menus]
    strides = [1] * len(slots)
    for s in range(len(slots) - 2, -1, -1):
        strides[s] = strides[s + 1] * sizes[s + 1]
    return slots, menus, sizes, strides


def _some_cut_sets(problem):
    """The empty cut set, one cut and two cuts (where the graph has them)."""
    edges = problem.graph.cut_edges
    return [(), tuple(edges[:1]), tuple(edges[1:3])]


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("backend", ["simple", "megatron", "spmd"])
def test_numpy_helpers_equal_jax(backend, mode):
    """``_construction_tables``, ``chunk_descriptor`` and
    ``absorb_improvements`` of the port return the JAX package's."""
    _, JS, _ = _jax()
    ref, port = problem_pair("jamba-1.5-large-398b", mode, backend=backend)
    slots, menus, sizes, strides = _space(ref)
    base_r = ref.backend.initial(ref.graph).with_cuts(())
    base_p = port.backend.initial(port.graph).with_cuts(())
    for cuts in _some_cut_sets(ref):
        scopes = JBF._slot_scopes(ref.backend, ref.graph, slots, cuts)
        tabs = JBF._clamp_tables(ref.graph, slots, scopes, menus)
        p_scopes = TBF._slot_scopes(port.backend, port.graph, slots, cuts)
        p_tabs = TBF._clamp_tables(port.graph, slots, p_scopes, menus)
        assert p_scopes == scopes
        want = JS._construction_tables(ref.graph, ref.backend, slots, scopes,
                                       tabs, menus, cuts, base_r,
                                       max(sizes), np.int64)
        got = TS._construction_tables(port.graph, port.backend, slots,
                                      p_scopes, p_tabs, menus, cuts, base_p,
                                      max(sizes), np.int64)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    total = math.prod(sizes)
    for produced, take in ((0, 256), (total // 3, 64), (max(total - 5, 0), 5),
                           (17, 1)):
        for idt in (np.int32, np.int64):
            want = JS.chunk_descriptor(strides, sizes, produced, take,
                                       len(slots) + 2, idt)
            got = TS.chunk_descriptor(strides, sizes, produced, take,
                                      len(slots) + 2, idt)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(len(backend) + len(mode))
    objs = np.where(rng.random(300) < 0.5, np.inf, rng.random(300))
    for best in (np.inf, 0.3):
        h_want, h_got = [(1, 0.5)], [(1, 0.5)]
        assert TS.absorb_improvements(objs, best, 40, h_got) == \
            JS.absorb_improvements(objs, best, 40, h_want)
        assert h_got == h_want


def _digits_direct(strides, sizes, produced, B):
    """The mixed-radix digits of global indices produced .. produced+B-1,
    with Python ints (any size)."""
    return np.array([[(produced + off) // st % sz
                      for st, sz in zip(strides, sizes)] + [0]
                     for off in range(B)], np.int64)


@pytest.mark.parametrize("case", ["slow", "fast", "mixed", "above_2_31",
                                  "above_2_63"])
def test_decode_digits_equal_jax(case):
    """``_bf_decode_digits`` against the JAX decode (int32) and against the
    direct decode of the global index: slow slots (at most one carry in the
    chunk), fast slots (periodic), both, and spaces above 2^31 and 2^63
    (the host reduces the index before it builds the descriptor)."""
    jnp, JS, _ = _jax()
    sizes, produced, B = {
        "slow": ([5, 4, 3], 7, 4),
        "fast": ([2, 3, 4, 5], 13, 64),
        "mixed": ([6, 5, 4, 3, 2], 301, 32),
        "above_2_31": ([7] * 12, 7 ** 11 * 3 + 12345, 256),
        "above_2_63": ([13] * 18, 13 ** 17 * 5 + 987654321, 128),
    }[case]
    strides = [1] * len(sizes)
    for s in range(len(sizes) - 2, -1, -1):
        strides[s] = strides[s + 1] * sizes[s + 1]
    want_direct = _digits_direct(strides, sizes, produced, B)
    for take in (B, B - 1):
        d32 = JS.chunk_descriptor(strides, sizes, produced, take, len(sizes),
                                  np.int32)
        d64 = TS.chunk_descriptor(strides, sizes, produced, take, len(sizes),
                                  np.int64)
        want = np.asarray(JS._bf_decode_digits(B, jnp.int32,
                                               jnp.asarray(d32)))
        got = TS._bf_decode_digits(B, torch.int64,
                                   torch.from_numpy(d64)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:take], want_direct[:take])


def _chunk_inputs(problem, cuts, produced, B, idt):
    """One chunk's descriptor, tables, cut row and take, from the port's
    helpers (int64) or the JAX package's (int32)."""
    slots, menus, sizes, strides = _space(problem)
    base = problem.backend.initial(problem.graph).with_cuts(())
    mod = TBF if idt == np.int64 else JBF
    loops = TS if idt == np.int64 else _jax()[1]
    scopes = mod._slot_scopes(problem.backend, problem.graph, slots, cuts)
    tabs = mod._clamp_tables(problem.graph, slots, scopes, menus)
    sigma, T = loops._construction_tables(problem.graph, problem.backend,
                                          slots, scopes, tabs, menus, cuts,
                                          base, max(sizes), idt)
    total = math.prod(sizes)
    take = min(B, total - produced)
    desc = loops.chunk_descriptor(strides, sizes, produced, take, len(slots),
                                  idt)
    cb_row = np.zeros(len(problem.graph.nodes) - 1, bool)
    cb_row[list(cuts)] = True
    return desc, sigma, T, cb_row, take


@pytest.mark.parametrize("backend", ["simple", "megatron", "spmd"])
def test_chunk_core_matches_jax(backend):
    """One decoded + evaluated chunk, with no cut and with cuts: the
    chunk's feasibility pattern and chosen fold rows equal JAX's, the
    objectives at the float32 contract. On megatron and spmd some chunks
    reach their minimum on several rows, so the chosen row is the first
    minimum's, as ``jnp.argmin``'s."""
    jnp, JS, JaxEvaluator = _jax()
    ref, port = problem_pair("tinyllama-1.1b", "decode", backend=backend,
                             objective="latency", exec_model="spmd")
    jev = JaxEvaluator.from_problem(ref)
    tev = TorchEvaluator.from_problem(port, device="cpu")
    B, tied = 256, 0
    total = math.prod(_space(ref)[2])
    for cuts in _some_cut_sets(ref):
        for produced in (0, 300):
            if produced >= total:
                continue
            jd = _chunk_inputs(ref, cuts, produced, B, np.int32)
            td = _chunk_inputs(port, cuts, produced, B, np.int64)
            want = JS._bf_chunk(jev.static, B, not cuts, jev.arrays,
                                *(jnp.asarray(x) for x in jd[:4]), jd[4])
            got = TS._bf_chunk_core(tev.static, B, not cuts, tev.arrays,
                                    *(torch.from_numpy(x) for x in td[:4]),
                                    td[4])
            w_objs, g_objs = np.asarray(want[0], np.float64), \
                got[0].numpy().astype(np.float64)
            np.testing.assert_array_equal(np.isfinite(g_objs),
                                          np.isfinite(w_objs))
            fin = np.isfinite(w_objs)
            np.testing.assert_allclose(g_objs[fin], w_objs[fin],
                                       rtol=F32_RTOL)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            tied += int((g_objs == g_objs.min()).sum() > 1)
    assert tied > 0 or backend == "simple"


@pytest.mark.parametrize("case", ["tie", "all_infeasible", "past_take"])
def test_eval_part_takes_the_first_minimum(case, monkeypatch):
    """``_bf_eval_part`` with the evaluator's results fixed (both packages'
    ``_eval_core`` replaced): the chosen row is the first minimum, an
    all-infeasible chunk gives row 0, and rows past ``take`` are inf —
    as in the JAX package."""
    jnp, JS, _ = _jax()
    B, take = 8, 8
    obj = np.array([5.0, 3.0, 1.0, 4.0, 2.0, 1.0, 6.0, 1.0])
    feas = np.ones(B, bool)
    if case == "all_infeasible":
        feas[:] = False
    if case == "past_take":
        take, obj[7] = 7, 0.5
    monkeypatch.setattr(JS, "_eval_core", lambda *a, **k: {
        "objective": jnp.asarray(obj, jnp.float32),
        "feasible": jnp.asarray(feas)})
    monkeypatch.setattr(TS, "_eval_core", lambda *a, **k: {
        "objective": torch.tensor(obj, dtype=torch.float32),
        "feasible": torch.from_numpy(feas)})
    rows = np.arange(B * 3).reshape(B, 3)
    static = SimpleNamespace(n_nodes=3)
    ones = torch.ones(3, dtype=torch.int64)
    got = TS._bf_eval_part(static, B, True, SimpleNamespace(batch=ones),
                           *(torch.from_numpy(rows + k) for k in range(3)),
                           torch.zeros(2, dtype=torch.bool), take)
    want = JS._bf_eval_part(static, B, True,
                            SimpleNamespace(batch=jnp.ones(3, jnp.int32)),
                            *(jnp.asarray(rows + k) for k in range(3)),
                            jnp.zeros(2, bool), take)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    row = {"tie": 2, "all_infeasible": 0, "past_take": 2}[case]
    np.testing.assert_array_equal(got[1].numpy(), rows[row])


#: reduced problems with cut sets on and off (arch, mode, backend,
#: objective, exec_model, max_points)
RUNS = [
    ("tinyllama-1.1b", "train", "simple", "throughput", "streaming", None),
    ("tinyllama-1.1b", "train", "megatron", "latency", "spmd", None),
    ("tinyllama-1.1b", "decode", "spmd", "latency", "spmd", 3000),
    ("jamba-1.5-large-398b", "decode", "megatron", "latency", "spmd", 3000),
]


def _assert_same_run(want, got, rtol, label):
    assert got.points == want.points, label
    assert got.variables == to_port(want.variables), label
    assert [i for i, _ in got.history] == [i for i, _ in want.history], label
    for (_, a), (_, b) in zip(got.history, want.history):
        assert a == pytest.approx(b, rel=rtol), label
    # the returned evaluation re-derives through the scalar reference
    assert got.evaluation.objective == want.evaluation.objective, label


@pytest.mark.parametrize("include_cuts", [False, True])
@pytest.mark.parametrize("arch,mode,backend,objective,exec_model,max_points",
                         RUNS)
def test_torch_engine_equals_numpy_and_jax(arch, mode, backend, objective,
                                           exec_model, max_points,
                                           include_cuts):
    _jax()
    kw = dict(include_cuts=include_cuts, max_cuts=2, max_points=max_points,
              batch_size=256)
    pair = lambda: problem_pair(arch, mode, backend=backend,
                                objective=objective, exec_model=exec_model)
    got = brute_force(pair()[1], engine="torch", device="cpu", **kw)
    assert got.points > 0
    for engine in ("numpy", "jax"):
        want = ref_brute_force(pair()[0], engine=engine, **kw)
        _assert_same_run(want, got, F32_RTOL, engine)
    # the port's own numpy engine (a copy) is the reference's
    mine = brute_force(pair()[1], engine="numpy", **kw)
    _assert_same_run(ref_brute_force(pair()[0], engine="numpy", **kw), mine,
                     0.0, "port numpy")


@pytest.mark.parametrize("backend", ["megatron", "spmd"])
def test_float64_equals_numpy_at_1e9(backend):
    ref, port = problem_pair("tinyllama-1.1b", "decode", backend=backend,
                             objective="latency", exec_model="spmd")
    kw = dict(include_cuts=True, max_cuts=2, max_points=2500)
    want = ref_brute_force(ref, engine="numpy", batch_size=256, **kw)
    got = TS.brute_force_torch(port, kw["include_cuts"], kw["max_cuts"],
                               kw["max_points"], None, 256, device="cpu",
                               dtype=torch.float64)
    _assert_same_run(want, got, 1e-9, "float64")
    assert len(got.history) > 3


def test_empty_cut_set_takes_no_segmented_reduction(monkeypatch):
    """The empty cut set is one partition: its chunks never reach segred,
    and every chunk of a cut set with a cut reaches it once."""
    from repro_torch.core.accel import segred
    calls = []
    plain = segred.segmented_reduce

    def counting(vals, pid, op):
        calls.append(tuple(vals.shape))
        return plain(vals, pid, op)

    monkeypatch.setattr(segred, "segmented_reduce", counting)
    _, port = problem_pair("tinyllama-1.1b", "train", backend="megatron",
                           objective="latency", exec_model="spmd")
    res = brute_force(port, include_cuts=False, device="cpu",
                      batch_size=256)
    assert res.points == 729 and calls == []
    res = brute_force(port, include_cuts=True, max_cuts=1, device="cpu",
                      batch_size=256)
    n_cut = len(port.graph.cut_edges)
    assert res.points == 729 * (1 + n_cut)
    # 729 points a cut set in chunks of 256: 3 chunks a cut set
    assert calls == [(256, len(port.graph.nodes))] * (3 * n_cut)


def test_max_points_time_budget_and_devices(monkeypatch):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import optimise_mapping
    _, port = problem_pair("tinyllama-1.1b", "train")
    res = brute_force(port, max_points=100, device="cpu", batch_size=64)
    assert res.points == 100
    # a spent time budget stops after the first chunk, as the jax engine
    res = brute_force(port, time_budget_s=0.0, device="cpu", batch_size=64)
    assert res.points == 64
    # devices=2: two logical CPU shards, bitwise the unsharded run; a
    # host engine raises as the JAX package's does for its non-jax ones
    kw = dict(max_points=100, device="cpu", batch_size=64)
    sharded, plain = brute_force(port, devices=2, **kw), brute_force(port,
                                                                     **kw)
    assert (sharded.points, sharded.variables, sharded.history) == \
        (plain.points, plain.variables, plain.history)
    with pytest.raises(ValueError, match="requires the torch engine"):
        brute_force(port, engine="numpy", devices=2)
    with pytest.raises(ValueError, match="device= applies"):
        brute_force(port, engine="numpy", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        brute_force(port, engine="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"engine": "auto"}, {"engine": "torch"}):
        with pytest.raises(EngineUnavailable):
            brute_force(port, max_points=10, **kw)
    with pytest.raises(EngineUnavailable):
        optimise_mapping(reduced(get_arch("tinyllama-1.1b")),
                         ShapeSpec("train_tiny", 256, 16, "train"),
                         optimiser="brute_force")


def test_optimise_mapping_plan_equals_repro():
    from repro.configs import get_arch as r_arch, reduced as r_reduced
    from repro.configs.base import ShapeSpec as RShape
    from repro.core.pipeline import optimise_mapping as r_optimise
    from repro.core.platform import Platform as RPlat
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import Platform
    from test_torch_rule_based import _plan_fields

    _jax()
    kw = dict(backend="megatron", optimiser="brute_force",
              objective="latency", exec_model="spmd", include_cuts=True,
              max_cuts=1, batch_size=512)
    mesh = (("data", 4), ("model", 4))
    want = r_optimise(r_reduced(r_arch("whisper-small")),
                      RShape("decode_tiny", 256, 16, "decode"),
                      RPlat(name="t-4x4", mesh_axes=mesh), engine="jax",
                      **kw)
    got = optimise_mapping(reduced(get_arch("whisper-small")),
                           ShapeSpec("decode_tiny", 256, 16, "decode"),
                           Platform(name="t-4x4", mesh_axes=mesh),
                           engine="torch", device="cpu", **kw)
    assert _plan_fields(got) == _plan_fields(want)


#: a mesh of one axis: the spmd backend's space at train_tiny is 2^15 a
#: cut set there (3^14 * 2 on the 4x4 mesh, too many to enumerate 16 times)
MESH_1X4 = (("model", 4),)

#: (backend, mode, mesh) of the exhaustive runs with every cut set of up to
#: two cuts; tinyllama-1.1b reduced has 5 cut edges, so 16 cut sets
CUT_RUNS = {
    "simple": ("simple", "train", MESH_4X4),
    "megatron": ("megatron", "train", MESH_4X4),
    "spmd": ("spmd", "train", MESH_1X4),
    "spmd-decode": ("spmd", "decode", MESH_4X4),
}


def _cut_run_pair(case):
    backend, mode, mesh = CUT_RUNS[case]
    return problem_pair("tinyllama-1.1b", mode, backend=backend,
                        objective="latency", exec_model="spmd",
                        mesh_axes=mesh)


def _chunks_with_a_cut(port, points, batch):
    """Chunks of ``batch`` rows in the cut sets with a cut, when every cut
    set has the same number of points."""
    e = len(port.graph.cut_edges)
    n_sets = 1 + e + e * (e - 1) // 2
    per_set = math.prod(_space(port)[2])
    assert points == n_sets * per_set
    return (n_sets - 1) * -(-per_set // batch)


def test_spmd_cut_sets_equal_numpy_and_jax(monkeypatch):
    """The spmd backend through every cut set of up to two cuts (2,048
    points a cut set on a one-axis mesh at decode): the numpy and jax
    engines' points, optimum and history, and one segmented reduction in
    every chunk of a cut set with a cut."""
    from repro_torch.core.accel import segred
    _jax()
    calls = []
    plain = segred.segmented_reduce

    def counting(vals, pid, op):
        calls.append(tuple(vals.shape))
        return plain(vals, pid, op)

    monkeypatch.setattr(segred, "segmented_reduce", counting)
    pair = lambda: problem_pair("tinyllama-1.1b", "decode", backend="spmd",
                                objective="latency", exec_model="spmd",
                                mesh_axes=MESH_1X4)
    kw = dict(include_cuts=True, max_cuts=2, batch_size=256)
    port = pair()[1]
    got = brute_force(port, engine="torch", device="cpu", **kw)
    assert got.points == 16 * 2048
    for engine in ("numpy", "jax"):
        _assert_same_run(ref_brute_force(pair()[0], engine=engine, **kw),
                         got, F32_RTOL, engine)
    n_nodes = len(port.graph.nodes)
    assert calls == [(256, n_nodes)] * _chunks_with_a_cut(port, got.points,
                                                          256)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CUT_RUNS))
def test_card_equals_numpy_and_launches_segred(case):
    """On the card, every cut set of up to two cuts (3, 729, 32,768 and
    118,098 points a cut set): the numpy engine's points, optimum and
    history in float32 (objectives at the float32 contract) and in float64
    (at 1e-9), and the segred kernel launched once in every chunk of a cut
    set with a cut (the empty cut set is one partition and launches it no
    time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")
    from repro_torch.core.accel import segred
    ref, port = _cut_run_pair(case)
    kw = dict(include_cuts=True, max_cuts=2, batch_size=256)
    want = ref_brute_force(ref, engine="numpy", **kw)
    segred.LAUNCHES = 0
    got = brute_force(port, engine="torch", **kw)
    launches = segred.LAUNCHES
    _assert_same_run(want, got, F32_RTOL, "cuda")
    assert launches == _chunks_with_a_cut(port, want.points, 256)
    got = TS.brute_force_torch(port, True, 2, None, None, 256,
                               device="cuda", dtype=torch.float64)
    _assert_same_run(want, got, 1e-9, "cuda float64")
