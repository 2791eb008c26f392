"""The port's device axis (``devices=D``) on the CPU: the counterpart of
``tests/test_shard.py`` and of
``test_random_differential.py::test_random_shard_devices_grid_identical``,
on fixed problems.

``devices=D`` runs D shards (``repro_torch.runtime.device_mesh``; here D
logical shards of ``device="cpu"``): brute force splits each chunk's rows,
the fleets each bucket's lanes. Everything it returns is bitwise the
``devices=None`` result for every D, ragged shards, shards of one lane and
shards made only of padding included; brute force also equals the JAX
package's engine with ``devices=None`` and with its mesh of one. The
``*_shard`` dispatch counters tick under ``devices=`` and the plain ones
do not; every misuse raises the exception type the JAX package raises. The
card-only cases run the shards on one card (each launching segred) and,
with two cards, on separate cards. Synthetic inputs come from
``np.random.default_rng`` with a fixed seed.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_support import MESH_4X4, TINY_SHAPES, problem_pair, to_port
from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.accel import EngineUnavailable
from repro_torch.core.accel import fleet as TF
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel import segred
from repro_torch.core.optimizers import OPTIMIZERS, brute_force
from repro_torch.core.pipeline import (
    make_problem,
    optimise_comapping,
    optimise_portfolio,
)
from repro_torch.core.platform import Platform
from repro_torch.obs import metrics
from repro_torch.runtime import device_mesh

#: float32-on-device agreement of recorded objectives with JAX's
F32_RTOL = 1e-5
GRID = (1, 2, 3, 8)
SHAPE = ShapeSpec(*TINY_SHAPES["train"])
PLAT = Platform(name="t-4x4", mesh_axes=MESH_4X4)
PLAT_2X8 = Platform(name="t-2x8", mesh_axes=(("data", 2), ("model", 8)),
                    hbm_bytes=8 * 2**30, hbm_bw=400e9)

#: brute force, in chunks of B = 100 rows (102 at D = 3, 104 at D = 8) and
#: ``max_points`` a multiple of none of them: without cuts, the first 2,500
#: of 118,098 points of a spmd decode problem whose chunks tie across rows;
#: with cuts, a megatron decode problem's 16 cut sets of up to two cuts,
#: 243 points each, cut short after 2,500
BF_CASES = {
    "cuts off": (dict(arch_name="tinyllama-1.1b", mode="decode",
                      backend="spmd", objective="latency",
                      exec_model="spmd"),
                 dict(include_cuts=False, max_points=2500, batch_size=100)),
    "cuts on": (dict(arch_name="tinyllama-1.1b", mode="decode",
                     backend="megatron", objective="latency",
                     exec_model="spmd"),
                dict(include_cuts=True, max_cuts=2, max_points=2500,
                     batch_size=100)),
}


def _same(a, b):
    """Points, design, history and the float64 evaluation, exactly."""
    return (a.points, a.variables, a.history, a.evaluation.objective,
            a.evaluation.feasible) == \
        (b.points, b.variables, b.history, b.evaluation.objective,
         b.evaluation.feasible)


def _dispatches(kind):
    return metrics.counter(f"accel.dispatches.{kind}").value


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

def test_device_mesh_lists_the_shards(monkeypatch):
    assert device_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert device_mesh(1, device="cpu") == [torch.device("cpu")]
    for bad in (0, -2):
        with pytest.raises(ValueError, match=">= 1 device"):
            device_mesh(bad, device="cpu")
    # the cards, round robin: shards share a card past the card count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_mesh(5) == [torch.device("cuda", d % 2) for d in range(5)]
    assert device_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable):
        device_mesh(2)


def test_pad_lanes():
    assert [TF._pad_lanes(P, D) for P, D in
            ((3, 1), (3, 2), (3, 8), (8, 8), (9, 8), (1, 3))] == \
        [3, 4, 8, 8, 16, 3]


# ----------------------------------------------------------------------
# brute force: the sharded chunk
# ----------------------------------------------------------------------

def _bf_problem(case):
    return problem_pair(**BF_CASES[case][0])[1]


@functools.lru_cache(maxsize=None)
def _bf_unsharded(case):
    return brute_force(_bf_problem(case), device="cpu", **BF_CASES[case][1])


@pytest.mark.parametrize("case", sorted(BF_CASES))
@pytest.mark.parametrize("D", GRID)
def test_brute_force_devices_grid_bitwise(D, case, monkeypatch):
    """D shards give the ``devices=None`` result bitwise, with B rounded up
    to a multiple of D, ragged last chunks whose later shards lie wholly
    past ``take`` and, without cuts, chunks whose minimum is reached in
    more than one shard."""
    seen = []
    combine = TS._bf_shard_combine
    monkeypatch.setattr(TS, "_bf_shard_combine", lambda outs: seen.append(
        [o[0][0].numpy().copy() for o in outs]) or combine(outs))
    got = brute_force(_bf_problem(case), device="cpu", devices=D,
                      **BF_CASES[case][1])
    want = _bf_unsharded(case)
    assert _same(got, want) and len(want.history) > 1
    assert want.points == 2500
    B = -(-100 // D) * D
    assert seen and all(len(s) == D and sum(len(x) for x in s) == B
                        for s in seen)
    if D > 1 and case == "cuts off":
        # some chunk's minimum lies in two shards: the first one wins
        tied = [s for s in seen if np.isfinite(min(x.min() for x in s))
                and sum(x.min() == min(y.min() for y in s) for x in s) > 1]
        assert tied


@pytest.mark.parametrize("case", sorted(BF_CASES))
def test_brute_force_shards_equal_the_jax_engine(case):
    """The sharded port against the JAX package's brute force with
    ``devices=None`` and with its mesh of one: points, design and history
    indices equal, the recorded float32 objectives at 1e-5."""
    pytest.importorskip("jax")
    from repro.core.optimizers import brute_force as ref_brute_force
    pair, kw = BF_CASES[case]
    got = brute_force(problem_pair(**pair)[1], device="cpu", devices=3, **kw)
    for devices in (None, 1):
        want = ref_brute_force(problem_pair(**pair)[0], engine="jax",
                               devices=devices, **kw)
        assert got.points == want.points
        assert got.variables == to_port(want.variables)
        assert [i for i, _ in got.history] == [i for i, _ in want.history]
        np.testing.assert_allclose([o for _, o in got.history],
                                   [o for _, o in want.history],
                                   rtol=F32_RTOL)
        assert got.evaluation.objective == want.evaluation.objective


def _outs(objs, D, n=3, seed=0):
    """Shard outputs as ``_bf_chunk_core`` gives them (lanes of 1): [1,
    B/D] objectives and each shard's fold rows of its first minimum."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 64, size=(len(objs), 3, n))
    out = []
    for d, part in enumerate(np.split(np.asarray(objs, np.float32), D)):
        r = int(np.argmin(part)) if np.isfinite(part).any() else 0
        out.append((torch.from_numpy(part)[None],) + tuple(
            torch.from_numpy(rows[d * len(part) + r, v])[None]
            for v in range(3)))
    return out, rows


@pytest.mark.parametrize("case,win_row", [
    ("cross_shard_tie", 5), ("all_infeasible", 0), ("past_take", 2)])
def test_shard_combine_is_the_first_minimum(case, win_row):
    """The host combine (JAX's ``pmin`` and masked ``psum``): the first
    shard holding the chunk's minimum wins, so a tie across shards goes to
    the lowest shard; an all-infeasible chunk is shard 0's row 0; shards
    wholly past ``take`` hold only inf and never win."""
    rng = np.random.default_rng(7)
    objs = rng.uniform(2.0, 9.0, size=12)
    if case == "cross_shard_tie":
        objs[[5, 7, 10]] = 1.0                 # shards 1, 2 and 3 of 4
    elif case == "all_infeasible":
        objs[:] = np.inf
    else:
        objs[2], objs[3:] = 1.0, np.inf        # take = 3: shards 1-3 inf
    outs, rows = _outs(objs, 4)
    got, (si, so, kk) = TS._bf_shard_combine(outs)
    np.testing.assert_array_equal(got, objs.astype(np.float32))
    for v, x in enumerate((si, so, kk)):
        np.testing.assert_array_equal(x[0].numpy(), rows[win_row, v])


def test_all_infeasible_run_is_the_unsharded_one():
    """A platform that fits no design: every chunk of every shard is inf,
    and the sharded run returns what the unsharded one does (the initial
    design, no history)."""
    tiny = Platform(name="t-tiny", mesh_axes=MESH_4X4, hbm_bytes=1)
    prob = lambda: make_problem(reduced(get_arch("tinyllama-1.1b")), SHAPE,
                                tiny, "spmd", "throughput", "streaming")
    kw = dict(include_cuts=True, max_points=700, batch_size=64,
              device="cpu")
    want = brute_force(prob(), **kw)
    assert want.history == [] and not want.evaluation.feasible
    for D in (3, 8):
        assert _same(brute_force(prob(), devices=D, **kw), want)


# ----------------------------------------------------------------------
# the fleets: the problem axis
# ----------------------------------------------------------------------

def _lanes(n=3, pkg="repro_torch"):
    """Three lanes of one bucket, mixed platforms and objectives, built by
    ``pkg`` (the port, or ``repro`` for the JAX package's fleets)."""
    from importlib import import_module
    cfg = import_module(f"{pkg}.configs")
    base = import_module(f"{pkg}.configs.base")
    pipe = import_module(f"{pkg}.core.pipeline")
    pl = import_module(f"{pkg}.core.platform")
    plats = {p.name: pl.Platform(name=p.name, mesh_axes=p.mesh_axes,
                                 hbm_bytes=p.hbm_bytes, hbm_bw=p.hbm_bw)
             for p in (PLAT, PLAT_2X8)}
    specs = [("tinyllama-1.1b", PLAT, "throughput"),
             ("llama3.2-1b", PLAT_2X8, "latency"),
             ("stablelm-3b", PLAT, "latency")][:n]
    return [pipe.make_problem(cfg.reduced(cfg.get_arch(a), num_layers=2),
                              base.ShapeSpec(*TINY_SHAPES["train"]),
                              plats[p.name], "spmd", o, "streaming")
            for a, p, o in specs]


FLEETS = {
    "brute_force": (TF.fleet_brute_force,
                    dict(include_cuts=True, max_cuts=1, max_points=900,
                         batch_size=128)),
    "annealing": (TF.fleet_annealing,
                  dict(seed=4, max_iters=40, chains=4)),
    "rule_based": (TF.fleet_rule_based, dict(multi_start=False)),
}


@functools.lru_cache(maxsize=None)
def _fleet_unsharded(name):
    fleet, kw = FLEETS[name]
    probs = _lanes()
    assert TF.bucket_indices(probs, tiered=name == "brute_force") == \
        [[0, 1, 2]]
    return fleet(probs, device="cpu", **kw)


@pytest.mark.parametrize("D", GRID)
@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_devices_grid_bitwise(name, D):
    """Three lanes over D shards: ragged (D = 2: a padding lane beside lane
    2), shards of one lane (D = 3) and shards of padding only (D = 8), each
    lane bitwise its ``devices=None`` result."""
    fleet, kw = FLEETS[name]
    got = fleet(_lanes(), device="cpu", devices=D, **kw)
    want = _fleet_unsharded(name)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _same(g, w)


@functools.lru_cache(maxsize=None)
def _jax_fleet(name, devices):
    from repro.core.accel import fleet as JF
    return getattr(JF, f"fleet_{name}")(_lanes(pkg="repro"),
                                        devices=devices, **FLEETS[name][1])


@pytest.mark.parametrize("D", GRID[1:])
@pytest.mark.parametrize("name", ["brute_force", "rule_based"])
def test_fleet_shards_equal_the_jax_fleet(name, D):
    """The port's fleet at D shards against the JAX package's fleet on the
    same three lanes with ``devices=None`` and with its mesh of one: points,
    design and history indices equal, the recorded float32 objectives at
    1e-5, the float64 evaluation exactly."""
    pytest.importorskip("jax")
    fleet, kw = FLEETS[name]
    got = fleet(_lanes(), device="cpu", devices=D, **kw)
    for devices in (None, 1):
        want = _jax_fleet(name, devices)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.points == w.points
            assert g.variables == to_port(w.variables)
            assert [i for i, _ in g.history] == [i for i, _ in w.history]
            np.testing.assert_allclose([o for _, o in g.history],
                                       [o for _, o in w.history],
                                       rtol=F32_RTOL)
            assert (g.evaluation.objective, g.evaluation.feasible) == \
                (w.evaluation.objective, w.evaluation.feasible)


def test_annealing_duplicate_pad_leaves_lane_zero_alone():
    """SA pads with duplicates of lane 0, each on its own clone of lane
    0's generator: lane 0 with one, two or seven duplicates beside it is
    bitwise lane 0 alone, and bitwise its per-problem run."""
    kw = FLEETS["annealing"][1]
    alone = TF.fleet_annealing(_lanes(1), device="cpu", **kw)[0]
    assert _same(alone, OPTIMIZERS["annealing"](_lanes(1)[0], device="cpu",
                                                **kw))
    for D in (2, 3, 8):
        assert _same(TF.fleet_annealing(_lanes(1), device="cpu", devices=D,
                                        **kw)[0], alone)
    g = torch.Generator().manual_seed(3)
    torch.rand(5, generator=g)
    twin = TF._cloned(g)
    state = g.get_state().clone()
    assert torch.equal(torch.rand(4, generator=twin),
                       torch.rand(4, generator=g))
    assert not torch.equal(g.get_state(), state)
    assert TF._gen_on(g, "cpu") is g


def test_rule_based_shards_take_the_round_max_parts(monkeypatch):
    """Every shard's descent takes the round's bucket-wide ``max_parts``,
    so each row adds as many partition terms as it does unsharded."""
    seen = []
    core = TF._rb_descend_core
    monkeypatch.setattr(TF, "_rb_descend_core", lambda *a: seen.append(
        (a[6].shape[0], a[-1])) or core(*a))
    TF.fleet_rule_based(_lanes(), device="cpu", devices=2, multi_start=False)
    calls, parts = len(seen), [p for _, p in seen]
    seen.clear()
    TF.fleet_rule_based(_lanes(), device="cpu", multi_start=False)
    assert calls == 2 * len(seen)
    assert parts == [p for _, p in seen for _ in range(2)]
    assert {n for n, _ in seen} == {3}


# ----------------------------------------------------------------------
# the entry points that reach the fleets and brute force
# ----------------------------------------------------------------------

@pytest.mark.parametrize("optimiser", sorted(FLEETS))
def test_optimise_portfolio_devices_bitwise(optimiser):
    archs = [reduced(get_arch(a), num_layers=2)
             for a in ("tinyllama-1.1b", "llama3.2-1b", "tinyllama-1.1b")]
    kw = dict(optimiser=optimiser, objective=["throughput", "latency",
                                              "throughput"],
              device="cpu", **FLEETS[optimiser][1])
    want, got = [], []
    plans = optimise_portfolio(archs, SHAPE, PLAT, results=want, **kw)
    sharded = optimise_portfolio(archs, SHAPE, PLAT, devices=3,
                                 results=got, **kw)
    assert sharded == plans
    assert all(_same(g, w) for g, w in zip(got, want))


def test_optimise_mapping_brute_force_devices_bitwise():
    from repro_torch.core.pipeline import optimise_mapping
    kw = dict(optimiser="brute_force", include_cuts=True, max_points=400,
              batch_size=64, device="cpu")
    arch = reduced(get_arch("tinyllama-1.1b"))
    assert optimise_mapping(arch, SHAPE, PLAT, devices=3, **kw) == \
        optimise_mapping(arch, SHAPE, PLAT, **kw)


@pytest.mark.parametrize("optimiser", ["brute_force", "rule_based"])
def test_optimise_comapping_devices_bitwise(optimiser):
    """``optimise_comapping`` and the service's ``solve_comap`` with
    ``devices=3``: the 2 splits x 2 nets = 4 lanes pad to 6."""
    from repro_torch.service import MappingServer
    archs = [reduced(get_arch(a), num_layers=2)
             for a in ("tinyllama-1.1b", "llama3.2-1b")]
    kw = dict(optimiser=optimiser, splits=[[2, 2], [3, 1]], device="cpu",
              **({"max_points": 300, "batch_size": 64}
                 if optimiser == "brute_force" else {"multi_start": False}))
    want = optimise_comapping(archs, SHAPE, PLAT, **kw)
    got = optimise_comapping(archs, SHAPE, PLAT, devices=3, **kw)
    with MappingServer() as srv:
        served = srv.solve_comap(archs, SHAPE, PLAT, engine="torch",
                                 devices=3, **kw)
    for plan in (got, served):
        assert (plan.split_index, plan.plans, plan.objective_value,
                plan.result.points, plan.result.history) == \
            (want.split_index, want.plans, want.objective_value,
             want.result.points, want.result.history)
        assert all(_same(a, b) for a, b in zip(plan.result.per_net,
                                                want.result.per_net))


@pytest.mark.parametrize("optimiser", ["brute_force", "rule_based"])
def test_optimise_comapping_shards_equal_the_jax_joint_search(optimiser):
    """``optimise_comapping(devices=3)`` against the JAX package's
    ``joint_search`` on its numpy and jax engines, on the same 4 lanes:
    split, composite objective, points, every net's design, history
    indices equal; brute force's recorded float32 objectives at 1e-5."""
    pytest.importorskip("jax")
    from repro.configs import get_arch as ref_arch
    from repro.configs import reduced as ref_reduced
    from repro.configs.base import ShapeSpec as RefShape
    from repro.core.comap import joint_search
    from repro.core.pipeline import make_comap_problem
    from repro.core.platform import Platform as RefPlatform
    names, splits = ("tinyllama-1.1b", "llama3.2-1b"), [[2, 2], [3, 1]]
    kw = ({"max_points": 300, "batch_size": 64}
          if optimiser == "brute_force" else {"multi_start": False})
    got = optimise_comapping([reduced(get_arch(a), num_layers=2)
                              for a in names], SHAPE, PLAT,
                             optimiser=optimiser, splits=splits,
                             device="cpu", devices=3, **kw).result
    fields = lambda r: (r.split_index, r.split, r.evaluation.objective,
                        r.evaluation.feasible, r.points,
                        [p for p, _ in r.history],
                        [(x.points, [p for p, _ in x.history]) for x in
                         r.per_net])
    for engine in ("numpy", "jax"):
        want = joint_search(make_comap_problem(
            [ref_reduced(ref_arch(a), num_layers=2) for a in names],
            RefShape(*TINY_SHAPES["train"]),
            RefPlatform(name=PLAT.name, mesh_axes=PLAT.mesh_axes),
            splits=splits), optimiser=optimiser, engine=engine, **kw)
        assert fields(got) == fields(want), engine
        assert [x.variables for x in got.per_net] == \
            [to_port(x.variables) for x in want.per_net], engine
        np.testing.assert_allclose([o for _, o in got.history],
                                   [o for _, o in want.history],
                                   rtol=F32_RTOL)
        for x, y in zip(got.per_net, want.per_net):
            np.testing.assert_allclose([o for _, o in x.history],
                                       [o for _, o in y.history],
                                       rtol=F32_RTOL)


def test_service_requests_with_devices_bitwise():
    """A submitted brute-force request and a POST /v1/mapping and
    /v1/comap with ``devices`` in their ``optimiser_kwargs``: each is
    bitwise the same call without it, and ``request_key`` keeps the two
    apart."""
    import json
    import threading
    import urllib.request
    from repro_torch.service import MappingServer, serve_http
    from repro_torch.service.cache import request_key
    bf = dict(include_cuts=True, max_points=500, batch_size=64,
              device="cpu")
    prob = lambda: make_problem(reduced(get_arch("tinyllama-1.1b")), SHAPE,
                                PLAT, "spmd", "throughput", "streaming")
    want = OPTIMIZERS["brute_force"](prob(), **bf)
    assert request_key(prob(), "brute_force", "torch", bf) != \
        request_key(prob(), "brute_force", "torch", dict(bf, devices=2))
    shape = {"name": SHAPE.name, "seq_len": SHAPE.seq_len,
             "global_batch": SHAPE.global_batch, "mode": SHAPE.mode}
    plat = {"name": "t-4x4", "mesh_axes": [list(a) for a in MESH_4X4]}
    comap = {"archs": ["tinyllama-1.1b", "llama3.2-1b"], "reduced": True,
             "shape": shape, "platform": plat, "engine": "torch",
             "splits": [[2, 2], [3, 1]],
             "optimiser_kwargs": {"device": "cpu", "multi_start": False}}
    mapping = {"arch": "tinyllama-1.1b", "reduced": True, "shape": shape,
               "platform": plat, "optimiser": "brute_force",
               "engine": "torch", "optimiser_kwargs": bf}

    def post(base, route, body):
        req = urllib.request.Request(
            f"{base}{route}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.load(r)

    with MappingServer() as srv:
        resp = srv.submit_problem(prob(), optimiser="brute_force",
                                  engine="torch", devices=2,
                                  **bf).result(300)
        assert _same(resp.result, want) and not resp.cached
        httpd = serve_http(srv, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            out = {}
            for d in (None, 2):
                kw = {} if d is None else {"devices": d}
                out[d] = (
                    post(base, "/v1/mapping", dict(mapping, optimiser_kwargs=(
                        dict(bf, **kw)))),
                    post(base, "/v1/comap", dict(comap, optimiser_kwargs=(
                        dict(comap["optimiser_kwargs"], **kw)))))
        finally:
            httpd.shutdown()
            httpd.server_close()
    drop = lambda r: {k: v for k, v in r.items()
                      if k not in ("total_s", "cached", "coalesced")}
    for a, b in zip(out[2], out[None]):
        assert drop(a) == drop(b)
    assert out[None][0]["objective_value"] == want.evaluation.objective
    assert out[None][0]["points"] == want.points


# ----------------------------------------------------------------------
# counters and misuse
# ----------------------------------------------------------------------

def _run_kind(kind, devices):
    if kind == "bf_chunk":
        brute_force(_lanes(1)[0], max_points=200, batch_size=64,
                    device="cpu", devices=devices)
        return
    name = {"fleet_bf_chunk": "brute_force", "fleet_sa_sweeps": "annealing",
            "fleet_rb_descend": "rule_based"}[kind]
    fleet, kw = FLEETS[name]
    fleet(_lanes(), device="cpu", devices=devices, **kw)


@pytest.mark.parametrize("kind", ["bf_chunk", "fleet_bf_chunk",
                                  "fleet_sa_sweeps", "fleet_rb_descend"])
def test_shard_counters_tick_and_plain_ones_do_not(kind):
    _run_kind(kind, 3)
    assert _dispatches(f"{kind}_shard") > 0 and _dispatches(kind) == 0
    metrics.reset()
    _run_kind(kind, None)
    assert _dispatches(kind) > 0 and _dispatches(f"{kind}_shard") == 0


def _misuse(pkg):
    """``devices=`` misuses, built by ``pkg`` (``repro`` or
    ``repro_torch``), each a thunk; the device engine is the package's."""
    from importlib import import_module
    opt = import_module(f"{pkg}.core.optimizers")
    pipe = import_module(f"{pkg}.core.pipeline")
    cfg = import_module(f"{pkg}.configs")
    base = import_module(f"{pkg}.configs.base")
    plat = import_module(f"{pkg}.core.platform")
    dev = "jax" if pkg == "repro" else "torch"
    extra = {} if pkg == "repro" else {"device": "cpu"}
    shape = base.ShapeSpec(*TINY_SHAPES["train"])
    p = plat.Platform(name="t-4x4", mesh_axes=MESH_4X4)
    arch = cfg.reduced(cfg.get_arch("tinyllama-1.1b"), num_layers=2)
    prob = lambda: pipe.make_problem(arch, shape, p)
    cp = lambda: pipe.make_comap_problem([arch, arch], shape, p,
                                         splits=[[2, 2]])
    comap = import_module(f"{pkg}.core.comap")
    return {
        "brute_force numpy": lambda: opt.brute_force(
            prob(), engine="numpy", devices=1, max_points=8),
        "brute_force scalar": lambda: opt.brute_force(
            prob(), engine="scalar", devices=2, max_points=8),
        "rule_based devices": lambda: opt.rule_based(
            prob(), engine=dev, devices=2, **extra),
        "annealing devices": lambda: opt.simulated_annealing(
            prob(), engine=dev, devices=2, **extra),
        "portfolio numpy": lambda: pipe.optimise_portfolio(
            [arch], shape, p, engine="numpy", devices=1),
        "portfolio loop": lambda: pipe.optimise_portfolio(
            [arch], shape, p, optimiser="annealing", engine=dev, devices=1,
            time_budget_s=0.1, **extra),
        "joint_search numpy": lambda: comap.joint_search(
            cp(), optimiser="brute_force", engine="numpy", devices=2,
            max_points=8),
        "no device": lambda: opt.brute_force(
            prob(), engine=dev, devices=0, max_points=8, **extra),
    }


@pytest.mark.parametrize("case", sorted(_misuse("repro_torch")))
def test_misuse_raises_the_jax_package_s_exception(case):
    """Each misuse raises what the JAX package's raises for it (its device
    engine ``jax`` where the port's is ``torch``)."""
    pytest.importorskip("jax")
    with pytest.raises(Exception) as port:
        _misuse("repro_torch")[case]()
    with pytest.raises(Exception) as ref:
        _misuse("repro")[case]()
    assert port.type is ref.type, (port.value, ref.value)
    assert port.type in (ValueError, TypeError)
    if "devices" in str(ref.value):
        assert "devices" in str(port.value)


def test_devices_without_a_card_never_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: brute_force(_lanes(1)[0], devices=2, max_points=8),
                 lambda: TF.fleet_rule_based(_lanes(1), devices=2)):
        with pytest.raises(EngineUnavailable):
            call()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_card_shards_launch_segred_each_and_equal_unsharded(monkeypatch):
    """devices=3 on one card: brute force and each fleet bitwise their
    ``devices=None`` run on the card; brute force launches segred once a
    shard a chunk with a cut, at [B/3, n]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")
    prob = lambda: _bf_problem("cuts on")
    kw = BF_CASES["cuts on"][1]
    segred.LAUNCHES = 0
    want = brute_force(prob(), device="cuda", **kw)
    base = segred.LAUNCHES
    segred.LAUNCHES = 0
    segred.SHAPES.clear()
    got = brute_force(prob(), device="cuda", devices=3, **kw)
    assert _same(got, want)
    assert 0 < segred.LAUNCHES == 3 * base
    p = prob()
    total = int(np.prod([len(m) for m in
                         p.backend.space(p.graph, p.platform)[1]]))
    rows = -(-min(100, TS._pow2ceil(total)) // 3)
    assert set(segred.SHAPES) == {(rows, len(p.graph.nodes))}
    for name, (fleet, fkw) in sorted(FLEETS.items()):
        w = fleet(_lanes(), device="cuda", **fkw)
        g = fleet(_lanes(), device="cuda", devices=3, **fkw)
        assert all(_same(a, b) for a, b in zip(g, w)), name


@pytest.mark.gpu
def test_two_cards_run_the_shards_on_separate_cards(monkeypatch):
    """devices=2 with two cards: shard d runs on cuda:d, and the results
    are bitwise the one-card unsharded run."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards")
    seen = set()
    core = TS._bf_chunk_core
    monkeypatch.setattr(TS, "_bf_chunk_core", lambda *a, **k: seen.add(
        a[4].device) or core(*a, **k))
    prob = lambda: _bf_problem("cuts on")
    kw = BF_CASES["cuts on"][1]
    want = brute_force(prob(), **kw)
    seen.clear()
    assert _same(brute_force(prob(), devices=2, **kw), want)
    assert seen == {torch.device("cuda", 0), torch.device("cuda", 1)}
    for name, (fleet, fkw) in sorted(FLEETS.items()):
        w = fleet(_lanes(), **fkw)
        g = fleet(_lanes(), devices=2, **fkw)
        assert all(_same(a, b) for a, b in zip(g, w)), name
