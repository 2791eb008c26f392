"""The port's mapping service (``repro_torch.service``) on the CPU.

The contract: every response the server hands back is BITWISE a direct
``OPTIMIZERS[...](problem, engine=..., device=...)`` call of the port for
the same request — across threads, duplicate in-flight coalescing, cache
hits, late joiners with a restack, and deadline failures. The cases are
``tests/test_service.py``'s, run on the torch engine with
``device="cpu"``. The threaded submissions and the two HTTP routes are
also held against the JAX package's ``repro.service.MappingServer`` on
its numpy engine, on the same requests: designs, objectives, points,
histories, plans and every response field but the engine's name and the
timing and coalescing flags. JAX's ``assert_max_traces`` has no counterpart in eager
PyTorch; in its place the lockstep cases count the ``fleet_rb_descend``
dispatches (one a round, from the port's ``obs.metrics``) and segred's
reductions (two a descent step, whatever the lane count). All randomness
is seeded (``random.Random(tid)``); the threaded tests are deterministic in
the set of requests issued.
"""
import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from _torch_support import TINY_SHAPES, port_obs_reset  # noqa: F401
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.accel import EngineUnavailable
from repro_torch.core.accel import search_loops as TS
from repro_torch.core.accel import segred
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.pipeline import (
    make_problem,
    optimise_comapping,
    optimise_portfolio,
)
from repro_torch.core.platform import Platform
from repro_torch.obs import metrics
from repro_torch.service import (
    AdmissionQueue,
    DeadlineExceeded,
    LockstepJob,
    MappingServer,
    ServiceClosed,
    ServiceOverloaded,
    SolvedCache,
    SolvedDesign,
    run_rule_based_lockstep,
    serve_http,
)

PLATFORM = Platform(name="test-4x4", mesh_axes=(("data", 4), ("model", 4)))
SHAPE = ShapeSpec(*TINY_SHAPES["train"])
CPU = {"engine": "torch", "device": "cpu"}


def problem(objective="throughput", num_layers=None):
    overrides = {} if num_layers is None else {"num_layers": num_layers}
    arch = reduced(get_arch("tinyllama-1.1b"), **overrides)
    return make_problem(arch, SHAPE, PLATFORM, "spmd", objective,
                        "streaming")


def reference_service():
    """The JAX package's service module (run on its numpy engine)."""
    pytest.importorskip("jax")
    import repro.service
    return repro.service


def reference_problem(objective="throughput"):
    """``problem(objective)``, built by the JAX package."""
    from repro.configs import get_arch as rget
    from repro.configs import reduced as rreduced
    from repro.configs.base import ShapeSpec as RShape
    from repro.core.pipeline import make_problem as rmake
    from repro.core.platform import Platform as RPlatform
    return rmake(rreduced(rget("tinyllama-1.1b")),
                 RShape(*TINY_SHAPES["train"]),
                 RPlatform(name=PLATFORM.name,
                           mesh_axes=PLATFORM.mesh_axes),
                 "spmd", objective, "streaming")


def answer(resp):
    """A response's design, objective, points and history and its plan,
    as plain values, comparable across the two packages."""
    r, v = resp.result, resp.result.variables
    return ((tuple(v.cuts), tuple(v.s_in), tuple(v.s_out), tuple(v.kern)),
            r.evaluation.objective, r.evaluation.feasible, r.points,
            [tuple(h) for h in r.history], dataclasses.asdict(resp.plan),
            resp.optimiser)


def direct(objective="throughput", num_layers=None):
    return OPTIMIZERS["rule_based"](problem(objective, num_layers),
                                    device="cpu")


def same_result(a, b) -> bool:
    """Bit-identity of two OptimResults (design, objective, accounting)."""
    return (a.variables == b.variables
            and a.evaluation.objective == b.evaluation.objective
            and a.points == b.points
            and list(a.history) == list(b.history))


def counters():
    return metrics.snapshot()["counters"]


def count_descent(monkeypatch):
    """(descent steps, segred reductions) lists that grow as they run."""
    steps, reduces = [], []
    step, plain = TS._rb_step, segred.segmented_reduce
    monkeypatch.setattr(TS, "_rb_step", lambda *a, **k: steps.append(1)
                        or step(*a, **k))
    monkeypatch.setattr(segred, "segmented_reduce",
                        lambda v, p, op: reduces.append(v.shape)
                        or plain(v, p, op))
    return steps, reduces


# ----------------------------------------------------------------------
# cache and admission queue (host code, copied)
# ----------------------------------------------------------------------

def _design(i: int) -> SolvedDesign:
    return SolvedDesign(cuts=(i % 2,), s_in=(1, i), s_out=(i, 1),
                        kern=(1, 1), points=10 * i, seconds=0.25,
                        history=((1, float(i)), (2, float(i) / 2)),
                        name="rule_based")


def test_cache_lru_eviction_and_counters():
    c = SolvedCache(capacity=2)
    c.put("a", _design(1))
    c.put("b", _design(2))
    assert c.get("a") is not None          # 'a' now most-recent
    c.put("c", _design(3))                 # evicts 'b'
    assert "b" not in c and "a" in c and "c" in c
    assert c.get("b") is None
    snap = counters()
    assert snap["service.cache.evictions"] == 1
    assert snap["service.cache.hits"] == 1
    assert snap["service.cache.misses"] == 1
    with pytest.raises(ValueError, match="capacity"):
        c.capacity = 0


def test_cache_contains_has_no_lru_side_effect():
    c = SolvedCache(capacity=2)
    c.put("a", _design(1))
    c.put("b", _design(2))
    assert "a" in c                        # probe must NOT refresh 'a'
    c.put("c", _design(3))
    assert "a" not in c and "b" in c
    assert "service.cache.hits" not in counters()


def test_cache_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "solved.jsonl")
    c = SolvedCache(capacity=8, path=path)
    for i in range(3):
        c.put(f"k{i}", _design(i))
    c.save()
    warm = SolvedCache(capacity=8, path=path)   # auto-loads
    assert len(warm) == 3
    for i in range(3):
        assert warm.get(f"k{i}") == _design(i)


def test_request_key_separates_devices_and_engines():
    from repro_torch.service import request_key
    p = problem()
    keys = {request_key(p, "rule_based", "torch", {"device": "cpu"}),
            request_key(p, "rule_based", "torch", {"device": "cuda"}),
            request_key(p, "rule_based", "numpy", {}),
            request_key(problem("latency"), "rule_based", "numpy", {})}
    assert len(keys) == 4
    assert request_key(p, "rule_based", "numpy", {}) == \
        request_key(problem(), "rule_based", "numpy", {})


def test_admission_queue_fifo_and_backpressure():
    q = AdmissionQueue(maxsize=2)
    q.push(1)
    q.push(2)
    with pytest.raises(ServiceOverloaded):
        q.push(3)
    assert counters()["service.requests.rejected"] == 1
    assert q.drain() == [1, 2]
    for i in (1, 2):                       # refill after drain works
        q.push(i * 10)
    assert q.drain_matching(lambda x: x == 20) == [20]
    assert q.drain() == [10]


def test_server_backpressure_and_close():
    srv = MappingServer(max_pending=2)     # never started: requests queue
    f1 = srv.submit_problem(problem(), **CPU)
    srv.submit_problem(problem(), **CPU)
    with pytest.raises(ServiceOverloaded):
        srv.submit_problem(problem(), **CPU)
    srv.close(drain=False)                 # pending fail, new rejected
    with pytest.raises(ServiceClosed):
        f1.result(timeout=5)
    with pytest.raises(ServiceClosed):
        srv.submit_problem(problem(), **CPU)


def test_unknown_optimiser_rejected_at_submit():
    srv = MappingServer()
    with pytest.raises(ValueError, match="unknown optimiser"):
        srv.submit_problem(problem(), optimiser="gradient_descent")
    srv.close()


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------

def test_numpy_engine_end_to_end_bit_identical():
    want = OPTIMIZERS["rule_based"](problem(), engine="numpy")
    with MappingServer() as srv:
        resp = srv.submit_problem(problem(), optimiser="rule_based",
                                  engine="numpy").result(timeout=300)
    assert resp.engine == "numpy" and not resp.cached
    assert same_result(resp.result, want)
    assert resp.plan.objective_value == want.evaluation.objective


def test_engine_fails_fast_and_never_falls_back(monkeypatch):
    """``jax`` is an unknown engine of the port; a torch request with no
    card and no ``device="cpu"`` fails with ``EngineUnavailable`` on its
    future — on the lockstep route and on the per-problem route alike —
    instead of running on the CPU."""
    with MappingServer() as srv:
        with pytest.raises(ValueError, match="unknown engine"):
            srv.submit_problem(problem(), engine="jax").result(timeout=30)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for fut in (srv.submit_problem(problem(), engine="torch"),
                    srv.submit_problem(problem(), engine="auto"),
                    srv.submit_problem(problem(), optimiser="annealing",
                                       engine="torch", max_iters=4)):
            with pytest.raises(EngineUnavailable):
                fut.result(timeout=30)     # clean failure, never a hang
    assert counters()["service.requests.failed"] == 4
    assert "service.engine_runs" not in counters()


def test_lockstep_groups_never_mix_devices(monkeypatch):
    """The lockstep group key holds the device: the same problem asked on
    the CPU and on the card leads two groups."""
    from repro_torch.service.server import _Request
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    srv = MappingServer()
    groups, lockstep, loop = {}, {}, []
    for dev in ("cpu", "cuda", "cpu"):
        srv._classify(_Request(problem(), "rule_based", "torch",
                               {"device": dev}, None), groups, lockstep,
                      loop)
    assert sorted(sig[1] for sig in lockstep) == ["cpu", "cuda"]
    assert sorted(len(jobs) for jobs in lockstep.values()) == [1, 1]
    assert len(groups) == 2 and loop == []
    assert counters()["service.requests.coalesced"] == 1
    srv.close(drain=False)


def test_deadline_expired_fails_cleanly_without_poisoning():
    srv = MappingServer()                  # paused: stage both requests
    doomed = srv.submit_problem(problem("latency"), engine="numpy",
                                deadline_s=0.0)
    ok = srv.submit_problem(problem(), engine="numpy")
    time.sleep(0.05)
    srv.start()
    resp = ok.result(timeout=300)          # healthy request unaffected
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=5)
    srv.close()
    want = OPTIMIZERS["rule_based"](problem(), engine="numpy")
    assert same_result(resp.result, want)
    assert counters()["service.requests.expired"] == 1


def test_portfolio_dedupe_coalesces_identical_problems():
    arch = reduced(get_arch("tinyllama-1.1b"))
    arch_b = reduced(get_arch("tinyllama-1.1b"), num_layers=2)
    plans = optimise_portfolio([arch, arch, arch_b], SHAPE, PLATFORM,
                               optimiser="rule_based", objective="throughput",
                               **CPU)
    assert counters()["pipeline.portfolio.coalesced"] == 1
    a, b, c = plans
    assert a.objective_value == b.objective_value
    assert a.partitions == b.partitions
    assert len(plans) == 3 and c.arch_name == arch_b.name


# ----------------------------------------------------------------------
# HTTP
# ----------------------------------------------------------------------

class _Served:
    """``serve_http`` of a started server on an ephemeral 127.0.0.1 port,
    serving from a thread; the base URL while in the ``with`` block."""

    def __init__(self, serve, srv):
        self.httpd = serve(srv, port=0)

    def __enter__(self):
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


def _post(base, route, body):
    req = urllib.request.Request(f"{base}{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def test_http_adapter_round_trip():
    """POST /v1/mapping and /v1/comap on the torch engine, each equal to
    the direct call; an unknown arch and the jax engine are 400s."""
    shape = {"name": TINY_SHAPES["train"][0], "seq_len": 256,
             "global_batch": 16, "mode": "train"}
    plat = {"name": "test-4x4", "mesh_axes": [["data", 4], ["model", 4]]}
    with MappingServer() as srv, _Served(serve_http, srv) as base:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.load(r) == {"ok": True}
        body = {"arch": "tinyllama-1.1b", "reduced": True,
                "shape": shape, "platform": plat,
                "optimiser": "rule_based", "engine": "torch",
                "objective": "throughput",
                "optimiser_kwargs": {"device": "cpu"}}
        out = _post(base, "/v1/mapping", body)
        want = OPTIMIZERS["rule_based"](
            make_problem(reduced(get_arch("tinyllama-1.1b")), SHAPE,
                         PLATFORM, "spmd", "throughput", "streaming"),
            device="cpu")
        assert out["engine"] == "torch"
        assert out["objective_value"] == want.evaluation.objective
        assert out["points"] == want.points
        comap = _post(base, "/v1/comap", {
            "archs": ["tinyllama-1.1b", "llama3.2-1b"],
            "reduced": True, "shape": shape, "platform": plat,
            "engine": "torch", "optimiser_kwargs": {"device": "cpu"}})
        plan = optimise_comapping(
            [reduced(get_arch(n)) for n in ("tinyllama-1.1b",
                                            "llama3.2-1b")],
            SHAPE, PLATFORM, device="cpu")
        assert comap["feasible"] and plan.feasible
        assert (comap["split_index"], comap["split"],
                comap["objective_value"], comap["points"]) == \
            (plan.split_index, list(plan.split), plan.objective_value,
             plan.result.points)
        assert [n["objective_value"] for n in comap["nets"]] == \
            [p.objective_value for p in plan.plans]
        for bad in ({"arch": "no-such-arch"},
                    dict(body, engine="jax")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/v1/mapping", bad)
            assert ei.value.code == 400
        with urllib.request.urlopen(f"{base}/metricsz",
                                    timeout=10) as r:
            snap = json.load(r)
        assert snap["counters"]["service.requests.completed"] >= 1


#: response fields that name the engine or time the request
_RUN_FIELDS = {"engine", "total_s"}


def test_http_round_trips_equal_the_reference_server():
    """The same POST /v1/mapping and /v1/comap bodies to the port's server
    (torch engine on the CPU) and to the JAX package's (numpy engine) give
    the same JSON: the plan summary, points, split, composite and each
    net's objective, throughput and latency."""
    ref = reference_service()
    shape = {"name": TINY_SHAPES["train"][0], "seq_len": 256,
             "global_batch": 16, "mode": "train"}
    plat = {"name": "test-4x4", "mesh_axes": [["data", 4], ["model", 4]]}
    mapping = [{"arch": "tinyllama-1.1b", "reduced": True, "shape": shape,
                "platform": plat, "optimiser": "rule_based",
                "objective": obj} for obj in ("throughput", "latency")]
    comap = {"archs": ["tinyllama-1.1b", "llama3.2-1b"], "reduced": True,
             "shape": shape, "platform": plat}
    port_kw = {"engine": "torch", "optimiser_kwargs": {"device": "cpu"}}
    answers = {}
    for name, serve, server, kw in (
            ("port", serve_http, MappingServer, port_kw),
            ("ref", ref.serve_http, ref.MappingServer,
             {"engine": "numpy"})):
        with server() as srv, _Served(serve, srv) as base:
            answers[name] = (
                [_post(base, "/v1/mapping", dict(b, **kw)) for b in mapping],
                _post(base, "/v1/comap", dict(comap, **kw)))
    (port_maps, port_comap), (ref_maps, ref_comap) = \
        answers["port"], answers["ref"]
    for got, want in zip(port_maps, ref_maps):
        assert (got["engine"], want["engine"]) == ("torch", "numpy")
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in _RUN_FIELDS} == \
            {k: v for k, v in want.items() if k not in _RUN_FIELDS}
    assert port_comap["feasible"] and len(port_comap["nets"]) == 2
    assert set(port_comap) == set(ref_comap)
    assert {k: v for k, v in port_comap.items() if k != "total_s"} == \
        {k: v for k, v in ref_comap.items() if k != "total_s"}


def test_solve_comap_and_parse_comap_request():
    from repro_torch.service.server import _parse_comap_request
    archs = [reduced(get_arch(n), num_layers=2)
             for n in ("tinyllama-1.1b", "llama3.2-1b")]
    with MappingServer() as srv:
        plan = srv.solve_comap(archs, SHAPE, PLATFORM, **CPU)
        want = optimise_comapping(archs, SHAPE, PLATFORM, **CPU)
        assert plan.feasible and len(plan.plans) == 2
        assert (plan.split, plan.objective_value, plan.result.history) == \
            (want.split, want.objective_value, want.result.history)
    with pytest.raises(ServiceClosed):
        srv.solve_comap(archs, SHAPE, PLATFORM, **CPU)
    kw = _parse_comap_request({
        "archs": ["tinyllama-1.1b", "llama3.2-1b"], "reduced": True,
        "objective": "maxmin_throughput", "weights": [2, 1],
        "splits": [[2, 2]], "engine": "torch",
        "optimiser_kwargs": {"device": "cpu", "multi_start": False}})
    assert [a.name for a in kw["archs"]] == ["tinyllama-1.1b",
                                             "llama3.2-1b"]
    assert kw["weights"] == [2.0, 1.0] and kw["splits"] == [[2, 2]]
    assert kw["device"] == "cpu" and kw["multi_start"] is False
    with pytest.raises(ValueError, match="single string"):
        _parse_comap_request({"archs": "tinyllama-1.1b"})


# ----------------------------------------------------------------------
# lockstep on the torch engine: concurrency, coalescing, late joiners
# ----------------------------------------------------------------------

def serve_threaded(srv, build, **kw):
    """8 threads x 3 seeded submissions of ``build(objective)`` to a
    started server: ``{(thread, i): (objective, response)}``. The requests
    issued are the same in every run."""
    results = {}
    res_lock = threading.Lock()

    def worker(tid):
        rng = random.Random(tid)           # seeded per thread: no flake
        for i in range(3):
            obj = rng.choice(("throughput", "latency"))
            resp = srv.submit_problem(build(obj), optimiser="rule_based",
                                      **kw).result(timeout=600)
            with res_lock:
                results[(tid, i)] = (obj, resp)
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_threaded_submissions_bit_identical_to_serial(monkeypatch):
    """8 threads x 3 seeded submissions, bitwise the serial direct runs;
    one ``fleet_rb_descend`` dispatch a round and two segred reductions a
    descent step, whatever the lane count."""
    want = {obj: direct(obj) for obj in ("throughput", "latency")}
    metrics.reset()
    steps, reduces = count_descent(monkeypatch)
    with MappingServer() as srv:
        results = serve_threaded(srv, problem, **CPU)
    assert len(results) == 24
    for obj, resp in results.values():
        assert resp.engine == "torch"
        assert same_result(resp.result, want[obj]), \
            f"threaded {obj} response differs from serial engine run"
    snap = counters()
    assert snap["service.engine_runs"] == 2
    assert snap["accel.dispatches.fleet_rb_descend"] == \
        snap["service.rounds"] > 0
    assert len(reduces) == 2 * len(steps)


def test_threaded_submissions_equal_the_reference_server():
    """The same 8 threads x 3 submissions to the port's server (the torch
    engine's lockstep rounds on the CPU) and to the JAX package's server
    (its numpy engine) give, request by request, the same design,
    objective, points, history and plan."""
    ref = reference_service()
    with MappingServer() as srv:
        got = serve_threaded(srv, problem, **CPU)
    with ref.MappingServer() as srv:
        want = serve_threaded(srv, reference_problem, engine="numpy")
    assert set(got) == set(want) and len(got) == 24
    for key, (obj, resp) in got.items():
        assert want[key][0] == obj
        assert (resp.engine, want[key][1].engine) == ("torch", "numpy")
        assert answer(resp) == answer(want[key][1]), (key, obj)
    assert counters()["service.engine_runs"] == 2


def test_duplicate_inflight_requests_coalesce_to_one_run(monkeypatch):
    srv = MappingServer()                  # paused: stage 4 duplicates
    futs = [srv.submit_problem(problem("throughput"), **CPU)
            for _ in range(4)]
    steps, reduces = count_descent(monkeypatch)
    srv.start()
    resps = [f.result(timeout=600) for f in futs]
    srv.close()
    snap = counters()
    assert snap["service.engine_runs"] == 1, \
        "4 identical in-flight requests must share one engine run"
    assert snap["service.requests.coalesced"] == 3
    assert snap["accel.dispatches.fleet_rb_descend"] == \
        snap["service.rounds"]
    # one lane: every reduction is over that lane's rows alone
    assert len(reduces) == 2 * len(steps) and reduces[0][0] == 1
    want = direct("throughput")
    for r in resps:
        assert same_result(r.result, want)
    assert sum(r.coalesced for r in resps) == 3


def test_cache_hit_bit_identical_on_resubmission():
    with MappingServer() as srv:
        first = srv.submit_problem(problem(), **CPU).result(600)
        again = srv.submit_problem(problem(), **CPU).result(600)
    assert not first.cached and again.cached
    assert same_result(first.result, again.result)
    assert same_result(again.result, direct())
    assert counters()["service.cache.hits"] == 1


def test_deadline_expiry_does_not_poison_lockstep_round():
    srv = MappingServer()
    doomed = srv.submit_problem(problem("latency"), deadline_s=0.0, **CPU)
    ok = srv.submit_problem(problem(), **CPU)
    time.sleep(0.05)
    srv.start()
    resp = ok.result(timeout=600)
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=5)
    srv.close()
    assert same_result(resp.result, direct())


def test_lockstep_late_joiner_and_restack(monkeypatch):
    """A job admitted mid-flight with a bigger graph grows the pads, which
    rebuilds the stack; both jobs stay bitwise their direct runs, and each
    round is one descent call over every lane of the stack."""
    from repro_torch.core.accel.fleet import _node_tier

    p1, p2 = problem("throughput"), problem("latency", num_layers=6)
    assert _node_tier(len(p2.graph.nodes)) > _node_tier(len(p1.graph.nodes))
    calls = [0]

    def poll():
        calls[0] += 1
        return [LockstepJob(p2, tag="late")] if calls[0] == 3 else []

    steps, reduces = count_descent(monkeypatch)
    done = run_rule_based_lockstep([LockstepJob(p1, tag="first")],
                                   poll=poll, device="cpu")
    results = {job.tag: res for job, res in done}
    assert set(results) == {"first", "late"}
    monkeypatch.undo()
    assert same_result(results["first"], direct("throughput"))
    assert same_result(results["late"], direct("latency", num_layers=6))
    snap = counters()
    assert snap["service.rounds"] == \
        snap["accel.dispatches.fleet_rb_descend"] > 2
    assert snap["service.rounds.restacks"] == 1
    assert snap["service.admissions"] == 2
    assert len(reduces) == 2 * len(steps)
    # rounds 1-2 hold one lane, later rounds two at the grown node pad
    lanes = {shape[0] for shape in reduces[::2]}
    assert lanes == {1, 2}
    assert {shape[1] for shape in reduces} == {
        _node_tier(len(p1.graph.nodes)), _node_tier(len(p2.graph.nodes))}


@pytest.mark.gpu
def test_card_service_equals_card_direct_run(monkeypatch):
    """On the card, a served request equals the card's direct run bitwise
    and its lockstep rounds launch segred twice a descent step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segred kernel has no CPU mode")
    want = OPTIMIZERS["rule_based"](problem(), device="cuda")
    steps = []
    step = TS._rb_step
    monkeypatch.setattr(TS, "_rb_step", lambda *a, **k: steps.append(1)
                        or step(*a, **k))
    segred.LAUNCHES = 0
    with MappingServer() as srv:
        resp = srv.submit_problem(problem(), engine="torch").result(600)
    assert same_result(resp.result, want)
    assert 0 < segred.LAUNCHES == 2 * len(steps)
