"""The rule-based optimiser on the port's torch engine (``device="cpu"``:
the kernels' plain versions) against the JAX package's jax and scalar
engines: identical probe points, final design, merge history and objective
— on the reduced tinyllama-1.1b across backends and objectives, and at full
width on train_4k / V5E_POD (``test_torch_full_width.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

from _torch_support import (  # noqa: E402,F401
    port_obs_reset,
    problem_pair,
    to_port,
)
from repro.core.backends import BACKENDS  # noqa: E402
from repro.core.optimizers import rule_based as ref_rule_based  # noqa: E402
from repro_torch.core.accel import EngineUnavailable  # noqa: E402
from repro_torch.core.optimizers import rule_based  # noqa: E402


def _assert_rb_identical(ref, got, label):
    assert got.points == ref.points, label
    assert got.variables == to_port(ref.variables), label
    assert got.history == ref.history, label
    assert got.evaluation.objective == ref.evaluation.objective, label


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_torch_engine_equals_jax_and_scalar(backend, objective):
    ref, port = problem_pair("tinyllama-1.1b", "train", backend=backend,
                             objective=objective)
    got = rule_based(port, engine="torch", device="cpu")
    for engine in ("jax", "scalar"):
        ref, _ = problem_pair("tinyllama-1.1b", "train", backend=backend,
                              objective=objective)
        _assert_rb_identical(ref_rule_based(ref, engine=engine), got,
                             (backend, objective, engine))


def _plan_fields(plan):
    return (plan.arch_name, plan.shape_name, plan.mode, plan.exec_model,
            plan.platform.name, plan.objective_value, plan.throughput,
            plan.latency,
            [(p.index, p.node_indices, p.layer_start, p.layer_end,
              p.has_embed, p.has_head, p.has_final_norm, p.enc_start,
              p.enc_end, sorted((k, dataclasses.astuple(kp))
                                for k, kp in p.kinds.items()))
             for p in plan.partitions])


@pytest.mark.parametrize("exec_model,objective", [("streaming", "throughput"),
                                                  ("spmd", "latency")])
def test_optimise_mapping_plans_equal_repro(exec_model, objective):
    from repro.configs import get_arch as r_arch, reduced as r_reduced
    from repro.configs.base import ShapeSpec as RShape
    from repro.core.pipeline import optimise_mapping as r_optimise
    from repro.core.platform import Platform as RPlat
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import Platform

    arch_name = "whisper-small"
    want = r_optimise(r_reduced(r_arch(arch_name)),
                      RShape("train_tiny", 256, 16, "train"),
                      RPlat(name="t-4x4",
                            mesh_axes=(("data", 4), ("model", 4))),
                      objective=objective, exec_model=exec_model,
                      engine="jax")
    got = optimise_mapping(reduced(get_arch(arch_name)),
                           ShapeSpec("train_tiny", 256, 16, "train"),
                           Platform(name="t-4x4",
                                    mesh_axes=(("data", 4), ("model", 4))),
                           objective=objective, exec_model=exec_model,
                           engine="torch", device="cpu")
    assert _plan_fields(got) == _plan_fields(want)


def test_float64_and_dense_route_walk_the_same_moves():
    ref, _ = problem_pair("tinyllama-1.1b", "train", backend="megatron",
                          objective="latency")
    want = ref_rule_based(ref, engine="scalar")
    from repro_torch.core.accel.search_loops import DeviceRuleBased
    from repro_torch.core.optimizers.rule_based import _algorithm2, drive
    for kw in ({"dtype": torch.float64}, {"use_kernel": False}):
        _, port = problem_pair("tinyllama-1.1b", "train", backend="megatron",
                               objective="latency")
        rb = DeviceRuleBased(port, device="cpu", **kw)
        got = drive(_algorithm2(port), rb.descend)
        _assert_rb_identical(want, got, kw)


def test_cap_zero_descent_is_a_no_op():
    from repro_torch.core.accel.search_loops import (
        DeviceRuleBased,
        _rb_descend_core,
    )
    from repro_torch.core.hdgraph import partitions_from_cuts
    from repro_torch.core.optimizers.common import repair
    _, port = problem_pair("llama3.2-1b", "train", backend="megatron")
    v0 = repair(port, port.backend.initial(port.graph))
    rb0 = DeviceRuleBased(port, device="cpu")
    si, so, kk, cb, pm, pidx, _ = rb0.pack_request(v0, partitions_from_cuts(
        port.graph, v0.cuts)[0])
    t = torch.from_numpy
    o = _rb_descend_core(rb0.static, rb0.gran, rb0.A, rb0.menus,
                         rb0.menu_sizes, rb0.clamp, t(si), t(so), t(kk),
                         t(cb), t(pm), pidx, rb0.amort, 0)
    np.testing.assert_array_equal(o[0].numpy(), si)
    np.testing.assert_array_equal(o[1].numpy(), so)
    np.testing.assert_array_equal(o[2].numpy(), kk)
    assert int(o[3]) == 0


def test_engine_selection_and_errors(monkeypatch):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pipeline import optimise_mapping
    _, port = problem_pair("tinyllama-1.1b", "train", backend="simple")
    with pytest.raises(ValueError, match="unknown engine"):
        rule_based(port, engine="jax")
    with pytest.raises(ValueError, match="device= applies"):
        rule_based(port, engine="numpy", device="cpu")
    arch = reduced(get_arch("tinyllama-1.1b"))
    shape = ShapeSpec("train_tiny", 256, 16, "train")
    # devices=2 reaches the sharded brute-force chunks: two logical CPU
    # shards, the plan of the unsharded run
    bf = dict(optimiser="brute_force", max_points=200, batch_size=64,
              device="cpu")
    assert optimise_mapping(arch, shape, devices=2, **bf) == \
        optimise_mapping(arch, shape, **bf)
    with pytest.raises(ValueError, match="unknown optimiser"):
        optimise_mapping(arch, shape, optimiser="genetic")
    # no card and no device="cpu": the default engine raises, it does not
    # carry on on the CPU (auto and the default both resolve to torch),
    # for each of the three optimisers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"engine": "auto"}, {"engine": "torch"}):
        with pytest.raises(EngineUnavailable):
            rule_based(port, **kw)
    for name in ("rule_based", "brute_force", "annealing"):
        with pytest.raises(EngineUnavailable):
            optimise_mapping(arch, shape, optimiser=name)


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_propagate_and_scatter_match_jax(backend, mode):
    """``propagate_torch`` and ``_scatter_triple`` against the JAX ports on
    random fold arrays and random legal cut masks (identical constants)."""
    import jax.numpy as jnp
    from repro.core.accel.eval_jax import JaxEvaluator
    from repro.core.accel.search_loops import (
        _scatter_triple as jax_scatter,
        build_sa_tables as jax_tables,
        propagate_jax,
    )
    from repro_torch.core.accel.lowering import tensors_from_numpy
    from repro_torch.core.accel.search_loops import (
        _scatter_triple,
        build_sa_tables,
        propagate_torch,
    )
    from repro_torch.core.accel.eval_torch import TorchEvaluator

    ref, port = problem_pair("jamba-1.5-large-398b", mode, backend=backend)
    jev = JaxEvaluator.from_problem(ref)
    fields = {k: np.asarray(v) for k, v in jev.arrays._asdict().items()}
    tev = TorchEvaluator.from_problem(
        port, arrays=tensors_from_numpy(fields, device="cpu"))
    menus, sizes, clamp, _, gran, _ = build_sa_tables(port)
    for a, b in zip(build_sa_tables(port)[:4], jax_tables(ref)[:4]):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(len(backend) + len(mode))
    C, n = 64, len(port.graph.nodes)
    pick = lambda vi: np.take_along_axis(
        menus[vi], rng.integers(0, sizes[vi][:, None], (n, C)), 1).T
    si, so, kk = pick(0), pick(1), pick(2)
    cb = (rng.random((C, n - 1)) < 0.2) & fields["cut_allowed"][None, :]
    i = rng.integers(0, n, C)
    v3 = np.stack([menus[vi][i, rng.integers(0, sizes[vi][i])]
                   for vi in range(3)])
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))
    j = lambda x: jnp.asarray(x)
    got = propagate_torch(tev.static, tev.arrays, t(si), t(so), t(kk),
                          torch.from_numpy(cb))
    want = propagate_jax(jev.static, jev.arrays, j(si), j(so), j(kk), j(cb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = _scatter_triple(tev.static, gran, tev.arrays, t(clamp), t(si),
                          t(so), t(kk), torch.from_numpy(cb), t(i), t(v3))
    want = jax_scatter(jev.static, gran, jev.arrays, j(clamp), j(si), j(so),
                       j(kk), j(cb), j(i), j(v3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
