"""The port's copies of the JAX package's host layers agree with the
originals: configs, graph builder, platform, backends, performance model,
constraints, objectives, the numpy engine, the exporter, telemetry and
Algorithm 2's merge loop.

Two holds: the source text of every verbatim copy equals its original once
the package name is mapped back, and the copies compute the same things
(``BatchedEvaluator`` arrays, scalar ``Problem.evaluate``, ``build_hdgraph``
node fields) on every registered architecture (reduced) x train / prefill
/ decode x backend.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch  # noqa: F401

from _torch_support import (  # noqa: F401
    port_obs_reset,
    problem_pair,
    random_designs,
    to_port,
)
from repro.configs import ARCHS
from repro.core.backends import BACKENDS

SRC = Path(__file__).resolve().parents[1] / "src"

#: modules copied with only their import paths changed
VERBATIM = (
    "configs/__init__.py", "configs/base.py",
    "configs/granite_moe_1b_a400m.py", "configs/jamba_1_5_large_398b.py",
    "configs/kimi_k2_1t_a32b.py", "configs/llama3_2_1b.py",
    "configs/minitron_8b.py", "configs/qwen2_vl_72b.py",
    "configs/rwkv6_1_6b.py", "configs/stablelm_3b.py",
    "configs/tinyllama_1_1b.py", "configs/whisper_small.py",
    "core/hdgraph.py", "core/graph_builder.py", "core/platform.py",
    "core/backends.py", "core/perfmodel.py", "core/constraints.py",
    "core/objectives.py", "core/batched_eval.py", "obs/trace.py",
    "obs/metrics.py", "core/optimizers/common.py",
)

#: copies that change one named part; the text from the marker on (or up
#: to it) must still equal the original's
PARTIAL = {
    # the port emits no jax PartitionSpecs: _pspec raises
    "core/exporter.py": ("from", "@dataclass(frozen=True)\nclass KindPlan"),
    # optimise() takes engine="torch" and a device
    "core/optimizers/rule_based.py": ("upto", "def optimise("),
}


def _texts(rel):
    orig = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    return orig, port.replace("repro_torch", "repro")


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_original(rel):
    orig, port = _texts(rel)
    assert port == orig, f"src/repro_torch/{rel} drifted from src/repro/{rel}"


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_partial_copy_matches_original_outside_its_change(rel):
    how, marker = PARTIAL[rel]
    orig, port = _texts(rel)
    assert marker in orig and marker in port
    if how == "from":
        assert port[port.index(marker):] == orig[orig.index(marker):]
    else:
        assert port[:port.index(marker)] == orig[:orig.index(marker)]


def _node_fields(graph):
    return [dataclasses.astuple(n) for n in graph.nodes]


def _assert_same_bev(ref, port):
    rb, pb = ref.batched(), port.batched()
    rv = {k: v for k, v in vars(rb).items()
          if k not in ("graph", "platform", "opts", "_real_memo")}
    pv = {k: v for k, v in vars(pb).items()
          if k not in ("graph", "platform", "opts", "_real_memo")}
    assert sorted(rv) == sorted(pv)
    for k, a in rv.items():
        b = pv[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k
    assert dataclasses.astuple(rb.opts) == dataclasses.astuple(pb.opts)
    np.testing.assert_array_equal(rb.platform_scalars(),
                                  pb.platform_scalars())


def _assert_same_eval(ref, port, designs):
    for v in designs:
        a, b = ref.evaluate(v), port.evaluate(to_port(v))
        assert a.objective == b.objective
        assert a.feasible == b.feasible
        assert a.violations == b.violations
        assert a.partition_times == b.partition_times
        assert a.latency == b.latency and a.throughput == b.throughput
        assert [dataclasses.astuple(e) for e in a.node_evals] == \
            [dataclasses.astuple(e) for e in b.node_evals]
    rb, pb = ref.batched(), port.batched()
    packed = rb.pack(designs)
    ra, pa = rb.evaluate_batch(*packed), pb.evaluate_batch(*packed)
    for f in dataclasses.fields(ra):
        np.testing.assert_array_equal(getattr(ra, f.name),
                                      getattr(pa, f.name), err_msg=f.name)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_host_layers_agree(arch_name, mode):
    for backend in sorted(BACKENDS):
        ref, port = problem_pair(arch_name, mode, backend=backend)
        assert _node_fields(ref.graph) == _node_fields(port.graph)
        assert (ref.graph.arch_name, ref.graph.shape_name, ref.graph.mode) \
            == (port.graph.arch_name, port.graph.shape_name, port.graph.mode)
        assert ref.graph.cut_edges == port.graph.cut_edges
        _assert_same_bev(ref, port)
        _assert_same_eval(ref, port, random_designs(ref, 6, seed=len(mode)))


def test_registry_and_shapes_agree():
    import repro.configs as rc
    import repro_torch.configs as tc
    assert sorted(rc.ARCHS) == sorted(tc.ARCHS)
    for name in rc.ARCHS:
        assert dataclasses.astuple(rc.ARCHS[name]) == \
            dataclasses.astuple(tc.ARCHS[name])
        assert dataclasses.astuple(rc.reduced(rc.ARCHS[name])) == \
            dataclasses.astuple(tc.reduced(tc.ARCHS[name]))
    assert {k: dataclasses.astuple(v) for k, v in rc.SHAPES_BY_NAME.items()} \
        == {k: dataclasses.astuple(v) for k, v in tc.SHAPES_BY_NAME.items()}


def test_default_platform_agrees():
    from repro.core.platform import V5E_POD as R
    from repro_torch.core.platform import V5E_POD as T
    assert dataclasses.astuple(R) == dataclasses.astuple(T)
    assert R.fold_values() == T.fold_values()
    assert R.realizable_folds() == T.realizable_folds()


def test_exporter_plans_agree_and_spec_methods_are_not_ported():
    """``export_plan`` is the original's; the PartitionSpec constructors
    (which need jax) raise until the launch layer is ported."""
    ref, port = problem_pair("qwen2-vl-72b", "prefill")
    from repro.core.exporter import export_plan as r_export
    from repro_torch.core.exporter import export_plan as t_export
    for v in random_designs(ref, 5, seed=4):
        a = r_export(ref.graph, v, ref.platform, "streaming")
        b = t_export(port.graph, to_port(v), port.platform, "streaming")
        assert [(p.index, p.node_indices, sorted(
            (k, dataclasses.astuple(kp)) for k, kp in p.kinds.items()))
            for p in a.partitions] == [(p.index, p.node_indices, sorted(
                (k, dataclasses.astuple(kp)) for k, kp in p.kinds.items()))
            for p in b.partitions]
        assert b.dp_axes() == a.dp_axes()
        with pytest.raises(NotImplementedError, match="item 15"):
            b.data_spec()
