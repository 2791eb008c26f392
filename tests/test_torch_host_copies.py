"""The port's copies of the JAX package's host layers agree with the
originals: configs, graph builder, platform, backends, performance model,
constraints, objectives, the numpy engine, the exporter, telemetry,
Algorithm 2's merge loop, brute force's and annealing's host engines, the
brute-force chunk helpers, the SA move tables, the fleet's host helpers,
the problem fingerprint, the co-mapping joint search, and the service's
cache, queue and server.

Two holds: the source text of every verbatim copy equals its original once
the package name is mapped back (for the optimisers whose engine dispatch
changes, and for the numpy helpers of the device search loops, statement by
statement), and the copies compute the same things
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
    "runtime/fault_tolerance.py", "runtime/stragglers.py",
)

#: copies that change one named part; the text from the marker on (or up
#: to it) must still equal the original's
PARTIAL = {
    # _pspec gives the port's own PartitionSpec, not jax's
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


#: copies whose engine dispatch changes: every top-level statement but the
#: module docstring and the named ones must equal the original's, in order
#: (the jax engine's entry becomes the torch engine's)
PIECEWISE = {
    "core/optimizers/brute_force.py": {"optimise"},
    "core/optimizers/annealing.py": {"optimise", "_optimise_jax",
                                     "_optimise_torch"},
    # the fleet branch takes the torch engine and ``device``
    "core/comap.py": {"FLEET_KWARGS", "joint_search"},
    # only the docstring differs
    "service/cache.py": set(),
    # the lockstep rounds run the port's lane-stacked descent on a device
    "service/queue.py": {"run_rule_based_lockstep"},
    # the lockstep route takes the torch engine, keyed by device too
    "service/server.py": {"_LOCKSTEP_KW", "MappingServer._classify",
                          "MappingServer._process"},
}
#: the entry point each piecewise copy must still define
PIECEWISE_ENTRY = {
    "core/optimizers/brute_force.py": "optimise",
    "core/optimizers/annealing.py": "optimise",
    "core/comap.py": "joint_search",
    "service/cache.py": "SolvedCache",
    "service/queue.py": "run_rule_based_lockstep",
    "service/server.py": "MappingServer",
}


def _statements(text):
    """(name, source) of each top-level statement after the docstring; a
    class is its header (up to its first member) and then each member,
    named ``Class.member``."""
    import ast
    lines = text.splitlines()
    body = ast.parse(text).body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]

    def name_of(node):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            return getattr(target, "id", None)
        return getattr(node, "name", None)

    def start_of(node):
        return min([node.lineno] + [d.lineno for d in getattr(
            node, "decorator_list", [])])

    out = []
    for node in body:
        name, start = name_of(node), start_of(node)
        if isinstance(node, ast.ClassDef):
            members = [m for m in node.body
                       if not (isinstance(m, ast.Expr)
                               and isinstance(m.value, ast.Constant))]
            first = start_of(members[0]) if members else node.end_lineno + 1
            out.append((name, "\n".join(lines[start - 1:first - 1])))
            for m in members:
                out.append((f"{name}.{name_of(m)}", "\n".join(
                    lines[start_of(m) - 1:m.end_lineno])))
            continue
        out.append((name, "\n".join(lines[start - 1:node.end_lineno])))
    return out


@pytest.mark.parametrize("rel", sorted(PIECEWISE))
def test_piecewise_copy_matches_original_outside_its_dispatch(rel):
    orig, port = _texts(rel)
    keep = lambda text: [st for st in _statements(text)
                         if st[0] not in PIECEWISE[rel]]
    assert keep(port) == keep(orig)
    names = {name for name, _ in _statements(port)}
    assert PIECEWISE_ENTRY[rel] in names
    assert not [n for n in names if n and "jax" in n]


#: numpy helpers of JAX modules that the port copies into its own module of
#: the same path, statement by statement
HELPER_VERBATIM = {
    "core/accel/search_loops.py": ("_pow2ceil", "_construction_tables",
                                   "chunk_descriptor",
                                   "absorb_improvements", "build_sa_tables"),
    "core/accel/fleet.py": ("_pad_lanes", "NODE_TIER", "_node_tier",
                            "_platform_pads", "_bucket_key", "bucket_key",
                            "bucket_indices", "_BFMember", "_bucket_tables"),
    "core/accel/lowering.py": ("FINGERPRINT_ARRAYS",
                               "FINGERPRINT_INDEX_SETS"),
    "checkpoint/checkpoint.py": ("MANIFEST", "_flatten", "latest_step",
                                 "_gc", "CheckpointManager"),
    "checkpoint/elastic.py": ("shrink_batch_for_mesh",),
}


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in
                                      sorted(HELPER_VERBATIM.items())
                                      for name in names])
def test_helper_copy_matches_original(rel, name):
    assert _top_level_source(SRC / "repro_torch" / rel, name) == \
        _top_level_source(SRC / "repro" / rel, name)


#: the data pipeline's host part: the numpy stream and its positioning,
#: statement by statement (``batch_at`` hands the rows to torch instead)
PIPELINE_VERBATIM = ("DataPipeline.__post_init__", "DataPipeline._sequence",
                     "DataPipeline.skip_to", "DataPipeline.step")


def test_pipeline_numpy_part_matches_original():
    rel = "data/pipeline.py"
    orig, port = (dict(_statements(t)) for t in _texts(rel))
    for name in PIPELINE_VERBATIM:
        assert port[name] == orig[name], name


def _split_engine_pin(text):
    """(the text without the statement that pins the engine knob and the
    comment above it, that statement)."""
    lines = text.splitlines()
    i = next(k for k, line in enumerate(lines)
             if "static = build_static_spec(" in line)
    j = i
    while not lines[j].rstrip().endswith(")"):
        j += 1
    k = i
    while lines[k - 1].lstrip().startswith("#"):
        k -= 1
    return "\n".join(lines[:k] + lines[j + 1:]), "\n".join(lines[i:j + 1])


def test_problem_fingerprint_copy_matches_original():
    """``problem_fingerprint`` is the original's statement for statement,
    except that it pins the port's engine knob (``use_kernel``) where the
    original pins ``use_pallas`` and its interpret mode."""
    rel = "core/accel/lowering.py"
    port, port_pin = _split_engine_pin(
        _top_level_source(SRC / "repro_torch" / rel, "problem_fingerprint"))
    orig, orig_pin = _split_engine_pin(
        _top_level_source(SRC / "repro" / rel, "problem_fingerprint"))
    assert port == orig
    assert port_pin.strip() == \
        "static = build_static_spec(bev, use_kernel=False)"
    assert "use_pallas=False" in orig_pin


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
    """``export_plan`` is the original's, and so are the plan's four
    PartitionSpec constructors (``data_spec``, ``act_spec``,
    ``kv_cache_spec``, ``spec_for_role`` of every role with ``stacked`` 0
    and 1), compared as tuples on every partition. The name is
    historical: the port's spec methods once raised, and now emit the
    port's own ``PartitionSpec``."""
    ref, port = problem_pair("qwen2-vl-72b", "prefill")
    from repro.core.exporter import export_plan as r_export
    from repro_torch.core.exporter import export_plan as t_export
    from repro_torch.core.partition_spec import PartitionSpec
    for v in random_designs(ref, 5, seed=4):
        a = r_export(ref.graph, v, ref.platform, "streaming")
        b = t_export(port.graph, to_port(v), port.platform, "streaming")
        assert [(p.index, p.node_indices, sorted(
            (k, dataclasses.astuple(kp)) for k, kp in p.kinds.items()))
            for p in a.partitions] == [(p.index, p.node_indices, sorted(
                (k, dataclasses.astuple(kp)) for k, kp in p.kinds.items()))
            for p in b.partitions]
        assert b.dp_axes() == a.dp_axes()
        for pi in range(len(b.partitions)):
            for what in ("data_spec", "act_spec", "kv_cache_spec"):
                got = getattr(b, what)(pi)
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == tuple(getattr(a, what)(pi)), (what, pi)
            for kind in sorted({k for p in b.partitions for k in p.kinds}):
                for role in ("col", "row", "expert", "table", "head",
                             "replicate"):
                    for stacked in (0, 1):
                        assert tuple(b.spec_for_role(
                            role, 3, kind, pi, stacked)) == tuple(
                            a.spec_for_role(role, 3, kind, pi, stacked)), \
                            (kind, role, stacked, pi)


# ----------------------------------------------------------------------
# the LM layers (models/layers.py, models/model.py)
# ----------------------------------------------------------------------

#: pieces of the JAX LM modules the port copies verbatim, by file: the
#: source text of each named top-level statement must match
LM_VERBATIM = {
    "models/layers.py": ("PARAM_ROLES",),
    "models/model.py": ("Segment", "build_segments"),
}


def _top_level_source(path, name):
    import ast
    text = path.read_text()
    for node in ast.parse(text).body:
        names = {getattr(node, "name", None)}
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {getattr(t, "id", None) for t in targets}
        if name in names:
            start = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", [])])
            lines = text.splitlines()[start - 1:node.end_lineno]
            return "\n".join(lines).replace("repro_torch", "repro")
    raise AssertionError(f"{name} not found in {path}")


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in
                                      sorted(LM_VERBATIM.items())
                                      for name in names])
def test_lm_verbatim_piece_matches_original(rel, name):
    assert _top_level_source(SRC / "repro_torch" / rel, name) == \
        _top_level_source(SRC / "repro" / rel, name)


def test_param_roles_and_segments_agree():
    from repro.models.layers import PARAM_ROLES as R_ROLES
    from repro.models.model import build_segments as r_segments
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.models.layers import PARAM_ROLES as T_ROLES
    from repro_torch.models.model import build_segments as t_segments
    assert R_ROLES == T_ROLES
    for name in sorted(ARCHS):
        n = ARCHS[name].num_layers
        for lr in (None, (0, n), (1, n), (0, max(1, n // 2))):
            a = r_segments(ARCHS[name], lr)
            b = t_segments(T_ARCHS[name], lr)
            assert [dataclasses.astuple(s) for s in a] == \
                [dataclasses.astuple(s) for s in b], (name, lr)


def _jt(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _np32(x):
    import jax.numpy as jnp
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_matches_jax(kind, dtype):
    import jax.numpy as jnp
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(0)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 5, 64), (64,), (64,)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = RL.apply_norm(_jt(x).astype(jd), _jt(scale).astype(jd),
                         _jt(bias).astype(jd) if kind == "ln" else None, kind)
    got = TL.apply_norm(torch.from_numpy(x).to(td),
                        torch.from_numpy(scale).to(td),
                        torch.from_numpy(bias).to(td) if kind == "ln"
                        else None, kind)
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def test_rope_and_mrope_match_jax():
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 6)).astype(np.int32)
    pos3 = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        _np32(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            1e4)),
        _np32(RL.apply_rope(_jt(x), _jt(pos), 1e4)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np32(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e6)),
        _np32(RL.apply_mrope(_jt(x), _jt(pos3), 1e6)), atol=2e-5,
        rtol=2e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu_sq"])
def test_ffn_matches_jax_and_init_shapes_agree(act):
    import jax
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    jp = RL.init_ffn(jax.random.PRNGKey(0), 32, 48, act, "rms")
    tp = TL.init_ffn(None, 32, 48, act, "rms", device="meta")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tp.items()}
    params = {k: np.array(v, np.float32) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = RL.apply_ffn(_jt(x), {k: _jt(v) for k, v in params.items()}, act,
                        "rms")
    got = TL.apply_ffn(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in params.items()},
                       act, "rms")
    np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_blocks_match_jax(with_state):
    """Time mix and channel mix, float32, with and without a carried decode
    state (the state branch takes the oracle with that state)."""
    import jax
    from repro.models import rwkv as RR
    from repro_torch.models import rwkv as TR
    D, hs, B, S = 64, 16, 2, 7
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    tm = {k: np.array(v, np.float32) for k, v in RR.init_rwkv_tmix(
        jax.random.PRNGKey(1), D, hs, "ln").items()}
    cm = {k: np.array(v, np.float32) for k, v in RR.init_rwkv_cmix(
        jax.random.PRNGKey(2), D, 96, "ln").items()}
    state_t = state_c = None
    if with_state:
        state_t = {"shift": rng.standard_normal((B, D)).astype(np.float32),
                   "wkv": 0.1 * rng.standard_normal(
                       (B, D // hs, hs, hs)).astype(np.float32)}
        state_c = {"shift": rng.standard_normal((B, D)).astype(np.float32)}

    def jx(tree):
        return None if tree is None else {k: _jt(v) for k, v in tree.items()}

    def tx(tree):
        return None if tree is None else {k: torch.from_numpy(v)
                                          for k, v in tree.items()}

    for jf, tf, p, st, kw in (
            (RR.apply_rwkv_tmix, TR.apply_rwkv_tmix, tm, state_t,
             {"head_size": hs}),
            (RR.apply_rwkv_cmix, TR.apply_rwkv_cmix, cm, state_c, {})):
        want, want_s = jf(_jt(x), jx(p), norm="ln", state=jx(st), **kw)
        got, got_s = tf(torch.from_numpy(x), tx(p), norm="ln", state=tx(st),
                        **kw)
        np.testing.assert_allclose(_np32(got), _np32(want), atol=1e-4,
                                   rtol=1e-4)
        assert (got_s is None) == (want_s is None)
        for k in (want_s or {}):
            np.testing.assert_allclose(_np32(got_s[k]), _np32(want_s[k]),
                                       atol=1e-4, rtol=1e-4)
