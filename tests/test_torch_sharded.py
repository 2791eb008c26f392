"""The port's sharded steps on a mesh of more than one device: parameters,
optimiser state, batch and cache as DTensors laid out from a plan's specs
(``core/partition_spec.placements``), the shard functions as
redistributions, and ``checkpoint/elastic.reshard_tree``.

One spawn of four CPU ranks on a gloo group (``_torch_sharded_ranks.py``,
a 2 x 2 ``("data", "model")`` mesh) runs reduced tinyllama-1.1b and
granite-moe-1b-a400m in float32; each result is held here against the
port's one-device steps (the train step with ZeRO-1 on and off on three
plans; a prefill and two greedy decode steps), and every parameter's
shard against the shards JAX's ``reshard_tree`` gives on four fake devices
(a subprocess: the device count is fixed before jax starts). The shard
functions' (kind, role) -> spec map is held against JAX's, whose
``with_sharding_constraint`` is recorded by patching it here. On a card
only: the train step on a 1 x 1 NCCL mesh, bitwise the host mesh's."""
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.core import exporter as r_exporter
    from repro.core.platform import Platform as RPlatform
    from repro.kernels import ref as r_ref
    from repro.launch import steps as r_steps
    from repro.launch.mesh import make_host_mesh as r_host_mesh
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

import _torch_sharded_ranks as ranks
from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import get_arch, reduced
from repro_torch.core.partition_spec import P, placements
from repro_torch.kernels import ref as port_ref
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models.model import Model

REPO = Path(__file__).resolve().parents[1]
#: losses relative; parameters, master, m, v and logits within this share
#: of each tensor's largest magnitude (the train step's contract)
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
TRAIN_CASES = ("tp", "tp-zero1", "dp-zero1", "sp-zero1")
#: granite-moe-1b-a400m's vocabulary, an uneven dimension over 16 shards
VOCAB, SHARDS = 49155, 16

#: JAX's side of the layout check, run in its own process: every
#: parameter's shard (offset, shape) by rank after ``reshard_tree`` on a
#: 2 x 2 mesh of 4 of 16 fake CPU devices (device [i, j] is rank 2i + j),
#: and the row counts of a (VOCAB, 8) tensor that a compiled JAX program
#: holds on a device once it is sharded over 16 (a ``jax.Array`` cannot be
#: sharded unevenly; inside a program GSPMD pads the last shard)
_JAX_LAYOUTS = r"""
import json, re, sys
from repro import runtime_config
runtime_config.fake_devices(16)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.elastic import reshard_tree
from repro.configs import get_arch
from repro.configs.base import reduced
from repro.core.exporter import KindPlan, PartitionPlan, ShardingPlan
from repro.core.platform import Platform
from repro.models.model import Model

req = json.loads(sys.argv[1])
devs = np.array(jax.devices()[:4]).reshape(2, 2)
rank = {d.id: 2 * i + j for (i, j), d in np.ndenumerate(devs)}
mesh = Mesh(devs, ("data", "model"))
out = {"layouts": {}}
for name, plans in req["plans"].items():
    arch = reduced(get_arch(name))
    model = Model(arch)
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          model.param_shapes())
    for tag, (mode, kinds) in plans.items():
        kp = {k: KindPlan(k, 1, 1, 1, tuple(r), tuple(c), tuple(b))
              for k, (b, r, c) in kinds.items()}
        plan = ShardingPlan(name, mode, mode, "spmd", Platform(
            name="t-2x2", mesh_axes=(("data", 2), ("model", 2))),
            [PartitionPlan(0, [], kp, 0, arch.num_layers, True, True, True)])
        placed = reshard_tree(params, model.param_specs(plan), mesh)
        leaves = {}
        for path, a in jax.tree_util.tree_flatten_with_path(placed)[0]:
            key = ".".join(p.key for p in path)
            leaves[key] = {rank[s.device.id]: [[sl.start or 0 for sl in s.index],
                                               list(s.data.shape)]
                           for s in a.addressable_shards}
        out["layouts"].setdefault(name, {})[tag] = leaves
row = Mesh(np.array(jax.devices()[:16]), ("model",))
rep = NamedSharding(row, P())
f = jax.jit(lambda t: jax.lax.with_sharding_constraint(
    t * 2.0, NamedSharding(row, P("model", None))).sum(0),
    in_shardings=rep, out_shardings=rep)
hlo = f.lower(jax.ShapeDtypeStruct((req["vocab"], 8), jnp.float32)
              ).compile().as_text()
out["uneven"] = sorted({int(m) for m in re.findall(r"f32\[(\d+),8\]", hlo)})
print(json.dumps(out))
"""


def _need_jax():
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")


def _kinds(plan):
    part = plan.partitions[0]
    return {k: [list(kp.batch_axes), list(kp.rows_axes), list(kp.cols_axes)]
            for k, kp in part.kinds.items()}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The four ranks' results, JAX's layouts beside them (the JAX
    subprocess runs while the ranks do)."""
    _need_jax()
    d = tmp_path_factory.mktemp("sharded")
    req = {"vocab": VOCAB, "plans": {}}
    for name in ranks.ARCHS:
        ps = ranks.plans(ranks.arch_of(name))
        req["plans"][name] = {t: [ps[t].mode, _kinds(ps[t])]
                              for t in ("tp", "prefill")}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [
                   str(REPO / "src"), os.environ.get("PYTHONPATH")])))
    ref = subprocess.Popen([sys.executable, "-c", _JAX_LAYOUTS,
                            json.dumps(req)], cwd=REPO, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.main,
                         args=(r, 4, str(d / "init"), str(d)))
             for r in range(4)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        assert not any(p.is_alive() for p in procs), "a rank hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    got = [torch.load(d / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    for r, res in enumerate(got):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return got, json.loads(out)


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device steps (host mesh, plain tensors) on the same
    seeds: each train case and the serve run."""
    host = port_mesh.make_host_mesh("cpu")
    out = {"train": {}, "serve": {}}
    for name in ranks.ARCHS:
        arch = ranks.arch_of(name)
        ps = ranks.plans(arch)
        out["train"][name] = ranks.run_train(arch, ps["tp"], host, False,
                                             ("data",))
        out["serve"][name] = ranks.run_serve(arch, ps, host)
    return out


def _close(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert got.shape == want.shape and err <= tol * scale, (what, err, scale)


def _update_close(got, want, m_want, what):
    """A parameter (or master) after one AdamW step within LEAF_TOL of its
    leaf's max, but where its gradient (read from the one-device first
    moment, which is linear in it) lies within LEAF_TOL of zero: there the
    first step's direction g / (|g| + eps) is not fixed by a gradient held
    at that contract (the shards sum it in another order), and the
    element may move by up to 2 lr more (``tests/test_torch_partition.py``'s
    rule)."""
    tol = LEAF_TOL * float(want.abs().max())
    loose = m_want.abs() <= LEAF_TOL * float(m_want.abs().max())
    err = (got - want).abs()
    assert bool((err[~loose] <= tol).all()), \
        (what, float(err[~loose].max()), tol)
    assert bool((err <= tol + 2 * ranks.LR).all()), what


# ----------------------------------------------------------------------
# layouts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ranks.ARCHS)
@pytest.mark.parametrize("tag", ("tp", "prefill"))
def test_every_shard_equals_jax(sharded, name, tag):
    """Each parameter's shard on each rank (global offset and shape)
    equals the shard JAX's ``reshard_tree`` puts on the same mesh
    position."""
    got, ref = sharded
    want = ref["layouts"][name][tag]
    for r in range(4):
        mine = got[r]["layouts"][name][tag]
        assert set(mine) == set(want)
        for k, (offset, shape) in mine.items():
            assert [list(offset), list(shape)] == want[k][str(r)], (k, r)


def test_uneven_dimension_shards_as_jax(sharded):
    """Granite's vocabulary (49,155 rows) over 16 shards: JAX's program
    holds ceil(n / 16) = 3,073 rows a device (the last padded); DTensor's
    shards are rows [3,073 r, 3,073 (r + 1)), the last short (3,060), so
    each device holds the rows JAX's does."""
    from torch.distributed.tensor import Shard
    chunk = -(-VOCAB // SHARDS)
    assert chunk in sharded[1]["uneven"]
    got = [Shard.local_shard_size_and_offset(VOCAB, SHARDS, r)
           for r in range(SHARDS)]
    assert got == [(min(chunk, VOCAB - r * chunk), r * chunk)
                   for r in range(SHARDS)]
    assert got[-1] == (3060, 15 * 3073)
    assert placements(P("model", None), ("model",)) == [Shard(0)]


def test_placements_rules():
    """Specs as placements: one a mesh dimension; several axes on one
    dimension shard it major to minor in mesh order; the other order, an
    axis named twice, an unknown axis and an uneven dimension over
    several axes raise."""
    from torch.distributed.tensor import Replicate, Shard
    axes, sizes = ("data", "model"), {"data": 2, "model": 4}
    assert placements(P(), axes) == [Replicate(), Replicate()]
    assert placements(None, axes) == [Replicate(), Replicate()]
    assert placements(P(None, "model"), axes) == [Replicate(), Shard(1)]
    assert placements(P(("data", "model"), None), axes, (16, 3), sizes) \
        == [Shard(0), Shard(0)]
    assert placements(P("model", "data"), axes) == [Shard(1), Shard(0)]
    for bad, shape in ((P(("model", "data")), None),
                       (P("data", "data"), None),
                       (P("pod"), None),
                       (P(("data", "model")), (12, 1))):
        with pytest.raises(ValueError):
            placements(bad, axes, shape, sizes if shape else None)
    # the exporter lists a dimension's axes in mesh order
    from repro_torch.core.exporter import _assign
    from repro_torch.core.platform import V5E_2POD
    for k in (2, 4, 16, 32, 256, 512):
        got = _assign(V5E_2POD, k, 1, 1)
        if got is not None:
            order = [n for n, _ in V5E_2POD.mesh_axes]
            for t in got:
                assert list(t) == sorted(t, key=order.index)


# ----------------------------------------------------------------------
# steps against the port's one-device steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ranks.ARCHS)
@pytest.mark.parametrize("tag", TRAIN_CASES)
def test_train_step_matches_one_device(sharded, one_device, name, tag):
    """Two sharded train steps (ZeRO-1 off and on; columns, batch over
    both axes, sequence over model) against the one-device steps: both
    losses at 1e-5 (the second reads the first update), the parameters
    and master after the first step within 1e-4 of each leaf's max (see
    ``_update_close``), m and v after the second within 1e-4."""
    got = sharded[0][0]["train"][(name, tag)]
    want = one_device["train"][name]
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (tag, a, b)
    first, want1 = got["first"], want["first"]
    for k, w in want1["params"].items():
        m = want1["m"][k]
        _update_close(first["params"][k], w, m, (tag, k))
        _update_close(first["master"][k], want1["master"][k], m, (tag, k))
        _close(got["m"][k], want["m"][k], LEAF_TOL, (tag, "m", k))
        _close(got["v"][k], want["v"][k], LEAF_TOL, (tag, "v", k))


@pytest.mark.parametrize("name", ranks.ARCHS)
def test_zero1_shards_the_state_over_the_data_axes(sharded, name):
    """With ZeRO-1 the master (so m and v) is sharded over the data axes
    where the parameter is not; without, it is laid out as the
    parameter."""
    res = sharded[0][0]["train"]
    off, on = res[(name, "tp")]["layout"], res[(name, "tp-zero1")]["layout"]
    both = res[(name, "dp-zero1")]["layout"]
    assert any(pl[0] != "R" for pl in on.values())
    assert all(pl == off[k] for k, pl in on.items() if pl[0] == "R")
    assert all(pl[0] == "R" for pl in off.values())
    assert any(pl[0] == pl[1] != "R" for pl in both.values())


@pytest.mark.parametrize("name", ranks.ARCHS)
def test_serve_matches_one_device(sharded, one_device, name):
    """A sharded prefill (sequence over model) and two decode steps (the
    cache's length over model: each rank writes its own rows): logits
    within 1e-4 of their max, the greedy tokens equal."""
    got = sharded[0][0]["serve"][name]
    want = one_device["serve"][name]
    for a, b in zip(got["logits"], want["logits"]):
        _close(a, b, LEAF_TOL, "logits")
    for a, b in zip(got["tokens"], want["tokens"]):
        assert torch.equal(a, b)


def test_mesh_of_one_is_bitwise_the_host_mesh(sharded):
    """The train step on a 1 x 1 gloo mesh (DTensors on a mesh of one)
    equals the host mesh's (plain tensors) bit for bit, in one rank."""
    res = sharded[0][0]["one"]
    assert res["mesh"]["losses"] == res["host"]["losses"]
    for field in ("params", "master", "m", "v"):
        for k, w in res["host"][field].items():
            assert torch.equal(res["mesh"][field][k], w), (field, k)


def test_reshard_tree_grows_and_shrinks(sharded):
    """``reshard_tree`` onto the 2 x 2 mesh, then onto the 1 x 2 mesh of
    ranks 0 and 1: the whole tensors bitwise the tree's."""
    for r in (0, 1):
        res = sharded[0][r]["reshard"]
        want = res["want"]
        assert torch.equal(res["on4"]["w"], want["w"])
        assert torch.equal(res["on4"]["m"], want["m"])
        assert torch.equal(res["on2"]["w"], want["w"])
        assert torch.equal(res["on2"]["m"], want["m"])
        assert res["on2"]["placements"] == ("R", "S1")
    assert sharded[0][2]["reshard"]["on2"] is None


# ----------------------------------------------------------------------
# shard functions, unported kinds, the oracle's rmsnorm
# ----------------------------------------------------------------------

def _fake_group_mesh():
    """A 2 x 2 ``Mesh`` that claims a process group (for the shard
    functions, which only read its axes here)."""
    return port_mesh.Mesh(("data", "model"), np.full((2, 2), None, object),
                          device_mesh=object())


def _jax_plan(plan):
    part = plan.partitions[0]
    kinds = {k: r_exporter.KindPlan(k, kp.s_in, kp.s_out, kp.kern,
                                    kp.rows_axes, kp.cols_axes,
                                    kp.batch_axes)
             for k, kp in part.kinds.items()}
    return r_exporter.ShardingPlan(
        plan.arch_name, plan.shape_name, plan.mode, "spmd",
        RPlatform(name="t-2x2", mesh_axes=(("data", 2), ("model", 2))),
        [r_exporter.PartitionPlan(0, [], kinds, part.layer_start,
                                  part.layer_end, True, True, True)])


_ROLES = (("boundary", 3), ("inner", 3), ("heads", 4), ("experts", 3),
          ("boundary", 4), ("inner", 2), (None, 3))


def test_shard_functions_match_jax(monkeypatch):
    """For every kind and role, on the train, sequence-parallel, prefill
    and decode plans, with and without ``seq_parallel``: the spec each
    shard function lays out (or none) equals the one JAX's passes to
    ``with_sharding_constraint``. (The unported kinds' steps are refused
    when they are built: ``test_unported_kinds_raise_naming_their_item``.)"""
    _need_jax()
    seen = []
    monkeypatch.setattr(r_steps.jax.lax, "with_sharding_constraint",
                        lambda a, sh: seen.append(tuple(sh.spec)) or a)
    monkeypatch.setattr(port_steps, "constrain",
                        lambda a, mesh, spec: seen.append(tuple(spec)) or a)
    mesh = _fake_group_mesh()
    arch = ranks.arch_of(ranks.ARCHS[1])
    ps = ranks.plans(arch)
    checked = 0
    for tag in ("tp", "sp", "prefill", "decode"):
        for sp in (False, True):
            port = port_steps.shard_fns_from_plan(ps[tag], mesh, 0, sp)
            ref = r_steps.shard_fns_from_plan(_jax_plan(ps[tag]),
                                              r_host_mesh(), 0, sp)
            assert set(port) == set(ref)
            for kind in port:
                for role, ndim in _ROLES:
                    del seen[:]
                    port[kind](torch.zeros((2,) * ndim), role=role)
                    ref[kind](jnp.zeros((2,) * ndim), role=role)
                    assert len(seen) in (0, 2) and \
                        seen[:1] == seen[1:], (tag, sp, kind, role, seen)
                    checked += bool(seen)
    assert checked > 100


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_unported_kinds_raise_naming_their_item(name):
    """The rwkv, ssm and encoder-decoder kinds have no sharded step yet:
    each ``make_*_step`` raises ``NotImplementedError`` naming ROADMAP item
    15 on a process group's mesh; a planning mesh (no group) of several
    devices raises a ``ValueError``."""
    arch = reduced(get_arch(name))
    model = Model(arch, device="meta")
    plan = ranks.plan_of(arch, "train", {})
    mesh = _fake_group_mesh()
    with pytest.raises(NotImplementedError, match="item 15"):
        port_steps.make_train_step(model, plan, mesh)
    with pytest.raises(NotImplementedError, match="item 15"):
        port_steps.make_serve_step(model, plan, mesh, "decode", 8)
    with pytest.raises(ValueError, match="planning"):
        port_steps.make_train_step(model, plan,
                                   port_mesh.make_production_mesh())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    """``ref.rmsnorm`` against JAX's ``ref.rmsnorm`` at 1e-6 of the
    output's largest magnitude (one rounding step in bfloat16)."""
    _need_jax()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(r_ref.rmsnorm(jnp.asarray(x, jdt),
                                    jnp.asarray(scale, jdt)), np.float32)
    tdt = getattr(torch, dtype)
    got = port_ref.rmsnorm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(scale).to(tdt)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_sharded_train_step_on_a_one_card_nccl_mesh(tmp_path):
    """Reduced tinyllama-1.1b in float32 on the card: two train steps on a
    1 x 1 NCCL ``DeviceMesh`` (DTensors) equal the host mesh's (plain
    tensors) bit for bit, losses, parameters and AdamW state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: an NCCL group runs on cards")
    import torch.distributed as dist
    port_mesh.init_process_group(1, 0, device="cuda",
                                 init_method=f"file://{tmp_path / 'init'}")
    try:
        arch = ranks.arch_of(ranks.ARCHS[0])
        plan = ranks.plans(arch)["tp"]
        mesh = port_mesh.make_mesh((1, 1), ("data", "model"))
        got = ranks.run_train(arch, plan, mesh, True, ("data",),
                              device="cuda")
        want = ranks.run_train(arch, plan, port_mesh.make_host_mesh("cuda"),
                               True, ("data",), device="cuda")
    finally:
        dist.destroy_process_group()
    assert got["losses"] == want["losses"]
    for field in ("params", "master", "m", "v"):
        for k, w in want[field].items():
            assert torch.equal(got[field][k], w), (field, k)
