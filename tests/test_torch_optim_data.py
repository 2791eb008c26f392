"""The port's training substrate against the JAX package's: the data
pipeline, AdamW, gradient compression and checkpoints.

Held on the CPU: ``DataPipeline.batch_at`` bitwise JAX's over seeds, steps
and host layouts; ``adamw_update`` on copied state and equal gradients
within 1e-6 relative of JAX's (clip on and off, steps 1 and 3, bfloat16 and
float32 parameters) and the JAX package's own AdamW cases; ``compress_int8``
bitwise without a generator, unbiased with one; top-k on distinct
magnitudes; ``compressed_psum`` in a one-rank gloo group; the JAX
package's checkpoint cases on the port; checkpoints written by either
package loading in the other, leaf for leaf and bitwise, with the same
files on disk."""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import port_obs_reset  # noqa: F401
from repro.checkpoint import checkpoint as r_ckpt
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.core.accel import EngineUnavailable
from repro_torch.data.pipeline import DataPipeline, make_pipeline
from repro_torch.models import convert
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123)])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batch_at_is_bitwise_jax(seed, step, hosts):
    for h in range(hosts):
        want = JaxPipeline(512, 32, 8, seed=seed, host_index=h,
                           host_count=hosts).batch_at(step)
        got = DataPipeline(512, 32, 8, seed=seed, host_index=h,
                           host_count=hosts, device="cpu").batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("hosts", [2, 4, 8])
def test_reshard_keeps_the_global_stream(hosts):
    base = DataPipeline(512, 16, 8, seed=1, device="cpu")
    whole = base.batch_at(5)
    shards = [base.reshard(h, hosts).batch_at(5) for h in range(hosts)]
    assert all(s["tokens"].shape[0] == 8 // hosts for s in shards)
    for k in ("tokens", "labels"):
        assert torch.equal(torch.cat([s[k] for s in shards]), whole[k])


def test_skip_to_next_batch_and_labels():
    p1 = DataPipeline(512, 32, 8, seed=3, device="cpu")
    p2 = DataPipeline(512, 32, 8, seed=3, device="cpu")
    p2.skip_to(5)
    for _ in range(5):
        p1.next_batch()
    assert p1.step == p2.step == 5
    a, b = p1.next_batch(), p2.next_batch()
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert next(iter(p1))["tokens"].shape == (8, 32)


def test_bad_host_split_and_no_card_raise(monkeypatch):
    with pytest.raises(ValueError):
        DataPipeline(512, 16, 9, host_count=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable):
        DataPipeline(512, 16, 8).batch_at(0)


def test_make_pipeline_reads_the_cell():
    from repro_torch.configs import SHAPES_BY_NAME, get_arch, reduced
    arch, shape = reduced(get_arch("tinyllama-1.1b")), \
        SHAPES_BY_NAME["train_4k"]
    p = make_pipeline(arch, shape, seed=2, host_index=1, host_count=2,
                      device="cpu")
    assert (p.vocab_size, p.seq_len, p.global_batch, p.local_batch) == \
        (arch.vocab_size, shape.seq_len, shape.global_batch,
         shape.global_batch // 2)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

SHAPES = {"a.w": (4, 5), "a.b": (5,), "c": (3, 2, 2)}


def _draws(seed, steps):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _jax_tree(flat, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), convert.nest(flat))


def _close(got: torch.Tensor, want, rtol=1e-6):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_jax_on_copied_state(dtype, steps, clip):
    """Both sides start from the same parameters and take the same
    gradients: master, m, v and the parameters within 1e-6 relative (the
    parameters in their own dtype), the step count equal."""
    params, grads = _draws(steps, steps)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = _jax_tree(params, jd)
    js = r_adamw.adamw_init(jp)
    tp = convert.params_from_jax(jp, device="cpu")
    ts = t_adamw.adamw_init(tp)
    for g in grads:
        jp, js = r_adamw.adamw_update(jp, _jax_tree(g, jd), js, lr=1e-2,
                                      grad_clip=clip)
        tp, ts = t_adamw.adamw_update(
            tp, {k: torch.from_numpy(v).to(td) for k, v in g.items()}, ts,
            lr=1e-2, grad_clip=clip)
    assert int(ts.step) == int(js.step) == steps
    assert ts.step.dtype == torch.int32
    want = {"master": js.master, "m": js.m, "v": js.v}
    for field, tree in want.items():
        flat = convert.flatten(tree)
        got = getattr(ts, field)
        assert set(got) == set(flat)
        for k, w in flat.items():
            assert got[k].dtype == torch.float32
            _close(got[k], w)
    for k, w in convert.flatten(jp).items():
        assert tp[k].dtype == td
        _close(tp[k], np.asarray(w, np.float32))


def test_adamw_donate_writes_in_place_and_equals_the_copy():
    """``donate=True`` writes into the given tensors and returns them, with
    the values of the copying update, which leaves its inputs alone."""
    params, grads = _draws(5, 2)
    p1 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          params.items()}
    p2 = {k: v.clone() for k, v in p1.items()}
    before = {k: v.clone() for k, v in p1.items()}
    s1, s2 = t_adamw.adamw_init(p1), t_adamw.adamw_init(p2)
    given = (dict(p2), dict(s2.m), dict(s2.v), dict(s2.master))
    q1, q2, r1, r2 = p1, p2, s1, s2
    for g in grads:
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        q1, r1 = t_adamw.adamw_update(q1, g, r1, lr=1e-2)
        q2, r2 = t_adamw.adamw_update(q2, g, r2, lr=1e-2, donate=True)
    for k in p1:
        assert torch.equal(p1[k], before[k])              # not donated
        assert not torch.equal(q1[k], before[k])
        for got, want, buf in ((q2, q1, given[0]), (r2.m, r1.m, given[1]),
                               (r2.v, r1.v, given[2]),
                               (r2.master, r1.master, given[3])):
            assert got[k] is buf[k] and torch.equal(got[k], want[k])


def test_adamw_rejects_mismatched_keys():
    p = {"x": torch.zeros(3)}
    with pytest.raises(KeyError):
        t_adamw.adamw_update(p, {"y": torch.zeros(3)}, t_adamw.adamw_init(p))


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    state = t_adamw.adamw_init(params)
    for _ in range(300):
        x = params["x"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(torch.square(x - target)), x)
        params, state = t_adamw.adamw_update(params, {"x": g}, state,
                                             lr=3e-2, weight_decay=0.0)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_keeps_param_dtype_with_fp32_master():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = t_adamw.adamw_init(params)
    assert state.master["w"].dtype == torch.float32
    grads = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    new_params, new_state = t_adamw.adamw_update(params, grads, state)
    assert new_params["w"].dtype == torch.bfloat16
    assert int(new_state.step) == 1


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = t_adamw.adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    p1, _ = t_adamw.adamw_update(params, huge, state, lr=1e-3,
                                 grad_clip=1.0, weight_decay=0.0)
    assert float(torch.max(torch.abs(p1["w"]))) < 1e-2


# ----------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------

def _normal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_int8_compression_is_bitwise_jax():
    g = _normal(4096)
    g[:4] = [0.5, -0.5, 1.5, 2.5]                 # ties round to even
    q, scale = t_comp.compress_int8(torch.from_numpy(g))
    jq, jscale = r_comp.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(
        t_comp.decompress_int8(q, scale).numpy(),
        np.asarray(r_comp.decompress_int8(jq, jscale)))
    back = t_comp.decompress_int8(q, scale)
    assert float(torch.max(torch.abs(back - torch.from_numpy(g)))) <= \
        float(scale) + 1e-6


def test_int8_stochastic_rounding_unbiased():
    g = torch.full((20000,), 0.31)
    gen = torch.Generator().manual_seed(1)
    q, scale = t_comp.compress_int8(g, generator=gen)
    back = t_comp.decompress_int8(q, scale)
    assert abs(float(torch.mean(back)) - 0.31) < 5e-3
    q2, _ = t_comp.compress_int8(g, generator=torch.Generator().manual_seed(1))
    assert torch.equal(q, q2)


def test_topk_sparsify_densify_match_jax():
    rng = np.random.default_rng(2)
    g = (rng.permutation(np.arange(1, 102)) * rng.choice([-1, 1], 101)
         ).astype(np.float32) / 10                 # distinct magnitudes
    vals, idx = t_comp.topk_sparsify(torch.from_numpy(g), k_fraction=0.1)
    jv, ji = r_comp.topk_sparsify(jnp.asarray(g), k_fraction=0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    dense = t_comp.topk_densify(vals, idx, g.shape)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(r_comp.topk_densify(jv, ji, g.shape)))
    small = torch.tensor([0.1, -5.0, 0.2, 4.0, -0.05, 0.0])
    v, i = t_comp.topk_sparsify(small, k_fraction=0.34)     # k = 2
    assert torch.equal(t_comp.topk_densify(v, i, (6,)),
                       torch.tensor([0, -5.0, 0, 4.0, 0, 0]))


def test_compressed_psum_in_a_one_rank_gloo_group(monkeypatch):
    """One rank in a gloo group built on an in-memory ``HashStore`` (no
    network; gloo's device on the loopback interface): the mean gradient
    equals JAX's ``compressed_psum`` over a one-member axis."""
    import torch.distributed as dist
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    g = _normal(1000, seed=4)
    want = jax.vmap(lambda x: r_comp.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(g)[None])[0]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = t_comp.compressed_psum(torch.from_numpy(g))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

class Pair(NamedTuple):
    first: object
    second: object


def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_load_roundtrip(tmp_path):
    d = str(tmp_path)
    t_ckpt.save_checkpoint(d, 10, _tree(), extra={"loss": 1.5})
    step, tree, extra = t_ckpt.load_checkpoint(d, like=_tree())
    assert step == 10 and extra["loss"] == 1.5
    assert torch.equal(tree["params"]["w"], _tree()["params"]["w"])
    assert tree["params"]["b"].dtype == torch.bfloat16
    assert tree["step"].dtype == torch.int32 and int(tree["step"]) == 7


def test_latest_ignores_tmp_and_garbage(tmp_path):
    d = str(tmp_path)
    t_ckpt.save_checkpoint(d, 1, _tree())
    t_ckpt.save_checkpoint(d, 5, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # crashed writer
    os.makedirs(os.path.join(d, "step_00000011"))       # no manifest
    assert t_ckpt.latest_step(d) == 5
    assert t_ckpt.latest_step(os.path.join(d, "none")) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.load_checkpoint(os.path.join(d, "none"))


def test_gc_keeps_last_n(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        t_ckpt.save_checkpoint(d, s, _tree(), keep=2)
    steps = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [3, 4]


def test_missing_leaf_detected(tmp_path):
    d = str(tmp_path)
    t_ckpt.save_checkpoint(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        t_ckpt.load_checkpoint(d, like={"a": torch.zeros(2),
                                        "b": torch.zeros(2)})


def test_manager_interval(tmp_path):
    mgr = t_ckpt.CheckpointManager(str(tmp_path), interval=10)
    assert mgr.maybe_save(5, _tree()) is None
    assert mgr.maybe_save(10, _tree()) is not None
    got = mgr.restore_or_none(like=_tree())
    assert got is not None and got[0] == 10
    assert t_ckpt.CheckpointManager(str(tmp_path / "x")).restore_or_none() \
        is None


def _mixed_numpy():
    """float32, bfloat16 (as its 16-bit patterns), int32 and a NamedTuple,
    from a seed: {path: numpy array}, bfloat16 leaves as uint16."""
    rng = np.random.default_rng(7)
    bf = rng.integers(0, 2 ** 16, (3, 5)).astype(np.uint16)
    bf[(bf & 0x7F80) == 0x7F80] = 0x3F80         # no NaN / inf patterns
    return {"f32": rng.standard_normal((2, 3)).astype(np.float32),
            "bf16": bf, "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
            "scalar": np.int32(11)}


def _jax_mixed(a):
    import ml_dtypes
    return {"net": {"w": jnp.asarray(a["f32"]),
                    "b": jnp.asarray(a["bf16"].view(ml_dtypes.bfloat16))},
            "opt": Pair(jnp.asarray(a["i32"]), jnp.asarray(a["scalar"]))}


def _port_mixed(a):
    return {"net": {"w": torch.from_numpy(a["f32"]),
                    "b": torch.from_numpy(a["bf16"].view(np.int16)).view(
                        torch.bfloat16)},
            "opt": Pair(torch.from_numpy(a["i32"]),
                        torch.tensor(int(a["scalar"]), dtype=torch.int32))}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_checkpoints_load_across_packages_bitwise(tmp_path):
    """A tree saved by JAX's ``save_checkpoint`` loads in the port's (flat
    and into a ``like`` tree) and a tree saved by the port's loads in
    JAX's, every leaf bitwise with its dtype; both writers write the same
    files (the manifests differ only in the per-process checksum)."""
    a = _mixed_numpy()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    r_ckpt.save_checkpoint(jdir, 3, _jax_mixed(a), extra={"loss": 2.5})
    t_ckpt.save_checkpoint(tdir, 3, _port_mixed(a), extra={"loss": 2.5})

    want = {"net/w": a["f32"], "net/b": a["bf16"].view(np.int16),
            "opt/first": a["i32"], "opt/second": np.asarray(a["scalar"])}
    step, flat, extra = t_ckpt.load_checkpoint(jdir)
    assert (step, extra, set(flat)) == (3, {"loss": 2.5}, set(want))
    for p, w in want.items():
        np.testing.assert_array_equal(_bits(flat[p]), w)
    assert flat["net/b"].dtype == torch.bfloat16
    _, tree, _ = t_ckpt.load_checkpoint(jdir, like=_port_mixed(a))
    assert isinstance(tree["opt"], Pair)
    for got, want in zip(t_ckpt._flatten(tree), t_ckpt._flatten(
            _port_mixed(a))):
        assert got[0] == want[0] and got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))

    _, jtree, jextra = r_ckpt.load_checkpoint(tdir, like=_jax_mixed(a))
    assert jextra == {"loss": 2.5} and isinstance(jtree["opt"], Pair)
    for (gp, got), (wp, want) in zip(r_ckpt._flatten(jtree),
                                     r_ckpt._flatten(_jax_mixed(a))):
        assert gp == wp and got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))

    jroot, troot = (os.path.join(d, "step_00000003") for d in (jdir, tdir))
    assert sorted(os.listdir(jroot)) == sorted(os.listdir(troot))
    for name in os.listdir(jroot):
        jb = open(os.path.join(jroot, name), "rb").read()
        tb = open(os.path.join(troot, name), "rb").read()
        if name == t_ckpt.MANIFEST:
            import json
            jm, tm = json.loads(jb), json.loads(tb)
            for m in (jm, tm):
                for leaf in m["leaves"]:
                    leaf.pop("checksum")
            assert jm == tm
        else:
            assert jb == tb, name


def test_an_unknown_void_dtype_is_refused(tmp_path):
    d = str(tmp_path)
    t_ckpt.save_checkpoint(d, 1, {"b": torch.zeros(2, dtype=torch.bfloat16)})
    import json
    man = os.path.join(d, "step_00000001", t_ckpt.MANIFEST)
    m = json.load(open(man))
    m["leaves"][0]["dtype"] = "float8_e4m3fn"
    json.dump(m, open(man, "w"))
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        t_ckpt.load_checkpoint(d)
