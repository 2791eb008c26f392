"""LM serving in the port: decode caches, the MoE block and
``repro_torch.launch`` (mesh, shapes, plan, serve steps, the serve loop).

Held against the JAX package on the CPU: the cache tree at full width on
the ``meta`` device; prefill and decode of five reduced archs step by step
against JAX's eager ``Model.forward(params, batch, cache=...,
cache_pos=jnp.int32(...))`` on the same cache state (JAX's own ``serve()``
fails before its first step, ROADMAP Queue 3); ``apply_moe`` with drops and
ties; greedy generation; the plan and the input specs. On a card only: the
reduced serve loop against the same loop on the CPU."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as R_ARCHS
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get_arch as r_arch
    from repro.configs.base import reduced as r_reduced
    from repro.models import moe as r_moe
    from repro.models.model import Model as JaxModel
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_model, reduced_jax_tree
from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.accel import EngineUnavailable
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import shapes as port_shapes
from repro_torch.launch.serve import generate, serve
from repro_torch.launch.steps import make_serve_step, shard_fns_from_plan
from repro_torch.launch.train import plan_for_mesh
from repro_torch.models import convert, moe
from repro_torch.models.model import Model

SERVED = ("tinyllama-1.1b", "rwkv6-1.6b", "granite-moe-1b-a400m",
          "kimi-k2-1t-a32b", "qwen2-vl-72b")
#: prefill and decode against JAX: logits 1e-4 abs and rel; every cache
#: leaf within 1e-5 of its largest magnitude (the WKV state grows to ~16)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


def _need_jax():
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")


def _flat(tree):
    return convert.flatten(tree)


@functools.lru_cache(maxsize=None)
def _meta_model(name):
    """The port's ``name`` at full width on the meta device."""
    return Model(get_arch(name), device="meta")


def _step_batch(arch, tokens, pos):
    """The batch of one step over ``tokens`` (B, n) from position ``pos``,
    as numpy; qwen2-vl's mrope positions run on from ``pos``."""
    batch = {"tokens": tokens}
    if arch.mrope:
        B, n = tokens.shape
        p = np.broadcast_to(np.arange(pos, pos + n, dtype=np.int32)[None],
                            (B, n))
        batch["mrope_positions"] = np.ascontiguousarray(np.stack([p, p, p]))
    return batch


# ----------------------------------------------------------------------
# cache trees
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVED)
def test_cache_tree_matches_jax_at_full_width(name):
    """``init_cache`` / ``cache_shapes`` on the meta device: JAX's keys,
    shapes and dtypes (bf16 K/V and shift, float32 wkv) at full width."""
    _need_jax()
    want = _flat(JaxModel(r_arch(name)).cache_shapes(4, 96))
    model = _meta_model(name)
    for got in (_flat(model.cache_shapes(4, 96)),
                _flat(model.init_cache(4, 96, device="meta"))):
        assert set(got) == set(want)
        for k, sds in want.items():
            assert tuple(got[k].shape) == tuple(sds.shape), k
            assert str(got[k].dtype) == f"torch.{sds.dtype}", k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_moe_parameter_tree_matches_jax_at_full_width(name):
    """The moe blocks' leaves (router float32, stacked expert weights) with
    JAX's names, shapes and dtypes, and a recipe for every one of them."""
    _need_jax()
    want = _flat(JaxModel(r_arch(name)).param_shapes())
    got = _meta_model(name).state_dict()
    assert set(got) == set(want)
    for k, sds in want.items():
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert str(got[k].dtype) == f"torch.{sds.dtype}", k
    small = {k: tuple(t.shape) for k, t in Model(
        reduced(get_arch(name)), device="meta").state_dict().items()}
    drawn = convert.recipe_params(small, 0)
    for leaf in ("router", "w_up", "w_gate", "w_down"):
        k = next(k for k in drawn if k.endswith(f"_moe.{leaf}"))
        rows = small[k][-2]
        assert 0.5 < drawn[k].std() * np.sqrt(rows) < 1.5, k


# ----------------------------------------------------------------------
# prefill and decode against JAX
# ----------------------------------------------------------------------

def _run_both(name, cache_dtype, steps=4, B=2, P=6, attn_impl=None):
    """Prefill ``P`` tokens, then ``steps`` decode steps, on JAX's eager
    forward and on the port, both from the same float32 weights and cache
    state; yields each step's (JAX logits, port logits, JAX cache, port
    cache), the port's cache cloned first (the port writes in place)."""
    params = reduced_jax_tree(name)
    arch = r_reduced(r_arch(name))
    kw = {"attn_impl": attn_impl} if attn_impl else {}
    jm = JaxModel(arch, **kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    pm = port_model(name, params, dtype=torch.float32, **kw)
    L = P + steps
    tokens = np.random.default_rng(7).integers(
        0, arch.vocab_size, (B, L)).astype(np.int32)
    jc = jm.init_cache(B, L, dtype=jnp.dtype(cache_dtype))
    pc = pm.init_cache(B, L, dtype=getattr(torch, cache_dtype))
    pos = 0
    for step in range(steps + 1):
        n = P if step == 0 else 1
        batch = _step_batch(arch, tokens[:, pos:pos + n], pos)
        jl, jc = jm.forward(jp, {k: jnp.asarray(v) for k, v in
                                 batch.items()},
                            cache=jc, cache_pos=jnp.int32(pos),
                            head_last_only=step == 0)
        tl, pc = pm({k: torch.from_numpy(v) for k, v in batch.items()},
                    cache=pc, cache_pos=torch.tensor(pos, dtype=torch.int32),
                    head_last_only=step == 0)
        pc = {s: {pk: {n_: t.clone() for n_, t in leaves.items()}
                  for pk, leaves in seg.items()} for s, seg in pc.items()}
        yield np.asarray(jl, np.float32), tl, jc, pc
        pos += n


@pytest.mark.parametrize("name", SERVED)
def test_prefill_and_decode_match_jax(name):
    """Float32 weights and cache: the prefill's last logits and 4 decode
    steps' logits within 1e-4 abs and rel of JAX's, every cache leaf within
    1e-5 of its largest magnitude, the same tree and dtypes each step."""
    _need_jax()
    for jl, tl, jc, pc in _run_both(name, "float32"):
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        want, got = _flat(jc), _flat(pc)
        assert set(got) == set(want)
        for k, a in want.items():
            a = np.asarray(a, np.float32)
            assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
            np.testing.assert_allclose(
                got[k].float().numpy(), a, rtol=0,
                atol=CACHE_TOL * max(1.0, float(np.abs(a).max())), err_msg=k)


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "tinyllama-1.1b"])
def test_default_cache_dtypes_follow_jax(name):
    """JAX's default bfloat16 cache with float32 weights: attention casts
    K/V into the cache's bfloat16, while the RWKV ``shift`` leaves keep
    ``h``'s float32 after the prefill (a new leaf, not the bf16 buffer);
    each leaf's dtype is JAX's after every step and its values within one
    bfloat16 rounding step of JAX's."""
    _need_jax()
    for step, (jl, tl, jc, pc) in enumerate(_run_both(name, "bfloat16",
                                                      steps=2)):
        want, got = _flat(jc), _flat(pc)
        for k, a in want.items():
            assert str(got[k].dtype) == f"torch.{a.dtype}", (step, k)
            a = np.asarray(a.astype(jnp.float32))
            mag = np.abs(a)
            assert (np.abs(got[k].float().numpy() - a)
                    <= 2.0 ** -7 * mag + 1e-5 * mag.max() + 1e-6).all(), k
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-2, rtol=1e-2)
    if name == "rwkv6-1.6b":
        assert str(want["dec0.p0_rwkv_tmix.shift"].dtype) == "float32"


def test_cache_is_written_in_place_where_it_fits():
    """Attention writes this step's K/V into the caller's buffers and
    returns them; a float32 model's RWKV ``shift`` does not fit the bf16
    buffer and comes back as a new float32 leaf, the buffer left as it
    was; the float32 ``wkv`` state is copied into its buffer."""
    dense = Model(reduced(get_arch("tinyllama-1.1b")), device="cpu",
                  generator=torch.Generator().manual_seed(0)).float()
    cache = dense.init_cache(1, 5)
    tokens = {"tokens": torch.arange(4, dtype=torch.int32)[None]}
    _, new = dense(tokens, cache=cache, cache_pos=0)
    assert new["dec0"]["p0_attn"]["k"] is cache["dec0"]["p0_attn"]["k"]
    k = cache["dec0"]["p0_attn"]["k"]
    assert bool(k[:, :, :4].abs().sum(dim=(1, 3, 4)).gt(0).all())
    assert bool((k[:, :, 4] == 0).all())

    rwkv = Model(reduced(get_arch("rwkv6-1.6b")), device="cpu",
                 generator=torch.Generator().manual_seed(0)).float()
    cache = rwkv.init_cache(1, 5)
    _, new = rwkv(tokens, cache=cache, cache_pos=0)
    shift = new["dec0"]["p0_rwkv_tmix"]["shift"]
    assert shift.dtype == torch.float32
    assert shift is not cache["dec0"]["p0_rwkv_tmix"]["shift"]
    assert bool((cache["dec0"]["p0_rwkv_tmix"]["shift"] == 0).all())
    assert new["dec0"]["p0_rwkv_tmix"]["wkv"] is \
        cache["dec0"]["p0_rwkv_tmix"]["wkv"]
    assert bool(cache["dec0"]["p0_rwkv_tmix"]["wkv"].abs().gt(0).any())


@pytest.mark.parametrize("name", SERVED)
def test_prefill_agrees_with_the_full_forward(name):
    """JAX's own decode test on the port (``tests/test_models.py``): bf16
    weights, a prefill into a cache one longer than the prompt gives the
    full forward's last logits within 1e-2 abs and rel, and one decode
    step against the cache gives finite (B, 1, V) logits."""
    _need_jax()
    arch = reduced(get_arch(name))
    model = port_model(name, reduced_jax_tree(name))
    B, S = 2, 8
    tokens = np.random.default_rng(1).integers(
        0, arch.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {k: torch.from_numpy(v) for k, v in
             _step_batch(arch, tokens[:, :S], 0).items()}
    full, _ = model(batch)
    cache = model.init_cache(B, S + 1)
    pre, cache = model(batch, cache=cache,
                       cache_pos=torch.tensor(0, dtype=torch.int32))
    np.testing.assert_allclose(pre.float()[:, -1], full.float()[:, -1],
                               atol=1e-2, rtol=1e-2)
    step = {k: torch.from_numpy(v) for k, v in
            _step_batch(arch, tokens[:, S:], S).items()}
    dec, _ = model(step, cache=cache,
                   cache_pos=torch.tensor(S, dtype=torch.int32))
    assert tuple(dec.shape) == (B, 1, arch.vocab_size)
    assert bool(torch.isfinite(dec.float()).all())


# ----------------------------------------------------------------------
# apply_moe
# ----------------------------------------------------------------------

def _moe_case(case):
    """Float32 inputs of reduced granite-moe's moe block (D 128, 4
    experts, top-2) for T = 2 x 16 tokens: ``plain`` random, ``drops``
    with a router that sends most tokens to expert 3 (capacity 20 of 32
    assignments there: drops), ``ties`` with experts 0 and 1 (and 2 and 3)
    sharing a router column, so that their probabilities tie exactly and
    the lower index must win, as in ``jax.lax.top_k``."""
    arch = reduced(get_arch("granite-moe-1b-a400m"))
    rng = np.random.default_rng({"plain": 0, "drops": 1, "ties": 2}[case])
    shapes = {k.split(".", 2)[2]: tuple(t.shape[1:]) for k, t in Model(
        arch, device="meta").state_dict().items() if "_moe." in k}
    p = {k: v for k, v in convert.recipe_params(shapes, 3).items()}
    if case == "drops":
        p["router"][:, 3] += 4.0 * np.abs(p["router"]).max()
    if case == "ties":
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    x = rng.standard_normal((2, 16, arch.d_model)).astype(np.float32)
    if case == "drops":
        x = np.abs(x)
    return arch, p, x


@pytest.mark.parametrize("case", ["plain", "drops", "ties"])
def test_apply_moe_matches_jax(case):
    _need_jax()
    arch, p, x = _moe_case(case)
    kw = dict(top_k=arch.experts_per_token, act=arch.act, norm=arch.norm)
    want = np.asarray(jax.jit(functools.partial(r_moe.apply_moe, **kw))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    moe.RECORD = []
    try:
        got = moe.apply_moe(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            **kw)
        (routed,) = moe.RECORD
    finally:
        moe.RECORD = None
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    T = x.shape[0] * x.shape[1]
    assert routed["cap"] == moe.capacity(T, 2, 4) == 20
    dropped = int((~routed["keep"]).sum())
    ids = routed["expert_ids"]
    if case == "drops":
        assert dropped > 0 and int((ids == 3).sum()) > 20
    else:
        assert dropped == 0
    if case == "ties":
        # experts 0 = 1 and 2 = 3: the lower of a tied pair first
        assert bool(((ids[:, 0] == 0) | (ids[:, 0] == 2)).all())
        assert torch.equal(ids[:, 1], ids[:, 0] + 1)


# ----------------------------------------------------------------------
# greedy generation and the serve loop
# ----------------------------------------------------------------------

def _jax_greedy(name, params, prompts, gen_len):
    """A greedy loop of JAX's eager forward with the serve loop's choices:
    ``attn_impl="chunked"``, the default bf16 cache, prefill then decode."""
    arch = r_reduced(r_arch(name))
    model = JaxModel(arch, attn_impl="chunked", remat=False)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen_len)
    batch = {k: jnp.asarray(v)
             for k, v in _step_batch(arch, prompts, 0).items()}
    logits, cache = model.forward(params, batch, cache=cache,
                                  cache_pos=jnp.int32(0), head_last_only=True)
    out = [np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)]
    for i in range(gen_len - 1):
        step = _step_batch(arch, out[-1][:, None], P + i)
        logits, cache = model.forward(
            params, {k: jnp.asarray(v) for k, v in step.items()},
            cache=cache, cache_pos=jnp.int32(P + i))
        out.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m", "qwen2-vl-72b"])
def test_generate_matches_jax_greedy(name):
    """``generate`` from JAX's reduced weights (float32) and the same
    prompts gives JAX's greedy tokens, bf16 caches on both sides (the
    dense, RWKV, MoE and mrope paths; kimi-k2's blocks are granite's and
    tinyllama's, held step by step above)."""
    _need_jax()
    params = reduced_jax_tree(name)
    arch = reduced(get_arch(name))
    prompts = np.random.default_rng(5).integers(
        0, arch.vocab_size, (3, 7)).astype(np.int32)
    want = _jax_greedy(name, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), params), prompts, 6)
    model = port_model(name, params, dtype=torch.float32,
                       attn_impl="chunked")
    got, stats = generate(model, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_per_s"}


def test_serve_on_the_cpu_is_deterministic_for_a_seed():
    arch = reduced(get_arch("tinyllama-1.1b"))
    logs = []
    a, stats = serve(arch, prompt_len=8, gen_len=5, batch=3, seed=0,
                     device="cpu", log=logs.append)
    b, _ = serve(arch, prompt_len=8, gen_len=5, batch=3, seed=0,
                 device="cpu", log=logs.append)
    c, _ = serve(arch, prompt_len=8, gen_len=5, batch=3, seed=1,
                 device="cpu", log=logs.append)
    assert tuple(a.shape) == (3, 5) and a.dtype == torch.int32
    assert bool(((a >= 0) & (a < arch.vocab_size)).all())
    assert torch.equal(a, b) and not torch.equal(a, c)
    # JAX's stats keys
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_per_s",
                          "partitions"}
    assert stats["partitions"] == 1 and stats["decode_tok_per_s"] > 0
    assert len(logs) == 3 and logs[0].startswith("[serve] prefill")


def test_serve_needs_the_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = reduced(get_arch("tinyllama-1.1b"))
    with pytest.raises(EngineUnavailable, match="device='cpu'"):
        serve(arch, prompt_len=4, gen_len=2, batch=1, log=lambda m: None)
    with pytest.raises(EngineUnavailable):
        port_mesh.make_host_mesh()
    # whisper serves (tests/test_torch_encdec_model.py); without a card it
    # needs device='cpu' as every arch does
    with pytest.raises(EngineUnavailable, match="device='cpu'"):
        serve(reduced(get_arch("whisper-small")), prompt_len=4, gen_len=2,
              batch=1, log=lambda m: None)


def test_main_runs_reduced_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                 "--prompt-len", "4", "--gen-len", "3", "--batch", "2"]) == 0
    assert "generated shape (2, 3)" in capsys.readouterr().out


# ----------------------------------------------------------------------
# mesh, plan, steps, shapes
# ----------------------------------------------------------------------

def test_meshes():
    host = port_mesh.make_host_mesh("cpu")
    assert host.axis_names == ("data", "model")
    assert host.devices.shape == (1, 1) and host.size == 1
    assert host.devices[0, 0] == torch.device("cpu")
    prod = port_mesh.make_production_mesh()
    assert (prod.axis_names, prod.devices.shape) == (("data", "model"),
                                                     (16, 16))
    pods = port_mesh.make_production_mesh(multi_pod=True)
    assert (pods.axis_names, pods.devices.shape) == \
        (("pod", "data", "model"), (2, 16, 16))
    fns = shard_fns_from_plan(None, host)
    x = torch.ones(2, 3, 4)
    assert all(fn(x, role="boundary") is x for fn in fns.values())
    # a mesh of several devices with no process group is for planning
    with pytest.raises(ValueError, match="planning"):
        shard_fns_from_plan(None, prod)


@pytest.mark.parametrize("name,shape", [
    ("tinyllama-1.1b", ("serve_prefill", 32, 4, "prefill")),
    ("granite-moe-1b-a400m", ("serve_prefill", 32, 4, "prefill")),
    ("rwkv6-1.6b", ("train_tiny", 64, 8, "train")),
])
def test_plan_for_mesh_matches_jax_on_the_host_mesh(name, shape):
    """The port's plan on its host mesh (torch engine, on the CPU) against
    JAX's on ``make_host_mesh()``: partitions and every kind plan."""
    _need_jax()
    from repro.configs.base import ShapeSpec as RShape
    from repro.launch.mesh import make_host_mesh as r_host_mesh
    from repro.launch.train import plan_for_mesh as r_plan_for_mesh
    want = r_plan_for_mesh(r_reduced(r_arch(name)), RShape(*shape),
                           r_host_mesh(), objective="throughput")
    got = plan_for_mesh(reduced(get_arch(name)), ShapeSpec(*shape),
                        port_mesh.make_host_mesh("cpu"),
                        objective="throughput")
    assert (got.arch_name, got.shape_name, got.mode, got.exec_model) == \
        (want.arch_name, want.shape_name, want.mode, want.exec_model)
    assert len(got.partitions) == len(want.partitions)
    for g, w in zip(got.partitions, want.partitions):
        assert (g.index, g.node_indices, g.layer_start, g.layer_end,
                g.has_embed, g.has_head, g.has_final_norm, g.enc_start,
                g.enc_end) == \
            (w.index, w.node_indices, w.layer_start, w.layer_end,
             w.has_embed, w.has_head, w.has_final_norm, w.enc_start,
             w.enc_end)
        assert {k: dataclasses.astuple(v) for k, v in g.kinds.items()} == \
            {k: dataclasses.astuple(v) for k, v in w.kinds.items()}


def test_serve_steps_prefill_then_decode():
    """``make_serve_step``'s prefill returns the last position's logits and
    starts at 0; decode takes a 0-d int32 position; both equal the model's
    own calls."""
    arch = reduced(get_arch("qwen2-vl-72b"))
    model = Model(arch, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    host = port_mesh.make_host_mesh("cpu")
    keys = ("tokens", "mrope_positions")
    prefill = make_serve_step(model, None, host, "prefill", 9,
                              batch_keys=keys)
    decode = make_serve_step(model, None, host, "decode", 9, batch_keys=keys)
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8)
    batch = {k: torch.from_numpy(v)
             for k, v in _step_batch(arch, tokens, 0).items()}
    batch["labels"] = batch["tokens"]           # not a batch key: dropped
    logits, cache = prefill(model.init_cache(2, 9), batch)
    assert tuple(logits.shape) == (2, 1, arch.vocab_size)
    full, _ = model({k: batch[k] for k in keys})
    torch.testing.assert_close(logits[:, 0], full[:, -1], atol=1e-2,
                               rtol=1e-2)
    step = {k: torch.from_numpy(v) for k, v in
            _step_batch(arch, tokens[:, :1], 8).items()}
    pos = torch.tensor(8, dtype=torch.int32)
    got, _ = decode(cache, step, pos)
    assert tuple(got.shape) == (2, 1, arch.vocab_size)


def test_input_specs_match_jax_for_every_cell():
    """``input_specs`` for every registry arch x shape: JAX's names, shapes
    and dtypes, on the meta device; ``make_batch`` draws that structure."""
    _need_jax()
    from repro.launch.shapes import input_specs as r_input_specs
    assert [a for a in ARCHS] == [a for a in R_ARCHS]
    assert [s.name for s in SHAPES] == [s.name for s in R_SHAPES]
    for name in ARCHS:
        for shape, r_shape in zip(SHAPES, R_SHAPES):
            want = r_input_specs(r_arch(name), r_shape, batch_override=2)
            got = port_shapes.input_specs(get_arch(name), shape,
                                          batch_override=2)
            assert list(got) == list(want), (name, shape.name)
            for k, sds in want.items():
                assert tuple(got[k].shape) == tuple(sds.shape)
                assert str(got[k].dtype) == f"torch.{sds.dtype}"
                assert got[k].device.type == "meta"
    arch = reduced(get_arch("qwen2-vl-72b"))
    shape = ShapeSpec("t", 16, 2, "train")
    a = port_shapes.make_batch(arch, shape, torch.Generator().manual_seed(3))
    b = port_shapes.make_batch(arch, shape, torch.Generator().manual_seed(3))
    assert list(a) == ["tokens", "labels", "mrope_positions"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tuple(a["mrope_positions"].shape) == (3, 2, 16)
    assert int(a["tokens"].max()) < arch.vocab_size
    assert int(a["mrope_positions"].max()) < 16
    whisper = port_shapes.make_batch(
        reduced(get_arch("whisper-small")), ShapeSpec("p", 8, 2, "prefill"),
        torch.Generator().manual_seed(0))
    assert whisper["frames"].dtype == torch.bfloat16


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serve loop runs on the card "
                    "unless asked for the CPU")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m"])
def test_serve_on_the_card_matches_the_cpu(name):
    """Reduced ``serve`` on the card (the default device) returns its
    tokens and stats; ``generate`` on the card from the same float32
    weights, prompts and a float32 cache as on the CPU gives logits within
    1e-4 abs and rel of the CPU's and the same tokens."""
    _card()
    arch = reduced(get_arch(name))
    tokens, stats = serve(arch, prompt_len=16, gen_len=8, batch=4,
                          log=lambda m: None)
    assert tokens.device.type == "cuda" and tuple(tokens.shape) == (4, 8)
    assert stats["partitions"] == 1
    cpu = Model(arch, attn_impl="chunked", device="cpu",
                generator=torch.Generator().manual_seed(0)).float()
    card = Model(arch, attn_impl="chunked", device="meta")
    card.load_state_dict({k: t.to("cuda") for k, t in
                          cpu.state_dict().items()}, strict=True, assign=True)
    prompts = torch.randint(0, arch.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    want, ws = generate(cpu, prompts, 8, cache_dtype=torch.float32,
                        keep_logits=True)
    got, gs = generate(card, prompts.to("cuda"), 8,
                       cache_dtype=torch.float32, keep_logits=True)
    torch.testing.assert_close(gs["logits"].cpu(), ws["logits"], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.cpu(), want)
