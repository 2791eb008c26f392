"""The dense scoring forward: the port's ``Model`` against the JAX package's
``Model(arch, use_flash=True)`` (its Pallas flash-attention kernel in
interpret mode) on reduced ``tinyllama-1.1b`` (4 layers, d_model 128, 4
query heads and 2 KV heads of 32), with the JAX parameters carried across
by ``params_from_jax``; the other attention routes; layer-range
composition; the full-width parameter tree; the seeded numpy recipe the
card run uses. The bfloat16 rule is the parametrised
``tests/test_torch_rwkv_model.py::test_bfloat16_logits_within_reference_spread``,
which covers this model too."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

import jax.numpy as jnp  # noqa: E402

from _torch_support import (jax_run, layer_range_pair,  # noqa: E402
                            lm_record, lm_sample_points, port_model,
                            port_run, reduced_jax_tree)
from _torch_support import port_obs_reset  # noqa: E402,F401
from repro.configs import get_arch as r_arch  # noqa: E402
from repro.configs.base import reduced as r_reduced  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import Model, Segment  # noqa: E402

NAME = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def jax_params():
    return reduced_jax_tree(NAME)


def _batch(S, seed=0):
    return convert.recipe_batch(reduced(get_arch(NAME)).vocab_size, 2, S,
                                seed)


def _hold_float32(got_logits, got_loss, want_logits, want_loss):
    """The float32 contract: logits 1e-4 abs and rel, loss 1e-5 relative
    (the measured gap is about 5e-6 in the logits)."""
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("S", [16, 100])
def test_float32_forward_and_loss_match_jax(jax_params, S):
    batch = _batch(S)
    want, want_loss = jax_run(NAME, jax_params, batch, jnp.float32)
    logits, loss = port_run(port_model(NAME, jax_params, torch.float32,
                                       use_flash=True), batch)
    assert logits.shape == (2, S, reduced(get_arch(NAME)).vocab_size)
    _hold_float32(logits, loss, want, want_loss)


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_other_attention_routes_match_jax(jax_params, impl):
    """``attn_impl="ref"`` and ``"chunked"`` models against JAX's models of
    the same route, at the float32 tolerance; S=100 is one KV block of the
    chunked form's 1024."""
    batch = _batch(100, seed=2)
    want, want_loss = jax_run(NAME, jax_params, batch, jnp.float32,
                              use_flash=False, attn_impl=impl)
    model = port_model(NAME, jax_params, torch.float32, attn_impl=impl)
    assert model.attn_impl == impl
    _hold_float32(*port_run(model, batch), want, want_loss)


def test_given_positions_match_jax(jax_params):
    """``batch["positions"]`` replaces the default 0..S-1 (rope). Rotary
    attention sees only relative positions, so these space the tokens 3
    apart, from 7 and from 300."""
    batch = _batch(16, seed=3)
    batch["positions"] = (3 * np.arange(16, dtype=np.int32)[None, :] +
                          np.array([[7], [300]], np.int32))
    want, want_loss = jax_run(NAME, jax_params, batch, jnp.float32)
    model = port_model(NAME, jax_params, torch.float32, use_flash=True)
    _hold_float32(*port_run(model, batch), want, want_loss)
    default, _ = port_run(model, _batch(16, seed=3))
    assert not np.allclose(default.numpy(), want, atol=1e-3)


def test_mrope_positions_match_jax():
    """An ``arch.mrope`` model (reduced qwen2-vl-72b, the same attn/ffn
    blocks) reads ``batch["mrope_positions"]`` (3, B, S) through
    ``layers.apply_mrope``."""
    name = "qwen2-vl-72b"
    tree = reduced_jax_tree(name)
    batch = convert.recipe_batch(reduced(get_arch(name)).vocab_size, 2, 24,
                                 5)
    batch["mrope_positions"] = np.random.default_rng(5).integers(
        0, 50, (3, 2, 24)).astype(np.int32)
    want, want_loss = jax_run(name, tree, batch, jnp.float32)
    model = port_model(name, tree, torch.float32, use_flash=True)
    _hold_float32(*port_run(model, batch), want, want_loss)


def test_kernel_route_equals_oracle_route_on_cpu(jax_params):
    """On the CPU ``use_flash`` runs the kernel's plain version through
    the layout wrapper: the same arithmetic as the oracle route."""
    batch = {"tokens": torch.from_numpy(_batch(16)["tokens"])}
    a, _ = port_model(NAME, jax_params, use_flash=True)(batch)
    b, _ = port_model(NAME, jax_params, use_flash=False)(batch)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_loss_mask_matches_jax(jax_params):
    batch = _batch(16, seed=4)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 16))
                          < 0.5).astype(np.float32)
    _, want_loss = jax_run(NAME, jax_params, batch, jnp.float32)
    _, loss = port_run(port_model(NAME, jax_params, torch.float32), batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


def test_layer_range_partitions_compose(jax_params):
    """Partition models run back to back == the whole model (the
    weight-streaming contract of tests/test_models.py)."""
    whole = port_model(NAME, jax_params)
    m1, m2 = layer_range_pair(NAME, jax_params, 2)
    batch = {"tokens": torch.from_numpy(_batch(16)["tokens"])}
    h, _ = m1(batch)
    logits2, _ = m2({"tokens": None}, embedded=h)
    logits, _ = whole(batch)
    assert torch.equal(logits2, logits)
    last, _ = whole(batch, head_last_only=True)
    assert torch.equal(last, logits[:, -1:])


def _jax_leaves(arch, **kw):
    shapes = jax.eval_shape(JaxModel(arch, **kw).init_params,
                            jax.random.PRNGKey(0))
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in convert.flatten(shapes).items()}


def _port_leaves(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in convert.flatten(tree).items()}


@pytest.mark.parametrize("layer_range", [None, (0, 2), (5, 22)])
def test_full_width_parameter_tree_matches_jax(layer_range):
    """Names, shapes and dtypes at full width (22 layers, d_model 2048, 32
    query and 4 KV heads of 64, d_ff 5632, vocab 32000), on the meta
    device: nothing is allocated."""
    kw = {"layer_range": layer_range}
    if layer_range == (5, 22):
        kw["include_embed"] = False
    want = _jax_leaves(r_arch(NAME), **kw)
    model = Model(get_arch(NAME), device="meta", **kw)
    assert _port_leaves(model.param_shapes()) == want
    assert _port_leaves(model.state_dict()) == want
    assert all(t.is_meta for t in model.state_dict().values())
    if layer_range is None:
        assert want["dec0.p0_attn.wk"] == ((22, 2048, 256), "bfloat16")
        assert want["dec0.p1_ffn.w_gate"] == ((22, 2048, 5632), "bfloat16")


def test_init_params_draws_from_the_generator():
    arch = reduced(get_arch(NAME))

    def make(seed):
        return Model(arch, device="cpu", use_flash=True,
                     generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert _port_leaves(sa) == _jax_leaves(r_reduced(r_arch(NAME)))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["dec0.p0_attn.wq"], sc["dec0.p0_attn.wq"])
    logits, _ = a({"tokens": torch.from_numpy(_batch(8)["tokens"])})
    assert logits.shape == (2, 8, arch.vocab_size)
    assert torch.isfinite(logits.float()).all()


def test_recipe_record_reproduces_on_the_port():
    """The mechanism of chip_smoke.py's [lm-dense] (a) at reduced width:
    the recipe draws every leaf of the dense tree (attention and ffn
    weights, norms, embedding, head), and the JAX record of its float32
    weights and batch agrees with the port built from the same recipe
    without JAX."""
    arch = reduced(get_arch(NAME))
    rec = lm_record(r_reduced(r_arch(NAME)), layers=2, batch=2, seq=16,
                    seed=0)
    model = Model(arch, layer_range=(0, 2), use_flash=True, device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert {k.rsplit(".", 1)[-1] for k in shapes} == {
        "table", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
        "ln_scale", "w"}
    model.load_state_dict(convert.params_from_jax(
        convert.nest(convert.recipe_params(shapes, 0)), device="cpu",
        dtype=torch.float32), strict=True, assign=True)
    data = convert.recipe_batch(arch.vocab_size, 2, 16, 0)
    logits, loss = port_run(model, data)
    assert abs(loss - rec["loss"]) <= 1e-4 * abs(rec["loss"])
    points = lm_sample_points(2, 16, arch.vocab_size)
    assert [p[:3] for p in rec["logits"]] == [list(p) for p in points]
    for b, t, v, want in rec["logits"]:
        assert abs(float(logits[b, t, v]) - want) <= 1e-3


def test_attend_refuses_what_is_not_ported():
    arch = reduced(get_arch(NAME))
    p = A.init_attention(None, arch.d_model, arch.num_heads,
                         arch.num_kv_heads, arch.head_dim, arch.norm,
                         device="meta")
    x = torch.zeros(1, 4, arch.d_model, dtype=torch.bfloat16, device="meta")
    kw = dict(num_heads=arch.num_heads, num_kv_heads=arch.num_kv_heads,
              head_dim=arch.head_dim, norm=arch.norm)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13d"):
        A.attend(x, p, kv_src=x, **kw)
    # a decode cache is ported: this step's K/V go into it at cache_pos
    cache = {"k": torch.zeros(1, 6, arch.num_kv_heads, arch.head_dim,
                              dtype=torch.bfloat16, device="meta")}
    cache["v"] = torch.zeros_like(cache["k"])
    y, new = A.attend(x, p, cache=cache, cache_pos=0, **kw)
    assert tuple(y.shape) == tuple(x.shape) and new is cache


def test_unknown_block_kind_raises_value_error():
    """``_run_segment`` has one branch per ported kind and no default: a
    kind it does not know raises ``ValueError(kind)``, as JAX's does."""
    model = Model(reduced(get_arch(NAME)), device="meta")
    with pytest.raises(ValueError, match="bogus"):
        model._run_segment({"p0_bogus": {"w": torch.zeros(1)}},
                           Segment("dec0", ("bogus",), 1, (0,)),
                           torch.zeros(1, 4, 128), None, None,
                           lambda kind: (lambda a, role=None: a))


def test_full_width_configuration_is_the_published_one():
    arch = get_arch(NAME)
    assert (arch.num_layers, arch.d_model, arch.num_heads,
            arch.num_kv_heads, arch.head_dim, arch.d_ff, arch.vocab_size,
            arch.act, arch.norm, arch.tie_embeddings) == \
        (22, 2048, 32, 4, 64, 5632, 32000, "swiglu", "rms", False)
    assert dataclasses.asdict(arch) == dataclasses.asdict(r_arch(NAME))
