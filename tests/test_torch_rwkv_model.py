"""The RWKV6 scoring forward: the port's ``Model`` against the JAX package's
``Model(arch, use_flash=True)`` (its Pallas WKV kernel in interpret mode) on
reduced ``rwkv6-1.6b``, with the JAX parameters carried across by
``params_from_jax``; layer-range composition; the full-width parameter tree;
the seeded numpy recipe the card run uses; and what the port leaves out.

The bfloat16 logits rule holds for both LM families the port runs, so its
one parametrised test (``test_bfloat16_logits_within_reference_spread``)
covers reduced ``rwkv6-1.6b`` and reduced ``tinyllama-1.1b`` here."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

import jax.numpy as jnp  # noqa: E402

from _torch_support import (jax_run, layer_range_pair,  # noqa: E402
                            lm_record, lm_sample_points,
                            port_model, port_run, reduced_jax_tree)
from _torch_support import port_obs_reset  # noqa: E402,F401
from repro.configs import get_arch as r_arch  # noqa: E402
from repro.configs.base import reduced as r_reduced  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

NAME = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def jax_params():
    """Reduced rwkv6-1.6b (4 layers, d_model 128, head size 32): the JAX
    ``init_params`` tree as numpy (bfloat16 weights)."""
    return reduced_jax_tree(NAME)


def _port(params, dtype=None, **kw):
    return port_model(NAME, params, dtype, **kw)


def _batch(S, seed=0):
    return convert.recipe_batch(reduced(get_arch(NAME)).vocab_size, 2, S,
                                seed)


def _jax_run(params, batch, dtype=None):
    return jax_run(NAME, params, batch, dtype)


@pytest.mark.parametrize("S", [16, 100])
def test_float32_forward_and_loss_match_jax(jax_params, S):
    batch = _batch(S)
    want, want_loss = _jax_run(jax_params, batch, jnp.float32)
    logits, loss = port_run(_port(jax_params, torch.float32,
                                  use_flash=True), batch)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=1e-4)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("S", [16, 100])
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "tinyllama-1.1b"])
def test_bfloat16_logits_within_reference_spread(name, S):
    """Each bfloat16 logit of the port lies within max(6e-2 + 6e-2 |want|,
    spread) of JAX's forward (``want``). ``spread`` is the largest distance
    between that forward (the layer loop compiled, some bfloat16 sums kept
    unrounded by XLA) and the same forward run op by op under
    ``jax.disable_jit`` (every bfloat16 result rounded): a random bfloat16
    model turns single rounding flips into logit differences, and at S=100
    the reference's own spread exceeds 6e-2."""
    tree = reduced_jax_tree(name)
    batch = convert.recipe_batch(reduced(get_arch(name)).vocab_size, 2, S, 0)
    tokens = {"tokens": batch["tokens"]}
    want, _ = jax_run(name, tree, tokens)
    with jax.disable_jit():
        eager, _ = jax_run(name, tree, tokens)
    spread = float(np.abs(eager - want).max())

    logits, loss = port_run(port_model(name, tree, use_flash=True), batch)
    assert logits.dtype == torch.bfloat16
    assert spread > 0
    assert np.isfinite(loss)
    bound = np.maximum(6e-2 + 6e-2 * np.abs(want), spread)
    diff = np.abs(logits.float().numpy() - want)
    assert (diff <= bound).all(), (
        f"{int((diff > bound).sum())} logits beyond the bound; max diff "
        f"{diff.max():.4g}, spread {spread:.4g}")


def test_kernel_route_equals_oracle_route_on_cpu(jax_params):
    """On the CPU ``use_flash`` runs the kernel's plain version through
    the layout wrapper: the same arithmetic as the oracle route."""
    batch = {"tokens": torch.from_numpy(_batch(16)["tokens"])}
    a, _ = _port(jax_params, use_flash=True)(batch)
    b, _ = _port(jax_params, use_flash=False)(batch)
    assert torch.equal(a, b)


def test_loss_mask_matches_jax(jax_params):
    batch = _batch(16, seed=4)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 16))
                          < 0.5).astype(np.float32)
    _, want_loss = _jax_run(jax_params, batch, jnp.float32)
    _, loss = port_run(_port(jax_params, torch.float32), batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


def test_layer_range_partitions_compose(jax_params):
    """Partition models run back to back == the whole model (the
    weight-streaming contract of tests/test_models.py)."""
    whole = _port(jax_params)
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


@pytest.mark.parametrize("layer_range", [None, (0, 2), (5, 24)])
def test_full_width_parameter_tree_matches_jax(layer_range):
    """Names, shapes and dtypes at full width (24 layers, d_model 2048,
    vocab 65536), on the meta device: nothing is allocated."""
    kw = {"layer_range": layer_range}
    if layer_range == (5, 24):
        kw["include_embed"] = False
    want = _jax_leaves(r_arch(NAME), **kw)
    model = Model(get_arch(NAME), device="meta", **kw)
    assert _port_leaves(model.param_shapes()) == want
    assert _port_leaves(model.state_dict()) == want
    assert all(t.is_meta for t in model.state_dict().values())


def test_init_params_draws_from_the_generator():
    arch = reduced(get_arch(NAME))

    def make(seed):
        return Model(arch, device="cpu",
                     generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert _port_leaves(sa) == _jax_leaves(r_reduced(r_arch(NAME)))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["dec0.p0_rwkv_tmix.wr"],
                           sc["dec0.p0_rwkv_tmix.wr"])
    assert all(p.requires_grad for p in a.parameters())
    with torch.inference_mode():
        logits, _ = a({"tokens": torch.from_numpy(_batch(8)["tokens"])})
    assert logits.shape == (2, 8, arch.vocab_size)
    assert torch.isfinite(logits.float()).all()


def test_params_from_jax_keeps_bits_and_casts_on_request(jax_params):
    sd = convert.params_from_jax(jax_params, device="cpu")
    table = jax_params["embed"]["table"]
    assert sd["embed.table"].dtype == torch.bfloat16
    assert np.array_equal(sd["embed.table"].view(torch.int16).numpy(),
                          table.view(np.int16))
    assert sd["dec0.p0_rwkv_tmix.decay"].dtype == torch.float32
    sd32 = convert.params_from_jax(jax_params, device="cpu",
                                   dtype=torch.float32)
    assert {t.dtype for t in sd32.values()} == {torch.float32}
    assert convert.nest(convert.flatten(jax_params)).keys() == \
        jax_params.keys()


def test_recipe_is_seeded_sorted_and_stated():
    shapes = {"b.ln_scale": (4,), "a.w": (3, 5), "c.decay": (6,),
              "c.mix_k": (2,), "c.bonus": (2, 3), "c.ln_bias": (4,)}
    one, two = (convert.recipe_params(shapes, 3) for _ in range(2))
    assert list(one) == sorted(shapes)
    assert all(np.array_equal(one[k], two[k]) for k in shapes)
    assert all(one[k].dtype == np.float32 and one[k].shape == shapes[k]
               for k in shapes)
    assert ((0 <= one["c.mix_k"]) & (one["c.mix_k"] < 1)).all()
    assert ((-6 <= one["c.decay"]) & (one["c.decay"] <= 1)).all()
    with pytest.raises(ValueError, match="no recipe"):
        convert.recipe_params({"x.scale": (3,)}, 0)
    b = convert.recipe_batch(512, 2, 7, 1)
    assert b["tokens"].shape == b["labels"].shape == (2, 7)
    assert b["tokens"].dtype == np.int32


def test_recipe_record_reproduces_on_the_port():
    """The mechanism of chip_smoke.py's [lm] phase at reduced width: the
    JAX record of the recipe's float32 weights and batch, and the port
    built from the same recipe without JAX, agree."""
    arch = reduced(get_arch(NAME))
    rec = lm_record(r_reduced(r_arch(NAME)), layers=2, batch=2, seq=16,
                    seed=0)
    model = Model(arch, layer_range=(0, 2), use_flash=True, device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    model.load_state_dict(convert.params_from_jax(
        convert.nest(convert.recipe_params(shapes, 0)), device="cpu",
        dtype=torch.float32), strict=True, assign=True)
    data = convert.recipe_batch(arch.vocab_size, 2, 16, 0)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.inference_mode():           # scoring, as chip_smoke.py's
        logits, _ = model(batch)
        loss = float(model.loss(batch))
    assert abs(loss - rec["loss"]) <= 1e-4 * abs(rec["loss"])
    points = lm_sample_points(2, 16, arch.vocab_size)
    assert [p[:3] for p in rec["logits"]] == [list(p) for p in points]
    for b, t, v, want in rec["logits"]:
        assert abs(float(logits[b, t, v]) - want) <= 1e-3


def test_what_the_slice_leaves_out_raises():
    """Nothing is left out any more (the name is kept from when the ssm and
    whisper blocks raised): ``Model`` builds reduced jamba (ssm) and
    whisper (enc_attn, enc_ffn, cross_attn) with JAX's parameter and cache
    trees, the moe block too, and a decode step on the meta device returns
    the cache's tree."""
    for name in ("jamba-1.5-large-398b", "whisper-small"):
        model = Model(reduced(get_arch(name)), device="meta")
        jm = JaxModel(r_reduced(r_arch(name)))
        assert _port_leaves(model.state_dict()) == \
            _port_leaves(jm.param_shapes())
        assert _port_leaves(model.cache_shapes(2, 8)) == \
            _port_leaves(jm.cache_shapes(2, 8))
    Model(reduced(get_arch("granite-moe-1b-a400m")), device="meta")
    model = Model(reduced(get_arch(NAME)), device="meta")
    cache = model.init_cache(1, 8)
    assert set(cache["dec0"]) == {"p0_rwkv_tmix", "p1_rwkv_cmix"}
    _, new = model({"tokens": torch.zeros(1, 4, dtype=torch.int64,
                                          device="meta")},
                   cache=cache, cache_pos=0)
    assert set(new["dec0"]) == set(cache["dec0"])


def test_default_device_is_the_card_and_never_the_cpu(monkeypatch):
    from repro_torch.core.accel import EngineUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable, match="device='cpu'"):
        Model(reduced(get_arch(NAME)))


def test_full_width_configuration_is_the_published_one():
    arch = get_arch(NAME)
    assert (arch.num_layers, arch.d_model, arch.d_model // arch.rwkv_head_size,
            arch.rwkv_head_size, arch.d_ff, arch.vocab_size) == \
        (24, 2048, 32, 64, 7168, 65536)
    assert dataclasses.asdict(arch) == dataclasses.asdict(r_arch(NAME))
