"""whisper-small's encoder-decoder in the port, against the JAX package on
the CPU.

Per block in float32 (JAX's whisper cannot run float32 as a whole: its
encoder casts ``frames`` to bfloat16, and its layer scan then refuses a
carry that comes back float32): ``attend(kv_src=...)`` without a cache,
at a prefill (``write_cross=True``, the stored K/V) and at a decode
reading the stored K/V, and the encoder's ``enc_attn`` / ``enc_ffn``,
each within 1e-5. Reduced whisper (2 encoder and 4 decoder layers,
d_model 128, 4 heads of 32, 16 frames) in bfloat16: the forward's logits
within the reference's own spread (JAX compiled against op by op); the
prefill's cache leaves (``enc_out``, the cross and self K/V) against
JAX's; the port's decode, teacher-forced, against JAX's cache-less
forward at each position, within the same bound. JAX's own decode is not
a reference: its cross-attention attends to the decoded token alone
(``test_jax_decode_ignores_the_cached_cross_kv``, ROADMAP Queue 3).
Also ``serve`` with frames on the CPU, training through autograd, and
the parameter and cache trees at full width on the meta device."""
import functools

import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as r_arch
    from repro.configs.base import reduced as r_reduced
    from repro.models import attention as r_attention
    from repro.models import layers as r_layers
    from repro.models.model import Model as JaxModel
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.serve import generate, serve
from repro_torch.launch.train import plan_for_mesh
from repro_torch.models import attention as A
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models.model import Model

NAME = "whisper-small"
#: the blocks in float32, abs and rel
BLOCK_TOL = 1e-5
#: batch, prompt and teacher-forced decode steps of the reduced model
B, P, STEPS = 2, 8, 4


def _need_jax():
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")


def _arch():
    return reduced(get_arch(NAME))


@functools.lru_cache(maxsize=None)
def _tree():
    """JAX's ``init_params(PRNGKey(0))`` of reduced whisper as numpy
    (bfloat16 weights)."""
    tree = JaxModel(r_reduced(r_arch(NAME))).init_params(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, tree)


def _port(**kw):
    model = Model(_arch(), device="meta", **kw)
    model.load_state_dict(convert.params_from_jax(_tree(), device="cpu"),
                          strict=True, assign=True)
    return model.requires_grad_(False)


@functools.lru_cache(maxsize=None)
def _data(S):
    """Tokens (B, S) and frames (B, 16, 128) from numpy seeds."""
    arch = _arch()
    tokens = convert.recipe_batch(arch.vocab_size, B, S, 0)["tokens"]
    return tokens, convert.recipe_frames(B, arch.num_frames, arch.d_model, 1)


def _jax_forward(tokens, frames, eager=False):
    model = JaxModel(r_reduced(r_arch(NAME)))
    tree = jax.tree.map(jnp.asarray, _tree())
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    if eager:
        with jax.disable_jit():
            return np.asarray(model.forward(tree, batch)[0], np.float32)
    return np.asarray(model.forward(tree, batch)[0], np.float32)


@functools.lru_cache(maxsize=None)
def _reference(S):
    """JAX's cache-less bf16 forward over ``S`` tokens (its layer loop
    compiled) and its spread: the largest distance from the same forward
    run op by op under ``jax.disable_jit``."""
    tokens, frames = _data(S)
    want = _jax_forward(tokens, frames)
    spread = float(np.abs(_jax_forward(tokens, frames, eager=True)
                          - want).max())
    assert spread > 0
    return want, spread


def _within_spread(got, want, spread):
    """max(6e-2 + 6e-2 |want|, spread): the bf16 rule of
    ``tests/test_torch_rwkv_model.py``."""
    bound = np.maximum(6e-2 + 6e-2 * np.abs(want), spread)
    diff = np.abs(np.asarray(got, np.float32) - want)
    assert (diff <= bound).all(), (
        f"{int((diff > bound).sum())} logits beyond the bound; max diff "
        f"{diff.max():.4g}, spread {spread:.4g}")
    return float(diff.max())


# ----------------------------------------------------------------------
# the blocks in float32
# ----------------------------------------------------------------------

def _block_params(kind, seed):
    """Float32 recipe weights of one reduced ``kind`` block."""
    shapes = {k.split(".", 2)[2]: tuple(t.shape[1:]) for k, t in Model(
        _arch(), device="meta").state_dict().items()
        if k.split(".")[1].endswith(f"_{kind}")}
    return convert.recipe_params(shapes, seed)


def _heads(arch):
    return dict(num_heads=arch.num_heads, num_kv_heads=arch.num_kv_heads,
                head_dim=arch.head_dim, norm=arch.norm)


@pytest.mark.parametrize("case", ["no_cache", "prefill", "decode"])
def test_cross_attention_matches_jax(case):
    """``attend(kv_src=...)`` in float32 against JAX's: without a cache;
    at a prefill (``write_cross=True``: K/V from the source, no rotation,
    stored in the cache's dtype, into its buffers in place); at a decode
    (``write_cross=False``: the stored K/V read, left as they were)."""
    _need_jax()
    arch = _arch()
    p = _block_params("cross_attn", 0)
    rng = np.random.default_rng(1)
    S = 1 if case == "decode" else 8
    x = rng.standard_normal((B, S, arch.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 16, arch.d_model)).astype(np.float32)
    kv = (B, 16, arch.num_kv_heads, arch.head_dim)
    cache = None
    if case == "prefill":
        cache = {"k": np.zeros(kv, np.float32), "v": np.zeros(kv, np.float32)}
    if case == "decode":
        cache = {k: rng.standard_normal(kv).astype(np.float32)
                 for k in ("k", "v")}
    kw = dict(_heads(arch), causal=False, write_cross=case == "prefill")
    want, wc = r_attention.attend(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        kv_src=jnp.asarray(src), attn_impl="ref",
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()}, **kw)
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    got, gc = A.attend(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()},
                       kv_src=torch.from_numpy(src), cache=tc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    if cache is None:
        assert gc is None
        return
    for k in ("k", "v"):
        assert gc[k] is tc[k]                      # in place
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
    if case == "decode":
        assert all(np.array_equal(gc[k].numpy(), cache[k]) for k in gc)


@pytest.mark.parametrize("kind", ["enc_attn", "enc_ffn"])
def test_encoder_blocks_match_jax(kind):
    """The encoder's blocks in float32: attention with no rotation, not
    causal, over 16 frames; the gelu (tanh) feed-forward with a biased
    layer norm."""
    _need_jax()
    arch = _arch()
    x = np.random.default_rng(2).standard_normal(
        (B, 16, arch.d_model)).astype(np.float32)
    if kind == "enc_attn":
        p = _block_params("enc_attn", 3)
        want, _ = r_attention.attend(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
            causal=False, attn_impl="ref", **_heads(arch))
        got, _ = A.attend(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          causal=False, **_heads(arch))
    else:
        p = _block_params("enc_ffn", 4)
        assert set(p) == {"w_up", "w_down", "ln_scale", "ln_bias"}
        want = r_layers.apply_ffn(jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  arch.act, arch.norm)
        got = L.apply_ffn(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          arch.act, arch.norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)


# ----------------------------------------------------------------------
# the reduced model in bfloat16
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [P + STEPS, 64])
def test_bfloat16_logits_within_reference_spread(S):
    """The port's bf16 forward (``use_flash=True``: the flash kernel's
    plain version on the CPU) within max(6e-2 + 6e-2 |want|, spread) of
    JAX's, and its loss finite."""
    _need_jax()
    want, spread = _reference(S)
    tokens, frames = _data(S)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)}
    model = _port(use_flash=True)
    with torch.inference_mode():
        logits, _ = model(batch)
        loss = float(model.loss(batch))
    assert logits.dtype == torch.bfloat16 and np.isfinite(loss)
    _within_spread(logits.float().numpy(), want, spread)


def _port_teacher_forced(model, tokens, frames):
    """The port's logits at every position of ``tokens`` (B, P + STEPS):
    the prefill of the first P with the frames, into a bf16 cache, then one
    decode step a token; and the cache after the prefill (cloned)."""
    cache = model.init_cache(B, tokens.shape[1])
    with torch.inference_mode():
        pre, cache = model({"tokens": torch.from_numpy(tokens[:, :P]),
                            "frames": torch.from_numpy(frames)},
                           cache=cache, cache_pos=torch.tensor(0))
        after_prefill = {k: t.clone()
                         for k, t in convert.flatten(cache).items()}
        out = [pre.float()]
        for t in range(P, tokens.shape[1]):
            step, cache = model(
                {"tokens": torch.from_numpy(tokens[:, t:t + 1])},
                cache=cache, cache_pos=torch.tensor(t, dtype=torch.int32))
            out.append(step.float())
    return torch.cat(out, dim=1).numpy(), after_prefill


def test_prefill_cache_leaves_match_jax():
    """After a prefill of P tokens with the frames into the default bf16
    cache: ``enc_out`` and every cross and self K/V leaf has JAX's shape
    and dtype, and its values lie within one bfloat16 rounding step (plus
    the reference's own spread for that leaf, compiled against op by op)
    of JAX's."""
    _need_jax()
    tokens, frames = _data(P + STEPS)
    model = JaxModel(r_reduced(r_arch(NAME)))
    tree = jax.tree.map(jnp.asarray, _tree())
    batch = {"tokens": jnp.asarray(tokens[:, :P]),
             "frames": jnp.asarray(frames)}

    def prefill():
        cache = model.init_cache(B, P + STEPS)
        return convert.flatten(model.forward(tree, batch, cache=cache,
                                             cache_pos=jnp.int32(0))[1])

    want = prefill()
    with jax.disable_jit():
        eager = prefill()
    _, got = _port_teacher_forced(_port(), tokens, frames)
    assert set(got) == set(want)
    assert {k for k in got if "cross" in k} == {
        "dec0.p1_cross_attn.k", "dec0.p1_cross_attn.v"}
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype) == f"torch.{a.dtype}", k
        a = np.asarray(a, np.float32)
        spread = np.abs(np.asarray(eager[k], np.float32) - a)
        diff = np.abs(got[k].float().numpy() - a)
        assert (diff <= 2.0 ** -7 * np.abs(a) + spread.max() + 1e-6).all(), k


def test_teacher_forced_decode_matches_the_cacheless_forward():
    """The port's prefill and STEPS teacher-forced decode steps: the logits
    at every position within the bf16 bound of JAX's cache-less forward
    over the same tokens (max(6e-2 + 6e-2 |want|, spread))."""
    _need_jax()
    want, spread = _reference(P + STEPS)
    tokens, frames = _data(P + STEPS)
    got, _ = _port_teacher_forced(_port(), tokens, frames)
    assert got.shape == want.shape
    _within_spread(got, want, spread)


def test_jax_decode_ignores_the_cached_cross_kv():
    """A fault of the reference (ROADMAP Queue 3): at decode JAX's forward
    gives the decoder no encoder output, so its cross-attention attends to
    the decoded token's own K/V and replaces the stored cross K/V by a
    length-1 pair. Its decode logits then lie far outside the bf16 bound
    of its own cache-less forward, while the port's, which read the stored
    K/V, lie within it."""
    _need_jax()
    want, spread = _reference(P + STEPS)
    tokens, frames = _data(P + STEPS)
    model = JaxModel(r_reduced(r_arch(NAME)))
    tree = jax.tree.map(jnp.asarray, _tree())
    cache = model.init_cache(B, P + STEPS)
    _, cache = model.forward(tree, {"tokens": jnp.asarray(tokens[:, :P]),
                                    "frames": jnp.asarray(frames)},
                             cache=cache, cache_pos=jnp.int32(0))
    step, cache = model.forward(tree, {"tokens": jnp.asarray(
        tokens[:, P:P + 1])}, cache=cache, cache_pos=jnp.int32(P))
    jax_gap = float(np.abs(np.asarray(step, np.float32)[:, 0]
                           - want[:, P]).max())
    assert cache["dec0"]["p1_cross_attn"]["k"].shape[2] == 1
    bound = float(np.maximum(6e-2 + 6e-2 * np.abs(want[:, P]), spread).max())
    assert jax_gap > 2 * bound, (jax_gap, bound)
    got, _ = _port_teacher_forced(_port(), tokens, frames)
    port_gap = float(np.abs(got[:, P] - want[:, P]).max())
    assert port_gap <= bound < jax_gap


# ----------------------------------------------------------------------
# serving, training, trees
# ----------------------------------------------------------------------

def test_serve_on_the_cpu_with_frames():
    """``serve`` on reduced whisper: a one-partition plan, frames drawn
    after the prompts from the seeded generator, the same tokens for the
    same seed; ``generate`` of an encoder-decoder refuses a prefill
    without frames."""
    arch = _arch()
    plan = plan_for_mesh(arch, ShapeSpec("serve_prefill", 8, 2, "prefill"),
                         port_mesh.make_host_mesh("cpu"),
                         objective="throughput")
    assert len(plan.partitions) == 1
    logs = []
    a, stats = serve(arch, prompt_len=8, gen_len=4, batch=2, seed=0,
                     device="cpu", log=logs.append)
    b, _ = serve(arch, prompt_len=8, gen_len=4, batch=2, seed=0,
                 device="cpu", log=logs.append)
    assert tuple(a.shape) == (2, 4) and a.dtype == torch.int32
    assert torch.equal(a, b) and stats["partitions"] == 1
    model = Model(arch, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frames"):
        generate(model, torch.zeros((1, 4), dtype=torch.int32), 2)


def test_whisper_trains_through_autograd():
    """Reduced whisper in float32 (frames rounded to bf16, then run in
    float32) under autograd: every parameter leaf gets a finite gradient,
    the encoder's and the cross-attention's non-zero, the same with remat
    on and off."""
    arch = _arch()
    tokens, frames = _data(16)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1)),
             "frames": torch.from_numpy(frames)}
    grads = []
    for remat in (True, False):
        model = Model(arch, attn_impl="chunked", remat=remat, device="cpu",
                      generator=torch.Generator().manual_seed(0)).float()
        params = dict(model.named_parameters())
        loss = model.loss(batch)
        grads.append(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
    for k, g in grads[0].items():
        assert bool(torch.isfinite(g).all()), k
        assert torch.equal(g, grads[1][k]), k
        if k.startswith("enc.") or "cross_attn.w" in k:
            assert float(g.abs().max()) > 0, k


def _leaves(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in convert.flatten(tree).items()}


def test_full_width_trees_match_jax():
    """whisper-small at full width (12 + 12 layers, d_model 768, 12 heads,
    vocab 51865, 1500 frames, tied head): JAX's parameter names, shapes and
    dtypes, and its cache tree (``enc_out`` (B, 1500, 768), cross K/V (12,
    B, 1500, 12, 64), self K/V), nothing allocated."""
    _need_jax()
    jm = JaxModel(r_arch(NAME))
    model = Model(get_arch(NAME), device="meta")
    assert _leaves(model.state_dict()) == _leaves(jm.param_shapes())
    cache = _leaves(model.cache_shapes(2, 96))
    assert cache == _leaves(jm.cache_shapes(2, 96))
    assert cache["enc_out"] == ((2, 1500, 768), "bfloat16")
    assert cache["dec0.p1_cross_attn.k"] == ((12, 2, 1500, 12, 64),
                                             "bfloat16")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_generate_on_the_card_matches_the_cpu():
    """Reduced whisper, float32 weights and cache: ``generate`` with the
    same frames on the card and on the CPU, logits within 1e-4 abs and rel
    and the same tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch = _arch()
    cpu = Model(arch, attn_impl="chunked", device="cpu",
                generator=torch.Generator().manual_seed(0)).float()
    card = Model(arch, attn_impl="chunked", device="meta")
    card.load_state_dict({k: t.to("cuda") for k, t in
                          cpu.state_dict().items()}, strict=True, assign=True)
    tokens, frames = _data(8)
    prompts, fr = torch.from_numpy(tokens), torch.from_numpy(frames)
    want, ws = generate(cpu, prompts, 6, frames=fr,
                        cache_dtype=torch.float32, keep_logits=True)
    got, gs = generate(card, prompts.cuda(), 6, frames=fr.cuda(),
                       cache_dtype=torch.float32, keep_logits=True)
    torch.testing.assert_close(gs["logits"].cpu(), ws["logits"], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.cpu(), want)
