"""The ``ssm`` block (jamba-1.5-large-398b's mamba mixer) in the port,
against the JAX package on the CPU.

``apply_ssm`` alone in float32 with and without a carried state (S in
{1, 16, 100}, and S = 100 scanned in blocks of 7 tokens): its output, the
final SSM state and the conv history within 1e-5 of each tensor's largest
magnitude. Reduced jamba (16 layers, d_model 128, d_inner 256, d_state
16; 2 attention layers; with no experts and with the default 4, top-2)
in float32 against JAX's ``Model(use_flash=True)``: logits 1e-4 abs and
rel, loss 1e-5 relative; prefill and decode step by step against JAX's
eager ``forward(cache=..., cache_pos=jnp.int32(...))`` (logits 1e-4,
cache leaves 1e-5 of their largest magnitude, dtypes equal, the bf16
cache's dtypes too); the train step's gradients against
``jax.value_and_grad(model.loss)`` (1e-4 of each leaf's largest
magnitude); the parameter and cache trees at full width on the meta
device. The port's ``generate`` of the ssm block is ``chip_smoke.py``'s
``[ssm]`` (a), against JAX's greedy loop. With the experts on, decode is
held to JAX's cached forward, not to the cache-less one: MoE capacity
depends on the token group's size."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as r_arch
    from repro.configs.base import reduced as r_reduced
    from repro.models import ssm as r_ssm
    from repro.models.model import Model as JaxModel
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import get_arch, reduced
from repro_torch.models import convert, ssm
from repro_torch.models.model import Model

NAME = "jamba-1.5-large-398b"
#: apply_ssm in float32: each tensor within this share of its largest |.|
SSM_TOL = 1e-5
#: the reduced model: logits abs and rel; loss relative; cache leaves as
#: SSM_TOL; gradient leaves of their largest |.|
LOGIT_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4


def _need_jax():
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")


def _arch(experts, port=True):
    """Reduced jamba (the port's or JAX's config) with ``experts`` experts;
    None keeps the reduced default of 4."""
    base = reduced(get_arch(NAME)) if port else r_reduced(r_arch(NAME))
    if experts is None:
        return base
    return dataclasses.replace(base, num_experts=experts)


@functools.lru_cache(maxsize=None)
def _tree(experts):
    """JAX's ``init_params(PRNGKey(0))`` of reduced jamba with ``experts``
    experts (None: the default 4) as numpy, every leaf float32."""
    model = JaxModel(_arch(experts, port=False))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        model.init_params(jax.random.PRNGKey(0)))


def _port(experts, **kw):
    model = Model(_arch(experts), device="meta", **kw)
    model.load_state_dict(convert.params_from_jax(_tree(experts),
                                                  device="cpu"),
                          strict=True, assign=True)
    return model


def _batch(S, seed=0):
    return convert.recipe_batch(reduced(get_arch(NAME)).vocab_size, 2, S,
                                seed)


def _held(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=what)


# ----------------------------------------------------------------------
# apply_ssm
# ----------------------------------------------------------------------

def _block_inputs(S, with_state, seed):
    """Float32 parameters of one reduced ssm block from the recipe, an
    input (2, S, D) and, with a state, a carried SSM state and conv
    history drawn as a decode would carry them."""
    arch = reduced(get_arch(NAME))
    shapes = {k.split(".", 2)[2]: tuple(t.shape[1:]) for k, t in Model(
        arch, layer_range=(0, 1), device="meta").state_dict().items()
        if "_ssm." in k}
    p = convert.recipe_params(shapes, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, S, arch.d_model)).astype(np.float32)
    state = None
    if with_state:
        di = arch.ssm_expand * arch.d_model
        state = {"ssm": rng.standard_normal(
                     (2, di, arch.ssm_d_state)).astype(np.float32),
                 "conv": rng.standard_normal(
                     (2, arch.ssm_conv - 1, di)).astype(np.float32)}
    return arch, p, x, state


@pytest.mark.parametrize("S,with_state,block", [
    (1, False, None), (1, True, None), (16, False, None), (16, True, None),
    (100, False, None), (100, True, None), (100, False, 7), (100, True, 7)])
def test_apply_ssm_matches_jax(S, with_state, block, monkeypatch):
    """The block's output, final SSM state and conv history in float32,
    each within 1e-5 of its largest magnitude of JAX's (its associative
    scan without a state, its step-by-step scan with one); ``block`` scans
    in blocks of that many tokens."""
    _need_jax()
    arch, p, x, state = _block_inputs(S, with_state, seed=S)
    kw = dict(d_state=arch.ssm_d_state, d_conv=arch.ssm_conv, norm=arch.norm)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = None if state is None else {k: jnp.asarray(v)
                                         for k, v in state.items()}
    want, want_state = jax.jit(functools.partial(r_ssm.apply_ssm, **kw))(
        jnp.asarray(x), jp, state=jstate)
    if block:
        monkeypatch.setattr(ssm, "SCAN_BLOCK",
                            2 * block * 2 * arch.d_model * arch.ssm_d_state)
    tstate = None if state is None else {k: torch.from_numpy(v)
                                         for k, v in state.items()}
    got, got_state = ssm.apply_ssm(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        state=tstate, **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _held(got, want, SSM_TOL, "y")
    for k in ("ssm", "conv"):
        assert got_state[k].dtype == torch.float32
        _held(got_state[k], want_state[k], SSM_TOL, k)


def test_scan_blocks_follow_the_scan_block_size(monkeypatch):
    """``SCAN_BLOCK`` bounds the tokens a block scans: at 7 tokens' worth
    of elements a 100-token input runs 15 blocks whose results agree with
    one block's within float32 rounding; a one-step scan is its ``b``
    (the carried state is already folded into it)."""
    arch, p, x, state = _block_inputs(100, True, seed=3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kw = dict(d_state=arch.ssm_d_state, d_conv=arch.ssm_conv, norm=arch.norm)
    whole, ws = ssm.apply_ssm(torch.from_numpy(x), tp, **kw)
    calls = []
    scan = ssm._scan
    monkeypatch.setattr(ssm, "_scan", lambda a, b: calls.append(a.shape[1])
                        or scan(a, b))
    monkeypatch.setattr(ssm, "SCAN_BLOCK",
                        7 * 2 * 2 * arch.d_model * arch.ssm_d_state)
    blocks, bs = ssm.apply_ssm(torch.from_numpy(x), tp, **kw)
    assert calls == [7] * 14 + [2]
    torch.testing.assert_close(blocks, whole, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bs["ssm"], ws["ssm"], atol=1e-5, rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 1, 4, 3, generator=g) + 0.1
    b = torch.randn(2, 1, 4, 3, generator=g)
    assert torch.equal(ssm._scan(a, b), b)


def test_recipe_keeps_the_ssm_in_its_working_range():
    """The recipe's SSM leaves: ``a_log`` near log(1..16) (decays
    -exp(a_log) from about -1 to -16), softplus(dt_bias) in [1e-3, 0.1],
    conv weights at 0.1 N, ``d_skip`` around 1."""
    arch = reduced(get_arch(NAME))
    shapes = {k: tuple(t.shape) for k, t in Model(
        arch, layer_range=(0, 1), device="meta").state_dict().items()}
    drawn = convert.recipe_params(shapes, 0)
    a_log = drawn["dec0.p0_ssm.a_log"]
    assert np.abs(a_log - np.log(np.arange(1, 17))).max() < 0.6
    step = np.log1p(np.exp(drawn["dec0.p0_ssm.dt_bias"]))
    assert 1e-3 * 0.999 <= step.min() and step.max() <= 0.1 * 1.001
    assert 0.05 < drawn["dec0.p0_ssm.conv_w"].std() < 0.2
    assert 0.05 < drawn["dec0.p0_ssm.conv_b"].std() < 0.2
    assert abs(drawn["dec0.p0_ssm.d_skip"].mean() - 1.0) < 0.05


# ----------------------------------------------------------------------
# the reduced model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("experts", [0, None])
def test_float32_forward_and_loss_match_jax(experts):
    """Reduced jamba, float32, B=2, S=100, against JAX's
    ``Model(use_flash=True)`` (its Pallas flash kernel in interpret mode
    for the attention layers): logits 1e-4 abs and rel, loss 1e-5 rel."""
    _need_jax()
    batch = _batch(100)
    model = JaxModel(_arch(experts, port=False), use_flash=True)
    jt = jax.tree.map(jnp.asarray, _tree(experts))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_loss = jax.jit(lambda t, b: (model.forward(t, b)[0],
                                            model.loss(t, b)))(jt, jb)
    want, want_loss = np.asarray(want), float(want_loss)
    port = _port(experts, use_flash=True).requires_grad_(False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, _ = port(tb)
        loss = float(port.loss(tb))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)


def _run_both(experts, cache_dtype, steps=4, B=2, P=6):
    """Prefill ``P`` tokens, then ``steps`` decode steps, on JAX's eager
    forward and on the port, from the same float32 weights and cache
    state; yields each step's (JAX logits, port logits, JAX cache, port
    cache), the port's cache cloned (the port writes in place)."""
    jm = JaxModel(_arch(experts, port=False))
    jt = jax.tree.map(jnp.asarray, _tree(experts))
    pm = _port(experts).requires_grad_(False)
    arch = pm.arch
    L = P + steps
    tokens = np.random.default_rng(7).integers(
        0, arch.vocab_size, (B, L)).astype(np.int32)
    jc = jm.init_cache(B, L, dtype=jnp.dtype(cache_dtype))
    pc = pm.init_cache(B, L, dtype=getattr(torch, cache_dtype))
    pos = 0
    with torch.inference_mode():
        for step in range(steps + 1):
            n = P if step == 0 else 1
            chunk = tokens[:, pos:pos + n]
            jl, jc = jm.forward(jt, {"tokens": jnp.asarray(chunk)}, cache=jc,
                                cache_pos=jnp.int32(pos),
                                head_last_only=step == 0)
            tl, pc = pm({"tokens": torch.from_numpy(chunk)}, cache=pc,
                        cache_pos=torch.tensor(pos, dtype=torch.int32),
                        head_last_only=step == 0)
            pc = {s: {pk: {n_: t.clone() for n_, t in leaves.items()}
                      for pk, leaves in seg.items()} for s, seg in pc.items()}
            yield np.asarray(jl, np.float32), tl, jc, pc
            pos += n


@pytest.mark.parametrize("experts", [0, None])
def test_prefill_and_decode_match_jax(experts):
    """Float32 weights and cache: the prefill's last logits and 4 decode
    steps' logits within 1e-4 abs and rel of JAX's eager cached forward,
    every cache leaf (attention K/V, SSM state, conv history) within 1e-5
    of its largest magnitude, the same tree and dtypes each step."""
    _need_jax()
    for jl, tl, jc, pc in _run_both(experts, "float32"):
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        want, got = convert.flatten(jc), convert.flatten(pc)
        assert set(got) == set(want)
        for k, a in want.items():
            assert str(got[k].dtype) == f"torch.{a.dtype}", k
            _held(got[k], a, SSM_TOL, k)


def test_default_cache_dtypes_follow_jax():
    """JAX's default bfloat16 cache with float32 weights: the SSM state
    stays float32, the K/V are cast into the bf16 buffers, and the conv
    history of ``[bf16 history ; float32 xi]`` turns float32 after the
    prefill (a new leaf); each leaf's dtype is JAX's every step and its
    values within one bfloat16 rounding step of JAX's."""
    _need_jax()
    for step, (jl, tl, jc, pc) in enumerate(_run_both(0, "bfloat16",
                                                      steps=2)):
        want, got = convert.flatten(jc), convert.flatten(pc)
        for k, a in want.items():
            assert str(got[k].dtype) == f"torch.{a.dtype}", (step, k)
            a = np.asarray(a.astype(jnp.float32))
            mag = np.abs(a)
            assert (np.abs(got[k].float().numpy() - a)
                    <= 2.0 ** -7 * mag + 1e-5 * mag.max() + 1e-6).all(), k
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-2, rtol=1e-2)
    assert str(want["dec0.p0_ssm.conv"].dtype) == "float32"
    assert str(want["dec0.p0_ssm.ssm"].dtype) == "float32"


def test_loss_and_grads_match_jax():
    """The train step's loss and gradients (autograd through the blocked
    scan, with remat) against ``jax.value_and_grad(model.loss)``, reduced
    jamba without experts (the MoE block's gradients are
    ``tests/test_torch_train.py``'s), float32, B=2, S=32: loss 1e-5
    relative, every gradient leaf within 1e-4 of that leaf's largest
    magnitude."""
    _need_jax()
    batch = _batch(32, seed=2)
    model = JaxModel(_arch(0, port=False), attn_impl="chunked")
    jt = jax.tree.map(jnp.asarray, _tree(0))
    want_loss, want = jax.jit(jax.value_and_grad(model.loss))(
        jt, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(g) for k, g in convert.flatten(want).items()}
    port = _port(0, attn_impl="chunked")
    params = dict(port.named_parameters())
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    assert set(grads) == set(want)
    for k, g in grads.items():
        scale = float(np.max(np.abs(want[k])))
        assert float(np.max(np.abs(g.numpy() - want[k]))) <= \
            GRAD_TOL * scale, k


# ----------------------------------------------------------------------
# full width, on the meta device
# ----------------------------------------------------------------------

def _leaves(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in convert.flatten(tree).items()}


@pytest.mark.parametrize("layer_range", [None, (0, 1), (6, 8)])
def test_full_width_trees_match_jax(layer_range):
    """jamba-1.5-large-398b at full width (72 layers, d_model 8192, d_inner
    16384, 16 experts of d_ff 24576): JAX's parameter names, shapes and
    dtypes (``a_log`` and ``d_skip`` float32) and cache tree (float32 SSM
    state, bf16 conv history and K/V), nothing allocated."""
    _need_jax()
    kw = {"layer_range": layer_range}
    jm = JaxModel(r_arch(NAME), **kw)
    model = Model(get_arch(NAME), device="meta", **kw)
    want = _leaves(jm.param_shapes())
    assert _leaves(model.state_dict()) == want
    assert want["dec0.p0_ssm.a_log" if layer_range != (6, 8)
                else "dec6.p0_ssm.a_log"][1] == "float32"
    assert _leaves(model.cache_shapes(2, 64)) == \
        _leaves(jm.cache_shapes(2, 64))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_apply_ssm_on_the_card_matches_the_cpu():
    """One reduced ssm block at S = 100, with and without a carried
    state, on the card against the same call on the CPU (float32, 1e-5 of
    each tensor's largest magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for with_state in (False, True):
        arch, p, x, state = _block_inputs(100, with_state, seed=1)
        kw = dict(d_state=arch.ssm_d_state, d_conv=arch.ssm_conv,
                  norm=arch.norm)
        runs = []
        for dev in ("cpu", "cuda"):
            st = None if state is None else {
                k: torch.from_numpy(v).to(dev) for k, v in state.items()}
            runs.append(ssm.apply_ssm(
                torch.from_numpy(x).to(dev),
                {k: torch.from_numpy(v).to(dev) for k, v in p.items()},
                state=st, **kw))
        (want, ws), (got, gs) = runs
        _held(got.cpu(), want.numpy(), SSM_TOL, "y")
        for k in ("ssm", "conv"):
            _held(gs[k].cpu(), ws[k].numpy(), SSM_TOL, k)
