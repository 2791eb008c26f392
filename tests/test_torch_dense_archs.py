"""The other dense archs the port builds: reduced llama3.2-1b (a tied head:
the logits read the embedding table, ``models/model.py``), stablelm-3b
(``norm="ln"`` with a bias, and as many KV heads as query heads) and
minitron-8b (GQA, group 2), each held to the JAX package's
``Model(arch, use_flash=True)`` (its Pallas flash-attention kernel in
interpret mode) in float32, as ``tests/test_torch_dense_model.py`` holds
tinyllama-1.1b; and each one's full-width parameter tree."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

import jax.numpy as jnp  # noqa: E402

from _torch_support import (jax_run, port_model, port_run,  # noqa: E402
                            reduced_jax_tree)
from _torch_support import port_obs_reset  # noqa: E402,F401
from repro.configs import get_arch as r_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["llama3.2-1b", "stablelm-3b", "minitron-8b"]


def _tree(name, seed=0):
    """The JAX ``init_params`` tree of reduced ``name`` with every norm's
    scale and bias redrawn around 1 and 0 (scale 0.1, from ``seed``): at
    init they are exactly 1 and 0, under which a norm that dropped its
    scale or bias would still agree."""
    flat = dict(convert.flatten(reduced_jax_tree(name)))
    rng = np.random.default_rng(seed)
    for key, a in flat.items():
        if key.endswith(("ln_scale", "ln_bias")):
            base = 1.0 if key.endswith("ln_scale") else 0.0
            flat[key] = (base + 0.1 * rng.standard_normal(a.shape)).astype(
                a.dtype)
    return convert.nest(flat)


@pytest.mark.parametrize("S", [16, 100])
@pytest.mark.parametrize("name", ARCHS)
def test_float32_forward_and_loss_match_jax(name, S):
    """Logits 1e-4 abs and rel, loss 1e-5 relative: tinyllama-1.1b's
    float32 contract, with the norms' scales and biases redrawn."""
    arch = reduced(get_arch(name))
    tree = _tree(name)
    batch = convert.recipe_batch(arch.vocab_size, 2, S, 0)
    want, want_loss = jax_run(name, tree, batch, jnp.float32)
    model = port_model(name, tree, torch.float32, use_flash=True)
    logits, loss = port_run(model, batch)
    assert logits.shape == (2, S, arch.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=1e-4)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


def test_the_reduced_archs_take_the_paths_named():
    """What each reduced arch exercises: llama3.2-1b ties its head (no
    ``head.w`` leaf), stablelm-3b has layer norm with a bias and
    H == Hkv, minitron-8b groups its query heads."""
    leaves = {n: set(Model(reduced(get_arch(n)), device="meta")
                     .state_dict()) for n in ARCHS}
    llama, stablelm, minitron = (reduced(get_arch(n)) for n in ARCHS)
    assert llama.tie_embeddings and "head.w" not in leaves["llama3.2-1b"]
    assert "head.w" in leaves["minitron-8b"]
    assert stablelm.norm == "ln" and \
        stablelm.num_heads == stablelm.num_kv_heads
    assert any(k.endswith("ln_bias") for k in leaves["stablelm-3b"])
    assert minitron.num_heads == 2 * minitron.num_kv_heads


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_parameter_tree_matches_jax(name):
    """Names, shapes and dtypes at full width, on the meta device, and the
    published configuration itself."""
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in convert.flatten(
        jax.eval_shape(JaxModel(r_arch(name)).init_params,
                       jax.random.PRNGKey(0))).items()}
    model = Model(get_arch(name), device="meta")
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in convert.flatten(model.param_shapes()).items()}
    assert got == want
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(r_arch(name))
