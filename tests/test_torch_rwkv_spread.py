"""How far the JAX reference's bfloat16 forward moves under its own
rounding choices, and the port held within that distance.

The reduced ``rwkv6-1.6b`` of ``tests/test_torch_rwkv_model.py`` in
bfloat16 at S=100: JAX's ``Model(use_flash=True).forward`` as its tests run
it (the layer loop compiled, some bfloat16 sums kept unrounded by XLA)
against the same forward op by op under ``jax.disable_jit`` (every
bfloat16 result rounded). A random bfloat16 model turns single rounding
flips into logit differences, so this spread is the yardstick for any
other implementation of the same function."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

import jax.numpy as jnp  # noqa: E402

from _torch_support import port_obs_reset  # noqa: E402,F401
from repro.configs import get_arch as r_arch  # noqa: E402
from repro.configs.base import reduced as r_reduced  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

NAME = "rwkv6-1.6b"


def _jax_logits(tree, tokens):
    model = JaxModel(r_reduced(r_arch(NAME)), use_flash=True)
    logits, _ = model.forward(tree, {"tokens": jnp.asarray(tokens)})
    return np.asarray(logits.astype(jnp.float32))


def test_bfloat16_logits_within_jax_own_spread():
    """The port's logits lie no farther from JAX's compiled forward than
    JAX's own op-by-op forward does."""
    arch = reduced(get_arch(NAME))
    tree = JaxModel(r_reduced(r_arch(NAME))).init_params(
        jax.random.PRNGKey(0))
    tokens = convert.recipe_batch(arch.vocab_size, 2, 100, 0)["tokens"]
    want = _jax_logits(tree, tokens)
    with jax.disable_jit():
        eager = _jax_logits(tree, tokens)
    spread = np.abs(eager - want).max()

    model = Model(arch, use_flash=True, device="meta")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu"), strict=True,
        assign=True)
    logits, _ = model({"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.bfloat16
    assert 0 < spread
    assert np.abs(logits.float().numpy() - want).max() <= spread
