"""Training in the port against the JAX package on the CPU: the model
under autograd and the train step.

For reduced tinyllama-1.1b, rwkv6-1.6b and granite-moe-1b-a400m, with
float32 weights carried from JAX (``params_from_jax``) and the pipeline's
batches: the loss within 1e-5 relative of ``jax.value_and_grad(model.loss)``'s,
every gradient leaf within 1e-4 of that leaf's largest magnitude, ``remat``
on and off giving the same gradients, and three steps of
``make_train_step`` against JAX's jitted ``make_train_step`` on
``make_host_mesh()`` (losses 1e-4 relative). The train loop, checkpoints
and the kernel wrappers' refusal of grad are
``tests/test_torch_train_loop.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import port_obs_reset  # noqa: F401
from _torch_support import reduced_jax_tree
from repro.configs import get_arch as r_arch
from repro.configs.base import ShapeSpec as RShape
from repro.configs.base import reduced as r_reduced
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.launch.mesh import make_host_mesh as r_host_mesh
from repro.launch.steps import make_train_step as r_make_train_step
from repro.launch.train import plan_for_mesh as r_plan
from repro.models.model import Model as JaxModel
from repro.optim import adamw as r_adamw
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init

ARCHS = ["tinyllama-1.1b", "rwkv6-1.6b", "granite-moe-1b-a400m"]
BATCH, SEQ, LR, STEPS = 2, 32, 1e-3, 3


def _batch_np(name, step=0):
    arch = reduced(get_arch(name))
    b = JaxPipeline(arch.vocab_size, SEQ, BATCH, seed=0).batch_at(step)
    return {k: np.asarray(v) for k, v in b.items()}


def _port_model(name, **kw):
    """Reduced ``name`` on the CPU, trainable, holding JAX's
    ``init_params(PRNGKey(0))`` weights in float32."""
    model = Model(reduced(get_arch(name)), attn_impl="chunked",
                  device="meta", **kw)
    model.load_state_dict(convert.params_from_jax(
        reduced_jax_tree(name), device="cpu", dtype=torch.float32),
        strict=True, assign=True)
    assert all(p.requires_grad for p in model.parameters())
    return model


def _port_grads(model, batch):
    params = dict(model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@functools.lru_cache(maxsize=None)
def _jax_record(name):
    """JAX's loss and gradients (``jax.value_and_grad(model.loss)``, jitted)
    on the first batch, and the losses of STEPS steps of its jitted
    ``make_train_step`` on ``make_host_mesh()``, from the float32 weights:
    (loss, {leaf: grad}, [step losses])."""
    arch = r_reduced(r_arch(name))
    model = JaxModel(arch, attn_impl="chunked")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          reduced_jax_tree(name))
    batches = [{k: jnp.asarray(v) for k, v in _batch_np(name, s).items()}
               for s in range(STEPS)]
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batches[0])
    mesh = r_host_mesh()
    plan = r_plan(arch, RShape("train_t", SEQ, BATCH, "train"), mesh)
    fn, in_sh, out_sh = r_make_train_step(model, plan, mesh, lr=LR)
    jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    opt = r_adamw.adamw_init(params)
    losses = []
    for jb in batches:
        params, opt, m = jitted(params, opt, jb)
        losses.append(float(m["loss"]))
    return float(loss), {k: np.asarray(g) for k, g in
                         convert.flatten(grads).items()}, losses


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    want_loss, want, _ = _jax_record(name)
    batch = DataPipeline(reduced(get_arch(name)).vocab_size, SEQ, BATCH,
                         seed=0, device="cpu").batch_at(0)
    loss, grads = _port_grads(_port_model(name), batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[k].shape, k
        scale = float(np.max(np.abs(want[k])))
        assert float(np.max(np.abs(g.numpy() - want[k]))) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_grads(name):
    batch = DataPipeline(reduced(get_arch(name)).vocab_size, SEQ, BATCH,
                         seed=0, device="cpu").batch_at(0)
    loss_r, with_remat = _port_grads(_port_model(name, remat=True), batch)
    loss_n, without = _port_grads(_port_model(name, remat=False), batch)
    assert loss_r == loss_n
    for k in with_remat:
        assert torch.equal(with_remat[k], without[k]), k


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_jax(name):
    """Three steps of the port's ``make_train_step`` against JAX's jitted
    ``make_train_step`` on ``make_host_mesh()``: the same float32 weights,
    the pipeline's batches, losses within 1e-4 relative."""
    want = _jax_record(name)[2]
    port = _port_model(name)
    step = make_train_step(port, None, port_mesh.make_host_mesh("cpu"),
                           lr=LR)
    state = adamw_init(dict(port.named_parameters()))
    pipe = DataPipeline(port.arch.vocab_size, SEQ, BATCH, seed=0,
                        device="cpu")
    got = []
    for _ in range(STEPS):
        state, m = step(state, pipe.next_batch())
        assert m["loss"].shape == () and not m["loss"].requires_grad
        got.append(float(m["loss"]))
    assert int(state.step) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[2] != got[0]
