"""The port's train loop and the plumbing around it, on the CPU.

The train loop learns and resumes equivalently at the JAX package's
tolerances (``tests/test_integration.py``'s two train cases on
``device="cpu"``); a checkpoint written by JAX's ``train()`` restores into
the port's ``{"params", "opt"}`` tree leaf for leaf, and the port resumes
from it; ``opt_state_from_jax`` keeps every bit; elastic resharding on one
device; ``main``; the kernel wrappers refuse to run under grad (they have
no backward, as their Pallas originals have none). On a card only: a
reduced train step on the card against the same step on the CPU."""
import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import checkpoint as r_ckpt
    from repro.checkpoint import elastic as r_elastic
    from repro.configs import get_arch as r_arch
    from repro.configs.base import reduced as r_reduced
    from repro.launch.train import train as r_train
    from repro.optim import adamw as r_adamw
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.checkpoint import elastic
from repro_torch.configs import get_arch, reduced
from repro_torch.core.accel import EngineUnavailable
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_scan
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init

LR = 1e-3

#: the JAX package's integration-test arch (tests/test_integration.py)
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=256)


def _quiet(*a):
    return None


def _tiny(name="tinyllama-1.1b"):
    return reduced(get_arch(name), **TINY)


# ----------------------------------------------------------------------
# the kernel wrappers refuse grad
# ----------------------------------------------------------------------

def test_kernel_wrappers_raise_under_grad_and_run_without_it():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 32, generator=g) for _ in range(3))
    r, kk, vv = (torch.randn(1, 8, 2, 32, generator=g) for _ in range(3))
    w = torch.rand(1, 8, 2, 32, generator=g) * 0.5 + 0.4
    u = torch.randn(2, 32, generator=g)
    runs = (
        (lambda *x: fa.flash_attention(*x, causal=True), (q, k, v),
         "flash_attention has no backward"),
        (rwkv6_scan.wkv6, (r, kk, vv, w, u), "wkv6 has no backward"),
    )
    for fn, args, msg in runs:
        want = fn(*args)                     # grad on, nothing needs it
        for i in range(len(args)):
            tracked = list(args)
            tracked[i] = args[i].clone().requires_grad_(True)
            with pytest.raises(RuntimeError, match=msg):
                fn(*tracked)
            with torch.inference_mode():
                assert torch.equal(fn(*tracked), want)
            with torch.no_grad():
                assert torch.equal(fn(*tracked), want)


def test_a_trainable_kernel_model_raises_under_grad():
    arch = reduced(get_arch("tinyllama-1.1b"))
    model = Model(arch, use_flash=True, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    batch = DataPipeline(arch.vocab_size, 16, 2, device="cpu").batch_at(0)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(batch)
    with torch.inference_mode():
        assert torch.isfinite(model.loss(batch))


def test_train_step_refuses_a_larger_mesh():
    arch = _tiny()
    model = Model(arch, attn_impl="chunked", device="cpu",
                  generator=torch.Generator().manual_seed(0))
    wide = port_mesh.Mesh(("data", "model"), np.full((2, 1), None, object))
    with pytest.raises(NotImplementedError, match="item 15"):
        make_train_step(model, None, wide)


# ----------------------------------------------------------------------
# the train loop
# ----------------------------------------------------------------------

def test_train_loop_runs_and_learns(tmp_path):
    res = port_train.train(_tiny(), steps=12, seq_len=64, global_batch=4,
                           ckpt_dir=str(tmp_path), ckpt_interval=5, lr=1e-3,
                           log=_quiet, device="cpu")
    assert res.steps_run == 12 and len(res.step_seconds) == 12
    assert np.isfinite(res.final_loss) and res.tokens_per_second > 0
    assert np.mean(res.losses[-4:]) < np.mean(res.losses[:4])
    assert t_ckpt.latest_step(str(tmp_path)) == 10


def test_checkpoint_restart_equivalence(tmp_path):
    """kill-and-resume == uninterrupted run (same data, same weights), at
    JAX's tolerances, for every resumed step."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(seq_len=32, global_batch=4, ckpt_interval=5, log=_quiet,
              device="cpu")
    full = port_train.train(_tiny(), steps=10, ckpt_dir=d1, **kw)
    port_train.train(_tiny(), steps=5, ckpt_dir=d2, **kw)
    logged = []
    resumed = port_train.train(_tiny(), steps=10, ckpt_dir=d2,
                               **dict(kw, log=logged.append))
    assert resumed.steps_run == 5                  # resumed from step 5
    assert logged[0] == "[train] resumed from step 5"
    np.testing.assert_allclose(full.losses[-1], resumed.losses[-1],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(full.losses[5:], resumed.losses,
                               rtol=1e-4, atol=1e-5)


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    """JAX's ``train()`` (the integration arch, 5 steps) writes a
    checkpoint; the port's ``{"params", "opt"}`` tree loads it with every
    leaf equal, bitwise and in JAX's dtype, the model takes it, and the
    port's ``train`` resumes from it."""
    d = str(tmp_path)
    r_train(r_reduced(r_arch("tinyllama-1.1b"), **TINY), steps=5,
            seq_len=32, global_batch=4, ckpt_dir=d, ckpt_interval=5,
            log=_quiet)
    _, jflat, _ = r_ckpt.load_checkpoint(d)
    model = Model(_tiny(), attn_impl="chunked", device="cpu",
                  generator=torch.Generator().manual_seed(3))
    like = port_train.checkpoint_tree(model, adamw_init(
        dict(model.named_parameters())))
    step, tree, extra = t_ckpt.load_checkpoint(d, like=like)
    assert step == 5 and "loss" in extra
    got = dict(t_ckpt._flatten(tree))
    assert set(got) == set(jflat)
    for path, want in jflat.items():
        t = got[path]
        if want.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            bits = t.view(torch.int16).numpy()
            np.testing.assert_array_equal(bits, want.view(np.int16))
        else:
            assert str(t.dtype).replace("torch.", "") == str(want.dtype)
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
    state = port_train.restore_tree(model, tree)
    assert int(state.step) == 5
    for k, p in model.state_dict().items():
        assert torch.equal(p, got["params/" + k.replace(".", "/")]), k
    res = port_train.train(_tiny(), steps=7, seq_len=32, global_batch=4,
                           ckpt_dir=d, ckpt_interval=5, log=_quiet,
                           device="cpu")
    assert res.steps_run == 2 and np.isfinite(res.final_loss)


def test_opt_state_from_jax_keeps_every_bit():
    rng = np.random.default_rng(0)
    params = {"dec0": {"p0_attn": {
        "wq": jnp.asarray(rng.standard_normal((3, 4, 4)), jnp.bfloat16),
        "ln_scale": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32)}},
        "embed": {"table": jnp.asarray(rng.standard_normal((8, 4)),
                                       jnp.bfloat16)}}
    state = r_adamw.adamw_init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    _, state = r_adamw.adamw_update(params, grads, state)
    got = convert.opt_state_from_jax(jax.tree.map(np.asarray, state),
                                     device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    for field in ("master", "m", "v"):
        flat = convert.flatten(getattr(state, field))
        assert set(getattr(got, field)) == {"dec0.p0_attn.wq",
                                            "dec0.p0_attn.ln_scale",
                                            "embed.table"}
        for k, w in flat.items():
            assert getattr(got, field)[k].dtype == torch.float32
            np.testing.assert_array_equal(getattr(got, field)[k].numpy(),
                                          np.asarray(w))


def test_reshard_tree_on_one_device_and_shrink():
    tree = {"a": torch.ones(2), "s": port_train.AdamWState(
        torch.zeros((), dtype=torch.int32), {"w": torch.ones(3)}, {}, {})}
    mesh = port_mesh.make_host_mesh("cpu")
    out = elastic.reshard_tree(tree, None, mesh)
    assert isinstance(out["s"], port_train.AdamWState)
    assert torch.equal(out["s"].master["w"], tree["s"].master["w"])
    wide = port_mesh.Mesh(("data", "model"), np.full((2, 2), None, object))
    with pytest.raises(NotImplementedError, match="item 15"):
        elastic.reshard_tree(tree, None, wide)
    for args in ((8, 4, 2), (96, 8, 7), (10, 3, 1)):
        assert elastic.shrink_batch_for_mesh(*args) == \
            r_elastic.shrink_batch_for_mesh(*args)


def test_main_trains_on_the_cpu(capsys):
    assert port_train.main(["--arch", "tinyllama-1.1b", "--reduced",
                            "--device", "cpu", "--steps", "2", "--seq", "16",
                            "--batch", "2"]) == 0
    assert "[train] done: 2 steps" in capsys.readouterr().out


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable):
        port_train.train(_tiny(), steps=1, log=_quiet)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu():
    """A reduced tinyllama-1.1b train step on the card from the same
    float32 weights and batch as on the CPU: the losses of two steps and
    every parameter after them within 1e-4 abs and rel of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: training runs on the card unless "
                    "asked for the CPU")
    arch = reduced(get_arch("tinyllama-1.1b"))
    cpu = Model(arch, attn_impl="chunked", device="cpu",
                generator=torch.Generator().manual_seed(0)).float()
    card = Model(arch, attn_impl="chunked", device="meta")
    card.load_state_dict({k: t.to("cuda") for k, t in
                          cpu.state_dict().items()}, strict=True, assign=True)
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        step = make_train_step(model, None, port_mesh.make_host_mesh(dev),
                               lr=LR)
        state = adamw_init(dict(model.named_parameters()))
        pipe = DataPipeline(arch.vocab_size, 64, 4, device=dev)
        losses = []
        for _ in range(2):
            state, m = step(state, pipe.next_batch())
            losses.append(float(m["loss"]))
        out[name] = (losses, {k: t.cpu() for k, t in
                              model.state_dict().items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for k, t in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], t, rtol=1e-4,
                                   atol=1e-4)
