"""The JAX package's train steps for ``chip_smoke.py``'s ``[train]`` (a).

For each trained arch at full width, the first 2 layers (``Model(arch,
layer_range=(0, 2), attn_impl="chunked")``, JAX's train loop's attention),
with float32 weights from the port's seeded numpy recipe
(``repro_torch.models.convert``, seed 0): 3 steps of JAX's jitted
``make_train_step`` (loss, grads, AdamW at lr 1e-3) on ``make_host_mesh()``
on the CPU, fed ``DataPipeline(vocab, 128, 2, seed=0).batch_at(step)`` for
steps 0, 1, 2. Prints ``TRAIN_RECORD``: per arch the loss of each step and,
for a MoE arch, the routing of step 3's batch under the weights after two
updates (an eager forward): each (layer, token)'s set of top-k experts as a
uint32 bit mask, little-endian, base64.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/train_records.py

(about 2 minutes and 6 GB.) Paste the output into ``chip_smoke.py``.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import sys

import numpy as np

#: the [train] (a) cell: archs, layers, batch, sequence, steps, lr
ARCHS = ("tinyllama-1.1b", "rwkv6-1.6b", "granite-moe-1b-a400m")
LAYERS, BATCH, SEQ, STEPS, SEED, LR = 2, 2, 128, 3, 0, 1e-3


def routing_masks(expert_ids) -> np.ndarray:
    """(T, k) expert ids -> (T,) uint32 masks of each token's experts."""
    ids = np.asarray(expert_ids, np.uint64)
    return np.bitwise_or.reduce(np.left_shift(np.uint64(1), ids),
                                axis=-1).astype(np.uint32)


def record(name: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import DataPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_step
    from repro.launch.train import plan_for_mesh
    from repro.models import moe
    from repro.models.model import Model
    from repro.optim.adamw import adamw_init
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import convert
    from repro_torch.models.model import Model as PortModel

    shapes = {k: tuple(t.shape) for k, t in PortModel(
        port_arch(name), layer_range=(0, LAYERS),
        device="meta").state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert.nest(
        convert.recipe_params(shapes, SEED)))
    arch = get_arch(name)
    model = Model(arch, layer_range=(0, LAYERS), attn_impl="chunked")
    mesh = make_host_mesh()
    plan = plan_for_mesh(dataclasses.replace(arch, num_layers=LAYERS),
                         ShapeSpec("train_record", SEQ, BATCH, "train"),
                         mesh)
    step_fn, in_sh, out_sh = make_train_step(model, plan, mesh, lr=LR)
    jitted = jax.jit(step_fn, in_shardings=in_sh, out_shardings=out_sh)
    opt = adamw_init(params)
    pipe = DataPipeline(arch.vocab_size, SEQ, BATCH, seed=SEED)
    losses, routing = [], None
    for step in range(STEPS):
        batch = pipe.batch_at(step)
        if step == STEPS - 1 and arch.num_experts:
            routing = _routing(model, params, batch, moe)
        params, opt, metrics = jitted(params, opt, batch)
        losses.append(float(metrics["loss"]))
    out = {"losses": losses}
    if routing is not None:
        out["routing"] = base64.b64encode(
            routing.astype("<u4").tobytes()).decode()
    return out


def _routing(model, params, batch, moe) -> np.ndarray:
    """(layers * T,) masks of each MoE layer's routing, in layer order,
    from an eager forward with ``moe.apply_moe`` wrapped to report its
    top-k (the module attribute only, for this process)."""
    import jax
    import jax.numpy as jnp
    captured = []
    apply_moe = moe.apply_moe

    def wrapped(x, p, *, top_k, norm, **kw):
        h = moe.block_norm(x, p, norm)
        logits = h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ p["router"]
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        jax.debug.callback(lambda a: captured.append(np.asarray(a)), ids,
                           ordered=True)
        return apply_moe(x, p, top_k=top_k, norm=norm, **kw)

    moe.apply_moe = wrapped
    try:
        jax.block_until_ready(model.forward(params, batch)[0])
        jax.effects_barrier()
    finally:
        moe.apply_moe = apply_moe
    return np.concatenate([routing_masks(ids) for ids in captured])


def main() -> int:
    rec = {"layers": LAYERS, "batch": BATCH, "seq": SEQ, "steps": STEPS,
           "seed": SEED, "lr": LR,
           "archs": {name: record(name) for name in ARCHS}}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
