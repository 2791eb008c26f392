"""The JAX package's greedy decode for ``chip_smoke.py``'s ``[serve]`` (a).

For each served arch at full width, the first 2 layers, with float32
weights from the port's seeded numpy recipe (``repro_torch.models.convert``,
seed 0) and a float32 cache: one prompt of 16 tokens drawn by
``numpy.random.default_rng(0)``, prefilled into the cache, then 7 greedy
decode steps, each through JAX's eager ``Model.forward(params, batch,
cache=..., cache_pos=jnp.int32(pos))`` on the CPU (``attn_impl="chunked"``,
as JAX's serve builds its model). JAX's own ``serve()`` is not used: it
fails before its first step (ROADMAP Queue 3). Prints ``SERVE_RECORD``:
per arch the 8 tokens and, at each step, the logits of vocabulary ids 0,
1, V/2 - 1, V - 1 and of the token picked.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/serve_records.py

(about 1 minute and 4 GB.) Paste the output into ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import sys

import numpy as np

#: the [serve] (a) cell: archs, layers, batch, prompt and generated tokens
ARCHS = ("tinyllama-1.1b", "rwkv6-1.6b", "granite-moe-1b-a400m")
LAYERS, BATCH, PROMPT, GEN, SEED = 2, 1, 16, 8, 0


def prompt_tokens(vocab: int) -> np.ndarray:
    """The (BATCH, PROMPT) int32 prompt both sides feed."""
    rng = np.random.default_rng(SEED)
    return rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def sample_ids(vocab: int):
    return (0, 1, vocab // 2 - 1, vocab - 1)


def record(name: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import convert
    from repro_torch.models.model import Model as PortModel

    shapes = {k: tuple(t.shape) for k, t in PortModel(
        port_arch(name), layer_range=(0, LAYERS),
        device="meta").state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert.nest(
        convert.recipe_params(shapes, SEED)))
    arch = get_arch(name)
    model = Model(arch, layer_range=(0, LAYERS), attn_impl="chunked",
                  remat=False)
    cache = model.init_cache(BATCH, PROMPT + GEN, dtype=jnp.float32)
    tokens = jnp.asarray(prompt_tokens(arch.vocab_size))
    logits, cache = model.forward(params, {"tokens": tokens}, cache=cache,
                                  cache_pos=jnp.int32(0), head_last_only=True)
    out, samples = [], []
    for step in range(GEN):
        if step:
            logits, cache = model.forward(
                params, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)},
                cache=cache, cache_pos=jnp.int32(PROMPT + step - 1))
        row = np.asarray(logits[0, -1], np.float32)
        tok = int(np.argmax(row))
        out.append(tok)
        samples += [[step, v, float(row[v])]
                    for v in sample_ids(arch.vocab_size) + (tok,)]
    return {"tokens": out, "logits": samples}


def main() -> int:
    rec = {"layers": LAYERS, "batch": BATCH, "prompt": PROMPT, "gen": GEN,
           "seed": SEED, "archs": {name: record(name) for name in ARCHS}}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
