"""The JAX package's records for ``chip_smoke.py``'s ``[ssm]`` (a) and
``[encdec]`` (a), made on the CPU.

  ssm     jamba-1.5-large-398b at full width, ``layer_range=(0, 1)`` (one
          ssm + ffn layer with the embedding and the head, 2.1e9
          parameters), float32 weights from the port's seeded numpy recipe
          (``repro_torch.models.convert``, seed 0): the loss and sampled
          logits of a B=1, T=128 recipe batch; then one 16-token prompt
          drawn by ``numpy.random.default_rng(0)``, prefilled into a
          float32 cache, and 7 greedy decode steps through JAX's eager
          ``Model.forward(params, batch, cache=..., cache_pos=...)``: the
          8 tokens and, each step, the logits of ids 0, 1, V/2 - 1, V - 1
          and of the token picked (as ``tools/serve_records.py``). About
          3 minutes and 12 GB: the weights are drawn and converted one
          leaf at a time.
  encdec  whisper-small at full width and depth (12 + 12 layers, 1500
          frames), bfloat16 recipe weights (seed 0), one row of 24 tokens
          (``recipe_batch`` seed 0) and recipe frames (seed 1): JAX's
          cache-less forward over the 24 tokens, with its layer loops
          compiled, at every position the logits of ids 0, 1, V/2 - 1,
          V - 1 and of the position's arg max; and the spread: the largest
          distance over all logits between that forward and the same
          forward run op by op under ``jax.disable_jit``. The port holds
          its prefill of the first 16 tokens and 8 teacher-forced decode
          steps to it. JAX's own decode is not used: its cross-attention
          ignores the cached K/V (ROADMAP Queue 3). About 1 minute, 3 GB.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/ssm_encdec_records.py ssm
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/ssm_encdec_records.py encdec

Each prints one JSON object; paste it into ``chip_smoke.py``
(``SSM_RECORD``, ``ENCDEC_RECORD``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from serve_records import prompt_tokens, sample_ids

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
from _torch_support import lm_sample_points  # noqa: E402

#: [ssm] (a): layers, scoring batch and sequence, prompt and tokens, seed
SSM = {"arch": "jamba-1.5-large-398b", "layers": 1, "batch": 1, "seq": 128,
       "prompt": 16, "gen": 8, "seed": 0}
#: [encdec] (a): prompt, teacher-forced steps, the tokens' and the frames'
#: seeds
ENCDEC = {"arch": "whisper-small", "batch": 1, "prompt": 16, "steps": 8,
          "seed": 0, "frames_seed": 1}


def _params(arch, layer_range, seed, dtype):
    """The port's recipe for ``arch`` as a JAX tree in ``dtype``, drawn
    and converted one leaf at a time."""
    import jax.numpy as jnp
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import convert
    from repro_torch.models.model import Model as PortModel

    shapes = {k: tuple(t.shape) for k, t in PortModel(
        port_arch(arch.name), layer_range=layer_range,
        device="meta").state_dict().items()}
    return convert.nest({name: jnp.asarray(a, dtype) for name, a in
                         convert.recipe_leaves(shapes, seed)})


def ssm_record() -> dict:
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro_torch.models import convert

    cfg = SSM
    arch = get_arch(cfg["arch"])
    lr = (0, cfg["layers"])
    params = _params(arch, lr, cfg["seed"], jnp.float32)
    data = convert.recipe_batch(arch.vocab_size, cfg["batch"], cfg["seq"],
                                cfg["seed"])
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    model = Model(arch, layer_range=lr)
    logits = np.asarray(model.forward(params, jbatch)[0], np.float32)
    loss = float(model.loss(params, jbatch))
    rec = dict(cfg, loss=loss, logits=[
        [b, t, v, float(logits[b, t, v])] for b, t, v in
        lm_sample_points(cfg["batch"], cfg["seq"], arch.vocab_size)])
    del logits

    P, G = cfg["prompt"], cfg["gen"]
    model = Model(arch, layer_range=lr, attn_impl="chunked", remat=False)
    cache = model.init_cache(1, P + G, dtype=jnp.float32)
    step_logits, cache = model.forward(
        params, {"tokens": jnp.asarray(prompt_tokens(arch.vocab_size))},
        cache=cache, cache_pos=jnp.int32(0), head_last_only=True)
    out, samples = [], []
    for step in range(G):
        if step:
            step_logits, cache = model.forward(
                params, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)},
                cache=cache, cache_pos=jnp.int32(P + step - 1))
        row = np.asarray(step_logits[0, -1], np.float32)
        tok = int(np.argmax(row))
        out.append(tok)
        samples += [[step, v, float(row[v])]
                    for v in sample_ids(arch.vocab_size) + (tok,)]
    rec["serve"] = {"tokens": out, "logits": samples}
    return rec


def encdec_record() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models.model import Model
    from repro_torch.models import convert

    cfg = ENCDEC
    arch = get_arch(cfg["arch"])
    params = _params(arch, None, cfg["seed"], jnp.bfloat16)
    S = cfg["prompt"] + cfg["steps"]
    tokens = convert.recipe_batch(arch.vocab_size, cfg["batch"], S,
                                  cfg["seed"])["tokens"]
    frames = convert.recipe_frames(cfg["batch"], arch.num_frames,
                                   arch.d_model, cfg["frames_seed"])
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    model = Model(arch)
    want = np.asarray(model.forward(params, batch)[0], np.float32)
    with jax.disable_jit():
        eager = np.asarray(model.forward(params, batch)[0], np.float32)
    spread = float(np.abs(eager - want).max())
    samples = []
    for t in range(S):
        row = want[0, t]
        ids = sample_ids(arch.vocab_size) + (int(np.argmax(row)),)
        samples += [[t, v, float(row[v])] for v in ids]
    return dict(cfg, tokens=tokens[0].tolist(), spread=spread,
                logits=samples)


def main(argv=None) -> int:
    which = (argv or sys.argv[1:] or ["ssm"])[0]
    rec = {"ssm": ssm_record, "encdec": encdec_record}[which]()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
