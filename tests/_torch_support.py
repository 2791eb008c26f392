"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Each port test module imports ``port_obs_reset`` so that the autouse
fixture below runs around its tests: ``tests/conftest.py`` resets only
``repro.obs``, and the port keeps its own telemetry registry.
"""
import functools
import random
import sys

import numpy as np
import pytest

#: the tiny shapes of the JAX package's engine tests (name, seq, batch, mode)
TINY_SHAPES = {
    "train": ("train_tiny", 256, 16, "train"),
    "prefill": ("prefill_tiny", 256, 16, "prefill"),
    "decode": ("decode_tiny", 256, 16, "decode"),
}
MESH_4X4 = (("data", 4), ("model", 4))


@pytest.fixture(autouse=True)
def port_obs_reset(monkeypatch):
    """Tracing off, span buffer empty, metrics registry empty — for the
    port's ``repro_torch.obs``, before and after every test. The JAX
    reference is unmasked as well: ``tools/check_static.py --mode nojax``
    sets ``REPRO_NO_JAX=1`` in its process and never unsets it, so a port
    test that runs after it in the same process would lose its reference."""
    monkeypatch.delenv("REPRO_NO_JAX", raising=False)
    from repro_torch.obs import metrics, trace
    trace.disable()
    trace.reset()
    metrics.reset()
    yield
    trace.disable()
    trace.reset()
    metrics.reset()


def problem_pair(arch_name, mode="train", backend="spmd",
                 objective="throughput", exec_model="streaming",
                 mesh_axes=MESH_4X4, reduce=True, **opts):
    """The same Problem built twice, by ``repro`` and by ``repro_torch``,
    each from its own configs, graph builder and platform: (ref, port)."""
    import repro.configs as rc
    import repro.configs.base as rcb
    import repro.core.backends as rbk
    import repro.core.graph_builder as rgb
    import repro.core.objectives as rob
    import repro.core.perfmodel as rpm
    import repro.core.platform as rpl
    import repro_torch.configs as tc
    import repro_torch.configs.base as tcb
    import repro_torch.core.backends as tbk
    import repro_torch.core.graph_builder as tgb
    import repro_torch.core.objectives as tob
    import repro_torch.core.perfmodel as tpm
    import repro_torch.core.platform as tpl

    out = []
    for cfg, base, bk, gb, ob, pm, pl in (
            (rc, rcb, rbk, rgb, rob, rpm, rpl),
            (tc, tcb, tbk, tgb, tob, tpm, tpl)):
        arch = cfg.get_arch(arch_name)
        if reduce:
            arch = cfg.reduced(arch)
        shape = base.ShapeSpec(*TINY_SHAPES[mode])
        plat = pl.Platform(name="t-4x4", mesh_axes=mesh_axes)
        out.append(ob.Problem(graph=gb.build_hdgraph(arch, shape),
                              platform=plat, backend=bk.BACKENDS[backend],
                              objective=objective, exec_model=exec_model,
                              opts=pm.ModelOptions(**opts)))
    return tuple(out)


def random_designs(prob, n, seed=0):
    """``n`` designs from a seeded random walk of the backend's moves (the
    JAX package's engine tests draw theirs the same way)."""
    rng = random.Random(seed)
    v = prob.backend.initial(prob.graph)
    out = []
    for _ in range(n):
        v = prob.backend.random_move(rng, prob.graph, v, prob.platform)
        out.append(v)
    return out


def to_port(v):
    """A ``repro`` Variables as the port's Variables."""
    from repro_torch.core.hdgraph import Variables
    return Variables(v.cuts, v.s_in, v.s_out, v.kern)


@functools.lru_cache(maxsize=None)
def reduced_jax_tree(name):
    """Reduced ``name`` (``repro.configs.base.reduced``): the JAX
    ``init_params(PRNGKey(0))`` tree as numpy (bfloat16 weights)."""
    import jax
    from repro.configs import get_arch
    from repro.configs.base import reduced
    from repro.models.model import Model
    tree = Model(reduced(get_arch(name))).init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, tree)


def port_model(name, params, dtype=None, **kw):
    """The port's reduced ``name`` on the CPU holding the JAX-layout
    ``params`` (``assign=True`` keeps the dtypes of the given tensors, or
    ``dtype`` when one is given). Its parameters are frozen
    (``requires_grad_(False)``): a scoring test builds no autograd graph,
    and the kernel wrappers, which raise under grad, take the tensors."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import convert
    from repro_torch.models.model import Model
    model = Model(reduced(get_arch(name)), device="meta", **kw)
    model.load_state_dict(convert.params_from_jax(params, device="cpu",
                                                  dtype=dtype),
                          strict=True, assign=True)
    return model.requires_grad_(False)


def jax_run(name, params, batch, dtype=None, use_flash=True, **kw):
    """JAX's reduced ``name``: ``Model(use_flash=use_flash, **kw).forward``
    logits as float32 numpy, called as JAX's own model tests call it, and
    the jitted loss when ``batch`` has labels (else None); ``params`` are
    cast to ``dtype`` when one is given."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import reduced
    from repro.models.model import Model
    model = Model(reduced(get_arch(name)), use_flash=use_flash, **kw)
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = model.forward(tree, jb)
    loss = float(jax.jit(model.loss)(tree, jb)) if "labels" in jb else None
    return np.asarray(logits.astype(jnp.float32)), loss


def layer_range_pair(name, params, cut):
    """The port's reduced ``name`` split at layer ``cut`` of its single
    decoder segment ``dec0``: ``Model(layer_range=(0, cut),
    include_head=False)`` and ``Model(layer_range=(cut, L),
    include_embed=False)``, holding the JAX-layout ``params``' slices,
    frozen as ``port_model``'s."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import convert
    from repro_torch.models.model import Model
    arch = reduced(get_arch(name))
    sd = convert.params_from_jax(params, device="cpu")
    m1 = Model(arch, layer_range=(0, cut), include_head=False, device="meta")
    m2 = Model(arch, layer_range=(cut, arch.num_layers), include_embed=False,
               device="meta")
    m1.load_state_dict({"embed.table": sd["embed.table"],
                        **{k: v[:cut] for k, v in sd.items()
                           if k.startswith("dec0.")}},
                       strict=True, assign=True)
    m2.load_state_dict({**{k.replace("dec0.", f"dec{cut}.", 1): v[cut:]
                           for k, v in sd.items() if k.startswith("dec0.")},
                        **{k: v for k, v in sd.items()
                           if k.startswith(("final_norm.", "head."))}},
                       strict=True, assign=True)
    return m1.requires_grad_(False), m2.requires_grad_(False)


def port_run(model, batch):
    """The port's logits (a tensor) and loss (a float) on the numpy
    ``batch``, scored under ``torch.inference_mode()`` as ``chip_smoke.py``
    scores; the forward returns no cache."""
    import torch
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, cache = model(tb)
        assert cache is None
        return logits, float(model.loss(tb))


def lm_sample_points(batch, seq, vocab):
    """The logits ``lm_record`` keeps: (b, t, v) at the first, second,
    middle and last positions of row 0 and the last row, for four
    vocabulary ids."""
    return [(b, t, v) for b in sorted({0, batch - 1})
            for t in (0, 1, seq // 2, seq - 1)
            for v in (0, 1, vocab // 2 - 1, vocab - 1)]


def lm_record(arch, *, layers, batch, seq, seed):
    """The JAX package's float32 loss and sampled logits for the port's
    seeded numpy recipe (``repro_torch.models.convert``): ``Model(arch,
    layer_range=(0, layers))`` on the CPU, with parameter shapes from the
    port's ``Model`` on the meta device. ``chip_smoke.py`` holds the port on
    the card to this record at full width. The model runs JAX's oracles
    (``use_flash=False``): for RWKV6 the recipe's decays go down to 0.07,
    where the Pallas WKV kernel's within-chunk division underflows over a
    128-step chunk and returns NaN (ROADMAP Queue 3); for attention the
    oracle and the Pallas kernel agree to about 5e-6 in float32."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import Model
    from repro_torch.models import convert
    from repro_torch.models.model import Model as PortModel

    shapes = {k: tuple(t.shape) for k, t in PortModel(
        arch, layer_range=(0, layers), device="meta").state_dict().items()}
    arrays = convert.recipe_params(shapes, seed)
    params = jax.tree.map(jnp.asarray, convert.nest(arrays))
    del arrays
    data = convert.recipe_batch(arch.vocab_size, batch, seq, seed)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    model = Model(arch, layer_range=(0, layers))
    logits = np.asarray(model.forward(params, jbatch)[0], np.float32)
    loss = float(model.loss(params, jbatch))
    return {"loss": loss,
            "logits": [[b, t, v, float(logits[b, t, v])] for b, t, v in
                       lm_sample_points(batch, seq, arch.vocab_size)]}


def partition_tree(tree, arch, part):
    """The parameter tree of ``part``'s model (``Model(arch,
    layer_range=(part.layer_start, part.layer_end),
    include_embed=part.has_embed, include_head=part.has_head)``) cut from
    the full model's nested ``tree`` (JAX arrays, numpy arrays or
    tensors): each of its segments' stacked leaves sliced along axis 0
    from the full segment that holds its first layer (the JAX package's
    dry run builds partition models so; its tests hold no weights)."""
    from repro_torch.models.model import build_segments
    full = [s for s in build_segments(arch) if not s.encoder]
    out = {}
    if part.has_embed or (part.has_head and arch.tie_embeddings):
        out["embed"] = tree["embed"]
    for seg in build_segments(arch, (part.layer_start, part.layer_end)):
        if seg.encoder:
            out[seg.name] = tree[seg.name]
            continue
        start = int(seg.name[3:])
        src = [s for s in full if int(s.name[3:]) <= start][-1]
        off = (start - int(src.name[3:])) // (max(src.layer_of) + 1)
        out[seg.name] = {pk: {k: a[off:off + seg.count]
                              for k, a in leaves.items()}
                         for pk, leaves in tree[src.name].items()}
    if part.has_head:
        out["final_norm"] = tree["final_norm"]
        if not arch.tie_embeddings:
            out["head"] = tree["head"]
    return out


def port_partition_model(model, part, **kw):
    """``part``'s model of the port, its parameters views of ``model``'s
    (no copy: ``load_state_dict(assign=True)``), ``kw`` for ``Model``."""
    from repro_torch.models import convert
    from repro_torch.models.model import Model
    tree = convert.nest(model.state_dict())
    pm = Model(model.arch, layer_range=(part.layer_start, part.layer_end),
               include_embed=part.has_embed, include_head=part.has_head,
               device="meta", **kw)
    pm.load_state_dict(convert.flatten(partition_tree(tree, model.arch,
                                                      part)),
                       strict=True, assign=True)
    return pm


def cut_plans(arch_name, cuts, mode="train", seq=16, batch=2,
              num_layers=None):
    """The plan of reduced ``arch_name`` (cut to ``num_layers`` when
    given) whose partitions the ``cuts`` (edges after these graph nodes)
    make, built twice from the same ``Variables`` (the spmd backend's
    initial folds): by the JAX package's ``export_plan`` and by the
    port's, on ``V5E_POD``. (ref, port)."""
    import repro.configs as rc
    import repro.core.backends as rbk
    import repro.core.exporter as rex
    import repro.core.graph_builder as rgb
    import repro.core.platform as rpl
    import repro_torch.configs as tc
    import repro_torch.core.backends as tbk
    import repro_torch.core.exporter as tex
    import repro_torch.core.graph_builder as tgb
    import repro_torch.core.platform as tpl
    out = []
    for cfg, bk, ex, gb, pl in ((rc, rbk, rex, rgb, rpl),
                                (tc, tbk, tex, tgb, tpl)):
        arch = cfg.reduced(cfg.get_arch(arch_name)) if num_layers is None \
            else cfg.reduced(cfg.get_arch(arch_name), num_layers=num_layers)
        graph = gb.build_hdgraph(arch, cfg.ShapeSpec("t", seq, batch, mode))
        v = bk.BACKENDS["spmd"].initial(graph).with_cuts(tuple(cuts))
        out.append(ex.export_plan(graph, v, pl.V5E_POD))
    return tuple(out)


if __name__ == "__main__":
    # The records in chip_smoke.py (LM_RECORD, DENSE_RECORD), made on the
    # CPU with:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
    #       rwkv6-1.6b 2 1 128 0          # arch, layers, batch, seq, seed
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
    #       tinyllama-1.1b 2 1 128 0
    import json

    from repro.configs import get_arch

    name, layers, batch, seq, seed = sys.argv[1:6]
    print(json.dumps(lm_record(get_arch(name), layers=int(layers),
                               batch=int(batch), seq=int(seq),
                               seed=int(seed))))
