"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Each port test module imports ``port_obs_reset`` so that the autouse
fixture below runs around its tests: ``tests/conftest.py`` resets only
``repro.obs``, and the port keeps its own telemetry registry.
"""
import random

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
