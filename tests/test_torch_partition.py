"""Multi-partition plans in the port: the ``PartitionSpec`` trees
(``Model.param_specs`` / ``cache_specs``, the plan's spec methods,
``zero1_specs``, ``opt_state_specs``, the batch and logits specs), the
weight-streaming partition steps (``make_partition_train_step``,
``make_partition_serve_step``) and ``serve`` on a plan of more than one
partition.

Held against the JAX package on the CPU, each package building its plan
from the same ``Variables`` through its own ``export_plan``: the specs as
tuples on every registry arch (reduced) on ``V5E_POD`` designs, whose
folds exceed 1 (on the 1 x 1 host mesh every spec is empty); the partition
steps step by step on plans cut by hand (every reduced arch gets a
one-partition plan from ``plan_for_mesh``), their chain against the
port's own full-graph step and ``generate``. On a card only: reduced
minitron-8b served through its partitions against ``generate``."""
import types

import numpy as np
import pytest
import torch

try:                                   # the card's machine has no jax
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as r_steps
    from repro.launch.mesh import make_host_mesh as r_host_mesh
    from repro.models.model import Model as JaxModel
    from repro.optim.adamw import adamw_init as r_adamw_init
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from _torch_support import (
    cut_plans,
    partition_tree,
    port_partition_model,
    problem_pair,
    random_designs,
    to_port,
)
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.core.partition_spec import P
from repro_torch.core.platform import V5E_POD
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as port_steps
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init

#: boundaries, cotangents and logits within this share of their largest
#: magnitude; losses relative; parameters and AdamW state within this share
#: of each leaf's largest magnitude (the train step's contract)
ACT_TOL, LOSS_TOL, LEAF_TOL = 1e-4, 1e-5, 1e-4
LR = 1e-3
#: the cuts (edges after these graph nodes) of the reduced archs cut to 2
#: layers (nodes: embed, 2 x (mixer, ffn), norm, head): four partitions
#: (the embedding alone, layer 0, layer 1, norm and head) and two cut
#: mid-graph on a layer boundary
LAYERS = 2
CUTS = {"four": (0, 2, 4), "mid": (2,)}
B, S = 2, 8


def _need_jax():
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")


def _weights(name):
    """Reduced ``name`` cut to ``LAYERS`` layers and its float32 weights
    from the port's seeded numpy recipe, as a nested (JAX-layout) tree:
    (port arch, JAX arch, tree)."""
    arch = reduced(get_arch(name), num_layers=LAYERS)
    shapes = {k: tuple(t.shape) for k, t in
              Model(arch, device="meta").state_dict().items()}
    return arch, _r_reduced(name, LAYERS), convert.nest(
        convert.recipe_params(shapes, 0))


def _port_full(arch, tree, **kw):
    """The port's full model holding its own float32 copy of ``tree`` (the
    port writes weights in place; JAX's CPU arrays may share numpy's)."""
    model = Model(arch, device="meta", **kw)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.copy, tree), device="cpu", dtype=torch.float32),
        strict=True, assign=True)
    return model


def _cheap_jit(fn):
    """``jax.jit(fn)`` compiled on its first call at XLA's lowest backend
    optimisation level, as the JAX package's dry run compiles its cost
    probes: the same program, a fraction of the compile time on the CPU.
    Later calls take arguments of the first call's shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": "0"}))
        return compiled[0](*args)

    return call


def _tuples(tree):
    """{path: spec as a tuple} of a nested spec tree (JAX's or the
    port's)."""
    return {k: tuple(v) for k, v in convert.flatten(tree).items()}


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

_SPEC_CASES = {}


def _spec_case(name):
    """The JAX and port models of reduced ``name`` and three plans on
    ``V5E_POD`` (modes alternate by arch): a random walk's 10th design
    without cuts (one partition), its 20th (5 to 17 partitions), and the
    20th's cuts with every node's batch and channels folded 16 ways (the
    walk's folds on a 16 x 16 mesh are mostly 1); built once."""
    if name not in _SPEC_CASES:
        mode = ("train", "prefill", "decode")[sorted(ARCHS).index(name) % 3]
        ref, port = problem_pair(name, mode, mesh_axes=V5E_POD.mesh_axes)
        from repro.core.exporter import export_plan as r_export
        from repro_torch.core.exporter import export_plan as t_export
        walk = random_designs(ref, 20, seed=3)
        n = len(ref.graph.nodes)
        folded = type(walk[19])(walk[19].cuts, (1,) * n, (16,) * n, (16,) * n)
        plans = [(r_export(ref.graph, v, ref.platform),
                  t_export(port.graph, to_port(v), port.platform))
                 for v in (walk[9].with_cuts(()), walk[19], folded)]
        jm = JaxModel(_r_reduced(name))
        tm = Model(reduced(get_arch(name)), device="meta")
        # each param_specs call draws param_shapes() anew: once here
        for m, shapes in ((jm, jm.param_shapes()), (tm, tm.param_shapes())):
            m.param_shapes = lambda shapes=shapes: shapes
        _SPEC_CASES[name] = (jm, tm, plans)
    return _SPEC_CASES[name]


def _r_reduced(name, num_layers=None):
    from repro.configs import get_arch as r_arch
    from repro.configs.base import reduced as r_reduced
    if num_layers is None:
        return r_reduced(r_arch(name))
    return r_reduced(r_arch(name), num_layers=num_layers)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_specs_match_jax(name):
    """``param_specs``, ``cache_specs``, ``data_spec``, ``act_spec``,
    ``kv_cache_spec``, ``spec_for_role`` (every role, ``stacked`` 0 and
    1), the batch specs of every batch key, ``batch_shardings`` and the
    logits spec equal JAX's as tuples, leaf by leaf, on each partition."""
    _need_jax()
    jm, tm, plans = _spec_case(name)
    keys = ("tokens", "labels", "frames", "mrope_positions", "other")
    sharded = {"param_specs": 0, "cache_specs": 0}
    for rp, tp in plans:
        assert len(tp.partitions) == len(rp.partitions)
        for pi in range(len(tp.partitions)):
            for what in ("param_specs", "cache_specs"):
                want = _tuples(getattr(jm, what)(rp, pi))
                got = getattr(tm, what)(tp, pi)
                assert all(isinstance(s, P) for s in
                           convert.flatten(got).values())
                assert _tuples(got) == want, (what, pi)
                sharded[what] += sum(any(e is not None for e in spec)
                                     for spec in want.values())
            for what in ("data_spec", "act_spec", "kv_cache_spec"):
                assert tuple(getattr(tp, what)(pi)) == \
                    tuple(getattr(rp, what)(pi)), (what, pi)
            for kind in ("attn", "ffn", "moe", "embed", "head", "norm"):
                for role in ("col", "row", "expert", "table", "head",
                             "replicate"):
                    for stacked in (0, 1):
                        assert tuple(tp.spec_for_role(
                            role, 3, kind, pi, stacked)) == tuple(
                            rp.spec_for_role(role, 3, kind, pi, stacked))
            assert {k: tuple(v) for k, v in port_steps._batch_specs(
                tp, pi, keys).items()} == {k: tuple(v) for k, v in
                                           r_steps._batch_specs(
                                               rp, pi, keys).items()}
            assert tuple(port_steps._logits_spec(tp, pi)) == \
                tuple(r_steps._logits_spec(rp, pi))
        assert port_steps.batch_shardings(tp, None, {"tokens": 0}) == \
            {"tokens": port_steps._batch_specs(tp, 0, ("tokens",))["tokens"]}
    # folds above 1: some leaves of each tree are sharded
    assert all(sharded.values()), sharded


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_zero1_and_opt_state_specs_match_jax(name):
    """On the 16 x 16 production mesh's shape: ``zero1_specs`` over the
    data axis and over both axes, and ``opt_state_specs`` with and without
    ZeRO-1, equal JAX's as tuples."""
    _need_jax()
    jm, tm, plans = _spec_case(name)
    prod = port_mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert list(port_mesh.make_host_mesh("cpu").shape.items()) == \
        [("data", 1), ("model", 1)]
    r_mesh = types.SimpleNamespace(shape=dict(prod.shape))
    rp, tp = plans[-1]
    jshapes, tshapes = jm.param_shapes(), tm.param_shapes()
    jspecs, tspecs = jm.param_specs(rp, 0), tm.param_specs(tp, 0)
    for dp in (("data",), ("data", "model")):
        got = port_steps.zero1_specs(tshapes, tspecs, prod, dp)
        assert _tuples(got) == _tuples(r_steps.zero1_specs(
            jshapes, jspecs, r_mesh, dp)), dp
    for zero1 in (False, True):
        want = r_steps.opt_state_specs(jshapes, jspecs, r_mesh, zero1)
        got = port_steps.opt_state_specs(tshapes, tspecs, prod, zero1)
        assert type(got).__name__ == "AdamWState"
        assert got.step == P() and tuple(want.step) == ()
        for field in ("master", "m", "v"):
            assert _tuples(getattr(got, field)) == \
                _tuples(getattr(want, field)), (zero1, field)


# JAX's four properties of the specs (tests/test_steps.py), on the port's
# production-mesh plans

def test_param_specs_cover_tree():
    _, tm, plans = _spec_case("tinyllama-1.1b")
    shapes = convert.flatten(tm.param_shapes())
    specs = convert.flatten(tm.param_specs(plans[0][1]))
    assert set(shapes) == set(specs)
    for k, t in shapes.items():
        assert len(specs[k]) <= t.ndim


def test_zero1_specs_divide():
    _, tm, plans = _spec_case("tinyllama-1.1b")
    prod = port_mesh.make_production_mesh()
    shapes = tm.param_shapes()
    z = convert.flatten(port_steps.zero1_specs(
        shapes, tm.param_specs(plans[0][1]), prod, dp_axes=("data",)))
    dp = prod.shape["data"]
    assert any("data" in spec for spec in z.values())
    for k, t in convert.flatten(shapes).items():
        for d, entry in enumerate(z[k]):
            if entry == "data":
                assert t.shape[d] % dp == 0


def test_opt_state_specs_structure():
    _, tm, plans = _spec_case("tinyllama-1.1b")
    specs = tm.param_specs(plans[0][1])
    o = port_steps.opt_state_specs(tm.param_shapes(), specs,
                                   port_mesh.make_production_mesh(),
                                   zero1=True)
    assert isinstance(o.step, P) and len(o.step) == 0
    assert set(convert.flatten(o.master)) == set(convert.flatten(specs))


def test_cache_specs_structure():
    _, tm, plans = _spec_case("tinyllama-1.1b")
    cshapes = tm.cache_shapes(4, 64)
    cspecs = tm.cache_specs(plans[0][1])
    assert set(cshapes) == set(cspecs)
    assert set(convert.flatten(cshapes)) == set(convert.flatten(cspecs))


# ----------------------------------------------------------------------
# partition train steps
# ----------------------------------------------------------------------

def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _update_close(got, want, m_want, what):
    """An updated parameter (or master) within LEAF_TOL of its leaf's max,
    but where its gradient (read from JAX's first moment, which is linear
    in it) lies within the gradient contract's LEAF_TOL of zero: there the
    first step's direction g / (|g| + eps) is not fixed by a gradient held
    at that contract, and the element may move by up to 2 lr more."""
    got = got.detach().float().numpy()
    want, m_want = np.asarray(want, np.float32), np.asarray(m_want)
    tol = LEAF_TOL * float(np.abs(want).max())
    loose = np.abs(m_want) <= LEAF_TOL * float(np.abs(m_want).max())
    err = np.abs(got - want)
    assert (err[~loose] <= tol).all(), (what, float(err[~loose].max()), tol)
    assert (err <= tol + 2 * LR).all(), what


def _train_chain(jsteps, tms, jps, jos, tos, tsteps, tokens, labels):
    """One chained step of each package: the port's forward over
    partitions 0..P-2 stashing each boundary, then the steps P-1..0, each
    taking the cotangent of the next. Both packages' steps take the same
    boundaries (the port's stash) and batch; each pair of outputs is
    compared as it comes (a step's boundary out is its partition's forward
    again). Returns (JAX's, port's) loss."""
    n = len(tms)
    tx = {"tokens": torch.from_numpy(tokens)}
    tb = []
    with torch.no_grad():
        for pi in range(n - 1):
            tb.append(tms[pi](tx)[0] if pi == 0 else
                      tms[pi]({"tokens": None}, embedded=tb[-1])[0])
            assert tb[-1].dtype == torch.float32
    jb = [jnp.asarray(t.numpy()) for t in tb]
    jx = {"tokens": jnp.asarray(tokens)}
    jps[-1], jos[-1], gj, lj = jsteps[-1](jps[-1], jos[-1], jb[-1],
                                          jnp.asarray(labels))
    tos[-1], gt, lt = tsteps[-1](tos[-1], tb[-1], torch.from_numpy(labels))
    assert lt["loss"].dtype == torch.float32 and lt["loss"].ndim == 0
    assert abs(float(lt["loss"]) - float(lj["loss"])) <= \
        LOSS_TOL * abs(float(lj["loss"]))
    _close(gt, gj, ACT_TOL, f"cotangent {n - 1}")
    for pi in range(n - 2, -1, -1):
        if pi == 0:
            jps[0], jos[0], hj = jsteps[0](jps[0], jos[0], jx, gj)
            tos[0], ht = tsteps[0](tos[0], tx, gt)
        else:
            jps[pi], jos[pi], hj, gj = jsteps[pi](jps[pi], jos[pi],
                                                  jb[pi - 1], gj)
            tos[pi], ht, gt = tsteps[pi](tos[pi], tb[pi - 1], gt)
            _close(gt, gj, ACT_TOL, f"cotangent {pi}")
        _close(ht, hj, ACT_TOL, f"boundary out {pi}")
        _close(tb[pi], hj, ACT_TOL, f"boundary {pi}")
    return float(lj["loss"]), float(lt["loss"])


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_partition_train_steps_match_jax(cut):
    """Reduced tinyllama-1.1b (untied) cut to 2 layers, float32 recipe
    weights, one chained step of JAX's jitted partition steps and of the
    port's from the same weights, batch and stashed boundaries:
    boundaries and cotangents at 1e-4 of their largest magnitude, the
    loss at 1e-5 relative, every partition's updated parameters, master,
    m and v at 1e-4 of each leaf's max (``_update_close``); the chained
    loss within 1e-5 of the port's own full-graph step's."""
    _need_jax()
    name = "tinyllama-1.1b"
    arch, r_arch, tree = _weights(name)
    rplan, tplan = cut_plans(name, CUTS[cut], seq=S, batch=B,
                             num_layers=LAYERS)
    n = len(tplan.partitions)
    assert n == len(rplan.partitions) == (4 if cut == "four" else 2)
    full = _port_full(arch, tree, attn_impl="chunked")
    jps, jos, jsteps, tms, tos, tsteps = ([] for _ in range(6))
    for pi, (rp, tp) in enumerate(zip(rplan.partitions, tplan.partitions)):
        jm = JaxModel(r_arch, layer_range=(rp.layer_start, rp.layer_end),
                      include_embed=rp.has_embed, include_head=rp.has_head,
                      attn_impl="chunked")
        jp = jax.tree.map(jnp.asarray, partition_tree(tree, arch, rp))
        step, _, _ = r_steps.make_partition_train_step(
            jm, rplan, r_host_mesh(), pi, lr=LR)
        jps.append(jp)
        jos.append(r_adamw_init(jp))
        jsteps.append(_cheap_jit(step))
        tm = port_partition_model(full, tp, attn_impl="chunked")
        assert all(t.requires_grad for t in tm.parameters())
        tms.append(tm)
        tos.append(adamw_init(dict(tm.named_parameters())))
        tsteps.append(port_steps.make_partition_train_step(
            tm, tplan, port_mesh.make_host_mesh("cpu"), pi, lr=LR))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    _, loss = _train_chain(jsteps, tms, jps, jos, tos, tsteps, tokens, labels)
    for pi in range(n):
        got, state = tms[pi].state_dict(), tos[pi]
        want, jstate = convert.flatten(jps[pi]), jos[pi]
        assert set(got) == set(want) and int(state.step) == 1
        jm_ = convert.flatten(jstate.m)
        for k in want:
            _update_close(got[k], want[k], jm_[k], (pi, k))
            _update_close(state.master[k], convert.flatten(
                jstate.master)[k], jm_[k], (pi, k, "master"))
            _close(state.m[k], jm_[k], LEAF_TOL, (pi, k, "m"))
            _close(state.v[k], convert.flatten(jstate.v)[k], LEAF_TOL,
                   (pi, k, "v"))
    # the partition models' tensors are views of the full model's
    assert tms[-1].state_dict()["final_norm.ln_scale"].data_ptr() == \
        full.state_dict()["final_norm.ln_scale"].data_ptr()
    own = _port_full(arch, tree, attn_impl="chunked")
    step = port_steps.make_train_step(own, None,
                                      port_mesh.make_host_mesh("cpu"), lr=LR)
    _, metrics = step(adamw_init(dict(own.named_parameters())),
                      {"tokens": torch.from_numpy(tokens),
                       "labels": torch.from_numpy(labels)})
    assert abs(loss - float(metrics["loss"])) <= LOSS_TOL * abs(loss)


# ----------------------------------------------------------------------
# partition serve steps
# ----------------------------------------------------------------------

def _serve_chain(run, parts, prompts, gen):
    """Greedy prefill, then ``gen - 1`` decode steps, through ``parts``
    partition steps: ``run(pi, i, inp)`` runs partition ``pi`` at step
    ``i`` (0: the prefill) on the tokens (B, n) (``pi == 0``) or on the
    previous partition's output, and returns its output as numpy float32.
    Returns (tokens (B, gen), each step's last logits (B, V), each step's
    boundaries)."""
    toks, logits, bounds = [], [], []
    x = prompts
    for i in range(gen):
        outs = []
        for pi in range(parts):
            outs.append(run(pi, i, x if pi == 0 else outs[-1]))
        last = outs[-1][:, -1]
        x = np.argmax(last, axis=-1).astype(np.int32)[:, None]
        toks.append(x[:, 0])
        logits.append(last)
        bounds.append(outs[:-1])
    return np.stack(toks, 1), logits, bounds


def _jax_without_constraints(monkeypatch):
    """JAX's serve steps with identity shard functions. As built, its
    partition serve step's decode fails with the ``ShardingTypeError`` of
    its serve path (ROADMAP Queue 3: the host mesh's sharding constraints
    meet the cache update); on one device the constraints place every
    tensor whole, so without them the step computes the same function."""
    monkeypatch.setattr(r_steps, "shard_fns_from_plan",
                        lambda *a, **k: {})


@pytest.mark.parametrize("name,cut", [("tinyllama-1.1b", "four"),
                                      ("rwkv6-1.6b", "mid")])
def test_partition_serve_steps_match_jax_and_generate(name, cut,
                                                      monkeypatch):
    """Reduced archs cut to 2 layers, float32 recipe weights and caches: a
    prefill of 6 tokens and 4 decode steps through each package's
    partition serve steps (each partition model its own cache; JAX's
    jitted, without its sharding constraints) from the same weights:
    every boundary and the logits at 1e-4 of their largest magnitude, the
    tokens equal; and the port's chain against ``generate(plan=None)`` on
    the full model: logits at 1e-4, tokens equal."""
    _need_jax()
    _jax_without_constraints(monkeypatch)
    arch, r_arch, tree = _weights(name)
    rplan, tplan = cut_plans(name, CUTS[cut], mode="prefill", seq=S,
                             batch=B, num_layers=LAYERS)
    full = _port_full(arch, tree, attn_impl="chunked", remat=False)
    gen, P_ = 5, 6
    prompts = np.random.default_rng(5).integers(
        0, arch.vocab_size, (B, P_)).astype(np.int32)
    want_toks, stats = port_serve.generate(
        full, torch.from_numpy(prompts), gen, cache_dtype=torch.float32,
        keep_logits=True)
    jps, jpre, jdec, jcaches, tpre, tdec, tcaches = ([] for _ in range(7))
    cpu = port_mesh.make_host_mesh("cpu")
    for pi, (rp, tp) in enumerate(zip(rplan.partitions, tplan.partitions)):
        jm = JaxModel(r_arch, layer_range=(rp.layer_start, rp.layer_end),
                      include_embed=rp.has_embed, include_head=rp.has_head,
                      attn_impl="chunked", remat=False)
        jps.append(jax.tree.map(jnp.asarray, partition_tree(tree, arch, rp)))
        for lst, mode in ((jpre, "prefill"), (jdec, "decode")):
            lst.append(_cheap_jit(r_steps.make_partition_serve_step(
                jm, rplan, r_host_mesh(), mode, P_ + gen, pi)[0]))
        jcaches.append(jm.init_cache(B, P_ + gen, dtype=jnp.float32))
        tm = port_partition_model(full, tp, attn_impl="chunked",
                                  remat=False)
        for lst, mode in ((tpre, "prefill"), (tdec, "decode")):
            lst.append(port_steps.make_partition_serve_step(
                tm, tplan, cpu, mode, P_ + gen, pi))
        tcaches.append(tm.init_cache(B, P_ + gen, dtype=torch.float32))

    def run_jax(pi, i, inp):
        inp = {"tokens": jnp.asarray(inp)} if pi == 0 else jnp.asarray(inp)
        if i == 0:
            out, jcaches[pi] = jpre[pi](jps[pi], jcaches[pi], inp)
        else:
            out, jcaches[pi] = jdec[pi](jps[pi], jcaches[pi], inp,
                                        jnp.int32(P_ + i - 1))
        return np.asarray(out, np.float32)

    def run_port(pi, i, inp):
        inp = {"tokens": torch.from_numpy(inp)} if pi == 0 \
            else torch.from_numpy(inp)
        if i == 0:
            out, tcaches[pi] = tpre[pi](tcaches[pi], inp)
        else:
            out, tcaches[pi] = tdec[pi](tcaches[pi], inp, torch.tensor(
                P_ + i - 1, dtype=torch.int32))
        assert out.dtype == torch.float32
        return out.numpy()

    n = len(tplan.partitions)
    jt, jl, jb = _serve_chain(run_jax, n, prompts, gen)
    tt, tl, tb = _serve_chain(run_port, n, prompts, gen)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, want_toks.numpy())
    for i in range(gen):
        _close(tl[i], jl[i], ACT_TOL, ("logits", i))
        _close(tl[i], stats["logits"][:, i].numpy(), ACT_TOL,
               ("generate", i))
        for pi, (a, b) in enumerate(zip(tb[i], jb[i])):
            assert a.shape == b.shape == (B, P_ if i == 0 else 1,
                                          arch.d_model)
            _close(a, b, ACT_TOL, ("boundary", i, pi))


def test_partition_steps_follow_jax_for_whisper_and_qwen2_vl(monkeypatch):
    """The boundary is the hidden state alone. whisper: a partition that
    runs the encoder from a boundary (JAX: ``KeyError: 'frames'``) or
    cross-attention without the encoder (JAX: cross-attention over the
    decoder's own tokens, ROADMAP Queue 3) raises a ``ValueError`` naming
    the missing input, in both step builders. qwen2-vl: a partition after
    the first gets no ``mrope_positions`` and runs, as JAX's: a prefill
    through the two partitions of the mid cut equals JAX's chain."""
    _need_jax()
    _jax_without_constraints(monkeypatch)
    cpu = port_mesh.make_host_mesh("cpu")
    for cuts, missing in (((3,), "frames"), ((10,), "enc_out")):
        _, tplan = cut_plans("whisper-small", cuts, seq=S, batch=B)
        arch = reduced(get_arch("whisper-small"))
        for pi, part in enumerate(tplan.partitions):
            m = Model(arch, layer_range=(part.layer_start, part.layer_end),
                      include_embed=part.has_embed,
                      include_head=part.has_head, device="meta")
            feeds = (part.has_head or not part.has_embed,
                     not part.has_embed)
            for make, fed in zip((
                    lambda: port_steps.make_partition_train_step(
                        m, tplan, cpu, pi),
                    lambda: port_steps.make_partition_serve_step(
                        m, tplan, cpu, "prefill", 16, pi)), feeds):
                needs = ((missing == "frames" and fed)
                         or (missing == "enc_out" and part.layer_start > 0))
                if needs:
                    with pytest.raises(ValueError, match=missing):
                        make()
                else:
                    make()
    name = "qwen2-vl-72b"
    arch, r_arch, tree = _weights(name)
    rplan, tplan = cut_plans(name, CUTS["mid"], mode="prefill", seq=S,
                             batch=B, num_layers=LAYERS)
    full = _port_full(arch, tree, attn_impl="chunked", remat=False)
    tokens = np.random.default_rng(2).integers(
        0, arch.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    mrope = np.ascontiguousarray(np.stack([pos, pos, pos]))
    xj = {"tokens": jnp.asarray(tokens), "mrope_positions": jnp.asarray(
        mrope)}
    xt = {"tokens": torch.from_numpy(tokens),
          "mrope_positions": torch.from_numpy(mrope)}
    keys = ("tokens", "mrope_positions")
    for pi, (rp, tp) in enumerate(zip(rplan.partitions, tplan.partitions)):
        jm = JaxModel(r_arch, layer_range=(rp.layer_start, rp.layer_end),
                      include_embed=rp.has_embed, include_head=rp.has_head,
                      attn_impl="chunked", remat=False)
        jstep = _cheap_jit(r_steps.make_partition_serve_step(
            jm, rplan, r_host_mesh(), "prefill", S, pi, batch_keys=keys)[0])
        xj, _ = jstep(jax.tree.map(jnp.asarray, partition_tree(
            tree, arch, rp)), jm.init_cache(B, S, dtype=jnp.float32), xj)
        tm = port_partition_model(full, tp, attn_impl="chunked",
                                  remat=False)
        tstep = port_steps.make_partition_serve_step(
            tm, tplan, cpu, "prefill", S, pi, batch_keys=keys)
        xt, _ = tstep(tm.init_cache(B, S, dtype=torch.float32), xt)
        _close(xt, xj, ACT_TOL, ("qwen2-vl", pi))


# ----------------------------------------------------------------------
# serve on a multi-partition plan
# ----------------------------------------------------------------------

def test_serve_runs_a_two_partition_plan(monkeypatch):
    """``serve`` with ``plan_for_mesh`` giving a 2-partition plan over
    reduced tinyllama-1.1b: it plans before it builds the model, runs
    partition 0's full-graph steps and returns ``generate``'s tokens with
    ``plan=None`` on the same weights and prompts, and
    ``stats["partitions"] == 2``."""
    _, tplan = cut_plans("tinyllama-1.1b", CUTS["mid"], mode="prefill",
                         seq=8, batch=3)
    assert len(tplan.partitions) == 2
    order = []

    def plan_for_mesh(*a, **k):
        order.append("plan")
        return tplan

    class Recorded(Model):
        def __init__(self, *a, **k):
            order.append("model")
            super().__init__(*a, **k)

    monkeypatch.setattr(port_serve, "plan_for_mesh", plan_for_mesh)
    monkeypatch.setattr(port_serve, "Model", Recorded)
    arch = reduced(get_arch("tinyllama-1.1b"))
    logs = []
    tokens, stats = port_serve.serve(arch, prompt_len=8, gen_len=5,
                                     batch=3, seed=4, device="cpu",
                                     log=logs.append)
    assert order == ["plan", "model"]
    assert stats["partitions"] == 2 and "2 partition(s)" in logs[-1]
    model = Model(arch, attn_impl="chunked", remat=False, device="cpu",
                  generator=torch.Generator("cpu").manual_seed(4))
    prompts = torch.randint(0, arch.vocab_size, (3, 8),
                            generator=torch.Generator("cpu").manual_seed(5),
                            dtype=torch.int32)
    want, _ = port_serve.generate(model, prompts, 5)
    assert torch.equal(tokens, want)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_partition_serve_chain_on_the_card_equals_generate():
    """Reduced minitron-8b on the card, bf16 weights from a seed, on a
    2-partition plan cut mid-graph: a greedy prefill and 7 decode steps
    through ``make_partition_serve_step``, each partition model's tensors
    views of the full model's, give ``generate``'s tokens, and logits
    within 1e-3 of max |logit| at every position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: serving runs on the card unless "
                    "asked for the CPU")
    name = "minitron-8b"
    arch = reduced(get_arch(name))
    _, tplan = cut_plans(name, CUTS["mid"], mode="prefill", seq=16, batch=4)
    assert len(tplan.partitions) == 2
    full = Model(arch, attn_impl="chunked", remat=False, device="cuda",
                 generator=torch.Generator("cuda").manual_seed(0))
    prompts = torch.randint(0, arch.vocab_size, (4, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1),
                            dtype=torch.int32)
    want, stats = port_serve.generate(full, prompts, 8, keep_logits=True)
    mesh = port_mesh.make_host_mesh("cuda")
    models = [port_partition_model(full, p, attn_impl="chunked",
                                   remat=False) for p in tplan.partitions]
    steps = [[port_steps.make_partition_serve_step(m, tplan, mesh, mode, 24,
                                                   pi)
              for pi, m in enumerate(models)]
             for mode in ("prefill", "decode")]
    caches = [m.init_cache(4, 24) for m in models]
    x, got, logits = {"tokens": prompts}, [], []
    for i in range(8):
        h = x
        for pi in range(2):
            if i == 0:
                h, caches[pi] = steps[0][pi](caches[pi], h)
            else:
                h, caches[pi] = steps[1][pi](caches[pi], h, torch.tensor(
                    15 + i, dtype=torch.int32, device="cuda"))
        last = h[:, -1].float()
        logits.append(last)
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        got.append(tok)
        x = {"tokens": tok[:, None]}
    assert torch.equal(torch.stack(got, 1), want)
    ref = stats["logits"]
    err = float((torch.stack(logits, 1) - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max())
