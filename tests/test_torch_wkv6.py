"""The RWKV6 WKV recurrence: the port's oracle against the JAX oracle, the
port's wrapper (on the CPU, the kernel's plain version) against the Pallas
kernel in interpret mode, a strong-decay case and the decay's edge cases
held to the oracle, the wrapper's checks, a CPU emulation of the chunked
bf16 kernel's arithmetic, and — on a card only — the CUDA kernel against
its plain version."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:                                   # the card's machine may lack jax
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
except ImportError:                    # pragma: no cover - jax-free machine
    jnp = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.kernels import ops, ref, rwkv6_scan

#: tests/test_kernels.py's WKV shapes (B, T, H, hs)
WKV_SHAPES = [(1, 128, 2, 32), (2, 256, 4, 64), (1, 100, 2, 64),
              (1, 64, 1, 128)]

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _needs_jax():
    if jnp is None:
        pytest.skip("jax is not installed")


def _inputs(B, T, H, hs, seed=0, w_range=(0.55, 0.95)):
    """r, k, v ~ N(0, 0.25), w uniform in ``w_range`` (the JAX kernel
    test's range by default), u ~ N(0, 0.01); float32 numpy. ``w_range``
    may instead name an edge case of the decay (``W_EDGES``)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)) for _ in range(3))
    if isinstance(w_range, str):
        w = W_EDGES[w_range](rng, (B, T, H, hs))
    else:
        lo, hi = w_range
        w = lo + (hi - lo) * rng.random((B, T, H, hs))
    u = 0.1 * rng.standard_normal((H, hs))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u))


#: decays at the edges of [0, 1]: a third of the multipliers exactly 0 (in
#: float32 exp(-exp(x)) is 0 once x > about 4.5), or near 1e-30, the rest in
#: the JAX test's range; every multiplier exactly 1; and the model's own,
#: about 0.98 (a long memory)
W_EDGES = {
    "zeros": lambda rng, shape: np.where(rng.random(shape) < 1 / 3, 0.0,
                                         0.55 + 0.4 * rng.random(shape)),
    "tiny": lambda rng, shape: np.where(rng.random(shape) < 1 / 3,
                                        1e-30 * (1 + rng.random(shape)),
                                        0.55 + 0.4 * rng.random(shape)),
    "ones": lambda rng, shape: np.ones(shape),
    # the model's: exp(-exp(decay + 0.01 x)), decay -4 (models/rwkv.py)
    "model": lambda rng, shape: np.exp(-np.exp(
        -4.0 + 0.01 * rng.standard_normal(shape))),
}

#: the edge cases (B, T, H, hs) and decay: the decay's edges, one step, a
#: ragged step past a multiple of every chunk length, head sizes 32 and
#: 128, and the model's own decay over a long sequence
EDGE_CASES = [((1, 256, 2, 64), "zeros"), ((1, 256, 2, 64), "tiny"),
              ((1, 256, 2, 64), "ones"), ((2, 1, 3, 64), (0.55, 0.95)),
              ((1, 4097, 1, 64), (0.55, 0.95)), ((2, 300, 3, 32), "zeros"),
              ((1, 300, 2, 128), "tiny"), ((1, 2048, 2, 64), "model")]


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_oracle_matches_jax_oracle(shape, with_state):
    _needs_jax()
    B, T, H, hs = shape
    args = _inputs(*shape, seed=sum(shape))
    state = None
    if with_state:
        state = (0.1 * np.random.default_rng(7).standard_normal(
            (B, H, hs, hs))).astype(np.float32)
    want, want_s = jax_ref.rwkv6(*args, state)
    got, got_s = ref.rwkv6(*_t(*args),
                           None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=1e-5, rtol=1e-5)


def test_oracle_state_carry_equals_full_sequence():
    """Two halves with the state carried == one run (JAX's decode test)."""
    args = _t(*_inputs(1, 32, 2, 16, seed=3))
    r, k, v, w, u = args
    full, full_s = ref.rwkv6(*args)
    half, s = ref.rwkv6(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u)
    rest, rest_s = ref.rwkv6(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u,
                             s)
    torch.testing.assert_close(torch.cat([half, rest], 1), full,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rest_s, full_s, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("shape", [(1, 128, 2, 32), (1, 100, 2, 64)])
def test_wrapper_matches_pallas_interpret(shape, chunk):
    """The Pallas kernel at either chunk length; the port's wrapper does not
    chunk time."""
    _needs_jax()
    args = _inputs(*shape, seed=sum(shape))
    want = np.asarray(jax_ops.rwkv6(*args, chunk=chunk, interpret=True))
    got = ops.rwkv6(*_t(*args))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)


def test_wrapper_takes_any_length_and_keeps_the_dtype():
    """T = 300, a multiple of no chunk length; bfloat16 r, k, v come back
    bfloat16, equal to the oracle's bfloat16 result; float64 w and u are
    cast to float32."""
    args = _t(*_inputs(2, 300, 3, 32, seed=5))
    want, _ = ref.rwkv6(*args)
    assert torch.equal(ops.rwkv6(*args), want)
    r, k, v, w, u = args
    rb, kb, vb = (x.bfloat16() for x in (r, k, v))
    got = ops.rwkv6(rb, kb, vb, w.double(), u.double())
    assert got.dtype == torch.bfloat16
    want_b, _ = ref.rwkv6(rb, kb, vb, w, u)
    assert torch.equal(got, want_b)


def test_strong_decay_matches_oracle():
    """w in [0.02, 0.1] over T = 256: the port holds the oracle at 1e-5."""
    _needs_jax()
    args = _inputs(1, 256, 2, 64, seed=11, w_range=(0.02, 0.1))
    want, _ = jax_ref.rwkv6(*args)
    got = ops.rwkv6(*_t(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,w_range", EDGE_CASES)
def test_plain_version_holds_the_jax_oracle_at_the_edges(shape, w_range,
                                                         dtype):
    """The wrapper's plain version (a CPU tensor) against the JAX oracle at
    the edge cases: float32 at 1e-5 (as the strong-decay case), bfloat16
    r, k, v within one rounding step (both sum in float32 and round once);
    every output finite."""
    _needs_jax()
    args = _inputs(*shape, seed=sum(shape), w_range=w_range)
    r, k, v, w, u = _t(*args)
    if dtype == "bfloat16":
        r, k, v = (x.bfloat16() for x in (r, k, v))
    want, _ = jax_ref.rwkv6(*(np.asarray(x.float()) for x in (r, k, v)),
                            args[3], args[4])
    got = ops.rwkv6(r, k, v, w, u)
    assert got.shape == shape and bool(torch.isfinite(got.float()).all())
    want = torch.from_numpy(np.array(want))
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _within_one_rounding_step(got, want.bfloat16())


def test_pallas_kernel_breaks_under_strong_decay():
    """The reference's Pallas kernel divides k by the within-chunk
    cumulative decay clamped at 1e-38; with w in [0.02, 0.1] that underflows
    in float32 and its result leaves the oracle (ROADMAP Queue 3). This is
    why the port's kernel is held to the oracle, not to the Pallas kernel."""
    _needs_jax()
    args = _inputs(1, 256, 2, 64, seed=11, w_range=(0.02, 0.1))
    want, _ = jax_ref.rwkv6(*args)
    pallas = np.asarray(jax_ops.rwkv6(*args, chunk=128, interpret=True))
    err = np.abs(pallas - np.asarray(want))
    assert not (np.isfinite(err).all() and err.max() < 1e-2)


def test_plain_version_is_the_oracle_head_by_head():
    """``wkv6_plain`` is the oracle's output, and each (b, h) of it is the
    recurrence of that head alone: the kernel's blocks own one (b, h) each
    and index the model's (B, T, H, hs) layout."""
    B, T, H, hs = 2, 40, 3, 32
    r, k, v, w, u = _t(*_inputs(B, T, H, hs, seed=2))
    got = rwkv6_scan.wkv6(r, k, v, w, u)
    want, _ = ref.rwkv6(r, k, v, w, u)
    assert torch.equal(got, want)
    assert torch.equal(rwkv6_scan.wkv6_plain(r, k, v, w, u), want)
    for b in range(B):
        for h in range(H):
            one = [x[b:b + 1, :, h:h + 1] for x in (r, k, v, w)]
            alone, _ = ref.rwkv6(*one, u[h:h + 1])
            torch.testing.assert_close(got[b:b + 1, :, h:h + 1], alone,
                                       atol=1e-6, rtol=1e-6)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    args = _t(*_inputs(1, 64, 2, 32))
    before = rwkv6_scan.LAUNCHES
    out = ops.rwkv6(*args)
    assert out.device.type == "cpu"
    assert rwkv6_scan.LAUNCHES == before


def _bthc(B=2, T=16, H=2, hs=32, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(B, T, H, hs, generator=g).to(dtype)
               for _ in range(3))
    w = torch.rand(B, T, H, hs, generator=g)
    u = torch.randn(H, hs, generator=g)
    return r, k, v, w, u


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, w, u = _bthc()
    with pytest.raises(ValueError, match=r"\(B, T, H, hs\)"):
        rwkv6_scan.wkv6(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="k is"):
        rwkv6_scan.wkv6(r, k[:, :-1], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        rwkv6_scan.wkv6(r, k, v, w, u[None])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rwkv6_scan.wkv6(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rwkv6_scan.wkv6(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError, match="w and u must be float32"):
        rwkv6_scan.wkv6(r, k, v, w.double(), u)
    r24, k24, v24, w24, u24 = _bthc(hs=24)
    with pytest.raises(ValueError, match="head size 24"):
        rwkv6_scan.wkv6(r24, k24, v24, w24, u24)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        rwkv6_scan.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(ValueError, match="contiguous"):   # a (B, H, T, hs)
        rwkv6_scan.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2),
                        k, v, w, u)
    # neither cpu nor cuda: no silent plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        rwkv6_scan.wkv6(*(x.to("meta") for x in (r, k, v, w, u)))


def test_kernel_source_exports_what_the_wrapper_calls():
    """The C entry points the wrapper binds, and the head sizes it accepts,
    are the ones ``csrc/wkv6.cu`` defines (nvcc does not run here)."""
    src = (CSRC / "wkv6.cu").read_text()
    for entry in ("wkv6_f32", "wkv6_bf16"):
        assert re.search(rf'extern "C" int {entry}\(', src)
    for launch in (r"launch_hs<\d+, float>", r"return launch_chunk<\d+>"):
        cases = {int(c) for c in re.findall(rf"case (\d+): {launch}", src)}
        assert cases == set(rwkv6_scan.HEAD_SIZES), launch


def test_step_yardstick_source_runs_bf16_step_by_step():
    """The yardstick ``chip_smoke.py`` and ``tools/wkv6_variants.py`` time
    beside the chunked kernel (``tools/wkv6_step_design.cu``) is
    self-contained: its ``wkv6_bf16`` runs the step kernel at every head
    size the wrapper accepts."""
    src = (CSRC.parents[2] / "tools" / "wkv6_step_design.cu").read_text()
    assert re.search(r'extern "C" int wkv6_bf16\([^)]*\) \{\s+return '
                     r'launch<__nv_bfloat16>\(', src)
    cases = {int(c) for c in re.findall(r"case (\d+): launch_hs<\d+, T>",
                                        src)}
    assert cases == set(rwkv6_scan.HEAD_SIZES)
    assert "launch_chunk" not in src


def test_variants_tool_edits_apply_to_the_source():
    """Every variant of ``tools/wkv6_variants.py`` (its diagnostics too)
    finds the lines it replaces or cuts in ``csrc/wkv6.cu``, and its step
    kernel is the yardstick's own source."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "wkv6_variants", CSRC.parents[2] / "tools" / "wkv6_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    committed = (CSRC / "wkv6.cu").read_text()
    for name in {**tool.VARIANTS, **tool.DIAGNOSTIC}:
        text = tool.source(name)       # raises where an edit does not apply
        assert (text == committed) == (name == "committed"), name
    assert tool.source(tool.STEP_KERNEL) == tool.STEP_SOURCE.read_text()


def _pieces(x, n):
    """float32 x as the kernel feeds it to the tensor cores: n bf16 pieces
    (hi = bf16(x), mid = bf16(x - hi), ...), each exact in float32."""
    out, rest = [], x
    for _ in range(n):
        piece = rest.bfloat16().float()
        out.append(piece)
        rest = rest - piece
    return out


def _chunked_arithmetic(r, k, v, w, u, *, pieces=3, chunk=16):
    """The chunked bf16 kernel's arithmetic (``csrc/wkv6.cu``,
    ``wkv6_chunk_kernel``) on the CPU, in float32, before the output's one
    rounding. Per chunk of 16 steps: the decays as running products of w
    in float32 (P_i forward, Q_s backward, and w_(s+1) ... w_(i-1) for
    each pair s < i), never divided; r P, k Q, the intra-chunk scores A
    and the state S in ``pieces`` bf16 pieces; S (r P)^T as the products
    of piece orders up to pieces - 1, A and k Q against the exact bf16 v
    piece by piece; float32 sums. Steps past T are zero, as the kernel's
    zero-filled copies."""
    B, T, H, hs = r.shape
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))
    uf = u.float()
    out = torch.zeros(B, H, T, hs)
    S = torch.zeros(B, H, hs, hs)                       # [c, j]
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)

        def take(x):
            y = torch.zeros(B, H, chunk, hs)
            y[:, :, :n] = x[:, :, t0:t0 + n]
            return y

        rc, kc, vc, wc = (take(x) for x in (rf, kf, vf, wf))
        P, rd = torch.ones(B, H, hs), []
        for i in range(chunk):
            rd.append(rc[:, :, i] * P)
            P = P * wc[:, :, i]
        Q, kd = torch.ones(B, H, hs), [None] * chunk
        for s in reversed(range(chunk)):
            kd[s] = kc[:, :, s] * Q
            Q = Q * wc[:, :, s]
        A = torch.zeros(B, H, chunk, chunk)                # [i, s]
        for s in range(chunk):
            a = kc[:, :, s]
            A[:, :, s, s] = (rc[:, :, s] * (uf * a)).sum(-1)
            for i in range(s + 1, chunk):
                A[:, :, i, s] = (rc[:, :, i] * a).sum(-1)
                a = a * wc[:, :, i]
        Sp, Rp = _pieces(S, pieces), _pieces(torch.stack(rd, 2), pieces)
        o = sum(Rp[x] @ Sp[y] for x in range(pieces) for y in range(pieces)
                if x + y < pieces)
        o = o + sum(a @ vc for a in _pieces(A, pieces))
        out[:, :, t0:t0 + n] = o[:, :, :n]
        kq = torch.stack(kd, 2).transpose(-1, -2)           # [c, s]
        S = S * P[..., None] + sum(x @ vc for x in _pieces(kq, pieces))
    return out.transpose(1, 2)


def _recurrence64(r, k, v, w, u):
    """The recurrence in float64 (zero initial state): the yardstick of the
    float32 arithmetic."""
    B, T, H, hs = r.shape
    rd, kd, vd, wd = (x.double() for x in (r, k, v, w))
    ud = u.double()[None, :, :, None]
    S = torch.zeros(B, H, hs, hs, dtype=torch.float64)
    outs = []
    for t in range(T):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], S + ud * kv))
        S = wd[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1)


def _step_limit_used(got, want):
    """The largest share of one bf16 rounding step plus 2e-6 max|want| that
    any element uses (<= 1 holds)."""
    diff, mag = (got.float() - want.float()).abs(), want.float().abs()
    return float((diff / (2.0 ** -7 * mag + 2e-6 * float(mag.max()))).max())


@pytest.mark.parametrize("w_range", [(0.55, 0.95), (0.02, 0.1), "zeros",
                                     "tiny", "ones", "model"])
def test_chunked_arithmetic_holds_one_rounding_step(w_range):
    """The kernel's three-piece operands hold the card's bf16 check against
    the oracle at (1, 256, 2, 64), for the JAX test's decays, strong decay,
    the decay's edges and the model's own decay; every output finite."""
    r, k, v, w, u = _t(*_inputs(1, 256, 2, 64, seed=11, w_range=w_range))
    r, k, v = (x.bfloat16() for x in (r, k, v))
    want, _ = ref.rwkv6(r, k, v, w, u)
    got = _chunked_arithmetic(r, k, v, w, u).bfloat16()
    assert bool(torch.isfinite(got.float()).all())
    assert _step_limit_used(got, want) <= 1.0


@pytest.mark.parametrize("w_range", [(0.55, 0.95), (0.02, 0.1)])
def test_chunked_arithmetic_needs_split_operands(w_range):
    """One bf16 rounding of the float32 operands (S, r P, k Q, A) puts
    outputs many rounding steps off the oracle: the split is what holds."""
    r, k, v, w, u = _t(*_inputs(1, 256, 2, 64, seed=11, w_range=w_range))
    r, k, v = (x.bfloat16() for x in (r, k, v))
    want, _ = ref.rwkv6(r, k, v, w, u)
    got = _chunked_arithmetic(r, k, v, w, u, pieces=1).bfloat16()
    assert _step_limit_used(got, want) > 10.0


@pytest.mark.parametrize("pieces,holds", [(3, True), (2, False)])
def test_chunked_arithmetic_needs_three_pieces_under_long_memory(pieces,
                                                                 holds):
    """Under the model's own decay (w about 0.98: a state of some 50
    steps) the float32 arithmetic, before the output's rounding, must stay
    within 1e-6 max|y| of the recurrence in float64, half the slack of the
    card's bf16 check (the plain float32 recurrence lies about 3e-7 from
    it): three bf16 pieces do (about 2e-7), two do not (about 6e-6, which
    on the card put in-model outputs past the check)."""
    r, k, v, w, u = _t(*_inputs(1, 1024, 2, 64, seed=0, w_range="model"))
    r, k, v = (x.bfloat16().float() for x in (r, k, v))
    y64 = _recurrence64(r, k, v, w, u)
    got = _chunked_arithmetic(r, k, v, w, u, pieces=pieces).double()
    err = float((got - y64).abs().max() / y64.abs().max())
    assert (err <= 1e-6) == holds, err


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,w_range", [
    *((s, (0.55, 0.95)) for s in WKV_SHAPES),
    ((1, 256, 2, 64), (0.02, 0.1)),
    *EDGE_CASES,
])
def test_kernel_matches_plain_on_card(shape, w_range, dtype):
    """The JAX test's shapes, strong decay and the edge cases: float32 at
    1e-4, bfloat16 at 2e-2 and one rounding step; every output finite."""
    _card()
    r, k, v, w, u = (x.to("cuda") for x in _t(*_inputs(
        *shape, seed=sum(shape), w_range=w_range)))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    before = rwkv6_scan.LAUNCHES
    got = ops.rwkv6(r, k, v, w, u)
    want, _ = ref.rwkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert rwkv6_scan.LAUNCHES == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        _within_one_rounding_step(got, want)


def _within_one_rounding_step(got, want):
    """Both sides sum in float32 and round once to bfloat16: at most one
    rounding step (2**-7 of |want|) apart, plus the float32 sums' order
    (each order lies within 2.6e-7 max|y| of a float64 recurrence on the
    CPU; the slack is 2e-6 max|want|, as chip_smoke.py's)."""
    diff, mag = (got.float() - want.float()).abs(), want.float().abs()
    assert bool((diff <= 2.0 ** -7 * mag + 2e-6 * float(mag.max())).all())


@pytest.mark.gpu
def test_kernel_matches_plain_on_card_at_lm_shape():
    """The [lm] phase's shape (2, 4096, 32, 64): float32 at 1e-4, bfloat16
    within one rounding step."""
    _card()
    args = _inputs(2, 4096, 32, 64, seed=4)
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, w, u = (x.to("cuda") for x in _t(*args))
        r, k, v = (x.to(dtype) for x in (r, k, v))
        got = ops.rwkv6(r, k, v, w, u)
        want = rwkv6_scan.wkv6_plain(r, k, v, w, u)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _within_one_rounding_step(got, want)


@pytest.mark.gpu
def test_bf16_kernel_refuses_a_misaligned_tensor_on_card():
    """The chunked kernel copies 16 bytes at a time: a contiguous view that
    starts off a 16-byte boundary raises rather than launching."""
    _card()
    r, k, v, w, u = (x.to("cuda") for x in _t(*_inputs(1, 64, 2, 32)))
    r, k, v = (x.bfloat16() for x in (r, k, v))
    shifted = torch.empty(r.numel() + 1, dtype=r.dtype, device="cuda")
    r1 = shifted[1:].view(r.shape)
    r1.copy_(r)
    before = rwkv6_scan.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan.wkv6(r1, k, v, w, u)
    assert rwkv6_scan.LAUNCHES == before
