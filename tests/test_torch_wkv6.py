"""The RWKV6 WKV recurrence: the port's oracle against the JAX oracle, the
port's wrapper (on the CPU, the kernel's plain version) against the Pallas
kernel in interpret mode, a strong-decay case held to the oracle, the
wrapper's checks, and — on a card only — the CUDA kernel against its plain
version."""
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
    test's range by default), u ~ N(0, 0.01); float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)) for _ in range(3))
    lo, hi = w_range
    w = lo + (hi - lo) * rng.random((B, T, H, hs))
    u = 0.1 * rng.standard_normal((H, hs))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u))


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
    cases = {int(c) for c in re.findall(r"case (\d+): launch_hs", src)}
    assert cases == set(rwkv6_scan.HEAD_SIZES)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,w_range", [
    *((s, (0.55, 0.95)) for s in WKV_SHAPES),
    ((1, 256, 2, 64), (0.02, 0.1)),
])
def test_kernel_matches_plain_on_card(shape, w_range, dtype):
    _card()
    r, k, v, w, u = (x.to("cuda") for x in _t(*_inputs(
        *shape, seed=sum(shape), w_range=w_range)))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    before = rwkv6_scan.LAUNCHES
    got = ops.rwkv6(r, k, v, w, u)
    want, _ = ref.rwkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert rwkv6_scan.LAUNCHES == before + 1
    assert got.dtype == dtype
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
