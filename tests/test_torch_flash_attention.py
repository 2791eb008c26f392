"""GQA attention: the port's oracles against the JAX oracles, the port's
wrapper (on the CPU, the kernel's plain version) against the Pallas kernel
in interpret mode, the wrapper's routes and checks, and — on a card only —
the CUDA kernel against its plain version."""
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

#: tests/test_kernels.py's FLASH_SHAPES (B, Sq, Skv, H, Hkv, dh)
FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 64),       # MHA, single block
    (2, 256, 256, 8, 2, 64),       # GQA 4:1, multi-block
    (1, 64, 64, 4, 1, 128),        # MQA, wide head
    (2, 37, 37, 4, 2, 64),         # ragged: padding on both axes
    (1, 16, 512, 2, 2, 64),        # cross-attn-like (Skv >> Sq)
]
DTYPES = ["float32", "bfloat16"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _tol(dtype):
    """The JAX kernel tests' tolerance (tests/test_kernels.py::_tol)."""
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _needs_jax():
    if jnp is None:
        pytest.skip("jax is not installed")


def _grid():
    """FLASH_SHAPES x dtype x causal, without causal where Sq != Skv (the
    JAX tests skip those)."""
    return [(s, d, c) for s in FLASH_SHAPES for d in DTYPES
            for c in (True, False) if not (c and s[1] != s[2])]


def _inputs(shape, seed=0):
    """q (B, Sq, H, dh), k and v (B, Skv, Hkv, dh), standard normal
    float32 numpy."""
    B, Sq, Skv, H, Hkv, dh = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                           (B, Skv, Hkv, dh)))


def _jax(arrays, dtype):
    return tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)


def _torch(arrays, dtype, device="cpu"):
    """The same values as ``_jax`` gives: float32, then rounded to
    ``dtype`` (both round to nearest even)."""
    return tuple(torch.from_numpy(a).to(device).to(TORCH_DTYPE[dtype])
                 for a in arrays)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("shape,dtype,causal", _grid())
def test_oracle_matches_jax_oracle(shape, dtype, causal):
    _needs_jax()
    args = _inputs(shape, seed=sum(shape))
    want = jax_ref.attention(*_jax(args, dtype), causal=causal)
    got = ref.attention(*_torch(args, dtype), causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("shape,dtype,causal", _grid())
def test_chunked_oracle_matches_jax_chunked(shape, dtype, causal):
    """block_k 128 so that the multi-block shapes walk several KV blocks
    and the ragged one ends in a partial block."""
    _needs_jax()
    args = _inputs(shape, seed=sum(shape))
    want = jax_ref.attention_chunked(*_jax(args, dtype), causal=causal,
                                     block_k=128)
    got = ref.attention_chunked(*_torch(args, dtype), causal=causal,
                                block_k=128)
    assert got.dtype == TORCH_DTYPE[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("q_offset", [0, 5, 40])
def test_oracles_with_q_offset_match_jax(q_offset):
    """A decode-like query block: 8 queries whose first sits at
    ``q_offset`` of 48 keys; at 40 every key is visible."""
    _needs_jax()
    args = _inputs((2, 8, 48, 4, 2, 32), seed=q_offset)
    jargs, targs = _jax(args, "float32"), _torch(args, "float32")
    want = jax_ref.attention(*jargs, causal=True, q_offset=q_offset)
    _close(ref.attention(*targs, causal=True, q_offset=q_offset), want,
           "float32")
    want_c = jax_ref.attention_chunked(*jargs, causal=True,
                                       q_offset=q_offset, block_k=16)
    _close(ref.attention_chunked(*targs, causal=True, q_offset=q_offset,
                                 block_k=16), want_c, "float32")


def test_chunked_fully_masked_rows_output_zero():
    """With a negative offset, queries before every key see none: the
    oracle's softmax gives NaN there, the chunked form 0 (its l == 0
    guard), as the JAX chunked form does."""
    _needs_jax()
    args = _inputs((1, 6, 16, 2, 2, 32), seed=3)
    want = np.asarray(jax_ref.attention_chunked(*_jax(args, "float32"),
                                                causal=True, q_offset=-3,
                                                block_k=8))
    got = ref.attention_chunked(*_torch(args, "float32"), causal=True,
                                q_offset=-3, block_k=8).numpy()
    assert np.array_equal(got[:, :3], np.zeros_like(got[:, :3]))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,dtype,causal", _grid())
def test_wrapper_matches_pallas_interpret(shape, dtype, causal):
    """JAX's wrapper transposes and pads for the TPU; the port's hands the
    (B, S, H, dh) tensors over as they are."""
    _needs_jax()
    args = _inputs(shape, seed=sum(shape))
    want = jax_ops.flash_attention(*_jax(args, dtype), causal=causal,
                                   interpret=True)
    got = ops.flash_attention(*_torch(args, dtype), causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype]
    _close(got, want, dtype)


def test_q_offset_takes_the_oracle_route():
    """A non-zero or non-int q_offset goes to ``ref.attention`` (the JAX
    wrapper's decode fallback), never to the kernel's wrapper."""
    q, k, v = _torch(_inputs((1, 4, 32, 2, 2, 32), seed=1), "float32")
    seen = []
    kernel = fa.flash_attention
    fa.flash_attention = lambda *a, **kw: seen.append(1) or kernel(*a, **kw)
    try:
        for off in (7, torch.tensor(7)):
            got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
            assert torch.equal(got, ref.attention(q, k, v, causal=True,
                                                  q_offset=7))
        assert seen == []
        ops.flash_attention(q, k, v, causal=True)
        assert seen == [1]
    finally:
        fa.flash_attention = kernel


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = _torch(_inputs((2, 37, 37, 4, 2, 64)), "bfloat16")
    before = fa.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.device.type == "cpu" and fa.LAUNCHES == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True))
    assert torch.equal(out, ref.attention(q, k, v, causal=True))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_inputs((2, 16, 16, 4, 2, 32)), "float32")
    with pytest.raises(ValueError, match=r"\(B, Sq, H, dh\)"):
        fa.flash_attention(q[0], k[0], v[0], causal=True)
    with pytest.raises(ValueError, match="k and v must be"):
        fa.flash_attention(q, k, v[:, :-1], causal=True)
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention(q[:, :, :3], k, v, causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q, k.bfloat16(), v, causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), causal=True)
    q48, k48, v48 = _torch(_inputs((1, 8, 8, 2, 2, 48)), "float32")
    with pytest.raises(ValueError, match="head size 48"):
        fa.flash_attention(q48, k48, v48, causal=True)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        fa.flash_attention(q[:, :0], k, v, causal=True)
    with pytest.raises(ValueError, match="contiguous"):   # a (B, H, S, dh)
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, causal=True)
    # neither cpu nor cuda: no silent plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(x.to("meta") for x in (q, k, v)), causal=True)


def test_kernel_source_exports_what_the_wrapper_calls():
    """The C entry points the wrapper binds, and the head sizes it accepts,
    are the ones ``csrc/flash_attn.cu`` defines (nvcc does not run
    here)."""
    src = (CSRC / "flash_attn.cu").read_text()
    for entry in ("flash_attn_f32", "flash_attn_bf16"):
        assert re.search(rf'extern "C" int {entry}\(', src)
    cases = {int(c) for c in re.findall(r"case (\d+): return launch_dh", src)}
    assert cases == set(fa.HEAD_DIMS)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


#: the CPU grid plus the reduced model's dh=32 and a ragged GQA case
CARD_CASES = _grid() + [((2, 100, 100, 4, 2, 32), d, c) for d in DTYPES
                        for c in (True, False)] + [
    ((3, 77, 77, 8, 2, 64), d, True) for d in DTYPES]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", CARD_CASES)
def test_kernel_matches_plain_on_card(shape, dtype, causal):
    _card()
    q, k, v = _torch(_inputs(shape, seed=sum(shape)), dtype, "cuda")
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.dtype == TORCH_DTYPE[dtype]
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == "bfloat16":
        # both sides work in float32 and round once to bfloat16: at most one
        # rounding step (2**-7 of |want|) apart, plus float32 sum order
        diff, mag = (got.float() - want.float()).abs(), want.float().abs()
        slack = 2e-5 * float(v.float().abs().max())
        assert bool((diff <= 2.0 ** -7 * mag + slack).all())
