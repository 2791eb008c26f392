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
    are the ones ``csrc/flash_attn.cu`` defines (nvcc does not run here):
    float32 goes to the CUDA-core kernel and bfloat16 to the tensor-core
    kernel, each instantiated for every head size."""
    src = (CSRC / "flash_attn.cu").read_text()
    for entry, launcher in (("flash_attn_f32", "launch_f32"),
                            ("flash_attn_bf16", "launch_bf16")):
        assert re.search(rf'extern "C" int {entry}\([^{{]*\{{\s*'
                         rf'return {launcher}\(', src)
    f32 = {int(c) for c in re.findall(
        r"case (\d+): return launch_dh<\1, float>", src)}
    bf16 = {int(c) for c in re.findall(
        r"case (\d+): return launch_mma_dh<\1>", src)}
    assert f32 == bf16 == set(fa.HEAD_DIMS)
    assert re.search(r"flash_attn_kernel<DH, T><<<", src)
    assert re.search(r"flash_attn_mma_kernel<DH><<<", src)
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
               "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
               "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
               "cp.async.cg.shared.global"):
        assert op in src
    assert src.count("cudaFuncAttributeMaxDynamicSharedMemorySize") == 2


def _tensor_core_arithmetic(q, k, v, *, causal, split_p, block=64):
    """The bf16 kernel's arithmetic in plain PyTorch, on the CPU: S in
    float32 from bf16 q and k (a bf16 product is exact in float32), scaled
    in float32 into the exp2 domain; the online softmax over ``block``-key
    tiles with the running max starting at -1e30; l summed from the
    float32 p; P·V with p as bf16 hi plus bf16 lo (``split_p``) or as one
    bf16 value, each product against bf16 v summed in float32; the output
    divided by l and rounded once to bf16."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float().transpose(1, 2)                            # (B, H, Sq, dh)
    kf = torch.repeat_interleave(k.float(), group, 2).transpose(1, 2)
    vf = torch.repeat_interleave(v.float(), group, 2).transpose(1, 2)
    scale_log2 = torch.tensor(1.4426950408889634 / dh ** 0.5,
                              dtype=torch.float32)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, dh))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        s = (qf @ kf[:, :, k0:k0 + block].transpose(-1, -2)) * scale_log2
        if causal:
            kpos = torch.arange(k0, k0 + s.shape[-1])[None, :]
            s = s.masked_fill(kpos > qpos, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split_p else (hi,)
        acc = acc * alpha
        for part in parts:
            acc = acc + part @ vf[:, :, k0:k0 + block]
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def _step_limit_used(got, want, v):
    """The largest share of one bfloat16 rounding step, 2**-7 |want| +
    2e-5 max|v| (chip_smoke.py's bf16 K2 limit), any element uses."""
    diff, mag = (got.float() - want.float()).abs(), want.float().abs()
    slack = 2e-5 * float(v.float().abs().max())
    return float((diff / (2.0 ** -7 * mag + slack)).max())


@pytest.mark.parametrize("split_p,holds", [(True, True), (False, False)])
def test_tensor_core_arithmetic_needs_a_split_p(split_p, holds):
    """At (1, 1024, 4, 1, 64), causal, bf16: with P as bf16 hi + lo the
    kernel's arithmetic holds the plain version within one rounding step;
    with one bf16 P it leaves that limit (each p rounded once more than
    the plain version rounds it), which is why the kernel splits P."""
    q, k, v = _torch(_inputs((1, 1024, 1024, 4, 1, 64), seed=16),
                     "bfloat16")
    want = fa.flash_attention_plain(q, k, v, causal=True)
    got = _tensor_core_arithmetic(q, k, v, causal=True, split_p=split_p)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    used = _step_limit_used(got, want, v)
    assert (used <= 1.0) == holds, used


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


#: the CPU grid plus the reduced model's dh=32, a ragged GQA case and
#: chip_smoke.py's two causal multi-tile cases (dh 128 and 32)
CARD_CASES = _grid() + [((2, 100, 100, 4, 2, 32), d, c) for d in DTYPES
                        for c in (True, False)] + [
    (shape, d, True) for shape in ((3, 77, 77, 8, 2, 64),
                                   (1, 2048, 2048, 16, 2, 128),
                                   (1, 1024, 1024, 8, 8, 32))
    for d in DTYPES]


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
        # the plain version works in float32 and rounds once to bfloat16;
        # the kernel's P is bf16 hi + lo: at most one rounding step (2**-7
        # of |want|) apart, plus float32 sum order
        assert _step_limit_used(got, want, v) <= 1.0


@pytest.mark.gpu
def test_bf16_kernel_refuses_a_misaligned_tensor_on_card():
    """The bf16 kernel copies 16 bytes at a time: a contiguous view that
    starts off a 16-byte boundary raises rather than launching."""
    _card()
    q, k, v = _torch(_inputs((1, 64, 64, 2, 2, 32)), "bfloat16", "cuda")
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    q1 = shifted[1:].view(q.shape)
    q1.copy_(q)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q1, k, v, causal=True)
    assert fa.LAUNCHES == before
