"""The partition-time segmented reduction: the plain PyTorch version against
the Pallas kernel (interpret mode, as the JAX package's own tests run it on
the CPU), the wrapper's checks, and — on a card only — the CUDA kernel
against the plain version."""
import numpy as np
import pytest
import torch

try:                                   # the card's machine may lack jax
    import jax
    import jax.numpy as jnp
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.core.accel import segred


def _inputs(N=64, n=7, seed=0, identity_rows=True):
    """The inputs of tests/test_accel_engine.py::test_pallas_segred_matches
    _numpy, plus rows with no cut (every later segment must hold the
    identity) and a row cut at every edge."""
    rng = np.random.default_rng(seed)
    vals = rng.random((N, n))
    cuts = rng.random((N, n - 1)) < 0.3
    if identity_rows and N > 3:
        cuts[:3] = False
        cuts[3] = True
    pid = np.concatenate([np.zeros((N, 1), np.int64),
                          np.cumsum(cuts, axis=1)], axis=1)
    return vals, pid


def _numpy_ref(vals, pid, op):
    N, n = vals.shape
    red, ident = (np.maximum, -np.inf) if op == "max" else (np.add, 0.0)
    want = np.full((N, n), ident)
    for r in range(N):
        for j in range(n):
            want[r, pid[r, j]] = red(want[r, pid[r, j]], vals[r, j])
    return want


def _strided(v):
    """A non-contiguous view with ``v``'s shape and values (every other
    column of a doubled tensor; non-contiguous even for one row)."""
    return torch.stack([v, v], dim=2).flatten(1)[:, ::2]


@pytest.mark.parametrize("op", ["max", "sum"])
def test_plain_matches_pallas_interpret(op):
    if jax is None:
        pytest.skip("jax is not installed")
    from repro.core.accel.pallas_segred import segmented_reduce as pallas
    vals, pid = _inputs()
    v32 = vals.astype(np.float32)
    want = np.asarray(pallas(jnp.asarray(v32), jnp.asarray(pid), op,
                             interpret=True))
    got = segred.segmented_reduce_plain(torch.from_numpy(v32),
                                        torch.from_numpy(pid), op).numpy()
    assert got.dtype == np.float32
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:3, 1:], -np.inf if op == "max" else 0)


@pytest.mark.parametrize("op", ["max", "sum"])
def test_plain_float64_matches_node_order_reference(op):
    """Sum is taken in node order, the numpy engine's np.add.at order, so
    float64 agrees bitwise with the explicit loop."""
    vals, pid = _inputs(N=40, n=11, seed=3)
    got = segred.segmented_reduce_plain(torch.from_numpy(vals),
                                        torch.from_numpy(pid), op).numpy()
    np.testing.assert_array_equal(got, _numpy_ref(vals, pid, op))


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    vals, pid = _inputs()
    v, p = torch.from_numpy(vals), torch.from_numpy(pid)
    before = segred.LAUNCHES
    for op in ("max", "sum"):
        assert torch.equal(segred.segmented_reduce(v, p, op),
                           segred.segmented_reduce_plain(v, p, op))
    assert segred.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    vals, pid = _inputs()
    v, p = torch.from_numpy(vals), torch.from_numpy(pid)
    with pytest.raises(ValueError, match="op must be"):
        segred.segmented_reduce(v, p, "min")
    with pytest.raises(TypeError, match="float32 or float64"):
        segred.segmented_reduce(v.half(), p, "max")
    with pytest.raises(TypeError, match="int64"):
        segred.segmented_reduce(v, p.int(), "max")
    with pytest.raises(ValueError, match=r"\[N, n\]"):
        segred.segmented_reduce(v, p[:, :-1], "max")
    with pytest.raises(ValueError, match=r"\[N, n\]"):
        segred.segmented_reduce(v[0], p[0], "max")
    with pytest.raises(ValueError, match="contiguous"):
        segred.segmented_reduce(_strided(v), p, "max")
    with pytest.raises(ValueError, match="outside the kernel's range"):
        segred.segmented_reduce(v[:0], p[:0], "sum")
    # neither cpu nor cuda: no silent plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        segred.segmented_reduce(v.to("meta"), p.to("meta"), "max")


def test_build_reuses_the_library_and_its_ptxas_report(tmp_path, monkeypatch):
    """A second process finds the library built from the same source: it
    does not run nvcc again and still reports the build, marked cached.
    nvcc and the loader are stand-ins here."""
    import subprocess
    from types import SimpleNamespace
    from repro_torch.core.accel import cuda_build

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(
            cmd, 0, "", "ptxas info    : Used 32 registers\n")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "subprocess",
                        SimpleNamespace(run=fake_run))
    monkeypatch.setattr(cuda_build, "ctypes",
                        SimpleNamespace(CDLL=lambda path: ("lib", path)))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "BUILD_INFO", {})

    lib = cuda_build.load("segred")
    built = cuda_build.BUILD_INFO["segred"]
    assert len(calls) == 1 and not built["cached"]
    assert "Used 32 registers" in built["ptxas"]
    assert cuda_build.load("segred") is lib and len(calls) == 1
    # a new process: nothing loaded yet, the library is on disk
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "BUILD_INFO", {})
    assert cuda_build.load("segred") == lib and len(calls) == 1
    reused = cuda_build.BUILD_INFO["segred"]
    assert reused == {"seconds": 0.0, "cached": True, "path": built["path"],
                      "ptxas": built["ptxas"]}
    assert [p.name for p in (tmp_path / "kernels").iterdir()
            if p.name.startswith(".")] == []


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 47), (28, 47), (4099, 47), (64, 7)])
def test_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    vals, pid = _inputs(*shape, seed=sum(shape))
    v = torch.from_numpy(vals).to("cuda", dtype)
    p = torch.from_numpy(pid).to("cuda")
    before = segred.LAUNCHES
    for op in ("max", "sum"):
        got = segred.segmented_reduce(v, p, op)
        want = segred.segmented_reduce_plain(v, p, op)
        torch.cuda.synchronize()
        if op == "max":
            assert torch.equal(got, want)
        else:
            rtol = 1e-6 if dtype == torch.float32 else 1e-12
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    assert segred.LAUNCHES == before + 2
    with pytest.raises(ValueError, match="contiguous"):
        segred.segmented_reduce(_strided(v), p, "max")
