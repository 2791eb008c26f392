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
    wide = torch.zeros((1, segred.MAX_N + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        segred.segmented_reduce(wide, wide.long(), "sum")
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


def test_build_takes_a_source_outside_csrc(monkeypatch, tmp_path):
    """A yardstick kept outside ``csrc/`` is built from the path given with
    its name, cached under that name, and rebuilt when its text changes
    (nvcc and the loader are stand-ins here)."""
    import subprocess
    from pathlib import Path
    from types import SimpleNamespace
    from repro_torch.core.accel import cuda_build

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "subprocess",
                        SimpleNamespace(run=fake_run))
    monkeypatch.setattr(cuda_build, "ctypes",
                        SimpleNamespace(CDLL=lambda path: ("lib", path)))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "BUILD_INFO", {})
    src = tmp_path / "yard.cu"
    src.write_text("// one\n")
    libs = cuda_build.load_all(["yard"], {"yard": src})
    assert calls[0][-1] == str(src) and len(calls) == 1
    assert Path(cuda_build.BUILD_INFO["yard"]["path"]).name.startswith(
        "libyard_")
    assert cuda_build.load("yard", src) is libs["yard"] and len(calls) == 1
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    src.write_text("// two\n")
    cuda_build.load("yard", src)
    assert len(calls) == 2 and not cuda_build.BUILD_INFO["yard"]["cached"]


def test_kernel_source_takes_the_rows_the_wrapper_passes():
    """The longest row the wrapper lets through is the kernel's ``kMaxN``,
    and the C entry points it binds are the ones ``csrc/segred.cu``
    defines (nvcc does not run here)."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "segred.cu").read_text()
    assert int(re.search(r"kMaxN = (\d+);", src).group(1)) == segred.MAX_N
    for entry in ("segred_f32", "segred_f64"):
        assert re.search(rf'extern "C" int {entry}\(', src)


def test_first_design_source_exports_what_the_smoke_run_binds():
    """The yardstick ``chip_smoke.py`` times beside the kernel
    (``tools/segred_first_design.cu``) defines the entry points it binds,
    with the kernel's arguments."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "tools" /
           "segred_first_design.cu").read_text()
    for entry in ("segred_f32", "segred_f64"):
        assert re.search(rf'extern "C" int {entry}\(const void\* vals, '
                         rf'const void\* pid, void\* out, int N,\s+int n, '
                         rf'int op, void\* stream\)', src), entry


def test_paths_tool_finds_its_rule_in_the_source():
    """``tools/segred_paths.py`` forces each of the kernel's two paths by
    replacing the rule's constant: the line it replaces is in
    ``csrc/segred.cu``, and the launch chooses by it."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "segred_paths", root / "tools" / "segred_paths.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "segred.cu").read_text()
    assert src.count(tool._RULE) == 1
    assert "if ((int64_t)N * n * n <= kOutputCompares)" in src


def _card_inputs(N, n, seed):
    """``_inputs`` plus, where the rows exist, a row holding NaN (row 4) and
    a row whose segments hold tied maxima (row 5)."""
    vals, pid = _inputs(N, n, seed=seed)
    if N > 5 and n > 2:
        vals[4, n // 2] = np.nan
        vals[5] = np.round(vals[5] * 4) / 4      # few distinct values: ties
    return vals, pid


def _bitwise_equal(got, want):
    """The same NaN positions, and every other element bit for bit."""
    nan = torch.isnan(want)
    ints = torch.int32 if got.dtype == torch.float32 else torch.int64
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 47), (28, 47), (4099, 47), (64, 7),
                                   (65536, 47), (64, 1), (130, 64),
                                   (3, 3000), (2, 8192)])
def test_kernel_matches_plain_on_card(shape, dtype):
    """Both routes are bitwise the plain version's: max and sum walk each
    row in node order. The shapes: the mapper's, a brute-force chunk's,
    one node a row, an even row length (bank conflicts in the walk), rows
    too long to share a block, and the longest row (more than 48 KB of
    shared memory). Rows 0-2 are one segment, row 3 has one node a
    segment, row 4 holds NaN and row 5 tied maxima."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    vals, pid = _card_inputs(*shape, seed=sum(shape))
    v = torch.from_numpy(vals).to("cuda", dtype)
    p = torch.from_numpy(pid).to("cuda")
    before = segred.LAUNCHES
    for op in ("max", "sum"):
        got = segred.segmented_reduce(v, p, op)
        want = segred.segmented_reduce_plain(v, p, op)
        torch.cuda.synchronize()
        assert _bitwise_equal(got, want), op
    assert segred.LAUNCHES == before + 2
    with pytest.raises(ValueError, match="contiguous"):
        segred.segmented_reduce(_strided(v), p, "max")
