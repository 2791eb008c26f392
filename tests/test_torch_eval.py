"""``repro_torch.core.accel.eval_torch``: the batched array program against
the JAX engine (float32, identical constants through
``tensors_from_numpy``), against the numpy ``BatchedEvaluator`` (float64,
1e-9 — not against jax x64, whose path is red on this jax), padded against
unpadded (bitwise) and the kernel route against the dense route."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

from _torch_support import (  # noqa: E402,F401
    port_obs_reset,
    problem_pair,
    random_designs,
)
from repro.configs import ARCHS  # noqa: E402
from repro.core.accel.eval_jax import JaxEvaluator  # noqa: E402
from repro_torch.core.accel.eval_torch import TorchEvaluator, _eval_core  # noqa: E402
from repro_torch.core.accel.lowering import tensors_from_numpy  # noqa: E402

F32_RTOL = 1e-5
FIELDS = ("objective", "latency", "throughput", "part_times", "reconf_time",
          "node_resident", "node_times", "node_collective")


def _jax_fields(jev):
    return {k: np.asarray(v) for k, v in jev.arrays._asdict().items()}


def _assert_close(got, want, rtol, atol=1e-12):
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.nparts, want.nparts)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, atol=atol, err_msg=f)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.nparts, want.nparts)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _float32_vs_jax(ref, port, designs, use_kernel):
    packed = ref.batched().pack(designs)
    jev = JaxEvaluator.from_problem(ref)
    tev = TorchEvaluator.from_problem(
        port, use_kernel=use_kernel,
        arrays=tensors_from_numpy(_jax_fields(jev), device="cpu"))
    assert tev.arrays.flops.dtype == torch.float32
    _assert_close(tev.evaluate_batch(*packed), jev.evaluate_batch(*packed),
                  F32_RTOL)


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_float32_matches_jax_all_example_archs(arch_name):
    for exec_model in ("streaming", "spmd"):
        ref, port = problem_pair(arch_name, "train", exec_model=exec_model)
        _float32_vs_jax(ref, port, random_designs(ref, 25, seed=1),
                        use_kernel=True)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("backend", ["simple", "megatron", "spmd"])
def test_float32_matches_jax_modes_and_backends(backend, mode, use_kernel):
    for objective, exec_model in (("throughput", "streaming"),
                                  ("latency", "spmd")):
        ref, port = problem_pair("tinyllama-1.1b", mode, backend=backend,
                                 objective=objective, exec_model=exec_model)
        _float32_vs_jax(ref, port, random_designs(ref, 20, seed=2),
                        use_kernel)


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_float64_matches_numpy_engine_at_1e9(arch_name):
    for exec_model in ("streaming", "spmd"):
        _, port = problem_pair(arch_name, "train", exec_model=exec_model,
                               zero1=exec_model == "spmd")
        designs = random_designs(port, 25, seed=5)
        bev = port.batched()
        packed = bev.pack(designs)
        tev = TorchEvaluator(bev, device="cpu", dtype=torch.float64)
        assert tev.arrays.flops.dtype == torch.float64
        _assert_close(tev.evaluate_batch(*packed), bev.evaluate_batch(*packed),
                      rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("arch_name", ["tinyllama-1.1b", "jamba-1.5-large-398b",
                                       "whisper-small"])
def test_padded_is_bitwise_unpadded(arch_name, dtype):
    for exec_model in ("streaming", "spmd"):
        _, port = problem_pair(arch_name, "train", exec_model=exec_model)
        bev = port.batched()
        packed = bev.pack(random_designs(port, 20, seed=7))
        base = TorchEvaluator(bev, device="cpu", dtype=dtype)
        nv = len(bev.platform.fold_values())
        lut = int(max(bev.platform.fold_values())) + 2
        for grow in (1, 4, 9):
            padded = TorchEvaluator(
                bev, device="cpu", dtype=dtype,
                pad_nodes=bev.n_nodes + grow,
                pad_pairs=max(bev.scan_pairs.shape[0], 1) + grow,
                pad_vals=nv + grow, pad_lut=lut + grow)
            assert padded.n_pad == bev.n_nodes + grow
            _assert_bitwise(padded.evaluate_batch(*packed),
                            base.evaluate_batch(*packed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_route_matches_dense_route(dtype):
    """Max is bitwise the dense route's; the sum differs only by float
    rounding (node order against the one-hot einsum)."""
    for exec_model in ("streaming", "spmd"):
        _, port = problem_pair("stablelm-3b", "train", exec_model=exec_model)
        bev = port.batched()
        packed = bev.pack(random_designs(port, 30, seed=11))
        on = TorchEvaluator(bev, device="cpu", dtype=dtype, use_kernel=True)
        off = TorchEvaluator(bev, device="cpu", dtype=dtype,
                             use_kernel=False)
        assert on.static.use_kernel and not off.static.use_kernel
        got, want = on.evaluate_batch(*packed), off.evaluate_batch(*packed)
        if exec_model == "streaming":
            _assert_bitwise(got, want)
        else:
            _assert_close(got, want,
                          rtol=1e-6 if dtype == torch.float32 else 1e-12,
                          atol=0)


def test_single_partition_branch_matches_general_branch():
    _, port = problem_pair("granite-moe-1b-a400m", "train", exec_model="spmd")
    bev = port.batched()
    designs = [v.with_cuts(()) for v in random_designs(port, 20, seed=13)]
    si, so, kk, cb = bev.pack(designs)
    assert not cb.any()
    tev = TorchEvaluator(bev, device="cpu", dtype=torch.float64)
    t = lambda a: torch.from_numpy(np.asarray(a))
    for exec_model in ("streaming", "spmd"):
        static = tev.static.__class__(**dict(vars(tev.static),
                                             exec_model=exec_model))
        fast = _eval_core(static, tev.arrays, t(si), t(so), t(kk), t(cb),
                          single_partition=True)
        slow = _eval_core(static, tev.arrays, t(si), t(so), t(kk), t(cb))
        assert torch.equal(fast["feasible"], slow["feasible"])
        for k in ("objective", "latency", "part_times", "reconf_time"):
            torch.testing.assert_close(fast[k], slow[k], rtol=1e-12, atol=0)


def test_evaluate_batch_checks_shapes():
    _, port = problem_pair("tinyllama-1.1b", "train")
    bev = port.batched()
    si, so, kk, cb = bev.pack(random_designs(port, 3))
    tev = TorchEvaluator(bev, device="cpu")
    with pytest.raises(ValueError, match="expected fold arrays"):
        tev.evaluate_batch(si[:, :-1], so, kk, cb)
