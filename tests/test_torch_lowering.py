"""``repro_torch.core.accel.lowering`` against the JAX lowering, field by
field in numpy, across the example architectures and a pad grid."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

from _torch_support import port_obs_reset, problem_pair  # noqa: E402,F401
from repro.configs import ARCHS  # noqa: E402
from repro.core.accel.lowering import DeviceArrays  # noqa: E402
from repro.core.accel.lowering import lower_program as jax_lower  # noqa: E402
from repro_torch.core.accel.lowering import (  # noqa: E402
    DeviceTensors,
    StaticSpec,
    build_static_spec,
    lower_program,
    tensors_from_numpy,
)


def _np(arrays):
    return {k: np.asarray(v) for k, v in arrays._asdict().items()}


def _pads(bev, grow):
    """(pad_nodes, pad_pairs, pad_vals, pad_lut) grown by ``grow``."""
    if grow is None:
        return {}
    nv = len(bev.platform.fold_values())
    lut = int(max(bev.platform.fold_values())) + 2
    return {"pad_nodes": bev.n_nodes + grow,
            "pad_pairs": max(bev.scan_pairs.shape[0], 1) + grow,
            "pad_vals": nv + grow, "pad_lut": lut + 2 * grow}


def _assert_same(ref: dict, got: DeviceTensors, fdt=torch.float32):
    for k in DeviceTensors._fields:
        a, t = ref[k], getattr(got, k)
        assert t.device.type == "cpu", k
        if a.dtype.kind == "f":
            assert t.dtype == fdt, k
        elif a.dtype.kind in "iu":
            assert t.dtype == torch.int64, k
        else:
            assert t.dtype == torch.bool, k
        b = t.numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)


def test_field_set_and_order_match_device_arrays():
    assert DeviceTensors._fields == DeviceArrays._fields
    import dataclasses
    from repro.core.accel.lowering import StaticSpec as JaxSpec
    jf = [f.name for f in dataclasses.fields(JaxSpec)]
    tf = [f.name for f in dataclasses.fields(StaticSpec)]
    assert tf == [f for f in jf if not f.startswith("pallas")
                  and f != "use_pallas"] + ["use_kernel"]


@pytest.mark.parametrize("grow", [None, 1, 5])
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_lowering_matches_jax_field_by_field(arch_name, grow):
    ref, port = problem_pair(arch_name, "train", exec_model="spmd")
    kw = _pads(ref.batched(), grow)
    js, ja = jax_lower(ref.batched(), **kw)
    ts, tt = lower_program(port.batched(), device="cpu", **kw)
    assert ts.n_nodes == js.n_nodes
    for f in ("mode", "exec_model", "strict_kv", "intra_matching",
              "inter_matching", "scan_tying", "zero1", "seq_parallel_stash",
              "grad_compression", "mxu_efficiency", "overlap_collectives"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.use_kernel is True
    _assert_same(_np(ja), tt)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["simple", "megatron", "spmd"])
def test_lowering_matches_jax_modes_backends(mode, backend):
    ref, port = problem_pair("tinyllama-1.1b", mode, backend=backend,
                             objective="latency")
    _, ja = jax_lower(ref.batched(), **_pads(ref.batched(), 3))
    _, tt = lower_program(port.batched(), device="cpu",
                          **_pads(port.batched(), 3))
    _assert_same(_np(ja), tt)


def test_float64_lowering_is_the_host_arrays_exactly():
    _, port = problem_pair("jamba-1.5-large-398b", "train")
    bev = port.batched()
    _, tt = lower_program(bev, device="cpu", dtype=torch.float64)
    for k in ("flops", "weight_bytes", "act_bytes", "inner_bytes",
              "state_bytes", "kv_bytes", "carry_bytes", "node_d",
              "reshard_full"):
        assert getattr(tt, k).dtype == torch.float64
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      getattr(bev, k))
    np.testing.assert_array_equal(
        np.array([float(getattr(tt, k)) for k in
                  ("peak_flops", "hbm_bw", "hbm_bytes", "ici_bw", "dma_bw",
                   "reconf_fixed_s", "chips")]), bev.platform_scalars())


def test_tensors_from_numpy_round_trips_the_jax_arrays():
    ref, port = problem_pair("granite-moe-1b-a400m", "decode")
    _, ja = jax_lower(ref.batched())
    fields = _np(ja)
    tt = tensors_from_numpy(fields, device="cpu")
    _assert_same(fields, tt)
    _, own = lower_program(port.batched(), device="cpu")
    for k in DeviceTensors._fields:
        assert torch.equal(getattr(tt, k), getattr(own, k)), k
    t64 = tensors_from_numpy(fields, device="cpu", dtype=torch.float64)
    assert t64.flops.dtype == torch.float64
    with pytest.raises(ValueError, match=r"missing \['n_valid'\]"):
        tensors_from_numpy({k: v for k, v in fields.items()
                            if k != "n_valid"}, device="cpu")
    with pytest.raises(ValueError, match=r"unknown \['extra'\]"):
        tensors_from_numpy(dict(fields, extra=np.zeros(1)), device="cpu")


def test_pad_arguments_are_checked():
    _, port = problem_pair("tinyllama-1.1b", "train")
    bev = port.batched()
    for kw, msg in (({"pad_nodes": bev.n_nodes - 1}, "pad_nodes"),
                    ({"pad_vals": 1}, "pad_vals"),
                    ({"pad_lut": 2}, "pad_lut")):
        with pytest.raises(ValueError, match=msg):
            lower_program(bev, device="cpu", **kw)
    spec = build_static_spec(bev, use_kernel=False, pad_nodes=bev.n_nodes + 4)
    assert spec.n_nodes == bev.n_nodes + 4 and spec.use_kernel is False
