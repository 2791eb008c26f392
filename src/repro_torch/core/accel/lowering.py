"""Lowering: BatchedEvaluator flat numpy arrays -> torch device tensors.

The port's counterpart of ``repro.core.accel.lowering``. The host lowering
(``core/batched_eval.py``) flattens an HDGraph + Platform + ModelOptions
into per-node numpy arrays; this module turns that result into the two
halves the device array program needs:

  ``StaticSpec``     an immutable, hashable bundle of everything that shapes
                     the program: mode/backend flags, ModelOptions, the
                     (padded) node count and the kernel route
                     (``use_kernel``). Architecture, platform and objective
                     are data, exactly as in the JAX package.
  ``DeviceTensors``  a NamedTuple of torch tensors on one device, with the
                     field set and order of the JAX package's
                     ``DeviceArrays``: per-node workload quantities, kind
                     masks, scan-tying pairs, validity masks, the platform
                     scalars and the mesh-realisability lookup tables.

Dtypes: floats in the working dtype (float32 by default, float64 on
request), every integer in ``torch.int64`` (``gather`` and advanced
indexing need it), masks in ``torch.bool``; scalars are 0-d tensors.

Padding (``pad_nodes``/``pad_pairs``/``pad_vals``/``pad_lut``) follows the
JAX lowering fill for fill: padded columns are neutral, so padded
evaluation is bitwise the unpadded one.

``tensors_from_numpy`` is the crossing point from the JAX package: it takes
a ``DeviceArrays`` passed as numpy (``{k: np.asarray(v) for k, v in
arrays._asdict().items()}``) and returns the port's ``DeviceTensors``, so
a test can give both engines identical constants.

Lanes: the device search bodies take ``DeviceTensors`` with a leading
problem ("lane") axis on every field. ``stack_tensors`` stacks the padded
tensors of a fleet bucket's problems; ``lift_tensors`` gives one problem's
tensors a lane axis of 1, which is how the single-problem engines call the
same bodies.

``problem_fingerprint`` (a copy of the JAX package's) is the content hash
by which ``optimise_portfolio`` coalesces duplicate problems.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.accel import EngineUnavailable
from repro_torch.obs import trace as _trace
from repro_torch.runtime import resolve_device, resolve_dtype

#: realisability tables are built by calling ``platform.folds_realizable``
#: over the fold-value cube; above this menu size the cube is too expensive
#: to enumerate scalar-by-scalar for platforms without a product rule.
MAX_TABLE_VALUES = 64


@dataclass(frozen=True)
class StaticSpec:
    """Hashable program-shaping configuration (see the JAX package's
    ``StaticSpec``). ``use_kernel`` routes the partition-time segmented
    reduction through ``segred.segmented_reduce`` — the CUDA kernel on a
    card, its plain version on the CPU — instead of the dense one-hot
    route. ``n_nodes`` is the PADDED node count."""

    n_nodes: int
    mode: str                       # train | prefill | decode
    exec_model: str                 # streaming | spmd
    strict_kv: bool
    intra_matching: bool
    inter_matching: bool
    scan_tying: bool
    # ModelOptions
    zero1: bool
    seq_parallel_stash: bool
    grad_compression: float
    mxu_efficiency: float
    overlap_collectives: float
    use_kernel: bool = True         # segred kernel route for T(P_i)

    @property
    def train(self) -> bool:
        return self.mode == "train"

    @property
    def decode(self) -> bool:
        return self.mode == "decode"


class DeviceTensors(NamedTuple):
    """Per-node device constants; the field set and order of the JAX
    package's ``DeviceArrays``."""

    flops: torch.Tensor
    weight_bytes: torch.Tensor
    act_bytes: torch.Tensor
    inner_bytes: torch.Tensor
    state_bytes: torch.Tensor
    kv_bytes: torch.Tensor
    carry_bytes: torch.Tensor
    node_d: torch.Tensor
    reshard_full: torch.Tensor
    batch: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    fm_width: torch.Tensor
    col_div: torch.Tensor
    kv_limit: torch.Tensor
    ep_topk: torch.Tensor
    scan_group: torch.Tensor
    internal: torch.Tensor
    elementwise: torch.Tensor
    weight_stream: torch.Tensor
    cut_allowed: torch.Tensor
    real_table: torch.Tensor        # [nv, nv, nv] bool over the fold menu
    val_lut: torch.Tensor           # fold value -> menu index (-1 unknown)
    val_cap: torch.Tensor           # scalar: realisability lut sentinel slot
    # platform scalars — per-problem data
    peak_flops: torch.Tensor        # scalar, float
    hbm_bw: torch.Tensor
    hbm_bytes: torch.Tensor
    ici_bw: torch.Tensor
    dma_bw: torch.Tensor
    reconf_fixed_s: torch.Tensor
    chips: torch.Tensor             # scalar, float (exact: chips <= 2**24)
    # per-problem objective configuration
    obj_latency: torch.Tensor       # scalar bool: True => Eq. 3 latency
    batch_amortisation: torch.Tensor  # scalar, float (B in Eq. 4; exact)
    # kind-specific column masks (see batched_eval._lower's index sets)
    m_attn: torch.Tensor
    m_head: torch.Tensor
    m_tp: torch.Tensor
    m_ep: torch.Tensor
    m_vocab: torch.Tensor
    m_vhead: torch.Tensor
    m_kv: torch.Tensor
    m_carry: torch.Tensor
    # scan-tying consecutive member pairs, padded with (0, 0) self-pairs
    pair_a: torch.Tensor            # [n_pairs_pad]
    pair_b: torch.Tensor
    # padding bookkeeping
    node_valid: torch.Tensor        # [n] bool; False on padded columns
    n_valid: torch.Tensor           # scalar: count of real nodes


def _realizability_table(bev) -> Tuple[np.ndarray, np.ndarray, int]:
    """(table, lut, cap) — reuse the host evaluator's table, or build one.

    ``batched_eval`` builds the cube only for menus of <= 24 values; the
    device engine needs it always. AbstractPlatform realisability is a pure
    product rule, so its cube vectorises at any size; generic platforms are
    enumerated up to ``MAX_TABLE_VALUES`` menu entries.
    """
    if getattr(bev, "_real_table", None) is not None:
        return bev._real_table, bev._val_lut, bev._val_max + 1

    plat = bev.platform
    vals = np.asarray(plat.fold_values(), np.int64)
    nv = len(vals)
    from repro_torch.core.platform import AbstractPlatform
    if isinstance(plat, AbstractPlatform):
        prod = vals[:, None, None] * vals[None, :, None] * vals[None, None, :]
        table = prod <= plat.chips
    elif nv <= MAX_TABLE_VALUES:
        table = np.zeros((nv, nv, nv), bool)
        for a, fa in enumerate(vals):
            for b, fb in enumerate(vals):
                for d, fd in enumerate(vals):
                    table[a, b, d] = plat.folds_realizable((fa, fb, fd))
    else:
        raise EngineUnavailable(
            f"platform {plat.name!r} has {nv} fold values; the torch engine "
            f"needs a dense realisability table (<= {MAX_TABLE_VALUES} "
            f"values) or an AbstractPlatform product rule. Use "
            f"engine='numpy' for this platform.")
    val_max = int(vals[-1])
    lut = np.full(val_max + 2, -1, np.int64)
    lut[vals] = np.arange(nv)
    return table, lut, val_max + 1


def _pad1(a: np.ndarray, n_pad: int, fill) -> np.ndarray:
    """Pad a per-node (or per-edge) 1-D array to ``n_pad`` with ``fill``."""
    if len(a) >= n_pad:
        return a
    out = np.full(n_pad, fill, a.dtype)
    out[:len(a)] = a
    return out


def _mask(index_set, n: int, n_pad: int) -> np.ndarray:
    m = np.zeros(n_pad, bool)
    m[np.asarray(index_set, np.int64)] = True
    return m


@_trace.traced("accel.build_static_spec")
def build_static_spec(bev, *, use_kernel: bool = True,
                      pad_nodes: Optional[int] = None) -> StaticSpec:
    """Pure-host construction of the program-shaping spec."""
    n = bev.n_nodes
    np_ = n if pad_nodes is None else int(pad_nodes)
    if np_ < n:
        raise ValueError(f"pad_nodes={np_} < graph node count {n}")
    opts = bev.opts
    return StaticSpec(
        n_nodes=np_,
        mode=bev.mode,
        exec_model=bev.exec_model,
        strict_kv=bev.strict_kv,
        intra_matching=bev.intra_matching,
        inter_matching=bev.inter_matching,
        scan_tying=bev.scan_tying,
        zero1=opts.zero1,
        seq_parallel_stash=opts.seq_parallel_stash,
        grad_compression=opts.grad_compression,
        mxu_efficiency=opts.mxu_efficiency,
        overlap_collectives=opts.overlap_collectives,
        use_kernel=use_kernel,
    )


#: BatchedEvaluator arrays covered by ``problem_fingerprint``, in
#: ``DeviceArrays`` field order — exactly the per-node/per-edge content
#: ``lower_program`` ships to the device. Extending ``DeviceArrays`` with
#: a new lowered array means extending this tuple too (the fingerprint
#: must keep covering everything that shapes engine results).
FINGERPRINT_ARRAYS: Tuple[str, ...] = (
    "flops", "weight_bytes", "act_bytes", "inner_bytes", "state_bytes",
    "kv_bytes", "carry_bytes", "node_d", "reshard_full", "batch", "rows",
    "cols", "fm_width", "col_div", "kv_limit", "ep_topk", "scan_group",
    "internal", "elementwise", "weight_stream", "cut_allowed",
)

#: kind index sets covered by ``problem_fingerprint`` (the
#: ``DeviceArrays.m_*`` mask sources).
FINGERPRINT_INDEX_SETS: Tuple[str, ...] = (
    "i_attn", "i_head", "i_tp", "i_ep", "i_vocab", "i_vhead", "i_kv",
    "i_carry",
)


@_trace.traced("accel.problem_fingerprint")
def problem_fingerprint(problem) -> str:
    """Canonical content hash of a Problem's lowered program (no jax).

    Routes through ``build_static_spec`` — the same keying path that
    shapes the XLA executable cache and that ``recompile_lint`` audits —
    and then hashes every array ``lower_program`` would ship to the
    device: the per-node workload quantities, kind index sets, scan
    pairs, platform scalar vector, fold-realisability cube/lut, plus the
    Eq. 5 objective flag and Eq. 4 amortisation factor. Two problems
    with equal fingerprints lower to bit-identical device programs (at
    any shared padding — padding is excluded on purpose: it is
    bit-neutral by the lowering contract, so it cannot change results),
    and therefore every deterministic engine returns identical designs,
    objectives and histories for them. This is the keying contract the
    service cache (``repro/service/cache.py``) and the
    ``optimise_portfolio`` duplicate-coalescing fix rely on
    (docs/service.md documents it).

    Accepts a ``Problem`` (lowers via its cached ``batched()``) or a
    ``BatchedEvaluator`` directly. Pure host, jax-free.
    """
    bev = problem.batched() if hasattr(problem, "batched") else problem
    # the engine knob (use_kernel) changes the kernel route, not the
    # computed design — pin it so the fingerprint is a problem identity,
    # not an engine configuration
    static = build_static_spec(bev, use_kernel=False)
    h = hashlib.sha256(b"repro.problem_fingerprint.v1")
    h.update(repr(dataclasses.astuple(static)).encode())

    def feed(name: str, a: np.ndarray) -> None:
        a = np.ascontiguousarray(a)
        h.update(f"|{name}:{a.dtype.str}:{a.shape}|".encode())
        h.update(a.tobytes())

    for name in FINGERPRINT_ARRAYS:
        feed(name, np.asarray(getattr(bev, name)))
    for name in FINGERPRINT_INDEX_SETS:
        feed(name, np.asarray(sorted(getattr(bev, name)), np.int64))
    feed("scan_pairs", np.asarray(bev.scan_pairs, np.int64))
    feed("platform_scalars", np.asarray(bev.platform_scalars(),
                                        np.float64))
    try:
        table, lut, cap = _realizability_table(bev)
        feed("real_table", table.astype(np.uint8))
        feed("val_lut", np.asarray(lut, np.int64))
        h.update(f"|cap:{int(cap)}|".encode())
    except EngineUnavailable:
        # menus too large for a dense cube (numpy-engine-only platforms):
        # the fold menu plus the platform name pins the candidate space —
        # a false MISS is possible across renamed-but-identical platforms,
        # a false HIT is not
        feed("fold_values", np.asarray(bev.platform.fold_values(),
                                       np.int64))
        h.update(f"|platform:{bev.platform.name}|".encode())
    h.update(f"|objective:{bev.objective}"
             f"|amort:{float(bev.batch_amortisation)!r}|".encode())
    return h.hexdigest()


def _tensor(a, *, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """numpy (or Python scalar) -> tensor on ``device``: float kinds take
    ``dtype``, integer kinds int64, bools bool."""
    a = np.asarray(a)
    if a.dtype.kind == "b":
        t = torch.from_numpy(np.array(a, bool))
    elif a.dtype.kind in "iu":
        t = torch.from_numpy(np.array(a, np.int64))
    elif a.dtype.kind == "f":
        t = torch.from_numpy(np.array(a, np.float64)).to(dtype)
    else:
        raise TypeError(f"cannot lower an array of dtype {a.dtype}")
    return t.to(device)


@_trace.traced("accel.lower_program")
def lower_program(bev, *, device=None, dtype: Optional[torch.dtype] = None,
                  use_kernel: bool = True,
                  pad_nodes: Optional[int] = None,
                  pad_pairs: Optional[int] = None,
                  pad_vals: Optional[int] = None,
                  pad_lut: Optional[int] = None
                  ) -> Tuple[StaticSpec, DeviceTensors]:
    """Lower a host ``BatchedEvaluator`` onto ``device`` (default: the
    card). ``dtype`` is the float width (float32 unless float64 is asked
    for). The pad arguments follow the JAX lowering exactly: padded nodes
    are neutral, padded realisability slots are False and padded lut
    entries -1 ("unknown value", already infeasible)."""
    device = resolve_device(device)
    fdt = resolve_dtype(dtype)

    table, lut, cap = _realizability_table(bev)
    nv = table.shape[0]
    pv = nv if pad_vals is None else int(pad_vals)
    if pv < nv:
        raise ValueError(f"pad_vals={pv} < fold menu size {nv}")
    if pv > nv:
        t2 = np.zeros((pv, pv, pv), bool)
        t2[:nv, :nv, :nv] = table
        table = t2
    pl = len(lut) if pad_lut is None else int(pad_lut)
    if pl < len(lut):
        raise ValueError(f"pad_lut={pl} < lut length {len(lut)}")
    lut = _pad1(lut, pl, -1)

    static = build_static_spec(bev, use_kernel=use_kernel,
                               pad_nodes=pad_nodes)
    n = bev.n_nodes
    np_ = static.n_nodes
    pf, hbw, hby, ibw, dbw, rfs, chips = bev.platform_scalars()

    # scan-tying pairs padded with (0, 0): a self-pair can never "differ"
    pairs = bev.scan_pairs
    pp = max(pairs.shape[0], 1) if pad_pairs is None else int(pad_pairs)
    if pp < pairs.shape[0]:
        raise ValueError(f"pad_pairs={pp} < pair count {pairs.shape[0]}")
    pair_a = np.zeros(pp, np.int64)
    pair_b = np.zeros(pp, np.int64)
    pair_a[:pairs.shape[0]] = pairs[:, 0]
    pair_b[:pairs.shape[0]] = pairs[:, 1]

    node_valid = np.zeros(np_, bool)
    node_valid[:n] = True

    T = lambda a: _tensor(a, device=device, dtype=fdt)
    ef = lambda a, fill: T(_pad1(np.asarray(a, np.float64), np_, fill))
    ei = lambda a, fill: T(_pad1(np.asarray(a, np.int64), np_, fill))
    eb = lambda a: T(_pad1(np.asarray(a, bool), np_, False))
    km = lambda ix: T(_mask(ix, n, np_))
    sf = lambda x: T(np.float64(x))

    tensors = DeviceTensors(
        flops=ef(bev.flops, 0.0),
        weight_bytes=ef(bev.weight_bytes, 0.0),
        act_bytes=ef(bev.act_bytes, 0.0),
        inner_bytes=ef(bev.inner_bytes, 0.0),
        state_bytes=ef(bev.state_bytes, 0.0),
        kv_bytes=ef(bev.kv_bytes, 0.0),
        carry_bytes=ef(bev.carry_bytes, 0.0),
        node_d=ef(bev.node_d, 0.0),
        reshard_full=ef(bev.reshard_full, 0.0),
        batch=ei(bev.batch, 1),
        rows=ei(bev.rows, 1),
        cols=ei(bev.cols, 1),
        fm_width=ei(bev.fm_width, 0),
        col_div=ei(bev.col_div, 1),
        kv_limit=ei(bev.kv_limit, 0),
        ep_topk=ei(bev.ep_topk, 0),
        scan_group=ei(bev.scan_group, -1),
        internal=eb(bev.internal),
        elementwise=eb(bev.elementwise),
        weight_stream=eb(bev.weight_stream),
        cut_allowed=T(_pad1(np.asarray(bev.cut_allowed, bool),
                            max(np_ - 1, 0), False)),
        real_table=T(table),
        val_lut=T(np.asarray(lut, np.int64)),
        val_cap=T(np.int64(cap)),
        peak_flops=sf(pf),
        hbm_bw=sf(hbw),
        hbm_bytes=sf(hby),
        ici_bw=sf(ibw),
        dma_bw=sf(dbw),
        reconf_fixed_s=sf(rfs),
        chips=sf(chips),
        obj_latency=T(np.bool_(bev.objective == "latency")),
        batch_amortisation=sf(float(bev.batch_amortisation)),
        m_attn=km(bev.i_attn),
        m_head=km(bev.i_head),
        m_tp=km(bev.i_tp),
        m_ep=km(bev.i_ep),
        m_vocab=km(bev.i_vocab),
        m_vhead=km(bev.i_vhead),
        m_kv=km(bev.i_kv),
        m_carry=km(bev.i_carry),
        pair_a=T(pair_a),
        pair_b=T(pair_b),
        node_valid=T(node_valid),
        n_valid=T(np.int64(n)),
    )
    return static, tensors


def tensors_from_numpy(fields: Mapping[str, np.ndarray], *, device=None,
                       dtype: Optional[torch.dtype] = None) -> DeviceTensors:
    """Build ``DeviceTensors`` from numpy arrays keyed by field name — the
    JAX package's ``DeviceArrays`` passed as numpy. Floats take ``dtype``
    (float32 unless asked), integers int64, bools bool. Raises
    ``ValueError`` on a missing or unknown field."""
    device = resolve_device(device)
    fdt = resolve_dtype(dtype)
    want = set(DeviceTensors._fields)
    missing = sorted(want - set(fields))
    unknown = sorted(set(fields) - want)
    if missing or unknown:
        raise ValueError(f"DeviceTensors fields: missing {missing}, "
                         f"unknown {unknown}")
    return DeviceTensors(**{k: _tensor(fields[k], device=device, dtype=fdt)
                            for k in DeviceTensors._fields})


def lift_tensors(A: DeviceTensors) -> DeviceTensors:
    """One problem's tensors with a lane axis of 1 (views, no copy)."""
    return DeviceTensors(*(x[None] for x in A))


def stack_tensors(arrays) -> DeviceTensors:
    """Equally shaped (padded) problems' tensors stacked on a new leading
    lane axis, field by field."""
    return DeviceTensors(*(torch.stack(xs) for xs in zip(*arrays)))


__all__ = ["StaticSpec", "DeviceTensors", "build_static_spec",
           "lower_program", "tensors_from_numpy", "lift_tensors",
           "stack_tensors", "problem_fingerprint", "FINGERPRINT_ARRAYS",
           "FINGERPRINT_INDEX_SETS", "MAX_TABLE_VALUES"]
