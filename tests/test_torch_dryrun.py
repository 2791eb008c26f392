"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

JAX's module asks for 512 fake devices when it is imported, which fails
once jax has started, so it runs in a subprocess of its own; the port's
cells run in another (its fake process group is one a process). Both run
at once. Held equal: ``all_cell_names``, ``_period``, ``platform_for``,
``roofline_terms`` (given JAX's TPU peaks), ``_partition_signature`` and
``optimise_cell``'s plan, ``samo`` block and partition count on reduced
archs. Reduced tinyllama-1.1b at ``train_4k`` on the 16 x 16 mesh goes
through each package's ``dryrun_cell`` (the registry's ``get_arch``
patched to return the reduced arch in each subprocess, and JAX's mesh
built with Auto axes: with jax 0.9's default Explicit axes JAX's own dry
run fails at its first sharding constraint, ROADMAP Queue 3): the same
keys and partitions, per-device FLOPs within 15 % of XLA's
``cost_analysis`` (XLA also counts element-wise work; the port counts
products), and JAX's collective kinds among the port's. Reduced
granite-moe-1b-a400m at ``train_4k`` and tinyllama-1.1b at ``decode_32k``
go through both too (JAX's without its cost probes): the same keys,
partitions and argument bytes, and a peak not above 1.5 times XLA's
memory analysis. Each cell's per-device products (matmuls) are also
counted from the HLO of JAX's unrolled program: the port's FLOPs equal
them on the dense train and decode cells (the decode splits the cache's
keys in both), and on the MoE cell both programs run the expert products
over the global capacity (the whole batch's tokens dispatched on every
device), where XLA splits their backward over the devices and the port
does not. The rwkv, ssm and encoder-decoder kinds record a
``NotImplementedError`` naming ROADMAP item 15."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

try:                                   # the card's machine has no jax
    import jax  # noqa: F401
except ImportError:                    # pragma: no cover - jax-free machine
    jax = None

from _torch_support import port_obs_reset  # noqa: F401
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.moe import capacity

REPO = Path(__file__).resolve().parents[1]
#: (arch, shape) cells planned on both sides, reduced
PLAN_CASES = (("tinyllama-1.1b", "train_4k"),
              ("granite-moe-1b-a400m", "decode_32k"),
              ("kimi-k2-1t-a32b", "prefill_32k"))
UNPORTED = ("rwkv6-1.6b", "jamba-1.5-large-398b", "whisper-small")
#: the reduced cell both dry runs count
CELL = ("tinyllama-1.1b", "train_4k")
FLOP_TOL = 0.15
#: more reduced cells both dry runs count: an MoE train step and a decode
MORE_CELLS = (("granite-moe-1b-a400m", "train_4k"),
              ("tinyllama-1.1b", "decode_32k"))
#: the cells whose products the port holds equal to XLA's
PRODUCT_CELLS = (CELL, ("tinyllama-1.1b", "decode_32k"))
#: the port's FLOPs against the products in XLA's HLO (measured equal to
#: five digits: both count 2 x the output's size x the contracted extent)
PRODUCT_TOL = 0.02
#: the port's peak over XLA's memory analysis, at most (measured 0.79,
#: 1.41 and 0.22 on the three cells: eager buffers against XLA's buffer
#: assignment; the port's MoE keeps the backward XLA splits)
PEAK_RATIO = 1.5
#: a fixed aggregate for the roofline terms
AGG = {"flops": 1.5e14, "bytes": 3.0e11, "collective_bytes": 2.0e9,
       "peak_memory_gib": 3.0}

_JAX_SIDE = r"""
import json, math, re, sys
from repro.launch import dryrun as D
import jax
from jax.sharding import AxisType
from repro.configs import get_arch, SHAPES_BY_NAME
from repro.configs.base import reduced
from repro.launch.mesh import make_production_mesh

req = json.loads(sys.argv[1])
out = {"cells": [list(c) for c in D.all_cell_names()],
       "periods": {n: D._period(get_arch(n)) for n in req["archs"]},
       "platforms": [], "roofline": {}, "plans": {}}
for mp in (False, True):
    p = D.platform_for(make_production_mesh(multi_pod=mp))
    out["platforms"].append([p.name, [list(a) for a in p.mesh_axes]])
for name, sname in out["cells"]:
    out["roofline"][name + "/" + sname] = D.roofline_terms(
        req["agg"], 256, SHAPES_BY_NAME[sname], get_arch(name))
out["peaks"] = [D.PEAK_FLOPS, D.HBM_BW, D.ICI_BW]
mesh = make_production_mesh()
for name, sname in req["plans"]:
    arch = reduced(get_arch(name))
    plan, _, res = D.optimise_cell(arch, SHAPES_BY_NAME[sname],
                                   D.platform_for(mesh))
    out["plans"][name + "/" + sname] = {
        "parts": [[p.layer_start, p.layer_end, p.has_embed, p.has_head,
                   p.has_final_norm, p.enc_start, p.enc_end,
                   list(p.node_indices),
                   {k: [kp.s_in, kp.s_out, kp.kern, list(kp.rows_axes),
                        list(kp.cols_axes), list(kp.batch_axes)]
                    for k, kp in sorted(p.kinds.items())}]
                  for p in plan.partitions],
        "signatures": [repr(D._partition_signature(plan, arch, i))
                       for i in range(len(plan.partitions))],
        "samo": [res.evaluation.objective, res.evaluation.latency,
                 res.evaluation.throughput, res.evaluation.feasible,
                 res.evaluation.reconf_time, res.points]}
real = D.get_arch
D.get_arch = lambda n: reduced(real(n))
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rec = D.dryrun_cell(*req["cell"], verbose=False)
for c in rec["cells"]:
    c.pop("traceback", None)
out["record"] = rec
out["more"] = {}
for name, sname in req["more"]:
    rec = D.dryrun_cell(name, sname, verbose=False, cost_probes=False)
    for c in rec["cells"]:
        c.pop("traceback", None)
    out["more"][name + "/" + sname] = rec

# the products (dots) of each cell's unrolled per-device program: FLOPs
# (2 x the output's size x the contracted extent) and the output shapes
DEF = re.compile(r"^\s*(?:ROOT )?%(\S+) = \w+\[([\d,]*)\]")
DOT = re.compile(r"^\s*(?:ROOT )?%\S+ = \w+\[([\d,]*)\]\S* "
                 r"dot\(%([^,\s]+), .*lhs_contracting_dims=\{([\d,]*)\}")
dims = lambda t: [int(x) for x in t.split(",") if x]
out["products"] = {}
mesh = D.make_production_mesh()
for name, sname in [req["cell"]] + req["more"]:
    arch, shape = reduced(real(name)), SHAPES_BY_NAME[sname]
    plan, _, _ = D.optimise_cell(arch, shape, D.platform_for(mesh))
    text = D._lower_one(arch, shape, plan, mesh, 0, zero1=True,
                        use_flash=False, unroll=True, layer_range=None,
                        include_embed=True, include_head=True).as_text()
    lines = text.splitlines()
    shapes = {m.group(1): dims(m.group(2)) for m in map(DEF.match, lines)
              if m}
    flops, outs = 0.0, []
    for m in filter(None, map(DOT.match, lines)):
        lhs = shapes[m.group(2)]
        flops += 2.0 * math.prod(dims(m.group(1))) * math.prod(
            lhs[d] for d in dims(m.group(3)))
        outs.append(dims(m.group(1)))
    out["products"][name + "/" + sname] = {
        "flops": flops, "parts": len(plan.partitions), "shapes": outs}
print(json.dumps(out))
"""

_PORT_SIDE = r"""
import json, logging, sys
from repro_torch.launch import dryrun as D
from repro_torch.configs import reduced
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
req = json.loads(sys.argv[1])
real = D.get_arch
D.get_arch = lambda n: reduced(real(n))
# the shapes of the products (the ops the counter gives FLOPs) of each cell
shapes = []
counted = D.Counter.__torch_dispatch__
def dispatch(self, func, types, args=(), kwargs=None):
    before = self.flops
    out = counted(self, func, types, args, kwargs)
    if out is not NotImplemented and self.flops > before:
        shapes.append([list(t.shape) for t in D._flat(args)
                       if hasattr(t, "shape")])
    return out
D.Counter.__torch_dispatch__ = dispatch
out = {"record": D.dryrun_cell(*req["cell"], verbose=False, device="cpu"),
       "unported": {}, "more": {}, "shapes": {}}
out["shapes"]["/".join(req["cell"])] = shapes[:]
for name, sname in req["more"]:
    del shapes[:]
    out["more"][name + "/" + sname] = D.dryrun_cell(
        name, sname, verbose=False, device="cpu")
    out["shapes"][name + "/" + sname] = shapes[:]
for name in req["unported"]:
    rec = D.dryrun_cell(name, "train_4k", verbose=False, device="cpu")
    out["unported"][name] = [c.get("error") for c in rec["cells"]]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(filter(None, [
                    str(REPO / "src"), os.environ.get("PYTHONPATH")])))


def _run(script, req):
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(req)],
                            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def both():
    """(JAX's side, the port's side), each from its own subprocess, run
    at once."""
    if jax is None:
        pytest.skip("needs jax, the reference (CPU tests)")
    procs = [_run(_JAX_SIDE, {"archs": sorted(ARCHS), "agg": AGG,
                              "plans": PLAN_CASES, "cell": CELL,
                              "more": MORE_CELLS}),
             _run(_PORT_SIDE, {"cell": CELL, "unported": UNPORTED,
                               "more": MORE_CELLS})]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.splitlines()[-1]))
    return tuple(outs)


def test_pure_parts_equal_jax(both):
    """``all_cell_names``, ``_period`` and ``platform_for`` equal JAX's;
    ``roofline_terms`` given JAX's TPU peaks equals JAX's for every cell,
    and by default it uses the H100's."""
    ref = both[0]
    assert [list(c) for c in dryrun.all_cell_names()] == ref["cells"]
    assert {n: dryrun._period(get_arch(n)) for n in ARCHS} == ref["periods"]
    got = [dryrun.platform_for(make_production_mesh(multi_pod=mp))
           for mp in (False, True)]
    assert [[p.name, [list(a) for a in p.mesh_axes]] for p in got] == \
        ref["platforms"]
    peak, hbm, link = ref["peaks"]
    for name, sname in dryrun.all_cell_names():
        terms = dryrun.roofline_terms(AGG, 256, SHAPES_BY_NAME[sname],
                                      get_arch(name), peak_flops=peak,
                                      hbm_bw=hbm, link_bw=link)
        assert terms == ref["roofline"][f"{name}/{sname}"], (name, sname)
    h100 = dryrun.roofline_terms(AGG, 256, SHAPES_BY_NAME["train_4k"],
                                 get_arch("tinyllama-1.1b"))
    assert h100["compute_s"] == AGG["flops"] / 989.4e12
    assert h100["memory_s"] == AGG["bytes"] / 3.35e12


@pytest.mark.parametrize("name,sname", PLAN_CASES)
def test_optimise_cell_equals_jax(both, name, sname):
    """The plan (partitions, their layers and kind plans), the partition
    signatures and the ``samo`` block of reduced archs on the 16 x 16
    platform equal JAX's (objective, latency and throughput at 1e-5: the
    port's engine runs float32)."""
    ref = both[0]["plans"][f"{name}/{sname}"]
    arch = reduced(get_arch(name))
    plan, _, res = dryrun.optimise_cell(
        arch, SHAPES_BY_NAME[sname],
        dryrun.platform_for(make_production_mesh()), device="cpu")
    parts = [[p.layer_start, p.layer_end, p.has_embed, p.has_head,
              p.has_final_norm, p.enc_start, p.enc_end, list(p.node_indices),
              {k: [kp.s_in, kp.s_out, kp.kern, list(kp.rows_axes),
                   list(kp.cols_axes), list(kp.batch_axes)]
               for k, kp in sorted(p.kinds.items())}]
             for p in plan.partitions]
    assert parts == ref["parts"]
    assert [repr(dryrun._partition_signature(plan, arch, i))
            for i in range(len(plan.partitions))] == ref["signatures"]
    ev = res.evaluation
    got = [ev.objective, ev.latency, ev.throughput]
    for a, b in zip(got, ref["samo"][:3]):
        assert a == pytest.approx(b, rel=1e-5)
    assert [ev.feasible, res.points] == [ref["samo"][3], ref["samo"][5]]
    assert ev.reconf_time == pytest.approx(ref["samo"][4], rel=1e-5,
                                           abs=1e-12)


def test_record_has_jax_keys_and_partitions(both):
    """Reduced tinyllama-1.1b at train_4k: the port's record carries every
    key of JAX's (top level, ``samo``, ``aggregate``, ``roofline``, each
    partition's), the same partitions, and no partition error."""
    ref, got = both[0]["record"], both[1]["record"]
    _same_record_shape(got, ref)
    assert all(a["cost_method"] == "counted" for a in got["cells"])
    assert got["mesh"] == ref["mesh"] and got["chips"] == ref["chips"]


def test_counts_match_xla(both):
    """Per-device FLOPs within 15 % of XLA's ``cost_analysis`` (which also
    counts element-wise work: the measured ratio is in PERF.md), every
    collective kind JAX's program has among the port's, and the argument
    bytes (parameters, optimiser state, batch on one device) equal."""
    ref, got = both[0]["record"], both[1]["record"]
    for a, b in zip(got["cells"], ref["cells"]):
        if "same_as" in b:
            continue
        ratio = a["flops"] / b["flops"]
        assert abs(ratio - 1) <= FLOP_TOL, ratio
        assert set(b["collectives"]) <= set(a["collectives"])
        assert a["memory"]["arguments_gib"] == \
            pytest.approx(b["memory"]["arguments_gib"], rel=1e-6)
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]


def _same_record_shape(got, ref):
    """JAX's keys (top level, ``samo``, ``aggregate``, ``roofline``, each
    partition's) among the port's, the same partitions, no error."""
    assert set(ref) <= set(got)
    for key in ("samo", "aggregate", "roofline"):
        assert set(ref[key]) <= set(got[key]), key
    assert got["partitions"] == ref["partitions"]
    assert [c.get("same_as") for c in got["cells"]] == \
        [c.get("same_as") for c in ref["cells"]]
    for a, b in zip(got["cells"], ref["cells"]):
        assert "error" not in a and "error" not in b
        assert set(b) <= set(a), set(b) - set(a)
        assert set(b["memory"]) == set(a["memory"])


@pytest.mark.parametrize("name,sname", MORE_CELLS)
def test_more_cells_against_xla(both, name, sname):
    """Reduced granite-moe-1b-a400m at train_4k and tinyllama-1.1b at
    decode_32k: the port's record has JAX's keys and partitions, its
    argument bytes (parameters, optimiser state or cache, batch on one
    device) equal XLA's, and its peak is at most ``PEAK_RATIO`` times the
    peak of XLA's memory analysis (temp + arguments + outputs - aliases)."""
    key = f"{name}/{sname}"
    ref, got = both[0]["more"][key], both[1]["more"][key]
    _same_record_shape(got, ref)
    for a, b in zip(got["cells"], ref["cells"]):
        if "same_as" in b:
            continue
        assert a["memory"]["arguments_gib"] == \
            pytest.approx(b["memory"]["arguments_gib"], rel=1e-6)
        assert a["peak_memory_gib"] <= PEAK_RATIO * b["peak_memory_gib"], \
            (a["peak_memory_gib"], b["peak_memory_gib"])


def _port_flops(both, key):
    rec = both[1]["record"] if key == "/".join(CELL) else both[1]["more"][key]
    assert rec["partitions"] == 1
    return rec["cells"][0]["flops"]


@pytest.mark.parametrize("name,sname", PRODUCT_CELLS)
def test_products_match_xla(both, name, sname):
    """The port's per-device FLOPs (``torch.utils.flop_counter``: the
    products) equal the products in the HLO of JAX's unrolled per-device
    program, within ``PRODUCT_TOL``: the dense train step, and the decode
    step, whose attention both programs split over the cache's sharded
    length (a rank attends its own keys; the shards combined by their
    log-sum-exps)."""
    key = f"{name}/{sname}"
    ref = both[0]["products"][key]
    assert ref["parts"] == 1
    got = _port_flops(both, key)
    assert got == pytest.approx(ref["flops"], rel=PRODUCT_TOL), \
        (got, ref["flops"])


def test_moe_dispatch_is_global_in_both(both):
    """Reduced granite-moe-1b-a400m at train_4k on the 16 x 16 mesh: JAX's
    per-device program and the port's both run expert products over the
    global capacity (E, capacity(B x S), ...), the whole batch's tokens
    dispatched on every device; the port's products are no fewer than
    XLA's, which computes the same forward but splits the backward's
    products over the devices."""
    key = "granite-moe-1b-a400m/train_4k"
    arch, shape = reduced(get_arch("granite-moe-1b-a400m")), \
        SHAPES_BY_NAME["train_4k"]
    E = arch.num_experts
    cap = capacity(shape.global_batch * shape.seq_len,
                   arch.experts_per_token, E)
    ref = both[0]["products"][key]
    assert any(s[:2] == [E, cap] for s in ref["shapes"]), ref["shapes"]
    assert any(s[:2] == [E, cap] for op in both[1]["shapes"][key]
               for s in op), "no product over the global capacity"
    assert _port_flops(both, key) >= ref["flops"]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_kinds_record_their_item(both, name):
    """rwkv6-1.6b, jamba-1.5-large-398b and whisper-small: every counted
    partition records a ``NotImplementedError`` naming ROADMAP item 15."""
    errors = [e for e in both[1]["unported"][name] if e is not None]
    assert errors
    for e in errors:
        assert e.startswith("NotImplementedError") and "item 15" in e, e
