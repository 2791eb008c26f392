#!/usr/bin/env python3
"""Time variants of the bf16 WKV6 kernel beside the committed one, on one
CUDA card.

    python3 tools/wkv6_variants.py [--diagnose]

Each variant is ``src/repro_torch/csrc/wkv6.cu`` with a few lines replaced
(``VARIANTS``), written to ``build/wkv6_variants/`` and built through the
port's cached loader (all builds started together; an unchanged variant is
reused). One of them is the step-by-step kernel, the design the chunked
kernel replaced, from its own source (``tools/wkv6_step_design.cu``). Each
is held to the plain version (``ref.rwkv6``) within one bfloat16 rounding
step plus ``2e-6 max|want|`` (as ``chip_smoke.py`` holds the kernel) at the
LM's shape (2, 4096, 32, 64), under strong decay, with a third of the
decays near 1e-30 and under the model's own decay (a long memory, where the
operand precision shows), then timed at the LM shape with CUDA events, in
turns: every variant in order, then in reverse, on the same inputs.
``--diagnose`` adds variants that skip part of the work (they do not
compute the function; they are timed, never held) to show where the
committed kernel's time goes. Prints one line per variant with ptxas's
registers and spills, and writes ``chiprun_out/wkv6_variants.json``.
Imports nothing of JAX.

The step kernel's source is ``tools/wkv6_step_design.cu``, which
``chip_smoke.py`` also builds to time the old design beside the new one.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "wkv6.cu"
OUT = ROOT / "build" / "wkv6_variants"

_A_SUMS = '''          switch (sp) {
            case 0: a_sums_pair<HS, 0>(sr, sk, sw, pt, u_own, lane); break;
            case 1: a_sums_pair<HS, 1>(sr, sk, sw, pt, u_own, lane); break;
            case 2: a_sums_pair<HS, 2>(sr, sk, sw, pt, u_own, lane); break;
            case 3: a_sums_pair<HS, 3>(sr, sk, sw, pt, u_own, lane); break;
            case 4: a_sums_pair<HS, 4>(sr, sk, sw, pt, u_own, lane); break;
            case 5: a_sums_pair<HS, 5>(sr, sk, sw, pt, u_own, lane); break;
            case 6: a_sums_pair<HS, 6>(sr, sk, sw, pt, u_own, lane); break;
            default: a_sums_pair<HS, 7>(sr, sk, sw, pt, u_own, lane); break;
          }
'''
_ORDER_2 = '''        mma_bf16(acc[2], sa[0], bl[0], bl[1]);
        mma_bf16(acc[2], sa[1], bhm[2], bhm[3]);
        mma_bf16(acc[2], sa[2], bhm[0], bhm[1]);'''
_ORDER_1 = '''        mma_bf16(acc[1], sa[0], bhm[2], bhm[3]);
        mma_bf16(acc[1], sa[1], bhm[0], bhm[1]);'''
_MMA = '''  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_NO_MMA = '''  d[0] += __uint_as_float(a[0] & b0 & 1u);'''

#: the step-by-step kernel for bfloat16 (the yardstick), built from its own
#: self-contained source rather than by edits of the committed one
STEP_KERNEL = "step kernel"
STEP_SOURCE = ROOT / "tools" / "wkv6_step_design.cu"

#: name -> (old, new) replacements in the committed source
VARIANTS = {
    "committed": [],
    STEP_KERNEL: [],
    "32 columns a block (2 blocks a head)": [
        ("static constexpr int J = HS == 128 ? 32 : HS;",
         "static constexpr int J = 32;")],
    "inputs 1 chunk ahead": [("constexpr int kAhead = 2;",
                              "constexpr int kAhead = 1;")],
    "S (r P)^T to piece order 1 (hi hi, hi mid, mid hi)": [(_ORDER_2, "")],
    "S and r P as one bf16 each": [(_ORDER_2, ""), (_ORDER_1, "")],
}

#: spans cut out by the diagnostics below, (from, up to): the consumers'
#: products and outputs, the producers' A sums, r P / k Q walks and reduction
_CONSUMER_PRODUCTS = ("    const bf16* rd = op_rd(o);",
                      "    if (n + 2 < nchunks) bar_arrive")
_CONSUMER_OUTPUTS = ("    put_state(1 - o);",
                     "  }\n}\n\ntemplate <int HS>\nint launch_chunk")
_PRODUCER_SUMS = ("      if (n < nchunks) {  // A(i, s)",
                  "      if (n == 0) continue;")
_PRODUCER_WALKS = ("      // r_i P_i forward (and P_16)",
                   "      // v of this block's columns")
_PRODUCER_REDUCTION = (
    "      // A(i, s): the 32 lanes' partial sums of each pair",
    "      bar_arrive(kBarFull + o, kAll);")

#: --diagnose: variants that skip work (not the function; timed, not held).
#: A ("cut", from, up to) entry removes that span of the source.
DIAGNOSTIC = {
    "no A sums (diagnostic)": [(_A_SUMS, "")],
    "no tensor-core products (diagnostic)": [(_MMA, _NO_MMA)],
    "neither (diagnostic)": [(_A_SUMS, ""), (_MMA, _NO_MMA)],
    "producers alone (diagnostic)": [("cut", *_CONSUMER_PRODUCTS),
                                     ("cut", *_CONSUMER_OUTPUTS)],
    "consumers alone (diagnostic)": [("cut", *_PRODUCER_SUMS),
                                     ("cut", *_PRODUCER_WALKS),
                                     ("cut", *_PRODUCER_REDUCTION)],
}


def source(name: str) -> str:
    """The committed source with ``name``'s replacements and cuts (the step
    kernel: its own source)."""
    if name == STEP_KERNEL:
        return STEP_SOURCE.read_text()
    src = SOURCE.read_text()
    for edit in {**VARIANTS, **DIAGNOSTIC}[name]:
        if edit[0] == "cut":
            _, start, end = edit
            i = src.find(start)
            j = src.find(end, i)
            if i < 0 or j < 0:
                raise SystemExit(f"variant {name!r}: span {start[:40]!r}... "
                                 f"is not in {SOURCE.name}")
            src = src[:i] + src[j:]
            continue
        old, new = edit
        if old not in src:
            raise SystemExit(f"variant {name!r}: {old[:60]!r}... is not in "
                             f"{SOURCE.name}")
        src = src.replace(old, new)
    return src


def build(text: str, stem: str):
    """``text`` written to ``OUT/<stem>.cu`` and built through the port's
    cached loader (its nvcc flags); the loaded library and ptxas's
    report."""
    from repro_torch.core.accel import cuda_build
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{stem}.cu"
    cu.write_text(text)
    name = f"wkv6_variant_{stem}"
    lib = cuda_build.load(name, cu)
    return lib, cuda_build.BUILD_INFO[name]["ptxas"]


def ptxas_by_head_size(report: str, kernel: str):
    """{hs: {"registers": n, "spill_stores": bytes}} for ``kernel``'s
    instantiations in a ptxas report."""
    rows, function = {}, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            function = line.rsplit(" ", 1)[-1]
        hit = re.search(rf"{kernel}ILi(\d+)E", function)
        if not hit:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            rows.setdefault(hit.group(1), {})["spill_stores"] = \
                int(spill.group(1))
        if regs:
            rows.setdefault(hit.group(1), {})["registers"] = \
                int(regs.group(1))
    return rows


def entry(lib):
    """The library's typed ``wkv6_bf16``."""
    fn = lib.wkv6_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, r, k, v, w, u):
    import torch
    B, T, H, hs = r.shape
    out = torch.empty_like(r)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), out.data_ptr(), B, T, H, hs,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def _build(i: int, name: str):
    lib, report = build(source(name), f"v{i}")
    kernel = "wkv6_kernel" if name == STEP_KERNEL else "wkv6_chunk_kernel"
    return entry(lib), ptxas_by_head_size(report, kernel)


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke  # shapes, inputs, limits, timing
    from repro_torch.kernels import rwkv6_scan
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    names = list(VARIANTS)
    if "--diagnose" in sys.argv[1:]:
        names += list(DIAGNOSTIC)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(_build, range(len(names)), names))
    checks = ((chip_smoke.WKV_LM_SHAPE, (0.55, 0.95)),
              ((1, 256, 2, 64), (0.02, 0.1)), ((1, 4097, 2, 64), "tiny"),
              ((1, 4096, 8, 64), "model"))
    rows = {n: {"ptxas": ptx, "limit_used": {}, "ms": []}
            for n, (_, ptx) in zip(names, built)}
    for i, (shape, w_range) in enumerate(checks):
        args = chip_smoke._wkv_inputs(shape, w_range, torch.bfloat16,
                                      seed=500 + i)
        want = rwkv6_scan.wkv6_plain(*args)
        for name, (fn, _) in zip(names, built):
            got = call(fn, *args)
            used = chip_smoke._wkv_limit_used(got, want)
            if not bool(torch.isfinite(got.float()).all()):
                used = float("inf")
            rows[name]["limit_used"][f"{shape} w {w_range}"] = used
    held = [n for n in names if n in DIAGNOSTIC or
            max(rows[n]["limit_used"].values()) <= 1.0]
    args = chip_smoke._wkv_inputs(chip_smoke.WKV_LM_SHAPE, (0.55, 0.95),
                                  torch.bfloat16, seed=600)
    for order in (held, held[::-1]):       # a variant that fails: no time
        for name in order:
            fn = built[names.index(name)][0]
            rows[name]["ms"].append(chip_smoke.cuda_ms(
                lambda: call(fn, *args), 20, warmup=3))
    for name in names:
        r = rows[name]
        print(f"{name}: {', '.join(f'{t:.5f}' for t in r['ms']) or 'FAILS'}"
              f" ms at {chip_smoke.WKV_LM_SHAPE}; limit used "
              f"{max(r['limit_used'].values()):.3g}; ptxas {r['ptxas']}",
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv6_variants.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
         "variants": rows}, indent=1))


if __name__ == "__main__":
    main()
