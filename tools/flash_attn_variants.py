#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernel beside the committed
one, on one CUDA card.

    python3 tools/flash_attn_variants.py

Each variant is ``src/repro_torch/csrc/flash_attn.cu`` with a few lines
replaced (``VARIANTS``), built with the port's nvcc flags into
``build/flash_attn_variants/`` (all builds started together). Each is held
to the plain version (``ref.attention``) within one bfloat16 rounding step
(``2**-7 |want| + 2e-5 max|v|``, as ``chip_smoke.py`` holds the kernel) at
the dense LM's shape and at ``chip_smoke.py``'s two multi-tile shapes
(dh 128 and 32), then timed at the LM shape with CUDA events, in turns:
every variant in order, then in reverse, on the same inputs. Prints one
line per variant with ptxas's registers and spills, and writes
``chiprun_out/flash_attn_variants.json``. Imports nothing of JAX.
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
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (shapes, inputs, limits, timing)

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attn.cu"
OUT = ROOT / "build" / "flash_attn_variants"

_HILO_GROUPED = '''#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
        mma_bf16(o[t], ph, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
        mma_bf16(o[t], pl, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);'''
_HILO_PAIRED = '''#pragma unroll
      for (int t = 0; t < kOTiles; ++t) {
        mma_bf16(o[t], ph, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);
        mma_bf16(o[t], pl, vf[t / 2][2 * (t % 2)], vf[t / 2][2 * (t % 2) + 1]);
      }'''
_BOUNDS = "__launch_bounds__(kMThreads)\n    flash_attn_mma_kernel"

#: the row max on raw scores; the scale folded into one multiply-add
#: in front of ex2
_FFMA = [
    ("""        float x = s[t][e] * scale_log2;
        if (!unmasked) {""", """        float x = s[t][e];
        if (!unmasked) {"""),
    ("""    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];""", """    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = m[r] * scale_log2;"""),
    ("s[t][e] = exp2_approx(s[t][e] - m[e / 2]);",
     "s[t][e] = exp2_approx(fmaf(s[t][e], scale_log2, -ms[e / 2]));"),
]
_BK32 = [("constexpr int kMBK = 64;", "constexpr int kMBK = 32;")]

#: name -> (old, new) replacements in the committed source
VARIANTS = {
    "committed": [],
    "8 warps (128 q rows)": [("constexpr int kMWarps = 4;",
                              "constexpr int kMWarps = 8;")],
    "8 warps, at least 2 blocks an SM": [
        ("constexpr int kMWarps = 4;", "constexpr int kMWarps = 8;"),
        (_BOUNDS, _BOUNDS.replace("(kMThreads)", "(kMThreads, 2)"))],
    "at least 4 blocks an SM": [
        (_BOUNDS, _BOUNDS.replace("(kMThreads)", "(kMThreads, 4)"))],
    "exp2f for ex2.approx": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = exp2f(x);")],
    "hi and lo products paired": [(_HILO_GROUPED, _HILO_PAIRED)],
    "max on raw scores, scale in one FFMA": _FFMA,
    "32-key tiles": _BK32,
    "32-key tiles, max on raw scores": _BK32 + _FFMA,
}


def _source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name!r}: {old[:60]!r}... is not in "
                             f"{SOURCE.name}")
        src = src.replace(old, new)
    return src


def _build(i: int, name: str):
    from repro_torch.core.accel import cuda_build
    cu = OUT / f"v{i}.cu"
    so = OUT / f"libv{i}.so"
    cu.write_text(_source(name))
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name!r}:\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    mma = {}
    function = ""
    for line in report.splitlines():
        if "Function properties for" in line:
            function = line.rsplit(" ", 1)[-1]
        hit = re.search(r"flash_attn_mma_kernelILi(\d+)E", function)
        if not hit:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            mma.setdefault(hit.group(1), {})["spill_stores"] = \
                int(spill.group(1))
        if regs:
            mma.setdefault(hit.group(1), {})["registers"] = int(regs.group(1))
    fn = ctypes.CDLL(str(so)).flash_attn_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, mma


def _call(fn, q, k, v):
    import torch
    B, Sq, H, dh = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
             Sq, k.shape[1], H, k.shape[2], dh, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def main() -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    names = list(VARIANTS)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(_build, range(len(names)), names))
    shapes = (*chip_smoke.FLASH_DEEP_SHAPES, chip_smoke.FLASH_LM_SHAPE)
    rows = {n: {"ptxas": mma, "limit_used": {}, "ms": []}
            for n, (_, mma) in zip(names, built)}
    for i, shape in enumerate(shapes):
        q, k, v = chip_smoke._flash_inputs(shape, torch.bfloat16,
                                           seed=300 + i)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        for name, (fn, _) in zip(names, built):
            used = chip_smoke._flash_limit_used(_call(fn, q, k, v), want, v)
            rows[name]["limit_used"][str(shape)] = used
        del want
    held = [n for n in names if max(rows[n]["limit_used"].values()) <= 1.0]
    q, k, v = chip_smoke._flash_inputs(chip_smoke.FLASH_LM_SHAPE,
                                       torch.bfloat16, seed=400)
    for order in (held, held[::-1]):       # a variant that fails: no time
        for name in order:
            fn = built[names.index(name)][0]
            rows[name]["ms"].append(chip_smoke.cuda_ms(
                lambda: _call(fn, q, k, v), 20, warmup=3))
    for name in names:
        r = rows[name]
        print(f"{name}: {', '.join(f'{t:.5f}' for t in r['ms']) or 'FAILS'}"
              f" ms at "
              f"{chip_smoke.FLASH_LM_SHAPE}; limit used "
              f"{max(r['limit_used'].values()):.3g}; ptxas {r['ptxas']}",
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_attn_variants.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
         "variants": rows}, indent=1))


if __name__ == "__main__":
    main()
