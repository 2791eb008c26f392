"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` has a plain ``extern "C"``
interface. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library and loaded with ``ctypes``; PyTorch's
headers are never included, so a build takes seconds. The library lands in
``build/repro_torch_kernels/`` at the repository root, under a name keyed
by a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is reused.

``BUILD_INFO[name]`` records, for each library this process loaded, the
build seconds, whether the library was reused from an earlier build, and
``ptxas``'s register / shared-memory report (``-Xptxas -v``), which is kept
beside the library so that a reused build still has it.

A source outside ``csrc/`` (a yardstick kept under ``tools/``) is built and
cached the same way when its path is passed with its name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> {"seconds": float, "cached": bool, "ptxas": str, "path": str}
#: for the libraries this process loaded (seconds is 0.0 when cached)
BUILD_INFO: Dict[str, dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}


#: the repository root's ``build/`` (listed in ``.gitignore``)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / \
    "repro_torch_kernels"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or for ``src``, under
    ``name``), built if needed. Builds of different sources may run at once
    (``load_all``)."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = Path(src) if src is not None else CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out_dir = BUILD_DIR
        so = out_dir / f"lib{name}_{digest[:16]}.so"
        report = out_dir / f"lib{name}_{digest[:16]}.ptxas.txt"
        if so.is_file():
            BUILD_INFO[name] = {
                "seconds": 0.0, "cached": True, "path": str(so),
                "ptxas": report.read_text() if report.is_file() else ""}
        else:
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            ptxas = (proc.stdout + proc.stderr).strip()
            tmp_report = out_dir / f".{report.name}.{os.getpid()}.tmp"
            tmp_report.write_text(ptxas)
            os.replace(tmp_report, report)
            os.replace(tmp, so)
            BUILD_INFO[name] = {"seconds": seconds, "cached": False,
                                "path": str(so), "ptxas": ptxas}
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib


def load_all(names: Sequence[str],
             sources: Optional[Mapping[str, Path]] = None
             ) -> Dict[str, ctypes.CDLL]:
    """``load`` every name (from ``sources[name]`` where given), all builds
    started together (one nvcc per source, each in its own thread)."""
    sources = sources or {}
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(
            lambda name: load(name, sources.get(name)), names)))


__all__ = ["load", "load_all", "BUILD_DIR", "find_nvcc", "BUILD_INFO",
           "NVCC_FLAGS", "CSRC"]
