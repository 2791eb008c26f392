"""The port stands alone: ``repro_torch`` imports torch and numpy, never
jax and nothing of the JAX package ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_support import port_obs_reset  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"repro_torch.runtime", "repro_torch.core.pipeline",
                "repro_torch.core.accel.segred",
                "repro_torch.core.accel.eval_torch",
                "repro_torch.core.accel.search_loops",
                "repro_torch.core.accel.fleet",
                "repro_torch.core.accel.comap_fleet",
                "repro_torch.core.comap", "repro_torch.service",
                "repro_torch.service.cache", "repro_torch.service.queue",
                "repro_torch.service.server",
                "repro_torch.core.accel.lowering",
                "repro_torch.core.optimizers.rule_based",
                "repro_torch.core.optimizers.brute_force",
                "repro_torch.core.optimizers.annealing",
                "repro_torch.obs.metrics", "repro_torch.obs.trace",
                "repro_torch.kernels.ref", "repro_torch.kernels.ops",
                "repro_torch.kernels.rwkv6_scan",
                "repro_torch.kernels.flash_attention",
                "repro_torch.models.layers", "repro_torch.models.rwkv",
                "repro_torch.models.attention",
                "repro_torch.models.model", "repro_torch.models.convert",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.launch",
                "repro_torch.launch.mesh", "repro_torch.launch.shapes",
                "repro_torch.launch.train", "repro_torch.launch.steps",
                "repro_torch.launch.serve",
                "repro_torch.runtime.fault_tolerance",
                "repro_torch.runtime.stragglers", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.optim",
                "repro_torch.optim.adamw", "repro_torch.optim.compression",
                "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
                "repro_torch.checkpoint.elastic"}
    assert expected <= set(out["modules"])
    assert out["bad"] == []


def test_import_pins_float32_matmuls_to_full_precision():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_engine_registry():
    from repro_torch.core.accel import ENGINES, resolve_engine
    assert ENGINES == ("scalar", "numpy", "torch")
    assert resolve_engine("auto") == "torch"
    assert resolve_engine("batched") == "numpy"
    assert resolve_engine("torch") == "torch"
    for bad in ("jax", "cuda", "nupmy"):
        with pytest.raises(ValueError, match="unknown engine"):
            resolve_engine(bad)


def test_default_device_is_the_card_and_never_the_cpu(monkeypatch):
    """No card and no device="cpu": the torch engine raises instead of
    carrying on on the CPU."""
    from repro_torch import runtime
    from repro_torch.core.accel import EngineUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineUnavailable, match="device='cpu'"):
        runtime.default_device()
    with pytest.raises(EngineUnavailable):
        runtime.resolve_device(None)
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert runtime.default_device() == torch.device("cuda")


def test_resolve_dtype():
    from repro_torch.runtime import resolve_dtype
    assert resolve_dtype() is torch.float32
    assert resolve_dtype(torch.float64) is torch.float64
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        resolve_dtype(torch.float16)


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    """``chip_smoke.py`` runs where there is no jax: every import in it,
    at any depth, names neither jax nor the JAX package."""
    import ast
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "repro_torch.models.model" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                        "repro")]
