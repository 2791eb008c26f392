"""Weights carried between the JAX package and the port, and one seeded
numpy recipe that both sides can build the same weights from.

``params_from_jax(tree, device=..., dtype=None)`` turns a parameter tree in
the JAX layout (nested dicts of numpy arrays, as ``jax.tree.map(np.asarray,
Model(arch).init_params(key))`` gives it) into the port's ``state_dict``:
keys are the tree's paths joined by ``.``, values keep JAX's dtypes unless
``dtype`` is given. Load it with ``Model.load_state_dict(sd, strict=True)``
(``assign=True`` on a ``meta``-device model keeps the given dtypes).

``opt_state_from_jax(state, device=...)`` does the same for the JAX
package's ``AdamWState`` (its step and its master, m and v trees as numpy
arrays), giving the port's ``optim.adamw.AdamWState`` keyed as the
``state_dict``.

``recipe_params(shapes, seed)`` draws numpy float32 values for every leaf of
a parameter tree, one stated recipe per leaf, leaves in sorted
key order from one ``numpy.random.default_rng(seed)``; ``recipe_batch``
draws tokens and labels the same way, ``recipe_frames`` the audio
encoder's frames. A program without JAX builds the same
weights and batch as a JAX program given the same tree shapes and seeds.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a.b.c": leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": leaf} -> nested dicts (the inverse of ``flatten``)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, bit for bit
        a = a.view(np.int16)
        return torch.from_numpy(np.require(a, requirements=["C", "W"])
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def params_from_jax(tree: Mapping[str, Any], *, device,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX-layout parameter tree."""
    return {k: _tensor(a).to(device=device, dtype=dtype)
            for k, a in flatten(tree).items()}


def opt_state_from_jax(state: Any, *, device):
    """The port's ``AdamWState`` for a JAX-layout one: any object with the
    fields ``step``, ``master``, ``m`` and ``v`` (JAX's ``AdamWState`` of
    numpy arrays), the three trees flattened as ``params_from_jax``
    flattens parameters, every value kept bit for bit."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(
        _tensor(np.asarray(state.step, np.int32)).to(device),
        *(params_from_jax(getattr(state, f), device=device)
          for f in ("master", "m", "v")))


def _draw(rng: np.random.Generator, name: str,
          shape: Sequence[int]) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    shape = tuple(shape)
    if leaf == "bonus":
        return 0.5 * rng.standard_normal(shape, dtype=np.float32)
    if leaf in ("conv_w", "conv_b"):
        return 0.1 * rng.standard_normal(shape, dtype=np.float32)
    if leaf == "a_log":
        base = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
        return base + 0.1 * rng.standard_normal(shape, dtype=np.float32)
    if leaf == "dt_bias":
        # softplus^-1 of steps drawn log-uniformly from [1e-3, 1e-1]
        step = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), shape))
        return np.log(np.expm1(step)).astype(np.float32)
    if leaf == "d_skip":
        return 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
    if len(shape) >= 2 and leaf not in ("ln_scale", "ln_bias", "decay") \
            and not leaf.startswith("mix_"):
        scale = np.float32(1.0 / math.sqrt(shape[-2]))
        return rng.standard_normal(shape, dtype=np.float32) * scale
    if leaf == "ln_scale":
        return 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
    if leaf == "ln_bias":
        return 0.1 * rng.standard_normal(shape, dtype=np.float32)
    if leaf.startswith("mix_"):
        return rng.random(shape, dtype=np.float32)
    if leaf == "decay":
        return rng.uniform(-6.0, 1.0, shape).astype(np.float32)
    raise ValueError(f"no recipe for parameter {name!r} of shape {shape}")


def recipe_batch(vocab_size: int, batch: int, seq: int,
                 seed: int) -> Dict[str, np.ndarray]:
    """A batch dict of int32 ``tokens`` and ``labels`` (batch, seq), drawn
    uniformly from the vocabulary by ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, vocab_size, (batch, seq)).astype(np.int32)
            for name in ("tokens", "labels")}


def recipe_frames(batch: int, frames: int, d_model: int,
                  seed: int) -> np.ndarray:
    """(batch, frames, d_model) float32 standard normal frame embeddings
    for the audio encoder, drawn by ``numpy.random.default_rng(seed)``
    (the model rounds them to bfloat16 as JAX's does)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, frames, d_model), dtype=np.float32)


def recipe_params(shapes: Mapping[str, Sequence[int]],
                  seed: int) -> Dict[str, np.ndarray]:
    """{dotted name: shape} -> {dotted name: float32 array}, drawn in sorted
    name order from ``numpy.random.default_rng(seed)``. By the leaf's name
    (N a standard normal, U(a, b) uniform, rows = shape[-2]):

      bonus                      0.5 N
      conv_w, conv_b             0.1 N     (the SSM's causal conv, JAX's
                                            init scale)
      a_log                      log(1..d_state) along the last axis
                                 + 0.1 N   (A = -exp(a_log): JAX's spread
                                            of decays, jittered)
      dt_bias                    log(expm1(s)), s = exp(U(log 1e-3,
                                 log 1e-1))  (softplus(dt_bias) = s: SSM
                                            steps from 1e-3 to 0.1 before
                                            the data's share)
      d_skip                     1 + 0.1 N
      any other of >= 2 axes     N / sqrt(rows)   (weights, embedding)
      ln_scale                   1 + 0.1 N
      ln_bias                    0.1 N
      mix_*                      U(0, 1)
      decay                      U(-6, 1)  (multipliers exp(-exp(.)) from
                                            0.07 to 0.998)
    """
    return dict(recipe_leaves(shapes, seed))


def recipe_leaves(shapes: Mapping[str, Sequence[int]], seed: int):
    """``recipe_params``' draws one leaf at a time: (name, float32 array)
    in sorted name order, so that a caller converting a large tree holds
    one drawn leaf at once."""
    rng = np.random.default_rng(seed)
    for name in sorted(shapes):
        yield name, _draw(rng, name, shapes[name]).astype(np.float32,
                                                          copy=False)


__all__ = ["params_from_jax", "opt_state_from_jax", "recipe_params",
           "recipe_leaves", "recipe_batch", "recipe_frames", "flatten",
           "nest"]
