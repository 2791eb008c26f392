"""Batched serving loop: prefill, then greedy decode against a KV/state
cache, on one device.

``serve`` builds the model from a seed (weights drawn as ``Model`` draws
them), plans the cell (``plan_for_mesh``), draws ``batch`` prompts and
runs ``generate``: one prefill step that writes the prompts into the cache
and picks each row's first token, then ``gen_len - 1`` decode steps of one
token each. Every token is the argmax of its logits (the first on ties).
Times end in ``torch.cuda.synchronize()`` on the card.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \\
        --prompt-len 32 --gen-len 32 --batch 4 [--device cpu]

A plan of more than one partition (weight streaming) and the whisper
encoder-decoder are not ported (ROADMAP Queue 1 items 15 and 13d).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import plan_for_mesh
from repro_torch.models.model import Model
from repro_torch.runtime import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen_len: int, *,
             plan=None, mesh=None, cache_dtype=torch.bfloat16,
             keep_logits: bool = False):
    """Greedy generation of ``gen_len`` tokens after each prompt row.

    ``prompts``: (B, P) integer tokens on the model's device. Returns
    (tokens (B, gen_len) int32, stats) with the serve loop's stats
    ``prefill_s``, ``decode_s`` and ``decode_tok_per_s``; with
    ``keep_logits`` also ``logits`` (B, gen_len, V) in float32, the logits
    each token was picked from. ``mesh`` defaults to the host mesh of the
    prompts' device and ``plan`` may be None (on one device every shard
    function is the identity); the cache holds ``cache_dtype`` (JAX's
    default bfloat16)."""
    B, P = prompts.shape
    device = prompts.device
    arch = model.arch
    max_len = P + gen_len
    if mesh is None:
        mesh = make_host_mesh(device)
    batch_keys = ("tokens", "mrope_positions") if arch.mrope else ("tokens",)
    prefill = make_serve_step(model, plan, mesh, "prefill", max_len,
                              batch_keys=batch_keys)
    decode = make_serve_step(model, plan, mesh, "decode", max_len,
                             batch_keys=batch_keys)
    cache = model.init_cache(B, max_len, dtype=cache_dtype, device=device)
    # every decode position, made once on the device: no copy a step
    positions = torch.arange(P, max_len, dtype=torch.int32, device=device)

    batch_in: Dict[str, Any] = {"tokens": prompts.to(torch.int32)}
    if arch.mrope:
        pos = torch.arange(P, dtype=torch.int32, device=device)
        pos = pos[None].repeat(B, 1)
        batch_in["mrope_positions"] = torch.stack([pos, pos, pos])

    kept = []
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cache, batch_in)
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    if keep_logits:
        kept.append(logits[:, -1].float())
    _sync(device)
    prefill_s = time.perf_counter() - t0

    generated = [next_tok]
    t1 = time.perf_counter()
    for i in range(gen_len - 1):
        step_in: Dict[str, Any] = {"tokens": next_tok[:, None]}
        if arch.mrope:
            p = positions[i].expand(1, B, 1)
            step_in["mrope_positions"] = torch.cat([p, p, p], 0)
        logits, cache = decode(cache, step_in, positions[i])
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        if keep_logits:
            kept.append(logits[:, -1].float())
        generated.append(next_tok)
    _sync(device)
    decode_s = time.perf_counter() - t1

    stats: Dict[str, Any] = {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tok_per_s": B * (gen_len - 1) / max(decode_s, 1e-9),
    }
    if keep_logits:
        stats["logits"] = torch.stack(kept, dim=1)
    return torch.stack(generated, dim=1), stats


def serve(arch: ArchConfig, *, prompt_len: int = 32, gen_len: int = 32,
          batch: int = 4, mesh=None, seed: int = 0, greedy: bool = True,
          log=print, device=None, keep_logits: bool = False):
    """Prefill ``batch`` prompts, then decode ``gen_len`` tokens each.
    Returns (generated tokens (B, gen_len), stats dict).

    The model's weights are drawn from a ``torch.Generator`` seeded
    ``seed`` and the prompts from one seeded ``seed + 1``. ``device=None``
    is the card (no card: ``EngineUnavailable``); ``mesh`` defaults to the
    host mesh of that device. ``greedy`` is kept for the signature:
    decoding is greedy. ``keep_logits`` adds the logits each token was
    picked from to the stats (``generate``)."""
    mesh = mesh or make_host_mesh(device)
    dev = resolve_device(mesh.devices.flat[0])
    model = Model(arch, attn_impl="chunked", remat=False, device=dev,
                  generator=torch.Generator(dev).manual_seed(seed))
    shape_p = ShapeSpec("serve_prefill", prompt_len, batch, "prefill")
    plan = plan_for_mesh(arch, shape_p, mesh, objective="throughput")
    if len(plan.partitions) != 1:
        raise NotImplementedError(
            f"a plan of {len(plan.partitions)} partitions (weight "
            f"streaming) is not ported yet (ROADMAP Queue 1 item 15: "
            f"make_partition_serve_step)")

    gen = torch.Generator(dev).manual_seed(seed + 1)
    prompts = torch.randint(0, arch.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int32, device=dev)
    tokens, stats = generate(model, prompts, gen_len, plan=plan, mesh=mesh,
                             keep_logits=keep_logits)
    stats["partitions"] = len(plan.partitions)
    log(f"[serve] prefill {stats['prefill_s'] * 1e3:.0f} ms, decode "
        f"{stats['decode_tok_per_s']:.1f} tok/s, "
        f"{stats['partitions']} partition(s)")
    return tokens, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    tokens, stats = serve(arch, prompt_len=args.prompt_len,
                          gen_len=args.gen_len, batch=args.batch,
                          device=args.device)
    print(f"[serve] generated shape {tuple(tokens.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
