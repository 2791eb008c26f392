"""The ranks of ``tests/test_torch_sharded.py``: four CPU processes on a
gloo group, a 2 x 2 ``("data", "model")`` mesh, running the port's
sharded steps on reduced tinyllama-1.1b and granite-moe-1b-a400m in
float32. Rank 0 saves what the test compares (``torch.save``); this module
imports no jax, so that each spawned rank starts quickly.
"""
import logging
import os
import traceback

import torch

ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m")
B, S = 4, 8                       # train batch and sequence
PROMPT, GEN, MAX_LEN = 8, 2, 16   # serve: prompt, decode steps, cache
LR, STEPS, SEED = 1e-3, 2, 0


def arch_of(name):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(name))


def plan_of(arch, mode, kinds):
    """A one-partition ``ShardingPlan`` with ``kinds``: kind -> (batch,
    rows, cols) axes."""
    from repro_torch.core.exporter import KindPlan, PartitionPlan, \
        ShardingPlan
    from repro_torch.core.platform import Platform
    kp = {k: KindPlan(k, 1, 1, 1, r, c, b) for k, (b, r, c) in kinds.items()}
    part = PartitionPlan(0, [], kp, 0, arch.num_layers, True, True, True)
    return ShardingPlan(arch.name, mode, mode, "spmd",
                        Platform(name="t-2x2",
                                 mesh_axes=(("data", 2), ("model", 2))),
                        [part])


def plans(arch):
    """The plans the ranks run: ``tp`` (batch over data, the blocks'
    columns over model), ``dp`` (batch over both axes), ``sp`` (batch
    over data, the sequence over model) and the serve
    plans (attention's rows, so the cache's length, over model; the
    FFN's / experts' and the head's columns over model)."""
    mix = "moe" if arch.is_moe else "ffn"
    D, M, DM = ("data",), ("model",), ("data", "model")
    tp = {"embed": (D, (), ()), "attn": (D, (), M), mix: (D, (), M),
          "norm": (D, (), ()), "head": (D, (), M)}
    dp = {k: (DM, (), ()) for k in ("embed", "attn", mix, "norm", "head")}
    sp = {"embed": (D, M, ()), "attn": (D, M, ()), mix: (D, M, ()),
          "norm": (D, (), ()), "head": (D, (), M)}
    serve = {"embed": (D, (), ()), "attn": (D, M, ()), mix: (D, (), M),
             "norm": (D, (), ()), "head": (D, (), M)}
    return {"tp": plan_of(arch, "train", tp), "dp": plan_of(arch, "train", dp),
            "sp": plan_of(arch, "train", sp),
            "prefill": plan_of(arch, "prefill", serve),
            "decode": plan_of(arch, "decode", serve)}


def model_of(arch, device="cpu"):
    """The seeded float32 model (the same weights on every rank: drawn on
    the CPU, then moved)."""
    from repro_torch.models.model import Model
    model = Model(arch, attn_impl="chunked",
                  device="meta" if device == "meta" else "cpu",
                  generator=torch.Generator().manual_seed(SEED))
    return model.float().to(device)


def train_batch(arch, device="cpu"):
    g = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, arch.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    labels = torch.randint(0, arch.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}


def prompts(arch):
    g = torch.Generator().manual_seed(SEED + 2)
    return torch.randint(0, arch.vocab_size, (B, PROMPT), generator=g,
                         dtype=torch.int32)


def names(placements):
    """Placements as short names: "R", "S<dim>", "P"."""
    return tuple("R" if p.is_replicate() else
                 f"S{p.dim}" if p.is_shard() else "P" for p in placements)


def full(t):
    from repro_torch.core.dtensor import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach().cpu().clone()


def run_train(arch, plan, mesh, zero1, dp_axes, device="cpu"):
    """``STEPS`` train steps; the losses, the parameters, master and m
    after the first, and the parameters, master, m and v after the last
    (whole tensors, on the CPU)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    model = model_of(arch, device)
    step = make_train_step(model, plan, mesh, lr=LR, zero1=zero1,
                           dp_axes=dp_axes)
    state = adamw_init(dict(model.named_parameters()))
    batch = train_batch(arch, device)
    out = {"losses": []}
    for i in range(STEPS):
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        if i == 0:
            out["first"] = {
                "params": {k: full(p.detach()) for k, p in
                           model.named_parameters()},
                "master": {k: full(t) for k, t in state.master.items()},
                "m": {k: full(t) for k, t in state.m.items()}}
    out["params"] = {k: full(p.detach()) for k, p in
                     model.named_parameters()}
    for field in ("master", "m", "v"):
        out[field] = {k: full(t) for k, t in getattr(state, field).items()}
    out["layout"] = {k: names(getattr(t, "placements", ()))
                     for k, t in state.master.items()}
    return out


def run_serve(arch, plans_, mesh):
    """A prefill of ``PROMPT`` tokens, then ``GEN`` greedy decode steps:
    each step's logits (whole) and tokens."""
    from repro_torch.launch.steps import make_serve_step
    model = model_of(arch).requires_grad_(False)
    prefill = make_serve_step(model, plans_["prefill"], mesh, "prefill",
                              MAX_LEN)
    decode = make_serve_step(model, plans_["decode"], mesh, "decode",
                             MAX_LEN)
    cache = model.init_cache(B, MAX_LEN, dtype=torch.float32,
                             device="cpu")
    logits, cache = prefill(cache, {"tokens": prompts(arch)})
    logits = full(logits)
    out = {"logits": [logits], "tokens": []}
    for i in range(GEN):
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["tokens"].append(tok)
        pos = torch.tensor(PROMPT + i, dtype=torch.int32)
        logits, cache = decode(cache, {"tokens": tok}, pos)
        logits = full(logits)
        out["logits"].append(logits)
    return out


def layouts(arch, plan, mesh):
    """Every parameter's shard on this rank: (global offset, shape)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch.steps import place_model
    model = place_model(model_of(arch, "meta"), plan, mesh)
    out = {}
    for k, p in model.named_parameters():
        shape, offset = compute_local_shape_and_global_offset(
            p.shape, p.device_mesh, p.placements)
        out[k] = (tuple(int(o) for o in offset), tuple(int(s) for s in shape))
    return out


def run_reshard(mesh, small):
    """A tree placed on the 2 x 2 mesh, then moved onto the 1 x 2 mesh of
    ranks 0 and 1: its whole tensors there."""
    from repro_torch.checkpoint.elastic import reshard_tree
    from repro_torch.core.partition_spec import PartitionSpec as P
    from repro_torch.optim.adamw import AdamWState
    g = torch.Generator().manual_seed(SEED + 3)
    tree = {"w": torch.randn(6, 4, generator=g),
            "s": AdamWState(torch.zeros((), dtype=torch.int32),
                            {"m": torch.randn(8, 3, generator=g)}, {}, {})}
    specs = {"w": P("data", "model"),
             "s": AdamWState(None, {"m": P(("data", "model"))}, {}, {})}
    on4 = reshard_tree(tree, specs, mesh)
    on2 = reshard_tree(on4, {"w": P(None, "model"),
                             "s": AdamWState(None, {"m": P("model")}, {},
                                             {})}, small)
    return {"want": {"w": tree["w"], "m": tree["s"].master["m"]},
            "on4": {"w": full(on4["w"]),
                                  "m": full(on4["s"].master["m"])},
            "on2": None if torch.distributed.get_rank() > 1 else
            {"w": full(on2["w"]), "m": full(on2["s"].master["m"]),
             "placements": names(on2["w"].placements)}}


def one_device_mesh(one):
    """Reduced tinyllama-1.1b's train step on the 1 x 1 mesh of this
    rank (DTensors on a mesh of one) and on the host mesh (plain
    tensors), zero1 on: both runs' results."""
    from repro_torch.launch.mesh import make_host_mesh
    arch = arch_of(ARCHS[0])
    plan = plans(arch)["tp"]
    return {"mesh": run_train(arch, plan, one, True, ("data",)),
            "host": run_train(arch, plan, make_host_mesh("cpu"), True,
                              ("data",))}


def main(rank, world, init_file, out_dir):
    """One rank: every case, the results of rank 0 (and rank 1's reshard)
    saved under ``out_dir``; a failure is saved as its traceback."""
    from repro_torch.launch.mesh import init_process_group, make_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        torch.set_num_threads(1)
        init_process_group(world, rank, device="cpu",
                           init_method=f"file://{init_file}")
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        small = make_mesh((1, 2), ("data", "model"), device="cpu")
        res = {"layouts": {}, "train": {}, "serve": {}}
        for name in ARCHS:
            arch = arch_of(name)
            ps = plans(arch)
            res["layouts"][name] = {p: layouts(arch, ps[p], mesh)
                                    for p in ("tp", "prefill")}
            for tag, plan, zero1, dp in (
                    ("tp", ps["tp"], False, ("data",)),
                    ("tp-zero1", ps["tp"], True, ("data",)),
                    ("dp-zero1", ps["dp"], True, ("data", "model")),
                    ("sp-zero1", ps["sp"], True, ("data",))):
                res["train"][(name, tag)] = run_train(arch, plan, mesh, zero1,
                                                      dp)
            res["serve"][name] = run_serve(arch, ps, mesh)
        res["reshard"] = run_reshard(mesh, small)
        one = make_mesh((1, 1), ("data", "model"), device="cpu")
        if rank == 0:
            res["one"] = one_device_mesh(one)
        torch.distributed.barrier()
    except Exception:  # noqa: BLE001 - the test reads and reports it
        res = {"error": traceback.format_exc()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
