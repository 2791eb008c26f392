#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line; any failure exits non-zero and no
phase's failure is caught while the run goes on:

  1. device   the card's name, power limit and CUDA version (no card: exit 1)
  2. build    the hand-written kernels, built from ``src/repro_torch/csrc``
              with nvcc for sm_90a, one nvcc per source, all started
              together (a later run reuses the libraries and says so);
              build seconds and ptxas's register / shared-memory / spill
              report (a spill store in the tensor-core flash kernel or the
              chunked WKV kernel fails). Built beside them, by the same
              cached loader from their own sources, as yardsticks timed in
              phase 3 and never used by the port: segred's first design
              (``tools/segred_first_design.cu``) and wkv6's step-by-step
              kernel (``tools/wkv6_step_design.cu``), run for bfloat16
  3. kernels  each kernel held against its plain PyTorch version on the card,
              with CUDA-event times (the kernel's, one PyTorch library
              call's where one exists and the earlier design's for segred
              and bf16 wkv6 as medians of rounds timed in turns) beside the
              plain version's and the bound:
              segred (max and sum bitwise, NaN where the plain version has
              it) at the mapper's shape, a brute-force chunk's and one node
              a row, in float32 and float64, with rows that are one segment,
              a segment a node, hold NaN and hold tied maxima; wkv6 (1e-4
              abs and rel with float32 r/k/v; with bfloat16 2e-2 abs and rel
              and, tighter, one bfloat16 rounding step; every output
              finite) at the JAX kernel test's shapes, a strong-decay case,
              decays with exact zeros and near 1e-30, T = 4097 and the LM
              phase's shape (2, 4096, 32, 64) in both types; flash_attn
              (2e-5 abs and rel in float32; in
              bfloat16 2e-2 abs and rel and, tighter, one bfloat16 rounding
              step) on the JAX kernel test's grid (shapes x dtype x causal),
              the reduced model's head size 32, two causal multi-tile cases
              (dh 128 and 32) and the dense LM phase's shape (B=2, S=4096,
              32 heads over 4 KV heads of 64, causal) in bfloat16 and
              float32, each timed beside scaled_dot_product_attention
  4. main     the rule-based optimiser with the torch engine on
              tinyllama-1.1b / train_4k / V5E_POD, for two requests, timed
              at the optimiser's entry point; each must equal the port's
              numpy engine (points, variables, history, objective) and the
              JAX package's recorded values, must have launched segred, and
              ``repro_torch.core.pipeline.optimise_mapping`` must return its
              plan
  5. search   the other two optimisers' entry points with the torch engine
              on the same arch, shape and platform (each timed call's plan
              equal to ``optimise_mapping``'s for the request): brute force
              (a) on the megatron backend, spmd/latency, every cut set of up
              to two cuts (201,933 points) and (b) on the spmd backend, the
              empty cut set's first 262,144 points in chunks of 65,536, each
              equal to the port's numpy engine run live and to the JAX
              package's record (points, design, history indices, objective;
              recorded objectives at 1e-5), segred launched in (a) and not in
              (b); (c) multi-chain SA (spmd backend, both of phase 4's
              requests, 64 chains, the default 342 sweeps): seed 0 twice
              identical, seed 1 another path, the whole schedule once more
              with every host sync an error and every chain's incumbent
              re-evaluated in float64 by the numpy engine (feasibility
              equal, objectives at 1e-5), and the schedule in float64
              with the same draws on the card and on the CPU, equal after
              every sweep (objectives within 1e-9); wall, points/s and
              segred launches of each request beside the card's name and
              power limit
  6. fleet    ``repro_torch.core.pipeline.optimise_portfolio(engine="torch")``
              over the ten registry archs at train_4k, platforms
              alternating V5E_POD / V5E_2POD and objectives alternating
              throughput / latency, timed once a part with its ``results``:
              (a) rule-based, spmd / streaming, every arch at full width
              cut to at most 12 decoder and 12 encoder layers,
              tinyllama-1.1b listed twice
              (coalesced once), every lane equal to the numpy engine (run
              after the timed runs, in worker processes), three lanes
              bitwise their per-problem torch run (each timed), segred
              once at [P, n]
              and once at [P x probes, n] a lockstep step; (b) SA, spmd,
              64 chains x 342 sweeps, at (a)'s depth cut,
              every lane bitwise its per-problem
              torch run and its incumbent the numpy engine's in float64,
              segred once a sweep a bucket; (c) brute force, megatron,
              one-cut sets, 16,384 points a problem, every lane equal to
              the numpy engine and bitwise its per-problem torch run,
              segred once a chunk with a cut for a whole bucket; each with
              its buckets, segred's shapes and kernel, and the walls and
              points/s of the portfolio and of the per-problem loop
  7. comap    ``optimise_comapping(["tinyllama-1.1b", "llama3.2-1b"],
              decode_32k, V5E_POD, optimiser="rule_based",
              objective="weighted_throughput", engine="torch")``: the 15
              splits of the 16-row data axis x 2 nets, 30 lanes at full
              width and depth in one rule-based fleet call; split (12, 4),
              134,803 points and a history of 5 as the numpy engine gives
              them, and split, designs, objectives, points and history
              equal to the numpy engine's run (in a worker process beside
              phases 10 and 11); each plan's objective its lane's; segred
              once at [30, n] and once at [30 x probes, n] a lockstep step
  8. service  ``repro_torch.service.MappingServer`` on the card: phase 4's
              two requests from 8 threads x 3 seeded submissions, each
              response bitwise phase 4's direct run, from 2 engine runs
              (the rest coalesced or cached) in lockstep rounds of one
              descent call each; a streaming/latency request that joins
              the streaming round after 3 rounds, equal to its own direct
              run; one POST /v1/mapping and one POST /v1/comap on
              127.0.0.1 (reduced nets), each equal to the direct call;
              segred twice a descent step in each part
  9. devices  the device axis, ``devices=D``, on the card (D shards
              share it and run one after another), each part bitwise its
              ``devices=None`` run in this process: (a) [search] (a) at
              D = 3 (B = 1026, ragged) and 8, segred once a shard a chunk
              with a cut, at [B/D, 47] (points, design, history,
              objective); (b) [fleet] (c)'s portfolio at D = 3 (ragged
              buckets, ``take = 0`` padding lanes), every plan and result,
              segred three times as often; (c) ``optimise_portfolio`` SA
              on three of [fleet] (b)'s archs at full width cut to 4
              layers, 16 chains x 50 sweeps, at None and D = 2 (3 lanes
              pad to 4 with a copy of lane 0); (d) ``optimise_comapping``
              of [comap]'s pair at full width cut to 4 layers on 2 pinned
              splits (4 lanes) at None and D = 3 (``cap = 0`` padding);
              (e) one POST /v1/mapping of brute force with
              ``"devices": 2`` (reduced tinyllama-1.1b, megatron, one-cut
              sets, 4,096 points), equal to the direct call; each part's
              wall, segred launches and shard devices
  10. lm      ``repro_torch.models.model.Model(rwkv6-1.6b, use_flash=True)``
              at full width: (a) the first 2 layers with float32 weights from
              the seeded numpy recipe, B=1, T=128, held to the JAX package's
              record (loss 1e-4 relative, sampled logits 1e-3 absolute);
              (b) all 24 layers, bfloat16 weights drawn on the card from a
              seed, B=2, T=4096: wall per forward, tokens/s, WKV launches
              per forward (must be 24) and peak memory; every in-model WKV
              launch held to the plain version on the same inputs (2e-2 abs
              and rel, and one bfloat16 rounding step); the loss held to the
              same model with the plain WKV (1e-3 relative); the logits held
              to that model's within 1.5 times the distance between that
              model and the same model with the recurrence summed in
              float64 (random bfloat16 weights over 24 layers turn
              summation order alone into logit differences far above a
              fixed 6e-2, see PERF.md); (c) the (b) weights in float32, all
              24 layers: the kernel forward held to the plain-WKV float32
              forward (logits 1e-3 abs and rel, loss 1e-5 relative)
  11. lm-dense ``Model(tinyllama-1.1b, use_flash=True)`` at full width, the
              same two checks with flash attention in the kernel: (a) 2
              layers, float32 recipe weights, B=1, T=128, held to the JAX
              record ``DENSE_RECORD``; (b) all 22 layers in bfloat16 at B=2,
              T=4096: 22 kernel launches per forward, each held to the plain
              version (2e-2 and one bfloat16 rounding step), the loss held to the ``attn_impl="ref"`` model
              (1e-3 relative) and the logits within 1.5 times that model's
              distance from the same model with attention in float64
  12. serve  ``repro_torch.launch.serve`` (prefill into a KV/state cache,
              then greedy decode) for tinyllama-1.1b, rwkv6-1.6b and
              granite-moe-1b-a400m (attention + 32-expert top-8 MoE) at
              full width: (a) the first 2 layers, float32 recipe weights
              and cache, B=1, a 16-token prompt, 8 tokens through
              ``generate``: tokens equal to the JAX record ``SERVE_RECORD``
              (``tools/serve_records.py``: JAX's eager ``forward`` with a
              cache, in a greedy loop), sampled logits within 1e-3; (b)
              all layers, bfloat16 weights drawn on the card from a seed,
              B=8, prompt 512, 64 tokens through ``serve``: prefill ms,
              decode tokens/s, peak memory; segred's launches (the plan),
              none of wkv6 or flash_attn (decode against a cache takes the
              oracles, as in JAX); at every generated position the decode
              logits within 1.5 times the distance between the cache-less
              forward over the served sequence and the same forward with
              attention / WKV in float64, and each served token's logit in
              that forward within twice the step's decode-vs-recompute
              distance of its row's maximum; (c) the (b) weights in float32
              with a float32 cache: decode logits within 1e-3 abs and rel
              of the cache-less float32 forward, the same token rule; (d)
              granite's drops at decode (T = 8, cap 2) equal to a host
              recount from the routed expert ids

  13. profile (only with ``--profile``) the first mapping request, each
              [search] request (SA: spmd/latency), [fleet] (b) and (c),
              one forward of each LM, one 16-token ``generate`` of each
              [serve] arch
              once more under ``torch.profiler``: device busy time, the idle
              share, the kernel's share and the kernels that take the most
              device time, beside the wall time; and
              segred's device time a launch beside its first design's, at
              the mapper's shape and a brute-force chunk's

Each phase's wall is printed as it ends (``[wall]``), and all of them
before the records. The line before the last is the kernels' JSON record;
the last line is
``{"ok": true, "device": {...}}``. Longer records go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; FLOP/s for float32
#: and float64 outside the tensor cores, and bf16 dense on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}

#: the hand-written kernels, one source each under src/repro_torch/csrc
KERNELS = ("segred", "wkv6", "flash_attn")
#: kernels (by name) whose ptxas report must show no spill stores
NO_SPILL = ("flash_attn_mma_kernel", "wkv6_chunk_kernel")
#: the earlier designs, timed beside the kernels and never used by the port
YARDSTICKS = {"segred_first_design": ROOT / "tools" / "segred_first_design.cu",
              "wkv6_step_design": ROOT / "tools" / "wkv6_step_design.cu"}

#: the JAX package's results for these requests (CPU run of repro's
#: engine="jax" and engine="numpy", which agree): points, objective,
#: partitions, history length
REQUESTS = (
    {"exec_model": "streaming", "objective": "throughput",
     "points": 3288, "value": -0.4505275627007433, "partitions": 24,
     "history": 3},
    {"exec_model": "spmd", "objective": "latency",
     "points": 4031, "value": 0.22177328183717918, "partitions": 1,
     "history": 3},
)

#: [search] requests on tinyllama-1.1b / train_4k / V5E_POD. Brute force:
#: the settings and the JAX package's record (CPU run of repro's
#: engine="jax", equal to its engine="numpy"): points, objective, history
#: [(index, objective)] and design (cuts, s_in, s_out, kern). (a) takes
#: every cut set of up to two cuts (K1 in each of the 276 with a cut, at
#: [1024, 47]); (b) the empty cut set only, in chunks of 65,536 rows, which
#: is evaluated as one partition and launches K1 no time
SEARCH_BF = (
    {"name": "a", "backend": "megatron", "exec_model": "spmd",
     "objective": "latency", "kw": {"include_cuts": True, "max_cuts": 2},
     "points": 201933, "value": 0.22177328183717918,
     "history": [(55, 0.22177329659461975)],
     "variables": ((), [1] * 47, [1] * 47, [256] * 47), "segred": True},
    {"name": "b", "backend": "spmd", "exec_model": "spmd",
     "objective": "latency",
     "kw": {"include_cuts": False, "max_points": 262144,
            "batch_size": 65536},
     "points": 262144, "value": 4.319828488379967,
     "history": [(42312, 4.412864685058594), (42314, 4.32696533203125),
                 (48370, 4.319828510284424)],
     "variables": ((), [1, 1] + [16, 1] * 21 + [16] * 3,
                   [1, 1] + [16, 1] * 21 + [16] * 3,
                   [1, 256] * 22 + [1] * 3),
     "segred": False},
)
#: [search] (c): multi-chain SA on the spmd backend, for both of phase 4's
#: requests, 64 chains on the default schedule (342 sweeps), seeds 0 and 1
SEARCH_SA = {"backend": "spmd", "chains": 64, "sweeps": 342, "seeds": (0, 1)}
#: float32 agreement of recorded objectives with the float64 reference
F32_RTOL = 1e-5

#: the main path's shape, a brute-force chunk's, one node a row, the
#: shapes of [search]: a brute-force chunk of (a) and the SA chains of (c),
#: of [fleet]: the probe rows of all ten lanes of (a) and the chains of all
#: ten lanes of (b), of [comap]: the incumbents and the probe rows of all
#: 30 lanes, and of [devices] (a): a shard of (a)'s chunk at D = 3 and 8
SEGRED_SHAPES = ((28, 47), (65536, 47), (64, 1), (1024, 47), (64, 47),
                 (2170, 63), (640, 163), (30, 47), (1950, 47), (342, 47),
                 (128, 47))

#: wkv6 check shapes (B, T, H, hs) and decay ranges: tests/test_kernels.py's
#: WKV shapes, a strong-decay case, decays with exact zeros and near 1e-30,
#: a ragged T, the model's own decay (a long memory), and the [lm] phase's
#: shape
WKV_CHECKS = (
    ((1, 128, 2, 32), (0.55, 0.95)), ((2, 256, 4, 64), (0.55, 0.95)),
    ((1, 100, 2, 64), (0.55, 0.95)), ((1, 64, 1, 128), (0.55, 0.95)),
    ((1, 256, 2, 64), (0.02, 0.1)), ((1, 256, 2, 64), "zeros"),
    ((1, 256, 2, 64), "tiny"), ((1, 4097, 2, 64), (0.55, 0.95)),
    ((1, 4096, 8, 64), "model"),
)
WKV_LM_SHAPE = (2, 4096, 32, 64)
WKV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: in bfloat16 the kernel and its plain version both sum in float32 and
#: round once to bfloat16, so an output may differ from the plain one by
#: one rounding step (BF16_STEP of |want|) plus the float32 sums' order.
#: On the CPU each order lies within 2.6e-7 max|y| of the same recurrence
#: in float64 (T up to 2048, w up to 0.95, strong decay too), so the two
#: lie within about 5e-7 max|y| of each other; the slack
#: WKV_BF16_SLACK max|want| is four times that
WKV_BF16_SLACK = 2e-6
#: one bfloat16 rounding step, relative: 8 significant bits
BF16_STEP = 2.0 ** -7

#: the JAX package's loss and sampled logits [b, t, v, logit] for the port's
#: seeded numpy recipe (repro_torch.models.convert, seed 0): rwkv6-1.6b at
#: full width, layer_range (0, 2), float32, B=1, T=128; made on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
#:       rwkv6-1.6b 2 1 128 0
LM_RECORD = {
    "arch": "rwkv6-1.6b", "layers": 2, "batch": 1, "seq": 128, "seed": 0,
    "loss": 11.68708324432373,
    "logits": [
        [0, 0, 0, 0.28645339608192444], [0, 0, 1, -0.7389975786209106],
        [0, 0, 32767, -0.03645841404795647],
        [0, 0, 65535, -2.2897133827209473],
        [0, 1, 0, -0.2396697849035263], [0, 1, 1, -0.4577353000640869],
        [0, 1, 32767, -0.07143926620483398],
        [0, 1, 65535, -1.275397539138794],
        [0, 64, 0, 0.10178482532501221], [0, 64, 1, 0.7287406325340271],
        [0, 64, 32767, -2.187739372253418],
        [0, 64, 65535, 1.1632769107818604],
        [0, 127, 0, 0.9406948089599609], [0, 127, 1, 1.22970712184906],
        [0, 127, 32767, 0.11191505193710327],
        [0, 127, 65535, 0.2801424264907837],
    ],
}
LM_FULL = {"arch": "rwkv6-1.6b", "batch": 2, "seq": 4096, "seed": 1,
           "runs": 3}
#: [lm] (b): the kernel forward's logits may lie at most this many times as
#: far from the plain-WKV forward's as the plain forward's lie from the same
#: model with its recurrence summed in float64
LOGIT_YARDSTICK = 1.5
#: [lm] (c): the (b) weights in float32, the kernel forward against the
#: plain-WKV forward: logits within this abs and rel, loss within
#: LM_F32_LOSS_TOL relative. Only the WKV sums' order differs, about 1e-7
#: of an output, which 24 layers amplify to about 4e-4 in the logits on an
#: H100 (PERF.md)
LM_F32_LOGIT_TOL = 1e-3
LM_F32_LOSS_TOL = 1e-5

#: flash_attn check shapes (B, Sq, Skv, H, Hkv, dh): tests/test_kernels.py's
#: FLASH_SHAPES, the reduced model's head size, and [lm-dense] (b)'s shape
FLASH_SHAPES = ((1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
                (1, 64, 64, 4, 1, 128), (2, 37, 37, 4, 2, 64),
                (1, 16, 512, 2, 2, 64), (2, 100, 100, 4, 2, 32))
FLASH_LM_SHAPE = (2, 4096, 4096, 32, 4, 64)
#: causal multi-tile cases the small grid cannot reach: many 64-key tiles
#: at dh = 128 (group 8) and at dh = 32 (no grouping)
FLASH_DEEP_SHAPES = ((1, 2048, 2048, 16, 2, 128), (1, 1024, 1024, 8, 8, 32))
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: in bfloat16 the plain version works in float32 and rounds once to
#: bfloat16, and the kernel carries P as bf16 hi + lo (about 2**-16 of p),
#: so an output may differ from the plain one by one rounding step
#: (BF16_STEP of |want|) plus the float32 sums' order (under
#: FLASH_BF16_SLACK of the largest |v|). At S = 4096 the outputs are
#: averages of thousands of values, so 2e-2 abs is as large as a typical
#: output and could not see a dropped KV tile; this limit can
FLASH_BF16_SLACK = 2e-5

#: as LM_RECORD, for tinyllama-1.1b (full width, layers 0-2, float32 recipe
#: weights, B=1, T=128, seed 0); made on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_support.py \
#:       tinyllama-1.1b 2 1 128 0
DENSE_RECORD = {
    "arch": "tinyllama-1.1b", "layers": 2, "batch": 1, "seq": 128, "seed": 0,
    "loss": 10.815146446228027,
    "logits": [
        [0, 0, 0, 0.6712658405303955], [0, 0, 1, 1.1410504579544067],
        [0, 0, 15999, -1.7576838731765747], [0, 0, 31999, 1.4409105777740479],
        [0, 1, 0, -0.3859884440898895], [0, 1, 1, 1.9796931743621826],
        [0, 1, 15999, -0.3091917335987091], [0, 1, 31999, 0.5858257412910461],
        [0, 64, 0, -0.5660134553909302], [0, 64, 1, 2.839251756668091],
        [0, 64, 15999, 0.8963364958763123],
        [0, 64, 31999, -1.3923943042755127],
        [0, 127, 0, 0.9991924166679382], [0, 127, 1, 1.6598496437072754],
        [0, 127, 15999, -0.5693889260292053],
        [0, 127, 31999, 0.41556504368782043],
    ],
}
DENSE_FULL = {"arch": "tinyllama-1.1b", "batch": 2, "seq": 4096, "seed": 1,
              "runs": 3}

#: [serve] (a): the JAX package's greedy decode (eager ``forward`` with a
#: float32 cache, ``attn_impl="chunked"``) of the port's seeded numpy recipe
#: weights in float32 (seed 0) at full width, layers 0-2, B=1, a 16-token
#: prompt drawn by numpy.random.default_rng(0), 8 tokens: each arch's tokens
#: and [step, vocabulary id, logit] at ids 0, 1, V/2 - 1, V - 1 and the
#: token picked; made on the CPU by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tools/serve_records.py
SERVE_RECORD = {
    "layers": 2, "batch": 1, "prompt": 16, "gen": 8,
    "seed": 0,
    "archs": {
        "tinyllama-1.1b": {
            "tokens": [19385, 17345, 23033, 23033, 9270, 18382, 1456, 23117],
            "logits": [
                [0, 0, -0.09123747795820236], [0, 1, 0.3629232943058014],
                [0, 15999, 1.3188098669052124],
                [0, 31999, -1.2313435077667236],
                [0, 19385, 3.8585352897644043], [1, 0, 0.24855493009090424],
                [1, 1, 1.1287550926208496], [1, 15999, 1.5670682191848755],
                [1, 31999, -2.073335647583008], [1, 17345, 3.7826037406921387],
                [2, 0, 0.5344075560569763], [2, 1, -0.17194993793964386],
                [2, 15999, 1.1726064682006836], [2, 31999, -1.124801754951477],
                [2, 23033, 4.102609634399414], [3, 0, -0.3699527084827423],
                [3, 1, 1.0329910516738892], [3, 15999, 2.2967331409454346],
                [3, 31999, -2.6048920154571533], [3, 23033, 4.229915142059326],
                [4, 0, -0.7000188827514648], [4, 1, 0.7658599615097046],
                [4, 15999, 2.3301055431365967],
                [4, 31999, -3.1734535694122314], [4, 9270, 3.963569164276123],
                [5, 0, -1.8560236692428589], [5, 1, 0.3670615255832672],
                [5, 15999, 1.5163583755493164],
                [5, 31999, -0.5158844590187073], [5, 18382, 3.911478042602539],
                [6, 0, -0.38066402077674866], [6, 1, 0.29278650879859924],
                [6, 15999, 0.8836110234260559],
                [6, 31999, -0.6195105910301208], [6, 1456, 4.133967876434326],
                [7, 0, -1.652590036392212], [7, 1, 0.2258222997188568],
                [7, 15999, 1.1803570985794067],
                [7, 31999, -1.8662647008895874], [7, 23117, 4.312603950500488],
            ],
        },
        "rwkv6-1.6b": {
            "tokens": [19680, 48891, 38757, 41216, 25320, 38025, 61519, 42070],
            "logits": [
                [0, 0, -1.262556791305542], [0, 1, -1.4548230171203613],
                [0, 32767, -0.251025915145874],
                [0, 65535, -0.8823198080062866], [0, 19680, 4.110400676727295],
                [1, 0, 0.2148725688457489], [1, 1, -0.2893804609775543],
                [1, 32767, -0.856128454208374], [1, 65535, -1.20017671585083],
                [1, 48891, 4.346399784088135], [2, 0, 0.2814742624759674],
                [2, 1, 0.24246729910373688], [2, 32767, 0.3741786777973175],
                [2, 65535, 0.2062566876411438], [2, 38757, 4.2520294189453125],
                [3, 0, 0.8409181237220764], [3, 1, 0.07124227285385132],
                [3, 32767, -1.147958755493164],
                [3, 65535, -1.4795690774917603], [3, 41216, 4.70811128616333],
                [4, 0, 1.0039544105529785], [4, 1, -1.5675451755523682],
                [4, 32767, -0.3644137382507324],
                [4, 65535, -1.3351086378097534], [4, 25320, 4.191018581390381],
                [5, 0, -0.6293029189109802], [5, 1, 0.7186969518661499],
                [5, 32767, -2.3126866817474365],
                [5, 65535, -0.2686547338962555],
                [5, 38025, 4.3736162185668945], [6, 0, -1.155954122543335],
                [6, 1, -0.9889763593673706], [6, 32767, -1.5021227598190308],
                [6, 65535, 1.3497062921524048], [6, 61519, 4.297268390655518],
                [7, 0, 1.2672464847564697], [7, 1, 0.40387511253356934],
                [7, 32767, -0.5662556886672974],
                [7, 65535, 0.07267521321773529], [7, 42070, 4.073941230773926],
            ],
        },
        "granite-moe-1b-a400m": {
            "tokens": [10534, 24424, 8729, 14998, 14998, 14998, 40740, 9681],
            "logits": [
                [0, 0, 1.0002717971801758], [0, 1, 0.8543857336044312],
                [0, 24576, 0.6275671124458313], [0, 49154, 0.529547393321991],
                [0, 10534, 4.2335286140441895], [1, 0, 0.8899856209754944],
                [1, 1, 0.34974074363708496], [1, 24576, 0.7085403800010681],
                [1, 49154, 0.22407382726669312],
                [1, 24424, 3.7594752311706543], [2, 0, 0.4280596971511841],
                [2, 1, 0.9133598804473877], [2, 24576, 0.7359110116958618],
                [2, 49154, -0.033283088356256485],
                [2, 8729, 4.096592903137207], [3, 0, 0.4659002423286438],
                [3, 1, 0.45809778571128845], [3, 24576, 1.0375478267669678],
                [3, 49154, 0.10242340713739395],
                [3, 14998, 3.8533217906951904], [4, 0, 0.8017266392707825],
                [4, 1, 0.475180447101593], [4, 24576, 0.6925418376922607],
                [4, 49154, 0.5884645581245422], [4, 14998, 3.974213123321533],
                [5, 0, 1.0515938997268677], [5, 1, 0.3051034212112427],
                [5, 24576, 0.7877378463745117], [5, 49154, 0.8066006898880005],
                [5, 14998, 3.8639392852783203], [6, 0, 1.2431914806365967],
                [6, 1, 0.2540797293186188], [6, 24576, 0.8795329928398132],
                [6, 49154, 0.8683710694313049], [6, 40740, 3.809196710586548],
                [7, 0, 0.9115217924118042], [7, 1, 0.8175631165504456],
                [7, 24576, 0.08683758974075317],
                [7, 49154, 0.35074523091316223], [7, 9681, 4.016693115234375],
            ],
        },
    },
}
#: [serve] (b) and (c): each arch at full width and depth through
#: ``repro_torch.launch.serve.serve``, B prompts of ``prompt`` tokens and
#: ``gen`` greedy tokens; weights and prompts drawn on the card from
#: ``seed``
SERVE = {"archs": ("tinyllama-1.1b", "rwkv6-1.6b", "granite-moe-1b-a400m"),
         "batch": 8, "prompt": 512, "gen": 64, "seed": 1}
#: [serve] (a): sampled logits within this of the record (tokens exact)
SERVE_RECORD_TOL = 1e-3
#: [serve] (c): float32 decode logits within this abs and rel of the
#: cache-less float32 forward over the served sequence
SERVE_F32_TOL = 1e-3
#: the token rule: a served token's logit in the cache-less forward lies
#: within this many times the step's decode-vs-recompute distance of its
#: row's largest logit (a near tie may flip a token, a wrong token may not)
SERVE_TOKEN_SLACK = 2.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


#: each phase's wall seconds, in the order the phases ran
WALLS = {}
#: the ``devices=None`` runs that [devices] holds its sharded runs to, by
#: the part that made them: "search a" (problem, kwargs, result, segred
#: launches), "fleet c" (plans, results, segred launches)
BASE = {}


class phase_wall:
    """``with phase_wall(name):`` records the block's wall seconds in
    ``WALLS`` and prints them."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            WALLS[self.name] = time.perf_counter() - self.t0
            say("wall", f"{self.name}: {WALLS[self.name]:.1f} s")


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_turns(fns, iters, rounds=5, warmup=5):
    """The median over ``rounds`` of ``cuda_ms`` for each of ``fns``, timed
    in turns (fn 0, fn 1, ..., then again), so that a slow stretch of the
    shared host, which sets the time of a call this small, falls on all of
    them alike."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            times[i].append(cuda_ms(fn, iters, warmup=warmup))
    return [sorted(t)[len(t) // 2] for t in times]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; python {sys.version.split()[0]}; "
                  f"visible cards {torch.cuda.device_count()}")
    print(smi_line, flush=True)
    return kind, smi_line


def _typed(lib, entry, argtypes):
    """``lib``'s C entry point ``entry``, typed."""
    import ctypes
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _wkv_step(fn, r, k, v, w, u):
    """One launch of the step-by-step yardstick's typed entry point."""
    import torch
    B, T, H, hs = r.shape
    out = torch.empty_like(r)
    if fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
          u.data_ptr(), out.data_ptr(), B, T, H, hs,
          torch.cuda.current_stream().cuda_stream):
        fail("the step-by-step wkv6 yardstick did not launch")
    return out


def phase_build():
    from repro_torch.core.accel import cuda_build, segred
    from repro_torch.kernels import rwkv6_scan
    t0 = time.perf_counter()
    libs = cuda_build.load_all(KERNELS + tuple(YARDSTICKS), YARDSTICKS)
    wall = time.perf_counter() - t0
    yardsticks = {
        "segred": {str(dt).replace("torch.", ""): _typed(
            libs["segred_first_design"], entry, segred._ARGTYPES)
            for dt, entry in segred._ENTRY.items()},
        "wkv6": _typed(libs["wkv6_step_design"], "wkv6_bf16",
                       rwkv6_scan._ARGTYPES)}
    for name in KERNELS + tuple(YARDSTICKS):
        info = cuda_build.BUILD_INFO[name]
        how = ("reused the library an earlier run built from the same source"
               if info["cached"] else f"nvcc {info['seconds']:.2f} s")
        say("build", f"{name}: {how} -> {info['path']}")
        function = ""
        for line in info["ptxas"].splitlines():
            if "Function properties for" in line:
                function = line.rsplit(" ", 1)[-1]
            if "ptxas" in line or "Used" in line or "spill" in line:
                say("build", f"  {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores", line)
            # the tensor-core kernels keep their fragments in registers
            if spill and int(spill.group(1)) and name in KERNELS and \
                    any(k in function for k in NO_SPILL):
                fail(f"ptxas spills {spill.group(1)} bytes in {function}")
    say("build", f"all kernels and the two yardsticks loaded in {wall:.2f} s "
                 f"(builds in parallel)")
    return ({name: dict(cuda_build.BUILD_INFO[name]) for name in KERNELS},
            yardsticks)


def _segred_inputs(N: int, n: int, dtype, seed: int):
    """Random positive node times and random monotone partition ids; row 0
    is one segment, row 1 has every node in its own segment, row 4 holds a
    NaN and row 5 tied maxima (where the rows and nodes exist), the rest
    cut with probabilities that vary by row, so most rows leave trailing
    segments empty (they must hold the identity)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    vals = rng.random((N, n)) + 1e-3
    prob = rng.random((N, 1))
    cuts = rng.random((N, n - 1)) < prob
    cuts[0] = False
    if N > 1:
        cuts[1] = True
    if N > 5 and n > 2:
        vals[4, n // 2] = np.nan
        vals[5] = np.round(vals[5] * 4) / 4      # few distinct values: ties
    pid = np.concatenate([np.zeros((N, 1), np.int64),
                          np.cumsum(cuts, axis=1)], axis=1)
    return (torch.from_numpy(vals).to("cuda", dtype),
            torch.from_numpy(pid).to("cuda"))


def _bitwise_equal(got, want):
    """The same NaN positions, and every other element bit for bit."""
    import torch
    nan = torch.isnan(want)
    ints = torch.int32 if got.dtype == torch.float32 else torch.int64
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(ints)[~nan], want.view(ints)[~nan])


def _segred_first(fn, vals, pid, op):
    """One call of segred's first design (typed entry ``fn``) with the
    wrapper's host work, so that the two designs' calls differ only in
    their kernels."""
    import torch
    from repro_torch.core.accel import segred
    segred._check(vals, pid, op)
    out = torch.empty_like(vals)
    N, n = vals.shape
    if fn(vals.data_ptr(), pid.data_ptr(), out.data_ptr(), N, n,
          segred.OPS[op], torch.cuda.current_stream().cuda_stream):
        fail("segred's first design did not launch")
    return out


def phase_kernels(yardsticks):
    import torch
    from repro_torch.core.accel import segred
    rows = []
    for N, n in SEGRED_SHAPES:
        for dtype in (torch.float32, torch.float64):
            vals, pid = _segred_inputs(N, n, dtype, seed=N + n)
            dname = str(dtype).replace("torch.", "")
            esize = vals.element_size()
            first = yardsticks["segred"][dname]

            for op in ("max", "sum"):
                got = segred.segmented_reduce(vals, pid, op)
                want = segred.segmented_reduce_plain(vals, pid, op)
                torch.cuda.synchronize()
                if not _bitwise_equal(got, want):
                    fail(f"segred {op} {dname} [{N},{n}] not bitwise equal "
                         f"to the plain version")
                err = float((got - want).abs().nan_to_num(0.0).max())
                ident = -torch.inf if op == "max" else 0.0
                lib_op = "amax" if op == "max" else "sum"
                iters = 200 if N < 1000 else 50
                # the kernel, its first design and the library call in
                # turns on the same inputs
                ms, old_ms, library_ms = cuda_ms_turns([
                    lambda: segred.segmented_reduce(vals, pid, op),
                    lambda: _segred_first(first, vals, pid, op),
                    lambda: torch.full_like(vals, ident).scatter_reduce_(
                        1, pid, vals, lib_op, include_self=True)], iters)
                plain_ms = cuda_ms(
                    lambda: segred.segmented_reduce_plain(vals, pid, op),
                    iters)
                # each input read once (vals + pid), the output written once
                nbytes = N * n * (esize + 8) + N * n * esize
                ops = N * n                  # one max/add per input element
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
                row = {"N": N, "n": n, "dtype": dname, "op": op,
                       "max_abs_err": err, "ms": ms,
                       "first_design_ms": old_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations", "bytes": nbytes, "ops": ops}
                rows.append(row)
                say("kernels", f"segred {op} {dname} [{N},{n}]: ok, bitwise "
                               f"equal; kernel {ms:.5f} ms, first design "
                               f"{old_ms:.5f} ms (medians in turns), plain "
                               f"{plain_ms:.5f} ms, scatter_reduce "
                               f"{library_ms:.5f} ms, bound "
                               f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


def _wkv_inputs(shape, w_range, dtype, seed):
    """(B, T, H, hs) r, k, v ~ N(0, 0.25) in ``dtype``, float32 w uniform
    in ``w_range`` and u ~ N(0, 0.01) of shape (H, hs), drawn on the card
    from ``seed``. ``w_range`` "zeros" or "tiny" puts a third of the
    multipliers at exactly 0 or near 1e-30, the rest in [0.55, 0.95];
    "model" draws the model's own decay, exp(-exp(-4 + 0.01 x)), about
    0.98 (models/rwkv.py)."""
    import torch
    B, T, H, hs = shape
    g = torch.Generator("cuda").manual_seed(seed)

    def normal(*size):
        return torch.randn(size, generator=g, device="cuda")

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B, T, H, hs), generator=g,
                                           device="cuda")

    r, k, v = (0.5 * normal(B, T, H, hs) for _ in range(3))
    if w_range == "model":
        w = torch.exp(-torch.exp(-4.0 + 0.01 * normal(B, T, H, hs)))
    elif isinstance(w_range, str):
        edge = {"zeros": 0.0, "tiny": 1e-30}[w_range]
        w = torch.where(uniform(0.0, 1.0) < 1 / 3, edge * uniform(1.0, 2.0),
                        uniform(0.55, 0.95))
    else:
        w = uniform(*w_range)
    u = 0.1 * normal(H, hs)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u


def _wkv_bound(shape, dtype):
    """The least time for the function on this card: each input read once
    and the output written once (r, k, v, out in their dtype, w and u in
    float32), and about 4*hs operations per (token, channel) — two
    multiply-adds of the readout and two of the state update — at the
    card's peak for the inputs' type: bfloat16 on the tensor cores (where
    the chunked kernel runs its products), float32 on the CUDA cores."""
    import torch
    B, T, H, hs = shape
    n = B * T * H * hs
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = n * (4 * esize + 4) + H * hs * 4
    ops = n * 4 * hs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _limit_used(got, want, tol, slack):
    """The largest share of its limit any output element uses (<= 1
    holds): ``tol`` abs and rel, and in bfloat16 also one rounding step,
    BF16_STEP of |want| plus the absolute ``slack``."""
    import torch
    gf, wf = got.float(), want.float()
    diff, mag = (gf - wf).abs(), wf.abs()
    used = float((diff / (tol * (1 + mag))).max())
    if got.dtype == torch.bfloat16:
        used = max(used, float((diff / (BF16_STEP * mag + max(slack, 1e-30)))
                               .max()))
    return used


def _wkv_limit_used(got, want):
    """``_limit_used`` at WKV_TOL and, in bfloat16, WKV_BF16_SLACK of max
    |want|."""
    dname = str(got.dtype).replace("torch.", "")
    return _limit_used(got, want, WKV_TOL[dname],
                       WKV_BF16_SLACK * float(want.float().abs().max()))


def phase_wkv6(yardsticks):
    import torch
    from repro_torch.kernels import rwkv6_scan
    step = yardsticks["wkv6"]
    checks = [(shape, w, dtype) for shape, w in WKV_CHECKS
              for dtype in (torch.float32, torch.bfloat16)]
    checks += [(WKV_LM_SHAPE, (0.55, 0.95), torch.bfloat16),
               (WKV_LM_SHAPE, (0.55, 0.95), torch.float32)]
    rows = []
    for i, (shape, w_range, dtype) in enumerate(checks):
        args = _wkv_inputs(shape, w_range, dtype, seed=100 + i)
        got = rwkv6_scan.wkv6(*args)
        want = rwkv6_scan.wkv6_plain(*args)
        torch.cuda.synchronize()
        dname = str(dtype).replace("torch.", "")
        tol = WKV_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        used = _wkv_limit_used(got, want)
        if got.dtype != dtype or not bool(torch.isfinite(got).all()) or \
                not used <= 1.0:
            fail(f"wkv6 {dname} {shape} w in {w_range}: max abs err {err:.3g}"
                 f", {used:.3g} of the limit ({tol} abs and rel"
                 f"{'' if dname == 'float32' else '; one rounding step'}) "
                 f"of the plain version")
        big = shape[1] >= 1024
        iters = 20 if big else 200
        old_ms = None
        if dtype == torch.bfloat16:
            # and the step kernel this one replaced, in turns on the same
            # inputs
            ms, old_ms = cuda_ms_turns(
                [lambda: rwkv6_scan.wkv6(*args),
                 lambda: _wkv_step(step, *args)], iters, rounds=3)
        else:
            ms, = cuda_ms_turns([lambda: rwkv6_scan.wkv6(*args)], iters,
                                rounds=3)
        plain_ms = cuda_ms(lambda: rwkv6_scan.wkv6_plain(*args),
                           2 if big else 5, warmup=1)
        row = {"shape": list(shape),
               "w_range": w_range if isinstance(w_range, str)
               else list(w_range),
               "dtype": dname, "max_abs_err": err, "limit_used": used,
               "ms": ms, "step_kernel_ms": old_ms,
               "plain_ms": plain_ms, "library_ms": None,
               **_wkv_bound(shape, dtype)}
        rows.append(row)
        old = "" if old_ms is None else \
            f", step kernel {old_ms:.5f} ms (medians in turns)"
        say("kernels", f"wkv6 {dname} (B,T,H,hs)={shape} w {w_range}: ok, "
                       f"max abs err {err:.3g} ({used:.3g} of the limit); "
                       f"kernel {ms:.5f} ms{old}, plain {plain_ms:.3f} ms, "
                       f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
                       f"no single library call")
    return rows


def _flash_inputs(shape, dtype, seed):
    """q (B, Sq, H, dh) and k, v (B, Skv, Hkv, dh), standard normal in
    ``dtype``, drawn on the card from ``seed``."""
    import torch
    B, Sq, Skv, H, Hkv, dh = shape
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                           (B, Skv, Hkv, dh)))


def _flash_bound(shape, dtype, causal):
    """The least time for the function on this card: q, k, v read once and
    the output written once; 4*dh operations (two multiply-adds of q.k and
    of p.v per head dimension) for each (query, key) pair the mask lets
    through, at the input type's peak rate (bf16 on the tensor cores).
    ``cuda_core_ms`` is the same operations at the float32 rate of the CUDA
    cores, the floor of the float32 kernel, which computes there."""
    import torch
    B, Sq, Skv, H, Hkv, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * dh * (2 * Sq * H + 2 * Skv * Hkv)
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    ops = 4 * dh * pairs * B * H
    dname = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "cuda_core_ms": ops / PEAK_OPS_PER_S["float32"] * 1e3,
            "bytes": nbytes, "ops": ops}


def _flash_limit_used(got, want, v):
    """``_limit_used`` at FLASH_TOL and, in bfloat16, FLASH_BF16_SLACK of
    max |v|."""
    dname = str(got.dtype).replace("torch.", "")
    return _limit_used(got, want, FLASH_TOL[dname],
                       FLASH_BF16_SLACK * float(v.float().abs().max()))


def phase_flash():
    """flash_attn against its plain version (``ref.attention``) on the JAX
    kernel test's grid and the dense LM's shape; CUDA-event times of the
    kernel, the plain version and ``scaled_dot_product_attention`` (one
    PyTorch call of the same function, timed here only: the port never
    calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    checks = [(shape, dtype, causal) for shape in FLASH_SHAPES
              for dtype in (torch.float32, torch.bfloat16)
              for causal in (True, False)
              if not (causal and shape[1] != shape[2])]
    checks += [(shape, dtype, True) for shape in FLASH_DEEP_SHAPES
               for dtype in (torch.float32, torch.bfloat16)]
    checks += [(FLASH_LM_SHAPE, torch.bfloat16, True),
               (FLASH_LM_SHAPE, torch.float32, True)]
    rows = []
    for i, (shape, dtype, causal) in enumerate(checks):
        q, k, v = _flash_inputs(shape, dtype, seed=200 + i)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        dname = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        used = _flash_limit_used(got, want, v)
        if got.dtype != dtype or not bool(torch.isfinite(got).all()) or \
                not used <= 1.0:
            fail(f"flash_attn {dname} {shape} causal={causal}: max abs err "
                 f"{err:.3g}, {used:.3g} of the limit ({tol} abs and rel"
                 f"{'' if dname == 'float32' else '; one rounding step'}) "
                 f"of the plain version")
        del got, want
        big = shape[1] >= 1024
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # the kernel and the library call in turns on the same inputs
        ms, library_ms = cuda_ms_turns([
            lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)],
            10 if big else 100, rounds=3, warmup=2 if big else 5)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            3 if big else 50, warmup=1 if big else 5)
        row = {"shape": list(shape), "dtype": dname, "causal": causal,
               "max_abs_err": err, "limit_used": used, "ms": ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms,
               **_flash_bound(shape, dtype, causal)}
        rows.append(row)
        say("kernels", f"flash_attn {dname} (B,Sq,Skv,H,Hkv,dh)={shape} "
                       f"causal={causal}: ok, max abs err {err:.3g} ({used:.3g} "
                       f"of the limit); kernel "
                       f"{ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
                       f"{library_ms:.5f} ms, bound {row['bound_ms']:.5f} ms "
                       f"({row['bound_by']}; float32 CUDA cores "
                       f"{row['cuda_core_ms']:.5f} ms)")
        torch.cuda.empty_cache()
    return rows


def _history(points):
    return [(int(x), float(y)) for x, y in points]


def phase_main():
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core import pipeline
    from repro_torch.core.platform import V5E_POD

    arch = get_arch("tinyllama-1.1b")
    shape = SHAPES_BY_NAME["train_4k"]
    launches = 0
    runs, results = [], {}
    for req in REQUESTS:
        em, obj = req["exec_model"], req["objective"]
        tag = f"{em}/{obj}"
        problem = pipeline.make_problem(arch, shape, V5E_POD, "spmd", obj, em)
        ref = pipeline.OPTIMIZERS["rule_based"](
            pipeline.make_problem(arch, shape, V5E_POD, "spmd", obj, em),
            engine="numpy")
        # the timed run is the optimiser's own call; optimise_mapping's plan
        # for the same request must be this run's
        plan, got, wall, n_launch = _timed_search(problem, "rule_based")
        _check_entry_point(f"[main] {tag}", plan, "rule_based", {},
                           arch=arch, shape=shape, platform=V5E_POD,
                           backend="spmd", objective=obj, exec_model=em)
        points, history = got.points, _history(got.history)
        if n_launch <= 0:
            fail(f"{tag}: the main path launched the segred kernel 0 times")
        if (points, got.history, got.variables) != \
                (ref.points, ref.history, ref.variables):
            fail(f"{tag}: points/history/design {points}/{history} differ "
                 f"from the numpy engine's {ref.points}/"
                 f"{_history(ref.history)}")
        if plan.objective_value != ref.evaluation.objective:
            fail(f"{tag}: objective {plan.objective_value!r} != numpy "
                 f"engine's {ref.evaluation.objective!r}")
        if (points, plan.objective_value, len(plan.partitions),
                len(history)) != (req["points"], req["value"],
                                  req["partitions"], req["history"]):
            fail(f"{tag}: ({points}, {plan.objective_value!r}, "
                 f"{len(plan.partitions)}, {len(history)}) differs from the "
                 f"JAX package's ({req['points']}, {req['value']!r}, "
                 f"{req['partitions']}, {req['history']})")
        launches += n_launch
        results[tag] = got
        runs.append({"request": tag, "points": points,
                     "objective": plan.objective_value,
                     "partitions": len(plan.partitions),
                     "history": history, "wall_s": wall,
                     "segred_launches": n_launch})
        say("main", f"{tag}: {points} points, objective "
                    f"{plan.objective_value!r}, {len(plan.partitions)} "
                    f"partitions, history {len(history)}; equal to numpy "
                    f"engine and JAX record, and to optimise_mapping's plan; "
                    f"wall {wall:.3f} s; segred launches {n_launch}")
    return runs, launches, results


def _timed_search(problem, optimiser, **kw):
    """One call of the optimiser's entry point with the torch engine on
    the card: (plan, result, wall seconds, segred launches). The launch
    count is set to 0 just before the call and read just after it; the
    wall time ends in ``torch.cuda.synchronize()``. The plan is
    ``export_plan`` of the result, as ``optimise_mapping`` makes it."""
    import torch
    from repro_torch.core.accel import segred
    from repro_torch.core.exporter import export_plan
    from repro_torch.core.optimizers import OPTIMIZERS
    torch.cuda.synchronize()
    segred.LAUNCHES = 0
    t0 = time.perf_counter()
    result = OPTIMIZERS[optimiser](problem, engine="torch", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segred.LAUNCHES
    plan = export_plan(problem.graph, result.variables, problem.platform,
                       problem.exec_model, result.evaluation)
    return plan, result, wall, launches


def _check_entry_point(label, plan, optimiser, req_kw, **kw):
    """``optimise_mapping`` with the torch engine on the card must return
    the plan of the optimiser's own call."""
    from repro_torch.core import pipeline
    got = pipeline.optimise_mapping(optimiser=optimiser, engine="torch",
                                    **kw, **req_kw)
    if got != plan:
        fail(f"{label}: optimise_mapping's plan (objective "
             f"{got.objective_value!r}) differs from the optimiser's "
             f"({plan.objective_value!r})")


def _design(v):
    return (tuple(v.cuts), list(v.s_in), list(v.s_out), list(v.kern))


def _same_history(got, want):
    """History indices equal, objectives at the float32 contract."""
    return [i for i, _ in got] == [i for i, _ in want] and all(
        abs(a - b) <= F32_RTOL * abs(b) for (_, a), (_, b) in zip(got, want))


def _search_bf(req, arch, shape, smi_line):
    from repro_torch.core import pipeline
    from repro_torch.core.platform import V5E_POD
    tag = (f"({req['name']}) brute force {req['backend']} "
           f"{req['exec_model']}/{req['objective']}")
    problem = pipeline.make_problem(arch, shape, V5E_POD, req["backend"],
                                    req["objective"], req["exec_model"])
    t0 = time.perf_counter()
    ref = pipeline.OPTIMIZERS["brute_force"](problem, engine="numpy",
                                             **req["kw"])
    numpy_wall = time.perf_counter() - t0
    plan, got, wall, n_launch = _timed_search(problem, "brute_force",
                                              **req["kw"])
    _check_entry_point(f"[search] {tag}", plan, "brute_force", req["kw"],
                       arch=arch,
                       shape=shape, platform=V5E_POD, backend=req["backend"],
                       objective=req["objective"],
                       exec_model=req["exec_model"])
    if (got.points, _design(got.variables)) != \
            (ref.points, _design(ref.variables)) or \
            not _same_history(got.history, ref.history) or \
            plan.objective_value != ref.evaluation.objective:
        fail(f"[search] {tag}: {got.points} points, history "
             f"{_history(got.history)}, objective {plan.objective_value!r} "
             f"differ from the numpy engine's {ref.points}, "
             f"{_history(ref.history)}, {ref.evaluation.objective!r}")
    if (got.points, plan.objective_value, _design(got.variables)) != \
            (req["points"], req["value"], req["variables"]) or \
            not _same_history(got.history, req["history"]):
        fail(f"[search] {tag}: ({got.points}, {plan.objective_value!r}, "
             f"{_history(got.history)}) differs from the JAX record "
             f"({req['points']}, {req['value']!r}, {req['history']})")
    if req["segred"] and n_launch <= 0:
        fail(f"[search] {tag}: the cut sets with a cut launched segred 0 "
             f"times")
    if not req["segred"] and n_launch:
        fail(f"[search] {tag}: the single-partition path launched segred "
             f"{n_launch} times")
    BASE[f"search {req['name']}"] = (problem, req["kw"], got, n_launch)
    row = {"request": tag, "points": got.points,
           "objective": plan.objective_value,
           "history": _history(got.history), "wall_s": wall,
           "points_per_s": got.points / wall, "segred_launches": n_launch,
           "numpy_wall_s": numpy_wall,
           "numpy_points_per_s": ref.points / numpy_wall, "device": smi_line}
    say("search", f"{tag}: {got.points} points, objective "
                  f"{plan.objective_value!r}, history {len(got.history)}; "
                  f"equal to the numpy engine and the JAX record; wall "
                  f"{wall:.3f} s, {row['points_per_s']:.0f} points/s (numpy "
                  f"engine {numpy_wall:.3f} s, "
                  f"{row['numpy_points_per_s']:.0f} points/s); segred "
                  f"launches {n_launch}"
                  + ("" if n_launch else " (one partition: no segmented "
                                         "reduction)") + f"; {smi_line}")
    return row


def _sa_start(problem, dev, dtype):
    """A DeviceSA on ``dev`` in ``dtype``, the repaired start design and
    its evaluation, the objective scale and the ladder, as
    ``annealing._optimise_torch`` makes them."""
    import torch
    from repro_torch.core.accel.search_loops import DeviceSA
    from repro_torch.core.optimizers.annealing import LADDER_SPREAD, _scale_for
    from repro_torch.core.optimizers.common import repair
    sa = DeviceSA(problem, device=dev, dtype=dtype)
    v0 = repair(problem, problem.backend.initial(problem.graph))
    ev0 = problem.evaluate(v0)
    temps = torch.tensor([1000.0 * LADDER_SPREAD ** c
                          for c in range(SEARCH_SA["chains"])],
                         dtype=dtype, device=dev)
    return sa, v0, ev0, _scale_for(ev0, None), temps


def _sa_float64_card_vs_cpu(problem, tag):
    """The same float64 draws (from a CPU generator) on the card and on
    the CPU, sweep by sweep over the whole schedule: the chains' folds,
    cuts and feasibility equal after every sweep, their objectives within
    1e-9; each incumbent equal, or tied with the other device's in the
    float64 re-evaluation (a tie that the last bit of a sum can break
    either way). Returns the number of such ties."""
    import numpy as np
    import torch
    from repro_torch.core.accel.search_loops import SweepDraws, sa_draws
    C, n = SEARCH_SA["chains"], len(problem.graph.nodes)
    runs = {}
    for dev in ("cuda", "cpu"):
        sa, v0, ev0, scale, temps = _sa_start(problem, dev, torch.float64)
        runs[dev] = [sa, sa.init_state(v0, ev0, C, 0), temps]
    gen = torch.Generator().manual_seed(7)
    bev = problem.batched()
    names = ("best_si", "best_so", "best_kk", "best_cb")
    ties = 0
    for k in range(SEARCH_SA["sweeps"]):
        dr = sa_draws(gen, C, n, torch.float64)
        st = {}
        for dev, run in runs.items():
            sa, state, temps = run
            state, temps, _ = sa.run(state, temps, scale, 0.98, 1.0, 1,
                                     draws=[SweepDraws(*(x.to(dev)
                                                         for x in dr))])
            run[1], run[2] = state, temps
            st[dev] = {key: v.cpu().numpy() for key, v in state.items()
                       if key != "gen"}
        a, b = st["cuda"], st["cpu"]
        for name in ("si", "so", "kk", "cb", "feas", "best_feas"):
            if not np.array_equal(a[name], b[name]):
                fail(f"[search] {tag}: float64 {name} on the card differs "
                     f"from the CPU's after sweep {k}")
        for name in ("obj", "best_obj"):
            if not np.allclose(a[name], b[name], rtol=1e-9, atol=0.0):
                fail(f"[search] {tag}: float64 {name} on the card differs "
                     f"from the CPU's by more than 1e-9 after sweep {k}")
        differ = np.zeros(C, bool)
        for name in names:
            differ |= (a[name] != b[name]).any(axis=1)
        rows = np.nonzero(differ)[0]
        if len(rows):
            ra = bev.evaluate_batch(*(a[x][rows] for x in names))
            rb = bev.evaluate_batch(*(b[x][rows] for x in names))
            if not (np.array_equal(ra.feasible, rb.feasible) and np.allclose(
                    ra.objective, rb.objective, rtol=1e-12, atol=0.0)):
                fail(f"[search] {tag}: float64 incumbents of chains "
                     f"{rows.tolist()} differ between card and CPU after "
                     f"sweep {k}, and not by a tie")
            ties += len(rows)
    return ties


def _search_sa(em, obj, arch, shape, smi_line):
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.core.optimizers.common import incumbent_better
    from repro_torch.core.platform import V5E_POD
    tag = f"(c) annealing {SEARCH_SA['backend']} {em}/{obj}"
    problem = pipeline.make_problem(arch, shape, V5E_POD,
                                    SEARCH_SA["backend"], obj, em)
    seed, other = SEARCH_SA["seeds"]
    kw = dict(chains=SEARCH_SA["chains"])
    plan, r1, wall, n_launch = _timed_search(problem, "annealing", seed=seed,
                                             **kw)
    _check_entry_point(f"[search] {tag}", plan, "annealing",
                       dict(kw, seed=seed),
                       arch=arch, shape=shape, platform=V5E_POD,
                       backend=SEARCH_SA["backend"], objective=obj,
                       exec_model=em)
    _, r2, _, _ = _timed_search(problem, "annealing", seed=seed, **kw)
    _, r3, _, _ = _timed_search(problem, "annealing", seed=other, **kw)
    points = SEARCH_SA["chains"] * SEARCH_SA["sweeps"]
    if r1.points != points:
        fail(f"[search] {tag}: {r1.points} points, not {points}")
    if (_design(r2.variables), r2.history, r2.points) != \
            (_design(r1.variables), r1.history, r1.points):
        fail(f"[search] {tag}: two runs with seed {seed} differ")
    if (_design(r3.variables), r3.history) == \
            (_design(r1.variables), r1.history):
        fail(f"[search] {tag}: seed {other} walked seed {seed}'s path")
    if n_launch <= 0:
        fail(f"[search] {tag}: the sweeps launched segred 0 times")
    ev = r1.evaluation                 # the float64 scalar reference's
    last = r1.history[-1][1]
    if ev.feasible and abs(last - ev.objective) > F32_RTOL * abs(ev.objective):
        fail(f"[search] {tag}: the incumbent's float32 objective {last!r} "
             f"is not the reference's {ev.objective!r}")

    # the same schedule straight through DeviceSA.run with every host sync
    # an error; its incumbent is the optimiser's
    sa, v0, ev0, scale, temps = _sa_start(problem, "cuda", torch.float32)
    state = sa.init_state(v0, ev0, SEARCH_SA["chains"], seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, temps, _ = sa.run(state, temps, scale, 0.98, 1.0,
                                 SEARCH_SA["sweeps"])
    except RuntimeError as err:
        fail(f"[search] {tag}: a sweep synchronised with the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    best = None
    for v, o, f in sa.best_variables(state):
        if best is None or incumbent_better(f, o, best[2], best[1]):
            best = (v, o, f)
    if _design(best[0]) != _design(r1.variables):
        fail(f"[search] {tag}: the sync-free run's incumbent differs from "
             f"the optimiser's")
    # every chain's incumbent, feasible or not, re-evaluated in float64 by
    # the numpy engine: feasibility equal, the card's float32 objective at
    # the float32 contract
    bev = problem.batched()
    chains = sa.best_variables(state)
    want = bev.evaluate_batch(*bev.pack([v for v, _, _ in chains]))
    objs = np.array([o for _, o, _ in chains])
    feas = np.array([f for _, _, f in chains])
    if not np.array_equal(feas, want.feasible):
        fail(f"[search] {tag}: the incumbents' feasibility on the card "
             f"differs from the numpy engine's in chains "
             f"{np.nonzero(feas != want.feasible)[0].tolist()}")
    rel = np.abs(objs - want.objective) / np.abs(want.objective)
    if not rel.max() <= F32_RTOL:
        fail(f"[search] {tag}: an incumbent's float32 objective is "
             f"{rel.max():.3g} from the numpy engine's float64 value "
             f"(chain {int(rel.argmax())}, limit {F32_RTOL})")
    ties = _sa_float64_card_vs_cpu(problem, tag)
    row = {"request": tag, "points": r1.points,
           "objective": plan.objective_value, "feasible": ev.feasible,
           "history": _history(r1.history), "wall_s": wall,
           "points_per_s": r1.points / wall, "segred_launches": n_launch,
           "float64_incumbent_ties": ties, "device": smi_line}
    say("search", f"{tag}: {r1.points} points, objective "
                  f"{plan.objective_value!r} (feasible {ev.feasible}), "
                  f"history {len(r1.history)}; seed {seed} twice identical, "
                  f"seed {other} another path; no host sync in "
                  f"{SEARCH_SA['sweeps']} sweeps; {len(chains)} incumbents "
                  f"equal to the numpy engine's float64 re-evaluation; "
                  f"float64 card equal to CPU "
                  f"over every sweep ({ties} incumbent ties); wall "
                  f"{wall:.3f} s, {row['points_per_s']:.0f} points/s; segred "
                  f"launches {n_launch}; {smi_line}")
    return row


def phase_search(smi_line):
    """Brute force and multi-chain SA through ``optimise_mapping`` on the
    card at full width (tinyllama-1.1b / train_4k / V5E_POD)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    arch = get_arch("tinyllama-1.1b")
    shape = SHAPES_BY_NAME["train_4k"]
    runs = [_search_bf(req, arch, shape, smi_line) for req in SEARCH_BF]
    runs += [_search_sa(req["exec_model"], req["objective"], arch, shape,
                        smi_line) for req in REQUESTS]
    return runs, sum(r["segred_launches"] for r in runs)


#: [fleet]: the ten registry archs at train_4k, platforms alternating
#: V5E_POD / V5E_2POD and objectives alternating throughput / latency, one
#: portfolio a part through ``optimise_portfolio(engine="torch")``: (a)
#: rule-based on the spmd backend, streaming, with tinyllama-1.1b listed
#: twice (coalesced once), every arch at full width and at most ``layers``
#: decoder and encoder layers (a depth cut, so that the whole run keeps
#: to its time aim; ``tools/fleet_rb_depth.py`` times (a) at several
#: depths), every lane equal to the numpy engine and the ``torch_loop``
#: lanes to their per-problem torch run; (b) SA on the spmd
#: backend, 64 chains on the default schedule, at the same depth cut,
#: every lane equal to its per-problem torch run; (c) brute force on the megatron backend with cut
#: sets of one cut, ``max_points`` a problem, every lane equal to the numpy
#: engine and to its per-problem torch run
FLEET = {
    "shape": "train_4k",
    "rb": {"backend": "spmd", "exec_model": "streaming", "layers": 12,
           "duplicate": "tinyllama-1.1b",
           "torch_loop": ("llama3.2-1b", "tinyllama-1.1b",
                          "jamba-1.5-large-398b"), "kw": {}},
    "sa": {"backend": "spmd", "exec_model": "spmd", "layers": 12,
           "kw": {"seed": 0, "chains": 64}, "sweeps": 342},
    "bf": {"backend": "megatron", "exec_model": "spmd",
           "kw": {"include_cuts": True, "max_cuts": 1,
                  "max_points": 16384}},
}
#: N n^2 at most for segred's thread-an-output kernel (``csrc/segred.cu``)
SEGRED_OUTPUT_COMPARES = 1 << 22


def _fleet_specs(cfg, extra=()):
    """(arch name, platform name, objective) of each problem of a [fleet]
    part, in portfolio order."""
    from repro_torch.configs import ARCHS
    names = sorted(ARCHS) + list(extra)
    return [(n, ("V5E_POD", "V5E_2POD")[i % 2],
             ("throughput", "latency")[i % 2]) for i, n in enumerate(names)]


def _fleet_arch(cfg, name):
    """The registry arch ``name`` at full width, its depth cut to
    ``cfg["layers"]`` where that is set (decoder and encoder layers each
    at most that many; a hybrid keeps whole interleave periods)."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch(name)
    layers = cfg.get("layers")
    if not layers:
        return arch
    period = arch.attn_period
    keep = max(period, layers // period * period)
    return dataclasses.replace(
        arch, num_layers=min(arch.num_layers, keep),
        encoder_layers=min(arch.encoder_layers, layers))


def _fleet_problem(cfg, spec):
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.core import pipeline, platform
    name, plat, obj = spec
    return pipeline.make_problem(_fleet_arch(cfg, name),
                                 SHAPES_BY_NAME[FLEET["shape"]],
                                 getattr(platform, plat), cfg["backend"], obj,
                                 cfg["exec_model"])


def _numpy_reference(part, optimiser, spec):
    """The numpy engine's result for one [fleet] problem (run in a worker
    process): (points, history, design, objective)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core.optimizers import OPTIMIZERS
    cfg = FLEET[part]
    r = OPTIMIZERS[optimiser](_fleet_problem(cfg, spec), engine="numpy",
                              **cfg["kw"])
    return r.points, _history(r.history), _design(r.variables), \
        r.evaluation.objective


class References:
    """The numpy engine's runs that [fleet] (a), (c) and [comap] are held
    to, in spawned worker processes (at most 8). They start after the last
    timed run of [service] and run while the card does [lm] and
    [lm-dense], whose times are the card's; ``check`` waits for each and
    hands its results to its check. ``stop`` ends every worker."""

    def __init__(self):
        self.tasks = []

    def add(self, fn, args, check):
        """``check(results, seconds)`` gets ``[fn(*a) for a in args]``."""
        self.tasks.append((fn, args, check))

    def start(self):
        import multiprocessing
        self.t0 = time.perf_counter()
        self.pool = multiprocessing.get_context("spawn").Pool(
            min(8, sum(len(args) for _, args, _ in self.tasks)))
        self.jobs = [self.pool.starmap_async(fn, args)
                     for fn, args, _ in self.tasks]

    def check(self):
        for (_, _, check), job in zip(self.tasks, self.jobs):
            results = job.get(timeout=1200)
            check(results, time.perf_counter() - self.t0)

    def stop(self):
        self.pool.terminate()
        self.pool.join()


def _fleet_reference_check(row, tag, exact, specs, results):
    """The check of one [fleet] part against its lanes' numpy references."""
    def check(refs, seconds):
        for spec, r, (points, history, design, objective) in zip(
                specs, results, refs):
            same_hist = _history(r.history) == history if exact \
                else _same_history(r.history, history)
            if (r.points, _design(r.variables), r.evaluation.objective) != \
                    (points, design, objective) or not same_hist:
                fail(f"[fleet] {tag} {spec[0]}: {r.points} points, "
                     f"history {_history(r.history)} differ from the "
                     f"numpy engine's {points}, {history}")
        row["numpy_wall_s"] = seconds
        say("fleet", f"{tag} {row['optimiser']}: every one of the "
                     f"{len(specs)} lanes equal to the numpy engine "
                     f"(points, design, history"
                     + ("" if exact else " indices, objectives at "
                        f"{F32_RTOL}") + f"; the references ran in "
                     f"worker processes beside [lm] and [lm-dense], "
                     f"{seconds:.1f} s)")
    return check


def _timed_on_card(fn):
    """(fn(), wall seconds ending in a synchronize, segred launches, segred
    launches by [N, n]); the counts are set to 0 just before the call."""
    import torch
    from repro_torch.core.accel import segred
    torch.cuda.synchronize()
    segred.LAUNCHES = 0
    segred.SHAPES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, segred.LAUNCHES,
            dict(segred.SHAPES))


def _segred_routes(shapes):
    """'[N, n] x count (kernel)' for each launch shape."""
    return ", ".join(
        f"[{N}, {n}] x{c} ("
        f"{'staged' if N * n * n > SEGRED_OUTPUT_COMPARES else 'output'})"
        for (N, n), c in sorted(shapes.items()))


def _same_result(a, b):
    return (a.points, _design(a.variables), a.history,
            a.evaluation.objective) == (b.points, _design(b.variables),
                                        b.history, b.evaluation.objective)


def _fleet_part(part, optimiser, smi_line, extra=()):
    """One [fleet] part: ``optimise_portfolio`` timed on the card, its plans
    checked against its results; returns the row with the unique problems,
    their specs and results."""
    from repro_torch.core.accel import fleet
    from repro_torch.core.accel.lowering import problem_fingerprint
    from repro_torch.core.exporter import export_plan
    from repro_torch.obs import metrics
    cfg = FLEET[part]
    specs = _fleet_specs(cfg, extra)
    problems = [_fleet_problem(cfg, s) for s in specs]
    metrics.reset()
    results = []
    plans, wall, launches, shapes = _timed_on_card(
        lambda: _portfolio(cfg, specs, optimiser, results))
    BASE[f"fleet {part}"] = (plans, results, launches)
    coalesced = metrics.counter("pipeline.portfolio.coalesced").value
    first = {}
    for i, p in enumerate(problems):
        first.setdefault(problem_fingerprint(p), i)
    unique = sorted(first.values())
    if coalesced != len(problems) - len(unique):
        fail(f"[fleet] ({part}): pipeline.portfolio.coalesced is "
             f"{coalesced}, not {len(problems) - len(unique)}")
    for i, (p, r, plan) in enumerate(zip(problems, results, plans)):
        if r is not results[first[problem_fingerprint(p)]]:
            fail(f"[fleet] ({part}): {specs[i][0]} was searched again, "
                 f"not coalesced with its duplicate")
        if plan != export_plan(p.graph, r.variables, p.platform,
                               p.exec_model, r.evaluation):
            fail(f"[fleet] ({part}): the plan of {specs[i][0]} is not its "
                 f"result's")
    if launches <= 0:
        fail(f"[fleet] ({part}): the fleet launched segred 0 times")
    u_problems = [problems[i] for i in unique]
    buckets = fleet.bucket_indices(u_problems,
                                   tiered=optimiser == "brute_force")
    return {"part": part, "optimiser": optimiser, "problems": len(problems),
            "unique": len(unique), "buckets": len(buckets),
            "bucket_lists": buckets, "unique_problems": u_problems,
            "unique_specs": [specs[i] for i in unique],
            "results": [results[i] for i in unique], "wall_s": wall,
            "segred_launches": launches, "segred_shapes": shapes,
            "coalesced": coalesced,
            "points": sum(results[i].points for i in unique),
            "device": smi_line}


def _portfolio(cfg, specs, optimiser, results, **kw):
    """``optimise_portfolio`` with the torch engine over the problems of
    ``specs`` built as ``cfg`` says; ``results`` receives theirs."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.core import pipeline, platform
    return pipeline.optimise_portfolio(
        [_fleet_arch(cfg, n) for n, _, _ in specs],
        SHAPES_BY_NAME[FLEET["shape"]],
        [getattr(platform, pl) for _, pl, _ in specs],
        backend=cfg["backend"], optimiser=optimiser,
        objective=[o for _, _, o in specs], exec_model=cfg["exec_model"],
        engine="torch", results=results, **cfg["kw"], **kw)


def _fleet_loop(optimiser, problems, **kw):
    """The per-problem torch runs of ``problems`` on the card, each timed
    on its own: (results, wall, launches, each lane's wall)."""
    from repro_torch.core.optimizers import OPTIMIZERS
    out, walls, launches = [], [], 0
    for p in problems:
        r, wall, n, _ = _timed_on_card(
            lambda: OPTIMIZERS[optimiser](p, engine="torch", **kw))
        out.append(r)
        walls.append(wall)
        launches += n
    return out, sum(walls), launches, walls


def _fleet_report(row, loop_wall, loop_points, loop_launches, loop_lanes,
                  checks):
    row.update({"loop_wall_s": loop_wall, "loop_points": loop_points,
                "loop_segred_launches": loop_launches,
                "loop_lanes": loop_lanes,
                "points_per_s": row["points"] / row["wall_s"],
                "loop_points_per_s": loop_points / loop_wall})
    say("fleet", f"({row['part']}) {row['optimiser']}: {row['problems']} "
                 f"problems, {row['unique']} unique (coalesced "
                 f"{row['coalesced']}), {row['buckets']} bucket(s) "
                 f"{row['bucket_lists']}; {checks}; optimise_portfolio wall "
                 f"{row['wall_s']:.3f} s, {row['points']} points, "
                 f"{row['points_per_s']:.0f} points/s; per-problem loop of "
                 f"{loop_lanes} lane(s) {loop_wall:.3f} s, {loop_points} "
                 f"points, {row['loop_points_per_s']:.0f} points/s; segred "
                 f"launches {row['segred_launches']} (loop {loop_launches}): "
                 f"{_segred_routes(row['segred_shapes'])}; "
                 f"{row['device']}")
    row.pop("unique_problems")
    row["segred_shapes"] = {f"{N}x{n}": c
                            for (N, n), c in row["segred_shapes"].items()}
    return row


def _fleet_rb(smi_line, pending):
    """(a) rule-based: every lane equal to the numpy engine; the
    ``torch_loop`` lanes equal to their per-problem torch run; one
    evaluation of all lanes at the incumbent and one of all probes a step,
    one segred launch each."""
    cfg = FLEET["rb"]
    row = _fleet_part("rb", "rule_based", smi_line,
                      extra=(cfg["duplicate"],))
    lanes = [(p, r) for p, r in zip(row["unique_problems"], row["results"])
             if p.graph.arch_name in cfg["torch_loop"]]
    loop, loop_wall, loop_launches, lane_walls = _fleet_loop(
        "rule_based", [p for p, _ in lanes], **cfg["kw"])
    row["loop_lane_walls_s"] = {p.graph.arch_name: w
                                for (p, _), w in zip(lanes, lane_walls)}
    say("fleet", "(a) per-problem torch loop, each lane's wall: " + ", ".join(
        f"{p.graph.arch_name} ({len(p.graph.nodes)} nodes) {w:.3f} s"
        for (p, _), w in zip(lanes, lane_walls)))
    for (p, r), lp in zip(lanes, loop):
        if not _same_result(r, lp):
            fail(f"[fleet] (a) {p.graph.arch_name}: the fleet's result "
                 f"differs from the per-problem torch run's")
    pending.append((_numpy_reference,
                    [("rb", "rule_based", spec)
                     for spec in row["unique_specs"]],
                    _fleet_reference_check(row, "(a)", True,
                                           row["unique_specs"],
                                           row["results"])))
    sizes = sorted(row["segred_shapes"].items())
    if len(sizes) != 2 or sizes[0][1] != sizes[1][1] or \
            sizes[0][0][0] != row["unique"]:
        fail(f"[fleet] (a): segred launches "
             f"{_segred_routes(row['segred_shapes'])} are not one [P, n] "
             f"and one [P x probes, n] a step")
    row["steps"] = sizes[0][1]
    return _fleet_report(
        row, loop_wall, sum(r.points for r in loop), loop_launches,
        len(lanes), f"{len(lanes)} lanes bitwise their per-problem torch "
                    f"run; {row['steps']} lockstep steps, two launches "
                    f"each")


def _fleet_sa(smi_line):
    """(b) SA: every lane bitwise its per-problem torch run; one launch a
    sweep a bucket; each lane's incumbent re-evaluated in float64."""
    cfg = FLEET["sa"]
    row = _fleet_part("sa", "annealing", smi_line)
    unique, results = row["unique_problems"], row["results"]
    loop, loop_wall, loop_launches, _ = _fleet_loop("annealing", unique,
                                                    **cfg["kw"])
    for p, r, lp in zip(unique, results, loop):
        if not _same_result(r, lp):
            fail(f"[fleet] (b) {p.graph.arch_name}: the fleet's result "
                 f"differs from the per-problem torch run's")
        if r.points != cfg["kw"]["chains"] * cfg["sweeps"]:
            fail(f"[fleet] (b) {p.graph.arch_name}: {r.points} points")
        bev = p.batched()
        got = bev.evaluate_batch(*bev.pack([r.variables]))
        last = r.history[-1][1]
        if bool(got.feasible[0]) != r.evaluation.feasible or (
                r.evaluation.feasible and abs(last - got.objective[0])
                > F32_RTOL * abs(got.objective[0])):
            fail(f"[fleet] (b) {p.graph.arch_name}: the incumbent's "
                 f"float32 objective {last!r} / feasibility are not the "
                 f"numpy engine's {got.objective[0]!r}")
    if row["segred_launches"] != row["buckets"] * cfg["sweeps"]:
        fail(f"[fleet] (b): {row['segred_launches']} segred launches, not "
             f"one a sweep a bucket ({row['buckets'] * cfg['sweeps']})")
    return _fleet_report(row, loop_wall, sum(r.points for r in loop),
                         loop_launches, len(unique),
                         "every lane bitwise its per-problem torch run, "
                         "each incumbent the numpy engine's in float64; "
                         "one launch a sweep")


def _bf_bucket_rows(members, batch_size=4096):
    """A brute-force bucket's launch shape: (members x chunk rows, padded
    node count), the chunk being the bucket's largest cut set rounded up to
    a power of two, at most ``batch_size``."""
    import math
    per_set = max(math.prod(len(m) for m in p.backend.space(
        p.graph, p.platform)[1]) for p in members)
    rows = 1
    while rows < per_set:
        rows *= 2
    return (len(members) * min(batch_size, rows),
            max(len(p.graph.nodes) for p in members))


def _fleet_bf(smi_line, pending):
    """(c) brute force: every lane equal to the numpy engine and to its
    per-problem torch run; one launch a chunk of a cut set with a cut for
    the whole bucket."""
    cfg = FLEET["bf"]
    row = _fleet_part("bf", "brute_force", smi_line)
    unique, results = row["unique_problems"], row["results"]
    loop, loop_wall, loop_launches, _ = _fleet_loop("brute_force", unique,
                                                    **cfg["kw"])
    for p, r, lp in zip(unique, results, loop):
        if not _same_result(r, lp):
            fail(f"[fleet] (c) {p.graph.arch_name}: the fleet's result "
                 f"differs from the per-problem torch run's")
    pending.append((_numpy_reference,
                    [("bf", "brute_force", spec)
                     for spec in row["unique_specs"]],
                    _fleet_reference_check(row, "(c)", False,
                                           row["unique_specs"],
                                           row["results"])))
    # every launch serves a whole bucket: [members x chunk rows, n_pad]
    whole = {_bf_bucket_rows([unique[i] for i in b])
             for b in row["bucket_lists"]}
    if not set(row["segred_shapes"]) <= whole:
        fail(f"[fleet] (c): segred launches "
             f"{_segred_routes(row['segred_shapes'])} are not one a chunk "
             f"for a whole bucket ({sorted(whole)})")
    return _fleet_report(row, loop_wall, sum(r.points for r in loop),
                         loop_launches, len(unique),
                         "every lane bitwise its per-problem torch run; one "
                         "launch a chunk with a cut for a whole bucket")


def phase_fleet(smi_line, references):
    """``optimise_portfolio(engine="torch")`` over the ten registry archs
    at full width, for the three optimisers: (runs, segred launches); the
    numpy engine's references of (a) and (c) are added to
    ``references``."""
    pending, runs = [], []
    for part, run in (("a", lambda: _fleet_rb(smi_line, pending)),
                      ("b", lambda: _fleet_sa(smi_line)),
                      ("c", lambda: _fleet_bf(smi_line, pending))):
        with phase_wall(f"fleet ({part})"):
            runs.append(run())
    for task in pending:
        references.add(*task)
    return runs, sum(r["segred_launches"] for r in runs)


#: [comap]: two models served side by side on one pod, co-mapped by the
#: rule-based optimiser over the full menu of splits of the 16-row data
#: axis (15 splits x 2 nets = 30 lanes, at full width and depth, on
#: sub-meshes of 1 to 15 rows); the numpy engine's result for it (the
#: port's numpy engine run on a CPU, which is the JAX package's numpy
#: engine copied): split, points and the length of the history
COMAP = {"archs": ("tinyllama-1.1b", "llama3.2-1b"), "shape": "decode_32k",
         "backend": "spmd", "exec_model": "streaming",
         "optimiser": "rule_based", "objective": "weighted_throughput",
         "lanes": 30, "split": (12, 4), "points": 134803, "history": 5}

#: [service]: phase 4's two requests from ``threads`` threads of
#: ``submissions`` seeded submissions each; the late joiner enters the
#: streaming lockstep round after ``late_after_rounds`` rounds; the HTTP
#: requests use reduced nets at train_4k, and the co-mapping request pins
#: two splits
SERVICE = {"threads": 8, "submissions": 3,
           "late": ("streaming", "latency"), "late_after_rounds": 3,
           "http_shape": {"name": "train_4k", "seq_len": 4096,
                          "global_batch": 256, "mode": "train"},
           "http_splits": [[12, 4], [8, 8]]}


def _comap_kwargs():
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.core.platform import V5E_POD
    return dict(archs=list(COMAP["archs"]),
                shape=SHAPES_BY_NAME[COMAP["shape"]], platform=V5E_POD,
                backend=COMAP["backend"], exec_model=COMAP["exec_model"],
                optimiser=COMAP["optimiser"], objective=COMAP["objective"])


def _comap_fields(plan):
    """What [comap] compares: split, per-net designs and objectives,
    composite, points and history."""
    r = plan.result
    return {"split_index": plan.split_index, "split": tuple(plan.split),
            "feasible": plan.feasible, "objective": plan.objective_value,
            "points": r.points, "history": _history(r.history),
            "designs": [_design(x.variables) for x in r.per_net],
            "net_objectives": [p.objective_value for p in plan.plans]}


def _comap_reference():
    """The numpy engine's joint search of [comap] (run in a worker)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core import pipeline
    return _comap_fields(pipeline.optimise_comapping(**_comap_kwargs(),
                                                     engine="numpy"))


class _CountSteps:
    """``with _CountSteps() as steps:`` counts the rule-based descent's
    device steps (``search_loops._rb_step`` calls) in ``steps.n``."""

    def __enter__(self):
        from repro_torch.core.accel import search_loops
        self.n, self.body = 0, search_loops._rb_step

        def counted(*a, **k):
            self.n += 1
            return self.body(*a, **k)

        search_loops._rb_step = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core.accel import search_loops
        search_loops._rb_step = self.body


def phase_comap(smi_line, references):
    """``optimise_comapping(engine="torch")`` on the card: every lane of
    the joint search in one rule-based fleet call; the numpy engine's
    reference is added to ``references``."""
    from repro_torch.core import pipeline
    with _CountSteps() as steps:
        plan, wall, launches, shapes = _timed_on_card(
            lambda: pipeline.optimise_comapping(**_comap_kwargs(),
                                                engine="torch"))
    got = _comap_fields(plan)
    r = plan.result
    tag = (f"{' + '.join(COMAP['archs'])} at {COMAP['shape']} on V5E_POD, "
           f"{COMAP['exec_model']}/{COMAP['objective']}")
    if not plan.feasible or len(plan.plans) != len(COMAP["archs"]):
        fail(f"[comap] {tag}: infeasible or {len(plan.plans)} plans")
    for p, x in zip(plan.plans, r.per_net):
        if p.objective_value != x.evaluation.objective:
            fail(f"[comap] {p.arch_name}: the plan's objective "
                 f"{p.objective_value!r} is not its lane's "
                 f"{x.evaluation.objective!r}")
    if (got["split"], got["points"], len(got["history"])) != \
            (COMAP["split"], COMAP["points"], COMAP["history"]):
        fail(f"[comap] {tag}: split {got['split']}, {got['points']} points, "
             f"history {len(got['history'])}, not the numpy engine's "
             f"{COMAP['split']}, {COMAP['points']}, {COMAP['history']}")
    # two launches a lockstep step: [lanes, n] at the incumbents and
    # [lanes x probes, n]
    n_pad = max(len(g.nodes) for g in r.problem.graphs)
    if not 0 < launches == 2 * steps.n or \
            shapes.get((COMAP["lanes"], n_pad)) != steps.n or len(shapes) != 2:
        fail(f"[comap] {launches} segred launches "
             f"({_segred_routes(shapes)}) in {steps.n} lockstep steps: not "
             f"one [{COMAP['lanes']}, {n_pad}] and one [lanes x probes, "
             f"{n_pad}] a step")
    row = dict(got, request=tag, lanes=COMAP["lanes"], wall_s=wall,
               points_per_s=r.points / wall, steps=steps.n,
               segred_launches=launches,
               segred_shapes={f"{N}x{n}": c for (N, n), c in shapes.items()},
               device=smi_line)
    say("comap", f"{tag}: {COMAP['lanes']} lanes in one rule-based fleet "
                 f"call; split {got['split']}, {got['points']} points, "
                 f"composite {got['objective']!r}, history "
                 f"{len(got['history'])}; each plan's objective its lane's; "
                 f"{steps.n} lockstep steps, two launches each: "
                 f"{_segred_routes(shapes)}; wall {wall:.3f} s, "
                 f"{row['points_per_s']:.0f} points/s; {smi_line}")

    def check(refs, seconds):
        (want,) = refs
        for key in ("split_index", "split", "feasible", "objective",
                    "points", "history", "designs", "net_objectives"):
            if got[key] != want[key]:
                fail(f"[comap] {key} {got[key]!r} differs from the numpy "
                     f"engine's {want[key]!r}")
        row["numpy_wall_s"] = seconds
        say("comap", f"equal to the numpy engine: split, both nets' designs "
                     f"and objectives, composite, points and history (the "
                     f"reference ran in a worker process beside [lm] and "
                     f"[lm-dense], {seconds:.1f} s)")

    references.add(_comap_reference, [()], check)
    return row, launches


def _same_served(resp, want):
    r = resp.result
    return (_design(r.variables), r.evaluation.objective, r.points,
            list(r.history)) == (_design(want.variables),
                                 want.evaluation.objective, want.points,
                                 list(want.history)) and \
        resp.plan.objective_value == want.evaluation.objective


def _service_threads(arch, shape, direct):
    """8 threads x 3 seeded submissions of phase 4's two requests to one
    server: each response bitwise phase 4's direct run."""
    import random
    import threading
    from repro_torch.core.platform import V5E_POD
    from repro_torch.obs import metrics
    from repro_torch.service import MappingServer
    results, errors = [], []
    lock = threading.Lock()
    with MappingServer() as srv:
        def worker(tid):
            try:
                rng = random.Random(tid)
                for _ in range(SERVICE["submissions"]):
                    req = rng.choice(REQUESTS)
                    tag = f"{req['exec_model']}/{req['objective']}"
                    resp = srv.submit(
                        arch, shape, V5E_POD, backend="spmd",
                        optimiser="rule_based", objective=req["objective"],
                        exec_model=req["exec_model"],
                        engine="torch").result(timeout=900)
                    with lock:
                        results.append((tag, resp))
            except BaseException as e:      # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(SERVICE["threads"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        fail(f"[service] a submission failed: {errors[0]!r}")
    n = SERVICE["threads"] * SERVICE["submissions"]
    c = metrics.snapshot()["counters"]
    for tag, resp in results:
        if resp.engine != "torch" or not _same_served(resp, direct[tag]):
            fail(f"[service] a {tag} response differs from phase 4's "
                 f"direct run")
    tags = sorted({tag for tag, _ in results})
    # an engine run's leader is neither cached nor coalesced
    coalesced = sum(r.coalesced for _, r in results)
    cached = sum(r.cached and not r.coalesced for _, r in results)
    if len(results) != n or len(tags) != len(REQUESTS) or \
            c.get("service.engine_runs") != len(REQUESTS) or \
            c.get("service.requests.completed") != n or \
            coalesced + cached != n - len(REQUESTS):
        fail(f"[service] {len(results)} responses over {tags}, "
             f"{coalesced} coalesced and {cached} from the cache; counters "
             f"{c}: not {len(REQUESTS)} engine runs and the rest "
             f"coalesced or cached")
    if c.get("accel.dispatches.fleet_rb_descend") != c["service.rounds"]:
        fail(f"[service] {c.get('accel.dispatches.fleet_rb_descend')} "
             f"descent calls in {c['service.rounds']} lockstep rounds, not "
             f"one a round")
    return {"responses": n, "engine_runs": c["service.engine_runs"],
            "coalesced": coalesced, "cached": cached,
            "rounds": c["service.rounds"]}, None


def _service_late_joiner(arch, shape, direct):
    """Streaming/throughput in lockstep rounds, joined after a few rounds
    by streaming/latency: both bitwise their direct runs."""
    from repro_torch.core import pipeline
    from repro_torch.core.optimizers import OPTIMIZERS
    from repro_torch.core.platform import V5E_POD
    from repro_torch.obs import metrics
    from repro_torch.service import MappingServer
    em, obj = SERVICE["late"]
    first_tag = next(f"{r['exec_model']}/{r['objective']}" for r in REQUESTS
                     if r["exec_model"] == em)
    rounds = metrics.counter("service.rounds")
    with MappingServer() as srv:
        first = srv.submit(arch, shape, V5E_POD, backend="spmd",
                           optimiser="rule_based",
                           objective=first_tag.split("/")[1],
                           exec_model=em, engine="torch")
        while rounds.value < SERVICE["late_after_rounds"] and \
                not first.done():
            time.sleep(0.001)
        late = srv.submit(arch, shape, V5E_POD, backend="spmd",
                          optimiser="rule_based", objective=obj,
                          exec_model=em, engine="torch")
        r_first, r_late = first.result(900), late.result(900)
    c = metrics.snapshot()["counters"]
    if c.get("service.requests.late_joined") != 1 or \
            c.get("service.admissions") != 2 or \
            c.get("service.engine_runs") != 2:
        fail(f"[service] the {em}/{obj} request did not join the running "
             f"round: counters {c}")

    def verify():
        want = OPTIMIZERS["rule_based"](
            pipeline.make_problem(arch, shape, V5E_POD, "spmd", obj, em),
            engine="torch")
        if not _same_served(r_first, direct[first_tag]) or \
                not _same_served(r_late, want):
            fail(f"[service] with a late joiner, a response differs from "
                 f"its direct run")

    return {"late_joined": f"{em}/{obj}", "joined_after_rounds":
            SERVICE["late_after_rounds"], "rounds": c["service.rounds"],
            "restacks": c.get("service.rounds.restacks", 0),
            "late_points": r_late.result.points}, verify


def _post(base, route, body):
    import urllib.request
    req = urllib.request.Request(f"{base}{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.load(r)


def _service_http():
    """One POST /v1/mapping and one POST /v1/comap on 127.0.0.1 through
    ``serve_http``, reduced nets, each equal to the direct call."""
    import threading
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.service import MappingServer, serve_http
    sh = SERVICE["http_shape"]
    shape = ShapeSpec(sh["name"], sh["seq_len"], sh["global_batch"],
                      sh["mode"])
    names = COMAP["archs"]
    with MappingServer() as srv:
        httpd = serve_http(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            mapping = _post(base, "/v1/mapping", {
                "arch": names[0], "reduced": True, "shape": sh,
                "backend": "spmd", "optimiser": "rule_based",
                "objective": "throughput", "exec_model": "streaming",
                "engine": "torch"})
            comap = _post(base, "/v1/comap", {
                "archs": list(names), "reduced": True, "shape": sh,
                "backend": "spmd", "optimiser": "rule_based",
                "objective": COMAP["objective"],
                "exec_model": "streaming", "engine": "torch",
                "splits": SERVICE["http_splits"]})
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
    return {"mapping": {k: mapping[k] for k in ("objective_value", "points",
                                                 "partitions")},
            "comap": {k: comap[k] for k in ("split", "objective_value",
                                             "points")}}, \
        lambda: _service_http_verify(mapping, comap, shape)


def _service_http_verify(mapping, comap, shape):
    """The HTTP responses against the direct calls on the card."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import pipeline
    from repro_torch.core.optimizers import OPTIMIZERS
    from repro_torch.core.platform import V5E_POD
    names = COMAP["archs"]
    want = OPTIMIZERS["rule_based"](pipeline.make_problem(
        reduced(get_arch(names[0])), shape, V5E_POD, "spmd", "throughput",
        "streaming"), engine="torch")
    if (mapping["engine"], mapping["objective_value"], mapping["points"]) != \
            ("torch", want.evaluation.objective, want.points):
        fail(f"[service] POST /v1/mapping gave {mapping}, not the direct "
             f"run's objective {want.evaluation.objective!r} and "
             f"{want.points} points")
    plan = pipeline.optimise_comapping(
        [reduced(get_arch(n)) for n in names], shape, V5E_POD,
        backend="spmd", optimiser="rule_based", objective=COMAP["objective"],
        exec_model="streaming", engine="torch",
        splits=SERVICE["http_splits"])
    if (comap["split_index"], comap["split"], comap["objective_value"],
            comap["points"], [n["objective_value"] for n in comap["nets"]]) \
            != (plan.split_index, list(plan.split), plan.objective_value,
                plan.result.points, [p.objective_value for p in plan.plans]):
        fail(f"[service] POST /v1/comap gave {comap}, not the direct "
             f"optimise_comapping's split {plan.split} and objective "
             f"{plan.objective_value!r}")


def phase_service(smi_line, direct):
    """``repro_torch.service.MappingServer`` on the card, its responses
    held to phase 4's direct runs (``direct``, by request)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.obs import metrics
    arch, shape = get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"]
    row = {"device": smi_line}
    for part, run in (("threads", lambda: _service_threads(arch, shape,
                                                           direct)),
                      ("late joiner", lambda: _service_late_joiner(
                          arch, shape, direct)),
                      ("http", _service_http)):
        metrics.reset()
        with _CountSteps() as steps:
            (out, verify), wall, launches, shapes = _timed_on_card(run)
        if verify is not None:
            verify()
        if not 0 < launches == 2 * steps.n:
            fail(f"[service] {part}: {launches} segred launches in "
                 f"{steps.n} descent steps, not two a step")
        out.update(wall_s=wall, steps=steps.n, segred_launches=launches,
                   segred_shapes={f"{N}x{n}": c
                                  for (N, n), c in shapes.items()})
        row[part] = out
        say("service", f"{part}: {json.dumps(out)}")
    launches = sum(row[p]["segred_launches"]
                   for p in ("threads", "late joiner", "http"))
    say("service", f"every response bitwise its direct run; "
                   f"{row['threads']['responses']} threaded responses from "
                   f"{row['threads']['engine_runs']} engine runs "
                   f"({row['threads']['coalesced']} coalesced, "
                   f"{row['threads']['cached']} from the cache), "
                   f"{row['threads']['rounds']} lockstep rounds, one "
                   f"descent call each; segred launches {launches}, two a "
                   f"step; {smi_line}")
    return row, launches


#: [devices]: the device axis on the card, each part held bitwise to its
#: ``devices=None`` run in this process. (a) [search] (a) at each of
#: ``bf``; (b) [fleet] (c)'s portfolio at ``fleet_bf``; (c) SA on the
#: first three of [fleet] (b)'s archs, full width cut to ``layers``, its
#: schedule cut to 50 sweeps by ``cooling``; (d) [comap]'s pair, full
#: width cut to ``layers``, on two pinned splits; (e) a POST /v1/mapping
#: of brute force on the reduced tinyllama-1.1b, with and without
#: ``devices``
DEVICES = {
    "bf": (3, 8), "fleet_bf": 3,
    "sa": {"devices": 2, "lanes": 3, "layers": 4, "sweeps": 50,
           "kw": {"seed": 0, "chains": 16, "k_start": 1000.0, "k_min": 1.0,
                  "cooling": 0.87}},
    "comap": {"devices": 3, "layers": 4, "splits": [[12, 4], [8, 8]]},
    "http": {"devices": 2, "arch": "tinyllama-1.1b", "backend": "megatron",
             "exec_model": "spmd", "objective": "latency",
             "kw": {"include_cuts": True, "max_cuts": 2,
                    "max_points": 4096}},
}


def _mesh_line(D):
    """Each shard's device, in shard order."""
    from repro_torch.runtime import device_mesh
    return ", ".join(f"shard {d}: {dev}"
                     for d, dev in enumerate(device_mesh(D)))


def _devices_report(part, what, wall, launches, shapes, D, smi_line,
                    base_wall=None):
    row = {"part": part, "devices": D, "wall_s": wall,
           "segred_launches": launches,
           "segred_shapes": {f"{N}x{n}": c for (N, n), c in shapes.items()},
           "unsharded_wall_s": base_wall, "device": smi_line}
    say("devices", f"({part}) D = {D}: {what}; wall {wall:.3f} s"
                   + ("" if base_wall is None
                      else f" (devices=None {base_wall:.3f} s)")
                   + f"; segred launches {launches}: "
                   f"{_segred_routes(shapes)}; {_mesh_line(D)}; {smi_line}")
    return row


def _devices_bf(smi_line):
    """(a) [search] (a) at D shards: bitwise its own result; segred once a
    shard a chunk with a cut, at [B/D, n]."""
    import math
    from repro_torch.core.accel.search_loops import _pow2ceil
    from repro_torch.core.optimizers import OPTIMIZERS
    problem, kw, want, base = BASE["search a"]
    total = math.prod(len(m) for m in problem.backend.space(
        problem.graph, problem.platform)[1])
    rows = []
    for D in DEVICES["bf"]:
        got, wall, launches, shapes = _timed_on_card(
            lambda: OPTIMIZERS["brute_force"](problem, engine="torch",
                                              devices=D, **kw))
        if not _same_result(got, want):
            fail(f"[devices] (a) D = {D}: {got.points} points, history "
                 f"{_history(got.history)} differ from [search] (a)'s "
                 f"{want.points}, {_history(want.history)}")
        B = -(-min(kw.get("batch_size", 4096), _pow2ceil(total)) // D) * D
        n = len(problem.graph.nodes)
        if shapes != {(B // D, n): base * D}:
            fail(f"[devices] (a) D = {D}: segred launches "
                 f"{_segred_routes(shapes)}, not {base * D} at "
                 f"[{B // D}, {n}]")
        rows.append(_devices_report(
            "a", f"[search] (a), {got.points} points, B = {B}, bitwise "
                 f"its devices=None result", wall, launches, shapes, D,
            smi_line))
    return rows


def _devices_fleet_bf(smi_line):
    """(b) [fleet] (c)'s portfolio at D shards: every plan and result
    bitwise (c)'s; segred D times as often."""
    D = DEVICES["fleet_bf"]
    cfg = FLEET["bf"]
    want_plans, want, base = BASE["fleet bf"]
    got = []
    plans, wall, launches, shapes = _timed_on_card(
        lambda: _portfolio(cfg, _fleet_specs(cfg), "brute_force", got,
                           devices=D))
    if plans != want_plans or not all(
            _same_result(a, b) for a, b in zip(got, want)):
        fail(f"[devices] (b) D = {D}: a plan or result differs from "
             f"[fleet] (c)'s")
    if launches != D * base:
        fail(f"[devices] (b) D = {D}: {launches} segred launches, not "
             f"{D} x [fleet] (c)'s {base}")
    return _devices_report("b", f"[fleet] (c)'s {len(plans)} problems, "
                                f"every plan and result bitwise (c)'s",
                           wall, launches, shapes, D, smi_line)


def _devices_sa(smi_line):
    """(c) SA on three of [fleet] (b)'s archs at full width cut to 4
    layers, at None and D shards: bitwise; one launch a sweep a shard."""
    cfg = dict(FLEET["sa"], layers=DEVICES["sa"]["layers"],
               kw=DEVICES["sa"]["kw"])
    D, sweeps = DEVICES["sa"]["devices"], DEVICES["sa"]["sweeps"]
    specs = _fleet_specs(cfg)[:DEVICES["sa"]["lanes"]]
    runs = {}
    for devices in (None, D):
        results = []
        plans, wall, launches, shapes = _timed_on_card(
            lambda: _portfolio(cfg, specs, "annealing", results,
                               devices=devices))
        runs[devices] = (plans, results, wall, launches, shapes)
    (want_plans, want, base_wall, base, _), \
        (plans, got, wall, launches, shapes) = runs[None], runs[D]
    if plans != want_plans or not all(
            _same_result(a, b) for a, b in zip(got, want)):
        fail(f"[devices] (c) D = {D}: a plan or result differs from the "
             f"devices=None run")
    if any(r.points != sweeps * cfg["kw"]["chains"] for r in got) or \
            (base, launches) != (sweeps, D * sweeps):
        fail(f"[devices] (c): {[r.points for r in got]} points, segred "
             f"launches {base} / {launches}, not {sweeps} / {D * sweeps}")
    return _devices_report(
        "c", f"SA on {', '.join(n for n, _, _ in specs)} (full width, "
             f"{cfg['layers']} layers), {cfg['kw']['chains']} chains x "
             f"{sweeps} sweeps, bitwise the devices=None run", wall,
        launches, shapes, D, smi_line, base_wall)


def _devices_comap(smi_line):
    """(d) [comap]'s pair at full width cut to 4 layers on 2 pinned
    splits (4 lanes), at None and D shards: bitwise."""
    from repro_torch.core import pipeline
    D = DEVICES["comap"]["devices"]
    kw = dict(_comap_kwargs(), engine="torch",
              splits=DEVICES["comap"]["splits"])
    kw["archs"] = [_fleet_arch(DEVICES["comap"], n) for n in kw["archs"]]
    runs = {}
    for devices in (None, D):
        with _CountSteps() as steps:
            plan, wall, launches, shapes = _timed_on_card(
                lambda: pipeline.optimise_comapping(**kw, devices=devices))
        runs[devices] = (plan, wall, launches, shapes, steps.n)
    (want, base_wall, _, _, base_steps), \
        (plan, wall, launches, shapes, steps) = runs[None], runs[D]
    if _comap_fields(plan) != _comap_fields(want) or \
            plan.plans != want.plans:
        fail(f"[devices] (d) D = {D}: split {plan.split}, composite "
             f"{plan.objective_value!r} differ from the devices=None run's "
             f"{want.split}, {want.objective_value!r}")
    if not 0 < launches == 2 * steps:
        fail(f"[devices] (d): {launches} segred launches in {steps} shard "
             f"steps, not two a step")
    return _devices_report(
        "d", f"{' + '.join(COMAP['archs'])} (full width, "
             f"{DEVICES['comap']['layers']} layers), splits "
             f"{DEVICES['comap']['splits']}, {plan.result.points} points, "
             f"split {plan.split}; {steps} shard steps against "
             f"{base_steps} unsharded; bitwise the devices=None run", wall,
        launches, shapes, D, smi_line, base_wall)


def _devices_http(smi_line):
    """(e) one POST /v1/mapping of brute force with ``devices`` in its
    kwargs: every JSON field but the wall equal to the same POST without
    ``devices``, the served result and plan (read back from the cache)
    bitwise the direct call's, segred D times the direct call's launches."""
    import threading
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import pipeline
    from repro_torch.core.exporter import export_plan
    from repro_torch.core.optimizers import OPTIMIZERS
    from repro_torch.core.platform import V5E_POD
    from repro_torch.service import MappingServer, serve_http
    cfg, sh = DEVICES["http"], SERVICE["http_shape"]
    D = cfg["devices"]
    shape = ShapeSpec(sh["name"], sh["seq_len"], sh["global_batch"],
                      sh["mode"])
    problem = pipeline.make_problem(
        reduced(get_arch(cfg["arch"])), shape, V5E_POD, cfg["backend"],
        cfg["objective"], cfg["exec_model"])
    want, _, base, _ = _timed_on_card(
        lambda: OPTIMIZERS["brute_force"](problem, engine="torch",
                                          **cfg["kw"]))
    plan = export_plan(problem.graph, want.variables, V5E_POD,
                       cfg["exec_model"], want.evaluation)
    body = {"arch": cfg["arch"], "reduced": True, "shape": sh,
            "backend": cfg["backend"], "optimiser": "brute_force",
            "objective": cfg["objective"], "exec_model": cfg["exec_model"],
            "engine": "torch"}
    with MappingServer() as srv:
        httpd = serve_http(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base_url = f"http://127.0.0.1:{httpd.server_address[1]}"
            plain, base_wall, plain_launches, _ = _timed_on_card(
                lambda: _post(base_url, "/v1/mapping",
                              dict(body, optimiser_kwargs=cfg["kw"])))
            out, wall, launches, shapes = _timed_on_card(
                lambda: _post(base_url, "/v1/mapping", dict(
                    body, optimiser_kwargs=dict(cfg["kw"], devices=D))))
            served = srv.submit(
                reduced(get_arch(cfg["arch"])), shape, V5E_POD,
                backend=cfg["backend"], optimiser="brute_force",
                objective=cfg["objective"], exec_model=cfg["exec_model"],
                engine="torch", devices=D, **cfg["kw"]).result(900)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
    drop = lambda r: {k: v for k, v in r.items() if k != "total_s"}
    if drop(out) != drop(plain):
        fail(f"[devices] (e): POST /v1/mapping with devices={D} gave "
             f"{drop(out)}, not the devices=None POST's {drop(plain)}")
    if (out["engine"], out["objective_value"], out["points"],
            out["partitions"]) != ("torch", plan.objective_value,
                                   want.points, len(plan.partitions)):
        fail(f"[devices] (e): POST /v1/mapping gave {out}, not the direct "
             f"call's objective {plan.objective_value!r}, {want.points} "
             f"points")
    if not served.cached or not _same_result(served.result, want) or \
            served.plan != plan:
        fail(f"[devices] (e): the served result (cached {served.cached}) "
             f"or plan differs from the direct call's: {served.result.points}"
             f" points, history {_history(served.result.history)} against "
             f"{want.points}, {_history(want.history)}")
    if not 0 < base == plain_launches or launches != D * base:
        fail(f"[devices] (e): segred launches {launches} with devices={D}, "
             f"{plain_launches} without, {base} in the direct call; not "
             f"{D} x {base}")
    return _devices_report(
        "e", f"POST /v1/mapping, brute force {cfg['backend']}, "
             f"{out['points']} points, every field but the wall equal to "
             f"the devices=None POST, result and plan bitwise the direct "
             f"call's", wall, launches, shapes, D, smi_line, base_wall)


def phase_devices(smi_line):
    """The device axis on the card: (rows, segred launches)."""
    rows = _devices_bf(smi_line)
    for run in (_devices_fleet_bf, _devices_sa, _devices_comap,
                _devices_http):
        rows.append(run(smi_line))
    return rows, sum(r["segred_launches"] for r in rows)


def _lm_batch(vocab, batch, seq, seed):
    import torch
    from repro_torch.models import convert
    data = convert.recipe_batch(vocab, batch, seq, seed)
    return {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}


def _lm_record_check(phase, rec, kernel_mod, name):
    """(a) float32 weights from the seeded numpy recipe, the first layers
    at full width, held to the JAX package's record; ``kernel_mod`` is the
    wrapper module of kernel ``name`` whose ``LAUNCHES`` the forward must
    raise, once per layer in the forward and once more in the loss."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import convert
    from repro_torch.models.model import Model

    arch = get_arch(rec["arch"])
    model = Model(arch, layer_range=(0, rec["layers"]), use_flash=True,
                  device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    t0 = time.perf_counter()
    model.load_state_dict(convert.params_from_jax(
        convert.nest(convert.recipe_params(shapes, rec["seed"])),
        device="cuda", dtype=torch.float32), strict=True, assign=True)
    setup_s = time.perf_counter() - t0
    batch = _lm_batch(arch.vocab_size, rec["batch"], rec["seq"], rec["seed"])
    kernel_mod.LAUNCHES = 0
    logits, _ = model(batch)
    loss = float(model.loss(batch))
    torch.cuda.synchronize()
    launches = kernel_mod.LAUNCHES
    if launches != 2 * rec["layers"]:
        fail(f"{phase} (a): {launches} {name} launches, expected "
             f"{2 * rec['layers']} (forward and loss, one per layer)")
    loss_rel = abs(loss - rec["loss"]) / abs(rec["loss"])
    logit_err = max(abs(float(logits[b, t, v]) - want)
                    for b, t, v, want in rec["logits"])
    if not (loss_rel <= 1e-4 and logit_err <= 1e-3):
        fail(f"{phase} (a): loss {loss!r} vs JAX record {rec['loss']!r} (rel "
             f"{loss_rel:.3g}, limit 1e-4); sampled logits off by "
             f"{logit_err:.3g} (limit 1e-3)")
    say(phase, f"(a) {rec['arch']} layers 0-{rec['layers']} float32, "
               f"B={rec['batch']} T={rec['seq']}: loss {loss!r} vs JAX "
               f"record {rec['loss']!r} (rel {loss_rel:.3g}); sampled "
               f"logits max abs err {logit_err:.3g}; {name} launches "
               f"{launches}; recipe + copy {setup_s:.2f} s")
    return {"loss": loss, "loss_rel_err": loss_rel,
            "logit_max_abs_err": logit_err, "launches": launches,
            "setup_s": setup_s}


def _wkv_float64(r, k, v, w, u):
    """``ref.rwkv6``'s recurrence (zero initial state) summed in float64
    and rounded to r's dtype: the same function in a more exact order, the
    yardstick for what summation order alone does to the forward."""
    import torch
    B, T, H, hs = r.shape
    rd, kd, vd, wd = (x.double() for x in (r, k, v, w))
    ud = u.double()[None, :, :, None]
    S = torch.zeros((B, H, hs, hs), dtype=torch.float64, device=r.device)
    outs = []
    for t in range(T):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], S + ud * kv))
        S = wd[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype), S


def _attention_float64(q, k, v, *, causal=True, q_offset=0):
    """``ref.attention`` computed in float64 and rounded to q's dtype, one
    batch row at a time (the full-length score matrix of one row is 4.3 GB
    in float64 at [lm-dense] (b)'s shape): the same function in a more
    exact arithmetic."""
    import math

    import torch
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    out = torch.empty_like(q)
    for b in range(B):
        kd = torch.repeat_interleave(k[b].double(), group, dim=1)
        vd = torch.repeat_interleave(v[b].double(), group, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kd) / math.sqrt(dh)
        if causal:
            qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
            kpos = torch.arange(Skv, device=q.device)[None, :]
            s = s.masked_fill(~(kpos <= qpos), -torch.inf)
        out[b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                              vd).to(q.dtype)
        del kd, vd, s
    return out


def _logit_gap(a, b):
    """Max abs difference of two logits tensors, and the share of logits
    beyond 6e-2 abs and rel of ``b``."""
    af, bf = a.float(), b.float()
    diff = (af - bf).abs()
    return float(diff.max()), float((diff > 6e-2 + 6e-2 * bf.abs())
                                    .float().mean())


def _lm_full(phase, cfg, kernel_mod, entry, plain, oracle, oracle64,
             limit_used, limit_text, name):
    """(b): the full model in bfloat16 through the kernel, timed; every one
    of its kernel launches held to the plain version on the same inputs;
    its loss held to the same model with the plain oracle; its logits held
    to that model's, within LOGIT_YARDSTICK times that model's distance
    from the same model with the oracle ``ref.<oracle>`` replaced by
    ``oracle64`` (float64 arithmetic). ``kernel_mod.<entry>`` is the
    wrapper of kernel ``name`` that the model calls and ``plain`` its plain
    version; ``limit_used(got, want, args)`` is the largest share of the
    per-launch limit (``limit_text``) an output element uses."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.models.model import Model

    arch = get_arch(cfg["arch"])
    # what earlier phases keep on the card (the other LM, kept for the
    # profile) is not this forward's memory
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(arch, use_flash=True, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(cfg["seed"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.state_dict().values())
    batch = _lm_batch(arch.vocab_size, cfg["batch"], cfg["seq"], cfg["seed"])
    tokens = cfg["batch"] * cfg["seq"]

    model(batch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    kernel_mod.LAUNCHES = 0
    for _ in range(cfg["runs"]):
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kernel_mod.LAUNCHES
    peak = torch.cuda.max_memory_allocated() - base
    per_forward = launches / cfg["runs"]
    if per_forward != arch.num_layers:
        fail(f"{phase} (b): {per_forward} {name} launches per forward, "
             f"expected {arch.num_layers}")

    # one more forward, each launch held to the plain version on its inputs
    kernel_call, layer_errs = getattr(kernel_mod, entry), []

    def held(*args, **kw):
        out = kernel_call(*args, **kw)
        # the largest share of the limit any element uses (<= 1 holds)
        layer_errs.append(limit_used(out, plain(*args, **kw), args))
        return out

    setattr(kernel_mod, entry, held)
    try:
        logits, _ = model(batch)
    finally:
        setattr(kernel_mod, entry, kernel_call)
    if len(layer_errs) != arch.num_layers or max(layer_errs) > 1.0:
        fail(f"{phase} (b): in-model {name} launches against the plain "
             f"version use {layer_errs} of the limit ({limit_text})")
    loss = float(model.loss(batch))

    plain_model = Model(arch, use_flash=False, device="meta")
    plain_model.load_state_dict(model.state_dict(), strict=True, assign=True)
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    want, _ = plain_model(batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    want_loss = float(plain_model.loss(batch))
    kept = getattr(ref, oracle)
    setattr(ref, oracle, oracle64)
    try:
        exact, _ = plain_model(batch)
    finally:
        setattr(ref, oracle, kept)
    if kernel_mod.LAUNCHES:
        fail(f"{phase} (b): the plain-{oracle} model launched the kernel")
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    finite = bool(torch.isfinite(logits.float()).all()) and loss == loss
    if logits.shape != (cfg["batch"], cfg["seq"], arch.vocab_size) or \
            not finite or loss_rel > 1e-3:
        fail(f"{phase} (b): logits {tuple(logits.shape)} finite={finite}; "
             f"loss {loss!r} vs plain-{oracle} {want_loss!r} (rel "
             f"{loss_rel:.3g}, limit 1e-3)")
    gaps = {"kernel_vs_plain": _logit_gap(logits, want),
            "plain_vs_float64": _logit_gap(want, exact),
            "kernel_vs_float64": _logit_gap(logits, exact)}
    # the yardstick: how far a more exact arithmetic alone moves these logits
    logit_limit = LOGIT_YARDSTICK * gaps["plain_vs_float64"][0]
    if not gaps["kernel_vs_plain"][0] <= logit_limit:
        fail(f"{phase} (b): logits {gaps['kernel_vs_plain'][0]:.3g} from the "
             f"plain-{oracle} forward's, beyond {LOGIT_YARDSTICK} times the "
             f"plain forward's distance from its float64 {oracle} "
             f"({gaps['plain_vs_float64'][0]:.3g})")
    mean_wall = sum(walls) / len(walls)
    out = {"arch": cfg["arch"], "params": n_params, "init_s": init_s,
           "batch": cfg["batch"], "seq": cfg["seq"], "walls_s": walls,
           "tokens_per_s": tokens / mean_wall, "launches": launches,
           "launches_per_forward": per_forward, "peak_bytes": peak,
           "layer_limit_used": layer_errs,
           "loss": loss, "plain_loss": want_loss, "loss_rel_err": loss_rel,
           "logit_gaps": gaps, "logit_limit": logit_limit,
           "plain_wall_s": plain_wall}
    say(phase, f"(b) {cfg['arch']}, {arch.num_layers} layers, {n_params} "
               f"parameters bfloat16 (drawn on the card in {init_s:.2f} s), "
               f"B={cfg['batch']} T={cfg['seq']}: wall per forward "
               f"{', '.join(f'{w:.4f}' for w in walls)} s, "
               f"{out['tokens_per_s']:.0f} tokens/s; {name} launches "
               f"{launches} in {cfg['runs']} forwards ({per_forward:.0f} per "
               f"forward); peak memory {peak / 2**30:.2f} GiB (weights "
               f"included)")
    say(phase, f"(b) each of the {len(layer_errs)} in-model {name} launches "
               f"holds its plain version on the same inputs, using at most "
               f"{max(layer_errs):.3g} of the limit ({limit_text}); "
               f"loss {loss!r} vs plain-{oracle} forward {want_loss!r} "
               f"(rel {loss_rel:.3g}, limit 1e-3; plain forward "
               f"{plain_wall:.2f} s)")
    say(phase, "(b) logits, max abs diff / share beyond 6e-2 abs and rel: " +
        "; ".join(f"{k.replace('_', ' ')} {v[0]:.3g} / {v[1]:.3g}"
                  for k, v in gaps.items()) +
        f"; kernel vs plain held within {logit_limit:.3g} "
        f"({LOGIT_YARDSTICK} x plain vs float64)")
    del plain_model, want, exact
    return model, batch, out


def _lm_float32(phase, cfg, model, batch, kernel_mod, name):
    """(c): the (b) model's weights cast to float32; the whole forward
    through the kernel against the same forward with the plain version,
    both in float32: logits within LM_F32_LOGIT_TOL abs and rel, loss
    within LM_F32_LOSS_TOL relative, one launch per layer."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    arch = get_arch(cfg["arch"])
    weights = {k: t.float() for k, t in model.state_dict().items()}
    kernel_model = Model(arch, use_flash=True, device="meta")
    kernel_model.load_state_dict(weights, strict=True, assign=True)
    plain_model = Model(arch, use_flash=False, device="meta")
    plain_model.load_state_dict(weights, strict=True, assign=True)
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    logits, _ = kernel_model(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_mod.LAUNCHES
    loss = float(kernel_model.loss(batch))
    kernel_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    want, _ = plain_model(batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    want_loss = float(plain_model.loss(batch))
    if kernel_mod.LAUNCHES:
        fail(f"{phase} (c): the plain float32 model launched the kernel")
    diff = (logits - want).abs()
    used = float((diff / (LM_F32_LOGIT_TOL * (1 + want.abs()))).max())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    if logits.dtype != torch.float32 or launches != arch.num_layers or \
            not bool(torch.isfinite(logits).all()) or not used <= 1.0 or \
            not loss_rel <= LM_F32_LOSS_TOL:
        fail(f"{phase} (c): float32 {logits.dtype}, {launches} {name} "
             f"launches (expected {arch.num_layers}); logits "
             f"{float(diff.max()):.3g} from the plain forward's ({used:.3g} "
             f"of {LM_F32_LOGIT_TOL} abs and rel); loss {loss!r} vs "
             f"{want_loss!r} (rel {loss_rel:.3g}, limit {LM_F32_LOSS_TOL})")
    out = {"launches": launches, "logit_max_abs_err": float(diff.max()),
           "logit_limit_used": used, "loss": loss, "plain_loss": want_loss,
           "loss_rel_err": loss_rel, "wall_s": wall, "plain_wall_s": plain_wall}
    say(phase, f"(c) {cfg['arch']}, {arch.num_layers} layers, the (b) weights "
               f"in float32, B={cfg['batch']} T={cfg['seq']}: logits max abs "
               f"diff {out['logit_max_abs_err']:.3g} from the plain-{name} "
               f"float32 forward ({used:.3g} of {LM_F32_LOGIT_TOL} abs and "
               f"rel); loss {loss!r} vs {want_loss!r} (rel {loss_rel:.3g}, "
               f"limit {LM_F32_LOSS_TOL}); {launches} {name} launches; wall "
               f"{wall:.3f} s (plain {plain_wall:.2f} s)")
    del kernel_model, plain_model, weights, logits, want, diff
    return out


def phase_lm():
    """rwkv6-1.6b: (a) against the JAX record, (b) the full model with the
    WKV kernel, held to the plain-WKV model and a float64 recurrence."""
    import torch
    from repro_torch.kernels import rwkv6_scan
    record = _lm_record_check("lm", LM_RECORD, rwkv6_scan, "wkv6")
    torch.cuda.empty_cache()
    model, batch, out = _lm_full("lm", LM_FULL, rwkv6_scan, "wkv6",
                                 rwkv6_scan.wkv6_plain, "rwkv6",
                                 _wkv_float64,
                                 lambda got, want, args: _wkv_limit_used(
                                     got, want),
                                 f"{WKV_TOL['bfloat16']} abs and rel; one "
                                 f"bfloat16 rounding step", "wkv6")
    out["record"] = record
    torch.cuda.empty_cache()
    out["float32"] = _lm_float32("lm", LM_FULL, model, batch, rwkv6_scan,
                                 "wkv6")
    torch.cuda.empty_cache()
    return model, batch, out


def phase_lm_dense():
    """tinyllama-1.1b: (a) against the JAX record, (b) the full model with
    flash attention in the kernel, held to the ``attn_impl="ref"`` model
    and to attention in float64."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    record = _lm_record_check("lm-dense", DENSE_RECORD, fa, "flash_attn")
    torch.cuda.empty_cache()
    model, batch, out = _lm_full("lm-dense", DENSE_FULL, fa,
                                 "flash_attention", fa.flash_attention_plain,
                                 "attention", _attention_float64,
                                 lambda got, want, args: _flash_limit_used(
                                     got, want, args[2]),
                                 f"{FLASH_TOL['bfloat16']} abs and rel; one "
                                 f"bfloat16 rounding step", "flash_attn")
    out["record"] = record
    torch.cuda.empty_cache()
    return model, batch, out


def _serve_prompts(vocab, batch, prompt, seed):
    """[serve] (a)'s prompt: ``tools/serve_records.py``'s draw."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, prompt)).astype(np.int32)


def _serve_record_check(name, rec):
    """(a) float32 recipe weights, the first layers at full width, greedy
    through ``generate`` with a float32 cache: tokens equal to the JAX
    record, sampled logits within SERVE_RECORD_TOL."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import convert
    from repro_torch.models.model import Model

    arch = get_arch(name)
    want = rec["archs"][name]
    model = Model(arch, layer_range=(0, rec["layers"]), attn_impl="chunked",
                  remat=False, device="meta")
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    model.load_state_dict(convert.params_from_jax(
        convert.nest(convert.recipe_params(shapes, rec["seed"])),
        device="cuda", dtype=torch.float32), strict=True, assign=True)
    prompts = torch.from_numpy(_serve_prompts(
        arch.vocab_size, rec["batch"], rec["prompt"], rec["seed"])).cuda()
    tokens, stats = generate(model, prompts, rec["gen"],
                             cache_dtype=torch.float32, keep_logits=True)
    got = tokens[0].tolist()
    logits = stats["logits"][0]
    err = max(abs(float(logits[step, v]) - x) for step, v, x in
              want["logits"])
    if got != want["tokens"] or not err <= SERVE_RECORD_TOL:
        fail(f"[serve] (a) {name}: tokens {got} vs JAX record "
             f"{want['tokens']}; sampled logits off by {err:.3g} (limit "
             f"{SERVE_RECORD_TOL})")
    say("serve", f"(a) {name} layers 0-{rec['layers']} float32, B="
                 f"{rec['batch']}, prompt {rec['prompt']}, {rec['gen']} "
                 f"tokens: equal to the JAX record; sampled logits max abs "
                 f"err {err:.3g}")
    return {"arch": name, "tokens": got, "logit_max_abs_err": err}


def _recompute(model, prompts, tokens, positions, oracle=None, oracle64=None):
    """Logits of the cache-less forward over the served sequence (prompt,
    then every served token but the last) at ``positions``; with
    ``oracle``, the same forward with ``ref.<oracle>`` replaced by
    ``oracle64``. The MoE blocks route the token groups that serving
    routed: the prompt as one group (the prefill), then each later
    position as its own group of B tokens (a decode step). A block's
    capacity, ``max(1, int(1.25 * T * top_k / E))``, and so which
    assignments drop, depends on its group's size T: the forward over
    the whole sequence as one group is another function (at T = 8 a
    32-expert top-8 block drops assignments, at T = 4600 none)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import moe
    P = prompts.shape[1]
    seq = torch.cat([prompts, tokens[:, :-1]], dim=1)
    apply_moe = moe.apply_moe

    def grouped(x, p, **kw):
        return torch.cat([apply_moe(x[:, :P], p, **kw)]
                         + [apply_moe(x[:, t:t + 1], p, **kw)
                            for t in range(P, x.shape[1])], dim=1)

    kept = getattr(ref, oracle) if oracle else None
    if oracle:
        setattr(ref, oracle, oracle64)
    moe.apply_moe = grouped
    try:
        logits, _ = model({"tokens": seq})
    finally:
        moe.apply_moe = apply_moe
        if oracle:
            setattr(ref, oracle, kept)
    return logits[:, positions].float()


def _token_rule(full, tokens, gaps):
    """The largest share of the token rule's slack that a served token
    uses: at each step, the gap between the recompute's row maximum and
    the served token's recompute logit over SERVE_TOKEN_SLACK times the
    step's decode-vs-recompute distance (<= 1 holds; a 0 distance allows
    only the row's maximum itself)."""
    import torch
    picked = torch.gather(full, -1, tokens.long()[..., None])[..., 0]
    short = (full.amax(dim=-1) - picked).amax(dim=0)        # (gen,)
    slack = SERVE_TOKEN_SLACK * gaps
    used = torch.where(slack > 0, short / slack.clamp(min=1e-30),
                       torch.where(short > 0, torch.inf, 0.0))
    return float(used.max()), short


def _moe_recount(records, batch):
    """The decode calls' drops (T = batch) on the device against a host
    recount from the routed expert ids: stable sort by expert, rank in
    the expert's run, kept below ``cap``. Returns (decode calls, device
    drops, host drops, whether every kept mask agreed)."""
    import numpy as np
    calls = dev = host = 0
    agree = True
    for r in records:
        ids = r["expert_ids"].cpu().numpy()
        if ids.shape[0] != batch:
            continue
        calls += 1
        keep = r["keep"].cpu().numpy()
        flat = ids.reshape(-1)
        srt = flat[np.argsort(flat, kind="stable")]
        start = np.r_[0, np.flatnonzero(srt[1:] != srt[:-1]) + 1]
        ranks = np.arange(srt.size) - np.repeat(start, np.diff(
            np.r_[start, srt.size]))
        host_keep = ranks < r["cap"]
        dev += int((~keep).sum())
        host += int((~host_keep).sum())
        agree &= bool((keep == host_keep).all())
    return calls, dev, host, agree


def _serve_full(name, smi_line):
    """(b) the arch at full width and depth, bf16 weights drawn from a
    seed, through ``serve``: prefill ms, decode tokens/s, peak memory;
    the decode logits of every generated position held to the cache-less
    forward over the served sequence within LOGIT_YARDSTICK times that
    forward's largest distance over the generated positions from the same
    forward with attention / WKV in float64, and the token rule. (c) the
    same weights in float32 through ``generate`` with a float32 cache,
    held to the cache-less float32 forward (SERVE_F32_TOL abs and rel)
    with the token rule. (d) for a MoE arch, the decode calls' drops
    against a host recount."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.accel import segred
    from repro_torch.kernels import flash_attention, rwkv6_scan
    from repro_torch.launch.serve import generate, serve
    from repro_torch.models import moe
    from repro_torch.models.model import Model, build_segments

    cfg = SERVE
    arch = get_arch(name)
    B, P, G = cfg["batch"], cfg["prompt"], cfg["gen"]
    kinds = {k for seg in build_segments(arch) for k in seg.pattern}
    oracle, oracle64 = (("rwkv6", _wkv_float64) if "rwkv_tmix" in kinds else
                        ("attention_chunked", _attention_float64))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    segred.LAUNCHES = flash_attention.LAUNCHES = rwkv6_scan.LAUNCHES = 0
    moe.RECORD = []
    lines = []
    t0 = time.perf_counter()
    try:
        tokens, stats = serve(arch, prompt_len=P, gen_len=G, batch=B,
                              seed=cfg["seed"], keep_logits=True,
                              log=lines.append)
    finally:
        records, moe.RECORD = moe.RECORD, None
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"segred": segred.LAUNCHES, "wkv6": rwkv6_scan.LAUNCHES,
                "flash_attn": flash_attention.LAUNCHES}
    if launches["wkv6"] or launches["flash_attn"]:
        fail(f"[serve] (b) {name}: the serve path launched {launches}; "
             f"decode against a cache takes the oracles, as in JAX")
    if tuple(tokens.shape) != (B, G) or tokens.dtype != torch.int32 or \
            not bool(((tokens >= 0) & (tokens < arch.vocab_size)).all()):
        fail(f"[serve] (b) {name}: tokens {tuple(tokens.shape)} "
             f"{tokens.dtype}, expected ({B}, {G}) int32 in the vocabulary")

    # the served model and prompts again, drawn as serve draws them
    dev = torch.device("cuda")
    model = Model(arch, attn_impl="chunked", remat=False, device=dev,
                  generator=torch.Generator(dev).manual_seed(cfg["seed"]))
    prompts = torch.randint(0, arch.vocab_size, (B, P),
                            generator=torch.Generator(dev).manual_seed(
                                cfg["seed"] + 1),
                            dtype=torch.int32, device=dev)
    positions = torch.arange(P - 1, P + G - 1, device=dev)
    dec = stats.pop("logits")
    full = _recompute(model, prompts, tokens, positions)
    full64 = _recompute(model, prompts, tokens, positions, oracle, oracle64)
    gaps = (dec - full).abs().amax(dim=(0, 2))               # (gen,)
    yard = (full - full64).abs().amax(dim=(0, 2))
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    # the yardstick is the distance over all the generated positions: at
    # one position alone it is one draw of a noisy distance (PERF.md)
    yard_used = float(gaps.max()
                      / (LOGIT_YARDSTICK * yard.max()).clamp(min=1e-30))
    token_used, short = _token_rule(full, tokens, gaps)
    if not finite or not yard_used <= 1.0 or not token_used <= 1.0:
        fail(f"[serve] (b) {name}: finite={finite}; decode logits vs the "
             f"cache-less forward by position {gaps.tolist()}, beyond "
             f"{LOGIT_YARDSTICK} x that forward's largest distance from "
             f"float64 {oracle} (by position {yard.tolist()}; "
             f"{yard_used:.3g} of the limit); "
             f"token rule {token_used:.3g} of its slack (row max less the "
             f"served token's logit {short.tolist()})")
    out = {"arch": name, "layers": arch.num_layers, "batch": B, "prompt": P,
           "gen": G, "serve_wall_s": wall,
           "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
           "decode_tok_per_s": stats["decode_tok_per_s"],
           "partitions": stats["partitions"], "peak_bytes": peak,
           "launches": launches, "log": lines,
           "decode_vs_recompute": gaps.tolist(),
           "recompute_vs_float64": yard.tolist(),
           "yardstick_used": yard_used, "token_rule_used": token_used}
    say("serve", f"(b) {name}, {arch.num_layers} layers bfloat16, B={B}, "
                 f"prompt {P}, {G} tokens: prefill "
                 f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
                 f"{stats['decode_tok_per_s']:.1f} tokens/s "
                 f"({stats['decode_s']:.3f} s), serve() {wall:.2f} s with "
                 f"plan and weights; peak memory {peak / 2**30:.2f} GiB; "
                 f"{smi_line}; launches {launches}")
    ratio = float((gaps / yard.clamp(min=1e-30)).max())
    say("serve", f"(b) {name}: decode vs cache-less logits max "
                 f"{float(gaps.max()):.3g} over the {G} positions "
                 f"({yard_used:.3g} of {LOGIT_YARDSTICK} x the forward's "
                 f"largest distance from float64 {oracle}, "
                 f"{float(yard.max()):.3g}; position by position the "
                 f"largest ratio {ratio:.3g}); token rule {token_used:.3g} "
                 f"of its slack")
    del full, full64, dec

    if "moe" in kinds:
        calls, dev_drops, host_drops, agree = _moe_recount(records, B)
        if not calls or dev_drops != host_drops or not agree:
            fail(f"[serve] (d) {name}: {calls} decode MoE calls, "
                 f"{dev_drops} drops on the device vs {host_drops} "
                 f"recounted on the host (kept masks agree: {agree})")
        out["moe_decode"] = {"calls": calls, "dropped": dev_drops,
                             "assignments": calls * B
                             * arch.experts_per_token}
        cap = moe.capacity(B, arch.experts_per_token, arch.num_experts)
        say("serve", f"(d) {name}: {calls} decode MoE calls (T = {B}, cap "
                     f"{cap}), {dev_drops} of "
                     f"{out['moe_decode']['assignments']} assignments "
                     f"dropped, equal to the host recount")
    del records

    # (c) the same weights in float32, against the cache-less float32 forward
    weights = {k: t.float() for k, t in model.state_dict().items()}
    del model
    model = Model(arch, attn_impl="chunked", remat=False, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    del weights
    tokens32, st32 = generate(model, prompts, G, cache_dtype=torch.float32,
                              keep_logits=True)
    dec = st32.pop("logits")
    full = _recompute(model, prompts, tokens32, positions)
    diff = (dec - full).abs()
    used = float((diff / (SERVE_F32_TOL * (1 + full.abs()))).max())
    gaps32 = diff.amax(dim=(0, 2))
    token32, short32 = _token_rule(full, tokens32, gaps32)
    if not bool(torch.isfinite(dec).all()) or not used <= 1.0 or \
            not token32 <= 1.0:
        fail(f"[serve] (c) {name}: float32 decode logits "
             f"{float(diff.max()):.3g} from the cache-less forward's "
             f"({used:.3g} of {SERVE_F32_TOL} abs and rel); token rule "
             f"{token32:.3g} of its slack ({short32.tolist()})")
    same = float((tokens32 == tokens).float().mean())
    out["float32"] = {"logit_max_abs_err": float(diff.max()),
                      "limit_used": used, "token_rule_used": token32,
                      "prefill_s": st32["prefill_s"],
                      "decode_tok_per_s": st32["decode_tok_per_s"],
                      "tokens_equal_to_bf16_share": same}
    say("serve", f"(c) {name} float32 weights and cache: decode logits max "
                 f"abs diff {float(diff.max()):.3g} from the cache-less "
                 f"float32 forward ({used:.3g} of {SERVE_F32_TOL} abs and "
                 f"rel); token rule {token32:.3g} of its slack; prefill "
                 f"{st32['prefill_s'] * 1e3:.1f} ms, decode "
                 f"{st32['decode_tok_per_s']:.1f} tokens/s; {same:.3f} of "
                 f"the tokens equal the bf16 run's")
    del model, dec, full, diff
    torch.cuda.empty_cache()
    return out


def phase_serve(smi_line):
    """[serve]: (a) each served arch against the JAX record, then (b)-(d)
    at full depth."""
    import torch
    record = [_serve_record_check(name, SERVE_RECORD)
              for name in SERVE_RECORD["archs"]]
    torch.cuda.empty_cache()
    runs = [_serve_full(name, smi_line) for name in SERVE["archs"]]
    return {"record": record, "runs": runs}


def _profile(fn):
    """Device events of ``fn()`` under torch.profiler, summed by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total, cnt + 1)
    return wall, dev, by_name


def _top(by_name, n=8):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:120], "device_s": v[0] * 1e-6, "count": v[1]}
            for k, v in top]


def phase_profile_lm(phase, model, batch, lm, kernel):
    """One LM forward under torch.profiler: device busy time, the idle
    share, the share of the kernel whose name holds ``kernel``, and the top
    kernels."""
    wall, dev, by_name = _profile(lambda: model(batch))
    device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
    plain_wall = min(lm["walls_s"])
    out = {"profiled_wall_s": wall, "wall_s": plain_wall,
           "device_s": device_s, "device_events": len(dev),
           "idle_share": (1.0 - device_s / plain_wall) if dev else None,
           "top": _top(by_name)}
    if not dev:
        say("profile", f"{phase}: the profiler traced no device activity: "
                       f"device time not measured")
        return out
    hits = [v for k, v in by_name.items() if kernel in k]
    out["kernel"] = kernel
    out["kernel_device_s"] = sum(v[0] for v in hits) * 1e-6
    out["kernel_events"] = sum(v[1] for v in hits)
    out["kernel_share"] = out["kernel_device_s"] / device_s
    say("profile", f"{phase} forward: {len(dev)} device events, device busy "
                   f"{device_s:.4f} s of {plain_wall:.4f} s wall (idle share "
                   f"{out['idle_share']:.4f}); {kernel} "
                   f"{out['kernel_device_s']:.5f} s in "
                   f"{out['kernel_events']} launches = "
                   f"{out['kernel_share']:.4f} of device time")
    for row in out["top"]:
        say("profile", f"  {row['device_s']:.5f} s  x{row['count']}  "
                       f"{row['name']}")
    return out


def phase_profile_serve(served):
    """One ``generate`` of each [serve] (b) arch (the same seeded bf16
    weights and prompts, 16 tokens) under torch.profiler: device busy time
    and idle share (against the same call's unprofiled wall) of the
    prefill and decode together, and device events (kernels and copies) a
    decode step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    cfg, out = SERVE, []
    for run in served["runs"]:
        arch = get_arch(run["arch"])
        dev = torch.device("cuda")
        model = Model(arch, attn_impl="chunked", remat=False, device=dev,
                      generator=torch.Generator(dev).manual_seed(cfg["seed"]))
        prompts = torch.randint(
            0, arch.vocab_size, (cfg["batch"], cfg["prompt"]),
            generator=torch.Generator(dev).manual_seed(cfg["seed"] + 1),
            dtype=torch.int32, device=dev)
        gen = 16
        generate(model, prompts, gen)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        profiled, dev_events, by_name = _profile(
            lambda: generate(model, prompts, gen))
        _, step_events, _ = _profile(
            lambda: generate(model, prompts, 2))
        device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
        rec = {"arch": run["arch"], "tokens": gen, "wall_s": wall,
               "profiled_wall_s": profiled, "device_s": device_s, "device_events": len(dev_events),
               "events_per_decode_step": (len(dev_events) - len(step_events))
               / (gen - 2),
               "idle_share": (1.0 - device_s / wall) if dev_events else None,
               "top": _top(by_name)}
        out.append(rec)
        del model
        torch.cuda.empty_cache()
        if not dev_events:
            say("profile", f"[serve] {run['arch']}: the profiler traced no "
                           f"device activity: device time not measured")
            continue
        say("profile", f"[serve] {run['arch']}, prefill + {gen - 1} decode "
                       f"steps: {len(dev_events)} device events, device busy "
                       f"{device_s:.4f} s of {wall:.4f} s wall "
                       f"(idle share {rec['idle_share']:.4f}); "
                       f"{rec['events_per_decode_step']:.0f} device events a "
                       f"decode step")
        for top in rec["top"]:
            say("profile", f"  {top['device_s']:.5f} s  x{top['count']}  "
                           f"{top['name']}")
    return out

def _is_segred(name):
    """Whether a traced kernel is one of segred's (``segred_kernel``,
    ``segred_output_kernel``, or the first design's ``segred_kernel``)."""
    return "segred" in name and "kernel" in name


def phase_profile_segred(yardsticks):
    """segred's device time a launch under torch.profiler, beside its first
    design's, float32, at the mapper's shape and a brute-force chunk's: 100
    launches of each, in separate traces (the first design's kernel is
    named segred_kernel too). This separates the kernels from the host
    work that sets the CUDA-event time of a call at 28 rows."""
    import torch
    from repro_torch.core.accel import segred
    first = yardsticks["segred"]["float32"]
    rows = []
    for N, n in SEGRED_SHAPES[:2]:
        vals, pid = _segred_inputs(N, n, torch.float32, seed=N + n)
        for op in ("max", "sum"):
            us = {}
            for design, fn in (
                    ("kernel", lambda: segred.segmented_reduce(vals, pid, op)),
                    ("first design",
                     lambda: _segred_first(first, vals, pid, op))):
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                _, dev, by_name = _profile(
                    lambda: [fn() for _ in range(100)])
                hits = [v for k, v in by_name.items() if _is_segred(k)]
                count = sum(v[1] for v in hits)
                us[design] = (sum(v[0] for v in hits) / count) if count \
                    else None
            row = {"N": N, "n": n, "dtype": "float32", "op": op,
                   "device_us": us["kernel"],
                   "first_design_device_us": us["first design"]}
            rows.append(row)
            if us["kernel"] is None or us["first design"] is None:
                say("profile", f"segred {op} [{N},{n}]: the profiler traced "
                               f"no segred launch: device time not measured")
                continue
            say("profile", f"segred {op} float32 [{N},{n}]: device "
                           f"{us['kernel']:.3f} us a launch, first design "
                           f"{us['first design']:.3f} us (100 launches each)")
    return rows


def phase_profile(runs):
    """The first request once more under torch.profiler. Device time is the
    sum of the traced kernel and copy durations (one stream, so they do not
    overlap); the idle share is one minus that over the unprofiled wall
    time of the same request in phase 4."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import V5E_POD

    req = REQUESTS[0]
    wall, dev, by_name = _profile(lambda: optimise_mapping(
        get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"], V5E_POD,
        optimiser="rule_based", objective=req["objective"],
        exec_model=req["exec_model"], engine="torch"))
    device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
    plain_wall = runs[0]["wall_s"]
    out = {"request": runs[0]["request"], "profiled_wall_s": wall,
           "wall_s": plain_wall, "device_s": device_s,
           "device_events": len(dev),
           "idle_share": (1.0 - device_s / plain_wall) if dev else None,
           "top": _top(by_name)}
    if not dev:
        say("profile", "the profiler traced no device activity: device "
                       "time not measured")
        return out
    seg = [v for k, v in by_name.items() if _is_segred(k)]
    out["segred_device_s"] = sum(v[0] for v in seg) * 1e-6
    out["segred_events"] = sum(v[1] for v in seg)
    if not out["segred_events"]:
        fail("the profiler traced the request's device work but no segred "
             "launch, though its counter saw them")
    say("profile", f"{out['request']}: {len(dev)} device events, device busy "
                   f"{device_s:.4f} s of {plain_wall:.3f} s wall (idle share "
                   f"{out['idle_share']:.4f}); profiled wall {wall:.3f} s; "
                   f"segred kernel {out['segred_device_s']:.5f} s device "
                   f"time in {out['segred_events']} launches")
    for row in out["top"]:
        say("profile", f"  {row['device_s']:.5f} s  x{row['count']}  "
                       f"{row['name']}")
    return out


def phase_profile_search(search):
    """Brute force (a) and (b) and SA on spmd/latency once more under
    torch.profiler: device busy time, its idle share against the
    unprofiled wall time of the same request in phase 5, and segred's
    device time."""
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import optimise_mapping
    from repro_torch.core.platform import V5E_POD
    arch, shape = get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"]
    sa_req = REQUESTS[1]
    calls = [(search[i], dict(optimiser="brute_force", backend=req["backend"],
                              objective=req["objective"],
                              exec_model=req["exec_model"], **req["kw"]))
             for i, req in enumerate(SEARCH_BF)]
    sa_tag = f"spmd {sa_req['exec_model']}/{sa_req['objective']}"
    calls.append((next(r for r in search if r["request"].startswith("(c)")
                       and r["request"].endswith(sa_tag)),
                  dict(optimiser="annealing", backend=SEARCH_SA["backend"],
                       objective=sa_req["objective"],
                       exec_model=sa_req["exec_model"],
                       chains=SEARCH_SA["chains"],
                       seed=SEARCH_SA["seeds"][0])))
    out = []
    for row, kw in calls:
        wall, dev, by_name = _profile(lambda: optimise_mapping(
            arch, shape, V5E_POD, engine="torch", **kw))
        device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
        seg = [v for k, v in by_name.items() if _is_segred(k)]
        rec = {"request": row["request"], "profiled_wall_s": wall,
               "wall_s": row["wall_s"], "device_s": device_s,
               "device_events": len(dev),
               "idle_share": (1.0 - device_s / row["wall_s"]) if dev
               else None,
               "segred_device_s": sum(v[0] for v in seg) * 1e-6,
               "segred_events": sum(v[1] for v in seg), "top": _top(by_name)}
        out.append(rec)
        if not dev:
            say("profile", f"{row['request']}: the profiler traced no device "
                           f"activity: device time not measured")
            continue
        say("profile", f"{row['request']}: {len(dev)} device events, device "
                       f"busy {device_s:.4f} s of {row['wall_s']:.3f} s wall "
                       f"(idle share {rec['idle_share']:.4f}); profiled wall "
                       f"{wall:.3f} s; segred {rec['segred_device_s']:.5f} s "
                       f"in {rec['segred_events']} launches")
        for top in rec["top"]:
            say("profile", f"  {top['device_s']:.5f} s  x{top['count']}  "
                           f"{top['name']}")
    return out


def phase_profile_fleet(fleet):
    """[fleet] (b) and (c) once more under torch.profiler: device busy
    time and its idle share against the unprofiled wall of the same
    ``optimise_portfolio`` call in phase 6, and segred's device time. (a)
    runs for minutes, too long a trace to take."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.core import pipeline, platform
    out = []
    for row in fleet:
        if row["part"] == "rb":
            continue
        cfg = FLEET[row["part"]]
        specs = _fleet_specs(cfg)
        wall, dev, by_name = _profile(lambda: pipeline.optimise_portfolio(
            [_fleet_arch(cfg, n) for n, _, _ in specs],
            SHAPES_BY_NAME[FLEET["shape"]],
            [getattr(platform, pl) for _, pl, _ in specs],
            backend=cfg["backend"], optimiser=row["optimiser"],
            objective=[o for _, _, o in specs],
            exec_model=cfg["exec_model"], engine="torch", **cfg["kw"]))
        device_s = sum(tot for tot, _ in by_name.values()) * 1e-6
        seg = [v for k, v in by_name.items() if _is_segred(k)]
        rec = {"part": row["part"], "profiled_wall_s": wall,
               "wall_s": row["wall_s"], "device_s": device_s,
               "device_events": len(dev),
               "idle_share": (1.0 - device_s / row["wall_s"]) if dev
               else None,
               "segred_device_s": sum(v[0] for v in seg) * 1e-6,
               "segred_events": sum(v[1] for v in seg), "top": _top(by_name)}
        out.append(rec)
        if not dev:
            say("profile", f"[fleet] ({row['part']}): the profiler traced no "
                           f"device activity: device time not measured")
            continue
        say("profile", f"[fleet] ({row['part']}): {len(dev)} device events, "
                       f"device busy {device_s:.4f} s of {row['wall_s']:.3f} "
                       f"s wall (idle share {rec['idle_share']:.4f}); "
                       f"profiled wall {wall:.3f} s; segred "
                       f"{rec['segred_device_s']:.5f} s in "
                       f"{rec['segred_events']} launches")
        for top in rec["top"]:
            say("profile", f"  {top['device_s']:.5f} s  x{top['count']}  "
                           f"{top['name']}")
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    t_run = time.perf_counter()
    kind, smi_line = phase_device()
    import torch
    with phase_wall("build"):
        build, yardsticks = phase_build()
    with phase_wall("kernels segred"):
        rows = phase_kernels(yardsticks)
    with phase_wall("kernels wkv6"):
        wkv_rows = phase_wkv6(yardsticks)
    with phase_wall("kernels flash_attn"):
        flash_rows = phase_flash()
    with phase_wall("main"):
        runs, launches, direct = phase_main()
    with phase_wall("search"):
        search, search_launches = phase_search(smi_line)
    references = References()
    fleet, fleet_launches = phase_fleet(smi_line, references)
    with phase_wall("comap"):
        comap, comap_launches = phase_comap(smi_line, references)
    with phase_wall("service"):
        service, service_launches = phase_service(smi_line, direct)
    with phase_wall("devices"):
        devices, devices_launches = phase_devices(smi_line)
    references.start()
    try:
        with phase_wall("lm"):
            model, batch, lm = phase_lm()
        with phase_wall("lm-dense"):
            dense_model, dense_batch, dense = phase_lm_dense()
        with phase_wall("numpy references (wait after lm-dense)"):
            references.check()
    finally:
        references.stop()
    with phase_wall("serve"):
        served = phase_serve(smi_line)
    for row in fleet:
        row.pop("results")
    WALLS["run before --profile"] = time.perf_counter() - t_run
    say("wall", ", ".join(f"{k} {v:.1f} s" for k, v in WALLS.items()))
    profiled = None
    if "--profile" in sys.argv[1:]:
        profiled = {"mapping": phase_profile(runs),
                    "search": phase_profile_search(search),
                    "fleet": phase_profile_fleet(fleet),
                    "segred": phase_profile_segred(yardsticks),
                    "lm": phase_profile_lm("lm", model, batch, lm,
                                           "wkv6_chunk_kernel"),
                    "lm-dense": phase_profile_lm("lm-dense", dense_model,
                                                 dense_batch, dense,
                                                 "flash_attn_mma_kernel"),
                    "serve": phase_profile_serve(served)}

    main_row = next(r for r in rows if (r["N"], r["n"]) == SEGRED_SHAPES[0]
                    and r["dtype"] == "float32" and r["op"] == "max")
    lm_row = next(r for r in wkv_rows
                  if tuple(r["shape"]) == WKV_LM_SHAPE)
    dense_row = next(r for r in flash_rows
                     if tuple(r["shape"]) == FLASH_LM_SHAPE
                     and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "segred", "route": "cuda",
        "source": "src/repro_torch/csrc/segred.cu",
        "replaces": "src/repro/core/accel/pallas_segred.py:31",
        "launches": launches + search_launches + fleet_launches
        + comap_launches + service_launches + devices_launches
        + sum(r["launches"]["segred"] for r in served["runs"]),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:27",
        "launches": lm["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        "ms": lm_row["ms"], "plain_ms": lm_row["plain_ms"],
        "bound_ms": lm_row["bound_ms"], "bound_by": lm_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": dense["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": dense_row["ms"], "plain_ms": dense_row["plain_ms"],
        "bound_ms": dense_row["bound_ms"], "bound_by": dense_row["bound_by"],
        "library_ms": dense_row["library_ms"],
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build": {name: {k: info[k] for k in ("seconds", "cached", "ptxas")}
                  for name, info in build.items()},
        "segred": rows, "wkv6": wkv_rows, "flash_attn": flash_rows,
        "main": runs, "search": search, "fleet": fleet, "comap": comap,
        "service": service, "devices": devices, "lm": lm,
        "walls_s": WALLS,
        "lm_dense": dense, "serve": served,
        "profile": profiled, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
