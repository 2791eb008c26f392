"""PyTorch/CUDA port of the SAMO mapping engine.

A second package beside ``repro`` (the JAX reference). It mirrors the JAX
package's module layout and names; the host layers (configs, graph builder,
platform, backends, performance model, constraints, objectives, the numpy
engine, the exporter, telemetry and Algorithm 2's merge loop) are the port's
own copies, and the device engine (``core/accel``) runs on a CUDA card with
the partition-time reduction in a hand-written kernel (``csrc/segred.cu``).

    from repro_torch.core.pipeline import optimise_mapping
    plan = optimise_mapping(arch, shape, platform, engine="torch")

The LM stack (``models``), its serve loop (``launch.serve``: prefill, then
greedy decode against a cache) and its train loop (``launch.train``:
``data``, ``optim``, ``checkpoint``, ``runtime``) run on the card as well.

Entry points run on ``cuda``; pass ``device="cpu"`` to run the kernels'
plain PyTorch versions on the CPU instead (the tests do). Importing the
package turns TF32 matmuls off (``runtime``).
"""
from repro_torch import runtime  # noqa: F401  (sets the float32 matmul policy)
