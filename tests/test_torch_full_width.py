"""The rule-based optimiser at full width: tinyllama-1.1b on train_4k and
the default target V5E_POD (47 nodes, a 3-value fold menu, 28-row probe
batches). The port's torch engine (``device="cpu"``: the kernels' plain
versions) walks the JAX engine's exact move sequence and lands on the
recorded results."""
import pytest
import torch  # noqa: F401

jax = pytest.importorskip("jax")  # the reference; JAX_PLATFORMS=cpu

from _torch_support import port_obs_reset, to_port  # noqa: E402,F401
from repro.core.optimizers import rule_based as ref_rule_based  # noqa: E402
from repro_torch.core.optimizers import rule_based  # noqa: E402


#: the JAX package's results at full width (repro, engine="jax" and
#: engine="numpy" agree): points, objective, partitions, history length
FULL_WIDTH = {
    ("streaming", "throughput"): (3288, -0.4505275627007433, 24, 3),
    ("spmd", "latency"): (4031, 0.22177328183717918, 1, 3),
}


@pytest.mark.parametrize("exec_model,objective", sorted(FULL_WIDTH))
def test_full_width_tinyllama_train_4k(exec_model, objective):
    from repro.configs import SHAPES_BY_NAME as R_SHAPES, get_arch as r_arch
    from repro.core.pipeline import make_problem as r_make
    from repro.core.platform import V5E_POD as R_POD
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.core.pipeline import make_problem
    from repro_torch.core.platform import V5E_POD

    ref = ref_rule_based(r_make(r_arch("tinyllama-1.1b"),
                                R_SHAPES["train_4k"], R_POD, "spmd",
                                objective, exec_model), engine="jax")
    prob = make_problem(get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"],
                        V5E_POD, "spmd", objective, exec_model)
    assert len(prob.graph.nodes) == 47
    got = rule_based(prob, engine="torch", device="cpu")
    assert got.points == ref.points
    assert got.variables == to_port(ref.variables)
    assert got.history == ref.history
    assert got.evaluation.objective == ref.evaluation.objective
    points, value, parts, hist = FULL_WIDTH[(exec_model, objective)]
    assert (got.points, got.evaluation.objective,
            len(got.variables.cuts) + 1, len(got.history)) == \
        (points, value, parts, hist)
