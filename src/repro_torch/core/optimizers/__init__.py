"""The paper's three optimisers, each with a torch engine: brute force,
simulated annealing and the rule-based optimiser (Algorithm 2)."""
from repro_torch.core.optimizers.common import (
    OptimResult,
    incumbent_better,
    repair,
)
from repro_torch.core.optimizers.brute_force import optimise as brute_force
from repro_torch.core.optimizers.annealing import \
    optimise as simulated_annealing
from repro_torch.core.optimizers.rule_based import optimise as rule_based

OPTIMIZERS = {
    "brute_force": brute_force,
    "annealing": simulated_annealing,
    "rule_based": rule_based,
}

__all__ = ["OptimResult", "repair", "incumbent_better", "brute_force",
           "simulated_annealing", "rule_based", "OPTIMIZERS"]
