"""Optimisers ported so far. Only the rule-based optimiser (Algorithm 2)
has a torch engine in this slice; brute force and annealing are still to
port (ROADMAP Queue 1, items 3 and 5)."""
from repro_torch.core.optimizers.common import (
    OptimResult,
    incumbent_better,
    repair,
)
from repro_torch.core.optimizers.rule_based import optimise as rule_based

OPTIMIZERS = {
    "rule_based": rule_based,
}

#: optimisers of the JAX package that the port does not have yet, with the
#: ROADMAP item that ports each
NOT_PORTED = {
    "brute_force": "ROADMAP Queue 1, item 3 (brute force on device)",
    "annealing": "ROADMAP Queue 1, item 5 (multi-chain SA)",
}

__all__ = ["OptimResult", "repair", "incumbent_better", "rule_based",
           "OPTIMIZERS", "NOT_PORTED"]
