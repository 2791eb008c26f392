from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
    latest_step,
)
from repro_torch.checkpoint.elastic import reshard_tree

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step", "reshard_tree"]
