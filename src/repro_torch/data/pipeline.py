"""Deterministic sharded synthetic token pipeline.

Fault-tolerance contract: batch content is a pure function of (seed, step,
host shard), so a restart resumes from any step with O(1) ``skip_to`` — no
replay, no data loss, and elastic re-sharding (changing host count) keeps
the global batch stream identical.

The synthetic stream is a Zipf-ish mixture over the vocab with a repeating
n-gram backbone so the LM loss actually decreases during the example runs.

The port's copy of the JAX package's ``data/pipeline.py``: the numpy
stream is the original's, so tokens and labels are bitwise JAX's for every
(seed, step, host layout). ``batch_at`` returns int32 torch tensors on the
pipeline's ``device``: the card unless the caller asks for another
(``runtime.resolve_device``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.runtime import resolve_device


@dataclass
class DataPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2
    device: Any = None

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = self.global_batch // self.host_count
        self._step = 0

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step, host shard): the FT contract."""
        rows = []
        for b in range(self.local_batch):
            global_row = self.host_index * self.local_batch + b
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, global_row]))
            rows.append(self._sequence(rng))
        tokens = torch.from_numpy(np.stack(rows)).to(
            resolve_device(self.device))                    # (local_B, S+1)
        return {
            "tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous(),
        }

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        S = self.seq_len + 1
        V = self.vocab_size
        # repeating n-gram backbone + Zipf noise => learnable structure
        period = 16
        motif = rng.integers(2, min(V, 512), period)
        seq = np.tile(motif, S // period + 1)[:S].copy()
        noise_mask = rng.random(S) < 0.15
        zipf = np.minimum(rng.zipf(1.5, S) + 1, V - 1)
        seq[noise_mask] = zipf[noise_mask]
        return seq.astype(np.int32)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, torch.Tensor]:
        out = self.batch_at(self._step)
        self._step += 1
        return out

    def skip_to(self, step: int) -> None:
        """O(1) restart positioning (no replay)."""
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    def reshard(self, host_index: int, host_count: int) -> "DataPipeline":
        """Elastic re-sharding: same global stream, new host layout."""
        return DataPipeline(self.vocab_size, self.seq_len, self.global_batch,
                            self.seed, host_index, host_count, self.prefetch,
                            self.device)


def make_pipeline(arch, shape, seed: int = 0, host_index: int = 0,
                  host_count: int = 1, device=None) -> DataPipeline:
    return DataPipeline(arch.vocab_size, shape.seq_len, shape.global_batch,
                        seed, host_index, host_count, device=device)
