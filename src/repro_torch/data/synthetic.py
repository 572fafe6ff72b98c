"""Synthetic LM data pipeline with a checkpointable cursor (the JAX
package's ``repro.data.synthetic``).

Deterministic: batch(i) is a pure function of (seed, i), made with numpy
as the JAX package makes it, so the batches are bitwise that package's
and a restored run resumes the exact stream. They are returned as
tensors on the pipeline's device.

The token stream is Zipf-ish (realistic embedding-gather skew) and labels
are next-token shifted.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

IGNORE_LABEL = -1


@dataclasses.dataclass
class DataCursor:
    seed: int
    step: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int, *,
                 seed: int = 0, device=None):
        """Batches land on ``device`` (default: the CUDA card)."""
        from repro_torch.api import resolve_device
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.cursor = DataCursor(seed=seed)
        self.device = resolve_device(device)

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.cursor.seed, step))
        # Zipf-like skew clipped to the vocab.
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        return (z % self.cfg.vocab_size).astype(np.int32)

    def next_batch(self) -> dict:
        cfg = self.cfg
        toks = self._tokens(self.cursor.step)
        self.cursor.step += 1
        tokens = toks[:, :-1]
        labels = toks[:, 1:].copy()
        batch = {}
        if cfg.frontend == "audio":
            rng = np.random.default_rng((self.cursor.seed, self.cursor.step,
                                         7))
            batch["embeds"] = rng.standard_normal(
                (self.batch, self.seq_len, cfg.d_model)).astype(np.float32)
            batch["labels"] = labels
        elif cfg.frontend == "vision":
            nv = cfg.n_frontend_tokens
            rng = np.random.default_rng((self.cursor.seed, self.cursor.step,
                                         11))
            batch["tokens"] = tokens[:, :self.seq_len - nv]
            batch["labels"] = labels[:, :self.seq_len - nv]
            batch["vision_embeds"] = rng.standard_normal(
                (self.batch, nv, cfg.d_model)).astype(np.float32)
        else:
            batch["tokens"] = tokens
            batch["labels"] = labels
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   device=self.device)
                for k, v in batch.items()}

    # --- checkpointable cursor ------------------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.cursor)

    def load_state_dict(self, d: dict) -> None:
        self.cursor = DataCursor(**d)
