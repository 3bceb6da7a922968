"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

Two learnable synthetic tasks, numpy-seeded, so their batches equal the
reference's exactly:

  * SyntheticImageDataset: a class-conditional image distribution (random
    class templates + noise), CIFAR-shaped, for the paper repro.
  * SyntheticTokenDataset: LM sequences from a deterministic successor
    table, so next-token loss is reducible.

Labels and tokens come as int64, the index type torch's embeddings and
losses take (the reference's are int32; the values are equal).  The
dry-run ``input_specs`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticImageDataset:
    n_classes: int = 10
    shape: tuple = (3, 32, 32)
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.normal(size=(self.n_classes, *self.shape)).astype(np.float32)

    def batch(self, batch_size: int, step: int, device="cuda"):
        rng = np.random.default_rng((self.seed, step))
        y = rng.integers(0, self.n_classes, size=batch_size)
        x = self.templates[y] + self.noise * rng.normal(
            size=(batch_size, *self.shape)).astype(np.float32)
        return {"x": torch.from_numpy(x).to(device),
                "y": torch.from_numpy(y.astype(np.int64)).to(device)}


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    n_patterns: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # deterministic successor table: tok -> likely next tok (learnable)
        self.successor = rng.integers(0, self.vocab_size, size=self.vocab_size)

    def batch(self, batch_size: int, step: int, device="cuda"):
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch_size, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch_size)
        for t in range(1, self.seq_len + 1):
            follow = self.successor[toks[:, t - 1]]
            rand = rng.integers(0, self.vocab_size, size=batch_size)
            use_follow = rng.random(batch_size) < 0.8
            toks[:, t] = np.where(use_follow, follow, rand)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}


def make_batch_iterator(dataset, batch_size: int, start_step: int = 0,
                        device="cuda") -> Iterator:
    step = start_step
    while True:
        yield dataset.batch(batch_size, step, device=device)
        step += 1
