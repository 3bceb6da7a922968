"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

``SyntheticImageDataset`` only: a class-conditional image distribution
(random class templates + noise), CIFAR-shaped, for the paper repro.  It is
numpy-seeded, so its batches equal the reference's exactly; labels come as
int64, the index type torch's losses take.
"""
from __future__ import annotations

import dataclasses

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
