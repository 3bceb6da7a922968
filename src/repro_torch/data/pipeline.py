"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

Two learnable synthetic tasks, numpy-seeded, so their batches equal the
reference's exactly:

  * SyntheticImageDataset: a class-conditional image distribution (random
    class templates + noise), CIFAR-shaped, for the paper repro.
  * SyntheticTokenDataset: LM sequences from a deterministic successor
    table, so next-token loss is reducible.

``input_specs(cfg, shape)`` gives the batches every dry run traces, as
empty ``meta`` tensors (nothing allocated; the one carve-out for vlm/audio:
precomputed patch/frame embeddings).

Labels and tokens come as int64, the index type torch's embeddings and
losses take (the reference's are int32; the values are equal).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


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


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors only: zero allocation)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k":    dict(seq_len=4096,    global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,   global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,   global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288,  global_batch=1,   kind="decode"),
}


def input_specs(cfg: ModelConfig, shape_name: str, dtype=torch.bfloat16):
    """Dry-run batch for (arch, input shape), on ``meta``.

    train/prefill: {"tokens", "labels" (train only), ["frontend"]}; a VLM's
    patches take ``frontend_seq`` of the total sequence.  decode: {"tokens"
    (B, 1)}; the cache comes from ``lm.abstract_decode_cache``.
    """
    spec = SHAPES[shape_name]
    B, S = spec["global_batch"], spec["seq_len"]

    def meta(shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device="meta")

    if spec["kind"] == "decode":
        return {"tokens": meta((B, 1))}
    out = {}
    if cfg.frontend and not cfg.is_encdec:
        s_text = S - cfg.frontend_seq
        out["tokens"] = meta((B, s_text))
        out["frontend"] = meta((B, cfg.frontend_seq, cfg.frontend_dim), dtype)
        if spec["kind"] == "train":
            out["labels"] = meta((B, s_text))
        return out
    out["tokens"] = meta((B, S))
    if cfg.is_encdec:
        out["frontend"] = meta((B, cfg.frontend_seq, cfg.frontend_dim), dtype)
    if spec["kind"] == "train":
        out["labels"] = meta((B, S))
    return out
