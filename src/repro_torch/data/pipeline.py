"""Deterministic, restart-safe data pipeline.

The contract the fault-tolerance story needs: ``batch_at(step)`` is a pure
function of (seed, step), so a job restarted from checkpoint step N resumes
with EXACTLY the batch it would have seen, with no iterator state to
persist.

Two sources, as in the JAX package:
  * SyntheticSource: the ``data.synthetic`` mixture, drawn from a
    ``torch.Generator`` seeded by (seed, step) (no files needed)
  * TokenFileSource: a memmapped flat token file (uint16/uint32), sliced
    into seq_len windows with a per-epoch permutation; numpy only, so its
    batches equal the JAX package's token for token
Both produce global batches of int64 CPU tensors; the caller moves them to
the device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import SynthConfig, lm_batch


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 32
    seed: int = 0
    source: str = "synthetic"      # synthetic | file
    path: Optional[str] = None     # token file for source="file"


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded by (seed, step): one stream per step. The
    pair is mixed into 32 bits by numpy's ``SeedSequence`` (the CPU
    generator, a Mersenne twister, keeps 32 bits of its seed)."""
    if seed < 0 or step < 0:
        raise ValueError(f"seed {seed} and step {step} must be >= 0")
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint32)[0]
    return torch.Generator().manual_seed(int(mixed))


class SyntheticSource:
    def __init__(self, dc: DataConfig, sc: SynthConfig):
        self.dc, self.sc = dc, sc

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return lm_batch(step_generator(self.dc.seed, step), self.sc,
                        self.dc.seq_len, self.dc.global_batch)


class TokenFileSource:
    """Flat binary token file -> deterministic shuffled windows."""

    def __init__(self, dc: DataConfig, dtype=np.uint16):
        if not (dc.path and os.path.exists(dc.path)):
            raise FileNotFoundError(dc.path)
        self.dc = dc
        self.data = np.memmap(dc.path, dtype=dtype, mode="r")
        self.n_windows = (len(self.data) - 1) // dc.seq_len
        if self.n_windows < dc.global_batch:
            raise ValueError(f"{dc.path}: {self.n_windows} windows of "
                             f"{dc.seq_len}, fewer than a batch of "
                             f"{dc.global_batch}")

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.dc.seed + 7919 * epoch)
        return rng.permutation(self.n_windows)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        bpe = self.n_windows // self.dc.global_batch  # batches per epoch
        epoch, off = divmod(step, bpe)
        perm = self._perm(epoch)
        idx = perm[off * self.dc.global_batch:(off + 1) * self.dc.global_batch]
        rows = np.stack([self.data[i * self.dc.seq_len:
                                   i * self.dc.seq_len + self.dc.seq_len + 1]
                         for i in idx]).astype(np.int64)
        return {"tokens": torch.from_numpy(rows[:, :-1].copy()),
                "labels": torch.from_numpy(rows[:, 1:].copy())}


def make_source(dc: DataConfig, sc: Optional[SynthConfig] = None):
    if dc.source == "synthetic":
        return SyntheticSource(dc, sc or SynthConfig())
    if dc.source == "file":
        return TokenFileSource(dc)
    raise ValueError(dc.source)
