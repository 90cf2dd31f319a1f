"""Assigned input shapes for the LM-family architectures (40 cells total).

``step`` selects which program the dry-run lowers:
  train   -> train_step(tokens, labels)
  prefill -> prefill_step(tokens) -> logits + KV cache
  decode  -> serve_step(one new token against a pre-filled KV cache)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and if not, why (documented skips)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def cells(cfg: ArchConfig):
    """All applicable (shape, skip_reason) pairs for an architecture."""
    out = []
    for s in ALL_SHAPES:
        ok, why = applicable(cfg, s)
        out.append((s, ok, why))
    return out
