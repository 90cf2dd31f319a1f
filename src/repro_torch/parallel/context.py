"""Explicit-collective parallel context.

All model code takes a ``ParallelContext`` and calls its collective helpers,
with the method names of the JAX package's context. At world size 1 every
helper is the identity, which is all this package runs so far: a tensor
parallel degree above 1 raises ``NotImplementedError`` (the
``torch.distributed`` backing comes later).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ParallelContext:
    tp_size: int = 1
    sp: bool = False            # sequence-parallel residual stream
    seq_axis: int = 1           # which tensor dim is "sequence" in activations

    def __post_init__(self):
        if self.tp_size != 1:
            raise NotImplementedError(
                f"tensor parallelism (tp_size={self.tp_size}) is not ported "
                "yet; the port runs at world size 1")

    @property
    def tp(self) -> int:
        return self.tp_size

    def with_sp(self, sp: bool) -> "ParallelContext":
        return replace(self, sp=sp)

    def tp_index(self) -> int:
        return 0

    # -- collectives over the TP axis (identity at world size 1) --------
    def psum_tp(self, x):
        return x

    def pmax_tp(self, x):
        return x

    # -- phase boundaries (the paper's sync points) ---------------------
    def phase_in(self, x, axis: Optional[int] = None):
        """Enter a TP phase: make the activation full-sequence."""
        return x

    def phase_out(self, x, axis: Optional[int] = None):
        """Exit a TP phase: combine row-parallel partial sums."""
        return self.psum_tp(x)

    def shard_seq(self, x):
        """Slice a replicated activation down to this rank's seq shard."""
        return x
