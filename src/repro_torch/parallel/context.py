"""Explicit-collective parallel context, backed by ``torch.distributed``.

All model code takes a ``ParallelContext`` and calls its collective helpers,
with the method names of the JAX package's context. Where the JAX package
runs one program inside ``shard_map``, the port runs one process per tensor
parallel rank: every rank executes the same code on its own shard of the
weights (SPMD), and the context's collectives are ``all_reduce`` calls over
the ranks' process group.

At ``tp_size`` 1 every helper is the identity and there is no group. Above
1 the context carries its rank and the group; a context without a group
raises at its first collective instead of running as one rank. Build it
with ``make_context`` from an initialised group, or ``init_context``, which
also initialises the group with the backend the caller names: ``"nccl"``
for one card per rank, or ``"gloo"`` (CUDA or CPU tensors; several ranks may
share one card). Nothing picks a backend for the caller.

``ALL_REDUCES`` counts the ``all_reduce`` calls the contexts make, by
operation, as ``kernels.ops.LAUNCHES`` counts kernel launches: it moves
only where a collective is issued (never at tp = 1, where every helper is
the identity), so a caller can hold a step's count to LP's halving (an LP
pair's phase syncs once where two layers sync twice). ``ALL_GATHERS``
counts the ``all_gather_tp`` calls beside it (the sequence-sharded kv
cache's q gather), so a gather's own all_reduce is not read as a phase
sum. ``reset_all_reduces`` sets both to zero.

Serving only: sequence parallelism (``sp=True``) at tp > 1 raises, and so
does a collective on a tensor that autograd tracks (the sharded trainer is
ROADMAP item 10.3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

#: all_reduce calls issued by the contexts of this process, by operation.
ALL_REDUCES = {"sum": 0, "max": 0}
#: all_gather_tp calls issued by the contexts of this process.
ALL_GATHERS = {"gather": 0}


def reset_all_reduces() -> None:
    """Zero ``ALL_REDUCES`` and ``ALL_GATHERS``."""
    for counts in (ALL_REDUCES, ALL_GATHERS):
        for op in counts:
            counts[op] = 0


@dataclass(frozen=True)
class ParallelContext:
    tp_size: int = 1
    rank: int = 0               # this process's rank in ``group``
    group: Any = None           # torch.distributed process group of the tp ranks
    sp: bool = False            # sequence-parallel residual stream
    seq_axis: int = 1           # which tensor dim is "sequence" in activations

    def __post_init__(self):
        if self.tp_size < 1 or not 0 <= self.rank < self.tp_size:
            raise ValueError(f"rank {self.rank} of tp_size {self.tp_size}")
        if self.tp_size > 1 and self.sp:
            raise NotImplementedError(
                "sequence parallelism (sp=True) at tp > 1 belongs to the "
                "sharded trainer, which is not ported yet: ROADMAP item 10.3")

    @property
    def tp(self) -> int:
        return self.tp_size

    def with_sp(self, sp: bool) -> "ParallelContext":
        return replace(self, sp=sp)

    def tp_index(self) -> int:
        return self.rank

    # -- collectives over the TP axis (identity at world size 1) --------
    def _check(self, x: torch.Tensor) -> None:
        if self.group is None:
            raise RuntimeError(
                f"a tp_size={self.tp_size} context has no process group: "
                "build it with make_context() from an initialised "
                "torch.distributed group")
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "a collective under autograd: the sharded trainer is not "
                "ported yet (ROADMAP item 10.3); serve under torch.no_grad()")

    def _all_reduce(self, x: torch.Tensor, op, name: str) -> torch.Tensor:
        self._check(x)
        y = x.contiguous().clone()   # in place on a copy: x stays as it was
        dist.all_reduce(y, op=op, group=self.group)
        ALL_REDUCES[name] += 1
        return y

    def psum_tp(self, x):
        if self.tp_size == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.SUM, "sum")

    def pmax_tp(self, x):
        if self.tp_size == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.MAX, "max")

    def all_gather_tp(self, x, axis: int, *, tiled: bool = True):
        """The ranks' ``x`` in rank order: concatenated along ``axis``
        (``tiled``), or stacked on a new axis ``axis``, as JAX's
        ``lax.all_gather``. Each rank writes its ``x`` into its block of a
        zero buffer of the full size and one all_reduce(SUM) adds the
        blocks, which is exact (x + 0 == x) and runs on every backend:
        gloo's ``all_gather`` takes CPU tensors only, its all_reduce CUDA
        ones too. Counted in ``ALL_GATHERS``, not ``ALL_REDUCES``."""
        if self.tp_size == 1:
            return x if tiled else x.unsqueeze(axis)
        self._check(x)
        buf = x.new_zeros((self.tp_size, *x.shape))
        buf[self.rank] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        ALL_GATHERS["gather"] += 1
        if not tiled:
            return buf.movedim(0, axis)
        return torch.cat(buf.unbind(0), dim=axis)

    # -- phase boundaries (the paper's sync points) ---------------------
    # A phase is one column-parallel -> local -> row-parallel region; an LP
    # pair runs two layers' phase in one, so it syncs once where two layers
    # sync twice. Without sequence parallelism the entry is the identity and
    # the exit one all-reduce.
    def phase_in(self, x, axis: Optional[int] = None):
        """Enter a TP phase: make the activation full-sequence."""
        return x

    def phase_out(self, x, axis: Optional[int] = None):
        """Exit a TP phase: combine row-parallel partial sums."""
        return self.psum_tp(x)

    def shard_seq(self, x):
        """Slice a replicated activation down to this rank's seq shard
        (the identity without sequence parallelism)."""
        return x


def make_context(group=None, *, sp: bool = False) -> ParallelContext:
    """The context of this process in an initialised process group
    (``group`` None: the default group). One rank gives the identity
    context with no group."""
    if not dist.is_initialized():
        raise RuntimeError("make_context needs an initialised torch.distributed "
                           "process group (init_context, or "
                           "torch.distributed.init_process_group)")
    size = dist.get_world_size(group)
    if size == 1:
        return ParallelContext(sp=sp)
    return ParallelContext(tp_size=size, rank=dist.get_rank(group),
                           group=group if group is not None else dist.group.WORLD,
                           sp=sp)


def init_context(*, backend: str, init_method: str, world_size: int,
                 rank: int) -> ParallelContext:
    """Initialise the default process group with ``backend`` ("nccl": one
    card per rank; "gloo": CUDA or CPU tensors, ranks may share a card)
    and return this rank's context. ``init_method`` is where the ranks
    meet: ``tcp://localhost:<port>`` or ``file://<path>``. The caller
    places its tensors (``torch.cuda.set_device`` for NCCL) and ends the
    group with ``torch.distributed.destroy_process_group``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return make_context()
