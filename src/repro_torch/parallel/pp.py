"""GPipe-style pipeline parallelism over a group of stage ranks.

Each stage rank holds the weights of its contiguous range of layers
(``stage_slice``). The schedule runs ``n_micro + n_stages - 1`` ticks; at
every tick each stage runs one microbatch slot and the activations move one
hop downstream. The JAX package moves them with one ``ppermute`` over its
"pipe" mesh axis; here, as every collective of ``parallel/context.py``, the
hop is one all_reduce: each stage writes its output into its block of a
zero buffer, the sum gathers the blocks, and each stage takes its upstream
neighbour's (``ALL_GATHERS`` counts it). A last sum replicates the last
stage's outputs on every stage (``ALL_REDUCES``).

The stage group is the world (``pipe_group()``) or a subgroup of it
(``pipe_group(ranks)``); the grid of ``make_grid_context`` has no pipeline
axis, as the JAX package's context has none. The schedule runs forward
only: no caller of the JAX package differentiates it, and the port's
raises on a tensor that autograd tracks.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.context import _gather, _refuse_tracked, _sum


def pipe_group(ranks: Optional[Sequence[int]] = None) -> Tuple[Any, int]:
    """(process group, this process's stage) of a pipeline over ``ranks``,
    world ranks in stage order (None: the whole world, stage = world rank).
    Every rank of the world calls it, in the same order, as
    ``dist.new_group`` requires; a rank outside ``ranks`` gets (None, -1)."""
    if not dist.is_initialized():
        raise RuntimeError("pipe_group needs an initialised torch.distributed world")
    if ranks is None:
        return dist.group.WORLD, dist.get_rank()
    ranks = list(ranks)
    group = dist.new_group(ranks)
    me = dist.get_rank()
    return (group, ranks.index(me)) if me in ranks else (None, -1)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, *, group: Any,
                   stage: int, n_stages: int) -> torch.Tensor:
    """Run ``x_micro`` [n_micro, micro_batch, ...] through ``n_stages``
    pipeline stages; this process is stage ``stage`` of ``group``.

    ``stage_fn(params, x) -> y`` is this rank's stage (closed over any inner
    context), with y of x's shape. Every stage passes the same ``x_micro``
    (stage 0 reads it). Returns the last stage's outputs in microbatch
    order, of ``x_micro``'s shape and type, on every stage."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} of {n_stages}")
    if n_stages > 1 and (group is None or dist.get_world_size(group) != n_stages):
        raise ValueError(f"{n_stages} stages need a group of {n_stages} ranks")
    n_micro = x_micro.shape[0]
    _refuse_tracked(x_micro, "pipeline_apply")
    buf = torch.zeros_like(x_micro[0])     # the activation entering this stage
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t (the last one again past the end: its
        # outputs are never recorded); the others take the buffer.
        y = stage_fn(stage_params, x_micro[min(t, n_micro - 1)] if stage == 0 else buf)
        _refuse_tracked(y, "pipeline_apply")
        slot = t - (n_stages - 1)
        if stage == n_stages - 1 and slot >= 0:
            outs[slot] = y.to(outs.dtype)
        if n_stages > 1:    # one hop downstream: stage s takes stage s - 1's
            buf = _gather(y, group, n_stages, stage, 0, tiled=False,
                          what="pipe")[(stage - 1) % n_stages]
    if n_stages == 1:
        return outs
    return _sum(outs if stage == n_stages - 1 else torch.zeros_like(outs), group,
                n_stages, "pipe")


def stage_slice(n_layers: int, n_stages: int, stage: int) -> Tuple[int, int]:
    """Contiguous layer range [lo, hi) owned by ``stage`` (balanced split)."""
    base, rem = divmod(n_layers, n_stages)
    lo = stage * base + min(stage, rem)
    hi = lo + base + (1 if stage < rem else 0)
    return lo, hi
