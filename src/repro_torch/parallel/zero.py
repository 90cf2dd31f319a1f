"""ZeRO-style flat sharding of optimizer state over the data-parallel axes.

Every parameter tensor is flattened to 1D, padded to a multiple of the dp
world size, and viewed as ``(dp_size, chunk)``; rank ``i`` owns row ``i``.
Gradients are combined with one sum-and-scatter (``psum_scatter_dp``),
updates run on the owned shard only, and fresh forward weights are rebuilt
with one ``all_gather_dp``. The JAX package's ``parallel/zero.py`` on the
port's tensors and context; the helpers run under ``torch.no_grad``.
"""
from __future__ import annotations

import torch

from repro_torch.model.params import tree_map
from repro_torch.parallel.context import ParallelContext


def _pad_len(n: int, dp: int) -> int:
    return (-n) % dp


def flatten_leaf(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Full tensor -> (dp, chunk) view, zero-padded at the end (no comms)."""
    flat = x.reshape(-1)
    pad = _pad_len(flat.numel(), dp)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(dp, -1)


def unflatten_leaf(flat2d: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return flat2d.reshape(-1)[:n].reshape(shape).to(dtype)


def shard_tree(tree, pc: ParallelContext):
    """Keep only this dp rank's flat shard of every leaf (no comms; at init,
    where every rank starts from the same values)."""
    return tree_map(lambda x: flatten_leaf(x, pc.dp_size)[pc.dp_index()], tree)


@torch.no_grad()
def scatter_grads(grads, pc: ParallelContext):
    """Sum gradients across dp and return each rank's fp32 flat shard
    (ZeRO-2): one sum-and-scatter per leaf."""
    return tree_map(lambda g: pc.psum_scatter_dp(
        flatten_leaf(g.float(), pc.dp_size), axis=0)[0], grads)


@torch.no_grad()
def gather_params(shards, like, pc: ParallelContext, dtype=torch.bfloat16):
    """Rebuild full (per-tp-shard) parameter tensors from flat dp shards:
    one gather per leaf."""
    return tree_map(lambda s, ref: unflatten_leaf(pc.all_gather_dp(s[None, :], axis=0),
                                                  ref.shape, dtype), shards, like)
