"""Int8 gradient compression with a shared scale and error feedback, for
the cross-pod data-parallel axis, where wire bandwidth is scarcest.

Per flat gradient chunk (the JAX package's ``parallel/compress.py``):
  1. scale = pmax(max|g + err|) / 127   one max over the pod ranks, so every
                                        rank quantises on the same grid
  2. q = round((g + err) / scale)       int8 values, summed as int32
  3. s = psum(q)                        over the pod ranks
  4. g_hat = s * scale
  5. err <- (g + err) - q * scale       the rank's quantisation residual,
                                        carried into the next step
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.model.params import tree_leaves, tree_map
from repro_torch.parallel.context import ParallelContext


@torch.no_grad()
def compress_psum(g: torch.Tensor, pc: Optional[ParallelContext],
                  err: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce ``g`` over the pod ranks of ``pc`` in int8 (``pc`` None:
    one rank, no comms). Returns (sum, new_err), both fp32."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    amax = torch.amax(torch.abs(g32))
    if pc is not None:
        amax = pc.pmax_pod(amax)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    new_err = g32 - q * scale
    qsum = q.to(torch.int32)
    if pc is not None:
        qsum = pc.psum_pod(qsum)
    return qsum.float() * scale, new_err


def compress_psum_tree(grads, pc: Optional[ParallelContext], errs=None):
    """``compress_psum`` leaf by leaf over a tree of gradients; ``errs``
    (a tree like it) None starts every error at zero. Returns (the tree of
    sums, the tree of new errors)."""
    gl = tree_leaves(grads)
    el = tree_leaves(errs) if errs is not None else [None] * len(gl)
    pairs = [compress_psum(g, pc, e) for g, e in zip(gl, el)]
    sums, new = iter([s for s, _ in pairs]), iter([e for _, e in pairs])
    return tree_map(lambda _: next(sums), grads), tree_map(lambda _: next(new), grads)
