"""FSDP / ZeRO-3 sharding of the layer-stack parameters.

FSDP stores each SEGMENT's parameters as flat shards over the intra-pod
``data`` ranks and gathers ONE GROUP's weights inside the stack loop, so
the full tensors are alive only while that group computes:

    peak = all flat shards (params / data) + one group's full tp-local tensors

The gather's backward sums the gradient over the same ranks and keeps the
rank's block (``ParallelContext.all_gather_data``): gradients arrive summed
over ``data`` and sharded exactly like the parameters, which is the ZeRO-3
gradient reduction with no extra trainer code.

Layout per segment leaf (GLOBAL view):
    (count, data, tp, chunk)
with chunk = ceil(prod(tp-local group-leaf shape) / data); a rank holds
its (count, 1, 1, chunk) view. The gather runs over ``data`` only, never
across pods: across pods the shards are replicated and their gradients
summed (optionally int8-compressed). The JAX package's ``parallel/
fsdp.py``.

Serving may keep the shards as int8 (``quantize_segment``): one fp32 scale
per block of ``QBLOCK`` values of a rank's chunk, so the per-token gathers
of FSDP decode move half the bytes and the resident shards take half the
memory. ``make_gather_fn_q`` gathers the int8 values and the scales and
dequantises each rank's chunk with that rank's own scales. (The JAX
package's gather dequantises blocks of the concatenated chunks, so where a
chunk is not a whole number of blocks, the blocks after the first rank's
chunk read another rank's scale: ROADMAP §3.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as NF

from repro_torch.model.params import PD, local_shape, shard_slice, tree_leaves, tree_map
from repro_torch.parallel.context import ParallelContext


@dataclass(frozen=True)
class SegMeta:
    """Static description of one FSDP segment's flat layout (one GROUP's
    template; the count axis is handled outside). Leaves in ``tree_leaves``
    order of ``tmpl``."""

    tmpl: Any                                   # the group's PD tree
    global_shapes: Tuple[Tuple[int, ...], ...]
    local_shapes: Tuple[Tuple[int, ...], ...]   # tp-local, without count
    chunks: Tuple[int, ...]
    sharded_dims: Tuple[Optional[int], ...]     # the axis tp splits
    parts: Tuple[int, ...]                      # blocks along that axis
    wd_flags: Tuple[float, ...]
    count: int

    @property
    def tp_flags(self) -> Tuple[bool, ...]:
        return tuple(d is not None for d in self.sharded_dims)

    def unflatten(self, leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), self.tmpl)


def segment_meta(group_tmpl, count: int, *, tp: int, data: int) -> SegMeta:
    pds = tree_leaves(group_tmpl)
    loc = [local_shape(pd, tp) for pd in pds]
    return SegMeta(group_tmpl, tuple(tuple(pd.shape) for pd in pds), tuple(loc),
                   tuple(-(-math.prod(s) // data) for s in loc),
                   tuple(pd.split for pd in pds), tuple(pd.parts for pd in pds),
                   tuple(1.0 if len(pd.shape) >= 2 else 0.0 for pd in pds), count)


def flat_segment_pds(meta: SegMeta, *, data: int, tp: int):
    """PD tree describing the flat FSDP storage of one segment (the tp axis
    is axis 2; a rank's view is (count, 1, 1, chunk))."""
    return meta.unflatten([PD((meta.count, data, tp, c), init="zeros", split=2)
                           for c in meta.chunks])


# ---------------------------------------------------------------------------
# Pack / unpack (GLOBAL tensors; init and mesh-agnostic checkpoints)
# ---------------------------------------------------------------------------

def to_tp_rows(x: torch.Tensor, sdim, parts: int, tp: int) -> torch.Tensor:
    """GLOBAL tensor -> (tp, local_size) rows: row r is rank r's shard
    (``params.shard_slice``), flattened; a replicated tensor repeats."""
    if sdim is None:
        return x.reshape(1, -1).expand(tp, x.numel())
    return torch.stack([x[shard_slice(x.shape, sdim, tp, r, parts)].reshape(-1)
                        for r in range(tp)])


def from_tp_rows(rows: torch.Tensor, gshape, loc, sdim, parts: int,
                 tp: int) -> torch.Tensor:
    """(tp, local_size) rows -> GLOBAL tensor (inverse of ``to_tp_rows``)."""
    n = math.prod(loc)
    if sdim is None:
        return rows[0, :n].reshape(loc)
    out = rows.new_empty(gshape)
    for r in range(tp):
        out[shard_slice(gshape, sdim, tp, r, parts)] = rows[r, :n].reshape(loc)
    return out


def pack_segment(group_params: Sequence[Any], meta: SegMeta, *, data: int,
                 tp: int, dtype=torch.float32):
    """[count group trees of GLOBAL tensors] -> flat (count, data, tp, chunk)."""
    groups = [tree_leaves(gp) for gp in group_params]
    per_leaf = []
    for i, (chunk, sdim, parts) in enumerate(zip(meta.chunks, meta.sharded_dims,
                                                 meta.parts)):
        stacked = []
        for leaves in groups:
            rows = to_tp_rows(leaves[i], sdim, parts, tp)
            pad = data * chunk - rows.shape[1]
            if pad:
                rows = torch.cat([rows, rows.new_zeros((tp, pad))], dim=1)
            stacked.append(rows.reshape(tp, data, chunk).transpose(0, 1).to(dtype))
        per_leaf.append(torch.stack(stacked))
    return meta.unflatten(per_leaf)


def unpack_segment(flat, meta: SegMeta, *, data: int, tp: int,
                   dtype=torch.float32) -> List[Any]:
    """Inverse of ``pack_segment`` -> list of ``count`` GLOBAL group trees."""
    leaves = tree_leaves(flat)
    out = []
    for c in range(meta.count):
        out.append(meta.unflatten([
            from_tp_rows(x[c].transpose(0, 1).reshape(tp, -1), gshape, loc, sdim,
                         parts, tp).to(dtype)
            for x, gshape, loc, sdim, parts in zip(
                leaves, meta.global_shapes, meta.local_shapes, meta.sharded_dims,
                meta.parts)]))
    return out


def rank_view(flat: torch.Tensor, data_index: int, tp_index: int) -> torch.Tensor:
    """A rank's (count, 1, 1, chunk) view of a GLOBAL flat leaf."""
    return flat[:, data_index:data_index + 1, tp_index:tp_index + 1]


# ---------------------------------------------------------------------------
# The in-loop gather
# ---------------------------------------------------------------------------

def make_gather_fn(meta: SegMeta, pc: ParallelContext,
                   dtype=None) -> Callable[[Any], Any]:
    """Gather one group's flat shards (chunk,) -> full tp-local tensors.
    The gather's backward is the ZeRO-3 reduce-scatter of the gradients."""

    def gather(flat_tree):
        out = []
        for x, loc in zip(tree_leaves(flat_tree), meta.local_shapes):
            y = pc.all_gather_data(x, axis=0)[:math.prod(loc)].reshape(loc)
            out.append(y if dtype is None else y.to(dtype))
        return meta.unflatten(out)

    return gather


# ---------------------------------------------------------------------------
# int8 serving shards
# ---------------------------------------------------------------------------

QBLOCK = 128


def quantize(x: torch.Tensor):
    """x [..., c] -> (q int8 [..., c], scale fp32 [..., ceil(c / QBLOCK)]):
    symmetric per block of ``QBLOCK`` values along the last axis (the last
    block zero-padded), scale = max(|block| / 127, 1e-12), q = round(x /
    scale) clipped to +-127, in fp32."""
    c = x.shape[-1]
    nb = -(-c // QBLOCK)
    xb = NF.pad(x.float(), (0, nb * QBLOCK - c)).reshape(*x.shape[:-1], nb, QBLOCK)
    scale = (xb.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(xb / scale).clamp(-127, 127).to(torch.int8)
    return q.reshape(*x.shape[:-1], nb * QBLOCK)[..., :c], scale[..., 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor):
    """Inverse of ``quantize`` up to its rounding: q [..., c] x scale [...,
    ceil(c / QBLOCK)] -> fp32 [..., c], each block by its own scale."""
    c, nb = q.shape[-1], scale.shape[-1]
    qb = NF.pad(q.float(), (0, nb * QBLOCK - c)).reshape(*q.shape[:-1], nb, QBLOCK)
    return (qb * scale[..., None].float()).reshape(*q.shape[:-1], nb * QBLOCK)[..., :c]


def quantize_segment(flat):
    """A bf16/fp32 flat segment (global (count, data, tp, chunk) leaves, or
    a rank's (count, 1, 1, chunk) view) -> {"q": int8 tree, "scale": fp32
    tree}, blocks along each chunk (``quantize``)."""
    qs = iter([quantize(x) for x in tree_leaves(flat)])
    pairs = tree_map(lambda _: next(qs), flat)     # leaves: (q, scale) tuples
    return {"q": tree_map(lambda _, p: p[0], flat, pairs),
            "scale": tree_map(lambda _, p: p[1], flat, pairs)}


def make_gather_fn_q(meta: SegMeta, pc: ParallelContext,
                     dtype=torch.bfloat16) -> Callable[[Any], Any]:
    """Gather one group's int8 shards and scales -> full tp-local tensors in
    ``dtype`` (the JAX package's serving type by default). One gather of
    the int8 chunks and one of the scales over the data ranks, then each
    rank's chunk dequantised with its own scales, in fp32. Serving only:
    the int8 values have no gradient."""

    def gather(tree):
        out = []
        for q, sc, loc in zip(tree_leaves(tree["q"]), tree_leaves(tree["scale"]),
                              meta.local_shapes):
            q = pc.all_gather_data(q, axis=0).view(pc.data_size, -1)
            sc = pc.all_gather_data(sc, axis=0).view(pc.data_size, -1)
            deq = dequantize(q, sc).reshape(-1)[:math.prod(loc)]
            out.append(deq.reshape(loc).to(dtype))
        return meta.unflatten(out)

    return gather
