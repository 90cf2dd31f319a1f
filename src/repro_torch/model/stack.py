"""Stack assembly: layers -> LP groups -> segments.

The layer list (with its LP pairing plan) is compressed into SEGMENTS of
identical group signature; each segment's params are stacked on a leading
count axis, as in the JAX package. Where JAX scans over a segment, the port
loops over it in Python.

Decode updates the caches IN PLACE: each group reads and writes a view of
its segment's stacked cache, so decode holds one copy of the KV cache (the
JAX package gets the same from XLA aliasing the scan carry).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.model import blocks as B
from repro_torch.model.params import stack_tmpl, tree_map, tree_structure


@dataclass(frozen=True)
class Segment:
    group: B.Group          # representative (layer_ids of the first group)
    count: int


def template_compatible(cfg, a: LayerSpec, b: LayerSpec) -> bool:
    """Two specs can LP-pair iff their param templates are structurally equal."""
    ta = tree_structure(B.layer_template(cfg, a, 1))
    tb = tree_structure(B.layer_template(cfg, b, 1))
    return ta == tb and a.cross_attn == b.cross_attn and a.ffn == b.ffn


def make_groups(cfg: ArchConfig, lp_pairs: Sequence[Tuple[int, int]],
                specs: Optional[Sequence[LayerSpec]] = None) -> List[B.Group]:
    """Build the group list from an LP pairing plan (validated)."""
    specs = list(specs if specs is not None else cfg.layer_specs())
    n = len(specs)
    paired = {}
    seen = set()
    for (i, j) in lp_pairs:
        if j != i + 1:
            raise ValueError(f"LP pairs must be consecutive layers, got {(i, j)}")
        if not (0 <= i and j < n):
            raise ValueError(f"LP pair {(i, j)} outside {n} layers")
        if i in seen or j in seen:
            raise ValueError(f"overlapping LP pairs at {(i, j)}")
        if not template_compatible(cfg, specs[i], specs[j]):
            raise ValueError(f"layers {i},{j} of {cfg.name} have "
                             "incompatible templates")
        seen.update((i, j))
        paired[i] = j
    groups: List[B.Group] = []
    i = 0
    while i < n:
        if i in paired:
            groups.append(B.Group(True, (specs[i], specs[i + 1]), (i, i + 1)))
            i += 2
        else:
            groups.append(B.Group(False, (specs[i],), (i,)))
            i += 1
    return groups


def make_segments(groups: Sequence[B.Group]) -> List[Segment]:
    segs: List[Segment] = []
    for g in groups:
        if segs and segs[-1].group.signature == g.signature:
            segs[-1] = Segment(segs[-1].group, segs[-1].count + 1)
        else:
            segs.append(Segment(g, 1))
    return segs


def group_template(cfg, group: B.Group, tp: int):
    t = B.layer_template(cfg, group.specs[0], tp)
    return stack_tmpl(t, 2) if group.pair else t


def segment_template(cfg, seg: Segment, tp: int):
    gt = group_template(cfg, seg.group, tp)
    return stack_tmpl(gt, seg.count) if seg.count > 1 else gt


def stack_template(cfg, segments: Sequence[Segment], tp: int):
    return [segment_template(cfg, s, tp) for s in segments]


def _group_params(sp, seg: Segment, c: int):
    """Params of group ``c`` of a segment (views, no copy)."""
    return tree_map(lambda v: v[c], sp) if seg.count > 1 else sp


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def apply_stack_full(seg_params, x, segments, *, cfg, dims, pc, positions,
                     attn_impl="auto", emit_cache=False, max_len=0, ctx=None,
                     q0=0):
    """Run all segments over the full sequence. Returns (x, aux, caches):
    caches is a list (one tree per segment, entries stacked to
    [count, ...]) when emit_cache, else None.

    ``ctx``/``q0`` (suffix prefill): cached context kv for absolute
    positions [0, q0), one count-stacked tree per segment in the layout of
    the emitted caches, so every group attends over its own layer's
    context."""
    caches = [] if emit_cache else None
    aux = 0.0
    ctx = ctx if ctx is not None else [None] * len(segments)
    for sp, seg, ctx_seg in zip(seg_params, segments, ctx):
        seg_caches = []
        for c in range(seg.count):
            ctx_g = (None if ctx_seg is None
                     else {name: e[c] for name, e in ctx_seg.items()})
            x, a, cache = B.apply_group_full(
                _group_params(sp, seg, c), x, cfg=cfg, group=seg.group,
                dims=dims, pc=pc, positions=positions, attn_impl=attn_impl,
                emit_cache=emit_cache, max_len=max_len, ctx_kv=ctx_g, q0=q0)
            aux = aux + a
            seg_caches.append(cache)
        if emit_cache:
            caches.append({name: torch.stack([sc[name] for sc in seg_caches])
                           for name in seg_caches[0]})
    return x, aux, caches


def apply_stack_decode(seg_params, x, caches, t, segments, *, cfg, dims,
                       pc, cache_layout="ring", block_tables=None):
    """One decode step through all segments. ``caches`` (one stacked tree
    per segment) are updated in place and returned.

    cache_layout="paged": the entries are page pools indirected through
    ``block_tables`` and ``t`` is the per-slot position tensor."""
    for sp, cache, seg in zip(seg_params, caches, segments):
        for c in range(seg.count):
            view = {name: entry[c] for name, entry in cache.items()}
            x, _ = B.apply_group_decode(
                _group_params(sp, seg, c), x, view, t, cfg=cfg,
                group=seg.group, dims=dims, pc=pc, cache_layout=cache_layout,
                block_tables=block_tables)
    return x, caches


def stack_cache_meta(cfg, segments, dims, *, batch, max_len,
                     dtype=torch.bfloat16):
    """Per segment, {entry name: (shape, dtype)} stacked to [count, ...]."""
    out = []
    for seg in segments:
        meta = B.group_cache_meta(cfg, seg.group, dims, batch=batch,
                                  max_len=max_len, dtype=dtype)
        out.append({k: ((seg.count, *shp), dt) for k, (shp, dt) in meta.items()})
    return out
