"""Layer Parallelism (LP) — the paper's contribution.

LP rewrites a *pretrained* model so that pairs of consecutive transformer
layers execute as ONE wide layer (paper Fig. 2b / Fig. 5):

    a = x + A_k(LN1_k x) + A_{k+1}(LN1_{k+1} x)     # ONE all-reduce
    y = a + F_k(LN2_k a) + F_{k+1}(LN2_{k+1} a)     # ONE all-reduce

The merge is retraining-free: a pair's weights are the two layers' weights
stacked on a leading pair axis. This module owns the pairing plans, the
merge per-layer params -> grouped/segmented params and its inverse, and the
fine-tune mask — the same functions as the JAX package's ``core/lp.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.model import blocks as B
from repro_torch.model import stack as ST
from repro_torch.model.params import stack_trees, tree_map

PyTree = Any


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LPPlan:
    """An LP pairing plan: which consecutive layer pairs run in parallel."""

    pairs: Tuple[Tuple[int, int], ...] = ()

    @property
    def delta(self) -> int:
        """The paper's Δ — number of layers merged (2 per pair)."""
        return 2 * len(self.pairs)

    def effective_depth(self, n_layers: int) -> int:
        """Minimum sequential operations input->output (paper Table 1)."""
        return n_layers - len(self.pairs)

    def paired_layers(self) -> set:
        s = set()
        for i, j in self.pairs:
            s.update((i, j))
        return s

    def __post_init__(self):
        seen = set()
        for i, j in self.pairs:
            if j != i + 1:
                raise ValueError(f"LP pairs must be consecutive, got {(i, j)}")
            if i in seen or j in seen:
                raise ValueError(f"overlapping pair {(i, j)}")
            seen.update((i, j))


EMPTY_PLAN = LPPlan(())


def pairable(cfg: ArchConfig, i: int,
             specs: Optional[Sequence[LayerSpec]] = None) -> bool:
    """Can layers (i, i+1) LP-pair? Requires structurally equal templates."""
    specs = list(specs if specs is not None else cfg.layer_specs())
    if i < 0 or i + 1 >= len(specs):
        return False
    return ST.template_compatible(cfg, specs[i], specs[i + 1])


def plan_range(cfg: ArchConfig, start: int, end: int) -> LPPlan:
    """Greedily pair consecutive compatible layers within [start, end)."""
    specs = cfg.layer_specs()
    end = min(end, cfg.n_layers)
    pairs: List[Tuple[int, int]] = []
    i = max(start, 0)
    while i + 1 < end:
        if pairable(cfg, i, specs):
            pairs.append((i, i + 1))
            i += 2
        else:
            i += 1
    return LPPlan(tuple(pairs))


def plan_for_depth(cfg: ArchConfig, eff_depth: int, *,
                   end: Optional[int] = None) -> LPPlan:
    """Pick the pairing whose effective depth == ``eff_depth``, ending the
    paired range at ``end`` (default: the 4th-to-last layer, or the full
    stack for models under 12 layers) and growing it backwards."""
    n = cfg.n_layers
    want = n - eff_depth  # number of pairs
    if want <= 0:
        return EMPTY_PLAN
    if end is None:
        end = n - 4 if n >= 12 else n
    end = min(end, n)
    for start in range(end - 2 * want, -1, -1):
        plan = plan_range(cfg, start, end)
        if len(plan.pairs) >= want:
            return LPPlan(plan.pairs[-want:])
    plan = plan_range(cfg, 0, end)
    if len(plan.pairs) < want:
        raise ValueError(f"{cfg.name}: cannot reach effective depth "
                         f"{eff_depth} (max pairs before layer {end} = "
                         f"{len(plan.pairs)})")
    return LPPlan(plan.pairs[-want:])


def default_plan(cfg: ArchConfig, lp_fraction: float = 0.5) -> LPPlan:
    """Pair the middle ``lp_fraction`` of the stack (the paper finds early
    layers and the last ~2-4 layers fragile)."""
    n = cfg.n_layers
    span = int(n * lp_fraction)
    start = max(2, (n - span) // 2)
    end = min(n - 2, start + span)
    return plan_range(cfg, start, end)


# ---------------------------------------------------------------------------
# Retraining-free weight merge
# ---------------------------------------------------------------------------

def merge_groups(layer_params: Sequence[PyTree], groups: Sequence[B.Group]) -> List[PyTree]:
    """Per-layer params -> one tree per group: a pair's params are the two
    layers' params stacked on a new leading axis."""
    out = []
    for g in groups:
        if g.pair:
            i, j = g.layer_ids
            out.append(stack_trees([layer_params[i], layer_params[j]]))
        else:
            out.append(layer_params[g.layer_ids[0]])
    return out


def segment_params(group_params: Sequence[PyTree],
                   segments: Sequence[ST.Segment]) -> List[PyTree]:
    """Group trees -> per-segment stacked trees (leading count axis)."""
    out, k = [], 0
    for seg in segments:
        if seg.count == 1:
            out.append(group_params[k])
        else:
            out.append(stack_trees(list(group_params[k:k + seg.count])))
        k += seg.count
    return out


def lp_convert(cfg: ArchConfig, layer_params: Sequence[PyTree], plan: LPPlan
               ) -> Tuple[List[ST.Segment], List[PyTree]]:
    """A trained layer stack -> its LP form: (segments, seg_params).
    ``plan.pairs == ()`` returns the vanilla sequential stack."""
    groups = ST.make_groups(cfg, plan.pairs)
    segments = ST.make_segments(groups)
    return segments, segment_params(merge_groups(layer_params, groups), segments)


def extract_layers(seg_params: Sequence[PyTree],
                   segments: Sequence[ST.Segment]) -> List[PyTree]:
    """Inverse of ``lp_convert``'s packing: per-layer param trees in the
    original layer order."""
    layers: List[Tuple[int, PyTree]] = []
    for sp, seg in zip(seg_params, segments):
        for c in range(seg.count):
            gp = tree_map(lambda v: v[c], sp) if seg.count > 1 else sp
            if seg.group.pair:
                base = seg.group.layer_ids[0] + 2 * c
                layers.append((base, tree_map(lambda v: v[0], gp)))
                layers.append((base + 1, tree_map(lambda v: v[1], gp)))
            else:
                base = seg.group.layer_ids[0] + c
                layers.append((base, gp))
    layers.sort(key=lambda t: t[0])
    assert [i for i, _ in layers] == list(range(len(layers)))
    return [p for _, p in layers]


def replan(cfg: ArchConfig, seg_params: Sequence[PyTree],
           segments: Sequence[ST.Segment], new_plan: LPPlan
           ) -> Tuple[List[ST.Segment], List[PyTree]]:
    """Re-pair an existing (possibly already LP'd) stack under a new plan."""
    return lp_convert(cfg, extract_layers(seg_params, segments), new_plan)


def finetune_mask(seg_params: Sequence[PyTree],
                  segments: Sequence[ST.Segment]) -> List[PyTree]:
    """1.0 where a parameter belongs to an LP pair, 0.0 elsewhere. Same
    structure as seg_params."""
    out = []
    for sp, seg in zip(seg_params, segments):
        flag = 1.0 if seg.group.pair else 0.0
        out.append(tree_map(lambda v: torch.tensor(flag, dtype=torch.float32), sp))
    return out
