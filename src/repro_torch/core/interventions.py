"""Effective-depth interventions (paper §3, Fig. 3/4).

Reference transformations of a trained layer stack, at world size 1, as in
the JAX package's ``core/interventions.py`` (which
``benchmarks/effective_depth.py`` uses for the five heatmaps):

  (a) shuffle    — random permutation of layers [s, e]
  (b) prune      — drop layers [s, e]
  (c) merge      — average the weights of layers [s, e] into one layer
  (d) parallel   — run layers [s, e] as ONE k-way parallel group
  (e) parallel2  — run consecutive pairs inside [s, e] in parallel (LP)

Two functional forms of parallel groups:
  * ``form="par"`` — the paper's eq. (PAR): each member's FFN sees only its
    OWN path's attention residual.
  * ``form="tp"``  — the implemented Fig. 2b graph: one merged residual per
    phase (what ``model.blocks`` runs for an LP pair), each member's
    contribution computed with its own weights and summed one by one, for
    every k. At k = 2 it is the formula the production pair path computes
    with stacked weights.

The functions take a list of per-layer param trees (``core.lp``'s
``extract_layers`` gives one) and a plan, and run on the device of their
inputs: on the card the attention cores launch the flash kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.model import attention as A
from repro_torch.model import blocks as B
from repro_torch.model.norms import apply_norm
from repro_torch.model.params import tree_map
from repro_torch.parallel.context import ParallelContext

PyTree = Any


@dataclass(frozen=True)
class LayerGroup:
    """One unit of the intervened stack: ``members`` original-layer indices
    executed together. len==1 -> ordinary sequential layer."""

    members: Tuple[int, ...]
    form: str = "tp"  # tp | par (only meaningful for len(members) > 1)


def sequential_plan(n: int) -> List[LayerGroup]:
    return [LayerGroup((i,)) for i in range(n)]


def shuffle_plan(n: int, s: int, e: int,
                 generator: torch.Generator) -> List[LayerGroup]:
    """Permute layers s..e (inclusive) uniformly at random, drawing from
    ``generator`` (the JAX package draws from a PRNG key)."""
    perm = s + torch.randperm(e - s + 1, generator=generator,
                              device=generator.device)
    order = list(range(s)) + [int(p) for p in perm] + list(range(e + 1, n))
    return [LayerGroup((i,)) for i in order]


def prune_plan(n: int, s: int, e: int) -> List[LayerGroup]:
    return [LayerGroup((i,)) for i in range(n) if not s <= i <= e]


def parallel_plan(n: int, s: int, e: int, *, form="par") -> List[LayerGroup]:
    """One k-way parallel group for layers s..e (paper Fig. 3d)."""
    return ([LayerGroup((i,)) for i in range(s)]
            + [LayerGroup(tuple(range(s, e + 1)), form=form)]
            + [LayerGroup((i,)) for i in range(e + 1, n)])


def parallel2_plan(n: int, s: int, e: int, *, form="tp") -> List[LayerGroup]:
    """Consecutive pairs inside s..e (paper Fig. 3e — contiguous 2-parallel;
    a trailing unpaired layer stays sequential)."""
    groups: List[LayerGroup] = [LayerGroup((i,)) for i in range(s)]
    i = s
    while i + 1 <= e:
        groups.append(LayerGroup((i, i + 1), form=form))
        i += 2
    if i <= e:
        groups.append(LayerGroup((i,)))
    return groups + [LayerGroup((i,)) for i in range(e + 1, n)]


def merge_avg(layer_params: Sequence[PyTree], s: int, e: int
              ) -> Tuple[List[PyTree], List[LayerGroup]]:
    """Average layers s..e into ONE layer (paper Fig. 3c). Returns the new
    param list and its sequential plan."""
    merged = tree_map(lambda *xs: sum(xs) / len(xs),
                      *[layer_params[i] for i in range(s, e + 1)])
    params = list(layer_params[:s]) + [merged] + list(layer_params[e + 1:])
    return params, sequential_plan(len(params))


def effective_depth_of(plan: Sequence[LayerGroup]) -> int:
    return len(plan)


# ---------------------------------------------------------------------------
# Reference evaluation
# ---------------------------------------------------------------------------

def _phase_attn(p, xn, cfg, dims, *, kind, positions, prefix_len):
    """One layer's attention sub-block on a normalised input. Partial out."""
    q = A.project_q(p, xn, cfg, dims, positions=positions, kind=kind, pair=False)
    k, v = A.project_kv(p, xn, cfg, dims, positions=positions, kind=kind,
                        pair=False)
    Bb, S = xn.shape[0], xn.shape[1]
    o = A.attention_core(q.reshape(Bb, S, dims.hkv, dims.group, dims.hd), k, v,
                         kind=kind, window=cfg.window, chunk=cfg.chunk,
                         prefix_len=prefix_len)
    return A.output_proj(p, o.reshape(Bb, S, dims.hq, dims.hd), dims, pair=False)


def _phase_ffn(p, xn, cfg, pc, spec):
    return B.ffn_phase(p, xn, cfg, pc,
                       group=B.Group(False, (spec,), (0,)))[0]


def apply_intervened(layer_params: Sequence[PyTree], plan: Sequence[LayerGroup],
                     x, *, cfg: ArchConfig, positions, prefix_len: int = 0,
                     pc: Optional[ParallelContext] = None):
    """Run an intervened stack. x: [B,S,D] -> [B,S,D].

    Sequential groups use the production single-layer path
    (``blocks.apply_group_full``), so 'no intervention' is bit-exact with
    the model's own stack; parallel groups implement the k-way PAR / TP
    forms."""
    pc = pc or ParallelContext()
    if pc.tp_size != 1:
        raise NotImplementedError("interventions run at tp = 1 only, as the "
                                  "JAX package declares them (no TP)")
    dims = A.attn_dims(cfg, pc.tp_size)
    specs = cfg.layer_specs()
    for g in plan:
        if len(g.members) == 1:
            li = g.members[0]
            grp = B.Group(False, (specs[li],), (li,))
            x, _, _ = B.apply_group_full(
                layer_params[li], x, cfg=cfg, group=grp, dims=dims, pc=pc,
                positions=positions, prefix_len=prefix_len)
            continue

        members = list(g.members)
        kinds = [specs[li].mixer for li in members]
        if g.form == "tp":
            # Fig. 2b generalised: one merged residual per phase.
            out = 0.0
            for li, kind in zip(members, kinds):
                p = layer_params[li]
                xn = apply_norm(x, p["ln1"], cfg)
                out = out + _phase_attn(p["attn"], xn, cfg, dims, kind=kind,
                                        positions=positions, prefix_len=prefix_len)
            a = x + pc.psum_tp(out).to(x.dtype)
            out = 0.0
            for li in members:
                p = layer_params[li]
                xn2 = apply_norm(a, p["ln2"], cfg)
                out = out + _phase_ffn(p, xn2, cfg, pc, specs[li])
            x = a + pc.psum_tp(out).to(x.dtype)
        else:
            # Paper eq. (PAR): each member applies its FULL layer to x;
            # contributions sum into the joint residual.
            out = 0.0
            for li, kind in zip(members, kinds):
                p = layer_params[li]
                xn = apply_norm(x, p["ln1"], cfg)
                att = pc.psum_tp(_phase_attn(p["attn"], xn, cfg, dims, kind=kind,
                                             positions=positions,
                                             prefix_len=prefix_len))
                own = x + att.to(x.dtype)
                xn2 = apply_norm(own, p["ln2"], cfg)
                ffn = pc.psum_tp(_phase_ffn(p, xn2, cfg, pc, specs[li]))
                out = out + att.float() + ffn.float()
            x = x + out.to(x.dtype)
    return x
