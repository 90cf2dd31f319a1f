"""Full model assembly: embedding -> LP-grouped stack -> head.

One ``ModelStructure`` describes everything static (config, LP plan, TP
degree, segments); the functional entry points mirror the JAX package:

  forward_full   — logits over a full sequence (or a suffix after cached
                   context kv)
  prefill        — forward_full + KV cache emission
  decode_step    — one new token against the ring cache or the paged pool
                   (updated in place)

Weights live in a ``ModelParams`` module (``init_params`` or
``repro_torch.bridge.params_from_numpy``); the functions take it or its
plain tree. They run where their tensors lie: on a CUDA device through the
Hopper kernels, on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lp import EMPTY_PLAN, LPPlan
from repro_torch.model import attention as A
from repro_torch.model import blocks as B
from repro_torch.model import embedding as E
from repro_torch.model import stack as ST
from repro_torch.model.norms import apply_norm
from repro_torch.model.params import ModelParams, as_tree, init_tree
from repro_torch.parallel.context import ParallelContext


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelStructure:
    cfg: ArchConfig
    plan: LPPlan
    tp: int
    segments: Tuple[ST.Segment, ...]

    @property
    def dims(self) -> A.AttnDims:
        return A.attn_dims(self.cfg, self.tp)

    @property
    def effective_depth(self) -> int:
        return self.plan.effective_depth(self.cfg.n_layers)


def build_structure(cfg: ArchConfig, *, plan: Optional[LPPlan] = None,
                    tp: int = 1) -> ModelStructure:
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported")
    if cfg.enc_layers or cfg.prefix_len:
        raise NotImplementedError(f"{cfg.name}: encoder / prefix-LM inputs "
                                  "are not ported")
    plan = plan or EMPTY_PLAN
    groups = ST.make_groups(cfg, plan.pairs)
    return ModelStructure(cfg, plan, tp, tuple(ST.make_segments(groups)))


def model_template(ms: ModelStructure) -> Dict[str, Any]:
    cfg, tp = ms.cfg, ms.tp
    return {
        "embed": E.embed_template(cfg, tp),
        "segments": ST.stack_template(cfg, ms.segments, tp),
        "final_norm": B._norm_tmpl(cfg),
    }


def init_params(ms: ModelStructure, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda") -> ModelParams:
    """Random weights from ``generator`` (normal * fan_in^-0.5, zeros,
    ones), made on ``device`` — the card unless the caller asks for "cpu".
    Without a generator, one seeded with 0 on ``device`` is used."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return ModelParams(init_tree(model_template(ms), generator, dtype, device))


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg, pc: ParallelContext, *, positions):
    """Token ids -> full [B,S,D] residual stream."""
    x = E.embed_lookup(params["embed"], tokens, pc)
    x = pc.psum_tp(x)
    x = E.add_positions(params["embed"], x, positions)
    if cfg.norm_plus_one:  # gemma-style sqrt(D) embedding scale
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params, x, cfg, pc: ParallelContext):
    """Final norm + LM head -> LOCAL logits [..., V/tp] (fp32)."""
    x = apply_norm(x, params["final_norm"], cfg)
    return E.local_logits(params["embed"], x, cfg, pc)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward_full(params, tokens, *, ms: ModelStructure, pc: ParallelContext,
                 emit_cache=False, max_len=0, attn_impl="auto", ctx_kv=None,
                 start=0):
    """tokens: [B, S] -> (local_logits [B, S, V/tp], aux, caches).

    ctx_kv/start (suffix prefill, prefix sharing): process ``tokens`` as
    the SUFFIX of a stream whose first ``start`` positions have cached kv
    in ``ctx_kv`` (one count-stacked tree per segment, the layout of the
    emitted caches). Every suffix row attends over exactly ``start + S``
    keys, the reduction shape the full-prompt forward gives the same row.
    ``start`` may be an int32 [B] tensor of PER-ROW context lengths
    (bucketed radix-hit prefill; needs the pinned-tile impl or the flash
    kernel). The emitted cache covers only the suffix (length ``max_len``,
    local 0 == absolute ``start``)."""
    params = as_tree(params)
    cfg = ms.cfg
    S = tokens.shape[1]
    rel = torch.arange(S, device=tokens.device)[None, :]
    positions = start.long()[:, None] + rel if torch.is_tensor(start) else start + rel
    x = _embed(params, tokens, cfg, pc, positions=positions)
    x = pc.shard_seq(x)
    x, aux, caches = ST.apply_stack_full(
        params["segments"], x, ms.segments, cfg=cfg, dims=ms.dims, pc=pc,
        positions=positions, attn_impl=attn_impl, emit_cache=emit_cache,
        max_len=max_len or S, ctx=ctx_kv, q0=start)
    x = pc.phase_in(x)
    logits = _head(params, x, cfg, pc)
    return logits, aux, caches


# ---------------------------------------------------------------------------
# Prefill + decode (serving)
# ---------------------------------------------------------------------------

def cache_meta(ms: ModelStructure, *, batch: int, max_len: int,
               dtype=torch.bfloat16):
    """Per segment, {entry name: (shape, dtype)} of the decode cache."""
    return ST.stack_cache_meta(ms.cfg, ms.segments, ms.dims, batch=batch,
                               max_len=max_len, dtype=dtype)


def cache_batch_axis(entry_name: str) -> int:
    """Axis of the BATCH dim in a count-stacked cache entry [count, ...]:
    stacked pair entries ("k", "v", "conv", "h") carry a leading pair axis
    of 2, so batch sits at axis 2; per-layer entries ("k0", ...) keep it at
    axis 1. In a paged pool the same axis holds the pages of k/v entries
    and the decode slots of state entries."""
    return 1 if entry_name[-1].isdigit() else 2


def cast_cache(caches, dtype):
    """The cache cast of ``prefill``: float entries to ``dtype``, except the
    recurrent state ``h`` (Mamba), which stays fp32 as ``cache_meta``
    declares it."""
    return [{k: (c.to(dtype) if c.dtype in (torch.float32, torch.bfloat16)
                 and k.rstrip("0123456789") != "h" else c)
             for k, c in seg.items()} for seg in caches]


def prefill(params, tokens, *, ms: ModelStructure, pc: ParallelContext,
            max_len: int, attn_impl="auto", cache_dtype=torch.bfloat16):
    """Returns (last-position local logits [B, V/tp], caches)."""
    logits, _, caches = forward_full(
        params, tokens, ms=ms, pc=pc, emit_cache=True, max_len=max_len,
        attn_impl=attn_impl)
    return logits[:, -1], cast_cache(caches, cache_dtype)


def decode_step(params, tok, caches, t, *, ms: ModelStructure,
                pc: ParallelContext, cache_layout="ring", block_tables=None):
    """One decode step. tok: [B] ids; t: absolute position of ``tok`` in
    the stream. ``caches`` are updated in place. Returns (local logits
    [B, V/tp], caches).

    cache_layout="paged" (continuous batching, ``repro_torch.serve``):
    ``t`` is an int32 [B] tensor of per-slot positions on the device,
    ``caches`` is the page pool tree (serve.paged_cache) and
    ``block_tables`` [B, n_pg] int32 maps each slot to its pages."""
    params = as_tree(params)
    cfg = ms.cfg
    dpc = pc.with_sp(False)  # decode never uses sequence parallelism
    if cache_layout == "paged":
        if block_tables is None or not torch.is_tensor(t) or t.dim() != 1:
            raise ValueError("paged decode takes per-slot positions t [B] and "
                             "block tables")
        pos = t[:, None]
    else:
        pos = torch.full((tok.shape[0], 1), t, dtype=torch.int64,
                         device=tok.device)
    x = _embed(params, tok[:, None], cfg, dpc, positions=pos)
    x, caches = ST.apply_stack_decode(
        params["segments"], x, caches, t, ms.segments, cfg=cfg, dims=ms.dims,
        pc=dpc, cache_layout=cache_layout, block_tables=block_tables)
    logits = _head(params, x, cfg, dpc)
    return logits[:, 0], caches
