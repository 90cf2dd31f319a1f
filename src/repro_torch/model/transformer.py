"""Full model assembly: embedding -> (encoder) -> LP-grouped stack -> head.

One ``ModelStructure`` describes everything static (config, LP plan, TP
degree, segments); the functional entry points mirror the JAX package:

  forward_full   — logits over a full sequence (or a suffix after cached
                   context kv)
  prefill        — forward_full + KV cache emission
  decode_step    — one new token against the ring cache or the paged pool
                   (updated in place)
  loss_fn        — next-token cross-entropy (+ the MoE aux loss) of a
                   batch, through the differentiable forward (training)

Two families take more than tokens, as in the JAX package:
  encdec (whisper)  — the encoder (``enc_segments``: bidirectional
                      attention layers, then ``enc_norm``) runs on frame
                      embeddings [B, T, D] (the audio frontend is a stub:
                      the caller passes the embeddings); the decoder's
                      layers cross-attend to its output.
  vlm (paligemma)   — patch embeddings [B, P, D] (the vision tower is a
                      stub) go in front of the token embeddings as a prefix
                      that every position sees (the prefix-LM mask, P =
                      ``cfg.prefix_len``); text positions start at P.

Weights live in a ``ModelParams`` module (``init_params`` or
``repro_torch.bridge.params_from_numpy``); the functions take it or its
plain tree. They run where their tensors lie: on a CUDA device through the
Hopper kernels, on the CPU through the kernels' plain versions. The one
exception is the forward of ``loss_fn(differentiable=True)``, which only
the train step asks for: the kernels have no backward, so it runs their
torch versions on any device (the counterparts of the XLA code the JAX
package's trainer runs).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core.lp import EMPTY_PLAN, LPPlan
from repro_torch.model import attention as A
from repro_torch.model import blocks as B
from repro_torch.model import embedding as E
from repro_torch.model import stack as ST
from repro_torch.model.norms import apply_norm
from repro_torch.model.params import (ModelParams, as_tree, init_tree,
                                      local_shape, parts_tree, shard_tree,
                                      split_tree, tree_leaves, tree_map)
from repro_torch.parallel import fsdp as F
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
    enc_segments: Tuple[ST.Segment, ...] = ()
    fsdp: bool = False        # decoder segments as flat FSDP shards
    fsdp_data: int = 1        # the data ranks those shards split over
    quant: bool = False       # int8 FSDP shards (serving only)

    @property
    def dims(self) -> A.AttnDims:
        return A.attn_dims(self.cfg, self.tp)

    @property
    def effective_depth(self) -> int:
        return self.plan.effective_depth(self.cfg.n_layers)


def build_structure(cfg: ArchConfig, *, plan: Optional[LPPlan] = None,
                    tp: int = 1, fsdp: bool = False,
                    fsdp_data: int = 1, quant: bool = False) -> ModelStructure:
    """The static structure of ``cfg`` under ``plan`` at ``tp``-way tensor
    parallelism: every family at every tp (attention of every kind, Mamba
    and RG-LRU mixers, an MLP, a mixture of experts or no FFN, an encoder,
    cross-attention and a prefix-LM). ``fsdp``: the decoder segments are
    stored as flat shards over ``fsdp_data`` data ranks (``parallel/
    fsdp.py``), gathered one group at a time wherever the stack runs;
    ``quant`` keeps those shards as int8 with block scales (serving)."""
    if tp < 1 or fsdp_data < 1:
        raise ValueError(f"tp={tp}, fsdp_data={fsdp_data}")
    if quant and not fsdp:
        raise ValueError("int8 weight shards (quant) need the FSDP layout (fsdp)")
    plan = plan or EMPTY_PLAN
    groups = ST.make_groups(cfg, plan.pairs)
    enc_segments: Tuple[ST.Segment, ...] = ()
    if cfg.enc_layers:
        # The encoder: bidirectional attention + MLP layers, never paired.
        enc_spec = LayerSpec(mixer="attn_bidir", ffn="mlp")
        enc_groups = ST.make_groups(cfg, (), specs=[enc_spec] * cfg.enc_layers)
        enc_segments = tuple(ST.make_segments(enc_groups))
    return ModelStructure(cfg, plan, tp, tuple(ST.make_segments(groups)),
                          enc_segments, fsdp, fsdp_data, quant)


def regular_structure(ms: ModelStructure) -> ModelStructure:
    """The non-FSDP twin of ``ms`` (param-shaped segment leaves)."""
    return (dataclasses.replace(ms, fsdp=False, fsdp_data=1, quant=False)
            if ms.fsdp else ms)


def segment_metas(ms: ModelStructure):
    """FSDP flat-layout metadata per decoder segment."""
    return [F.segment_meta(ST.group_template(ms.cfg, seg.group, ms.tp),
                           seg.count, tp=ms.tp, data=ms.fsdp_data)
            for seg in ms.segments]


def model_template(ms: ModelStructure) -> Dict[str, Any]:
    cfg, tp = ms.cfg, ms.tp
    if ms.fsdp:
        segs = [F.flat_segment_pds(meta, data=ms.fsdp_data, tp=tp)
                for meta in segment_metas(ms)]
        if ms.quant:   # int8 values and one fp32 scale per block of a chunk
            segs = [{"q": tree_map(lambda pd: dataclasses.replace(
                        pd, dtype=torch.int8), t),
                     "scale": tree_map(lambda pd: dataclasses.replace(
                         pd, shape=(*pd.shape[:-1], -(-pd.shape[-1] // F.QBLOCK)),
                         dtype=torch.float32), t)}
                    for t in segs]
    else:
        segs = ST.stack_template(cfg, ms.segments, tp)
    t = {
        "embed": E.embed_template(cfg, tp),
        "segments": segs,
        "final_norm": B._norm_tmpl(cfg),
    }
    if ms.enc_segments:
        t["enc_segments"] = ST.stack_template(cfg, ms.enc_segments, tp)
        t["enc_norm"] = B._norm_tmpl(cfg)
    return t


def init_params(ms: ModelStructure, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda",
                rank: Optional[int] = None, data_index: int = 0) -> ModelParams:
    """Random weights from ``generator`` (normal * fan_in^-0.5, zeros,
    ones), made on ``device`` — the card unless the caller asks for "cpu".
    Without a generator, one seeded with 0 on ``device`` is used. At
    ``ms.tp`` > 1, rank ``rank``'s shard of the global weights (every rank
    draws the same global weights from the same seed and keeps its own).

    FSDP: the regular structure's global weights are drawn (the same ones),
    each segment packed (``fsdp.pack_segment``) and the rank's (count, 1, 1,
    chunk) view kept, at data index ``data_index``; with ``ms.quant`` that
    view quantised (``fsdp.quantize_segment``: per block of the rank's
    chunk, as the JAX package quantises the global packing)."""
    if (ms.tp > 1) != (rank is not None):
        raise ValueError(f"tp={ms.tp}: give the rank at tp > 1, and only there")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if not ms.fsdp:
        return ModelParams(init_tree(model_template(ms), generator, dtype, device,
                                     tp=ms.tp, rank=rank or 0))
    reg = regular_structure(ms)
    full = init_tree(model_template(reg), generator, dtype, device)
    tree = tree_map(lambda x: x.clone(), shard_tree(
        full, param_pspecs(reg), ms.tp, rank or 0, param_parts(reg)))
    tree["segments"] = pack_rank_segments(full["segments"], ms, rank or 0,
                                          data_index, dtype)
    if ms.quant:
        tree["segments"] = [F.quantize_segment(seg) for seg in tree["segments"]]
    return ModelParams(tree)


def pack_rank_segments(segments, ms: ModelStructure, tp_index: int,
                       data_index: int, dtype=torch.float32):
    """GLOBAL regular segment trees (count-stacked) -> the rank's (count, 1,
    1, chunk) parts of their FSDP packing (copies)."""
    out = []
    for sp, seg, meta in zip(segments, ms.segments, segment_metas(ms)):
        groups = ([tree_map(lambda v: v[i], sp) for i in range(seg.count)]
                  if seg.count > 1 else [sp])
        flat = F.pack_segment(groups, meta, data=ms.fsdp_data, tp=ms.tp, dtype=dtype)
        out.append(tree_map(lambda x: F.rank_view(x, data_index, tp_index).clone(),
                            flat))
    return out


def stack_params_and_gathers(params, ms: ModelStructure, pc: ParallelContext):
    """(segment param trees, gather_fns) for the stack apply. FSDP leaves
    arrive as the rank-local (count, 1, 1, chunk) view -> (count, chunk)
    (int8 values and their scales alike); each gather function makes one
    group's tp-local weights from them (``fsdp.make_gather_fn``, or
    ``make_gather_fn_q`` for int8 shards: bf16 weights, as the JAX
    package serves them, in the model's compute type, its embedding's)."""
    if not ms.fsdp:
        return params["segments"], None
    if pc.data_size != ms.fsdp_data:
        raise ValueError(f"FSDP shards over {ms.fsdp_data} data ranks, the "
                         f"context has {pc.data_size}")
    segs = [tree_map(lambda v: v.reshape(v.shape[0], v.shape[-1]), sp)
            for sp in params["segments"]]
    if not ms.quant:
        return segs, [F.make_gather_fn(meta, pc) for meta in segment_metas(ms)]
    compute = params["embed"]["tok"].dtype

    def widened(gather):     # under fp32 compute, fp32 copies of bf16 values
        return lambda tree: tree_map(lambda w: w.to(compute), gather(tree))
    return segs, [widened(F.make_gather_fn_q(meta, pc)) for meta in segment_metas(ms)]


def param_pspecs(ms: ModelStructure):
    """The axis each weight splits over the tp ranks (None: replicated), in
    the weights' tree: the JAX function of this name gives the same as
    PartitionSpecs, where the axis is that of their "model" entry."""
    return split_tree(model_template(ms))


def param_parts(ms: ModelStructure):
    """The blocks each weight's split axis concatenates (``PD.parts``: 2
    for Mamba's ``w_in`` = [x; z], else 1), in the weights' tree: with
    ``param_pspecs`` what ``params.shard_tree`` cuts a global tree by."""
    return parts_tree(model_template(ms))


def abstract_params(ms: ModelStructure, dtype=torch.bfloat16, *,
                    rank: Optional[int] = None, data_index: int = 0):
    """The weights' tree as tensors on the "meta" device: shapes and
    dtypes, no storage (the counterpart of JAX's ``ShapeDtypeStruct``
    tree). Without ``rank``, the global shapes; with it, the shapes rank
    ``rank`` of the tp ranks holds (``init_params(rank=)``: its tp shard of
    every regular leaf and, under FSDP, its (count, 1, 1, chunk) view of
    each flat leaf at data index ``data_index``, int8 values and fp32
    scales under ``ms.quant``)."""
    if rank is not None and not 0 <= rank < ms.tp:
        raise ValueError(f"rank {rank} of tp={ms.tp}")
    if ms.fsdp and not 0 <= data_index < ms.fsdp_data:
        raise ValueError(f"data index {data_index} of fsdp_data={ms.fsdp_data}")
    tmpl = model_template(ms)

    def make(pd, shape):
        return torch.empty(shape, dtype=pd.dtype or dtype, device="meta")
    if rank is None:
        return tree_map(lambda pd: make(pd, pd.shape), tmpl)
    segs = tmpl.pop("segments")
    out = tree_map(lambda pd: make(pd, local_shape(pd, ms.tp)), tmpl)
    out["segments"] = tree_map(
        lambda pd: make(pd, (pd.shape[0], 1, 1, pd.shape[3]) if ms.fsdp
                        else local_shape(pd, ms.tp)), segs)
    return out


def param_count(ms: ModelStructure) -> int:
    """Exact number of weights, a Python integer. (The JAX package's
    ``param_count`` multiplies each shape in int32 and wraps for a leaf of
    2^31 elements or more: granite-34b, dbrx-132b, falcon-mamba-7b.)"""
    return sum(math.prod(pd.shape) for pd in tree_leaves(model_template(ms)))


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


def _encoder(params, frames, ms: ModelStructure, pc: ParallelContext,
             *, attn_impl="auto", differentiable=False):
    """The encoder on frame embeddings [B,T,D] (stub frontend): the
    ``enc_segments`` stack (bidirectional attention), then ``enc_norm``.
    Runs without sequence parallelism, so the output is full-length (the
    decoder's cross-attention projects its k/v from it). At tp > 1 each
    layer runs the rank's heads and d_ff columns; its two phase exits are
    one ``psum_tp`` each, so every rank holds the whole output."""
    params = as_tree(params)
    enc_pc = pc.with_sp(False)
    pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
    h, _, _ = ST.apply_stack_full(params["enc_segments"], frames,
                                  ms.enc_segments, cfg=ms.cfg, dims=ms.dims,
                                  pc=enc_pc, positions=pos,
                                  attn_impl=attn_impl,
                                  differentiable=differentiable)
    # The output enters the decoder's cross-attention phases, as the
    # residual stream enters the head: the identity forward, and under
    # autograd the backward sums the ranks' parts of its gradient.
    return apply_norm(enc_pc.phase_in(h), params["enc_norm"], ms.cfg)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward_full(params, tokens, *, ms: ModelStructure, pc: ParallelContext,
                 prefix_embed=None, enc_frames=None, emit_cache=False,
                 max_len=0, kv_mode="heads", attn_impl="auto", ctx_kv=None,
                 start=0, remat=False, differentiable=False):
    """tokens: [B, S_text] -> (local_logits [B, S_total, V/tp], aux, caches).

    prefix_embed (vlm): [B, P, D] patch embeddings, P = ``cfg.prefix_len``,
    put in front of the token embeddings (cast to their type, after the
    gemma sqrt(D) scale of the tokens, so the prefix is not scaled) and
    seen by every position; S_total = P + S_text, and text positions
    start at P.
    enc_frames (encdec): [B, T, D] frame embeddings for the encoder, whose
    output the decoder's cross-attention layers read; an encoder-decoder
    refuses to run without them.

    ctx_kv/start (suffix prefill, prefix sharing): process ``tokens`` as
    the SUFFIX of a stream whose first ``start`` positions have cached kv
    in ``ctx_kv`` (one count-stacked tree per segment, the layout of the
    emitted caches). Every suffix row attends over exactly ``start + S``
    keys, the reduction shape the full-prompt forward gives the same row.
    ``start`` may be an int32 [B] tensor of PER-ROW context lengths
    (bucketed radix-hit prefill; needs the pinned-tile impl or the flash
    kernel). The emitted cache covers only the suffix (length ``max_len``,
    local 0 == absolute ``start``).

    ``kv_mode`` ("heads" | "seq"): the layout of the emitted ring cache
    at tp > 1 (``blocks.seq_sharded_kind``: "seq" cuts the full-length
    caches of replicated kv heads along the sequence, a shard a rank).

    ``differentiable`` (the train step only): every kernel site runs its
    torch version, on any device, so autograd sees the whole forward;
    ``remat`` checkpoints each decoder group (``stack.apply_stack_full``)."""
    params = as_tree(params)
    cfg = ms.cfg
    prefix_len = cfg.prefix_len if prefix_embed is not None else 0
    if ctx_kv is not None and (prefix_len or enc_frames is not None):
        raise ValueError("suffix prefill does not compose with prefix-LM or "
                         "encoder inputs")
    if prefix_embed is not None and (
            not prefix_len or prefix_embed.shape[:2] != (tokens.shape[0], prefix_len)):
        raise ValueError(f"{cfg.name}: prefix embeddings "
                         f"{tuple(prefix_embed.shape)} for a prefix of "
                         f"{cfg.prefix_len} and {tokens.shape[0]} rows")
    if enc_frames is not None and not ms.enc_segments:
        raise ValueError(f"{cfg.name} has no encoder for the frames")
    if ms.enc_segments and enc_frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs frames for "
                         "its encoder")
    S = tokens.shape[1] + prefix_len
    rel = torch.arange(S, device=tokens.device)[None, :]
    positions = start.long()[:, None] + rel if torch.is_tensor(start) else start + rel
    x = _embed(params, tokens, cfg, pc, positions=positions[:, prefix_len:])
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    enc_out = None
    if enc_frames is not None:
        enc_out = _encoder(params, enc_frames, ms, pc, attn_impl=attn_impl,
                           differentiable=differentiable)
    x = pc.shard_seq(x)
    seg_params, gather_fns = stack_params_and_gathers(params, ms, pc)
    x, aux, caches = ST.apply_stack_full(
        seg_params, x, ms.segments, cfg=cfg, dims=ms.dims, pc=pc,
        positions=positions, prefix_len=prefix_len, enc_out=enc_out,
        attn_impl=attn_impl, emit_cache=emit_cache, max_len=max_len or S,
        kv_mode=kv_mode, ctx=ctx_kv, q0=start, remat=remat,
        differentiable=differentiable, gather_fns=gather_fns)
    x = pc.phase_in(x)  # SP: re-gather the sequence before the LM head
    logits = _head(params, x, cfg, pc)
    return logits, aux, caches


def loss_fn(params, batch, *, ms: ModelStructure, pc: ParallelContext,
            remat=False, attn_impl="auto", aux_weight=1e-2,
            differentiable=False):
    """Mean next-token cross-entropy (+ ``aux_weight`` x the MoE
    load-balance aux). Returns (loss, {"xent", "aux"}).

    batch: {"tokens": [B,S], "labels": [B,S]} plus optional "prefix"
    (prefix-LM patch embeddings; their logits are dropped) and "frames"
    (the encoder's input). labels < 0 are masked out. The train step sets
    ``differentiable``; without it (the eval step) the kernels run on a
    CUDA tensor, and they have no backward."""
    prefix = batch.get("prefix")
    logits, aux, _ = forward_full(
        params, batch["tokens"], ms=ms, pc=pc, prefix_embed=prefix,
        enc_frames=batch.get("frames"), attn_impl=attn_impl, remat=remat,
        differentiable=differentiable)
    labels = batch["labels"]
    if prefix is not None and ms.cfg.prefix_len:
        logits = logits[:, ms.cfg.prefix_len:]
    mask = (labels >= 0).float()
    xent = E.vocab_parallel_xent(logits, labels.clamp_min(0), pc, mask=mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=xent.device)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill + decode (serving)
# ---------------------------------------------------------------------------

def cache_meta(ms: ModelStructure, *, batch: int, max_len: int,
               kv_mode="heads", dtype=torch.bfloat16):
    """Per segment, {entry name: (shape, dtype)} of this rank's decode
    cache (at tp > 1: the rank's share of split kv heads, or every stored
    head when kv is replicated, then with ``kv_mode="seq"`` the rank's
    ``max_len / tp`` positions of a full-length ring); the cross-attention
    entries of an encoder-decoder hold ``cfg.enc_seq`` positions."""
    return ST.stack_cache_meta(ms.cfg, ms.segments, ms.dims, batch=batch,
                               max_len=max_len, kv_mode=kv_mode,
                               enc_len=ms.cfg.enc_seq if ms.enc_segments else 0,
                               dtype=dtype)


def cache_batch_axis(entry_name: str) -> int:
    """Axis of the BATCH dim in a count-stacked cache entry [count, ...]:
    stacked pair entries ("k", "v", "conv", "h") carry a leading pair axis
    of 2, so batch sits at axis 2; per-layer entries ("k0", ...) keep it at
    axis 1. In a paged pool the same axis holds the pages of k/v entries
    and the decode slots of state entries."""
    return 1 if entry_name[-1].isdigit() else 2


def cast_cache(caches, dtype):
    """The cache cast of ``prefill``: float entries to ``dtype``, except the
    recurrent state ``h`` (Mamba, RG-LRU), which stays fp32 as ``cache_meta``
    declares it."""
    return [{k: (c.to(dtype) if c.dtype in (torch.float32, torch.bfloat16)
                 and k.rstrip("0123456789") != "h" else c)
             for k, c in seg.items()} for seg in caches]


def prefill(params, tokens, *, ms: ModelStructure, pc: ParallelContext,
            max_len: int, prefix_embed=None, enc_frames=None, kv_mode="heads",
            attn_impl="auto", cache_dtype=torch.bfloat16):
    """Returns (last-position local logits [B, V/tp], caches). The cache
    holds the prefix (when given) before the prompt, and the encoder's
    keys and values (when frames are given) in ``xk``/``xv``; its layout
    is ``kv_mode``'s (``cache_meta``)."""
    logits, _, caches = forward_full(
        params, tokens, ms=ms, pc=pc, prefix_embed=prefix_embed,
        enc_frames=enc_frames, emit_cache=True, max_len=max_len,
        kv_mode=kv_mode, attn_impl=attn_impl)
    return logits[:, -1], cast_cache(caches, cache_dtype)


def decode_step(params, tok, caches, t, *, ms: ModelStructure,
                pc: ParallelContext, kv_mode="heads", cache_layout="ring",
                block_tables=None):
    """One decode step. tok: [B] ids; t: absolute position of ``tok`` in
    the stream. ``caches`` are updated in place. Returns (local logits
    [B, V/tp], caches). ``kv_mode`` is the ring cache's layout, as
    ``prefill`` emitted it.

    cache_layout="paged" (continuous batching, ``repro_torch.serve``):
    ``t`` is an int32 [B] tensor of per-slot positions on the device,
    ``caches`` is the page pool tree (serve.paged_cache) and
    ``block_tables`` [B, n_pg] int32 maps each slot to its pages.

    An FSDP structure gathers each group's weights over the data ranks
    inside the group's step (``stack_params_and_gathers``), every step."""
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
    seg_params, gather_fns = stack_params_and_gathers(params, ms, dpc)
    x, caches = ST.apply_stack_decode(
        seg_params, x, caches, t, ms.segments, cfg=cfg, dims=ms.dims,
        pc=dpc, kv_mode=kv_mode, cache_layout=cache_layout,
        block_tables=block_tables, gather_fns=gather_fns)
    logits = _head(params, x, cfg, dpc)
    return logits[:, 0], caches
