"""Vocab-parallel embedding, LM head, cross-entropy and greedy/sampled
token choice.

Same functions and conventions as the JAX package (vocabulary padded to a
multiple of tp and split over the ranks, logits over the LOCAL vocabulary
shard, pad columns masked); at world size 1 the shard is the whole
vocabulary. The lookup gives each rank a partial embedding (zero rows for
ids outside its shard) that the caller's ``psum_tp`` adds up.
"""
from __future__ import annotations

import torch

from repro_torch.model.params import PD
from repro_torch.parallel.context import ParallelContext


def vocab_pad(V: int, tp: int) -> int:
    return -(-V // tp) * tp


def embed_template(cfg, tp: int):
    Vp = vocab_pad(cfg.vocab_size, tp)
    t = {"tok": PD((Vp, cfg.d_model), fan_in=cfg.d_model, split=0)}
    if cfg.pos_embed == "learned":
        t["pos"] = PD((cfg.max_position, cfg.d_model), fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        t["head"] = PD((cfg.d_model, Vp), split=1)
    return t


def embed_lookup(p, ids, pc: ParallelContext):
    """ids: [B,S] global token ids -> TP-partial [B,S,D]."""
    tok = p["tok"]
    v_local = tok.shape[0]
    base = pc.tp_index() * v_local
    lid = ids - base
    ok = (lid >= 0) & (lid < v_local)
    emb = tok[lid.clamp(0, v_local - 1)]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=tok.dtype,
                                                      device=tok.device))


def add_positions(p, x, positions):
    if "pos" not in p:
        return x
    return x + p["pos"][positions].to(x.dtype)


def local_logits(p, x, cfg, pc: ParallelContext):
    """x: [B,S,D] full -> local logits [B,S,V/tp] (fp32, pad masked)."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = (x @ w.to(x.dtype)).float()
    v_local = logits.shape[-1]
    base = pc.tp_index() * v_local
    col = base + torch.arange(v_local, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def vocab_parallel_xent(logits, labels, pc: ParallelContext, *, mask=None):
    """Mean token cross-entropy from LOCAL logits [B,S,Vl] (fp32, pad
    columns at -1e30) and global labels [B,S]; with ``mask`` [B,S] the mean
    runs over the masked-in positions, ``sum(nll * mask) / max(sum(mask),
    1)``."""
    v_local = logits.shape[-1]
    base = pc.tp_index() * v_local
    # The max shift is for numerical stability only: the lse gradient does
    # not depend on it, so it is detached (as JAX's stop_gradient).
    m = pc.pmax_tp(logits.detach().amax(-1))
    lse = m + torch.log(pc.psum_tp(torch.exp(logits - m[..., None]).sum(-1)))
    lid = labels - base
    ok = (lid >= 0) & (lid < v_local)
    tgt = torch.gather(logits, -1, lid.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = pc.psum_tp(torch.where(ok, tgt, 0.0))
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def vocab_parallel_argmax(logits, pc: ParallelContext):
    """Greedy next token from LOCAL logits [B,Vl] (deterministic tie-break:
    smallest global id among the maximisers)."""
    v_local = logits.shape[-1]
    base = pc.tp_index() * v_local
    val = logits.max(-1).values
    idx = base + logits.argmax(-1)
    gmax = pc.pmax_tp(val)
    cand = torch.where(val >= gmax, idx, torch.full_like(idx, 2**30))
    return -pc.pmax_tp(-cand)  # global min over candidates


def vocab_parallel_sample(logits, generator: torch.Generator, temperature,
                          pc: ParallelContext):
    """Gumbel-max sampling: independent Gumbel noise per column from
    ``generator`` (which must live on the logits' device), then the argmax
    is an exact sample from softmax(logits/T). The noise stream differs from
    JAX's threefry stream; compare sampled paths by distribution. At tp > 1
    every rank draws the noise of the whole (padded) vocabulary from its
    generator, seeded alike on every rank, and keeps its shard's columns:
    the draw tp = 1 makes from the same seed."""
    v_local = logits.shape[-1]
    u = torch.rand((*logits.shape[:-1], v_local * pc.tp_size),
                   generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = u[..., pc.tp_index() * v_local:(pc.tp_index() + 1) * v_local]
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return vocab_parallel_argmax(logits / max(temperature, 1e-6) + g, pc)
