"""Serving: one-shot generation and the continuous-batching engine.

The programs of the JAX package's ``serve/engine.py``:
  make_prefill     — logits + cache from a full prompt batch
  make_serve_step  — ONE new token against the cache
  generate         — prefill, then ``n_new - 1`` decode steps
  PagedEngine      — continuous batching over a paged pair-KV pool
                     (``add_request`` / ``step`` / ``drain`` / ``cancel``)

The decode loop is a Python loop where the JAX package runs ``lax.scan``;
the KV cache and the page pool are updated in place, so each is held once.
Sampling is greedy (argmax, smallest id on ties) or Gumbel-max from a
``torch.Generator``.

Continuous batching
-------------------
``PagedEngine`` serves requests of different lengths that arrive at
different times, share ONE paged pool (``serve.paged_cache``) and finish
independently. The decode step is one fixed-shape program over ``n_slots``
decode slots (idle slots point at the garbage page and the host ignores
their rows), with per-slot positions and a block table as its only
per-step inputs; they go to the device in one copy, and the step's tokens
and finite flags come back in one. Admission is FCFS under a prefill token
budget (``serve.scheduler``). Admitted prompts prefill through the bucket
ladder (``serve.bucketing``: several right-padded prompts in one
``[rows, bucket]`` launch, radix-hit suffixes beside cold prompts), or at
their exact length when the ladder is off or tops out.

Prefix sharing and preemption: admission radix-matches the prompt against
donated whole pages (``serve.prefix_cache``); matched pages link read-only
into the block table and only the unmatched suffix is prefilled, over the
matched pages gathered as context kv. A blocked queue head preempts the
youngest running request: its tokens park on the request, its whole
written pages are donated, and resume replays the parked positions
through the regular decode program (with greedy sampling and an fp32 pool
the engine asserts that every replayed token reproduces the parked one).

Robustness: per-request failures are contained. The decode and prefill
programs return a per-row finite flag beside the tokens, every running
slot's block table is checked against its request's pages before each
launch, and prompts are re-checked against the vocabulary at admission. A
tripped guard FAILs exactly that request and scrubs its private pages;
requests carry deadlines and can be cancelled; ``max_queue`` bounds the
queue with deadline-aware shedding; a ``serve.faults.FaultPlan`` injects
seeded faults through the same hooks.

Recurrent mixers (Mamba, RG-LRU): the state lives per decode slot beside
the pages (``serve.paged_cache``), so there is nothing to share or to pad;
a hybrid (recurrentgemma) keeps its attention layers' kv in pages and its
RG-LRU state in slots of the same pool. The
prefix cache and the bucket ladder switch off for such a model (as in the
JAX engine): every admission prefills its exact prompt in its own launch,
and a preempted request resumes by a full re-prefill and a replay that
leaves every other slot's state as it was.

Overload degradation (``degrade_delta``): the engine re-pairs the SAME
weights under a more aggressive Δ plan (``core.lp.replan``, no reload, no
retraining) and reserves ``degrade_slots`` decode slots as a DEGRADED
cohort with its own decode program over its own pool tree (same page-id
space). Under SLO pressure (queue depth >= ``degrade_queue_depth``) new
admissions overflow into that cohort; its greedy streams equal an engine
built wholly at the aggressive plan, and the cohorts never share radix
pages (kv bits are plan-specific).

Self-speculative decoding (``spec_k > 0``, ``serve.speculative``): the
same weights re-paired at an aggressive Δ draft ``spec_k`` tokens per slot,
and ONE full-depth verify launch at batch ``n_slots * (spec_k + 1)``
accepts the drafts the full model agrees with plus its own bonus token.
The whole episode (drafts, probe-row packing, verify) is one device
episode with one host-to-device copy in and one copy out; rejected
positions are then un-written in both pool trees. Greedy streams equal the
``spec_k = 0`` engine's. Recurrent mixers turn speculation off with a
warning.

This is the JAX engine for attention + MLP models, Mamba models, the
RG-LRU hybrid and the mixture-of-experts models (dbrx, llama4) at world
size 1. The prefix-LM (paligemma) and encoder-decoder (whisper) models run
through ``generate`` only, as in the JAX package: the paged pool refuses
them (``paged_cache.validate_paged_support``).

Tensor parallel serving (every family): one process per rank, each with
its shard of the weights (``transformer.init_params(rank=)``,
``bridge.shard_from_numpy``) and its ``ParallelContext``, runs the same
program: ``sharded_generate`` (the ring cache; every family, with a
prefix-LM's patch embeddings or an encoder's frames), or a ``PagedEngine``
given the rank's ``pc`` (every family the pool pages). The ring cache's
``ServeConfig.kv_mode="seq"`` cuts the full-length rings of replicated kv
heads along the sequence over the ranks (``blocks.seq_sharded_kind``);
the pool pages kv heads only. Every rank runs the same scheduler, prefix
cache and bucket ladder on the same requests; the tokens come from the
vocab-parallel argmax and the finite flags are agreed over the ranks
(``pmax_tp``), so the host decisions of all ranks agree. Each rank's pool
holds its share of split kv heads, or every stored head when kv is
replicated (the paged kernel then reads the rank's through its head
map), and its channels of the recurrent slot state. The recurrent and MoE
families prefill every admission exactly at tp > 1 too (no prefix cache,
no buckets). ``spec_k`` and ``degrade_delta`` are tp=1-only, as in the JAX
package.

FSDP serving: on a (pod, data, model) grid of rank processes
(``parallel.context.make_grid_context``) a structure built with ``fsdp``
(and ``quant`` for int8 shards) keeps each rank's flat shards of the
segments and gathers one group's weights over the data ranks in the
group's turn of every prefill and decode step; the batch and the pool are
replicated over the pod and data ranks. ``spec_k`` and ``degrade_delta``
re-pair the segments and refuse such a structure.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lp as LP
from repro_torch.model import embedding as E
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import bucketing as BK
from repro_torch.serve import faults as F
from repro_torch.serve import paged_cache as PG
from repro_torch.serve import speculative as SP
from repro_torch.serve.faults import (BlockTableCorruptionError,
                                      InvalidRequestError, LoadShedError,
                                      NonFiniteLogitsError,
                                      PoisonedPromptError, QueueFullError)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import (COHORT_DEGRADED, COHORT_MAIN,
                                         TERMINAL_STATES, PagePool, Request,
                                         Scheduler)
from repro_torch.serve.telemetry import (DECODE, PREFILL, REPLAY,
                                         ProgramCache, Telemetry)
from repro_torch.serve.trace import write_trace


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024           # KV-cache length
    temperature: float = 0.0      # 0 -> greedy
    cache_dtype: Any = torch.bfloat16
    # Pinned-tile prefill attention (serve.bucketing): every prefill
    # consumer runs the same impl.
    attn_impl: str = BK.PREFILL_ATTN_IMPL
    # The ring cache at tp > 1: "heads" (kv heads split, or replicated
    # whole on every rank) or "seq" (replicated kv heads' full-length rings
    # cut along the sequence, ``blocks.seq_sharded_kind``).
    kv_mode: str = "heads"


def make_prefill(ms: T.ModelStructure, pc: ParallelContext, sv: ServeConfig):
    """prefill(params, tokens, prefix=None, frames=None) -> (last-position
    logits, caches); ``prefix`` (patch embeddings, vlm) and ``frames``
    (frame embeddings, encdec) as ``transformer.forward_full`` takes
    them."""
    def prefill_fn(params, tokens, prefix=None, frames=None):
        return T.prefill(params, tokens, ms=ms, pc=pc, max_len=sv.max_len,
                         prefix_embed=prefix, enc_frames=frames,
                         kv_mode=sv.kv_mode, attn_impl=sv.attn_impl,
                         cache_dtype=sv.cache_dtype)
    return prefill_fn


def _choose(logits, generator, sv: ServeConfig, pc: ParallelContext):
    if sv.temperature > 0:
        return E.vocab_parallel_sample(logits, generator, sv.temperature, pc)
    return E.vocab_parallel_argmax(logits, pc)


def make_serve_step(ms: T.ModelStructure, pc: ParallelContext, sv: ServeConfig):
    """serve_step(params, tok [B], caches, t, generator) -> (next_tok [B],
    caches): embed -> stack -> head -> greedy or sampled choice. The caches
    are updated in place."""
    def serve_fn(params, tok, caches, t, generator=None):
        logits, caches = T.decode_step(params, tok, caches, t, ms=ms, pc=pc,
                                       kv_mode=sv.kv_mode)
        return _choose(logits, generator, sv, pc), caches
    return serve_fn


def _now(dev: torch.device) -> float:
    """Host clock once the device has finished the work queued so far."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def generate(params, prompts, n_new: int, *, ms: T.ModelStructure,
             pc: ParallelContext, sv: ServeConfig,
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None,
             prefix=None, frames=None):
    """Greedy/temperature generation: returns [B, n_new] new tokens.

    ``prefix`` [B, P, D] (a prefix-LM's patch embeddings) goes in front of
    the prompts, so decode starts at position P + S; ``frames`` [B, T, D]
    (an encoder-decoder's frame embeddings) feed the encoder.
    ``prompts`` [B, S], ``prefix`` and ``frames`` must lie on the weights'
    device. Sampling
    (``sv.temperature > 0``) draws from ``generator``, which must live on
    that device too. A ``timings`` dict receives ``prefill_s`` (prefill and
    the first token's choice) and ``decode_s`` (the ``n_new - 1`` decode
    steps) of this call, in seconds; each mark waits for the device."""
    params = as_tree(params)
    dev = params["embed"]["tok"].device
    for name, x in (("prompts", prompts), ("prefix", prefix), ("frames", frames)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} on {x.device}, weights on {dev}")
    t0 = prompts.shape[1] + (ms.cfg.prefix_len if prefix is not None else 0)
    if t0 + n_new - 1 > sv.max_len:
        raise ValueError(f"prompt {t0} (prefix included) + {n_new} new tokens "
                         f"overflow the cache (max_len={sv.max_len})")
    if sv.temperature > 0 and generator is None:
        raise ValueError("sampling needs a torch.Generator")
    prefill_fn = make_prefill(ms, pc, sv)
    step_fn = make_serve_step(ms, pc, sv)
    marks = [_now(dev)] if timings is not None else None
    logits, caches = prefill_fn(params, prompts, prefix, frames)
    tok = _choose(logits, generator, sv, pc)
    if marks:
        marks.append(_now(dev))
    toks = []
    for i in range(n_new - 1):
        # ``tok`` sits at absolute position t0 + i; its logits predict i+1.
        nxt, caches = step_fn(params, tok, caches, t0 + i, generator)
        toks.append(tok)
        tok = nxt
    if marks:
        marks.append(_now(dev))
        timings.update(prefill_s=marks[1] - marks[0], decode_s=marks[2] - marks[1])
    return torch.stack(toks + [tok], dim=1)


def sharded_generate(params, prompts, n_new: int, *, ms: T.ModelStructure,
                     pc: ParallelContext, sv: ServeConfig,
                     timings: Optional[Dict[str, float]] = None,
                     prefix=None, frames=None):
    """One-shot greedy generation at tp > 1 on the ring cache: the tp > 1
    reference stream the sharded ``PagedEngine`` is held to. Each rank's
    process calls it with its own shard of the weights, its context and the
    same ``prompts`` [B, S] (and the same ``prefix`` patch embeddings or
    encoder ``frames``, replicated, as ``generate`` takes them); all ranks
    return the same [B, n_new] tokens (the vocab-parallel argmax). It is
    ``generate`` under the rank's context: where the JAX package runs the
    ranks under ``shard_map`` from one process, every rank here runs the
    same host loop. (The JAX package's ``sharded_generate`` refuses the
    prefix and the frames; its sharded prefill and serve step take them.)

    On a grid context (``make_grid_context``) the batch is replicated over
    the pod and data ranks, as the JAX package's sharded decode keeps it
    (``shard_batch=False``); an FSDP structure (``ms.fsdp``, with bf16/fp32
    or int8 shards) gathers each group's weights over the context's data
    ranks, of which it must have ``ms.fsdp_data``."""
    if pc.tp_size != ms.tp:
        raise ValueError(f"a tp_size={pc.tp_size} context for a tp={ms.tp} "
                         "structure")
    if sv.temperature != 0.0:
        raise ValueError("sharded generation is the greedy reference "
                         "(temperature 0)")
    return generate(params, prompts, n_new, ms=ms, pc=pc, sv=sv,
                    timings=timings, prefix=prefix, frames=frames)


# ---------------------------------------------------------------------------
# Continuous batching over the paged pair-KV pool
# ---------------------------------------------------------------------------

def _agreed(ok: torch.Tensor, pc: ParallelContext) -> torch.Tensor:
    """A per-row flag true on every rank (``pmax_tp`` of its negation), so
    each rank takes the same host decision on a row whose shard of the
    logits or the cache is not finite on one rank only."""
    if pc.tp_size == 1:
        return ok
    return pc.pmax_tp((~ok).to(torch.int32)) == 0


def _rows_finite(logits, seq, pc: ParallelContext) -> torch.Tensor:
    """[rows] bool: each row's logits and emitted cache are all finite, on
    every rank."""
    ok = torch.isfinite(logits).all(-1)
    for seg in seq:
        for name, c in seg.items():
            c = c.movedim(T.cache_batch_axis(name), 0)
            ok = ok & torch.isfinite(c).reshape(c.shape[0], -1).all(-1)
    return _agreed(ok, pc)


def make_paged_decode_fn(ms: T.ModelStructure, pc: ParallelContext, psv):
    """Paged decode step: (params, caches, tok [n_slots], pos [n_slots],
    block_tables [n_slots, n_pg], poison [n_slots] bool, generator) ->
    (next_tok [n_slots], ok [n_slots] bool, caches); the pool is updated in
    place.

    ``ok[slot]`` is the per-row finite guard: False when the slot's logits
    hold NaN/inf (on any rank: every rank reports alike). ``poison`` is the
    deterministic-chaos hook: True rows get
    their logits overwritten with NaN BEFORE the guard; an all-False mask
    is a bitwise no-op (``where`` with a false predicate returns the
    original lanes)."""
    def f(params, caches, tok, pos, bt, poison, generator=None):
        logits, caches = T.decode_step(params, tok, caches, pos, ms=ms, pc=pc,
                                       cache_layout="paged", block_tables=bt)
        logits = torch.where(poison[:, None], torch.nan, logits)
        ok = _agreed(torch.isfinite(logits).all(-1), pc)
        return _choose(logits, generator, psv, pc), ok, caches
    return f


def make_spec_step_fn(ms_draft: T.ModelStructure, ms: T.ModelStructure,
                      pc: ParallelContext, psv, k: int):
    """Speculative step: (params_draft, params, caches_draft, caches, tok,
    pos, bt, poison, remaining) -> (drafts [k, n], yhat [n*(k+1)],
    ok [n*(k+1)]); both pools are updated in place.

    One device episode: ``k`` greedy draft steps at the drafter's plan (the
    device-side twin of ``speculative.build_draft_step``: a slot whose
    commit budget ends mid-episode feeds token 0 at position 0 against the
    garbage page), the probe-row packing (twin of
    ``speculative.build_verify_batch``: row ``s*(k+1)+j`` feeds slot s's
    token j at p0+j), and ONE full-depth verify through the regular paged
    decode at batch ``n*(k+1)``. Nothing in it reads a value back to the
    host. Draft rows are never poisoned and their finite flags are ignored
    (garbage proposals are simply refused by the verify, whose own per-row
    ``ok`` is returned); a poisoned slot's flag goes to each of its live
    verify rows."""
    draft = make_paged_decode_fn(ms_draft, pc, psv)
    verify = make_paged_decode_fn(ms, pc, psv)

    def f(params_draft, params, caches_draft, caches, tok, pos, bt, poison,
          remaining):
        n = tok.shape[0]
        no_poison = torch.zeros((n,), dtype=torch.bool, device=tok.device)
        garbage = torch.full_like(bt, PG.GARBAGE_PAGE)
        prev, drafts = tok, []
        for j in range(k):
            act = (remaining >= 0) & (j <= remaining)
            d, _, _ = draft(params_draft, caches_draft,
                            torch.where(act, prev, 0),
                            torch.where(act, pos + j, 0),
                            torch.where(act[:, None], bt, garbage), no_poison)
            prev = d.to(tok.dtype)
            drafts.append(prev)
        drafts = torch.stack(drafts)                            # [k, n]
        j = torch.arange(k + 1, dtype=pos.dtype, device=pos.device)
        act = (remaining[:, None] >= 0) & (j <= remaining[:, None])  # [n, k+1]
        u = torch.cat([tok[:, None], drafts.T], dim=1)
        tok_v = torch.where(act, u, 0).reshape(-1)
        pos_v = torch.where(act, pos[:, None] + j, 0).reshape(-1)
        bt_v = torch.where(act[:, :, None], bt[:, None], garbage[:, None])
        poison_v = (poison[:, None] & act).reshape(-1)
        yhat, ok, _ = verify(params, caches, tok_v, pos_v,
                             bt_v.reshape(n * (k + 1), -1), poison_v)
        return drafts, yhat, ok
    return f


def make_paged_prefill_fn(ms: T.ModelStructure, pc: ParallelContext, psv,
                          prompt_len: int):
    """Exact-length prefill + page scatter: (params, caches, prompt
    [1, prompt_len], page_ids, slot, generator) -> (first_tok [1], ok [1],
    caches). ``ok`` covers the sampled position's logits AND the emitted
    cache (a poisoned prompt corrupts the kv it writes, not just the
    logits). The cache emission rounds up to whole pages; the forward is
    the exact prompt, no padding. State entries (Mamba) land at ``slot``."""
    emit_len = -(-prompt_len // psv.page_size) * psv.page_size

    def f(params, caches, prompt, page_ids, slot, generator=None):
        logits, _, seq = T.forward_full(
            params, prompt, ms=ms, pc=pc, emit_cache=True, max_len=emit_len,
            attn_impl=BK.PREFILL_ATTN_IMPL)
        seq = T.cast_cache(seq, psv.cache_dtype)
        last = logits[:, prompt_len - 1]
        ok = _rows_finite(last, seq, pc)
        tok0 = _choose(last, generator, psv, pc)
        PG.scatter_prefill(caches, seq, page_ids, slot)
        return tok0, ok, caches
    return f


def make_paged_bucket_prefill_fn(ms: T.ModelStructure, pc: ParallelContext,
                                 psv, bucket: int, rows: int,
                                 ctx_pages: int = 0):
    """Bucketed batched prefill + masked page scatter: (params, caches,
    prompts [rows, bucket], true_lens [rows], page_ids [rows, n_pg],
    [ctx_ids [rows, ctx_pages], ctx_lens [rows],] generator)
    -> (first_tok [rows], ok [rows], caches).

    ONE launch prefills up to ``rows`` requests right-padded to ``bucket``
    tokens. Row i's token comes from its logits at ``true_lens[i] - 1``,
    which the pinned-tile attention keeps independent of the padding. The
    per-row finite guard covers the sampled logits AND the row's emitted
    cache, so one poisoned request fails alone. Pad rows carry
    ``true_lens == 1`` and all-garbage page ids; their junk never lands.

    ``ctx_pages > 0`` makes the program CTX-AWARE (prefix-on engines):
    radix-HIT rows ride the same launch as cold rows. Row i's matched
    prefix pages arrive in ``ctx_ids[i]`` (garbage-padded to the uniform
    width) with its ctx length in ``ctx_lens[i]`` (int32, on the device);
    ``prompts[i]`` then holds only the suffix, and the forward runs with
    per-row start offsets. Cold rows pass ctx_len 0 and all-garbage ids."""
    def f(params, caches, prompts, true_lens, page_ids, *rest):
        if ctx_pages:
            ctx_ids, ctx_lens, generator = rest
            ctx, start = PG.gather_ctx_rows(caches, ctx_ids), ctx_lens
        else:
            (generator,) = rest
            ctx, start = None, 0
        logits, _, seq = T.forward_full(
            params, prompts, ms=ms, pc=pc, emit_cache=True, max_len=bucket,
            ctx_kv=ctx, start=start, attn_impl=BK.PREFILL_ATTN_IMPL)
        seq = T.cast_cache(seq, psv.cache_dtype)
        idx = (true_lens.long() - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
        last = logits.gather(1, idx)[:, 0]
        ok = _rows_finite(last, seq, pc)
        tok0 = _choose(last, generator, psv, pc)
        PG.scatter_prefill_rows(caches, seq, page_ids)
        return tok0, ok, caches
    return f


def make_paged_suffix_prefill_fn(ms: T.ModelStructure, pc: ParallelContext,
                                 psv, n_ctx_pages: int, suffix_len: int):
    """Prefix-hit suffix prefill: (params, caches, suffix [1, suffix_len],
    ctx_ids [n_ctx_pages], sfx_ids, generator) -> (first_tok [1], ok [1],
    caches). Gathers the matched pages as read-only context kv, runs the
    forward over ONLY the unmatched suffix (every row reduces over exactly
    ``ctx + suffix`` keys, the cold program's shape for that row), and
    scatters the suffix pages. Copy-on-write holds by construction: only
    ``sfx_ids`` pages are written."""
    ps = psv.page_size
    start = n_ctx_pages * ps
    emit_len = -(-suffix_len // ps) * ps

    def f(params, caches, suffix, ctx_ids, sfx_ids, generator=None):
        ctx = PG.gather_ctx(caches, ctx_ids)
        logits, _, seq = T.forward_full(
            params, suffix, ms=ms, pc=pc, emit_cache=True, max_len=emit_len,
            ctx_kv=ctx, start=start, attn_impl=BK.PREFILL_ATTN_IMPL)
        seq = T.cast_cache(seq, psv.cache_dtype)
        last = logits[:, suffix_len - 1]
        ok = _rows_finite(last, seq, pc)
        tok0 = _choose(last, generator, psv, pc)
        PG.scatter_prefill(caches, seq, sfx_ids)
        return tok0, ok, caches
    return f


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission-side knobs: how much prefill work a step may take on and
    how the submit queue bounds itself. ``prefill_buckets``: None picks the
    auto ladder (``bucketing.default_buckets``), an empty tuple disables
    bucketing (every prefill runs the exact-length program), an explicit
    tuple is validated against the page geometry."""
    prefill_token_budget: int = 4096
    max_queue: int = 0
    prefill_buckets: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class DegradeConfig:
    """Overload degradation: the aggressive-Δ slot cohort."""
    enabled: bool = False
    slots: int = 0
    queue_depth: int = 1
    eff_depth: int = 0


@dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding: draft length and drafter depth."""
    k: int = 0
    delta: int = 0


@dataclass(frozen=True)
class TelemetryConfig:
    """Observability retention + profiling hooks."""
    enabled: bool = True
    profile_decode: bool = False


@dataclass(frozen=True)
class PagedServeConfig:
    """Static geometry of the continuous-batching engine, with the JAX
    package's fields and grouping.

    The flat fields decompose into four sub-configs (``AdmissionConfig``,
    ``DegradeConfig``, ``SpecConfig``, ``TelemetryConfig``), passable as
    the ``admission`` / ``degrade`` / ``spec`` / ``telemetry_cfg`` kwargs;
    after construction both views are populated and consistent. ``validate()``
    holds every cross-field rule; the engine calls it first thing.

    max_len must be a page multiple: decode attends over exactly
    ``pages_per_slot * page_size == max_len`` positions, the horizon a ring
    cache of ``max_len`` gives one-shot ``generate()``. ``n_pages``
    INCLUDES the reserved garbage page 0 (capacity ``n_pages - 1``).
    prefix_cache: radix prefix sharing over whole pages. preempt_after:
    > 0 preempts the youngest running request after that many consecutive
    steps with a blocked queue head. max_queue: > 0 bounds the submit queue
    (deadline-aware shedding, else ``QueueFullError``). telemetry=False
    drops span/gauge-series/wall retention; profile_decode wraps each
    decode launch in a ``torch.profiler.record_function`` range.
    degrade_delta: the aggressive-Δ overload cohort on the top
    ``degrade_slots`` slots. spec_k: self-speculative decoding with that
    many drafts per verify.
    """
    n_slots: int = 8              # concurrent decode slots (fixed batch)
    page_size: int = 16           # tokens per cache page
    n_pages: int = 129            # pool size incl. the reserved garbage page
    max_len: int = 256            # per-request position cap (page multiple)
    prefill_token_budget: int = 4096   # admission budget per step
    temperature: float = 0.0      # 0 -> greedy
    cache_dtype: Any = torch.bfloat16
    eos_token: int = -1           # -1: run every request to max_new
    prefix_cache: bool = False    # radix prefix sharing (CoW pages)
    preempt_after: int = 0        # blocked-head steps before preemption
    max_queue: int = 0            # bounded submit queue (0 = unbounded)
    degrade_delta: bool = False   # aggressive-Δ overload cohort
    degrade_slots: int = 0        # slots reserved for the degraded cohort
    degrade_queue_depth: int = 1  # queue depth that signals SLO pressure
    degrade_eff_depth: int = 0    # effective depth of the cohort (0 = max Δ)
    spec_k: int = 0               # speculative draft length (0 = off)
    spec_delta: int = 0           # drafter effective depth (0 = max Δ)
    telemetry: bool = True        # retain spans/gauge series/wall marks
    profile_decode: bool = False  # profiler range around each decode launch
    # Bucketed prefill ladder: None = auto (powers-of-two page multiples
    # capped at max_len), () = off, explicit tuple = validated ladder.
    prefill_buckets: Optional[Tuple[int, ...]] = None
    admission: Optional[AdmissionConfig] = None
    degrade: Optional[DegradeConfig] = None
    spec: Optional[SpecConfig] = None
    telemetry_cfg: Optional[TelemetryConfig] = None

    def __post_init__(self):
        def put(name, value):   # frozen dataclass
            object.__setattr__(self, name, value)

        if self.admission is not None:
            a = self.admission
            put("prefill_token_budget", a.prefill_token_budget)
            put("max_queue", a.max_queue)
            put("prefill_buckets", a.prefill_buckets)
        if self.degrade is not None:
            d = self.degrade
            put("degrade_delta", d.enabled)
            put("degrade_slots", d.slots)
            put("degrade_queue_depth", d.queue_depth)
            put("degrade_eff_depth", d.eff_depth)
        if self.spec is not None:
            put("spec_k", self.spec.k)
            put("spec_delta", self.spec.delta)
        if self.telemetry_cfg is not None:
            put("telemetry", self.telemetry_cfg.enabled)
            put("profile_decode", self.telemetry_cfg.profile_decode)
        if self.prefill_buckets is not None:
            put("prefill_buckets", tuple(self.prefill_buckets))
        put("admission", AdmissionConfig(
            prefill_token_budget=self.prefill_token_budget,
            max_queue=self.max_queue, prefill_buckets=self.prefill_buckets))
        put("degrade", DegradeConfig(
            enabled=self.degrade_delta, slots=self.degrade_slots,
            queue_depth=self.degrade_queue_depth,
            eff_depth=self.degrade_eff_depth))
        put("spec", SpecConfig(k=self.spec_k, delta=self.spec_delta))
        put("telemetry_cfg", TelemetryConfig(
            enabled=self.telemetry, profile_decode=self.profile_decode))

    def validate(self, *, tp_size: int = 1) -> None:
        """Every cross-field configuration rule, as actionable
        ValueErrors. ``tp_size``: the engine's tensor-parallel degree; some
        features are tp=1-only, as in the JAX package."""
        if self.max_len % self.page_size != 0:
            raise ValueError(
                f"max_len={self.max_len} is not a multiple of "
                f"page_size={self.page_size}: the decode step attends over "
                "exactly pages_per_slot * page_size positions — pick max_len "
                "as a whole number of pages")
        if self.n_slots < 1:
            raise ValueError(
                f"n_slots={self.n_slots} must be >= 1: the decode program's "
                "fixed batch is the slot count")
        if self.max_queue < 0:
            raise ValueError(f"max_queue={self.max_queue} must be >= 0 "
                             "(0 = unbounded)")
        if self.prefill_buckets:
            BK.validate_buckets(self.prefill_buckets,
                                page_size=self.page_size,
                                max_len=self.max_len)
        if self.degrade_delta:
            if not 1 <= self.degrade_slots < self.n_slots:
                raise ValueError(
                    f"degrade_delta needs 1 <= degrade_slots < n_slots "
                    f"(got degrade_slots={self.degrade_slots}, "
                    f"n_slots={self.n_slots})")
            if tp_size > 1:
                raise ValueError(
                    "degrade_delta is tp=1-only for now: the degraded "
                    "cohort would need its own sharded program pair and "
                    "replanned param placement")
        elif self.degrade_slots:
            raise ValueError(
                f"degrade_slots={self.degrade_slots} without degrade_delta: "
                "set degrade_delta=True or degrade_slots=0")
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k} must be >= 0 (0 = off)")
        if self.spec_k:
            if self.temperature > 0:
                raise ValueError("spec_k needs temperature=0.0: acceptance "
                                 "compares greedy argmax ids")
            if tp_size > 1:
                raise ValueError(
                    "spec_k is tp=1-only for now: the draft and wide "
                    "verify programs need their own sharded wrappers and "
                    "replanned param placement")
            if self.degrade_delta:
                raise ValueError("spec_k is exclusive with degrade_delta")
        elif self.spec_delta:
            raise ValueError(f"spec_delta={self.spec_delta} without spec_k: "
                             "set spec_k >= 1 to enable speculative decoding")

    @property
    def pages_per_slot(self) -> int:
        return self.max_len // self.page_size


class PagedEngine:
    """Continuous-batching serving engine: ``add_request / step / drain``.

    One ``step()`` is: chaos injection (when armed) -> deadline expiry ->
    FCFS admission (prompts and prefill outputs pass fault guards; bucket
    groups prefill in one launch each) -> block-table validation -> ONE
    fixed-shape decode launch per active cohort (the main cohort's is a
    speculative episode when ``spec_k > 0``). Finished requests release
    their slot and pages the same step; FAILED/CANCELLED/EXPIRED requests
    release within the step that terminates them.

    Greedy outputs per request equal one-shot ``generate(params,
    prompt[None], max_new)`` with this engine's ``max_len`` (at the
    degraded plan for a degraded-cohort request): every cross-request
    interaction is row-independent, which is also why failing one slot
    leaves the survivors' streams untouched. The engine runs on the
    weights' device: the card, or the CPU when the caller put the weights
    there (kernels' plain versions).

    ``fault_plan``: a ``serve.faults.FaultPlan``; each step applies that
    step's events through the same hooks real faults take, and
    ``fault_log`` records what fired.

    ``pc``: this rank's context at tp > 1 (``ms`` built at its tp_size,
    ``params`` the rank's shard); every rank builds its engine alike and
    submits the same requests in the same steps. An FSDP structure serves
    on a grid context whose data ranks hold its shards: every prefill and
    decode launch gathers each group's weights in the group's turn.
    """

    #: Every monotone engine counter, pre-registered at 0. Per-step
    #: ``step()`` stats are DELTAS of the lifecycle subset over the step.
    COUNTER_KEYS = (
        "prefill_tokens", "hit_tokens", "resume_hit_tokens",
        "replay_tokens", "full_prefills", "suffix_prefills", "prefix_hits",
        "bucket_prefills", "bucket_groups", "pad_tokens",
        "submitted", "admitted", "decoded", "finished", "preempted",
        "failed", "expired", "cancelled", "shed", "degraded_admissions",
        "draft_steps", "verify_steps", "spec_accepted", "spec_rejected",
        "spec_rewound")
    #: The subset ``step()`` reports as per-step deltas.
    STEP_STAT_KEYS = ("admitted", "decoded", "finished", "preempted",
                      "failed", "expired")

    def __init__(self, params, ms: T.ModelStructure, psv: PagedServeConfig,
                 *, pc: Optional[ParallelContext] = None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 fault_plan: Optional[F.FaultPlan] = None):
        if mesh is not None:
            raise ValueError(
                "the port serves tensor parallel as one process per rank: "
                "build one engine in each, with the rank's shard and its "
                "ParallelContext (pc=), and start the ranks with "
                "launch.mesh.spawn_ranks (as launch.serve --mesh 1xM does)")
        self.pc = pc if pc is not None else ParallelContext()
        if self.pc.tp_size != ms.tp:
            raise ValueError(f"a tp_size={self.pc.tp_size} context for a "
                             f"tp={ms.tp} structure")
        psv.validate(tp_size=ms.tp)
        if ms.fsdp and (psv.spec_k or psv.degrade_delta):
            raise ValueError(
                "spec_k and degrade_delta re-pair the segments' weights, and "
                "an FSDP structure holds them as flat shards: serve it with "
                "neither")
        PG.validate_paged_support(ms, psv.max_len)
        self.ms = ms
        self.psv = psv
        self.params = as_tree(params)
        self.device = self.params["embed"]["tok"].device
        self.n_main = psv.n_slots - (psv.degrade_slots
                                     if psv.degrade_delta else 0)
        self.n_deg = psv.n_slots - self.n_main
        cfg = ms.cfg
        # Degraded-cohort model: the SAME weights re-paired under an
        # aggressive Δ plan. Only the re-paired segments are new tensors;
        # the embedding and head are shared.
        self.ms_deg = self.params_deg = None
        if psv.degrade_delta:
            deg_plan = (LP.plan_for_depth(cfg, psv.degrade_eff_depth,
                                          end=cfg.n_layers)
                        if psv.degrade_eff_depth > 0
                        else LP.plan_range(cfg, 0, cfg.n_layers))
            if len(deg_plan.pairs) <= len(ms.plan.pairs):
                raise ValueError(
                    f"degraded plan pairs {len(deg_plan.pairs)} vs base "
                    f"{len(ms.plan.pairs)}: the degraded cohort must be "
                    "strictly MORE aggressive than the base plan (lower "
                    "degrade_eff_depth, or use a shallower base)")
            self.ms_deg, self.params_deg = self._replanned(deg_plan)
        # Speculative drafter: the same weights re-paired at an aggressive
        # Δ. Recurrent mixers turn speculation off with a warning, and the
        # engine then behaves exactly as spec_k=0.
        self.spec_k = psv.spec_k
        self.ms_draft = self.params_draft = None
        if self.spec_k and not SP.spec_eligible(ms):
            warnings.warn(
                f"{cfg.name}: speculative decoding auto-disabled — "
                "recurrent mixer state (mamba conv/h, RG-LRU h) advances "
                "on every launch and has no per-position representation "
                "to rewind; serving continues non-speculatively",
                stacklevel=2)
            self.spec_k = 0
        if self.spec_k:
            self.ms_draft, self.params_draft = self._replanned(
                SP.draft_plan_for(cfg, ms.plan, psv.spec_delta))
        self.telemetry = Telemetry(enabled=psv.telemetry)
        self.telemetry.seed_counters(self.COUNTER_KEYS)
        self.telemetry.fault_counts.update({k: 0 for k in F.ALL_FAULT_KINDS})
        # One home for every program, keyed (cohort, program, shape) like
        # the telemetry compile events.
        self._programs = ProgramCache(self.telemetry)
        self.pool = PagePool(psv.n_pages)
        self.prefix = (PrefixCache(psv.page_size, telemetry=self.telemetry)
                       if psv.prefix_cache and self._prefix_eligible(ms)
                       else None)
        # Bucketed prefill needs the pinned-tile attention's padding
        # transparency, which only attention mixers have: the prefix
        # cache's gate. None = auto ladder, () = off.
        if psv.prefill_buckets == () or not self._prefix_eligible(ms):
            self._buckets: Tuple[int, ...] = ()
        elif psv.prefill_buckets is None:
            self._buckets = BK.default_buckets(psv.max_len, psv.page_size)
        else:
            self._buckets = psv.prefill_buckets
        self.sched = Scheduler(
            n_slots=psv.n_slots, pool=self.pool, page_size=psv.page_size,
            max_len=psv.max_len,
            prefill_token_budget=psv.prefill_token_budget,
            prefix_cache=self.prefix, preempt_after=psv.preempt_after,
            degrade_slots=self.n_deg, telemetry=self.telemetry,
            prefill_buckets=self._buckets)

        def pool_for(model, n_slots):
            return PG.init_paged_caches(
                model, n_slots=n_slots, n_pages=psv.n_pages,
                page_size=psv.page_size, dtype=psv.cache_dtype,
                device=self.device)

        self.caches = pool_for(ms, self.n_main)
        # The degraded and draft trees span the SAME page-id space (one
        # host PagePool hands out ids to both cohorts; one block table
        # serves the main and draft trees). The draft tree holds
        # aggressive-plan kv that only feeds proposals: the verify reads
        # the MAIN tree, so draft bits can move acceptance but never
        # committed output.
        self.caches_deg = (pool_for(self.ms_deg, self.n_deg) if self.n_deg
                           else None)
        self.caches_draft = (pool_for(self.ms_draft, self.n_main)
                             if self.spec_k else None)
        P_slot = psv.pages_per_slot
        self.block_tables = np.full((self.n_main, P_slot), PG.GARBAGE_PAGE,
                                    np.int32)
        self.tok = np.zeros((self.n_main,), np.int32)
        self.pos = np.zeros((self.n_main,), np.int32)
        self.block_tables_deg = np.full((self.n_deg, P_slot),
                                        PG.GARBAGE_PAGE, np.int32)
        self.tok_deg = np.zeros((self.n_deg,), np.int32)
        self.pos_deg = np.zeros((self.n_deg,), np.int32)
        if psv.temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.step_count = 0
        self.results: Dict[int, np.ndarray] = {}
        self._requests: Dict[int, Request] = {}
        self._decode = self._make_decode(COHORT_MAIN)
        self._decode_deg = (self._make_decode(COHORT_DEGRADED)
                            if self.n_deg else None)
        self._spec_step = None
        if self.spec_k:
            # One program holds both speculative bodies: the k-step draft
            # episode at the aggressive plan (batch n_main) and the
            # verifier, which IS the regular decode at batch
            # n_main * (spec_k + 1). It lives under the draft key and the
            # verify body is note()d, so the compile stream shows both.
            self._spec_step = self._programs.get(
                SP.COHORT_SPEC_DRAFT, "decode", self.n_main,
                lambda: make_spec_step_fn(self.ms_draft, ms, self.pc, psv,
                                          self.spec_k))
            self._programs.note(SP.COHORT_SPEC_VERIFY, "decode",
                                self.n_main * (self.spec_k + 1))
        # rids whose draft tree a bucketed draft-mirror launch primed this
        # step: _spec_prime then skips its full-prompt draft prefill.
        self._spec_primed: set = set()
        # Greedy + fp32 pool => replay recomputation reproduces the
        # original run; the engine then self-checks the replay.
        self._exact = (psv.temperature == 0.0
                       and psv.cache_dtype == torch.float32)
        self._plan = fault_plan
        self._poison_slots: set = set()   # slots NaN-poisoned THIS step
        self._poison_next = 0             # deferred poison_prompt events
        self._storm_next = 0              # deferred deadline_storm victims

    def _replanned(self, plan) -> Tuple[T.ModelStructure, Dict[str, Any]]:
        """(structure, params) of the same weights re-paired under
        ``plan``: new tensors for the re-stacked segments only."""
        cfg = self.ms.cfg
        segs, seg_params = LP.replan(cfg, self.params["segments"],
                                     self.ms.segments, plan)
        ms2 = T.build_structure(cfg, plan=plan, tp=self.ms.tp)
        assert tuple(s.group.specs for s in ms2.segments) == \
            tuple(s.group.specs for s in segs)
        return ms2, dict(self.params, segments=seg_params)

    @staticmethod
    def _prefix_eligible(ms: T.ModelStructure) -> bool:
        """Prefix sharing resumes from cached kv alone, so every mixer must
        be attention (recurrent conv/h state has no page representation)
        and the FFN a plain MLP or none."""
        return all(spec.mixer.startswith("attn") and not spec.cross_attn
                   and spec.ffn in ("mlp", None)
                   for seg in ms.segments for spec in seg.group.specs)

    @property
    def counters(self) -> Dict[str, int]:
        """Monotone event counters (the live Telemetry dict)."""
        return self.telemetry.counters

    @property
    def fault_log(self) -> List[Dict[str, Any]]:
        return self.telemetry.fault_log

    @property
    def fault_counts(self) -> Dict[str, int]:
        return self.telemetry.fault_counts

    # -- cohort plumbing ------------------------------------------------
    def _cohort_of_slot(self, slot: int) -> str:
        return COHORT_MAIN if slot < self.n_main else COHORT_DEGRADED

    def _arrays(self, cohort: str):
        """(tok, pos, block_tables, slot_base) for a cohort; slot indices
        into these arrays are ``global_slot - slot_base``."""
        if cohort == COHORT_MAIN:
            return self.tok, self.pos, self.block_tables, 0
        return self.tok_deg, self.pos_deg, self.block_tables_deg, self.n_main

    def _model(self, cohort: str):
        """(params, structure) of a cohort's programs."""
        if cohort == COHORT_MAIN:
            return self.params, self.ms
        if cohort == SP.COHORT_SPEC_DRAFT:
            return self.params_draft, self.ms_draft
        return self.params_deg, self.ms_deg

    def _get_caches(self, cohort: str):
        if cohort == COHORT_MAIN:
            return self.caches
        if cohort == SP.COHORT_SPEC_DRAFT:
            return self.caches_draft
        return self.caches_deg

    def _decode_fn(self, cohort: str):
        return self._decode if cohort == COHORT_MAIN else self._decode_deg

    # -- host <-> device ------------------------------------------------
    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Int arrays -> int32 tensors on the engine's device in ONE copy
        (each result is a contiguous view of one buffer)."""
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                               for a in arrays])
        buf = torch.from_numpy(flat).to(self.device)
        out, i = [], 0
        for a in arrays:
            n = int(np.prod(a.shape, dtype=np.int64))
            out.append(buf[i:i + n].view(a.shape))
            i += n
        return out

    @staticmethod
    def _to_host(*tensors) -> List[np.ndarray]:
        """Int or bool tensors (tokens, finite flags) -> int32 host arrays
        in ONE copy, each in its own shape."""
        flat = torch.cat([t.reshape(-1).to(torch.int32)
                          for t in tensors]).cpu()
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].numpy().reshape(t.shape))
            i += t.numel()
        return out

    # -- programs ---------------------------------------------------------
    # The build callables record nothing: callers go through
    # ``self._programs.get``, which records a compile event exactly once
    # per key.
    def _make_decode(self, cohort: str):
        return self._programs.get(
            cohort, "decode", len(self._arrays(cohort)[0]),
            lambda: make_paged_decode_fn(self._model(cohort)[1], self.pc,
                                         self.psv))

    def _prefill_fn(self, prompt_len: int, cohort: str):
        """Exact-length prefill for a cohort (the cohorts differ in the
        model structure and the pool tree)."""
        return self._programs.get(
            cohort, "prefill_full", prompt_len,
            lambda: make_paged_prefill_fn(self._model(cohort)[1], self.pc,
                                          self.psv, prompt_len))

    def _bucket_ctx_pages(self, cohort: str) -> int:
        """Ctx-page width of the cohort's bucket programs: prefix-on main
        cohorts route EVERY bucket launch through the ctx-aware program
        (cold rows pass ctx_len 0), so hits and colds share one program. A
        radix match always leaves a >= 2-token suffix
        (``Scheduler._match_cap``), so ctx pages <= pages_per_slot - 1.
        Draft-mirror and degraded launches keep the plain program (the
        radix tree never holds their plan's pages)."""
        if self.prefix is not None and cohort == COHORT_MAIN:
            return self.psv.pages_per_slot - 1
        return 0

    def _bucket_prefill_fn(self, bucket: int, rows: int, cohort: str):
        ctx_pages = self._bucket_ctx_pages(cohort)
        return self._programs.get(
            cohort, "prefill_bucket", (bucket, rows),
            lambda: make_paged_bucket_prefill_fn(
                self._model(cohort)[1], self.pc, self.psv, bucket, rows,
                ctx_pages))

    def _suffix_fn(self, n_ctx_pages: int, suffix_len: int):
        """Prefix-hit exact-shape prefill (main cohort only: the radix tree
        never holds degraded-plan pages)."""
        return self._programs.get(
            COHORT_MAIN, "prefill_suffix", (n_ctx_pages, suffix_len),
            lambda: make_paged_suffix_prefill_fn(self.ms, self.pc, self.psv,
                                                 n_ctx_pages, suffix_len))

    def _draft_decode_fn(self):
        """Single-step draft decode: only the resume catch-up needs it (the
        decode phase runs the speculative step instead)."""
        return self._programs.get(
            SP.COHORT_SPEC_DRAFT, "decode_catchup", self.n_main,
            lambda: make_paged_decode_fn(self.ms_draft, self.pc, self.psv))

    def _spec_prefill_fn(self, prompt_len: int):
        """Draft-tree prefill at the aggressive plan."""
        return self._programs.get(
            SP.COHORT_SPEC_DRAFT, "prefill_full", prompt_len,
            lambda: make_paged_prefill_fn(self.ms_draft, self.pc, self.psv,
                                          prompt_len))

    def _scrub_fn(self, cohort: str):
        return self._programs.get(cohort, "scrub",
                                  self.psv.pages_per_slot,
                                  lambda: PG.scrub_pages)

    # -- public API ----------------------------------------------------
    def add_request(self, prompt, max_new: int,
                    eos_token: Optional[int] = None,
                    deadline: Optional[int] = None) -> int:
        """Queue a request; returns its id. Submit-time validation
        (``Scheduler.submit``) rejects malformed work with typed
        ``InvalidRequestError``s; the engine adds the vocabulary-range
        check and the bounded-queue policy. ``deadline``: ABSOLUTE engine
        step by which the request must finish (None = none)."""
        arr = np.asarray(prompt)
        if arr.size and np.issubdtype(arr.dtype, np.integer):
            vocab = self.ms.cfg.vocab_size
            if (arr < 0).any() or (arr >= vocab).any():
                raise InvalidRequestError(
                    f"prompt holds token ids outside [0, {vocab}): "
                    f"min={int(arr.min())}, max={int(arr.max())}")
        if self.psv.max_queue and self.sched.n_queued >= self.psv.max_queue:
            self._shed_for(deadline)
        eos = self.psv.eos_token if eos_token is None else eos_token
        r = self.sched.submit(prompt, max_new, eos,
                              deadline=-1 if deadline is None else deadline,
                              step=self.step_count)
        self._requests[r.rid] = r
        # Deferred chaos events that needed a submission to land on.
        if self._poison_next > 0:
            self._poison_next -= 1
            r.prompt = r.prompt.copy()
            r.prompt[r.rid % r.prompt_len] = self.ms.cfg.vocab_size + 1
            self._log_fault(F.POISON_PROMPT, rid=r.rid, deferred=True)
        if self._storm_next > 0:
            self._storm_next -= 1
            r.deadline = self.step_count
            self._log_fault(F.DEADLINE_STORM, rid=r.rid, deferred=True)
        return r.rid

    def cancel(self, rid: int) -> bool:
        """Client-initiated abort. True when the request was live (now
        CANCELLED, slot and pages released); False when it was already
        terminal. Unknown rids raise KeyError."""
        r = self._requests[rid]
        if r.status in TERMINAL_STATES:
            return False
        slot = r.slot
        self.sched.cancel(r, self.step_count)
        if slot >= 0:
            self._clear_slot(slot)
        self.results[rid] = np.asarray(r.out, np.int32)
        return True

    def _shed_for(self, newcomer_deadline: Optional[int]) -> None:
        """Bounded-queue policy: shed the queued request with the SLACKEST
        deadline if the newcomer is strictly more urgent, else reject the
        newcomer (``QueueFullError``)."""
        inf = float("inf")
        nd = inf if newcomer_deadline is None else newcomer_deadline
        victim = max(self.sched.queue,
                     key=lambda r: (inf if r.deadline < 0 else r.deadline,
                                    r.rid))
        vd = inf if victim.deadline < 0 else victim.deadline
        if nd >= vd:
            raise QueueFullError(
                f"queue at max_queue={self.psv.max_queue} and no queued "
                f"request is slacker than the newcomer (deadline "
                f"{newcomer_deadline})")
        self.sched.expire(victim, self.step_count, error=LoadShedError(
            f"rid={victim.rid} (deadline {victim.deadline}) shed for a "
            f"more urgent arrival (deadline {newcomer_deadline})"))
        self.results[victim.rid] = np.asarray(victim.out, np.int32)

    # -- fault containment ---------------------------------------------
    def _clear_slot(self, slot: int) -> None:
        tok, pos, bt, lo = self._arrays(self._cohort_of_slot(slot))
        bt[slot - lo] = PG.GARBAGE_PAGE
        tok[slot - lo] = 0
        pos[slot - lo] = 0

    def _scrub_slot(self, r: Request, private: List[int]) -> None:
        """Zero a failing request's private pages (and its slot's state
        rows) in its cohort's tree, and in the draft tree, which scattered
        the same request's kv into the same page ids."""
        cohort = self._cohort_of_slot(r.slot)
        lo = self._arrays(cohort)[3]
        ids = np.full((self.psv.pages_per_slot,), PG.GARBAGE_PAGE, np.int32)
        ids[:len(private)] = private
        ids = self._to_device(ids)[0]
        trees = [cohort]
        if self.spec_k and cohort == COHORT_MAIN:
            trees.append(SP.COHORT_SPEC_DRAFT)
        for c in trees:
            self._scrub_fn(c)(self._get_caches(c), ids, r.slot - lo)

    def _fail(self, r: Request, error, *, scrub: bool) -> None:
        """Contain a per-request fault: FAILED, slot row cleared, pages
        released this step. ``scrub``: the request may have written
        non-finite values into its pages — zero its PRIVATE pages before
        they return to the free list, and purge its own radix donations."""
        slot = r.slot
        if slot >= 0 and scrub:
            private = r.pages[r.n_shared:]
            if private:
                self._scrub_slot(r, private)
        donated = list(r.donated_pages)
        self.sched.fail(r, self.step_count, error)
        if slot >= 0:
            self._clear_slot(slot)
        if scrub and donated and self.prefix is not None:
            self.prefix.purge_pages(donated, self.pool)
        self.results[r.rid] = np.asarray(r.out, np.int32)

    def _expire_pass(self) -> None:
        """Deadlines are honored at step boundaries: any live request whose
        deadline has passed is EXPIRED and releases everything now."""
        sc = self.step_count
        for r in [x for x in list(self.sched.queue)
                  if 0 <= x.deadline <= sc]:
            self.sched.expire(r, sc)
            self.results[r.rid] = np.asarray(r.out, np.int32)
        for r in [x for x in list(self.sched.running.values())
                  if 0 <= x.deadline <= sc]:
            slot = r.slot
            self.sched.expire(r, sc)
            self._clear_slot(slot)
            self.results[r.rid] = np.asarray(r.out, np.int32)

    def _validate_block_tables(self) -> None:
        """Pre-launch guard: every running slot's block-table row must be
        exactly its request's pages followed by garbage padding; a mismatch
        fails that request before the decode reads a page it does not own."""
        for slot, r in sorted(self.sched.running.items()):
            _, _, bt, lo = self._arrays(self._cohort_of_slot(slot))
            expect = np.full((self.psv.pages_per_slot,), PG.GARBAGE_PAGE,
                             np.int32)
            expect[:len(r.pages)] = r.pages
            if not np.array_equal(bt[slot - lo], expect):
                self._fail(r, BlockTableCorruptionError(
                    f"rid={r.rid} slot {slot}: block-table row "
                    f"{bt[slot - lo].tolist()} != owned pages "
                    f"{r.pages}"), scrub=False)

    # -- chaos ----------------------------------------------------------
    def _log_fault(self, kind: str, *, rid: Optional[int] = None,
                   slot: Optional[int] = None, applied: bool = True,
                   deferred: bool = False) -> None:
        self.telemetry.fault(self.step_count, kind, rid=rid, slot=slot,
                             applied=applied, deferred=deferred)

    def _inject(self) -> None:
        """Apply this step's scheduled fault events. Victim selection is a
        pure function of the deterministic engine state, so a fixed (seed,
        workload) reproduces the same fault_log and results."""
        for ev in self._plan.at(self.step_count):
            if ev.kind == F.PAGE_ALLOC_FAIL:
                self.pool.fail_next_allocs(ev.payload)
                self._log_fault(ev.kind)
            elif ev.kind in (F.NAN_LOGITS, F.BLOCK_TABLE_CORRUPT):
                slots = sorted(self.sched.running)
                if not slots:
                    self._log_fault(ev.kind, applied=False)
                    continue
                slot = slots[ev.index % len(slots)]
                if ev.kind == F.NAN_LOGITS:
                    self._poison_slots.add(slot)
                else:
                    _, _, bt, lo = self._arrays(self._cohort_of_slot(slot))
                    col = ev.index % self.psv.pages_per_slot
                    bt[slot - lo, col] = (
                        int(bt[slot - lo, col]) + ev.payload
                    ) % self.psv.n_pages
                self._log_fault(ev.kind, rid=self.sched.running[slot].rid,
                                slot=slot)
            elif ev.kind == F.POISON_PROMPT:
                queued = list(self.sched.queue)
                if not queued:
                    self._poison_next += 1
                    self._log_fault(ev.kind, applied=False, deferred=True)
                    continue
                r = queued[ev.index % len(queued)]
                r.prompt = r.prompt.copy()
                r.prompt[ev.index % r.prompt_len] = \
                    self.ms.cfg.vocab_size + ev.payload
                self._log_fault(ev.kind, rid=r.rid)
            elif ev.kind == F.DEADLINE_STORM:
                queued = list(self.sched.queue)[:ev.payload]
                if not queued:
                    self._storm_next += ev.payload
                    self._log_fault(ev.kind, applied=False, deferred=True)
                    continue
                for r in queued:
                    r.deadline = self.step_count
                    self._log_fault(ev.kind, rid=r.rid)

    # -- per-request device work ----------------------------------------
    def _run_prefill(self, r: Request, ctx: int) -> Tuple[int, bool]:
        """Exact-shape prefill of the unmatched prompt suffix (the full
        prompt when ctx == 0) in the request's cohort. Returns (first
        token, finite-guard flag)."""
        ps = self.psv.page_size
        Lp = r.prompt_len
        n_pg_prompt = -(-Lp // ps)
        cohort = r.cohort
        params, caches = self._model(cohort)[0], self._get_caches(cohort)
        if ctx == 0:
            prompt, ids = self._to_device(r.prompt[None],
                                          np.asarray(r.pages[:n_pg_prompt]))
            tok0, ok, _ = self._prefill_fn(Lp, cohort)(
                params, caches, prompt, ids, r.slot - self._arrays(cohort)[3],
                self.generator)
            self.counters["prefill_tokens"] += Lp
            self.counters["full_prefills"] += 1
        else:
            m = ctx // ps
            suffix, ctx_ids, sfx_ids = self._to_device(
                r.prompt[None, ctx:], np.asarray(r.pages[:m]),
                np.asarray(r.pages[m:n_pg_prompt]))
            tok0, ok, _ = self._suffix_fn(m, Lp - ctx)(
                params, caches, suffix, ctx_ids, sfx_ids, self.generator)
            self.counters["prefill_tokens"] += Lp - ctx
            self.counters["suffix_prefills"] += 1
        tok0, ok = self._to_host(tok0, ok)
        return int(tok0[0]), bool(ok[0])

    def _replay(self, r: Request, start: int) -> bool:
        """Resume catch-up: teacher-force the parked generated tokens whose
        kv fell outside the surviving radix prefix through the cohort's
        REGULAR decode program (all other slots masked to the garbage page,
        their rows ignored). With greedy sampling and an fp32 pool the
        replayed prediction must reproduce the parked token, which the
        engine asserts. Returns False if the finite guard trips mid-replay.

        Recurrent state (Mamba conv/h) needs protection: the masked slots'
        attention writes land on the garbage page, but the decode advances
        EVERY slot's state. The state entries are snapshot before the
        replay and every row but the replaying slot's is restored after it
        (their timeline has no step here)."""
        Lp = r.prompt_len
        end = Lp + len(r.out) - 1      # exclusive; kv for end-1 is the
        if start >= end:               # resumed decode step's own write
            return True
        self.telemetry.span_event(r.rid, REPLAY, self.step_count,
                                  tokens=end - start)
        caches = self._get_caches(r.cohort)
        loc = r.slot - self._arrays(r.cohort)[3]
        saved = [{name: e.clone() for name, e in seg.items()
                  if not PG.is_paged_entry(name)} for seg in caches]
        survived = self._replay_steps(r, start, end)
        for seg, snap in zip(caches, saved):
            for name, old in snap.items():
                ba = T.cache_batch_axis(name)
                keep = torch.tensor([loc], device=old.device)
                old.index_copy_(ba, keep, seg[name].index_select(ba, keep))
                seg[name].copy_(old)
        return survived

    def _teacher_force(self, decode, params, caches, r: Request, p: int):
        """One decode launch feeding ``r``'s token at position ``p`` on its
        slot, every other slot masked to the garbage page. Returns the
        launch's (tokens, finite flags) on the device."""
        tok_a, _, bt_a, lo = self._arrays(r.cohort)
        size, loc = tok_a.shape[0], r.slot - lo
        tok_v = np.zeros((size,), np.int32)
        pos_v = np.zeros((size,), np.int32)
        bt = np.full_like(bt_a, PG.GARBAGE_PAGE)
        tok_v[loc] = r.out[p - r.prompt_len]
        pos_v[loc] = p
        bt[loc] = bt_a[loc]
        args = self._to_device(tok_v, pos_v, bt, np.zeros((size,), np.int32))
        nxt, ok, _ = decode(params, caches, *args[:3], args[3].bool(),
                            self.generator)
        return nxt, ok

    def _replay_steps(self, r: Request, start: int, end: int) -> bool:
        """Teacher-force positions [start, end) of ``r`` through its
        cohort's decode program; False when the finite guard trips."""
        decode = self._decode_fn(r.cohort)
        params, caches = self._model(r.cohort)[0], self._get_caches(r.cohort)
        loc = r.slot - self._arrays(r.cohort)[3]
        Lp = r.prompt_len
        for p in range(start, end):
            nxt, ok = self._to_host(*self._teacher_force(decode, params,
                                                         caches, r, p))
            if not ok[loc]:
                return False
            if self._exact:
                assert int(nxt[loc]) == r.out[p - Lp + 1], (
                    f"replay divergence at pos {p}: {int(nxt[loc])} != "
                    f"{r.out[p - Lp + 1]} (rid={r.rid})")
            self.counters["replay_tokens"] += 1
        return True

    def _spec_prime(self, r: Request) -> None:
        """Warm the DRAFT tree for a freshly started main-cohort request: a
        full-prompt prefill at the aggressive plan (unless a bucketed
        draft-mirror launch already primed it), then teacher-forced
        catch-up over any parked generated tokens (the resume path).

        Always the FULL prompt, even on a radix hit: draft kv has no radix
        representation (its bits are plan-specific), and re-deriving it
        over shared pages writes the same bits the draft tree already
        holds there. Quality-only work: the verify reads the MAIN tree, so
        nothing here can move committed output, and its finite guards are
        ignored for the same reason. No state snapshots: speculation is
        attention-only."""
        Lp = r.prompt_len
        if r.rid in self._spec_primed:
            self._spec_primed.discard(r.rid)
        else:
            prompt, ids = self._to_device(
                r.prompt[None],
                np.asarray(r.pages[:-(-Lp // self.psv.page_size)]))
            self._spec_prefill_fn(Lp)(self.params_draft, self.caches_draft,
                                      prompt, ids, r.slot, self.generator)
        for p in range(Lp, Lp + len(r.out) - 1):
            self._teacher_force(self._draft_decode_fn(), self.params_draft,
                                self.caches_draft, r, p)

    def _start(self, r: Request,
               pre: Optional[Tuple[int, bool]] = None) -> bool:
        """Bring an admitted request onto its slot: link its block table,
        consume the bucketed-prefill result planned for it (``pre``) or run
        the exact-shape prefill itself (full / suffix / skipped when the
        radix hit covers the whole prompt), for resumed requests replay
        the parked positions, and under speculation prime the draft tree.
        Returns False when a fault guard FAILED the request (slot and pages
        already released)."""
        ps = self.psv.page_size
        ctx = r.n_shared * ps
        Lp = r.prompt_len
        resumed = bool(r.out)
        tok_a, pos_a, bt_a, lo = self._arrays(r.cohort)
        row = bt_a[r.slot - lo]
        row[:] = PG.GARBAGE_PAGE
        row[:len(r.pages)] = r.pages
        # hit_tokens counts PROMPT tokens served from shared pages on fresh
        # admissions; a resume re-linking its own donation is tracked under
        # resume_hit_tokens.
        if resumed:
            self.counters["resume_hit_tokens"] += ctx
        else:
            self.counters["hit_tokens"] += ctx
            if ctx:
                self.counters["prefix_hits"] += 1
        if ctx < Lp:
            self.telemetry.span_event(
                r.rid, PREFILL, self.step_count,
                kind="full" if ctx == 0 else "suffix",
                hit_tokens=ctx, tokens=Lp - ctx, batched=pre is not None)
            if pre is not None:
                tok0, ok = pre
                self.counters["prefill_tokens"] += Lp - ctx
                self.counters["suffix_prefills" if ctx
                              else "full_prefills"] += 1
                self.counters["bucket_prefills"] += 1
            else:
                tok0, ok = self._run_prefill(r, ctx)
            if not ok:
                # The prefill may have scattered non-finite kv into the
                # request's pages before the guard was read — scrub.
                self._fail(r, NonFiniteLogitsError(
                    f"rid={r.rid}: non-finite logits/cache in prefill"),
                    scrub=True)
                return False
            if not resumed:
                r.out.append(tok0)
                self.telemetry.first_token(r.rid, self.step_count)
            elif self._exact:
                # Same inputs as the original prefill: the re-sampled first
                # token must reproduce the parked one.
                assert tok0 == r.out[0], (tok0, r.out[0], r.rid)
        # Early donation: the prompt pages are complete now, so same-prefix
        # requests admitted from the NEXT step on can share them (a no-op
        # for the degraded cohort: its pages hold aggressive-plan bits).
        self.sched.donate_prefilled(r, self.step_count)
        if resumed and not self._replay(r, max(Lp, ctx)):
            self._fail(r, NonFiniteLogitsError(
                f"rid={r.rid}: non-finite logits during decode replay"),
                scrub=True)
            return False
        if self.spec_k:
            self._spec_prime(r)
        tok_a[r.slot - lo] = r.out[-1]
        pos_a[r.slot - lo] = r.pos
        return True

    def _finish(self, r: Request) -> None:
        slot = r.slot
        self.sched.finish(r, self.step_count)
        self._clear_slot(slot)
        self.results[r.rid] = np.asarray(r.out, np.int32)

    def _plan_prefills(self, admitted: List[Request]
                       ) -> Dict[int, Tuple[int, bool]]:
        """Pass 1 of admission: vocab-guard every admitted request, then
        pack the bucket-eligible prefills into (cohort, bucket) groups and
        launch each group ONCE. Returns rid -> (first token, finite-ok) for
        every request whose prefill ran batched; ``_start`` consumes those.
        Eligible: the ladder is on, suffix tokens remain (a full-prompt
        radix cover skips prefill), and a rung holds the SUFFIX length."""
        pre: Dict[int, Tuple[int, bool]] = {}
        ps = self.psv.page_size
        vocab = self.ms.cfg.vocab_size
        groups: Dict[Tuple[str, int], List[Request]] = {}
        for r in admitted:
            # Device-boundary prompt guard: the prompt may have been
            # corrupted since submit; an out-of-vocab id would index the
            # embedding out of range — fail the request, not the engine.
            if (r.prompt < 0).any() or (r.prompt >= vocab).any():
                self._fail(r, PoisonedPromptError(
                    f"rid={r.rid}: prompt token ids outside [0, {vocab}) "
                    f"at admission (min={int(r.prompt.min())}, "
                    f"max={int(r.prompt.max())})"), scrub=False)
                continue
            if not self._buckets:
                continue
            Ls = r.prompt_len - r.n_shared * ps
            if Ls <= 0:
                continue   # radix cover reaches the prompt: replay only
            b = BK.bucket_for(Ls, self._buckets)
            if b is not None:
                groups.setdefault((r.cohort, b), []).append(r)
        for (cohort, b), grp in sorted(groups.items()):
            pre.update(self._launch_bucket(cohort, b, grp))
        return pre

    def _launch_bucket(self, cohort: str, bucket: int, grp: List[Request]
                       ) -> Dict[int, Tuple[int, bool]]:
        """One bucket group of a cohort: right-pad each row's SUFFIX (the
        full prompt when cold) to ``bucket``, launch chunks of the
        program's fixed row count (short chunks pad with inert rows: zero
        prompts, all-garbage page ids), and take each row's token at its
        true length. Under the ctx-aware program radix-hit rows also carry
        their matched pages (garbage-padded to the uniform width) and ctx
        length.

        Under speculation the main cohort's group also runs through the
        draft-plan program (the draft mirror), which warms the draft tree;
        its outputs are ignored and ``_spec_prime`` skips the full-prompt
        draft prefill of rows primed here. Radix-hit rows are inert in the
        mirror and not marked primed: the draft tree needs the full prompt,
        so ``_spec_prime`` prefills it for them."""
        ps = self.psv.page_size
        rows = BK.rows_for_bucket(bucket, len(self._arrays(cohort)[0]),
                                  self.psv.prefill_token_budget)
        ctx_pages = self._bucket_ctx_pages(cohort)
        fn = self._bucket_prefill_fn(bucket, rows, cohort)
        draft_fn = (self._bucket_prefill_fn(bucket, rows,
                                            SP.COHORT_SPEC_DRAFT)
                    if self.spec_k and cohort == COHORT_MAIN else None)
        params, caches = self._model(cohort)[0], self._get_caches(cohort)
        n_pg = bucket // ps
        out: Dict[int, Tuple[int, bool]] = {}
        for i0 in range(0, len(grp), rows):
            chunk = grp[i0:i0 + rows]
            prompts = np.zeros((rows, bucket), np.int32)
            true_lens = np.ones((rows,), np.int32)
            page_ids = np.full((rows, n_pg), PG.GARBAGE_PAGE, np.int32)
            ctx_ids = np.full((rows, ctx_pages), PG.GARBAGE_PAGE, np.int32)
            ctx_lens = np.zeros((rows,), np.int32)
            for i, r in enumerate(chunk):
                m = r.n_shared
                Ls = r.prompt_len - m * ps
                prompts[i, :Ls] = r.prompt[m * ps:]
                true_lens[i] = Ls
                npg = -(-r.prompt_len // ps)
                page_ids[i, :npg - m] = r.pages[m:npg]
                if m:
                    ctx_ids[i, :m] = r.pages[:m]
                    ctx_lens[i] = m * ps
            if draft_fn is not None:
                hit = ctx_lens > 0
                d_args = self._to_device(
                    np.where(hit[:, None], 0, prompts),
                    np.where(hit, 1, true_lens),
                    np.where(hit[:, None], PG.GARBAGE_PAGE, page_ids))
                draft_fn(self.params_draft, self.caches_draft, *d_args,
                         self.generator)
            args = self._to_device(prompts, true_lens, page_ids,
                                   *((ctx_ids, ctx_lens) if ctx_pages else ()))
            tok0, ok, _ = fn(params, caches, *args, self.generator)
            tok0, ok = self._to_host(tok0, ok)
            for i, r in enumerate(chunk):
                out[r.rid] = (int(tok0[i]), bool(ok[i]))
                if draft_fn is not None and not r.n_shared:
                    self._spec_primed.add(r.rid)
            self.counters["bucket_groups"] += 1
            self.counters["pad_tokens"] += rows * bucket - sum(
                r.prompt_len - r.n_shared * ps for r in chunk)
        return out

    def _admit(self, *, count_blocked: bool) -> None:
        # The SLO-pressure signal: a backlog at least degrade_queue_depth
        # deep lets an unpinned head overflow into the degraded cohort.
        degrade = (self.psv.degrade_delta
                   and self.sched.n_queued >= self.psv.degrade_queue_depth)
        admitted = self.sched.admit(self.step_count,
                                    count_blocked=count_blocked,
                                    degrade=degrade)
        pre = self._plan_prefills(admitted)
        for r in admitted:
            if r.status in TERMINAL_STATES:
                continue          # failed by the pass-1 vocab guard
            if r.cohort == COHORT_DEGRADED and not r.preemptions:
                self.counters["degraded_admissions"] += 1
            if not self._start(r, pre.get(r.rid)):
                continue
            # "admitted" counts requests that SURVIVED admission.
            self.counters["admitted"] += 1
            if r.done():      # max_new == 1 (or instant EOS) on prefill
                self._finish(r)
            else:
                self.telemetry.span_event(r.rid, DECODE, self.step_count)

    def _running(self, cohort: str) -> Dict[int, Request]:
        """slot -> request of the cohort's running slots."""
        return {s: r for s, r in self.sched.running.items()
                if self._cohort_of_slot(s) == cohort}

    def _poison(self, cohort: str) -> np.ndarray:
        """[cohort size] int32: the slots NaN-poisoned this step."""
        tok, _, _, lo = self._arrays(cohort)
        poison = np.zeros(tok.shape, np.int32)
        for s in self._poison_slots:
            if self._cohort_of_slot(s) == cohort:
                poison[s - lo] = 1
        return poison

    def _decode_cohort(self, cohort: str) -> None:
        """ONE decode launch over every slot of a cohort; running rows take
        their next token, idle rows are ignored."""
        running = self._running(cohort)
        if not running:
            return
        tok_a, pos_a, bt_a, lo = self._arrays(cohort)
        tok, pos, bt, poison = self._to_device(tok_a, pos_a, bt_a,
                                               self._poison(cohort))
        prof = (torch.profiler.record_function(f"paged_decode_{cohort}")
                if self.psv.profile_decode else contextlib.nullcontext())
        with prof:
            nxt, ok, _ = self._decode_fn(cohort)(
                self._model(cohort)[0], self._get_caches(cohort), tok, pos,
                bt, poison.bool(), self.generator)
        nxt, ok = self._to_host(nxt, ok)
        for slot, r in sorted(running.items()):
            loc = slot - lo
            if not ok[loc]:
                # Non-finite logits on this row only: scrub its private
                # pages on the way out; other rows are untouched.
                self._fail(r, NonFiniteLogitsError(
                    f"rid={r.rid}: non-finite logits in decode at step "
                    f"{self.step_count} (slot {slot})"), scrub=True)
                continue
            r.out.append(int(nxt[loc]))
            tok_a[loc] = nxt[loc]
            pos_a[loc] += 1
            self.counters["decoded"] += 1
            if r.done():
                self._finish(r)

    def _rewind_pages(self, pairs: List[Tuple[int, int]]) -> None:
        """Un-write rejected speculative positions in BOTH trees. Fixed
        shape: at most ``n_main * spec_k`` positions can reject per step,
        padded with ``(GARBAGE_PAGE, 0)`` (``paged_cache.rewind_tokens``)."""
        cap = self.n_main * self.spec_k
        assert len(pairs) <= cap, (len(pairs), cap)
        pages = np.zeros((cap,), np.int32)
        offs = np.zeros((cap,), np.int32)
        for i, (p, o) in enumerate(pairs):
            pages[i], offs[i] = p, o
        rewind = self._programs.get(SP.COHORT_SPEC_VERIFY, "rewind", cap,
                                    lambda: PG.rewind_tokens)
        pg, of = self._to_device(pages, offs)
        rewind(self.caches, pg, of)
        rewind(self.caches_draft, pg, of)

    def _decode_spec(self) -> None:
        """Speculative main-cohort step: ONE device episode (``spec_k``
        draft steps at the aggressive plan, the probe-row packing and ONE
        full-depth verify at batch ``n_main * (spec_k + 1)``), host-side
        acceptance, then an un-write of every rejected position
        (``serve.speculative`` has the math and the soundness argument).
        Replaces ``_decode_cohort(COHORT_MAIN)`` when spec_k > 0; greedy
        streams equal it because every committed token is a full-depth
        argmax over an exactly-committed history."""
        running = self._running(COHORT_MAIN)
        if not running:
            return
        tok_a, pos_a, bt_a, lo = self._arrays(COHORT_MAIN)
        size, k = tok_a.shape[0], self.spec_k
        remaining = np.full((size,), -1, np.int32)
        for s, r in running.items():
            remaining[s - lo] = r.max_new - len(r.out)
        tok, pos, bt, poison, rem = self._to_device(
            tok_a, pos_a, bt_a, self._poison(COHORT_MAIN), remaining)
        prof = (torch.profiler.record_function("paged_decode_spec_step")
                if self.psv.profile_decode else contextlib.nullcontext())
        with prof:
            d, yhat, ok = self._spec_step(
                self.params_draft, self.params, self.caches_draft,
                self.caches, tok, pos, bt, poison.bool(), rem)
        drafts, yhat, okm = self._to_host(d, yhat.reshape(size, k + 1),
                                          ok.reshape(size, k + 1))
        self.counters["draft_steps"] += k
        self.counters["verify_steps"] += 1
        zero_pairs: List[Tuple[int, int]] = []
        for slot, r in sorted(running.items()):
            loc = slot - lo
            rem = int(remaining[loc])
            j_hi = min(k, rem)
            if not okm[loc, :j_hi + 1].all():
                # Any live probe row non-finite fails the slot (a poisoned
                # slot emits no token); peers are untouched by row
                # independence. The scrub covers the draft tree too.
                self._fail(r, NonFiniteLogitsError(
                    f"rid={r.rid}: non-finite logits in speculative "
                    f"verify at step {self.step_count} (slot {slot})"),
                    scrub=True)
                continue
            p0 = int(pos_a[loc])
            a_max = min(k, rem - 1)
            a = SP.accept_length(drafts[:, loc], yhat[loc], a_max)
            self.counters["spec_accepted"] += a
            self.counters["spec_rejected"] += a_max - a
            committed = 0
            for t in SP.commit_tokens(drafts[:, loc], yhat[loc], a):
                r.out.append(t)
                committed += 1
                self.counters["decoded"] += 1
                if r.done():     # EOS can cut inside the accepted run
                    break
            self.telemetry.observe("spec_accept", committed)
            self.telemetry.spec_episode(self.step_count, slot, r.rid,
                                        probed=a_max, accepted=a,
                                        committed=committed)
            if r.done():
                self._finish(r)
                continue
            tok_a[loc] = r.out[-1]
            pos_a[loc] = r.pos
            start, stop = SP.stale_span(p0, a, j_hi)
            if start < stop:
                zero_pairs += PG.rewind_plan(
                    r.pages, r.n_shared, start, stop,
                    self.psv.page_size)[0]
        if zero_pairs:
            self._rewind_pages(zero_pairs)
            self.counters["spec_rewound"] += len(zero_pairs)

    def _step_gauges(self, hit0: int, faults0: Dict[str, int]) -> None:
        """Per-step gauge samples, taken after the step's work: queue
        depth, pool live/free/shared pages, per-step radix hit tokens,
        per-cohort slot occupancy, and faults by kind. Host reads only."""
        tel, sc = self.telemetry, self.step_count
        tel.gauge("queue_depth", sc, self.sched.n_queued)
        tel.gauge("pages_live", sc, self.pool.live)
        tel.gauge("pages_free", sc, self.pool.n_free)
        tel.gauge("pages_shared", sc, self.pool.shared)
        tel.gauge("hit_tokens_step", sc,
                  tel.counters["hit_tokens"]
                  + tel.counters["resume_hit_tokens"] - hit0)
        n_run_main = sum(1 for s in self.sched.running if s < self.n_main)
        tel.gauge(f"slots_live/{COHORT_MAIN}", sc, n_run_main)
        if self.n_deg:
            tel.gauge(f"slots_live/{COHORT_DEGRADED}", sc,
                      self.sched.n_running - n_run_main)
        for kind, n in tel.fault_counts.items():
            d = n - faults0.get(kind, 0)
            if d:
                tel.gauge(f"faults/{kind}", sc, d)

    @torch.no_grad()
    def step(self) -> Dict[str, int]:
        """One engine iteration: chaos injection (when armed) -> deadline
        expiry -> admission + prefill (with blocked-head preemption when
        enabled) -> block-table validation -> one decode launch per active
        cohort (a speculative episode for the main cohort when spec_k > 0).
        Returns the step's lifecycle event counts (telemetry counter
        deltas)."""
        tel = self.telemetry
        before = {k: tel.counters[k] for k in self.STEP_STAT_KEYS}
        hit0 = tel.counters["hit_tokens"] + tel.counters["resume_hit_tokens"]
        faults0 = dict(tel.fault_counts)
        if self._plan is not None:
            self._inject()
        self._expire_pass()
        self._admit(count_blocked=True)
        if self.sched.should_preempt():
            _victim, slot = self.sched.preempt_youngest(self.step_count)
            self._clear_slot(slot)
            # The freed pages/slot may unblock the head immediately.
            self._admit(count_blocked=False)
        self._validate_block_tables()
        if self.spec_k:
            self._decode_spec()
        else:
            self._decode_cohort(COHORT_MAIN)
        if self.n_deg:
            self._decode_cohort(COHORT_DEGRADED)
        self._poison_slots.clear()
        self.pool.check_balance()
        if self.prefix is not None:
            self.prefix.check_locks()
        self._step_gauges(hit0, faults0)
        tel.mark_step(self.step_count)
        self.step_count += 1
        stats = {k: tel.counters[k] - before[k] for k in self.STEP_STAT_KEYS}
        stats["live_pages"] = self.pool.live
        return stats

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until every submitted request reached a TERMINAL state;
        returns {rid: generated tokens} for every rid (FAILED/CANCELLED/
        EXPIRED ones hold their partial output; ``request(rid).state`` and
        ``.error`` say why)."""
        while self.sched.n_queued or self.sched.n_running:
            self.step()
        return dict(self.results)

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable cache pages currently live."""
        return self.pool.live / max(self.psv.n_pages - 1, 1)

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    # -- telemetry exporters -------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-able metrics snapshot: counters, gauges, histograms,
        compile events, fault counts, request-state census, span-derived
        latency, prefix hit rate, pool accounting, occupancy and, under
        speculation, the ``spec`` section. Everything outside ``wall*``
        keys is a pure function of the step-denominated event stream."""
        snap = self.telemetry.snapshot(step=self.step_count)
        snap["pool"] = {
            "allocated_total": self.pool.allocated_total,
            "freed_total": self.pool.freed_total,
            "shared_total": self.pool.shared_total,
            "alloc_faults": self.pool.alloc_faults,
            "live": self.pool.live,
        }
        cap = max(self.psv.n_pages - 1, 1)
        series = self.telemetry.gauge_series.get("pages_live", [])
        if series:
            vals = [v for _, v in series]
            snap["occupancy"] = {
                "mean": round(sum(vals) / len(vals) / cap, 3),
                "max": round(max(vals) / cap, 3),
            }
        snap["preemptions"] = self.sched.preemptions_total
        if self.spec_k:
            c = self.telemetry.counters
            probed = c["spec_accepted"] + c["spec_rejected"]
            # One histogram observation per slot per verify = one episode;
            # its mean is committed tokens per full-depth verification of a
            # slot (> 1: each full-depth pass commits more than one token).
            h = self.telemetry.hists.get("spec_accept")
            snap["spec"] = {
                "k": self.spec_k,
                "draft_eff_depth": self.ms_draft.effective_depth,
                "accept_per_verify": round(h.sum / h.count, 3)
                                     if h and h.count else 0.0,
                "accept_rate": round(c["spec_accepted"] / probed, 3)
                               if probed else 0.0,
            }
        return snap

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of the scalar channels."""
        return self.telemetry.prom_text()

    def dump_trace(self, path: str) -> str:
        """Write the Chrome/Perfetto ``trace_event`` JSON of this run
        (``serve.trace``). Needs spans and gauge series, so the engine must
        run with ``telemetry=True`` (the default)."""
        return write_trace(self.telemetry, path, n_slots=self.psv.n_slots)
