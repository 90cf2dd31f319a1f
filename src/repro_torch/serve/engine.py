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

Recurrent mixers (Mamba): the state lives per decode slot beside the
pages (``serve.paged_cache``), so there is nothing to share or to pad. The
prefix cache and the bucket ladder switch off for such a model (as in the
JAX engine): every admission prefills its exact prompt in its own launch,
and a preempted request resumes by a full re-prefill and a replay that
leaves every other slot's state as it was.

This is the JAX engine's main cohort at world size 1, for attention + MLP
models and Mamba models: the degraded cohort and speculative decoding
(ROADMAP item 9) and tensor parallelism (item 10) raise
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.model import embedding as E
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import bucketing as BK
from repro_torch.serve import faults as F
from repro_torch.serve import paged_cache as PG
from repro_torch.serve.faults import (BlockTableCorruptionError,
                                      InvalidRequestError, LoadShedError,
                                      NonFiniteLogitsError,
                                      PoisonedPromptError, QueueFullError)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import (COHORT_MAIN, TERMINAL_STATES,
                                         PagePool, Request, Scheduler)
from repro_torch.serve.telemetry import (DECODE, PREFILL, REPLAY,
                                         ProgramCache, Telemetry)


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024           # KV-cache length
    temperature: float = 0.0      # 0 -> greedy
    cache_dtype: Any = torch.bfloat16
    # Pinned-tile prefill attention (serve.bucketing): every prefill
    # consumer runs the same impl.
    attn_impl: str = BK.PREFILL_ATTN_IMPL


def make_prefill(ms: T.ModelStructure, pc: ParallelContext, sv: ServeConfig):
    def prefill_fn(params, tokens):
        return T.prefill(params, tokens, ms=ms, pc=pc, max_len=sv.max_len,
                         attn_impl=sv.attn_impl, cache_dtype=sv.cache_dtype)
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
        logits, caches = T.decode_step(params, tok, caches, t, ms=ms, pc=pc)
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
             timings: Optional[Dict[str, float]] = None):
    """Greedy/temperature generation: returns [B, n_new] new tokens.

    ``prompts`` [B, S] must lie on the weights' device. Sampling
    (``sv.temperature > 0``) draws from ``generator``, which must live on
    that device too. A ``timings`` dict receives ``prefill_s`` (prefill and
    the first token's choice) and ``decode_s`` (the ``n_new - 1`` decode
    steps) of this call, in seconds; each mark waits for the device."""
    params = as_tree(params)
    dev = params["embed"]["tok"].device
    if prompts.device != dev:
        raise ValueError(f"prompts on {prompts.device}, weights on {dev}")
    t0 = prompts.shape[1]
    if t0 + n_new - 1 > sv.max_len:
        raise ValueError(f"prompt {t0} + {n_new} new tokens overflow the "
                         f"cache (max_len={sv.max_len})")
    if sv.temperature > 0 and generator is None:
        raise ValueError("sampling needs a torch.Generator")
    prefill_fn = make_prefill(ms, pc, sv)
    step_fn = make_serve_step(ms, pc, sv)
    marks = [_now(dev)] if timings is not None else None
    logits, caches = prefill_fn(params, prompts)
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


# ---------------------------------------------------------------------------
# Continuous batching over the paged pair-KV pool
# ---------------------------------------------------------------------------

def _rows_finite(logits, seq) -> torch.Tensor:
    """[rows] bool: each row's logits and emitted cache are all finite."""
    ok = torch.isfinite(logits).all(-1)
    for seg in seq:
        for name, c in seg.items():
            c = c.movedim(T.cache_batch_axis(name), 0)
            ok = ok & torch.isfinite(c).reshape(c.shape[0], -1).all(-1)
    return ok


def make_paged_decode_fn(ms: T.ModelStructure, pc: ParallelContext, psv):
    """Paged decode step: (params, caches, tok [n_slots], pos [n_slots],
    block_tables [n_slots, n_pg], poison [n_slots] bool, generator) ->
    (next_tok [n_slots], ok [n_slots] bool, caches); the pool is updated in
    place.

    ``ok[slot]`` is the per-row finite guard: False when the slot's logits
    hold NaN/inf. ``poison`` is the deterministic-chaos hook: True rows get
    their logits overwritten with NaN BEFORE the guard; an all-False mask
    is a bitwise no-op (``where`` with a false predicate returns the
    original lanes)."""
    def f(params, caches, tok, pos, bt, poison, generator=None):
        logits, caches = T.decode_step(params, tok, caches, pos, ms=ms, pc=pc,
                                       cache_layout="paged", block_tables=bt)
        logits = torch.where(poison[:, None], torch.nan, logits)
        ok = torch.isfinite(logits).all(-1)
        return _choose(logits, generator, psv, pc), ok, caches
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
        ok = _rows_finite(last, seq)
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
        ok = _rows_finite(last, seq)
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
        ok = _rows_finite(last, seq)
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
    """Overload degradation: the aggressive-Δ slot cohort (not ported)."""
    enabled: bool = False
    slots: int = 0
    queue_depth: int = 1
    eff_depth: int = 0


@dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding (not ported)."""
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
    degrade_delta and spec_k are the JAX engine's degraded cohort and
    speculative decoding, not ported (the engine raises).
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

    def validate(self) -> None:
        """Every cross-field configuration rule, as actionable
        ValueErrors."""
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
    fixed-shape decode launch over the slots. Finished requests release
    their slot and pages the same step; FAILED/CANCELLED/EXPIRED requests
    release within the step that terminates them.

    Greedy outputs per request equal one-shot ``generate(params,
    prompt[None], max_new)`` with this engine's ``max_len``: every
    cross-request interaction is row-independent, which is also why
    failing one slot leaves the survivors' streams untouched. The engine
    runs on the weights' device: the card, or the CPU when the caller put
    the weights there (kernels' plain versions).

    ``fault_plan``: a ``serve.faults.FaultPlan``; each step applies that
    step's events through the same hooks real faults take, and
    ``fault_log`` records what fired.
    """

    #: Every monotone engine counter, pre-registered at 0. Per-step
    #: ``step()`` stats are DELTAS of the lifecycle subset over the step.
    COUNTER_KEYS = (
        "prefill_tokens", "hit_tokens", "resume_hit_tokens",
        "replay_tokens", "full_prefills", "suffix_prefills", "prefix_hits",
        "bucket_prefills", "bucket_groups", "pad_tokens",
        "submitted", "admitted", "decoded", "finished", "preempted",
        "failed", "expired", "cancelled", "shed")
    #: The subset ``step()`` reports as per-step deltas.
    STEP_STAT_KEYS = ("admitted", "decoded", "finished", "preempted",
                      "failed", "expired")

    def __init__(self, params, ms: T.ModelStructure, psv: PagedServeConfig,
                 *, pc: Optional[ParallelContext] = None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 fault_plan: Optional[F.FaultPlan] = None):
        psv.validate()
        if psv.degrade_delta or psv.spec_k:
            raise NotImplementedError(
                "the degraded cohort (degrade_delta) and speculative decoding "
                "(spec_k) are not ported yet: ROADMAP item 9")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is not ported yet: ROADMAP "
                "item 10")
        PG.validate_paged_support(ms, psv.max_len)
        self.ms = ms
        self.psv = psv
        self.pc = pc if pc is not None else ParallelContext()
        self.params = as_tree(params)
        self.device = self.params["embed"]["tok"].device
        self.n_main = psv.n_slots
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
            telemetry=self.telemetry, prefill_buckets=self._buckets)
        self.caches = PG.init_paged_caches(
            ms, n_slots=self.n_main, n_pages=psv.n_pages,
            page_size=psv.page_size, dtype=psv.cache_dtype,
            device=self.device)
        self.block_tables = np.full((self.n_main, psv.pages_per_slot),
                                    PG.GARBAGE_PAGE, np.int32)
        self.tok = np.zeros((self.n_main,), np.int32)
        self.pos = np.zeros((self.n_main,), np.int32)
        if psv.temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.step_count = 0
        self.results: Dict[int, np.ndarray] = {}
        self._requests: Dict[int, Request] = {}
        self._decode = self._programs.get(
            COHORT_MAIN, "decode", self.n_main,
            lambda: make_paged_decode_fn(ms, self.pc, psv))
        # Greedy + fp32 pool => replay recomputation reproduces the
        # original run; the engine then self-checks the replay.
        self._exact = (psv.temperature == 0.0
                       and psv.cache_dtype == torch.float32)
        self._plan = fault_plan
        self._poison_slots: set = set()   # slots NaN-poisoned THIS step
        self._poison_next = 0             # deferred poison_prompt events
        self._storm_next = 0              # deferred deadline_storm victims

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
    def _to_host(tok, ok) -> Tuple[np.ndarray, np.ndarray]:
        """Tokens and finite flags -> host in ONE copy."""
        both = torch.stack([tok.to(torch.int32), ok.to(torch.int32)]).cpu()
        return both[0].numpy(), both[1].numpy().astype(bool)

    # -- programs ---------------------------------------------------------
    # The build callables record nothing: callers go through
    # ``self._programs.get``, which records a compile event exactly once
    # per key.
    def _prefill_fn(self, prompt_len: int):
        return self._programs.get(
            COHORT_MAIN, "prefill_full", prompt_len,
            lambda: make_paged_prefill_fn(self.ms, self.pc, self.psv,
                                          prompt_len))

    def _bucket_ctx_pages(self) -> int:
        """Ctx-page width of the bucket programs: prefix-on engines route
        EVERY bucket launch through the ctx-aware program (cold rows pass
        ctx_len 0), so hits and colds share one program. A radix match
        always leaves a >= 2-token suffix (``Scheduler._match_cap``), so
        ctx pages <= pages_per_slot - 1."""
        return self.psv.pages_per_slot - 1 if self.prefix is not None else 0

    def _bucket_prefill_fn(self, bucket: int, rows: int):
        ctx_pages = self._bucket_ctx_pages()
        return self._programs.get(
            COHORT_MAIN, "prefill_bucket", (bucket, rows),
            lambda: make_paged_bucket_prefill_fn(self.ms, self.pc, self.psv,
                                                 bucket, rows, ctx_pages))

    def _suffix_fn(self, n_ctx_pages: int, suffix_len: int):
        return self._programs.get(
            COHORT_MAIN, "prefill_suffix", (n_ctx_pages, suffix_len),
            lambda: make_paged_suffix_prefill_fn(self.ms, self.pc, self.psv,
                                                 n_ctx_pages, suffix_len))

    def _scrub_fn(self):
        return self._programs.get(COHORT_MAIN, "scrub",
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
        self.block_tables[slot] = PG.GARBAGE_PAGE
        self.tok[slot] = 0
        self.pos[slot] = 0

    def _fail(self, r: Request, error, *, scrub: bool) -> None:
        """Contain a per-request fault: FAILED, slot row cleared, pages
        released this step. ``scrub``: the request may have written
        non-finite values into its pages — zero its PRIVATE pages before
        they return to the free list, and purge its own radix donations."""
        slot = r.slot
        if slot >= 0 and scrub:
            private = r.pages[r.n_shared:]
            if private:
                ids = np.full((self.psv.pages_per_slot,), PG.GARBAGE_PAGE,
                              np.int32)
                ids[:len(private)] = private
                self._scrub_fn()(self.caches, self._to_device(ids)[0], slot)
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
            expect = np.full((self.psv.pages_per_slot,), PG.GARBAGE_PAGE,
                             np.int32)
            expect[:len(r.pages)] = r.pages
            if not np.array_equal(self.block_tables[slot], expect):
                self._fail(r, BlockTableCorruptionError(
                    f"rid={r.rid} slot {slot}: block-table row "
                    f"{self.block_tables[slot].tolist()} != owned pages "
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
                    col = ev.index % self.psv.pages_per_slot
                    self.block_tables[slot, col] = (
                        int(self.block_tables[slot, col]) + ev.payload
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
        prompt when ctx == 0). Returns (first token, finite-guard flag)."""
        ps = self.psv.page_size
        Lp = r.prompt_len
        n_pg_prompt = -(-Lp // ps)
        if ctx == 0:
            prompt, ids = self._to_device(r.prompt[None],
                                          np.asarray(r.pages[:n_pg_prompt]))
            tok0, ok, _ = self._prefill_fn(Lp)(
                self.params, self.caches, prompt, ids, r.slot, self.generator)
            self.counters["prefill_tokens"] += Lp
            self.counters["full_prefills"] += 1
        else:
            m = ctx // ps
            suffix, ctx_ids, sfx_ids = self._to_device(
                r.prompt[None, ctx:], np.asarray(r.pages[:m]),
                np.asarray(r.pages[m:n_pg_prompt]))
            tok0, ok, _ = self._suffix_fn(m, Lp - ctx)(
                self.params, self.caches, suffix, ctx_ids, sfx_ids,
                self.generator)
            self.counters["prefill_tokens"] += Lp - ctx
            self.counters["suffix_prefills"] += 1
        tok0, ok = self._to_host(tok0, ok)
        return int(tok0[0]), bool(ok[0])

    def _replay(self, r: Request, start: int) -> bool:
        """Resume catch-up: teacher-force the parked generated tokens whose
        kv fell outside the surviving radix prefix through the REGULAR
        decode program (all other slots masked to the garbage page, their
        rows ignored). With greedy sampling and an fp32 pool the replayed
        prediction must reproduce the parked token, which the engine
        asserts. Returns False if the finite guard trips mid-replay.

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
        saved = [{name: e.clone() for name, e in seg.items()
                  if not PG.is_paged_entry(name)} for seg in self.caches]
        survived = self._replay_steps(r, start, end)
        for seg, snap in zip(self.caches, saved):
            for name, old in snap.items():
                ba = T.cache_batch_axis(name)
                keep = torch.tensor([r.slot], device=old.device)
                old.index_copy_(ba, keep, seg[name].index_select(ba, keep))
                seg[name].copy_(old)
        return survived

    def _replay_steps(self, r: Request, start: int, end: int) -> bool:
        """Teacher-force positions [start, end) of ``r`` through the decode
        program; False when the finite guard trips."""
        size, loc = self.n_main, r.slot
        Lp = r.prompt_len
        for p in range(start, end):
            tok_v = np.zeros((size,), np.int32)
            pos_v = np.zeros((size,), np.int32)
            bt = np.full_like(self.block_tables, PG.GARBAGE_PAGE)
            tok_v[loc] = r.out[p - Lp]
            pos_v[loc] = p
            bt[loc] = self.block_tables[loc]
            args = self._to_device(tok_v, pos_v, bt, np.zeros((size,), np.int32))
            nxt, ok, _ = self._decode(self.params, self.caches, *args[:3],
                                      args[3].bool(), self.generator)
            nxt, ok = self._to_host(nxt, ok)
            if not ok[loc]:
                return False
            if self._exact:
                assert int(nxt[loc]) == r.out[p - Lp + 1], (
                    f"replay divergence at pos {p}: {int(nxt[loc])} != "
                    f"{r.out[p - Lp + 1]} (rid={r.rid})")
            self.counters["replay_tokens"] += 1
        return True

    def _start(self, r: Request,
               pre: Optional[Tuple[int, bool]] = None) -> bool:
        """Bring an admitted request onto its slot: link its block table,
        consume the bucketed-prefill result planned for it (``pre``) or run
        the exact-shape prefill itself (full / suffix / skipped when the
        radix hit covers the whole prompt), and for resumed requests replay
        the parked positions. Returns False when a fault guard FAILED the
        request (slot and pages already released)."""
        ps = self.psv.page_size
        ctx = r.n_shared * ps
        Lp = r.prompt_len
        resumed = bool(r.out)
        row = self.block_tables[r.slot]
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
        # requests admitted from the NEXT step on can share them.
        self.sched.donate_prefilled(r, self.step_count)
        if resumed and not self._replay(r, max(Lp, ctx)):
            self._fail(r, NonFiniteLogitsError(
                f"rid={r.rid}: non-finite logits during decode replay"),
                scrub=True)
            return False
        self.tok[r.slot] = r.out[-1]
        self.pos[r.slot] = r.pos
        return True

    def _finish(self, r: Request) -> None:
        slot = r.slot
        self.sched.finish(r, self.step_count)
        self._clear_slot(slot)
        self.results[r.rid] = np.asarray(r.out, np.int32)

    def _plan_prefills(self, admitted: List[Request]
                       ) -> Dict[int, Tuple[int, bool]]:
        """Pass 1 of admission: vocab-guard every admitted request, then
        pack the bucket-eligible prefills into bucket groups and launch
        each group ONCE. Returns rid -> (first token, finite-ok) for every
        request whose prefill ran batched; ``_start`` consumes those.
        Eligible: the ladder is on, suffix tokens remain (a full-prompt
        radix cover skips prefill), and a rung holds the SUFFIX length."""
        pre: Dict[int, Tuple[int, bool]] = {}
        ps = self.psv.page_size
        vocab = self.ms.cfg.vocab_size
        groups: Dict[int, List[Request]] = {}
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
                groups.setdefault(b, []).append(r)
        for b, grp in sorted(groups.items()):
            pre.update(self._launch_bucket(b, grp))
        return pre

    def _launch_bucket(self, bucket: int, grp: List[Request]
                       ) -> Dict[int, Tuple[int, bool]]:
        """One bucket group: right-pad each row's SUFFIX (the full prompt
        when cold) to ``bucket``, launch chunks of the program's fixed row
        count (short chunks pad with inert rows: zero prompts, all-garbage
        page ids), and take each row's token at its true length. Under the
        ctx-aware program radix-hit rows also carry their matched pages
        (garbage-padded to the uniform width) and ctx length."""
        ps = self.psv.page_size
        rows = BK.rows_for_bucket(bucket, self.n_main,
                                  self.psv.prefill_token_budget)
        ctx_pages = self._bucket_ctx_pages()
        fn = self._bucket_prefill_fn(bucket, rows)
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
            args = self._to_device(prompts, true_lens, page_ids,
                                   *((ctx_ids, ctx_lens) if ctx_pages else ()))
            tok0, ok, _ = fn(self.params, self.caches, *args, self.generator)
            tok0, ok = self._to_host(tok0, ok)
            for i, r in enumerate(chunk):
                out[r.rid] = (int(tok0[i]), bool(ok[i]))
            self.counters["bucket_groups"] += 1
            self.counters["pad_tokens"] += rows * bucket - sum(
                r.prompt_len - r.n_shared * ps for r in chunk)
        return out

    def _admit(self, *, count_blocked: bool) -> None:
        admitted = self.sched.admit(self.step_count,
                                    count_blocked=count_blocked)
        pre = self._plan_prefills(admitted)
        for r in admitted:
            if r.status in TERMINAL_STATES:
                continue          # failed by the pass-1 vocab guard
            if not self._start(r, pre.get(r.rid)):
                continue
            # "admitted" counts requests that SURVIVED admission.
            self.counters["admitted"] += 1
            if r.done():      # max_new == 1 (or instant EOS) on prefill
                self._finish(r)
            else:
                self.telemetry.span_event(r.rid, DECODE, self.step_count)

    def _decode_cohort(self) -> None:
        """ONE decode launch over every slot; running rows take their next
        token, idle rows are ignored."""
        running = dict(self.sched.running)
        if not running:
            return
        poison = np.zeros((self.n_main,), np.int32)
        for s in self._poison_slots:
            poison[s] = 1
        tok, pos, bt, poison = self._to_device(self.tok, self.pos,
                                               self.block_tables, poison)
        prof = (torch.profiler.record_function(f"paged_decode_{COHORT_MAIN}")
                if self.psv.profile_decode else contextlib.nullcontext())
        with prof:
            nxt, ok, _ = self._decode(self.params, self.caches, tok, pos, bt,
                                      poison.bool(), self.generator)
        nxt, ok = self._to_host(nxt, ok)
        for slot, r in sorted(running.items()):
            if not ok[slot]:
                # Non-finite logits on this row only: scrub its private
                # pages on the way out; other rows are untouched.
                self._fail(r, NonFiniteLogitsError(
                    f"rid={r.rid}: non-finite logits in decode at step "
                    f"{self.step_count} (slot {slot})"), scrub=True)
                continue
            r.out.append(int(nxt[slot]))
            self.tok[slot] = nxt[slot]
            self.pos[slot] += 1
            self.counters["decoded"] += 1
            if r.done():
                self._finish(r)

    def _step_gauges(self, hit0: int, faults0: Dict[str, int]) -> None:
        """Per-step gauge samples, taken after the step's work: queue
        depth, pool live/free/shared pages, per-step radix hit tokens, slot
        occupancy, and faults by kind. Host reads only."""
        tel, sc = self.telemetry, self.step_count
        tel.gauge("queue_depth", sc, self.sched.n_queued)
        tel.gauge("pages_live", sc, self.pool.live)
        tel.gauge("pages_free", sc, self.pool.n_free)
        tel.gauge("pages_shared", sc, self.pool.shared)
        tel.gauge("hit_tokens_step", sc,
                  tel.counters["hit_tokens"]
                  + tel.counters["resume_hit_tokens"] - hit0)
        tel.gauge(f"slots_live/{COHORT_MAIN}", sc, self.sched.n_running)
        for kind, n in tel.fault_counts.items():
            d = n - faults0.get(kind, 0)
            if d:
                tel.gauge(f"faults/{kind}", sc, d)

    @torch.no_grad()
    def step(self) -> Dict[str, int]:
        """One engine iteration: chaos injection (when armed) -> deadline
        expiry -> admission + prefill (with blocked-head preemption when
        enabled) -> block-table validation -> one decode launch. Returns
        the step's lifecycle event counts (telemetry counter deltas)."""
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
        self._decode_cohort()
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
        latency, prefix hit rate, pool accounting and occupancy. Everything
        outside ``wall*`` keys is a pure function of the step-denominated
        event stream."""
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
        return snap

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of the scalar channels."""
        return self.telemetry.prom_text()
