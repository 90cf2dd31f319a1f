"""Self-speculative decoding controller: shallow-Δ drafts, full-depth verify.

Ported from the JAX package's ``serve/speculative.py`` (host only). The
paper's Δ sweep shows the aggressively-paired shallow configuration is a
usable approximation of the full model, which makes the ``LP.replan``
re-pairing a FREE draft model: same weights, same stacked pair-cache
layout, no extra parameter memory beyond the re-stacked pairs. The
speculative mode drafts ``k`` greedy tokens with the aggressive plan, then
verifies all of them in ONE full-depth launch, accepting the longest draft
prefix the full model agrees with plus the full model's own "bonus" token.
Under greedy decoding this is lossless by construction: every committed
token is an argmax of FULL-depth logits over an exactly-committed history,
so the output stream equals the non-speculative engine's.

Why the verifier is the regular batched paged-decode program
------------------------------------------------------------
The obvious verifier — a suffix forward over the k draft tokens
(``forward_full(ctx_kv=, start=)``) — would run each slot as a 1-row
sequence forward, whose projections reduce in another grouping than the
batched decode GEMM; the engine's stream contract pins decode bits to the
DECODE program (see ``Scheduler._match_cap`` for the same constraint on
prefix matching). Instead the verifier packs slot ``s``'s k+1 probe
tokens into rows ``s*(k+1)+j`` of one regular paged-decode launch at
batch ``n_main*(k+1)``:

  row j feeds token u_j at position p0+j, where u_0 is the slot's last
  committed token at its committed position p0 and u_j (j>=1) is draft j.

Row independence makes this sound AND exact: the decode step scatters
every row's kv BEFORE any row gathers (model.attention.decode_attn_paged),
and each row masks positions beyond its own ``pos`` — so within the one
launch row j attends over exactly the committed history plus drafts
1..j, the same keys the sequential engine would have given it. The paged
decode kernel's rows are bit-identical at any batch size; the GEMMs
around it run at M = n_main*(k+1) rather than n_main, and on the card
cuBLAS may pick another kernel for that M, so bf16 streams there can
leave the plain engine's at near-ties (fp32 on the CPU: bit for bit).

Rewind
------
Rejected drafts leave kv at positions past the new committed horizon in
both cache trees. Those bits are never read (future writes land before
any gather; per-row masks hide unwritten tails) but the contract that
pages hold ONLY committed-token kv is what the radix prefix cache and the
page accounting audit (``PagePool.check_balance``) lean on — so the
engine un-writes them (``paged_cache.rewind_tokens``) and the host-side
plan (``paged_cache.rewind_plan`` + ``PagePool.free_rewound``) returns
fully-rewound private pages to the pool for allocators that extend page
holdings on demand. Radix-SHARED pages are read-only by refcount: a
rewind may never touch them, which both the plan and the pool enforce.

Scope: attention-only models (mamba/RG-LRU state advances every slot on
every launch — a rewind would need conv/h snapshots per draft step; the
engine auto-disables speculation with a warning, prefix-cache precedent),
greedy sampling (acceptance compares argmax ids), tp=1 for now.

Everything here is pure host-side bookkeeping (numpy in, numpy out) so
the acceptance/masking/rewind math is unit-testable without an engine;
the engine runs the device-side twin of the packing
(``serve.engine.make_spec_step_fn``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import lp as LP
from repro_torch.serve.paged_cache import GARBAGE_PAGE

#: Compile-event cohorts for the speculative programs (the draft prefill /
#: draft decode and the wide verify launch), keyed like the engine's
#: main/degraded cohorts so ``metrics_snapshot()`` shows them.
COHORT_SPEC_DRAFT = "spec_draft"
COHORT_SPEC_VERIFY = "spec_verify"


def draft_plan_for(cfg, base_plan, spec_delta: int):
    """The drafter's LP plan: ``spec_delta`` effective layers (0 = maximal
    pairing), validated to be strictly MORE aggressive than the base plan —
    a draft at the serving depth would just double every step."""
    if spec_delta > 0:
        plan = LP.plan_for_depth(cfg, spec_delta, end=cfg.n_layers)
    else:
        plan = LP.plan_range(cfg, 0, cfg.n_layers)
    if len(plan.pairs) <= len(base_plan.pairs):
        raise ValueError(
            f"draft plan pairs {len(plan.pairs)} vs base "
            f"{len(base_plan.pairs)}: the drafter must be strictly more "
            "aggressive than the serving plan (lower spec_delta, or serve "
            "a shallower base)")
    return plan


def spec_eligible(ms) -> bool:
    """Speculation needs every mixer to be plain causal attention: paged
    k/v entries are positional, so rewinding = un-writing positions.
    Recurrent state (mamba conv/h, RG-LRU h) advances EVERY slot on every
    launch and has no per-position representation — rewind would need a
    state snapshot per draft step."""
    return all(spec.mixer.startswith("attn") and not spec.cross_attn
               for seg in ms.segments for spec in seg.group.specs)


# ---------------------------------------------------------------------------
# Batch packing: draft steps and the one wide verify launch
# ---------------------------------------------------------------------------
#
# ``remaining[s]`` is the slot's commit headroom: max_new - len(out) for a
# running slot, -1 for an idle one. Draft step j and verify row j both feed
# a token at device position p0+j; any j past ``remaining`` would write kv
# beyond the request's page allocation, so those rows are masked to the
# idle-slot convention (garbage block table, pos 0, tok 0 — exactly the
# rows the engine already ignores).

def draft_active(j: int, remaining: np.ndarray) -> np.ndarray:
    """Bool [n]: slots whose draft step j writes inside their allocation."""
    return (remaining >= 0) & (j <= remaining)


def build_draft_step(j: int, tok: np.ndarray, drafts: np.ndarray,
                     pos: np.ndarray, bt: np.ndarray,
                     remaining: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inputs for draft launch ``j`` (0-based): feed the last committed
    token for j == 0, else draft j-1's output, at position p0+j."""
    act = draft_active(j, remaining)
    tok_j = np.where(act, tok if j == 0 else drafts[j - 1], 0)
    pos_j = np.where(act, pos + j, 0)
    bt_j = np.where(act[:, None], bt, GARBAGE_PAGE)
    return tok_j.astype(np.int32), pos_j.astype(np.int32), \
        bt_j.astype(np.int32)


def build_verify_batch(k: int, tok: np.ndarray, pos: np.ndarray,
                       bt: np.ndarray, poison: np.ndarray,
                       drafts: np.ndarray, remaining: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Pack every slot's k+1 probe rows for the ONE verify launch.

    Slot s occupies rows [s*(k+1), (s+1)*(k+1)): row j re-feeds u_j at
    p0+j against the slot's own block table, so its logits are the full
    model's distribution for position p0+j+1 given drafts 1..j. Poisoned
    slots replicate their poison flag to every row (chaos containment
    composes: any poisoned row fails the whole slot, never a neighbour).
    """
    n = tok.shape[0]
    rows = n * (k + 1)
    tok_v = np.zeros((rows,), np.int32)
    pos_v = np.zeros((rows,), np.int32)
    bt_v = np.full((rows, bt.shape[1]), GARBAGE_PAGE, np.int32)
    poison_v = np.zeros((rows,), bool)
    for j in range(k + 1):
        act = draft_active(j, remaining)
        idx = np.arange(n) * (k + 1) + j
        tok_v[idx] = np.where(act, tok if j == 0 else drafts[j - 1], 0)
        pos_v[idx] = np.where(act, pos + j, 0)
        bt_v[idx[act]] = bt[act]
        poison_v[idx] = poison & act
    return tok_v, pos_v, bt_v, poison_v


# ---------------------------------------------------------------------------
# Acceptance
# ---------------------------------------------------------------------------

def accept_length(draft_col: Sequence[int], verify_col: Sequence[int],
                  a_max: int) -> int:
    """Longest prefix of the drafts the full model reproduces, capped at
    ``a_max``: draft i+1 is accepted iff it equals verify row i's argmax
    (the full model's choice after committing drafts 1..i)."""
    a = 0
    while a < a_max and int(draft_col[a]) == int(verify_col[a]):
        a += 1
    return a


def commit_tokens(draft_col: Sequence[int], verify_col: Sequence[int],
                  a: int) -> List[int]:
    """The episode's committed tokens: accepted drafts 1..a, then the
    verifier's bonus — verify row a's argmax, the full model's pick for
    the first position the drafts got wrong (or the position after the
    last accepted draft). Every element is a FULL-depth argmax over a
    committed history: zero accuracy loss."""
    return [int(draft_col[i]) for i in range(a)] + [int(verify_col[a])]


def stale_span(pos0: int, accepted: int, j_hi: int) -> Tuple[int, int]:
    """Device positions [start, stop) holding rejected-draft kv after an
    episode: the verify/draft launches wrote positions p0..p0+j_hi, of
    which p0..p0+accepted hold committed-token kv. Empty when every
    written draft was accepted."""
    return pos0 + accepted + 1, pos0 + j_hi + 1


@dataclass(frozen=True)
class SpecEpisode:
    """One slot's draft/verify episode (telemetry record)."""
    step: int
    slot: int
    rid: int
    probed: int      # drafts actually probed (a_max; < k near max_new)
    accepted: int    # drafts the full model reproduced
    committed: int   # tokens appended (accepted + bonus, EOS may cut)
