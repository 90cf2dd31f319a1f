"""Paged pair-KV cache pool for the continuous-batching engine.

Ported from the JAX package's ``serve/paged_cache.py``. The pool carves the
cache into fixed-size PAGES handed out from a free list
(``serve.scheduler.PagePool``); a request holds exactly the pages its
length needs and returns them the moment it finishes, so requests of very
different lengths share one cache allocation.

Layout: the ring cache's stacked pair layout with the ``[B, L]`` prefix
replaced by ``[n_pages, page_size]``. A fused LP pair's k/v pool is
``[count, 2, n_pages, page_size, Hkv, hd]`` (bare entry names), a
single-layer entry ``[count, n_pages, page_size, Hkv, hd]`` (indexed names
``k0``/``v0``). Both halves of a pair live at the SAME page indices of
their own half, so one block table serves the pair and a pair decodes in
one kernel launch (``kernels.ops.decode_attention_pair_paged``).

Indirection: a block table ``[n_slots, pages_per_slot]`` maps a slot's
logical position ``t`` to ``(page, offset) = (bt[slot, t // ps], t % ps)``.
Page 0 is RESERVED as the garbage page: idle slots and the unused tail of
every block-table row point at it, so the fixed-shape decode batch writes
and reads it harmlessly. The free list never hands out page 0.

Recurrent state entries (``conv``/``h`` of Mamba and RG-LRU) are O(1)
per request and are not paged: they stay slot-indexed,
``[count, (2,) n_slots, ...]``, with the decode slot as their batch axis. ``scatter_prefill`` writes a request's
state at its slot and ``scrub_pages`` clears it. The state ``h`` stays
fp32 whatever the pool's type. At tp > 1 a rank's slot state holds its
channels only (d_inner / tp for Mamba, lru_width / tp for RG-LRU).

Every write here is IN PLACE (``index_copy_`` / ``index_fill_`` on the pool
tensors); the functions return the same pool list for convenience. The
pool is never copied, as the JAX package gets from XLA buffer donation.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.model import blocks as B
from repro_torch.model import transformer as T

#: Reserved garbage page: idle slots and unused block-table entries point here.
GARBAGE_PAGE = 0

Pool = List[Dict[str, torch.Tensor]]


def is_paged_entry(name: str) -> bool:
    """Self-attention k/v entries are paged (per-token length dim); state
    entries (conv/h) are slot-indexed."""
    return name.rstrip("0123456789") in ("k", "v")


def pages_needed(prompt_len: int, max_new: int, page_size: int) -> int:
    """Pages a request holds for its whole life (prompt + all new tokens)."""
    return -(-(prompt_len + max_new) // page_size)


def validate_paged_support(ms: T.ModelStructure, max_len: int) -> None:
    """The paged layout covers causal attention caches with one slot per
    absolute position, and slot state. Rejected, as in the JAX package: an
    encoder or cross-attention (whisper), a prefix-LM (paligemma), and
    ring kinds whose cache is a reused window/chunk ring (``attn_local``,
    ``attn_chunked``) shorter than ``max_len``.

    At tp > 1 a pool of split kv heads (n_kv >= tp) cuts the stored head
    axis into equal per-rank shards, so n_kv must divide by tp: the padded
    heads the ring cache tolerates would be phantom heads in every page.
    Replicated kv (n_kv < tp) has no such rule: every rank holds all stored
    heads and the kernel reads its own through the head map."""
    cfg = ms.cfg
    if ms.enc_segments or cfg.enc_layers:
        raise ValueError(f"{cfg.name}: encoder/cross-attention caches are "
                         "not pageable")
    if cfg.prefix_len:
        raise ValueError(f"{cfg.name}: prefix-LM serving is not paged yet")
    dims = ms.dims
    if ms.tp > 1 and dims.kv_sharded and cfg.n_kv_heads % ms.tp:
        raise ValueError(
            f"{cfg.name}: n_kv_heads={cfg.n_kv_heads} does not divide by "
            f"tp={ms.tp}; the paged pool splits stored kv heads evenly over "
            f"the ranks (the ring cache pads to {dims.hkv_global} heads, but "
            "padded pool heads would be phantom heads in every page): pick "
            "tp dividing n_kv_heads, or tp > n_kv_heads for replicated kv")
    for seg in ms.segments:
        for spec in seg.group.specs:
            if spec.cross_attn:
                raise ValueError(f"{cfg.name}: cross-attention not pageable")
            m = spec.mixer
            if m.startswith("attn") and B.ring_len(cfg, m, max_len) != max_len:
                raise ValueError(
                    f"{cfg.name}: {m} reuses a ring of "
                    f"{B.ring_len(cfg, m, max_len)} < {max_len} slots; paged "
                    "layout requires one slot per absolute position")


def paged_cache_meta(ms: T.ModelStructure, *, n_slots: int, n_pages: int,
                     page_size: int, dtype=torch.bfloat16):
    """Per segment, {entry name: (shape, dtype)} of this rank's pool: the
    ring cache meta with the ``[B, L]`` prefix of every k/v entry replaced
    by ``[n_pages, page_size]``; state entries keep ``n_slots`` as their
    batch and their own type (``h`` is fp32). At tp > 1 the head axis holds
    the rank's share of split kv heads, or every stored head when kv is
    replicated (``attention.AttnDims.hkv``)."""
    meta = T.cache_meta(ms, batch=n_slots, max_len=n_pages * page_size,
                        dtype=dtype)
    out = []
    for seg in meta:
        nseg = {}
        for name, (shape, dt) in seg.items():
            if is_paged_entry(name):
                ba = T.cache_batch_axis(name)   # [count, (2,) B, L, H, hd]
                shape = (*shape[:ba], n_pages, page_size, *shape[ba + 2:])
            nseg[name] = (shape, dt)
        out.append(nseg)
    return out


def init_paged_caches(ms: T.ModelStructure, *, n_slots: int, n_pages: int,
                      page_size: int, dtype=torch.bfloat16,
                      device="cuda") -> Pool:
    """An all-zero pool on ``device`` (the card unless the caller asks for
    "cpu")."""
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in seg.items()}
            for seg in paged_cache_meta(ms, n_slots=n_slots, n_pages=n_pages,
                                        page_size=page_size, dtype=dtype)]


def _ids(page_ids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.long, device=like.device)


def gather_ctx(pool: Pool, page_ids) -> Pool:
    """A prefix's pages as per-segment CONTEXT kv trees for the suffix
    prefill (``forward_full(ctx_kv=..., start=n_pg * page_size)``).

    page_ids: [n_pg] pages covering the matched prefix in position order.
    Returns one tree per segment in the emitted-cache layout with a batch-1
    length axis: pair entries [count, 2, 1, n_pg * ps, Hkv, hd], per-layer
    entries [count, 1, n_pg * ps, Hkv, hd]. A new tensor (a gather), not a
    view of the pool."""
    out = []
    for seg in pool:
        nseg = {}
        for name, pv in seg.items():
            ba = T.cache_batch_axis(name)   # page axis of the pool entry
            g = pv.index_select(ba, _ids(page_ids, pv))
            g = g.reshape(*g.shape[:ba], -1, *g.shape[ba + 2:])
            nseg[name] = g.unsqueeze(ba)     # batch-1 at the B axis
        out.append(nseg)
    return out


def gather_ctx_rows(pool: Pool, page_ids) -> Pool:
    """Per-row twin of ``gather_ctx`` for the bucketed radix-suffix path.

    page_ids: [rows, n_ctx_pages]; row i's first ``ctx_len_i / page_size``
    entries are its matched prefix pages in position order, the rest (and
    every entry of a cold row) ``GARBAGE_PAGE``. Returns one tree per
    segment with ``rows`` as the batch axis: pair entries
    [count, 2, rows, n_ctx_pages * ps, Hkv, hd], per-layer entries
    [count, rows, n_ctx_pages * ps, Hkv, hd]. Garbage-directed positions
    gather the all-zero garbage page: finite junk that the forward's per-row
    key rearrangement parks behind each row's causal horizon."""
    out = []
    for seg in pool:
        nseg = {}
        for name, pv in seg.items():
            ba = T.cache_batch_axis(name)
            ids = _ids(page_ids, pv)
            g = pv.index_select(ba, ids.reshape(-1))   # [.., rows*n_ctx, ps, ..]
            nseg[name] = g.reshape(*g.shape[:ba], ids.shape[0], -1,
                                   *g.shape[ba + 2:])
        out.append(nseg)
    return out


def _slot_ids(slot, pv: torch.Tensor, name: str) -> torch.Tensor:
    if slot is None:
        raise ValueError(f"state entry {name!r} needs the request's slot")
    return _ids([int(slot)], pv)


def scrub_pages(pool: Pool, page_ids, slot=None) -> Pool:
    """Zero a departing request's pages and its slot's state rows, in place
    (fault containment: a FAILED request may have written non-finite
    values, and the next holder of a recycled page or slot must not find
    them). ``page_ids`` may be padded with ``GARBAGE_PAGE``: zeroing the
    garbage page is harmless. ``slot`` (the request's decode slot) is
    needed when the pool has state entries."""
    for seg in pool:
        for name, pv in seg.items():
            ids = (_ids(page_ids, pv) if is_paged_entry(name)
                   else _slot_ids(slot, pv, name))
            pv.index_fill_(T.cache_batch_axis(name), ids, 0)
    return pool


def scatter_prefill(pool: Pool, seq: Pool, page_ids, slot=None) -> Pool:
    """Place one request's prefill caches into its pages and its decode
    slot, in place.

    seq: a batch-1 cache tree from ``forward_full(emit_cache=True,
    max_len=n_scatter_pages * page_size)`` (the cache length is a whole
    number of pages). page_ids: [n_scatter_pages], the FIRST
    ceil(prompt_len / page_size) pages the request owns. Positions of the
    last page past the true prompt length receive junk; they stay masked
    (pos > horizon) until the decode loop overwrites each of them.
    ``slot``: the request's decode slot, which receives the state entries
    (needed when the pool has any)."""
    for pool_seg, seq_seg in zip(pool, seq):
        for name, pv in pool_seg.items():
            ba = T.cache_batch_axis(name)
            s = seq_seg[name]
            if not is_paged_entry(name):
                pv.index_copy_(ba, _slot_ids(slot, pv, name), s.to(pv.dtype))
                continue
            ids = _ids(page_ids, pv)
            s = s.squeeze(ba)                        # length at ba
            s = s.reshape(*s.shape[:ba], ids.shape[0], pv.shape[ba + 1],
                          *s.shape[ba + 1:])
            pv.index_copy_(ba, ids, s.to(pv.dtype))
    return pool


def scatter_prefill_rows(pool: Pool, seq: Pool, page_ids) -> Pool:
    """Place a BUCKETED prefill batch's caches into each row's pages in one
    shot, in place.

    seq: a batch-``rows`` cache tree from the bucket forward
    (``max_len=bucket``, a whole number of pages). page_ids: [rows, n_pg];
    row i's first ``ceil(true_len_i / page_size)`` entries are its real
    pages, every pad entry (the page tail a short prompt does not reach,
    every entry of a pad row) is ``GARBAGE_PAGE``. Garbage-directed chunks
    are ZEROED before the scatter, so pad rows write nothing anywhere real,
    the garbage page stays all-zero, and the duplicate garbage indices are
    deterministic: every colliding write stores the same zeros."""
    for pool_seg, seq_seg in zip(pool, seq):
        for name, pv in pool_seg.items():
            ba = T.cache_batch_axis(name)            # rows at ba, len at ba+1
            ids = _ids(page_ids, pv)
            flat = ids.reshape(-1)
            ps = pv.shape[ba + 1]
            s = seq_seg[name]
            s = s.reshape(*s.shape[:ba], flat.shape[0], ps, *s.shape[ba + 2:])
            keep = (flat != GARBAGE_PAGE).reshape(
                (1,) * ba + (-1,) + (1,) * (s.dim() - ba - 1))
            s = torch.where(keep, s, torch.zeros((), dtype=s.dtype,
                                                  device=s.device))
            pv.index_copy_(ba, flat, s.to(pv.dtype))
    return pool


def rewind_tokens(pool: Pool, page_ids, offsets) -> Pool:
    """Un-write single token positions: zero ``(page_ids[i], offsets[i])``
    across every paged entry, in place (both halves of a stacked pair entry
    in one write).

    Speculative-decoding rewind: rejected draft tokens left kv at positions
    past the slot's committed horizon. Those bits are never read wrong (a
    decode launch scatters every row's kv before any row gathers, and each
    row masks positions past its own ``pos``), but the contract that pages
    hold only committed-token kv is what prefix sharing and the page
    accounting lean on, so the engine restores it eagerly. Fixed shape like
    ``scrub_pages``: the pair lists are padded with ``(GARBAGE_PAGE, 0)``
    (zeroing the garbage page is harmless; duplicate pairs all write the
    same zero). Slot-state entries are left alone: speculation is
    attention-only (``serve.speculative``)."""
    for seg in pool:
        for name, pv in seg.items():
            if not is_paged_entry(name):
                continue
            idx = (slice(None),) * T.cache_batch_axis(name) + (
                _ids(page_ids, pv), _ids(offsets, pv))
            pv[idx] = 0
    return pool


def rewind_plan(pages: List[int], n_shared: int, new_len: int, old_len: int,
                page_size: int) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Host-side rewind bookkeeping: shrink a request's written horizon
    from ``old_len`` to ``new_len`` tokens.

    Returns ``(zero_pairs, free_pages)``:

    - ``zero_pairs``: the ``(page, offset)`` of every position in
      ``[new_len, old_len)``, to un-write with ``rewind_tokens``.
    - ``free_pages``: the trailing pages left with NO live position. An
      allocator that extends page holdings on demand returns these through
      ``PagePool.free_rewound`` (which re-checks they are privately held).
      The engine claims prompt + max_new pages up front and re-uses
      rewound positions for later commits, so it ignores this list.

    Radix-shared pages are read-only by refcount: a rewind may only
    un-write this request's own writes, so ``new_len`` may never cut into
    the shared prefix.
    """
    if not 0 <= new_len <= old_len:
        raise ValueError(f"rewind to {new_len} from {old_len}: the new "
                         "horizon must be within the written one")
    if new_len < n_shared * page_size:
        raise ValueError(
            f"rewind to {new_len} tokens would cut into the "
            f"{n_shared}-page radix-shared prefix "
            f"({n_shared * page_size} tokens): shared pages are read-only "
            "— only positions this request wrote itself can rewind")
    if old_len > len(pages) * page_size:
        raise ValueError(f"old_len={old_len} exceeds the "
                         f"{len(pages)}-page holding")
    zero_pairs = [(int(pages[t // page_size]), t % page_size)
                  for t in range(new_len, old_len)]
    first_keep = -(-new_len // page_size)
    n_old = -(-old_len // page_size)
    return zero_pairs, [int(p) for p in pages[first_keep:n_old]]
