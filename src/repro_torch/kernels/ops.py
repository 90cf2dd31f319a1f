"""Public kernel wrappers: device dispatch and launch counts.

Each wrapper takes the JAX package's layout at its interface and dispatches
on the device its tensors lie on:

  * CPU tensors run the kernel's plain PyTorch version (``*_plain`` here,
    built on ``repro_torch.kernels.ref``);
  * CUDA tensors launch the hand-written Hopper kernel, or raise.

  * "meta" tensors (the dry run, ``launch/dryrun.py``) give empty outputs
    of the kernel's shapes and dtypes on meta: the counterpart of a
    ``pallas_call``'s abstract evaluation. Nothing is computed and no
    launch is counted.

There is no fallback and no switch that runs the plain version on a CUDA
tensor. ``LAUNCHES`` counts kernel launches per wrapper; it moves only where
a kernel is launched, so a run can show which kernels its path went
through (``reset_launches`` before the run, read after).
``HEAD_MAP_LAUNCHES`` counts, beside it, the paged decode launches that
took a head map (a tensor-parallel rank over replicated kv heads).

The kernels are called through ctypes, so autograd does not see them: their
outputs carry no ``grad_fn``. Every wrapper therefore raises on an input off
the CPU that requires grad while grad mode is on, so a backward pass can
never lose the gradient of the weights below a kernel without a word. The
train step's forward runs the kernels' torch versions instead
(``transformer.loss_fn(differentiable=True)``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"dual_rmsnorm": 0, "decode_attention": 0,
            "decode_attention_pair": 0, "decode_attention_paged": 0,
            "decode_attention_pair_paged": 0, "flash_attention": 0,
            "ssm_scan": 0}
HEAD_MAP_LAUNCHES = {"decode_attention_paged": 0,
                     "decode_attention_pair_paged": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, HEAD_MAP_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _refuse_grad(tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a kernel has no backward: its output would carry no gradient. "
            "Run it under torch.no_grad(), or take the differentiable "
            "forward (transformer.loss_fn(differentiable=True))")


def _on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on "meta" (the wrapper then returns
    empty outputs); False when none does; raises on a mix, and for a meta
    tensor that requires grad under grad mode, as ``_on_card``."""
    meta = [t.device.type == "meta" for t in tensors]
    if any(meta) and not all(meta):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if meta[0]:
        _refuse_grad(tensors)
    return meta[0]


def _empty(like: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    return torch.empty(like.shape if shape is None else shape,
                       dtype=like.dtype if dtype is None else dtype, device="meta")


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise, and
    for a tensor off the CPU that requires grad under grad mode (the kernel
    would cut the autograd graph)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return False
    _refuse_grad(tensors)
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------------------
# dual RMSNorm
# ---------------------------------------------------------------------------

def dual_rmsnorm_plain(x, sa, sb, *, eps=1e-6, plus_one=False):
    ya, yb = ref.dual_rmsnorm_ref(x.reshape(-1, x.shape[-1]), sa, sb, eps=eps,
                                  plus_one=plus_one)
    return torch.stack([ya, yb]).reshape(2, *x.shape)


def dual_rmsnorm(x, sa, sb, *, eps=1e-6, plus_one=False):
    """x: [..., D] -> [2, ..., D]: the two per-path norms (LP pair) stacked
    on a leading axis, so ``ya, yb = dual_rmsnorm(...)`` unpacks them."""
    if _on_meta(x, sa, sb):
        return _empty(x, (2, *x.shape))
    if not _on_card(x, sa, sb):
        return dual_rmsnorm_plain(x, sa, sb, eps=eps, plus_one=plus_one)
    from repro_torch.kernels import dual_rmsnorm as K
    y = K.launch(x.reshape(-1, x.shape[-1]), sa, sb, eps=eps, plus_one=plus_one)
    LAUNCHES["dual_rmsnorm"] += 1
    return y.reshape(2, *x.shape)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, kind="causal", window=0, chunk=0,
                          prefix_len=0, q0=0, k0=0, block_n=64):
    """Grouped layout: q [B, S, H, g, hd]; k, v [B, T, H, hd] ->
    [B, S, H, g, hd]. Folds to the kernel's rows (row = pos*g + head) and
    runs ``flash_attention_ref``; ``block_n`` only sets the kernel's tiling,
    which the plain version does not have. ``q0``: an int, or a [B] tensor
    of per-row query offsets."""
    B, S, H, g, hd = q.shape
    T = k.shape[1]
    if torch.is_tensor(q0):
        q0 = q0.long().repeat_interleave(H)   # one offset per (b, kv head)
    qf = q.permute(0, 2, 1, 3, 4).reshape(B * H, S * g, hd)
    kf = k.permute(0, 2, 1, 3).reshape(B * H, T, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * H, T, hd)
    o = ref.flash_attention_ref(qf, kf, vf, kind=kind, window=window,
                                chunk=chunk, prefix_len=prefix_len, q0=q0,
                                k0=k0, q_group=g)
    return o.reshape(B, H, S, g, hd).permute(0, 2, 1, 3, 4)


def flash_attention(q, k, v, *, kind="causal", window=0, chunk=0,
                    prefix_len=0, q0=0, k0=0, block_n=64):
    """Grouped layout: q [B, S, H, g, hd]; k, v [B, T, H, hd] ->
    [B, S, H, g, hd]. ``block_n`` is the kv tile width, fixed by the caller
    and never clamped to T. ``q0`` is an int, or an int32 tensor [B] of
    per-row query offsets on the inputs' device."""
    if _on_meta(q, k, v, *([q0] if torch.is_tensor(q0) else [])):
        return _empty(q)
    if not _on_card(q, k, v, *([q0] if torch.is_tensor(q0) else [])):
        return flash_attention_plain(q, k, v, kind=kind, window=window,
                                     chunk=chunk, prefix_len=prefix_len,
                                     q0=q0, k0=k0, block_n=block_n)
    from repro_torch.kernels import flash_attention as K
    o = K.launch(q, k, v, kind=kind, window=window, chunk=chunk,
                 prefix_len=prefix_len, q0=q0, k0=k0, block_n=block_n)
    LAUNCHES["flash_attention"] += 1
    return o


# ---------------------------------------------------------------------------
# ring decode attention (single layer and LP pair)
# ---------------------------------------------------------------------------

decode_attention_plain = ref.decode_attention_ref
decode_attention_pair_plain = ref.decode_attention_pair_ref


def decode_attention(q, k, v, t_valid):
    """q: [B, Hkv, g, hd]; k, v: [B, L, Hkv, hd] -> [B, Hkv, g, hd]."""
    if _on_meta(q, k, v):
        return _empty(q)
    if not _on_card(q, k, v):
        return decode_attention_plain(q, k, v, t_valid)
    from repro_torch.kernels import decode_attention as K
    o = K.launch(q[None], k[None], v[None], int(t_valid))[0]
    LAUNCHES["decode_attention"] += 1
    return o


def decode_attention_pair(q, k, v, t_valid):
    """Fused LP-pair decode: q [2, B, Hkv, g, hd]; k, v [2, B, L, Hkv, hd]
    (the stacked pair cache) -> [2, B, Hkv, g, hd] in one kernel launch."""
    if q.shape[0] != 2 or k.shape[0] != 2:
        raise ValueError(f"pair decode shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if _on_meta(q, k, v):
        return _empty(q)
    if not _on_card(q, k, v):
        return decode_attention_pair_plain(q, k, v, t_valid)
    from repro_torch.kernels import decode_attention as K
    o = K.launch(q, k, v, int(t_valid))
    LAUNCHES["decode_attention_pair"] += 1
    return o


# ---------------------------------------------------------------------------
# paged decode attention (single layer and LP pair)
# ---------------------------------------------------------------------------

decode_attention_paged_plain = ref.decode_attention_paged_ref
decode_attention_pair_paged_plain = ref.decode_attention_pair_paged_ref


def _paged(name, q, k_pages, v_pages, block_tables, t_valid, head_map):
    """Dispatch one paged decode entry (``name``): q [P, B, Hkv, g, hd] and
    the pool [P, n_pages, ps, Hs, hd] with the pair axis P; ``head_map``
    (int32 [Hkv] on the inputs' device, or None) is checked on every
    device before it is used."""
    from repro_torch.kernels import decode_attention as K
    if _on_meta(q, k_pages, v_pages, block_tables, t_valid,
                *([head_map] if torch.is_tensor(head_map) else [])):
        return _empty(q)
    if head_map is not None:
        K.check_head_map(head_map, q.shape[2], k_pages.shape[3], q.device)
    if not _on_card(q, k_pages, v_pages, block_tables, t_valid):
        return torch.stack([ref.decode_attention_paged_ref(
            q[i], k_pages[i], v_pages[i], block_tables, t_valid, head_map)
            for i in range(q.shape[0])])
    o = K.launch_paged(q, k_pages, v_pages, block_tables, t_valid, head_map)
    LAUNCHES[name] += 1
    if head_map is not None:
        HEAD_MAP_LAUNCHES[name] += 1
    return o


def decode_attention_paged(q, k_pages, v_pages, block_tables, t_valid,
                           head_map=None):
    """q: [B, Hkv, g, hd]; k/v_pages: [n_pages, ps, Hs, hd]; block_tables
    [B, n_pg] and t_valid [B], int32, on the same device -> [B, Hkv, g, hd].
    Each row attends to its positions 0..t_valid[b]. ``head_map``: an
    optional int32 [Hkv] tensor on the same device; q's kv head h then reads
    the pool's stored head ``head_map[h]`` (without one, Hs == Hkv)."""
    return _paged("decode_attention_paged", q[None], k_pages[None],
                  v_pages[None], block_tables, t_valid, head_map)[0]


def decode_attention_pair_paged(q, k_pages, v_pages, block_tables, t_valid,
                                head_map=None):
    """Fused paged LP-pair decode: q [2, B, Hkv, g, hd]; k/v_pages
    [2, n_pages, ps, Hs, hd] (the stacked pair pool, one block table and
    one optional head map for both halves) -> [2, B, Hkv, g, hd] in one
    kernel launch."""
    if q.shape[0] != 2 or k_pages.shape[0] != 2:
        raise ValueError(f"pair decode shapes {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    return _paged("decode_attention_pair_paged", q, k_pages, v_pages,
                  block_tables, t_valid, head_map)


# ---------------------------------------------------------------------------
# selective scan (Mamba-1 / RG-LRU recurrence)
# ---------------------------------------------------------------------------

def ssm_scan_plain(a, b, h0, *, block_s=256, block_c=128):
    """a, b: [B, S, C, N]; h0: [B, C, N] -> (y [B, S, C, N] in a's type,
    hT [B, C, N] fp32): ``ssm_scan_ref`` in fp32. ``block_s``/``block_c``
    are the TPU kernel's tiling, which the plain version does not have."""
    y, hT = ref.ssm_scan_ref(a.float(), b.float(), h0.float())
    return y.to(a.dtype), hT


def ssm_scan(a, b, h0, *, block_s=256, block_c=128):
    """h_t = a_t * h_{t-1} + b_t in fp32 over S. a, b: [B, S, C, N] of one
    type; h0: [B, C, N] (any float type) -> (y [B, S, C, N] in a's type,
    hT [B, C, N] fp32). The JAX signature: ``block_s``/``block_c`` tile the
    TPU kernel and change nothing here (the card's kernel has no tiles
    over S or C)."""
    if _on_meta(a, b, h0):
        return _empty(a), _empty(h0, dtype=torch.float32)
    if not _on_card(a, b, h0):
        return ssm_scan_plain(a, b, h0)
    from repro_torch.kernels import ssm_scan as K
    y, hT = K.launch(a, b, h0.float())
    LAUNCHES["ssm_scan"] += 1
    return y, hT
