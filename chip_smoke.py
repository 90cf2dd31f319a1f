#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: compile the CUDA kernels from src/repro_torch/csrc into build/.
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the shapes of the three paths below (plus every
     flash mask kind at a small size), with times of the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call. The paged decode kernel also equals the ring kernel bit for bit
     on a paginated copy of the same cache, and each of its rows equals,
     bit for bit, the same row launched alone and inside a 40-row launch
     (batch invariance); the flash kernel with a per-row q0 tensor of
     equal entries equals its scalar launch, its rows below Lq equal a
     launch cut to Lq (padding transparency, also with junk keys past Lq),
     and it is timed at the engine's bucket shape beside SDPA with a
     boolean mask; the selective scan equals its plain version bit for bit
     in fp32 (and a sequence split across two calls equals one call). The
     dual RMSNorm's rows equal, bit for bit, the same row launched alone,
     inside an 8-row launch and at three offsets of a 2048-row launch (D =
     2048, 4096 and 100, plus_one both ways; scales that are not 16-byte
     aligned give the bits of an aligned copy). At every path's shape
     (``NORM_SHAPES``) it is held against its plain version in bf16 and
     fp32, and timed in bf16 beside two ``F.rms_norm`` calls (its
     yardstick) and beside the launch floor: an empty one-block kernel
     timed the same way, launched plainly and as the norm is (programmatic
     dependent launch). It is timed back to back and between the path's
     neighbours (a residual add before, a GEMM after, in one graph).
  4. reduced parity: tinyllama and falcon-mamba cut to 4 layers in fp32,
     LP pairs (0,1), (2,3): greedy tokens on the card equal the port's CPU
     path, prefill logits agree within 2e-4; the continuous-batching
     ``PagedEngine`` on the card gives the same tokens as ``generate`` on
     the card and as the engine on the CPU (for falcon-mamba also with a
     preempted request, resumed by a full re-prefill).
  5. generate path: LP tinyllama-1.1b at full width (22 layers,
     plan_for_depth 16 -> 6 pairs + 10 single layers), bf16 random weights
     from a seed, 4 prompts of 128 tokens, 64 new tokens through
     ``generate``, with the exact launch count of every kernel, and prefill
     ms and decode ms per step taken inside that one ``generate`` call.
  6. engine path: the same model behind ``PagedEngine`` (8 slots, pages of
     16, 129 pages, prefix cache, auto bucket ladder), 16 requests in two
     waves (8 sharing a 64-token prefix, 8 cold), 32 new tokens each: an
     fp32-pool run whose streams are held against ``generate`` (any
     divergence must sit at a near-tie), then a timed bf16-pool run whose
     kernel launches reconcile exactly with the engine's own counters, and
     a profiled window of 8 engine steps.
  7. Mamba path: LP falcon-mamba-7b at full width (64 layers, d 4096,
     d_inner 8192, N 16, vocab 65024; plan_for_depth 48 -> 16 pairs + 32
     single layers), random weights made on the card from a seed, after
     the tinyllama weights are freed. First in fp32 (29 GB): the engine
     with phase 6's geometry and traffic, fp32 pool, held stream by stream
     against ``generate`` (the prefix cache and the bucket ladder switch
     off for the recurrent mixer: every admission prefills at its exact
     length). bf16 GEMMs of other shapes (decode at M = 8 against M = 1)
     move this random model's logits by a few percent of their scale, so
     the streams are held in fp32, where they move by far less. Then the
     same weights cast to bf16: ``generate`` with phase 5's prompts and
     lengths (the selective scan once per group at prefill) and a timed
     engine run whose launches reconcile with the engine's counters, each
     with a profiled window.

The second-to-last line is the kernels JSON (with every path's metrics),
the last line the device JSON.

    python3 chip_smoke.py --norm-times

times only the dual RMSNorm at ``NORM_SHAPES`` through the ``repro_torch``
beside this script, and prints one JSON line: so a copy of this script in
another checkout times that checkout's kernel on the same card.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BF16_TOL = 2e-2     # atol = rtol, as the JAX package's kernel tests
FP32_TOL = 2e-5
LOGIT_TOL = 2e-4    # prefill logits after the whole stack, fp32
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense bf16 tensor-core rate
            "float32": 67e12}        # fp32 outside the tensor cores

# Main-path shapes (tinyllama-1.1b, B=4 prompts of 128, cache of 256).
B, S, MAX_LEN, N_NEW = 4, 128, 256, 64
D, HKV, G, HD = 2048, 4, 8, 64
# Engine shapes: 8 decode slots, pages of 16 tokens, 16 pages per slot
# (max_len 256), 129 pages with the garbage page 0.
N_SLOTS, PS, N_PAGES = 8, 16, 129
N_PG = MAX_LEN // PS
ENGINE_NEW = 32
MARGIN_FRAC = 0.01   # a divergence must sit at a top-2 margin <= 1% of scale
# Mamba path: falcon-mamba-7b, d_inner 8192, state 16, 48 LP groups.
MAMBA = "falcon-mamba-7b"
MAMBA_EFF_DEPTH, DI, NS = 48, 8192, 16
# Dual RMSNorm (D, M) on the paths: tinyllama decode (generate, engine) and
# prefill (generate's 4 x 128 and the engine's 8 x 64 bucket); falcon-mamba
# decode, an exact engine admission of 97 tokens, and generate's prefill.
NORM_SHAPES = ((2048, 4), (2048, 8), (2048, 512),
               (4096, 4), (4096, 8), (4096, 97), (4096, 512))
NORM_EPS = 1e-6


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, reps=10):
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch cost
    is left out."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def call_ms(fn, iters=50):
    """Time of one call issued back to back from Python: the host's launch
    cost included, as the eager main path pays it."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name, *, flops_peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_peak or PEAK_OPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, got, want, tol):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e}, tol {tol:g})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows = {}

    def record(name, dtype, err, fn, plain, nb, fl, library=None, flops_peak=None):
        entry = rows.setdefault((name, dtype), {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if fn is None:
            return
        b_ms, b_by = bound(nb, fl, str(dtype).split(".")[1], flops_peak=flops_peak)
        entry.update(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=b_ms,
                     bound_by=b_by, library_ms=time_ms(library) if library else None,
                     call_ms=call_ms(fn))
        log(f"  {name} {dtype}: ms={entry['ms']:.5f} plain_ms={entry['plain_ms']:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms="
            f"{entry['library_ms']} call_ms={entry['call_ms']:.5f}")

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        log(f"[kernels] dual_rmsnorm {dtype}")
        for M in (B * S, B):   # prefill rows, decode rows
            x = rand(M, D, dtype=dtype)
            sa, sb = rand(D, dtype=dtype), rand(D, dtype=dtype)
            for plus_one in (False, True):
                ya, yb = ops.dual_rmsnorm(x, sa, sb, plus_one=plus_one)
                ra, rb = ops.dual_rmsnorm_plain(x, sa, sb, plus_one=plus_one)
                err = max(compare(f"dual_rmsnorm M={M} plus_one={plus_one} a", ya, ra, tol),
                          compare(f"dual_rmsnorm M={M} plus_one={plus_one} b", yb, rb, tol))
                timed = (M == B and not plus_one)   # the decode shape: most launches
                if M == B * S and not plus_one:   # the prefill shape: 12 launches
                    b_ms, b_by = bound(nbytes(x, sa, sb) + 2 * nbytes(x), 6 * M * D,
                                       "float32")
                    log(f"  dual_rmsnorm M={M}: ms={time_ms(lambda: ops.dual_rmsnorm(x, sa, sb)):.5f} "
                        f"plain_ms={time_ms(lambda: ops.dual_rmsnorm_plain(x, sa, sb)):.5f} "
                        f"bound_ms={b_ms:.6f} ({b_by})")
                record("dual_rmsnorm", dtype, err,
                       (lambda: ops.dual_rmsnorm(x, sa, sb)) if timed else None,
                       lambda: ops.dual_rmsnorm_plain(x, sa, sb),
                       nbytes(x, sa, sb) + 2 * nbytes(x), 6 * M * D,
                       library=two_rms_norms(x, sa, sb) if timed else None,
                       flops_peak=PEAK_OPS["float32"])
        check_norm_rows(ops, rand, dtype)
        if dtype == torch.bfloat16:
            from repro_torch.kernels import dual_rmsnorm as K
            device = torch.device(dev, torch.cuda.current_device())
            for pdl, key in ((False, "launch_floor_ms"), (True, "launch_floor_pdl_ms")):
                rows[key] = time_ms(lambda: K.noop(device, pdl=pdl))
            log(f"  launch floor (empty one-block kernel, graph replay): "
                f"ms={rows['launch_floor_ms']:.5f}; launched as the dual RMSNorm "
                f"(PDL): ms={rows['launch_floor_pdl_ms']:.5f}")
            rows["dual_rmsnorm_shapes"] = norm_times(
                ops, lambda pdl: K.noop(device, pdl=pdl))

        log(f"[kernels] decode attention {dtype}")
        k1, v1 = rand(B, MAX_LEN, HKV, HD, dtype=dtype), rand(B, MAX_LEN, HKV, HD, dtype=dtype)
        q1 = rand(B, HKV, G, HD, dtype=dtype)
        k2, v2 = rand(2, B, MAX_LEN, HKV, HD, dtype=dtype), rand(2, B, MAX_LEN, HKV, HD, dtype=dtype)
        q2 = rand(B, 2, HKV, G, HD, dtype=dtype).transpose(0, 1)   # strided, as on the path
        for t in (0, 63, 100, 160, MAX_LEN - 1):
            timed = t == 160
            err = compare(f"decode_attention t={t}", ops.decode_attention(q1, k1, v1, t),
                          ops.decode_attention_plain(q1, k1, v1, t), tol)
            n = t + 1
            lib = None
            if timed:
                ql = q1.reshape(B, HKV * G, 1, HD)
                kl, vl = k1[:, :n].transpose(1, 2), v1[:, :n].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True)
            record("decode_attention", dtype, err,
                   (lambda: ops.decode_attention(q1, k1, v1, t)) if timed else None,
                   lambda: ops.decode_attention_plain(q1, k1, v1, t),
                   2 * nbytes(q1) + 2 * B * n * HKV * HD * k1.element_size(),
                   4 * B * HKV * G * n * HD, library=lib)
            err = compare(f"decode_attention_pair t={t}", ops.decode_attention_pair(q2, k2, v2, t),
                          ops.decode_attention_pair_plain(q2, k2, v2, t), tol)
            if timed:
                ql2 = q2.reshape(2 * B, HKV * G, 1, HD)
                kl2 = k2.reshape(2 * B, MAX_LEN, HKV, HD)[:, :n].transpose(1, 2)
                vl2 = v2.reshape(2 * B, MAX_LEN, HKV, HD)[:, :n].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(ql2, kl2, vl2, enable_gqa=True)
            record("decode_attention_pair", dtype, err,
                   (lambda: ops.decode_attention_pair(q2, k2, v2, t)) if timed else None,
                   lambda: ops.decode_attention_pair_plain(q2, k2, v2, t),
                   2 * nbytes(q2) + 2 * 2 * B * n * HKV * HD * k2.element_size(),
                   4 * 2 * B * HKV * G * n * HD, library=lib)

        log(f"[kernels] flash attention {dtype}")
        for H in (2 * HKV, HKV):   # LP pair layer (heads folded), single layer
            q = rand(B, S, H, G, HD, dtype=dtype)
            k, v = rand(B, S, H, HD, dtype=dtype), rand(B, S, H, HD, dtype=dtype)
            err = compare(f"flash causal H={H}", ops.flash_attention(q, k, v, block_n=16),
                          ops.flash_attention_plain(q, k, v), tol)
            timed = H == 2 * HKV
            ql = q.permute(0, 2, 3, 1, 4).reshape(B, H * G, S, HD)
            kl, vl = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
            lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                         enable_gqa=True)
            pairs = B * H * G * S * (S + 1) // 2   # allowed (query, key) pairs
            if not timed:   # the single-layer shape: 10 of the 16 launches
                b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                                   str(dtype).split(".")[1])
                log(f"  flash causal H={H}: ms={time_ms(lambda: ops.flash_attention(q, k, v, block_n=16)):.5f} "
                    f"plain_ms={time_ms(lambda: ops.flash_attention_plain(q, k, v)):.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by}) library_ms={time_ms(lib):.5f}")
            record("flash_attention", dtype, err,
                   (lambda: ops.flash_attention(q, k, v, block_n=16)) if timed else None,
                   lambda: ops.flash_attention_plain(q, k, v),
                   2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                   library=lib if timed else None)
            if timed:
                check_flash_padding(ops, q, k, v, rand)
        # every other mask kind, offsets and ragged edges, at a small size
        for kw, s_len, t_len, hd, g, bn in (
                (dict(kind="window", window=7), 40, 40, 64, 2, 16),
                (dict(kind="chunk", chunk=16), 37, 37, 32, 4, 16),
                (dict(kind="causal", prefix_len=5), 40, 40, 16, 1, 64),
                (dict(kind="bidir"), 24, 40, 64, 3, 16),
                (dict(kind="causal", q0=16), 24, 40, 64, 8, 16),
                (dict(kind="causal", q0=20, k0=4), 24, 40, 128, 2, 32)):
            q = rand(2, s_len, 2, g, hd, dtype=dtype)
            k, v = rand(2, t_len, 2, hd, dtype=dtype), rand(2, t_len, 2, hd, dtype=dtype)
            err = compare(f"flash {kw} S={s_len} T={t_len} hd={hd} g={g} block_n={bn}",
                          ops.flash_attention(q, k, v, block_n=bn, **kw),
                          ops.flash_attention_plain(q, k, v, **kw), tol)
            record("flash_attention", dtype, err, None, None, 0, 0)

        log(f"[kernels] flash attention, per-row q0 {dtype}")
        # A bucketed radix-suffix prefill: 8 rows of a 64-token bucket after
        # 4 context pages; cold rows start at 0, hit rows at their ctx.
        Sb, Tc = 64, 4 * PS
        for H in (2 * HKV, HKV):
            q = rand(N_SLOTS, Sb, H, G, HD, dtype=dtype)
            k, v = (rand(N_SLOTS, Tc + Sb, H, HD, dtype=dtype) for _ in range(2))
            q0 = torch.tensor([0, 64, 32, 0, 48, 16, 64, 0], dtype=torch.int32,
                              device=dev)
            err = compare(f"flash q0 rows H={H}",
                          ops.flash_attention(q, k, v, q0=q0, block_n=16),
                          ops.flash_attention_plain(q, k, v, q0=q0), tol)
            record("flash_attention", dtype, err, None, None, 0, 0)
            same = torch.full((N_SLOTS,), 32, dtype=torch.int32, device=dev)
            if not torch.equal(ops.flash_attention(q, k, v, q0=same, block_n=16),
                               ops.flash_attention(q, k, v, q0=32, block_n=16)):
                raise AssertionError("flash with equal per-row q0 differs from "
                                     "the scalar launch")
            log(f"  flash q0 rows H={H}: equal entries == scalar q0, bit for bit")
            if H == 2 * HKV:   # the pair layer's bucket launch, timed
                qpos = q0[:, None] + torch.arange(Sb, device=dev)          # [8, Sb]
                mask = (torch.arange(Tc + Sb, device=dev)[None, None, :]
                        <= qpos[:, :, None])[:, None]                     # [8, 1, Sb, T]
                ql = q.permute(0, 2, 3, 1, 4).reshape(N_SLOTS, H * G, Sb, HD)
                kl, vl = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
                lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                             enable_gqa=True)
                compare(f"flash q0 rows H={H} against SDPA with a boolean mask",
                        ops.flash_attention(q, k, v, q0=q0, block_n=16),
                        lib().reshape(N_SLOTS, H, G, Sb, HD).permute(0, 3, 1, 2, 4), tol)
                pairs = int((qpos + 1).sum()) * H * G   # allowed (query, key) pairs
                b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                                   str(dtype).split(".")[1])
                rows[("flash_attention_bucket", dtype)] = entry = {
                    "shape": f"8 rows x {Sb}-token bucket after {Tc} context keys, "
                             f"per-row q0, {H} kv heads, g={G}, hd={HD}",
                    "ms": time_ms(lambda: ops.flash_attention(q, k, v, q0=q0, block_n=16)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}
                log(f"  flash engine bucket H={H} {dtype}: ms={entry['ms']:.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by}) library_ms={entry['library_ms']:.5f} "
                    f"(SDPA, boolean mask)")

        log(f"[kernels] paged decode attention {dtype}")
        # The engine's decode: 8 slots of 16 pages, ragged horizons, slot 1
        # idle (all-garbage block table, t = 0).
        kr, vr = (rand(2, N_SLOTS, MAX_LEN, HKV, HD, dtype=dtype) for _ in range(2))
        qp = rand(N_SLOTS, 2, HKV, G, HD, dtype=dtype).transpose(0, 1)
        perm = 1 + torch.randperm(N_SLOTS * N_PG, generator=gen, device=dev)
        bt = perm.to(torch.int32).reshape(N_SLOTS, N_PG)
        kp = torch.zeros((2, N_PAGES, PS, HKV, HD), dtype=dtype, device=dev)
        vp = torch.zeros_like(kp)
        kp[:, bt.long().reshape(-1)] = kr.reshape(2, -1, PS, HKV, HD)
        vp[:, bt.long().reshape(-1)] = vr.reshape(2, -1, PS, HKV, HD)
        bt[1] = 0
        tv = torch.tensor([255, 0, 17, 100, 160, 63, 200, 31], dtype=torch.int32,
                          device=dev)
        pair = ops.decode_attention_pair_paged(qp, kp, vp, bt, tv)
        err = compare("decode_attention_pair_paged", pair,
                      ops.decode_attention_pair_paged_plain(qp, kp, vp, bt, tv), tol)
        single = ops.decode_attention_paged(qp[0], kp[0], vp[0], bt, tv)
        err1 = compare("decode_attention_paged", single,
                       ops.decode_attention_paged_plain(qp[0], kp[0], vp[0], bt, tv), tol)
        for b in range(N_SLOTS):
            if b == 1:
                continue
            ring = ops.decode_attention_pair(qp[:, b:b + 1], kr[:, b:b + 1],
                                             vr[:, b:b + 1], int(tv[b]))
            if not torch.equal(pair[:, b:b + 1], ring):
                raise AssertionError(f"paged decode differs from the ring kernel "
                                     f"on a paginated cache (slot {b})")
        log("  paged == ring kernel on the paginated cache, bit for bit (7 slots)")
        check_decode_batch_invariance(ops, qp, kp, vp, bt, tv, pair)
        keys = int((tv + 1).sum())               # keys 0..t[b] of each row
        kv_bytes = 2 * keys * HKV * HD * kp.element_size()
        record("decode_attention_pair_paged", dtype, err,
               lambda: ops.decode_attention_pair_paged(qp, kp, vp, bt, tv),
               lambda: ops.decode_attention_pair_paged_plain(qp, kp, vp, bt, tv),
               2 * nbytes(qp) + 2 * kv_bytes + nbytes(bt, tv),
               2 * 4 * keys * HKV * G * HD)
        record("decode_attention_paged", dtype, err1,
               lambda: ops.decode_attention_paged(qp[0], kp[0], vp[0], bt, tv),
               lambda: ops.decode_attention_paged_plain(qp[0], kp[0], vp[0], bt, tv),
               2 * nbytes(qp[0]) + kv_bytes + nbytes(bt, tv),
               4 * keys * HKV * G * HD)

        log(f"[kernels] ssm_scan {dtype}")
        # generate's pair and single-layer prefill, one engine admission of
        # 97 tokens, and RG-LRU's width (N = 1).
        for what, (R, Ss, C, N) in (("pair", (2 * B, S, DI, NS)),
                                     ("single", (B, S, DI, NS)),
                                     ("engine", (1, 97, DI, NS)),
                                     ("rglru", (4, 128, 4096, 1))):
            a = (0.5 + 0.5 * torch.rand((R, Ss, C, N), generator=gen, device=dev)).to(dtype)
            bb = rand(R, Ss, C, N, dtype=dtype)
            h0 = rand(R, C, N, dtype=torch.float32)
            y, h = ops.ssm_scan(a, bb, h0)
            ry, rh = ops.ssm_scan_plain(a, bb, h0)
            err = max(compare(f"ssm_scan {what} {list(a.shape)} y", y, ry, tol),
                      compare(f"ssm_scan {what} h_S", h, rh, tol))
            if dtype == torch.float32:
                if not (torch.equal(y, ry) and torch.equal(h, rh)):
                    raise AssertionError(f"ssm_scan {what}: fp32 kernel differs from "
                                         "its plain version")
                y1, h1 = ops.ssm_scan(a[:, :64].contiguous(), bb[:, :64].contiguous(), h0)
                y2, h2 = ops.ssm_scan(a[:, 64:].contiguous(), bb[:, 64:].contiguous(), h1)
                if not (torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)):
                    raise AssertionError(f"ssm_scan {what}: two calls split at s = 64 "
                                         "differ from one call")
                log(f"  ssm_scan {what}: == plain bit for bit; split at s = 64 == one call")
            del y, h, ry, rh
            # bytes: a, b and y once each, h0 and h_S; 2 flops per element-step
            nb, fl = 3 * nbytes(a) + 2 * nbytes(h0), 2 * a.numel()
            if what == "pair":
                record("ssm_scan", dtype, err, lambda: ops.ssm_scan(a, bb, h0),
                       lambda: ops.ssm_scan_plain(a, bb, h0), nb, fl,
                       flops_peak=PEAK_OPS["float32"])
            else:
                b_ms, b_by = bound(nb, fl, "float32")
                log(f"  ssm_scan {what}: ms={time_ms(lambda: ops.ssm_scan(a, bb, h0)):.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by})")
                record("ssm_scan", dtype, err, None, None, 0, 0)
            del a, bb, h0
        torch.cuda.empty_cache()
    return rows


def two_rms_norms(x, sa, sb):
    """The dual RMSNorm's yardstick: ``F.rms_norm`` once per path. No single
    PyTorch call computes both norms; the port never calls this."""
    import torch.nn.functional as F
    return lambda: (F.rms_norm(x, (x.shape[-1],), sa, NORM_EPS),
                    F.rms_norm(x, (x.shape[-1],), sb, NORM_EPS))


def norm_times(ops, noop=None):
    """The dual RMSNorm at every ``NORM_SHAPES`` entry: held against its
    plain version in fp32 and bf16, and timed in bf16 beside it and two
    ``F.rms_norm`` calls: back to back (``time_ms``), and between the path's
    neighbours (``between_ms``: a residual add before it and a GEMM of the
    pair's ``[2, D, D]`` shape after it in one graph, less the time of the
    add and the GEMM alone). With ``noop(pdl)``, the empty kernel is timed
    between the same neighbours, launched plainly and as the dual RMSNorm
    is (programmatic dependent launch): the floors of the two launches."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = []
    for d, m in NORM_SHAPES:
        errs = {}
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            x, sa, sb = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                         for shape in ((m, d), (d,), (d,)))
            got, want = ops.dual_rmsnorm(x, sa, sb), ops.dual_rmsnorm_plain(x, sa, sb)
            errs[dtype] = max(compare(f"dual_rmsnorm {str(dtype)[6:]} D={d} M={m} {half}",
                                      got[i], want[i], tol) for i, half in enumerate("ab"))
        b_ms, b_by = bound(nbytes(x, sa, sb) + 2 * nbytes(x), 6 * m * d, "float32")
        e = {"D": d, "M": m, "max_abs_err": errs[torch.bfloat16],
             "fp32_max_abs_err": errs[torch.float32],
             "ms": time_ms(lambda: ops.dual_rmsnorm(x, sa, sb)),
             "plain_ms": time_ms(lambda: ops.dual_rmsnorm_plain(x, sa, sb)),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(two_rms_norms(x, sa, sb))}
        h = torch.randn((m, d), generator=gen, device="cuda").to(x.dtype)
        w = torch.randn((2, d, d), generator=gen, device="cuda").to(x.dtype)
        y0 = torch.empty((2, m, d), dtype=x.dtype, device="cuda")

        def least(fn):   # the GEMM's time spreads by tenths of a microsecond
            return min(time_ms(fn) for _ in range(3))

        base = least(lambda: (x + h, torch.matmul(y0, w)))

        def between(fn):
            return least(lambda: torch.matmul(fn(x + h), w)) - base

        e["between_ms"] = between(lambda r: ops.dual_rmsnorm(r, sa, sb))
        if noop is not None:
            e["floor_between_ms"] = between(lambda r: (noop(False), y0)[1])
            e["floor_pdl_between_ms"] = between(lambda r: (noop(True), y0)[1])
        log(f"  dual_rmsnorm bf16 D={d} M={m}: " + " ".join(
            f"{k}={v:.5f}" for k, v in e.items() if k.endswith("ms")) + f" ({b_by})")
        out.append(e)
    return out


def check_norm_rows(ops, rand, dtype):
    """Each dual RMSNorm row equals, bit for bit, the same row launched
    alone (M = 1), inside an 8-row launch and at three offsets of a
    2048-row launch (8 rows x a 256-token bucket), plus_one both ways: at
    D = 2048 and 4096, and at D = 100, where the scales are the two rows of
    a [2, D] pair as the model slices them (in bf16 the second starts 200
    bytes in: element-wise loads), also held against the plain version. A
    16-byte-misaligned sb gives the bits of an aligned copy."""
    import torch
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    offsets = (0, 1001, 2040)
    for d in (2048, 4096, 100):
        scales = rand(2, d, dtype=dtype)
        sa, sb = scales[0], scales[1]
        x8, big = rand(8, d, dtype=dtype), rand(2048, d, dtype=dtype)
        for o in offsets:
            big[o:o + 8] = x8
        for plus_one in (False, True):
            y8 = ops.dual_rmsnorm(x8, sa, sb, plus_one=plus_one)
            want = ops.dual_rmsnorm_plain(x8, sa, sb, plus_one=plus_one)
            compare(f"dual_rmsnorm D={d} M=8 plus_one={plus_one}", y8, want, tol)
            wide = ops.dual_rmsnorm(big, sa, sb, plus_one=plus_one)
            for i in range(8):
                alone = ops.dual_rmsnorm(x8[i:i + 1], sa, sb, plus_one=plus_one)
                if not torch.equal(alone, y8[:, i:i + 1]):
                    raise AssertionError(f"dual_rmsnorm {dtype} D={d}: row {i} alone "
                                         f"differs from the 8-row launch")
            for o in offsets:
                if not torch.equal(wide[:, o:o + 8], y8):
                    raise AssertionError(f"dual_rmsnorm {dtype} D={d}: rows at {o} of "
                                         f"a 2048-row launch differ from the 8-row launch")
    d = 2048
    x8, sa = rand(8, d, dtype=dtype), rand(d, dtype=dtype)
    sb = rand(d + 1, dtype=dtype)[1:]        # 2 or 4 bytes past a 16-byte line
    if not torch.equal(ops.dual_rmsnorm(x8, sa, sb), ops.dual_rmsnorm(x8, sa, sb.clone())):
        raise AssertionError(f"dual_rmsnorm {dtype}: a misaligned sb changes the bits")
    log(f"  dual_rmsnorm rows {dtype}: alone == in 8 rows == at {offsets} of 2048 rows, "
        f"bit for bit (D = 2048, 4096, 100; plus_one both ways); misaligned sb == "
        f"aligned copy")


def check_flash_padding(ops, q, k, v, rand):
    """Right-padding is bit-transparent (causal, block_n = 16): the rows
    below Lq of the S = 128 launch equal the launch cut to Lq, bit for bit,
    also when the keys and values at and past Lq hold large finite junk."""
    import torch
    full = ops.flash_attention(q, k, v, block_n=16)
    for lq in (37, 64, 100):
        cut = ops.flash_attention(q[:, :lq], k[:, :lq], v[:, :lq], block_n=16)
        kj, vj = k.clone(), v.clone()
        kj[:, lq:] = 1e4 * rand(*kj[:, lq:].shape, dtype=k.dtype)
        vj[:, lq:] = 1e4 * rand(*vj[:, lq:].shape, dtype=v.dtype)
        junk = ops.flash_attention(q, kj, vj, block_n=16)[:, :lq]
        if not (torch.equal(cut, full[:, :lq]) and torch.equal(cut, junk)):
            raise AssertionError(f"flash {q.dtype}: rows below Lq={lq} depend on "
                                 f"the keys past Lq")
    log(f"  flash padding {q.dtype}: rows below Lq in (37, 64, 100) == launch "
        f"cut to Lq, with and without junk past Lq, bit for bit")


def check_decode_batch_invariance(ops, qp, kp, vp, bt, tv, pair):
    """Each row of the 8-slot paged pair launch ``pair`` equals, bit for
    bit, the same row launched alone (B = 1) and inside a 40-row launch
    (the 8 rows five times: the speculative verifier's width at k = 4)."""
    import torch
    n = bt.shape[0]
    for b in range(n):
        alone = ops.decode_attention_pair_paged(qp[:, b:b + 1], kp, vp,
                                                bt[b:b + 1], tv[b:b + 1])
        if not torch.equal(alone, pair[:, b:b + 1]):
            raise AssertionError(f"paged decode row {b} alone differs from the "
                                 f"{n}-row launch")
    wide = ops.decode_attention_pair_paged(torch.cat([qp] * 5, 1), kp, vp,
                                           torch.cat([bt] * 5), torch.cat([tv] * 5))
    for i in range(5):
        if not torch.equal(wide[:, i * n:(i + 1) * n], pair):
            raise AssertionError(f"paged decode rows in a {5 * n}-row launch "
                                 f"differ from the {n}-row launch")
    log(f"  decode batch invariance {qp.dtype}: each of {n} rows == alone "
        f"(B = 1) == inside a {5 * n}-row launch, bit for bit")


# ---------------------------------------------------------------------------
# phase 4: reduced config, card against CPU
# ---------------------------------------------------------------------------

def reduced_parity():
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    base = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    for n_kv in (base.n_kv_heads, 1):   # g = 1 as reduced, and a GQA group of 4
        cfg = dataclasses.replace(base, n_kv_heads=n_kv)
        ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 4))
        p_cpu = T.init_params(ms, torch.Generator().manual_seed(SEED),
                              torch.float32, device="cpu")
        p_gpu = copy.deepcopy(p_cpu).to("cuda")   # the same weights, on the card
        prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                                generator=torch.Generator().manual_seed(SEED + 1))
        sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
        lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts)
        lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda())
        err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv)
        tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv).cpu()
        same = bool((tok_cpu == tok_gpu).all())
        log(f"[reduced] n_kv_heads={n_kv} pairs={ms.plan.pairs}: prefill logits "
            f"max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); greedy tokens equal: {same}")
        if err > LOGIT_TOL or not same:
            raise AssertionError(f"reduced parity failed: logits err {err:.3e}, "
                                 f"tokens\n{tok_cpu}\n{tok_gpu}")
        # The continuous-batching engine: card == generate on the card ==
        # the engine on the CPU, token for token.
        work = reduced_traffic(cfg.vocab_size)
        psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=48,
                               cache_dtype=torch.float32, prefix_cache=True)
        eng = PagedEngine(p_gpu, ms, psv)
        got = serve(eng, work)
        cpu = serve(PagedEngine(p_cpu, ms, psv), work)
        ref = [generate(p_gpu, torch.from_numpy(p).cuda()[None], n, ms=ms, pc=pc,
                        sv=sv)[0].cpu().numpy() for _, p, n in work]
        n_gen = sum(a.tolist() == b.tolist() for a, b in zip(got, ref))
        n_cpu = sum(a.tolist() == b.tolist() for a, b in zip(got, cpu))
        c = eng.counters
        log(f"[reduced] engine n_kv_heads={n_kv}: {len(work)} requests, "
            f"prefix hits {c['prefix_hits']}, bucket launches {c['bucket_groups']}; "
            f"streams equal to generate on the card {n_gen}/{len(work)}, "
            f"to the engine on the CPU {n_cpu}/{len(work)}")
        if n_gen != len(work) or n_cpu != len(work) or not c["prefix_hits"]:
            raise AssertionError("reduced engine parity failed")


def reduced_mamba_parity():
    """falcon-mamba cut to 4 layers, LP pairs (0,1), (2,3), fp32 weights and
    caches: the card against the CPU for ``generate`` and the engine, and
    the engine against ``generate`` on the card, with staggered traffic and
    with a preempted request (resumed by a full re-prefill and a replay)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    cfg = reduced_config(get_config(MAMBA), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 4))
    p_cpu = T.init_params(ms, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(SEED + 1))
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts)
    lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda())
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv)
    tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv).cpu()
    same = bool((tok_cpu == tok_gpu).all())
    log(f"[reduced] {cfg.name} pairs={ms.plan.pairs}: prefill logits "
        f"max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); greedy tokens equal: {same}")
    if err > LOGIT_TOL or not same:
        raise AssertionError(f"reduced mamba parity failed: logits err {err:.3e}, "
                             f"tokens\n{tok_cpu}\n{tok_gpu}")
    rng = np.random.default_rng(SEED + 4)
    preempt = [(0, rng.integers(0, cfg.vocab_size, 8), 20),
               (0, rng.integers(0, cfg.vocab_size, 8), 20),
               (4, rng.integers(0, cfg.vocab_size, 8), 4)]
    for name, work, psv in (
            ("staggered", reduced_traffic(cfg.vocab_size),
             PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=48,
                              cache_dtype=torch.float32, prefix_cache=True)),
            ("preempted", preempt,
             PagedServeConfig(n_slots=4, page_size=8, n_pages=9, max_len=32,
                              cache_dtype=torch.float32, prefix_cache=True,
                              preempt_after=2))):
        eng = PagedEngine(p_gpu, ms, psv)
        got = serve(eng, work)
        cpu = serve(PagedEngine(p_cpu, ms, psv), work)
        gsv = ServeConfig(max_len=psv.max_len, cache_dtype=torch.float32)
        ref = [generate(p_gpu, torch.from_numpy(p).cuda()[None], n, ms=ms, pc=pc,
                        sv=gsv)[0].cpu().numpy() for _, p, n in work]
        n_gen = sum(a.tolist() == b.tolist() for a, b in zip(got, ref))
        n_cpu = sum(a.tolist() == b.tolist() for a, b in zip(got, cpu))
        c = eng.counters
        log(f"[reduced] {cfg.name} engine, {name}: {len(work)} requests, "
            f"{c['full_prefills']} exact prefills, preemptions "
            f"{eng.sched.preemptions_total}, replayed tokens {c['replay_tokens']}; "
            f"streams equal to generate on the card {n_gen}/{len(work)}, to the "
            f"engine on the CPU {n_cpu}/{len(work)}")
        if n_gen != len(work) or n_cpu != len(work) or eng.prefix is not None \
                or c["bucket_groups"]:
            raise AssertionError(f"reduced mamba engine parity failed ({name})")
        if name == "preempted" and not (eng.sched.preemptions_total
                                        and c["replay_tokens"]):
            raise AssertionError("the reduced mamba engine preempted nothing")


def reduced_traffic(vocab):
    """10 requests of the reduced engine check: 4 sharing a 16-token
    prefix, 6 cold, in staggered waves (submit step, prompt, max_new)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    shared = rng.integers(0, vocab, 16)
    fam = [np.concatenate([shared, rng.integers(0, vocab, n)]) for n in (5, 8, 11, 2)]
    cold = [rng.integers(0, vocab, n) for n in (3, 9, 17, 24, 30, 12)]
    prompts = [fam[0], cold[0], cold[1], fam[1], cold[2], cold[3], fam[2],
               cold[4], fam[3], cold[5]]
    return list(zip([0, 0, 0, 1, 1, 1, 2, 2, 4, 4], prompts,
                    [6, 4, 7, 5, 8, 3, 6, 5, 4, 7]))


def serve(eng, work, step_log=None):
    """Drive a PagedEngine through (submit step, prompt, max_new) traffic;
    returns the streams in submission order. ``step_log`` receives
    (seconds, stats) per step, each step ending with its tokens on the
    host."""
    rids, i = [], 0
    while i < len(work) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(work) and work[i][0] <= eng.step_count:
            rids.append(eng.add_request(work[i][1], work[i][2]))
            i += 1
        t0 = time.perf_counter()
        stats = eng.step()
        if step_log is not None:
            step_log.append((time.perf_counter() - t0, stats))
    return [eng.results[r] for r in rids]


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def main_path():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, make_prefill

    pc = ParallelContext()
    cfg = get_config("tinyllama-1.1b")
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 16))
    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    n_single = n_groups - n_pairs
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, pairs {ms.plan.pairs}, "
        f"{n_groups} groups")
    assert (n_groups, n_pairs) == (16, 6), (n_groups, n_pairs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(ms, gen, torch.bfloat16, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.bfloat16)

    generate(params, prompts, 2, ms=ms, pc=pc, sv=sv)   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    out = generate(params, prompts, N_NEW, ms=ms, pc=pc, sv=sv, timings=timings)
    launches = dict(ops.LAUNCHES)

    steps = N_NEW - 1
    want = {"flash_attention": n_groups,
            "dual_rmsnorm": 2 * n_pairs * (1 + steps),
            "decode_attention": steps * n_single,
            "decode_attention_pair": steps * n_pairs,
            "decode_attention_paged": 0, "decode_attention_pair_paged": 0,
            "ssm_scan": 0}
    log(f"[main] launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    logits, caches = make_prefill(ms, pc, sv)(params, prompts)
    if tuple(out.shape) != (B, N_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    tok0 = logits.argmax(-1)
    if not bool((tok0 == out[:, 0]).all()):
        raise AssertionError("first generated token is not the prefill argmax")
    # One decode step against the prefill cache vs a prefill of the longer
    # prompt: the same logits up to bf16 rounding of two different paths.
    step_logits, _ = T.decode_step(params, tok0, caches, S, ms=ms, pc=pc)
    longer = torch.cat([prompts, tok0[:, None]], dim=1)
    full_logits, _, _ = T.forward_full(params, longer, ms=ms, pc=pc,
                                       attn_impl=sv.attn_impl)
    scale = full_logits[:, -1].abs().max().item()
    diff = (step_logits - full_logits[:, -1]).abs().max().item()
    log(f"[main] decode-step vs prefill logits: max_abs_diff={diff:.4f} "
        f"(logit scale {scale:.3f}, tol 0.1 x scale)")
    if diff > 0.1 * scale:
        raise AssertionError("decode step disagrees with prefill of the same stream")
    # Both from the one measured generate above.
    e2e = {"prefill_ms": timings["prefill_s"] * 1e3,
           "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
           "decode_tok_per_s": B * steps / timings["decode_s"]}
    log("[main] " + " ".join(f"{k}={v:.3f}" for k, v in e2e.items()))
    e2e["busy_share"] = profile_decode(
        lambda: generate(params, prompts, 9, ms=ms, pc=pc, sv=sv))
    return launches, e2e


def profile_decode(run, what="generate(9 new)"):
    """Device busy share and kernel time by name over a short run (a
    generate of a prefill and 8 decode steps, or 8 engine steps), from
    torch.profiler. Returns the busy share, or None when not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        log("[profile] device time not measured: the profiler saw no device events")
        return None
    log(f"[profile] {what} wall_ms={wall_us / 1e3:.3f} device_busy_ms="
        f"{busy_us / 1e3:.3f} busy_share={busy_us / wall_us:.4f} "
        f"kernels={sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy_us:6.1%}  {name[:90]}")
    return busy_us / wall_us


# ---------------------------------------------------------------------------
# phase 6: the continuous-batching engine at full width
# ---------------------------------------------------------------------------

def engine_traffic(vocab):
    """16 requests in two waves of 8 (the second 4 steps after the first),
    32 new tokens each: 8 share a 64-token prefix (4 pages) and add their
    own 16-96-token suffix, 8 are cold at 24-160 tokens. The second wave's
    hit suffixes and cold prompts fall into common buckets (32, 64, 128),
    so hit and cold rows share bucket launches."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, vocab, 64)
    fam = [np.concatenate([prefix, rng.integers(0, vocab, n)])
           for n in (16, 40, 60, 96, 20, 44, 64, 90)]
    cold = [rng.integers(0, vocab, n) for n in (24, 50, 100, 160, 30, 52, 110, 150)]
    wave1 = [p for pair in zip(fam[:4], cold[:4]) for p in pair]
    wave2 = [p for pair in zip(fam[4:], cold[4:]) for p in pair]
    return [(0, p, ENGINE_NEW) for p in wave1] + [(4, p, ENGINE_NEW) for p in wave2]


def engine_config(cache_dtype):
    from repro_torch.serve import PagedServeConfig
    return PagedServeConfig(n_slots=N_SLOTS, page_size=PS, max_len=MAX_LEN,
                            n_pages=N_PAGES, prefix_cache=True,
                            cache_dtype=cache_dtype)


def shared_bucket_launches(eng):
    """(hit rows, cold rows) of every bucket launch that held both, from
    the engine's prefill spans: one launch per (step, bucket) group here,
    since every group fits the program's rows."""
    from repro_torch.serve import bucket_for
    groups = {}
    for span in eng.telemetry.spans.values():
        for e in span.events_of("prefill"):
            if e.attrs.get("batched"):
                key = (e.step, bucket_for(e.attrs["tokens"], eng._buckets))
                groups.setdefault(key, []).append(e.attrs["kind"])
    return [(kinds.count("suffix"), kinds.count("full"))
            for kinds in groups.values()
            if "suffix" in kinds and "full" in kinds]


def first_divergence(params, ms, pc, prompt, want, got):
    """First position where the engine's stream leaves generate()'s, and
    the top-2 margin and scale of generate's logits there (its own
    prefill + decode_step path)."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.serve import ServeConfig, make_prefill
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    x = torch.from_numpy(prompt).cuda()[None]
    logits, caches = make_prefill(ms, pc, sv)(params, x)
    for j in range(i):
        tok = torch.tensor([int(want[j])], device="cuda")
        logits, caches = T.decode_step(params, tok, caches, len(prompt) + j,
                                       ms=ms, pc=pc)
    top = logits[0].float().topk(2).values
    return i, float(top[0] - top[1]), float(logits[0].abs().max())


def engine_path():
    """Returns (kernel launches of the timed run, engine metrics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, ServeConfig, default_buckets,
                                   generate)

    pc = ParallelContext()
    cfg = get_config("tinyllama-1.1b")
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 16))
    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    work = engine_traffic(cfg.vocab_size)
    log(f"[engine] {cfg.name} LP {ms.plan.pairs}: {len(work)} requests, "
        f"{N_SLOTS} slots, pages of {PS}, {N_PAGES} pages, buckets "
        f"{default_buckets(MAX_LEN, PS)}")

    # Parity run: bf16 weights, fp32 pool, streams against generate().
    eng = PagedEngine(params, ms, engine_config(torch.float32))
    got = serve(eng, work)
    shared = shared_bucket_launches(eng)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    n_equal, worst = 0, 0.0
    for (_, prompt, n), stream in zip(work, got):
        want = generate(params, torch.from_numpy(prompt).cuda()[None], n, ms=ms,
                        pc=pc, sv=sv)[0].cpu().numpy()
        if want.tolist() == stream.tolist():
            n_equal += 1
            continue
        i, margin, scale = first_divergence(params, ms, pc, prompt, want, stream)
        worst = max(worst, margin / scale)
        log(f"[engine] stream of a {len(prompt)}-token prompt leaves generate at "
            f"token {i}: top-2 margin {margin:.5f} of logit scale {scale:.3f} "
            f"({margin / scale:.5f}, limit {MARGIN_FRAC})")
    log(f"[engine] parity (fp32 pool): {n_equal}/{len(work)} streams equal to "
        f"generate on the card; bucket launches holding hit and cold rows "
        f"(hit, cold): {shared}")
    if worst > MARGIN_FRAC:
        raise AssertionError("an engine stream diverged from generate away from "
                             "a near-tie")
    if not shared:
        raise AssertionError("no bucket launch held both a radix-hit row and a "
                             "cold row")

    # Timed run: bf16 pool, every kernel launch counted.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    serve(eng, work[:N_SLOTS])                      # warm-up: one wave
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    c = dict(eng.counters)
    exact = c["full_prefills"] + c["suffix_prefills"] - c["bucket_prefills"]
    prefill_launches = c["bucket_groups"] + exact
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    want = {"dual_rmsnorm": 2 * n_pairs * (prefill_launches + decode_launches),
            "decode_attention": 0, "decode_attention_pair": 0,
            "decode_attention_paged": (n_groups - n_pairs) * decode_launches,
            "decode_attention_pair_paged": n_pairs * decode_launches,
            "flash_attention": n_groups * prefill_launches, "ssm_scan": 0}
    log(f"[engine] launches {launches} (want {want}; {prefill_launches} prefill "
        f"and {decode_launches} decode launches by the engine's counters)")
    if launches != want:
        raise AssertionError(f"engine launch counts {launches} != {want}")
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size
           for o in out):
        raise AssertionError("engine streams of the wrong length or out of range")
    resident = eng.prefix.resident_pages
    live = eng.pool.live
    eng.prefix.evict(resident, eng.pool)          # nothing holds a page now
    eng.pool.check_balance()
    log(f"[engine] after drain: pool.live {live} == radix-resident {resident}; "
        f"after evicting the tree pool.live {eng.pool.live}")
    if live != resident or eng.pool.live != 0:
        raise AssertionError("pages still held after drain")
    dec = [dt for dt, st in steps if st["decoded"] and not st["admitted"]]
    dec_tokens = sum(st["decoded"] for _, st in steps
                     if st["decoded"] and not st["admitted"])
    metrics = {"wall_ms": wall_s * 1e3, "steps": len(steps),
               "decode_ms_per_step": sum(dec) / len(dec) * 1e3,
               "decode_tok_per_s": dec_tokens / sum(dec),
               "decoded": c["decoded"],
               "prefill_launches": {"bucket": c["bucket_groups"], "exact": exact},
               "prefix_hits": c["prefix_hits"], "hit_tokens": c["hit_tokens"],
               "pad_tokens": c["pad_tokens"],
               "parity_streams_equal": n_equal, "parity_streams": len(work),
               "shared_bucket_launches": len(shared)}
    log("[engine] " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in metrics.items()))

    # Profiled window: 8 decode steps with all slots running.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    for _, prompt, n in work[:N_SLOTS]:
        eng.add_request(prompt, n)
    eng.step()
    eng.step()
    metrics["busy_share"] = profile_decode(lambda: [eng.step() for _ in range(8)],
                                           "engine 8 decode steps")
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 7: the Mamba path at full width
# ---------------------------------------------------------------------------

def mamba_model():
    """falcon-mamba-7b under plan_for_depth(48), fp32 random weights from
    the seed, made on the card (``init_params`` draws in fp32 and casts, so
    a later cast to bf16 gives the weights a bf16 init would)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    cfg = get_config(MAMBA)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, MAMBA_EFF_DEPTH))
    n_groups = sum(s.count for s in ms.segments)
    if (n_groups, len(ms.plan.pairs)) != (48, 16) or cfg.d_inner != DI:
        raise AssertionError(f"{cfg.name}: {n_groups} groups, pairs {ms.plan.pairs}")
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.float32, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    log(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, N {cfg.ssm_state}, vocab {cfg.vocab_size}; pairs "
        f"{ms.plan.pairs[0]}..{ms.plan.pairs[-1]} ({len(ms.plan.pairs)}), "
        f"{n_groups} groups; {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, ms, params


def mamba_generate(cfg, ms, params):
    """The Mamba model through ``generate``: B = 4 prompts of 128, 64 new.
    Returns (launches, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, make_prefill

    pc = ParallelContext()
    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 5),
                            device="cuda")
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.bfloat16)
    generate(params, prompts, 2, ms=ms, pc=pc, sv=sv)   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    out = generate(params, prompts, N_NEW, ms=ms, pc=pc, sv=sv, timings=timings)
    launches = dict(ops.LAUNCHES)
    steps = N_NEW - 1
    want = {name: 0 for name in launches}
    want.update(ssm_scan=n_groups, dual_rmsnorm=n_pairs * (1 + steps))
    log(f"[mamba] generate launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"mamba generate launch counts {launches} != {want}")

    logits, caches = make_prefill(ms, pc, sv)(params, prompts)
    if tuple(out.shape) != (B, N_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    dtypes = {(name, str(e.dtype)) for seg in caches for name, e in seg.items()}
    if dtypes != {("conv0", "torch.bfloat16"), ("h0", "torch.float32"),
                  ("conv", "torch.bfloat16"), ("h", "torch.float32")}:
        raise AssertionError(f"cache entries {sorted(dtypes)}")
    tok0 = logits.argmax(-1)
    if not bool((tok0 == out[:, 0]).all()):
        raise AssertionError("first generated token is not the prefill argmax")
    # One decode step on the prefill state vs a prefill of the longer
    # prompt: the recurrence by steps against the scan kernel.
    step_logits, _ = T.decode_step(params, tok0, caches, S, ms=ms, pc=pc)
    longer = torch.cat([prompts, tok0[:, None]], dim=1)
    full_logits, _, _ = T.forward_full(params, longer, ms=ms, pc=pc,
                                       attn_impl=sv.attn_impl)
    scale = full_logits[:, -1].abs().max().item()
    diff = (step_logits - full_logits[:, -1]).abs().max().item()
    log(f"[mamba] decode-step vs prefill logits: max_abs_diff={diff:.4f} "
        f"(logit scale {scale:.3f}, tol 0.1 x scale)")
    if diff > 0.1 * scale:
        raise AssertionError("mamba decode step disagrees with prefill of the same stream")
    del logits, caches, step_logits, full_logits
    e2e = {"prefill_ms": timings["prefill_s"] * 1e3,
           "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
           "decode_tok_per_s": B * steps / timings["decode_s"]}
    log("[mamba] generate " + " ".join(f"{k}={v:.3f}" for k, v in e2e.items()))
    e2e["busy_share"] = profile_decode(
        lambda: generate(params, prompts, 9, ms=ms, pc=pc, sv=sv),
        "mamba generate(9 new)")
    return launches, e2e


def mamba_engine_parity(cfg, ms, params):
    """fp32 weights and pool: the engine's streams against ``generate``'s on
    the card, with phase 6's traffic. Returns the count of equal streams."""
    import torch
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import PagedEngine, ServeConfig, generate

    pc = ParallelContext()
    work = engine_traffic(cfg.vocab_size)
    eng = PagedEngine(params, ms, engine_config(torch.float32))
    if eng.prefix is not None or eng._buckets:
        raise AssertionError("prefix cache or bucket ladder on for a recurrent mixer")
    got = serve(eng, work)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    n_equal, worst = 0, 0.0
    for (_, prompt, n), stream in zip(work, got):
        want = generate(params, torch.from_numpy(prompt).cuda()[None], n, ms=ms,
                        pc=pc, sv=sv)[0].cpu().numpy()
        if want.tolist() == stream.tolist():
            n_equal += 1
            continue
        i, margin, scale = first_divergence(params, ms, pc, prompt, want, stream)
        worst = max(worst, margin / scale)
        log(f"[mamba] stream of a {len(prompt)}-token prompt leaves generate at "
            f"token {i}: top-2 margin {margin:.5f} of logit scale {scale:.3f} "
            f"({margin / scale:.5f}, limit {MARGIN_FRAC})")
    log(f"[mamba] engine parity (fp32 weights and pool): {n_equal}/{len(work)} "
        f"streams equal to generate on the card")
    if worst > MARGIN_FRAC:
        raise AssertionError("a mamba engine stream diverged from generate away "
                             "from a near-tie")
    return n_equal


def mamba_engine(cfg, ms, params):
    """The Mamba model (bf16) behind ``PagedEngine`` with phase 6's geometry
    and traffic. Returns (launches of the timed run, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import PagedEngine

    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    work = engine_traffic(cfg.vocab_size)

    # Timed run: bf16 pool (the state h stays fp32), every launch counted.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    serve(eng, work[:2])                            # warm-up
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    c = dict(eng.counters)
    prefills = c["full_prefills"]
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    want = {name: 0 for name in launches}
    want.update(ssm_scan=n_groups * prefills,
                dual_rmsnorm=n_pairs * (prefills + decode_launches))
    log(f"[mamba] engine launches {launches} (want {want}; {prefills} exact "
        f"prefills for {c['admitted']} admissions, {decode_launches} decode launches)")
    if launches != want:
        raise AssertionError(f"mamba engine launch counts {launches} != {want}")
    if (prefills != c["admitted"] or c["bucket_groups"] or c["suffix_prefills"]
            or c["prefix_hits"]):
        raise AssertionError(f"mamba engine prefills not all exact and cold: {c}")
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size
           for o in out):
        raise AssertionError("engine streams of the wrong length or out of range")
    if eng.pool.live != 0:
        raise AssertionError("pages still held after drain")
    dec = [dt for dt, st in steps if st["decoded"] and not st["admitted"]]
    dec_tokens = sum(st["decoded"] for _, st in steps
                     if st["decoded"] and not st["admitted"])
    metrics = {"wall_ms": wall_s * 1e3, "steps": len(steps),
               "decode_ms_per_step": sum(dec) / len(dec) * 1e3,
               "decode_tok_per_s": dec_tokens / sum(dec),
               "decoded": c["decoded"],
               "prefill_launches": {"bucket": 0, "exact": prefills},
               "prefix_hits": c["prefix_hits"]}
    log("[mamba] engine " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in metrics.items()))

    # Profiled window: 8 decode steps with all slots running.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    for _, prompt, n in work[:N_SLOTS]:
        eng.add_request(prompt, n)
    eng.step()
    eng.step()
    metrics["busy_share"] = profile_decode(lambda: [eng.step() for _ in range(8)],
                                           "mamba engine 8 decode steps")
    return launches, metrics


# ---------------------------------------------------------------------------

KERNELS = {
    "dual_rmsnorm": ("cuda", "src/repro_torch/csrc/dual_rmsnorm.cu",
                     "src/repro/kernels/dual_rmsnorm.py:37"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:130"),
    "decode_attention_pair": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:142"),
    "decode_attention_paged": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:258"),
    "decode_attention_pair_paged": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:273"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:92"),
    "ssm_scan": ("cuda", "src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:50"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build   # fails outside a checkout of the repo
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in per_source.items()) or 'cached'})")
    for src in build.SOURCES:
        for line in build.library_path(src).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    if sys.argv[1:] == ["--norm-times"]:
        from repro_torch.kernels import ops
        print(json.dumps({"norm_times": norm_times(ops), "smi": smi.splitlines()[0]}))
        return 0
    rows = check_kernels()
    reduced_parity()
    reduced_mamba_parity()
    by_path = {}                              # each path reads its own counts
    by_path["generate"], e2e = main_path()
    by_path["engine"], engine = engine_path()
    gc.collect()
    torch.cuda.empty_cache()                  # the tinyllama weights are gone
    cfg, ms, params = mamba_model()
    n_equal = mamba_engine_parity(cfg, ms, params)
    params.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mamba_generate"], mamba_gen = mamba_generate(cfg, ms, params)
    by_path["mamba_engine"], mamba_eng = mamba_engine(cfg, ms, params)
    mamba_eng.update(parity_streams_equal=n_equal,
                     parity_streams=len(engine_traffic(cfg.vocab_size)))
    del params
    for name in KERNELS:
        if not sum(p[name] for p in by_path.values()):
            raise AssertionError(f"{name} was launched on no main path")
    for path in ("mamba_generate", "mamba_engine"):
        if not by_path[path]["ssm_scan"]:
            raise AssertionError(f"ssm_scan was not launched on {path}")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        # Times in the type the paths launch: bf16, except the scan, whose
        # operands ssm_mix builds in fp32 whatever the weights' type.
        dtype = torch.float32 if name == "ssm_scan" else torch.bfloat16
        r = rows[(name, dtype)]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "dtype": str(dtype).split(".")[1],
                        "launches": sum(p[name] for p in by_path.values()),
                        "launches_by_path": {k: p[name] for k, p in by_path.items()},
                        "max_abs_err": max(rows[(name, d)]["max_abs_err"]
                                           for d in (torch.bfloat16, torch.float32)),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if name == "flash_attention":
            kernels[-1]["engine_bucket"] = rows[("flash_attention_bucket", dtype)]
        if name == "dual_rmsnorm":
            kernels[-1].update(library="two F.rms_norm calls, one per path (timed only)",
                               shapes=rows["dual_rmsnorm_shapes"])
    print(json.dumps({"kernels": kernels, "launch_floor_ms": rows["launch_floor_ms"],
                      "launch_floor_pdl_ms": rows["launch_floor_pdl_ms"],
                      **e2e, "engine": engine,
                      "mamba": {"generate": mamba_gen, "engine": mamba_eng}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
