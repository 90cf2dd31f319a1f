"""The port's hand-written kernels against their plain versions (and the
paged kernel against the ring kernel and, with a head map, against the
identity launch on the gathered pool, the selective scan against its plain
version in fp32, bit for bit), the flash kernel's padding transparency, the
decode and dual RMSNorm kernels' batch invariance (bit for bit), the
engine against ``generate``, the speculative and degraded-cohort engines,
``rewind_tokens`` and the reduced hybrid and mixture-of-experts models
against their CPU runs, on an NVIDIA GPU (CUDA C++ has no CPU mode):
skipped elsewhere.

This file imports only torch and the port, so it runs on a machine without
JAX:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
Tolerances: atol = rtol = 2e-5 in fp32, 2e-2 in bf16.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# the kernels themselves (NVIDIA GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_gpu(cuda, dtype):
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    x, sa, sb = rand(40, 96), rand(96), rand(96)
    for got, want in zip(ops.dual_rmsnorm(x, sa, sb), ops.dual_rmsnorm_plain(x, sa, sb)):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    q, k, v = rand(2, 2, 4, 16), rand(2, 50, 2, 16), rand(2, 50, 2, 16)
    for t in (0, 20, 49):
        torch.testing.assert_close(ops.decode_attention(q, k, v, t),
                                   ops.decode_attention_plain(q, k, v, t),
                                   atol=tol, rtol=tol)
    q2, k2, v2 = rand(2, 2, 2, 4, 16), rand(2, 2, 50, 2, 16), rand(2, 2, 50, 2, 16)
    torch.testing.assert_close(ops.decode_attention_pair(q2, k2, v2, 33),
                               ops.decode_attention_pair_plain(q2, k2, v2, 33),
                               atol=tol, rtol=tol)
    q, k, v = rand(2, 37, 2, 4, 32), rand(2, 37, 2, 32), rand(2, 37, 2, 32)
    for kw in ({}, {"kind": "window", "window": 5}, {"kind": "chunk", "chunk": 8},
               {"kind": "bidir"}, {"prefix_len": 3}):
        torch.testing.assert_close(ops.flash_attention(q, k, v, block_n=16, **kw),
                                   ops.flash_attention_plain(q, k, v, **kw),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_matches_plain_on_gpu(cuda, dtype):
    """Mamba (N = 16) and RG-LRU (N = 1) widths, S and C off any tile
    size. In fp32 the kernel rounds as the plain version does: bit for bit.
    A sequence split across two calls equals one call."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(3)
    for R, S, C, N in ((2, 100, 48, 8), (1, 33, 16, 1), (3, 70, 130, 16)):
        a = (0.5 + 0.5 * torch.rand((R, S, C, N), generator=gen, device=cuda)).to(td)
        b = torch.randn((R, S, C, N), generator=gen, device=cuda).to(td)
        h0 = torch.randn((R, C, N), generator=gen, device=cuda)
        y, h = ops.ssm_scan(a, b, h0)
        ry, rh = ops.ssm_scan_plain(a, b, h0)
        assert y.dtype == td and h.dtype == torch.float32
        torch.testing.assert_close(y, ry, atol=tol, rtol=tol)
        torch.testing.assert_close(h, rh, atol=tol, rtol=tol)
        if td == torch.float32:
            assert torch.equal(y, ry) and torch.equal(h, rh)
        y1, h1 = ops.ssm_scan(a[:, :20].contiguous(), b[:, :20].contiguous(), h0)
        y2, h2 = ops.ssm_scan(a[:, 20:].contiguous(), b[:, 20:].contiguous(), h1)
        assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_scan(a[:, ::2], b[:, ::2], h0)


def _paginate(cache, ps):
    """Ring cache [P, B, L, H, hd] -> (pool [P, 1 + B*L/ps, ps, H, hd],
    block tables [B, L/ps] int32): slot b's pages are contiguous, after the
    garbage page 0."""
    P, B, L, H, hd = cache.shape
    n_pg = L // ps
    pool = torch.cat([torch.zeros((P, 1, ps, H, hd), dtype=cache.dtype,
                                  device=cache.device),
                      cache.reshape(P, B * n_pg, ps, H, hd)], dim=1)
    bt = 1 + torch.arange(B * n_pg, dtype=torch.int32,
                          device=cache.device).reshape(B, n_pg)
    return pool, bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_match_plain_and_ring_on_gpu(cuda, dtype):
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    B, L, H, G, hd, ps = 3, 48, 2, 4, 32, 16
    k, v = rand(2, B, L, H, hd), rand(2, B, L, H, hd)
    q = rand(2, B, H, G, hd)
    kp, bt = _paginate(k, ps)
    vp, _ = _paginate(v, ps)
    t = torch.tensor([40, 0, 17], dtype=torch.int32, device=cuda)
    bt[1] = 0                                   # an idle slot: garbage page
    got = ops.decode_attention_pair_paged(q, kp, vp, bt, t)
    torch.testing.assert_close(
        got, ops.decode_attention_pair_paged_plain(q, kp, vp, bt, t),
        atol=tol, rtol=tol)
    got1 = ops.decode_attention_paged(q[0], kp[0], vp[0], bt, t)
    torch.testing.assert_close(got1, got[0], atol=0, rtol=0)
    # same arithmetic as the ring kernel: bit for bit on a paginated cache
    for b in (0, 2):
        ring = ops.decode_attention_pair(q[:, b:b + 1], k[:, b:b + 1],
                                         v[:, b:b + 1], int(t[b]))
        assert torch.equal(got[:, b:b + 1], ring), b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hm,G,hd", [([3, 0], 4, 32), ([1, 1], 4, 32),
                                     ([2], 48, 128), ([0, 2], 16, 256)])
def test_paged_head_map_on_gpu(cuda, dtype, hm, G, hd):
    """A head map over a pool of 4 stored heads: against the plain version,
    and bit for bit against the identity launch on the gathered pool."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    B, L, ps = 3, 48, 16
    k, v = rand(2, B, L, 4, hd), rand(2, B, L, 4, hd)
    q = rand(2, B, len(hm), G, hd)
    kp, bt = _paginate(k, ps)
    vp, _ = _paginate(v, ps)
    t = torch.tensor([40, 0, 17], dtype=torch.int32, device=cuda)
    hmap = torch.tensor(hm, dtype=torch.int32, device=cuda)
    kg, vg = kp.index_select(3, hmap.long()), vp.index_select(3, hmap.long())
    got = ops.decode_attention_pair_paged(q, kp, vp, bt, t, hmap)
    torch.testing.assert_close(
        got, ops.decode_attention_pair_paged_plain(q, kp, vp, bt, t, hmap),
        atol=tol, rtol=tol)
    assert torch.equal(got, ops.decode_attention_pair_paged(q, kg, vg, bt, t))
    got1 = ops.decode_attention_paged(q[0], kp[0], vp[0], bt, t, hmap)
    assert torch.equal(got1, ops.decode_attention_paged(q[0], kg[0], vg[0], bt, t))
    with pytest.raises(ValueError, match="outside"):
        ops.decode_attention_paged(q[0], kp[0], vp[0], bt, t, hmap + 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,hd", [(8, 64), (32, 64), (3, 128), (16, 16),
                                  (48, 128), (36, 64), (12, 128), (5, 128), (6, 128),
                                  (130, 128), (200, 16), (16, 256), (40, 256)])
def test_decode_group_widths_on_gpu(cuda, dtype, g, hd):
    """GQA groups on both sides of 16 heads (in bf16 one warp per 16 heads
    on the tensor cores, two at hd = 256: granite-34b's MQA is g = 48 at
    hd = 128, recurrentgemma-9b's g = 16 at hd = 256; g = 130 and 200 are
    cut into head slices): ring and paged, pair and single layer, against
    their plain versions, paged == ring bit for bit, horizons that make a
    block walk two chunks."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    B, L, H, ps = 3, 320, 2, 16
    k, v = rand(2, B, L, H, hd), rand(2, B, L, H, hd)
    q = rand(2, B, H, g, hd)
    kp, bt = _paginate(k, ps)
    vp, _ = _paginate(v, ps)
    t = torch.tensor([319, 5, 200], dtype=torch.int32, device=cuda)
    got = ops.decode_attention_pair_paged(q, kp, vp, bt, t)
    torch.testing.assert_close(
        got, ops.decode_attention_pair_paged_plain(q, kp, vp, bt, t),
        atol=tol, rtol=tol)
    for b in range(B):
        ring = ops.decode_attention_pair(q[:, b:b + 1], k[:, b:b + 1],
                                         v[:, b:b + 1], int(t[b]))
        torch.testing.assert_close(
            ring, ops.decode_attention_pair_plain(q[:, b:b + 1], k[:, b:b + 1],
                                                  v[:, b:b + 1], int(t[b])),
            atol=tol, rtol=tol)
        assert torch.equal(got[:, b:b + 1], ring), b
    single = ops.decode_attention_paged(q[1], kp[1], vp[1], bt, t)
    torch.testing.assert_close(
        single, ops.decode_attention_paged_plain(q[1], kp[1], vp[1], bt, t),
        atol=tol, rtol=tol)
    ring1 = ops.decode_attention(q[1, :1], k[1, :1], v[1, :1], int(t[0]))
    torch.testing.assert_close(
        ring1, ops.decode_attention_plain(q[1, :1], k[1, :1], v[1, :1], int(t[0])),
        atol=tol, rtol=tol)
    assert torch.equal(single[:1], ring1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_per_row_q0_on_gpu(cuda, dtype):
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    q, k, v = rand(3, 20, 2, 4, 32), rand(3, 52, 2, 32), rand(3, 52, 2, 32)
    q0 = torch.tensor([0, 32, 17], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(ops.flash_attention(q, k, v, q0=q0, block_n=16),
                               ops.flash_attention_plain(q, k, v, q0=q0),
                               atol=tol, rtol=tol)
    same = torch.full((3,), 32, dtype=torch.int32, device=cuda)
    assert torch.equal(ops.flash_attention(q, k, v, q0=same, block_n=16),
                       ops.flash_attention(q, k, v, q0=32, block_n=16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_padding_transparent_on_gpu(cuda, dtype):
    """Causal, block_n = 16: the rows below Lq of a launch at S = 64 equal
    the launch cut to Lq, bit for bit, also when the keys and values at and
    past Lq hold large finite junk."""
    td, _ = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    q, k, v = rand(2, 64, 2, 4, 32), rand(2, 64, 2, 32), rand(2, 64, 2, 32)
    full = ops.flash_attention(q, k, v, block_n=16)
    for lq in (13, 37, 50):
        cut = ops.flash_attention(q[:, :lq], k[:, :lq], v[:, :lq], block_n=16)
        assert torch.equal(cut, full[:, :lq]), lq
        kj, vj = k.clone(), v.clone()
        kj[:, lq:] = 1e4 * rand(2, 64 - lq, 2, 32)
        vj[:, lq:] = 1e4 * rand(2, 64 - lq, 2, 32)
        assert torch.equal(ops.flash_attention(q, kj, vj, block_n=16)[:, :lq], cut), lq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd256_on_gpu(cuda, dtype):
    """recurrentgemma-9b's prefill head shape (16 query heads over one kv
    head at hd = 256), window mask with a prompt past the window and the
    causal mask, at the paths' block_n (16 and 64), against the plain
    version; block_n = 128 does not fit a block's shared memory and is
    refused."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    q, k, v = rand(2, 70, 1, 16, 256), rand(2, 70, 1, 256), rand(2, 70, 1, 256)
    for kw in ({"kind": "window", "window": 24}, {}):
        for bn in (16, 64):
            torch.testing.assert_close(ops.flash_attention(q, k, v, block_n=bn, **kw),
                                       ops.flash_attention_plain(q, k, v, **kw),
                                       atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="shared memory"):
        ops.flash_attention(q, k, v, block_n=128)


def test_flash_bf16_refuses_what_it_does_not_take_on_gpu(cuda):
    """The tensor-core body takes block_n in 16/32/64/128 and 16-byte
    aligned pointers and strides; it raises on anything else."""
    q = torch.zeros((1, 8, 1, 2, 16), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="block_n"):
        ops.flash_attention(q, k, k, block_n=8)
    shifted = torch.zeros(k.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(q, shifted, k, block_n=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,hd", [(2, 4, 64), (1, 48, 128), (1, 16, 256)])
def test_decode_batch_invariant_on_gpu(cuda, dtype, H, G, hd):
    """Each row of an 8-slot paged pair launch equals, bit for bit, the
    same row launched alone and inside a 40-row launch (the 8 rows five
    times, the speculative verifier's width at k = 4), at a narrow group,
    at granite-34b's MQA (1 kv head, g = 48, hd = 128) and at
    recurrentgemma-9b's (1 kv head, g = 16, hd = 256). Horizons up to 319
    make a block of the split walk two chunks; slot 1 is idle."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    B, L, ps = 8, 320, 16
    kp, bt = _paginate(rand(2, B, L, H, hd), ps)
    vp, _ = _paginate(rand(2, B, L, H, hd), ps)
    q = rand(2, B, H, G, hd)
    t = torch.tensor([319, 0, 17, 100, 160, 63, 200, 256], dtype=torch.int32,
                     device=cuda)
    bt[1] = 0
    out = ops.decode_attention_pair_paged(q, kp, vp, bt, t)
    torch.testing.assert_close(
        out, ops.decode_attention_pair_paged_plain(q, kp, vp, bt, t),
        atol=tol, rtol=tol)
    for b in range(B):
        alone = ops.decode_attention_pair_paged(q[:, b:b + 1], kp, vp,
                                                bt[b:b + 1], t[b:b + 1])
        assert torch.equal(alone, out[:, b:b + 1]), b
    wide = ops.decode_attention_pair_paged(torch.cat([q] * 5, 1), kp, vp,
                                           torch.cat([bt] * 5), torch.cat([t] * 5))
    for i in range(5):
        assert torch.equal(wide[:, i * B:(i + 1) * B], out), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2048, 4096, 5120])
@pytest.mark.parametrize("plus_one", [False, True])
def test_dual_rmsnorm_rows_bit_identical_on_gpu(cuda, dtype, d, plus_one):
    """A dual RMSNorm row comes out bit for bit the same launched alone, in
    an 8-row launch (the engine's decode) and at three offsets of a 2048-row
    launch (8 rows x a 256-token bucket)."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(5)
    scales = torch.randn((2, d), generator=gen, device=cuda).to(td)
    sa, sb = scales[0], scales[1]
    x8 = torch.randn((8, d), generator=gen, device=cuda).to(td)
    big = torch.randn((2048, d), generator=gen, device=cuda).to(td)
    offsets = (0, 1001, 2040)
    for o in offsets:
        big[o:o + 8] = x8
    y8 = ops.dual_rmsnorm(x8, sa, sb, plus_one=plus_one)
    torch.testing.assert_close(y8, ops.dual_rmsnorm_plain(x8, sa, sb, plus_one=plus_one),
                               atol=tol, rtol=tol)
    for i in range(8):
        assert torch.equal(ops.dual_rmsnorm(x8[i:i + 1], sa, sb, plus_one=plus_one),
                           y8[:, i:i + 1]), i
    wide = ops.dual_rmsnorm(big, sa, sb, plus_one=plus_one)
    for o in offsets:
        assert torch.equal(wide[:, o:o + 8], y8), o


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_rmsnorm_unaligned_and_widest_on_gpu(cuda, dtype):
    """D = 100 with the scales as the two rows of a [2, D] pair (in bf16 sb
    starts 200 bytes in: element-wise loads), D = 8192 (the widest row) and
    D = 2056 with rows off a 16-byte line, against the plain version;
    a 16-byte-misaligned sb gives the bits of an aligned copy; D = 8193 is
    refused."""
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    rows = rand(40, 2058)[:, 2:]
    for x, (sa, sb) in ((rand(40, 100), rand(2, 100)), (rand(24, 8192), rand(2, 8192)),
                        (rows, rand(2, 2056))):
        for plus_one in (False, True):
            for got, want in zip(ops.dual_rmsnorm(x, sa, sb, plus_one=plus_one),
                                 ops.dual_rmsnorm_plain(x, sa, sb, plus_one=plus_one)):
                torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    x, sa, sb = rand(8, 2048), rand(2048), rand(2049)[1:]
    assert torch.equal(ops.dual_rmsnorm(x, sa, sb), ops.dual_rmsnorm(x, sa, sb.clone()))
    with pytest.raises(ValueError):
        ops.dual_rmsnorm(rand(2, 8193), rand(8193), rand(8193))


def test_engine_matches_generate_on_gpu(cuda):
    """The engine on the card gives one-shot generate()'s greedy tokens
    (reduced tinyllama, fp32 weights and pool)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
    params = T.init_params(ms, torch.Generator(device=cuda).manual_seed(0),
                           torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 9)] + [rng.integers(0, cfg.vocab_size, n)
                                   for n in (5, 20, 12)]
    eng = PagedEngine(params, ms, PagedServeConfig(
        n_slots=4, page_size=8, n_pages=33, max_len=48,
        cache_dtype=torch.float32, prefix_cache=True))
    rids = [eng.add_request(prompts[0], 6)]
    eng.step()
    rids += [eng.add_request(p, 6) for p in prompts[1:]]
    res = eng.drain()
    assert eng.counters["prefix_hits"] >= 1 and eng.pool.live == eng.prefix.resident_pages
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    for rid, p in zip(rids, prompts):
        ref = generate(params, torch.from_numpy(p).to(cuda)[None], 6, ms=ms,
                       pc=ParallelContext(), sv=sv)[0].cpu().numpy()
        assert (res[rid] == ref).all(), rid


def _reduced_engine_streams(device, **kw):
    """Staggered traffic through a reduced tinyllama engine (fp32 weights
    made on the CPU from a seed, then moved to ``device``; fp32 pool)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    from repro_torch.serve import PagedEngine, PagedServeConfig

    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
    params = T.init_params(ms, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu").to(device)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 9)] + [rng.integers(0, cfg.vocab_size, n)
                                   for n in (5, 20, 12, 7)]
    eng = PagedEngine(params, ms, PagedServeConfig(
        n_slots=4, page_size=8, n_pages=33, max_len=48,
        cache_dtype=torch.float32, prefix_cache=True, **kw))
    rids = [eng.add_request(prompts[0], 9)]
    eng.step()
    rids += [eng.add_request(p, 9) for p in prompts[1:]]
    res = eng.drain()
    return [res[r].tolist() for r in rids], dict(eng.counters)


@pytest.mark.parametrize("kw", [
    dict(spec_k=3),
    dict(degrade_delta=True, degrade_slots=2, degrade_queue_depth=1)])
def test_spec_and_degraded_engines_match_cpu_on_gpu(cuda, kw):
    """The speculative engine (verify at 16 rows) and the degraded-cohort
    engine on the card give the same streams and counters as the same
    engines on the CPU (reduced tinyllama, fp32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, c_gpu = _reduced_engine_streams(cuda, **kw)
    want, c_cpu = _reduced_engine_streams("cpu", **kw)
    assert got == want
    assert c_gpu == c_cpu
    key = "verify_steps" if "spec_k" in kw else "degraded_admissions"
    assert c_gpu[key] > 0


def test_rewind_tokens_on_gpu_equals_cpu(cuda):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    from repro_torch.serve import paged_cache as PG

    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
    gen = torch.Generator().manual_seed(2)
    cpu = [{n: torch.randn(shape, generator=gen).to(dt) for n, (shape, dt) in seg.items()}
           for seg in PG.paged_cache_meta(ms, n_slots=2, n_pages=9, page_size=8,
                                          dtype=torch.bfloat16)]
    gpu = [{n: v.to(cuda) for n, v in seg.items()} for seg in cpu]
    pages = torch.tensor([3, 3, 5, 0, 0, 0], dtype=torch.int32)
    offs = torch.tensor([7, 1, 0, 0, 0, 0], dtype=torch.int32)
    PG.rewind_tokens(cpu, pages, offs)
    PG.rewind_tokens(gpu, pages.to(cuda), offs.to(cuda))
    for cseg, gseg in zip(cpu, gpu):
        for name, v in cseg.items():
            assert torch.equal(gseg[name].cpu(), v), name


def test_hybrid_card_equals_cpu_on_gpu(cuda):
    """Reduced recurrentgemma (RG-LRU pairs and local attention, window 16)
    in fp32 with TF32 off: generate's greedy tokens on the card equal the
    CPU's for prompts past the window (the ring wraps), and the engine on
    the card (window raised to the cache length, as the paged pool needs)
    gives generate()'s tokens on the card."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = ParallelContext()
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    base = reduced_config(get_config("recurrentgemma-9b"), n_layers=6)
    for cfg in (base, dataclasses.replace(base, window=48)):
        ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 6))
        p_cpu = T.init_params(ms, torch.Generator().manual_seed(0), torch.float32,
                              device="cpu")
        p_gpu = T.init_params(ms, torch.Generator().manual_seed(0), torch.float32,
                              device="cpu").to(cuda)
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 21)))
        want = generate(p_cpu, prompts, 10, ms=ms, pc=pc, sv=sv)
        got = generate(p_gpu, prompts.to(cuda), 10, ms=ms, pc=pc, sv=sv).cpu()
        assert torch.equal(got, want), cfg.window
        if cfg.window < sv.max_len:
            continue
        eng = PagedEngine(p_gpu, ms, PagedServeConfig(
            n_slots=2, page_size=8, n_pages=13, max_len=48,
            cache_dtype=torch.float32, prefix_cache=True))
        rids = [eng.add_request(p.numpy(), 10) for p in prompts]
        res = eng.drain()
        assert eng.prefix is None
        assert [res[r].tolist() for r in rids] == got.tolist()


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_card_equals_cpu_on_gpu(cuda, arch):
    """Reduced dbrx (4 experts, top 2, LayerNorm; plan_for_depth 3) and
    llama4 (4 experts, top 1, a shared expert; pairs chunked + chunked and
    chunked + global, chunk 16) in fp32 with TF32 off, at the capacity
    factor E/k (nothing dropped): generate's greedy tokens on the card
    equal the CPU's for 21-token prompts (past llama4's chunk), and the
    engine on the card gives generate()'s tokens on the card (llama4 with
    its chunk raised to the cache length and one chunked + chunked pair,
    as the paged pool needs)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan, plan_for_depth, plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = ParallelContext()
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    base = reduced_config(get_config(arch), n_layers=4)
    base = dataclasses.replace(base, moe_capacity_factor=base.moe_experts / base.moe_top_k)
    if arch.startswith("llama4"):
        cases = ((base, plan_range(base, 0, 4), False),
                 (dataclasses.replace(base, chunk=48), LPPlan(((0, 1),)), True))
    else:
        cases = ((base, plan_for_depth(base, 3), True),)
    for cfg, plan, paged in cases:
        ms = T.build_structure(cfg, plan=plan)
        p_cpu = T.init_params(ms, torch.Generator().manual_seed(0), torch.float32,
                              device="cpu")
        p_gpu = T.init_params(ms, torch.Generator().manual_seed(0), torch.float32,
                              device="cpu").to(cuda)
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 21)))
        want = generate(p_cpu, prompts, 10, ms=ms, pc=pc, sv=sv)
        got = generate(p_gpu, prompts.to(cuda), 10, ms=ms, pc=pc, sv=sv).cpu()
        assert torch.equal(got, want), (cfg.chunk, plan)
        if not paged:
            continue
        eng = PagedEngine(p_gpu, ms, PagedServeConfig(
            n_slots=2, page_size=8, n_pages=13, max_len=48,
            cache_dtype=torch.float32, prefix_cache=True))
        rids = [eng.add_request(p.numpy(), 10) for p in prompts]
        res = eng.drain()
        assert eng.prefix is None
        assert [res[r].tolist() for r in rids] == got.tolist()


@pytest.mark.parametrize("arch,pairs", [("tinyllama-1.1b", ((1, 2),)),
                                        ("recurrentgemma-9b", ((0, 1),))])
def test_differentiable_forward_card_equals_cpu_on_gpu(cuda, arch, pairs):
    """The train step's forward on the card (torch cores, no kernel) ==
    the CPU's: loss and every leaf's gradient within 1e-4 (fp32, TF32 off;
    the GEMMs sum in another order), and one AdamW step of the trainer
    moves the weights alike: 99.9% of the master weights within 1e-6, every
    one within 2·lr. The same weights through the kernels (eval,
    no_grad) give the same loss; under grad mode the kernels refuse."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_leaves, tree_map
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import (make_eval_step, make_train_step,
                                           state_from_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = ParallelContext()
    cfg = reduced_config(get_config(arch), n_layers=4)
    ms = T.build_structure(cfg, plan=LPPlan(pairs))
    p_cpu = T.init_params(ms, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = {}
    for dev in ("cpu", cuda):
        w = tree_map(lambda x: x.to(dev).requires_grad_(True), p_cpu.tree())
        b = {k: x.to(dev) for k, x in batch.items()}
        loss, _ = T.loss_fn(w, b, ms=ms, pc=pc, differentiable=True)
        grads = torch.autograd.grad(loss, tree_leaves(w))
        tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
        st = state_from_params(tree_map(lambda x: x.to(dev), p_cpu.tree()), ms, pc, tc)
        st, _ = make_train_step(ms, pc, tc)(st, b)
        ev = make_eval_step(ms, pc)(tree_map(lambda x: x.to(dev), p_cpu.tree()), b)
        out[str(dev)] = (loss.detach().cpu(), [g.cpu() for g in grads],
                         [x.cpu() for x in tree_leaves(st["master"])], ev["loss"].cpu())
        if dev == cuda:
            with pytest.raises(RuntimeError, match="no backward"):
                T.loss_fn(w, b, ms=ms, pc=pc)
    (lc, gc, mc, ec), (lg, gg, mg, eg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(eg, lc, atol=1e-4, rtol=1e-4)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # Adam's first step is about lr·sign(g): an element whose gradient is
    # near 0 may move the other way (2·lr), the bulk moves alike.
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(mg, mc)])
    assert d.max() <= 2e-3 + 1e-5
    assert d.le(1e-6).float().mean() >= 0.999
