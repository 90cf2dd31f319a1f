"""The port's plain kernel versions against the JAX oracles and the JAX
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

Tolerances as tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16. The
kernels themselves run only on an NVIDIA GPU: tests/test_torch_cuda.py.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.kernels import dual_rmsnorm as KNORM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and keeps
    the parallel suite's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype="float32"):
    """One numpy array -> (jax array, torch tensor) of the same values."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _close(t, j, tol):
    t = t.float().numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# dual RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,d", [(8, 64), (50, 96), (1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_dual_rmsnorm_plain(m, d, dtype, plus_one):
    rng = np.random.default_rng(m * d)
    tol = DTYPES[dtype][2]
    jx, tx = _both(rng.standard_normal((m, d)), dtype)
    jsa, tsa = _both(rng.standard_normal(d))
    jsb, tsb = _both(rng.standard_normal(d))
    ya, yb = ref.dual_rmsnorm_ref(tx, tsa, tsb, plus_one=plus_one)
    for ja, jb in (JREF.dual_rmsnorm_ref(jx, jsa, jsb, plus_one=plus_one),
                   JOPS.dual_rmsnorm(jx, jsa, jsb, plus_one=plus_one, block_m=32)):
        _close(ya, ja, tol)
        _close(yb, jb, tol)
    # the wrapper on CPU tensors is the plain version, any leading shape,
    # both outputs stacked on a leading pair axis
    w = ops.dual_rmsnorm(tx.reshape(m, 1, d), tsa, tsb, plus_one=plus_one)
    assert w.shape == (2, m, 1, d)
    assert torch.equal(w[0].reshape(m, d), ya) and torch.equal(w[1].reshape(m, d), yb)


@pytest.mark.parametrize("d", [1, 100, 128, 2048, 4096, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_rmsnorm_row_layout_ignores_m(d, dtype):
    """The CUDA kernel launches one block a row (the grid is M), laid out by
    ``row_layout``: vector width, warps a row and vectors a thread, so the
    order of every sum. It takes D and the dtype and nothing of M, so a
    row's layout is the same at M = 1, 8 and 2048. Every layout fits the
    kernel, covers the row and leaves no warp idle."""
    td = DTYPES[dtype][1]
    assert list(inspect.signature(KNORM.row_layout).parameters) == ["D", "dtype"]
    lay = KNORM.row_layout(d, td)
    assert lay.vec * td.itemsize == 16
    assert 1 <= lay.warps <= 8 and 1 <= lay.vecs_per_thread <= 8
    assert lay.warps * 32 * lay.vecs_per_thread * lay.vec >= d   # covers the row
    assert (lay.warps - 1) * 32 * lay.vec < d or lay.warps == 8  # no idle warp
    assert (lay.vecs_per_thread - 1) * lay.warps * 32 * lay.vec < d  # no idle vector


def test_dual_rmsnorm_row_layout_at_the_paths_widths():
    """The paths' rows (D = 2048 and 4096) take 8 warps a row: in bf16 one
    or two 16-byte vectors a lane, in fp32 (the parity runs) two or four.
    A narrow row takes the warps it fills."""
    bf, f32 = torch.bfloat16, torch.float32
    assert KNORM.row_layout(2048, bf) == KNORM.RowLayout(8, 8, 1)
    assert KNORM.row_layout(4096, bf) == KNORM.RowLayout(8, 8, 2)
    assert KNORM.row_layout(2048, f32) == KNORM.RowLayout(4, 8, 2)
    assert KNORM.row_layout(4096, f32) == KNORM.RowLayout(4, 8, 4)
    assert KNORM.row_layout(8192, f32) == KNORM.RowLayout(4, 8, 8)
    assert KNORM.row_layout(128, bf) == KNORM.RowLayout(8, 1, 1)
    assert KNORM.row_layout(100, f32) == KNORM.RowLayout(4, 1, 1)


def _norm_inputs(case):
    d, dt = 64, torch.bfloat16
    x, sa, sb = torch.zeros(8, d, dtype=dt), torch.zeros(d, dtype=dt), torch.zeros(d, dtype=dt)
    if case == "dtype":
        return x.half(), sa.half(), sb.half()
    if case == "mixed dtypes":
        return x, sa.float(), sb
    if case == "D > 8192":
        return (torch.zeros(2, 8200, dtype=dt), torch.zeros(8200, dtype=dt),
                torch.zeros(8200, dtype=dt))
    if case == "no rows":
        return x[:0], sa, sb
    if case == "strided rows":
        return torch.zeros(8, 2 * d, dtype=dt)[:, ::2], sa, sb
    if case == "strided scales":
        return x, torch.zeros(2 * d, dtype=dt)[::2], sb
    if case == "scale shape":
        return x, sa[:-1], sb
    assert case == "x not 2-d"
    return x[None], sa, sb


@pytest.mark.parametrize("case", ["dtype", "mixed dtypes", "D > 8192", "no rows",
                                  "strided rows", "strided scales", "scale shape",
                                  "x not 2-d"])
def test_dual_rmsnorm_kernel_refuses(case):
    """What the CUDA kernel does not take is refused before any launch (on
    any device), and a CPU tensor never reaches the kernel's launch."""
    with pytest.raises((TypeError, ValueError)):
        KNORM.check(*_norm_inputs(case))
    with pytest.raises((TypeError, ValueError)):
        KNORM.launch(*_norm_inputs(case), eps=1e-6, plus_one=False)


def test_dual_rmsnorm_kernel_misaligned_pointers_take_element_loads():
    """Pointers or row strides off a 16-byte line are not refused: the
    kernel reads and writes them element by element (the same arithmetic).
    The model's scales are the two rows of a [2, D] pair, so at D = 100 in
    bf16 sb starts 200 bytes in. In fp32 that row is aligned."""
    bf, f32 = torch.bfloat16, torch.float32
    pair = torch.zeros(2, 100, dtype=bf)
    assert KNORM.check(torch.zeros(8, 128, dtype=bf), torch.zeros(128, dtype=bf),
                       torch.zeros(128, dtype=bf))
    assert not KNORM.check(torch.zeros(8, 100, dtype=bf), pair[0], pair[1])
    pair32 = torch.zeros(2, 100, dtype=f32)
    assert KNORM.check(torch.zeros(8, 100, dtype=f32), pair32[0], pair32[1])
    off = torch.zeros(2049, dtype=bf)[1:]          # 2 bytes past a 16-byte line
    assert not KNORM.check(torch.zeros(4, 2048, dtype=bf), torch.zeros(2048, dtype=bf), off)
    rows = torch.zeros(4, 2056, dtype=f32)[:, 1:2049]  # rows 4 bytes off the line
    assert not KNORM.check(rows, torch.zeros(2048, dtype=f32), torch.zeros(2048, dtype=f32))
    with pytest.raises(ValueError):   # a CPU tensor: the kernel's launch refuses it
        KNORM.launch(torch.zeros(8, 100, dtype=bf), pair[0], pair[1], eps=1e-6,
                     plus_one=False)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw,s,t,hd", [
    ("causal", {}, 37, 37, 32),
    ("causal", {"prefix_len": 5}, 37, 37, 32),
    ("window", {"window": 7}, 37, 37, 32),
    ("chunk", {"chunk": 16}, 40, 40, 16),
    ("bidir", {}, 16, 48, 16),
    ("causal", {"q0": 16}, 24, 40, 16),
    ("causal", {"q0": 20, "k0": 4}, 24, 40, 16),
])
def test_flash_attention_plain(kind, kw, s, t, hd):
    rng = np.random.default_rng(s * t + hd)
    jq, tq = _both(rng.standard_normal((3, s, hd)))
    jk, tk = _both(rng.standard_normal((3, t, hd)))
    jv, tv = _both(rng.standard_normal((3, t, hd)))
    o = ref.flash_attention_ref(tq, tk, tv, kind=kind, **kw)
    _close(o, JREF.flash_attention_ref(jq, jk, jv, kind=kind, **kw), 2e-5)
    _close(o, JOPS.flash_attention(jq, jk, jv, kind=kind, block_q=16,
                                   block_k=16, **kw), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_fold(dtype):
    """q_group > 1: rows [pos, head] share the position mask — against the
    Pallas kernel, and the kernel wrapper's grouped layout on the CPU."""
    g, s, hd, tol = 4, 24, 16, DTYPES[dtype][2]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, s * g, hd))
    jq, tq = _both(q, dtype)
    jk, tk = _both(rng.standard_normal((2, s, hd)), dtype)
    jv, tv = _both(rng.standard_normal((2, s, hd)), dtype)
    o = ref.flash_attention_ref(tq, tk, tv, kind="causal", q_group=g)
    _close(o, JOPS.flash_attention(jq, jk, jv, kind="causal", q_group=g,
                                   block_q=16, block_k=16), tol)
    for h in range(g):  # the oracle, one query head at a time
        _close(o[:, h::g], JREF.flash_attention_ref(jq[:, h::g], jk, jv), tol)
    # grouped layout [B=2, S, H=1, g, hd] through the wrapper
    og = ops.flash_attention(tq.reshape(2, s, 1, g, hd), tk[:, :, None],
                             tv[:, :, None], kind="causal", block_n=16)
    assert torch.equal(og.reshape(2, s * g, hd), o)


# ---------------------------------------------------------------------------
# ring decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,g,l,hd", [(2, 3, 4, 100, 32), (4, 2, 1, 64, 16)])
@pytest.mark.parametrize("t_frac", [0.3, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain(b, hkv, g, l, hd, t_frac, dtype):
    rng = np.random.default_rng(b * l + g)
    tol = DTYPES[dtype][2]
    t = max(int(l * t_frac) - 1, 0)
    jq, tq = _both(rng.standard_normal((b, hkv, g, hd)), dtype)
    jk, tk = _both(rng.standard_normal((b, l, hkv, hd)), dtype)
    jv, tv = _both(rng.standard_normal((b, l, hkv, hd)), dtype)
    o = ref.decode_attention_ref(tq, tk, tv, t)
    _close(o, JREF.decode_attention_ref(jq, jk, jv, t), tol)
    _close(o, JOPS.decode_attention(jq, jk, jv, t, block_l=32), tol)
    assert torch.equal(ops.decode_attention(tq, tk, tv, t), o)


@pytest.mark.parametrize("t", [0, 17, 47])
def test_decode_attention_pair_plain(t):
    rng = np.random.default_rng(t)
    jq, tq = _both(rng.standard_normal((2, 3, 2, 4, 16)))
    jk, tk = _both(rng.standard_normal((2, 3, 48, 2, 16)))
    jv, tv = _both(rng.standard_normal((2, 3, 48, 2, 16)))
    o = ref.decode_attention_pair_ref(tq, tk, tv, t)
    _close(o, JOPS.decode_attention_pair(jq, jk, jv, t, block_l=32), 2e-5)
    for i in range(2):  # each half is the single-layer oracle
        _close(o[i], JREF.decode_attention_ref(jq[i], jk[i], jv[i], t), 2e-5)
    assert torch.equal(ops.decode_attention_pair(tq, tk, tv, t), o)


def test_wrappers_reject_other_devices():
    x = torch.zeros(2, 8)
    s = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        ops.dual_rmsnorm(x, s, s)
    with pytest.raises(ValueError):
        ops.dual_rmsnorm(x.to("meta"), torch.ones(8), s)
    # all on meta: the dry run's abstract evaluation, the kernel's shape
    y = ops.dual_rmsnorm(x.to("meta"), s, s)
    assert y.device.type == "meta" and y.shape == (2, 2, 8) and y.dtype == x.dtype


def _view(kind):
    x = torch.zeros((2, 40, 2, 16), dtype=torch.bfloat16)
    if kind == "contiguous":
        return x
    if kind == "later_positions":
        return x[:, 5:]
    if kind == "one_batch_row":
        return x[1:2]
    if kind == "shifted_pointer":
        return torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    return torch.zeros((2, 40, 2, 20), dtype=x.dtype)[..., :16]  # 40-byte rows


@pytest.mark.parametrize("kind,ok", [
    ("contiguous", True), ("later_positions", True), ("one_batch_row", True),
    ("shifted_pointer", False), ("padded_rows", False)])
def test_kernel_strides_and_alignment(kind, ok):
    """The host side of the kernels that copy rows in 16-byte pieces: a
    size-1 dim's stride is passed as 0, and a pointer or stride that is not
    a multiple of 16 bytes is refused."""
    from repro_torch.kernels import build
    x = _view(kind)
    assert build.aligned16(x, 3) is ok
    want = [0 if d == 1 else s for d, s in zip(x.shape[:3], x.stride()[:3])]
    assert build.strides(x, 3) == want


# ---------------------------------------------------------------------------
# hd = 256 (recurrentgemma-9b: 16 query heads over one kv head)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("t", [0, 40, 79])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_hd256(pair, t, dtype):
    """The ring decode plain versions at hd = 256, g = 16, one kv head,
    against the JAX Pallas kernels (interpret mode)."""
    rng = np.random.default_rng(t + 256 * pair)
    tol = DTYPES[dtype][2]
    lead = (2,) if pair else ()
    jq, tq = _both(rng.standard_normal(lead + (2, 1, 16, 256)), dtype)
    jk, tk = _both(rng.standard_normal(lead + (2, 80, 1, 256)), dtype)
    jv, tv = _both(rng.standard_normal(lead + (2, 80, 1, 256)), dtype)
    if pair:
        o = ops.decode_attention_pair(tq, tk, tv, t)
        _close(o, JOPS.decode_attention_pair(jq, jk, jv, t, block_l=32), tol)
        assert torch.equal(o, ref.decode_attention_pair_ref(tq, tk, tv, t))
    else:
        o = ops.decode_attention(tq, tk, tv, t)
        _close(o, JOPS.decode_attention(jq, jk, jv, t, block_l=32), tol)
        assert torch.equal(o, ref.decode_attention_ref(tq, tk, tv, t))


@pytest.mark.parametrize("s,window", [(24, 16), (40, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_hd256(s, window, dtype):
    """The flash plain version (the wrapper's grouped layout) at hd = 256,
    g = 16, one kv head, kind window, against the JAX Pallas kernel in
    interpret mode on the folded rows (row = position * g + head)."""
    g, hd, tol = 16, 256, DTYPES[dtype][2]
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 1, g, hd))
    jq, tq = _both(q.reshape(2, s * g, hd), dtype)
    jk, tk = _both(rng.standard_normal((2, s, hd)), dtype)
    jv, tv = _both(rng.standard_normal((2, s, hd)), dtype)
    want = JOPS.flash_attention(jq, jk, jv, kind="window", window=window,
                                q_group=g, block_q=32, block_k=16)
    got = ops.flash_attention(tq.reshape(2, s, 1, g, hd), tk[:, :, None],
                              tv[:, :, None], kind="window", window=window,
                              block_n=16)
    _close(got.reshape(2, s * g, hd), want, tol)


def _attn_inputs(hd, dtype=torch.bfloat16):
    q = torch.zeros(2, 1, 16, hd, dtype=dtype)
    kv = torch.zeros(2, 32, 1, hd, dtype=dtype)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    return q, kv, bt


@pytest.mark.parametrize("hd", [96, 512])
def test_kernel_wrappers_refuse_untaken_widths(hd):
    """A head width the kernels are not instantiated at is refused before
    any launch, on any device (no fallback)."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KF
    q, kv, bt = _attn_inputs(hd)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        KD.launch(q[None], kv[None], kv[None], 5)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        KD.launch_paged(q[None], kv.reshape(1, 8, 8, 1, hd), kv.reshape(1, 8, 8, 1, hd),
                        bt, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=f"got {hd}"):
        KF.launch(q.reshape(2, 1, 1, 16, hd), kv, kv, kind="causal", window=0,
                  chunk=0, prefix_len=0, q0=0, k0=0, block_n=16)


@pytest.mark.parametrize("dtype,block_n,ok", [
    (torch.float32, 128, False), (torch.bfloat16, 128, False),
    (torch.float32, 64, True), (torch.bfloat16, 64, True), (torch.bfloat16, 16, True)])
def test_flash_wrapper_refuses_tiles_over_shared_memory(dtype, block_n, ok):
    """At hd = 256 a block_n of 128 needs more shared memory than a block
    may take (fp32 264 KB, bf16 297 KB) and is refused with that reason;
    64 and the engine's 16 fit (a CPU tensor then fails on its device)."""
    from repro_torch.kernels import flash_attention as KF
    q, kv, _ = _attn_inputs(256, dtype)
    assert (KF.smem_bytes(dtype, block_n, 256) <= KF.MAX_SMEM) is ok
    match = "CUDA device" if ok else "shared memory"
    with pytest.raises(ValueError, match=match):
        KF.launch(q.reshape(2, 1, 1, 16, 256), kv, kv, kind="window", window=2048,
                  chunk=0, prefix_len=0, q0=0, k0=0, block_n=block_n)
