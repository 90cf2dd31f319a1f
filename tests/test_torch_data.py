"""The port's data pipeline on the CPU: ``TokenFileSource`` batches equal
the JAX package's token for token (numpy on both sides), and the synthetic
sources keep the properties the JAX package's tests/test_data.py checks:
``batch_at`` is a pure function of (seed, step), labels are the tokens
shifted by one, tokens stay in range, copy rows repeat their pattern, ICL
rows keep one class map, and trigram rows follow the one fixed language.
The synthetic tokens are the port's own draws (torch cannot replay
``jax.random`` streams), so they are held to properties, not to JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenFileSource as JTokenFileSource  # noqa: E402

from repro_torch.data import (DataConfig, SynthConfig, TokenFileSource,  # noqa: E402
                              eval_ppl_batch, icl_eval_batch, lm_batch,
                              make_source)
from repro_torch.data.pipeline import step_generator  # noqa: E402
from repro_torch.data.synthetic import (_trigram_tables, copy_rows,  # noqa: E402
                                        icl_rows, trigram_rows)

SC = SynthConfig(vocab_size=512)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_source_matches_jax(tmp_path, dtype):
    """Every batch of two epochs and a half equals JAX's, token for token;
    labels are the next-token view of the same window."""
    hi = 1000 if dtype == np.uint16 else 100_000
    data = np.random.default_rng(0).integers(0, hi, 5_000).astype(dtype)
    p = tmp_path / "tokens.bin"
    data.tofile(p)
    kw = dict(seq_len=64, global_batch=4, seed=1, source="file", path=str(p))
    src = TokenFileSource(DataConfig(**kw), dtype=dtype)
    jsrc = JTokenFileSource(JDataConfig(**kw), dtype=dtype)
    assert src.n_windows == jsrc.n_windows == (5_000 - 1) // 64
    bpe = src.n_windows // 4
    for step in range(int(2.5 * bpe)):
        b, jb = src.batch_at(step), jsrc.batch_at(step)
        assert b["tokens"].dtype == torch.int64 and b["tokens"].shape == (4, 64)
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(b["labels"].numpy(), np.asarray(jb["labels"]))
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_file_source_refuses_a_short_file(tmp_path):
    p = tmp_path / "tokens.bin"
    np.arange(100, dtype=np.uint16).tofile(p)
    with pytest.raises(ValueError, match="fewer than a batch"):
        make_source(DataConfig(seq_len=64, global_batch=4, source="file", path=str(p)))


def test_batch_at_is_pure():
    src = make_source(DataConfig(seq_len=32, global_batch=4, seed=7))
    a, b = src.batch_at(11), src.batch_at(11)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], src.batch_at(12)["tokens"])
    other = make_source(DataConfig(seq_len=32, global_batch=4, seed=8))
    assert not torch.equal(a["tokens"], other.batch_at(11)["tokens"])
    with pytest.raises(ValueError):
        step_generator(7, -1)


def test_labels_are_shifted_tokens_in_range():
    batch = lm_batch(_gen(0), SC, 64, 16)
    assert batch["tokens"].shape == batch["labels"].shape == (16, 64)
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert int(batch["tokens"].min()) >= 0
    assert int(batch["tokens"].max()) < SC.vocab_size


def test_mixture_holds_every_kind():
    """Rows start with [COPY], [ICL] or a trigram token; 64 rows hold all
    three kinds."""
    toks = lm_batch(_gen(1), SC, 64, 64)["tokens"]
    first = toks[:, 0]
    n_copy = int((first == SC.copy_tok).sum())
    n_icl = int((first == SC.icl_tok).sum())
    assert n_copy and n_icl and 64 - n_copy - n_icl > 0


def test_copy_rows_structure():
    s = copy_rows(_gen(0), SC, 3, 65)
    L = (65 - 2) // 2
    assert bool((s[:, 0] == SC.copy_tok).all()) and bool((s[:, L + 1] == SC.sep_tok).all())
    assert torch.equal(s[:, 1:L + 1], s[:, L + 2:2 * L + 2])
    assert bool((s[:, 2 * L + 2:] == SC.sep_tok).all())


def test_icl_answers_consistent():
    """The same x maps to the same y within a row (the in-context function
    is well defined), and the answers sit at the marked positions."""
    toks, pos, ys = icl_rows(_gen(3), SC, 4, 100, return_meta=True)
    for r in range(4):
        seen = {}
        for x, y in zip(toks[r, pos - 2].tolist(), ys[r].tolist()):
            assert seen.setdefault(x, y) == y
        assert torch.equal(toks[r, pos], ys[r])
        assert bool((toks[r, pos - 1] == SC.arrow_tok).all())
    batch = icl_eval_batch(_gen(3), SC, 100, 4)
    assert torch.equal(batch["tokens"], toks)
    assert torch.equal(batch["ans_pos"][2], pos) and torch.equal(batch["ans_tok"], ys)


def test_trigram_rows_follow_the_fixed_language():
    """Same seed -> same rows; every token after the first two is one of
    the ``branch`` continuations the fixed table allows for its context,
    whatever the seed."""
    m, nexts, _ = _trigram_tables(SC)
    a = trigram_rows(_gen(0), SC, 4, 64)
    assert torch.equal(a, trigram_rows(_gen(0), SC, 4, 64))
    for rows in (a, trigram_rows(_gen(5), SC, 4, 64), eval_ppl_batch(_gen(6), SC, 63, 4)["tokens"]):
        ctx = nexts[rows[:, :-2] % m, rows[:, 1:-1] % m]     # [n, L-2, branch]
        assert bool((ctx == rows[:, 2:, None]).any(-1).all())
