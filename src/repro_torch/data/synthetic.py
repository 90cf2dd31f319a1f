"""Structured synthetic corpus + ICL tasks (the JAX package's corpus).

No pretrained weights or datasets are fetched, so the paper's perplexity
and ICL measurements run on models trained on this corpus. The mixture
(per sequence):
  * trigram language: a fixed random trigram chain with Zipfian weights
    over ``branch`` continuations per context (perplexity metric)
  * copy spans: [COPY] pattern [SEP] pattern (induction circuitry)
  * k-shot ICL classification: k (x -> y) demonstrations of a per-sequence
    random class map, then queries; the answer tokens' accuracy is the
    Table-1 proxy metric

The structure is the JAX package's. The draws come from a
``torch.Generator`` in a fixed order, so a batch is a pure function of the
generator's seed; the JAX package's ``jax.random`` streams cannot be
replayed in torch, so the two corpora hold the same kinds of sequences,
not the same tokens. Every function makes ``n`` rows at once (int64, on
the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

#: Seed of the trigram tables: one fixed language for every run.
LANGUAGE_SEED = 17


@dataclass(frozen=True)
class SynthConfig:
    vocab_size: int = 512
    # reserved control tokens at the top of the vocab
    n_special: int = 8
    # trigram LM
    branch: int = 4          # candidate continuations per (a, b) context
    zipf: float = 1.2
    # ICL classification
    n_classes: int = 8
    n_features: int = 32

    @property
    def copy_tok(self) -> int:
        return self.vocab_size - 1

    @property
    def sep_tok(self) -> int:
        return self.vocab_size - 2

    @property
    def icl_tok(self) -> int:
        return self.vocab_size - 3

    @property
    def arrow_tok(self) -> int:
        return self.vocab_size - 4

    @property
    def base_vocab(self) -> int:
        return self.vocab_size - self.n_special


def _zipf_probs(n: int, alpha: float) -> torch.Tensor:
    r = torch.arange(1, n + 1, dtype=torch.float32)
    p = r ** (-alpha)
    return p / p.sum()


def _trigram_tables(sc: SynthConfig):
    """The fixed language: for every (a % m, b % m) context, ``branch``
    allowed continuations with Zipfian weights. m keeps the table small
    (structure, not memorisation)."""
    m = min(sc.base_vocab, 64)
    g = torch.Generator().manual_seed(LANGUAGE_SEED)
    nexts = torch.randint(0, sc.base_vocab, (m, m, sc.branch), generator=g)
    return m, nexts, _zipf_probs(sc.branch, sc.zipf)


def _pad_to(s: torch.Tensor, seq_len: int, fill: int) -> torch.Tensor:
    """Rows [n, L] right-padded with ``fill`` (or cut) to ``seq_len``."""
    if s.shape[1] < seq_len:
        s = torch.cat([s, torch.full((s.shape[0], seq_len - s.shape[1]), fill,
                                     dtype=s.dtype)], dim=1)
    return s[:, :seq_len]


def trigram_rows(generator: torch.Generator, sc: SynthConfig, n: int,
                 seq_len: int) -> torch.Tensor:
    """[n, seq_len] trigram-language rows."""
    m, nexts, w = _trigram_tables(sc)
    a, b = torch.randint(0, sc.base_vocab, (2, n), generator=generator)
    choice = torch.multinomial(w.expand(n, -1), seq_len, replacement=True,
                               generator=generator)
    out = torch.empty((n, seq_len), dtype=torch.int64)
    for t in range(seq_len):
        c = nexts[a % m, b % m, choice[:, t]]
        out[:, t] = c
        a, b = b, c
    return out


def copy_rows(generator: torch.Generator, sc: SynthConfig, n: int,
              seq_len: int) -> torch.Tensor:
    """[n, seq_len] rows [COPY] p_1..p_L [SEP] p_1..p_L, padded with SEP."""
    L = (seq_len - 2) // 2
    pat = torch.randint(0, sc.base_vocab, (n, L), generator=generator)
    col = torch.ones((n, 1), dtype=torch.int64)
    s = torch.cat([col * sc.copy_tok, pat, col * sc.sep_tok, pat], dim=1)
    return _pad_to(s, seq_len, sc.sep_tok)


def icl_rows(generator: torch.Generator, sc: SynthConfig, n: int,
             seq_len: int, *, return_meta=False):
    """[n, seq_len] rows [ICL] x1 -> y1 x2 -> y2 ..., each with its own
    random map features -> classes; with ``return_meta`` also the answer
    positions [n_pairs] (where the y tokens sit) and the answers [n,
    n_pairs]."""
    fmap = torch.randint(0, sc.n_classes, (n, sc.n_features), generator=generator)
    n_pairs = (seq_len - 1) // 3
    xs = torch.randint(0, sc.n_features, (n, n_pairs), generator=generator)
    y_toks = sc.base_vocab - sc.n_classes + torch.gather(fmap, 1, xs)
    arrow = torch.full_like(xs, sc.arrow_tok)
    trip = torch.stack([xs, arrow, y_toks], dim=2).reshape(n, -1)
    s = torch.cat([torch.full((n, 1), sc.icl_tok, dtype=torch.int64), trip], dim=1)
    s = _pad_to(s, seq_len, sc.sep_tok)
    if not return_meta:
        return s
    ans_pos = 1 + 3 * torch.arange(n_pairs) + 2
    return s, ans_pos, y_toks


def lm_batch(generator: torch.Generator, sc: SynthConfig, seq_len: int,
             batch: int) -> Dict[str, torch.Tensor]:
    """Mixture batch {"tokens", "labels"} [batch, seq_len] for LM training
    (labels are the tokens shifted by one): each row is trigram with
    probability 1/2, copy or ICL with 1/4 each."""
    kind = torch.randint(0, 4, (batch,), generator=generator)
    toks = torch.empty((batch, seq_len + 1), dtype=torch.int64)
    for rows, make in ((kind <= 1, trigram_rows), (kind == 2, copy_rows),
                       (kind == 3, icl_rows)):
        n = int(rows.sum())
        if n:
            toks[rows] = make(generator, sc, n, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def eval_ppl_batch(generator: torch.Generator, sc: SynthConfig, seq_len: int,
                   batch: int) -> Dict[str, torch.Tensor]:
    """Pure trigram-language batch: the perplexity eval set (the analogue of
    the paper's RedPajama test split)."""
    toks = trigram_rows(generator, sc, batch, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def icl_eval_batch(generator: torch.Generator, sc: SynthConfig, seq_len: int,
                   batch: int) -> Dict[str, torch.Tensor]:
    """ICL accuracy batch: tokens, answer positions and answer ids."""
    toks, pos, ys = icl_rows(generator, sc, batch, seq_len, return_meta=True)
    return {"tokens": toks, "ans_pos": pos.expand(batch, -1), "ans_tok": ys}
