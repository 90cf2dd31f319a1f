"""What decides ``correct``: the served tokens of a sample of the requests
the window finished, held against the plain reference.

The sample is drawn from the seed and always holds the longest finished
request. The reference runs once over each prompt with its served tokens
(teacher forced) and gives the logits before every served token; the
number compared is the widest gap by which a served token's logit lies
below the reference's best there (greedy decoding serves the best token,
so a sound program reads the rounding of its arithmetic). The control
(``quant="fp8"``) puts the reference in the program's place at the next
precision down and reads the same gap for the token it would put first;
``judge`` decides both by the same limit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import weights as W
from portbench.reference import Reference, fp32_matmuls
from portbench.traffic import MASK64

ROOT = Path(__file__).resolve().parent
#: A sample grows until it holds this many served tokens and requests.
SAMPLE_TOKENS = 200
SAMPLE_REQUESTS = 4


def limits(workload: str) -> dict:
    path = ROOT / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def sample(finished: list, served: dict, prompts: dict, seed: int,
           tokens: int = SAMPLE_TOKENS, requests: int = SAMPLE_REQUESTS) -> list:
    """rids to compare: the longest finished request (most served tokens,
    then the longest prompt), then others in an order drawn from the seed
    until the sample holds ``tokens`` served tokens and ``requests``
    requests."""
    if not finished:
        return []
    rids = sorted(finished)
    longest = max(rids, key=lambda r: (len(served[r]), len(prompts[r]), -r))
    rest = [r for r in rids if r != longest]
    order = np.random.default_rng([int(seed) & MASK64, 1]).permutation(len(rest))
    out, n = [longest], len(served[longest])
    for k in order:
        if n >= tokens and len(out) >= requests:
            break
        out.append(rest[k])
        n += len(served[rest[k]])
    return out


def _seqs(rids, served, prompts, device):
    seqs, at = [], []
    for r in rids:
        ids, out = prompts[r], served[r]
        seq = np.concatenate([ids, np.asarray(out[:-1], np.int32)])
        seqs.append(torch.as_tensor(seq, device=device))
        at.append(torch.arange(len(ids) - 1, len(seq), device=device))
    return seqs, at


@torch.no_grad()
def gaps(cfg: dict, seed: int, device, rids: list, served: dict, prompts: dict,
         *, control: bool = False) -> dict:
    """{"gap_max": the widest gap of a served token below the reference's
    best, "tokens": served tokens compared, and with ``control`` the
    control's "control_gap_max"}. The reference draws the weights again
    from the seed."""
    fp32_matmuls()
    drawn = W.draw(cfg, seed, device)
    seqs, at = _seqs(rids, served, prompts, device)
    ref = Reference(cfg, drawn).logits(seqs, at)
    out = {"tokens": sum(len(served[r]) for r in rids), "requests": len(rids)}
    gap = []
    for r, lg in zip(rids, ref):
        tok = torch.as_tensor(served[r], device=lg.device).long()
        gap.append((lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]).max().item())
    out["gap_max"] = max(gap)
    if control:
        ctl = Reference(cfg, drawn, quant="fp8").logits(seqs, at)
        cg = [(lg.max(-1).values - lg.gather(-1, c.argmax(-1)[:, None])[:, 0]).max().item()
              for lg, c in zip(ref, ctl)]
        out["control_gap_max"] = max(cg)
    return out


def judge(readings: dict, lim: dict, failed: int, short: int) -> tuple:
    """(correct, {name: {"value", "limit"}}) of every number compared."""
    gap_limit = lim.get("gap_max", {}).get("limit")
    check = {"failed": {"value": failed, "limit": 0},
             "short_answers": {"value": short, "limit": 0},
             "gap_max": {"value": readings.get("gap_max"), "limit": gap_limit}}
    ok = (failed == 0 and short == 0 and readings.get("requests", 0) > 0
          and gap_limit is not None and readings["gap_max"] <= gap_limit)
    return ok, check
