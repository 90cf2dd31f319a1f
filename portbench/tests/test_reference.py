"""The plain reference against the port on a tiny configuration on the
CPU: the same weights (drawn by the benchmark, packed by the port's LP
merge) give the same logits through the port's full forward."""
import pytest
import torch

from cells import tiny
from portbench import program, weights
from portbench.reference import Reference


@pytest.mark.parametrize("family", ["dense", "mamba"])
def test_reference_equals_the_port(family):
    torch.manual_seed(0)
    cfg = tiny(family)
    port = program.import_port()
    ms = program.structure(cfg, port)
    assert len(ms.plan.pairs) == 2
    drawn = weights.draw(cfg, 2**33 + 5, "cpu")
    tree = program.params(cfg, ms, drawn, port)
    seqs = [torch.randint(0, cfg["vocab_size"], (n,)) for n in (9, 23)]
    ref = Reference(cfg, drawn).logits(seqs, [torch.arange(len(s)) for s in seqs])
    from repro_torch.parallel.context import ParallelContext
    for s, r in zip(seqs, ref):
        got, _, _ = port["T"].forward_full(tree, s[None], ms=ms, pc=ParallelContext())
        assert (got[0] - r).abs().max().item() < 2e-4


def test_pairs_and_the_port_plan_agree():
    for family in ("dense", "mamba"):
        cfg = tiny(family)
        assert weights.lp_pairs(cfg) == [(2, 3), (4, 5)]
    cfg = dict(tiny("dense"), lp={"effective_depth": 5, "pairs_end": 4})
    with pytest.raises(ValueError, match="pairs"):
        program.structure(cfg, program.import_port())


def test_the_port_refuses_other_sizes():
    cfg = dict(tiny("dense"), intermediate_size=256)
    with pytest.raises(ValueError, match="differs"):
        program.structure(cfg, program.import_port())


def test_weights_repeat_from_the_seed():
    cfg = tiny("mamba", "bfloat16")
    a, b = weights.draw(cfg, 7, "cpu"), weights.draw(cfg, 7, "cpu")
    assert torch.equal(a["flat"], b["flat"])
    assert not torch.equal(a["flat"], weights.draw(cfg, 8, "cpu")["flat"])
    lw = a["layers"][0]
    assert torch.equal(lw["A_log"][0].float(),
                       torch.log(torch.arange(1, 9, dtype=torch.float32)).bfloat16().float())
    dt = torch.nn.functional.softplus(lw["dt_bias"].float())
    assert dt.min() > 5e-4 and dt.max() < 0.2
