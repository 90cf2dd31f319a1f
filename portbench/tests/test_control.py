"""What decides ``correct``, at a size a test run holds: the fp8 control
reads far above the program's rounding, and a run whose tokens are
altered where they are produced comes out not correct. The card's own
control readings are made by ``portbench/control.py``."""
import pytest
import torch

from cells import TINY_MIX, bench, card, tiny  # noqa: F401 (fixtures)
from portbench import run as R

#: At this size bf16 serving reads about 0.03 and the fp8 control about 0.6.
TEST_LIMIT = 0.15


def cell_run(bench, family, dtype, *, control=False, seed=2**31 + 99):
    cell = {"name": "yi6b.decode" if family == "dense" else "fmamba7b.prefill", "chips": 1}
    torch.manual_seed(0)
    return R.run_cell(bench, cell, tiny(family, dtype), TINY_MIX, seed=seed, seconds=0.5,
                      trace=False, device="cpu", control=control,
                      lim={"gap_max": {"limit": TEST_LIMIT}})


@pytest.mark.parametrize("family", ["dense", "mamba"])
def test_control_fails_where_the_program_passes(bench, family):
    res = cell_run(bench, family, "bfloat16", control=True)
    assert res["program"]["correct"], res["program"]["check"]
    assert not res["correct"], res["check"]
    prog = res["program"]["check"]["gap_max"]["value"]
    ctl = res["check"]["gap_max"]["value"]
    assert prog <= TEST_LIMIT < ctl
    assert ctl > 3 * max(prog, 0.01)


@pytest.mark.parametrize("family", ["dense", "mamba"])
def test_an_altered_token_is_caught(bench, family, monkeypatch):
    from repro_torch.serve import engine as E
    choose = E._choose

    def altered(logits, *a, **k):
        return (choose(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(E, "_choose", altered)
    res = cell_run(bench, family, "float32")
    assert not res["correct"]
    assert res["check"]["gap_max"]["value"] > TEST_LIMIT


def test_a_run_on_the_card(bench, card):
    cell, cfg, mix = R.load_cell(bench, "yi6b.prefill")
    res = R.run_cell(bench, cell, cfg, mix, seed=2**31 + 1, seconds=2, trace=False)
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"setup_s", "prompt_tok_s", "ttft_p95_ms"}


def test_a_traced_run_on_the_cpu(bench):
    """The traced path end to end at test size: the host's metrics come
    from the measured window, and the run is still judged."""
    cell = {"name": "yi6b.decode", "chips": 1}
    res = R.run_cell(bench, cell, tiny("dense", "float32"), TINY_MIX, seed=2**31 + 7,
                     seconds=0.5, trace=True, device="cpu",
                     lim={"gap_max": {"limit": TEST_LIMIT}})
    assert res["correct"], res["check"]
    assert {"step_ms.decode", "itl_p95_ms.decode", "mfu.decode"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
