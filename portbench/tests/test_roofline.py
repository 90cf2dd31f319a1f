"""Each roofline count against a hand count for one shape, and the trace
arithmetic (busy time as a union, idle gaps by host span)."""
import pytest

from portbench import roofline as R
from portbench.trace import Trace

YI = {"family": "dense", "num_hidden_layers": 32, "hidden_size": 4096, "head_dim": 128,
      "num_attention_heads": 32, "num_key_value_heads": 4, "intermediate_size": 11008,
      "vocab_size": 64000}
MAMBA = {"family": "mamba", "num_hidden_layers": 64, "hidden_size": 4096,
         "intermediate_size": 8192, "state_size": 16, "conv_kernel": 4,
         "time_step_rank": 256, "vocab_size": 65024}


def test_paged_decode_bytes_by_hand():
    # two rows reading 1000 and 3000 positions: q and out 32 x 128 bf16
    # each per row, k and v 4 x 128 bf16 each per position, 32 layers
    got = R.paged_decode_bytes(YI, [1000, 3000])
    hand = 32 * (2 * (2 * 32 * 128 * 2) + 4000 * (2 * 4 * 128 * 2))
    assert got == hand
    assert 4000 * 32 * 2 * 4 * 128 * 2 == 4000 * 65536    # 64 KiB a position


def test_flash_prefill_by_hand():
    ops, byts = R.flash_prefill(YI, [4])
    # 10 causal pairs, 4 * 128 flops each per head (QK and PV), 32 heads
    assert ops == 32 * 32 * 10 * 4 * 128
    assert byts == 32 * 4 * (2 * 32 * 128 + 2 * 4 * 128) * 2


def test_ssm_scan_bytes_by_hand():
    got = R.ssm_scan_bytes(MAMBA, [10])
    assert got == 64 * (3 * 10 + 2) * 8192 * 16 * 4


def test_model_flops_is_two_n():
    n = R.matmul_params(YI)
    assert abs(n - 6.06e9 + 64000 * 4096) < 0.05e9      # 6.06 B less the lookup
    assert R.model_flops(YI, 3) == 6 * n
    assert R.attn_layers(MAMBA) == 0 and R.ssm_scan_bytes(YI, [5]) == 0


def test_bound_takes_the_larger_term():
    assert R.bound_s(989e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_trace_busy_union_and_idle_attribution():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60), ("k1", 90, 100)]
    spans = [("portbench.window", 0, 100), ("portbench.step", 0, 70),
             ("paged_decode_main", 35, 45), ("portbench.account", 70, 95)]
    tr = Trace.from_events(dev, spans)
    assert tr.busy_intervals() == [(10, 30), (50, 60), (90, 100)]
    assert tr.busy_s == pytest.approx(40e-9)
    assert tr.window_s == pytest.approx(100e-9)
    gaps = dict((n, v) for n, v in tr.idle_gaps())
    # 0-10 step, 30-50 mid 40 decode, 60-90 mid 75 account
    assert gaps == {"portbench.step": pytest.approx(10e-9),
                    "paged_decode_main": pytest.approx(20e-9),
                    "portbench.account": pytest.approx(30e-9)}
    secs, names = tr.kernel_s("k1")
    assert secs == pytest.approx(20e-9) and names == ["k1"]
    assert tr.device_ops()[0][0] == "k1"
