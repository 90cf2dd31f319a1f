"""The window's arithmetic on synthetic step logs."""
import math

import pytest

from portbench import run as R
from portbench.window import StepLog, percentile


def steps(durations, tokens=10, prompt=100, ttft=0.1):
    out, t = [], 0.0
    for d in durations:
        out.append(StepLog(t, t + d, prompt_tokens=prompt, decode_tokens=tokens,
                           ttft=[ttft + d], itl=[d] * tokens))
        t += d
    return out


def read(name, logs):
    return R.reader(name)(R.Run({}, {}, logs, None))


def test_rates_are_all_the_work_over_all_the_time():
    logs = steps([0.1] * 10)
    assert read("out_tok_s", logs) == pytest.approx(100.0)
    assert read("prompt_tok_s", logs) == pytest.approx(1000.0)
    assert read("step_ms.decode", logs) == pytest.approx(100.0)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    calm, stalled = steps([0.1] * 20), steps([0.1] * 17 + [1.0] * 3)
    assert read("out_tok_s", stalled) < read("out_tok_s", calm)
    assert read("ttft_p95_ms", stalled) > read("ttft_p95_ms", calm)
    assert read("itl_p95_ms.decode", stalled) > read("itl_p95_ms.decode", calm)


def test_a_failed_request_counts_as_missing():
    logs = steps([0.1] * 19)
    logs.append(StepLog(1.9, 2.0, ttft=[math.inf], failed=[7]))
    assert read("ttft_p95_ms", logs) == pytest.approx(200.0)
    logs[-1].ttft.append(math.inf)
    assert read("ttft_p95_ms", logs) == math.inf   # 2 of 21 beyond the 95th


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile([3.0], 95) == 3.0


def test_pad_share_and_mfu():
    logs = [StepLog(0.0, 1.0, prompt_tokens=300, pad_tokens=100, decode_tokens=0)]
    assert read("pad_share.prefill", logs) == pytest.approx(25.0)
    cfg = {"family": "dense", "hidden_size": 8, "head_dim": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "intermediate_size": 16, "num_hidden_layers": 3,
           "vocab_size": 10}
    n = 3 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16) + 8 * 10
    got = R.reader("mfu.prefill")(R.Run(cfg, {}, logs, None))
    assert got == pytest.approx(100.0 * 2 * n * 300 / 989e12)


def test_host_metrics_read_the_measured_window_and_rooflines_the_traced_one():
    from portbench.trace import Trace
    measured = [StepLog(0.0, 0.1, decode_tokens=4, decode_ctx=[100] * 4)]
    traced = [StepLog(0.2, 0.5, decode_tokens=2, decode_ctx=[3000] * 2)]
    trace = Trace.from_events([("decode_mma_kernel<128, true, false>", 0, 10**6)],
                              [("portbench.window", 0, 4 * 10**6)])
    cfg = {"family": "dense", "num_hidden_layers": 32, "hidden_size": 4096,
           "head_dim": 128, "num_attention_heads": 32, "num_key_value_heads": 4}
    run = R.Run(cfg, {}, measured, trace, traced)
    assert R.reader("step_ms.decode")(run) == pytest.approx(100.0)
    assert R.reader("idle_share.decode")(run) == pytest.approx(75.0)
    roof = R.reader("paged_decode_roofline.decode")
    from portbench import roofline
    want = 100.0 * roofline.bound_s(0.0, roofline.paged_decode_bytes(cfg, [3000] * 2)) / 1e-3
    assert roof(run) == pytest.approx(want)


def test_median_first_token_time():
    logs = steps([0.1] * 9 + [1.0])
    assert read("ttft_p50_ms", logs) == pytest.approx(200.0)
