"""Small configurations of the port's model families, and the fixtures of
the CPU tests. Each is the port's ``reduced_config`` twin of its model,
registered with the port under the name the configuration gives, so the
program and the reference run the same tiny model."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import program  # noqa: E402

program.import_port()
from repro_torch.configs import get_config, list_archs, reduced_config, register  # noqa: E402

#: The tiny architectures: (name, the port's model, fields that differ).
TINY_ARCHS = (("portbench-tiny-dense", "yi-6b", {"n_kv_heads": 2}),
              ("portbench-tiny-mamba", "falcon-mamba-7b", {}))
for _name, _base, _fields in TINY_ARCHS:
    if _name not in list_archs():
        register(dataclasses.replace(reduced_config(get_config(_base), n_layers=6),
                                     name=_name, **_fields))

ENGINE = {"page_size": 16, "max_len": 64, "prefill_token_budget": 128,
          "prefill_buckets": "auto", "prefix_cache": False}


def tiny(family: str, dtype: str = "float32") -> dict:
    common = {"num_hidden_layers": 6, "hidden_size": 128, "vocab_size": 512,
              "tie_word_embeddings": False, "torch_dtype": dtype,
              "lp": {"effective_depth": 4, "pairs_end": 6},
              "engine": dict(ENGINE, cache_dtype=dtype)}
    if family == "dense":
        return {"name": "tiny-dense", "family": "dense", "port_arch": "portbench-tiny-dense",
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                "intermediate_size": 512, "rope_theta": 5e6, "rms_norm_eps": 1e-6,
                **common}
    return {"name": "tiny-mamba", "family": "mamba", "port_arch": "portbench-tiny-mamba",
            "intermediate_size": 256, "state_size": 8, "conv_kernel": 4,
            "time_step_rank": 8, "layer_norm_epsilon": 1e-6, **common}


TINY_MIX = {"name": "tiny", "loop": "closed", "clients": 4, "shared_prefix_tokens": 0,
            "stagger_first": True, "prompt": {"lengths": [8, 13, 21, 30]},
            "output": {"lengths": [3, 5, 9]},
            "index": {"prompt": [1, 1, 0], "output": [1, 2, 1]}}


@pytest.fixture
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    """Skips a test that needs the card, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
