"""The system under test, as the benchmark drives it: the port
(``repro_torch``, under ``src/`` of the checkout) built from a
configuration file and the benchmark's own weights. This is the only
module of the benchmark that imports the program.

Everything here is the program's side: its structure and LP plan (held to
the ones the configuration states), its packed weights, its engine. The
reference never sees any of it.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

from portbench import weights as W

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
#: Kernel and extension caches: fixed paths inside the checkout.
CACHE = ROOT / "build" / "portbench"


def import_port():
    """Put the checkout's ``src`` on the path and import the port; the
    extension caches of torch and triton go under the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core import lp
    from repro_torch.kernels import build, ops
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_map
    from repro_torch.serve import PagedEngine, PagedServeConfig
    from repro_torch.serve.scheduler import FAILED, TERMINAL_STATES
    return dict(get_config=get_config, lp=lp, build=build, ops=ops, T=T,
                PagedEngine=PagedEngine, PagedServeConfig=PagedServeConfig,
                FAILED=FAILED, TERMINAL_STATES=TERMINAL_STATES,
                tree_map=tree_map)


def build_kernels() -> dict:
    """Compile the port's CUDA sources that are not built yet (the port
    keeps them under ``build/kernels`` of the checkout)."""
    return import_port()["build"].build_all()


#: The configuration file's keys and the port's ArchConfig fields they fix.
DENSE_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
              "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
              "head_dim": "head_dim", "intermediate_size": "d_ff",
              "vocab_size": "vocab_size", "rope_theta": "rope_theta"}
MAMBA_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
              "intermediate_size": "d_inner", "state_size": "ssm_state",
              "conv_kernel": "ssm_conv", "time_step_rank": "dt_rank",
              "vocab_size": "vocab_size"}


def arch_config(cfg: dict, port: dict):
    """The port's ArchConfig of the configuration, held to the file's
    sizes: a size the port does not state as the file does raises."""
    arch = port["get_config"](cfg["port_arch"])
    keys = DENSE_KEYS if cfg["family"] == "dense" else MAMBA_KEYS
    wrong = {k: (cfg[k], getattr(arch, f)) for k, f in keys.items()
             if getattr(arch, f) != cfg[k]}
    if wrong or bool(arch.tie_embeddings) != bool(cfg.get("tie_word_embeddings")):
        raise ValueError(f"{cfg['name']}: the port's {arch.name} differs from the "
                         f"configuration: {wrong or 'tie_word_embeddings'}")
    return arch


def structure(cfg: dict, port: dict):
    arch = arch_config(cfg, port)
    plan = port["lp"].plan_for_depth(arch, cfg["lp"]["effective_depth"])
    if [tuple(p) for p in plan.pairs] != W.lp_pairs(cfg):
        raise ValueError(f"{cfg['name']}: the port pairs {plan.pairs}, the "
                         f"configuration {W.lp_pairs(cfg)}")
    return port["T"].build_structure(arch, plan=plan)


def _layer_tree(cfg: dict, lw: dict) -> dict:
    if cfg["family"] == "dense":
        return {"ln1": {"scale": lw["ln1"]}, "ln2": {"scale": lw["ln2"]},
                "attn": {k: lw[k] for k in ("wq", "wk", "wv", "wo")},
                "mlp": {k: lw[k] for k in ("w_gate", "w_up", "w_down")}}
    return {"ln1": {"scale": lw["ln1"]},
            "mamba": {k: lw[k] for k in ("w_in", "conv_w", "conv_b", "w_x", "w_dt",
                                         "dt_bias", "A_log", "D", "w_out")}}


def params(cfg: dict, ms, drawn: dict, port: dict) -> dict:
    """The program's weight tree, packed by the port's own LP merge
    (``core.lp.lp_convert``) from the benchmark's per-layer weights; no
    leaf shares the drawn buffer, which the caller can then free."""
    layers = [_layer_tree(cfg, lw) for lw in drawn["layers"]]
    segments, seg_params = port["lp"].lp_convert(ms.cfg, layers, ms.plan)
    if tuple(segments) != tuple(ms.segments):
        raise ValueError("lp_convert's segments differ from the structure's")
    g = drawn["globals"]
    embed = {"tok": g["tok"]}
    if "head" in g:
        embed["head"] = g["head"]
    tree = {"embed": embed, "segments": seg_params,
            "final_norm": {"scale": g["final_norm"]}}
    base = drawn["flat"].untyped_storage().data_ptr()
    return port["tree_map"](
        lambda t: t.clone() if t.untyped_storage().data_ptr() == base else t, tree)


def serve_config(cfg: dict, clients: int, port: dict, *, profile: bool):
    e = cfg["engine"]
    buckets = e["prefill_buckets"]
    return port["PagedServeConfig"](
        n_slots=clients, page_size=e["page_size"], max_len=e["max_len"],
        n_pages=clients * e["max_len"] // e["page_size"] + 1,
        prefill_token_budget=e["prefill_token_budget"],
        prefill_buckets=None if buckets == "auto" else tuple(buckets),
        temperature=0.0, cache_dtype=W.DTYPES[e["cache_dtype"]], eos_token=-1,
        prefix_cache=bool(e["prefix_cache"]), profile_decode=profile)
