"""The benchmark's weights, drawn from the seed: one flat buffer in the
served type, filled by a few large draws on the device, then cut into
per-layer views in a fixed order and shaped leaf by leaf (a scale, or a
map of the normal draw). The program and the reference each get these
same bits: the program through ``program.params``, which packs them into
its own layout, the reference by drawing them again from the seed once the
program is gone.

Orientation: every matrix is [in, out] (``y = x @ w``).
"""
from __future__ import annotations

import math

import torch

#: Elements per draw: a few large calls, none past 32-bit indexing.
CHUNK = 1 << 30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layer_leaves(cfg: dict) -> list:
    """[(name, shape, kind, fan)] of one layer, in draw order. ``kind``:
    "normal" (times fan^-0.5), "norm" (1 + 0.1 z), "small" (0.1 z),
    "dt_bias" (the softplus inverse of a log-uniform dt in [1e-3, 1e-1]),
    "a_log" (log(1..N), not drawn)."""
    D = cfg["hidden_size"]
    if cfg["family"] == "dense":
        hd, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
        F = cfg["intermediate_size"]
        return [("ln1", (D,), "norm", 0),
                ("wq", (D, hq * hd), "normal", D),
                ("wk", (D, hkv * hd), "normal", D),
                ("wv", (D, hkv * hd), "normal", D),
                ("wo", (hq * hd, D), "normal", hq * hd),
                ("ln2", (D,), "norm", 0),
                ("w_gate", (D, F), "normal", D),
                ("w_up", (D, F), "normal", D),
                ("w_down", (F, D), "normal", F)]
    if cfg["family"] == "mamba":
        di, N = cfg["intermediate_size"], cfg["state_size"]
        K, R = cfg["conv_kernel"], cfg["time_step_rank"]
        return [("ln1", (D,), "norm", 0),
                ("w_in", (D, 2 * di), "normal", D),
                ("conv_w", (K, di), "normal", K),
                ("conv_b", (di,), "small", 0),
                ("w_x", (di, R + 2 * N), "normal", di),
                ("w_dt", (R, di), "normal", R),
                ("dt_bias", (di,), "dt_bias", 0),
                ("A_log", (di, N), "a_log", 0),
                ("D", (di,), "norm", 0),
                ("w_out", (di, D), "normal", di)]
    raise ValueError(f"unknown family {cfg['family']!r}")


def global_leaves(cfg: dict) -> list:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    out = [("tok", (V, D), "normal", D)]
    if not cfg.get("tie_word_embeddings"):
        out.append(("head", (D, V), "normal", D))
    out.append(("final_norm", (D,), "norm", 0))
    return out


def n_elements(cfg: dict) -> int:
    per = sum(math.prod(s) for _, s, _, _ in layer_leaves(cfg))
    return cfg["num_hidden_layers"] * per + sum(
        math.prod(s) for _, s, _, _ in global_leaves(cfg))


def _shape_leaf(v: torch.Tensor, kind: str, fan: int) -> None:
    if kind == "normal":
        v.mul_(fan ** -0.5)
    elif kind == "norm":
        v.mul_(0.1).add_(1.0)
    elif kind == "small":
        v.mul_(0.1)
    elif kind == "dt_bias":
        u = 0.5 * (1.0 + torch.erf(v.float() / math.sqrt(2.0)))
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        v.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif kind == "a_log":
        n = torch.arange(1, v.shape[-1] + 1, dtype=torch.float32, device=v.device)
        v.copy_(torch.log(n).expand(v.shape))
    else:
        raise ValueError(kind)


def draw(cfg: dict, seed: int, device) -> dict:
    """{"flat": the buffer, "globals": {name: view}, "layers": [{name:
    view}]} of the configuration's weights for ``seed``, on ``device``, in
    the configuration's served type."""
    dtype = DTYPES[cfg["torch_dtype"]]
    device = torch.device(device)
    flat = torch.empty(n_elements(cfg), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 64) - 1))
    for a in range(0, flat.numel(), CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    off = 0

    def take(leaves):
        nonlocal off
        out = {}
        for name, shape, kind, fan in leaves:
            n = math.prod(shape)
            v = flat[off:off + n].view(shape)
            _shape_leaf(v, kind, fan)
            out[name] = v
            off += n
        return out

    glob = take(global_leaves(cfg))
    layers = [take(layer_leaves(cfg)) for _ in range(cfg["num_hidden_layers"])]
    assert off == flat.numel()
    return {"flat": flat, "globals": glob, "layers": layers}


def lp_pairs(cfg: dict) -> list:
    """The LP pairs the configuration states: ``n - effective_depth``
    consecutive pairs ending just below layer ``pairs_end``."""
    n = cfg["num_hidden_layers"]
    want = n - cfg["lp"]["effective_depth"]
    end = cfg["lp"]["pairs_end"]
    start = end - 2 * want
    if want < 0 or start < 0 or end > n:
        raise ValueError(f"{cfg['name']}: no {want} pairs end at layer {end}")
    return [(i, i + 1) for i in range(start, end, 2)]
