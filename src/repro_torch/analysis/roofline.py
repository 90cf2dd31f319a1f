"""Roofline terms of one step on one NVIDIA H100 SXM (80 GB HBM3).

Peaks from NVIDIA's H100 data sheet, SXM part, dense rates (no sparsity),
at the card's full power limit of 700 W; a card set below it runs slower
under load, so a share of these peaks is stated beside the card's power
limit:

    peak bf16 compute : 989 TFLOP/s (tensor cores)
    HBM bandwidth     : 3.35 TB/s
    HBM capacity      : 80 GB
    NVLink bandwidth  : 450 GB/s each way (the collective term)

The three terms (seconds, per device, per step):
    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes accessed / HBM_BW
    collective = wire bytes / LINK_BW + COLL_LAT per collective

At tp = 1 there is no collective, and the term is 0. Above it,
``collective_bytes`` prices the collectives a rank's step issued, as
``parallel.context.COLLECTIVES`` records them (the dry run's record, or a
real rank's), where the JAX package parses them from the partitioned HLO.
The port counts kernel launches in its wrappers (``kernels.ops.LAUNCHES``)
where the JAX package counts ``pallas_call`` in a jaxpr.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12       # FLOP/s, bf16 dense
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9          # bytes of device memory
LINK_BW = 450e9           # bytes/s, NVLink, each way
COLL_LAT = 1e-6           # per-collective launch + hop latency


def collective_bytes(records) -> Dict[str, float]:
    """Per-rank wire bytes of a record of collectives
    (``parallel.context.COLLECTIVES``), in the JAX package's dict:
    ``all-reduce`` and ``total`` (bytes), ``count:all-reduce`` and
    ``n_ops``.

    The JAX package's ring model, with n the group's size and R the
    buffer's bytes: an all-reduce moves 2 (n - 1) / n R. Every port
    collective issues one all-reduce, so it is priced by what it issues:
    a gather of n blocks of |x| reduces a buffer of n |x| and moves 2 (n -
    1) |x|, twice what an all-gather moves (XLA's); a sum-and-scatter
    moves 2 (n - 1) / n |x| where a reduce-scatter moves (n - 1) / n |x|.
    ``computed:<kind>`` keeps the bytes of each kind the records compute
    (sum, max, gather, scatter; ``count:computed:<kind>`` their number)
    and ``axis:<axis>`` the bytes over each axis (tp, dp, data, pod), so
    the difference shows."""
    out: Dict[str, float] = {}

    def add(key, v):
        out[key] = out.get(key, 0) + v
    for r in records:
        n = r["group"]
        wire = 2.0 * r["bytes"] * (n - 1) / n
        op = r["issues"].replace("_", "-")
        add(op, wire)
        add("total", wire)
        add(f"count:{op}", 1)
        add("n_ops", 1)
        add(f"computed:{r['computed']}", wire)
        add(f"count:computed:{r['computed']}", 1)
        add(f"axis:{r['axis']}", wire)
    return out


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0
    chips: int = 1
    useful_bytes: float = 0.0  # per-device payload bytes (weights + cache)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def n_coll(self) -> float:
        return self.coll.get("n_ops", 0.0)

    @property
    def t_collective(self) -> float:
        return self.coll.get("total", 0.0) / LINK_BW + COLL_LAT * self.n_coll

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs (per device)."""
        per_dev = self.model_flops / self.chips
        return per_dev / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Time the step would take doing only USEFUL work at the binding
        peak, over the bound time: MFU where compute binds, the payload's
        share of HBM traffic where bandwidth binds (decode)."""
        per_dev = self.model_flops / self.chips
        t_useful = max(per_dev / PEAK_FLOPS, self.useful_bytes / HBM_BW)
        if self.t_bound == 0:
            return 0.0
        return t_useful / self.t_bound

    def row(self) -> Dict[str, object]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops": self.flops / 1e9,
            "hlo_gbytes": self.bytes_accessed / 1e9,
            "coll_gbytes": self.coll.get("total", 0.0) / 1e9,
            "coll_ops": self.n_coll,
            "t_coll_latency_s": COLL_LAT * self.n_coll,
            "model_gflops_total": self.model_flops / 1e9,
            "useful_fraction": self.useful_fraction,
            "useful_gbytes": self.useful_bytes / 1e9,
            "bw_utilization": (self.useful_bytes / self.bytes_accessed
                               if self.bytes_accessed else 0.0),
            "roofline_fraction": self.roofline_fraction,
        }


def attention_flops(cfg, shape, *, tp: int = 1) -> float:
    """GLOBAL attention-core FLOPs of one step (qk^T + pv = 4 * visible
    keys * hd per query and head), which ``model_flops`` leaves out."""
    specs = cfg.layer_specs()
    S = shape.seq_len
    hd = cfg.head_dim
    hq = -(-max(cfg.n_heads, 1) // tp) * tp  # padded global head count
    total = 0.0
    for spec in specs:
        m = spec.mixer
        if not m.startswith("attn"):
            continue
        if shape.step == "decode":
            if m == "attn_local" and cfg.window:
                kv = min(cfg.window, S)
            elif m == "attn_chunked" and cfg.chunk:
                kv = min(cfg.chunk, S)
            else:
                kv = S
            per_seq = 4.0 * kv * hd * hq
            total += per_seq * shape.global_batch
            if spec.cross_attn:
                total += 4.0 * cfg.enc_seq * hd * hq * shape.global_batch
        else:
            if m == "attn_local" and cfg.window:
                vis = S * min(cfg.window, S)  # ~window per query
            elif m == "attn_chunked" and cfg.chunk:
                c = min(cfg.chunk, S)
                vis = (S // max(c, 1)) * (c * (c + 1) / 2)
            elif m == "attn_bidir":
                vis = S * S
            else:
                vis = S * (S + 1) / 2  # causal
            per_seq = 4.0 * vis * hd * hq
            total += per_seq * shape.global_batch
            if spec.cross_attn:
                total += 4.0 * S * cfg.enc_seq * hd * hq * shape.global_batch
    if cfg.enc_layers and shape.step != "decode":
        total += cfg.enc_layers * 4.0 * cfg.enc_seq ** 2 * hd * hq * shape.global_batch
    # train: forward + backward (2x fwd for the two grad matmuls each)
    if shape.step == "train":
        total *= 3.0
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N·D train, 2·N·D prefill, 2·N·B decode
    (N = active params excl. embeddings — the standard MFU convention)."""
    n_active = cfg.param_count(active_only=True)
    n_embed = cfg.vocab_size * cfg.d_model
    n = n_active - n_embed  # lm-head matmul is counted, lookup is not
    if shape.step == "train":
        return 6.0 * n * shape.tokens
    if shape.step == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
