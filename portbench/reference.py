"""The plain reference: the configurations' models in float32 PyTorch,
with no kernel, no cache and no batching of the program's. It imports
nothing of the program; it works out the LP pairing from the
configuration file (``weights.lp_pairs``) and takes the weights that
``weights.draw`` makes from the seed.

Equations, as the configurations state them:

* dense (LLaMA): ``h = x + attn(rms1(x)); y = h + mlp(rms2(h))``; an LP
  pair (k, k+1) reads one input for both layers of each phase: ``a = x +
  attn_k(rms1_k(x)) + attn_k+1(rms1_k+1(x))``, ``y = a + mlp_k(rms2_k(a)) +
  mlp_k+1(rms2_k+1(a))``. Rotary embeddings rotate halves; query head h
  reads kv head h // (heads / kv heads); the MLP is ``(silu(x wg) * x wu)
  wd``.
* mamba (Mamba-1): ``y = x + mix(rms(x))`` (a pair sums both layers' mixes
  of one input), with ``[u; z] = x w_in``, ``c = silu(causal_conv(u))``,
  ``[r; B; C] = c w_x``, ``dt = softplus(r w_dt + dt_bias)``, ``h_t =
  exp(dt_t A) h_t-1 + dt_t c_t B_t`` with ``A = -exp(A_log)``, ``y_t = h_t
  C_t + D c_t``, ``mix = (y * silu(z)) w_out``.

``quant="fp8"`` is the control: every product with a weight matrix takes
both operands rounded to float8 e4m3 (a scale per row of the activations
and per column of the weight), the arithmetic of an fp8 GEMM, and
everything else in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.weights import lp_pairs

E4M3_MAX = 448.0
SCAN_CHUNK = 128


def fp32_matmuls() -> None:
    """No TF32 in the reference's float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: dict, weights: dict, *, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.cfg = cfg
        self.w = weights
        self.quant = quant
        self.eps = cfg.get("rms_norm_eps", cfg.get("layer_norm_epsilon"))
        self.pair_of = {i: j for i, j in lp_pairs(cfg)}

    # -- pieces ---------------------------------------------------------
    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.quant == "fp8":
            return _q8(x, -1) @ _q8(w, 0)
        return x @ w

    def rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * g.float()

    def groups(self):
        """Layer groups in order: (k,) or (k, k + 1) for a pair."""
        n, k = self.cfg["num_hidden_layers"], 0
        while k < n:
            if k in self.pair_of:
                yield (k, self.pair_of[k])
                k += 2
            else:
                yield (k,)
                k += 1

    # -- dense ----------------------------------------------------------
    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [L, H, hd] at positions 0..L-1, halves rotated."""
        L, _, hd = x.shape
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attn(self, p: dict, xn: torch.Tensor, lens: list) -> torch.Tensor:
        """xn [sum(lens), D]: the sequences laid end to end; projections
        over all rows at once, the causal core per sequence."""
        c = self.cfg
        hd, hq, hkv = c["head_dim"], c["num_attention_heads"], c["num_key_value_heads"]
        g = hq // hkv
        q, k, v = (self.lin(xn, p[n]) for n in ("wq", "wk", "wv"))
        out, a = [], 0
        for L in lens:
            qi = self._rope(q[a:a + L].view(L, hq, hd)).view(L, hkv, g, hd)
            ki = self._rope(k[a:a + L].view(L, hkv, hd))
            vi = v[a:a + L].view(L, hkv, hd)
            s = torch.einsum("qngd,knd->ngqk", qi, ki) * hd ** -0.5
            causal = torch.ones(L, L, dtype=torch.bool, device=xn.device).tril()
            s = s.masked_fill(~causal, float("-inf"))
            out.append(torch.einsum("ngqk,knd->qngd", torch.softmax(s, -1), vi)
                       .reshape(L, hq * hd))
            a += L
        return self.lin(torch.cat(out), p["wo"])

    def _mlp(self, p: dict, xn: torch.Tensor) -> torch.Tensor:
        return self.lin(F.silu(self.lin(xn, p["w_gate"])) * self.lin(xn, p["w_up"]),
                        p["w_down"])

    def _dense_group(self, ids, x: torch.Tensor, lens: list) -> torch.Tensor:
        ps = [{k: v.float() for k, v in self.w["layers"][i].items()} for i in ids]
        a = x + sum(self._attn(p, self.rms(x, p["ln1"]), lens) for p in ps)
        return a + sum(self._mlp(p, self.rms(a, p["ln2"])) for p in ps)

    # -- mamba ----------------------------------------------------------
    def _mix(self, p: dict, xn: torch.Tensor) -> torch.Tensor:
        """xn [B, L, D] (right-padded rows: the recurrence is causal)."""
        c = self.cfg
        Bn, L, _ = xn.shape
        di, N, K, R = (c["intermediate_size"], c["state_size"], c["conv_kernel"],
                       c["time_step_rank"])
        u, z = self.lin(xn, p["w_in"]).split(di, dim=-1)
        cw = p["conv_w"].float()
        conv = p["conv_b"].float().expand(Bn, L, di).clone()
        for j in range(K):
            shift = K - 1 - j
            conv[:, shift:] += u[:, :L - shift] * cw[j]
        cx = F.silu(conv)
        r, Bm, Cm = self.lin(cx, p["w_x"]).split([R, N, N], dim=-1)
        dt = F.softplus(self.lin(r, p["w_dt"]) + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())                            # [di, N]
        h = torch.zeros(Bn, di, N, dtype=torch.float32, device=xn.device)
        y = torch.empty(Bn, L, di, dtype=torch.float32, device=xn.device)
        for t0 in range(0, L, SCAN_CHUNK):
            t1 = min(L, t0 + SCAN_CHUNK)
            dA = torch.exp(dt[:, t0:t1, :, None] * A)
            dBx = (dt[:, t0:t1] * cx[:, t0:t1])[..., None] * Bm[:, t0:t1, None, :]
            hs = torch.empty_like(dA)
            for t in range(t1 - t0):
                torch.addcmul(dBx[:, t], dA[:, t], h, out=hs[:, t])
                h = hs[:, t]
            y[:, t0:t1] = (hs * Cm[:, t0:t1, None, :]).sum(-1)
        y = (y + p["D"].float() * cx) * F.silu(z)
        return self.lin(y, p["w_out"])

    def _mamba_group(self, ids, x: torch.Tensor, lens: list) -> torch.Tensor:
        """The sequences right-padded into one batch for the scan (the
        recurrence is causal, so padding changes no real row)."""
        ps = [{k: v.float() for k, v in self.w["layers"][i].items()} for i in ids]
        X = torch.zeros(len(lens), max(lens), x.shape[1], dtype=torch.float32,
                        device=x.device)
        offs = [0]
        for b, L in enumerate(lens):
            X[b, :L] = x[offs[-1]:offs[-1] + L]
            offs.append(offs[-1] + L)
        Y = sum(self._mix(p, self.rms(X, p["ln1"])) for p in ps)
        return x + torch.cat([Y[b, :L] for b, L in enumerate(lens)])

    # -- whole model ----------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: list, at: list) -> list:
        """seqs: token id tensors [L_i]; at: index tensors into each.
        Returns, per sequence, the float32 logits [len(at_i), V] of the
        next token after each position in ``at_i``."""
        g = self.w["globals"]
        lens = [len(s) for s in seqs]
        x = g["tok"][torch.cat(seqs).long()].float()
        group = self._dense_group if self.cfg["family"] == "dense" else self._mamba_group
        for ids in self.groups():
            x = group(ids, x, lens)
        head = g["tok"].T if self.cfg.get("tie_word_embeddings") else g["head"]
        offs = torch.tensor([0] + lens[:-1], device=x.device).cumsum(0)
        rows = torch.cat([o + i.long() for o, i in zip(offs, at)])
        out = self.lin(self.rms(x[rows], g["final_norm"]), head.float())
        return list(out.split([len(i) for i in at]))
