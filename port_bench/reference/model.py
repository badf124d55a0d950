"""The benchmark's models as plain float32 PyTorch, layer by layer.

A decoder-only stack of pre-norm residual blocks, as a configuration
file's ``model`` object describes it:

* ``attn`` blocks: RMSNorm, causal multi-head attention with rotary
  positions (the two halves of each head rotated, ``theta**(-i/half)``),
  then RMSNorm and a SwiGLU FFN or a mixture of experts: a float32 router,
  softmax over ``num_experts``, the ``top_k`` largest renormalised to sum
  to one, each chosen expert a SwiGLU MLP of width ``d_ff_expert``, plus
  ``num_shared`` always-on experts as one SwiGLU MLP of ``num_shared``
  times that width (DeepSeekMoE, arXiv:2401.06066);
* ``ssm`` blocks: RMSNorm and a Mamba-1 selective SSM (arXiv:2312.00752):
  an input projection to x and z, a causal depthwise conv of
  ``d_conv`` taps on x, SiLU, a projection to (dt, B, C), ``dt =
  softplus(dt W + b)``, ``A = -exp(A_log)``, the recurrence ``h_t =
  exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t h_t + D x_t``, gated by
  SiLU(z), and an output projection;
* a final RMSNorm and the LM head (the embedding table's transpose when
  tied).

Weights are the benchmark's own tensors (``harness.weights``), read in
their served type and widened to float32 one layer at a time.  Matrix
products run with TF32 off.  Every sequence runs whole (no cache, no
batching); the Mamba recurrence is evaluated in chunks, each chunk's
local scan for all chunks at once, then the carries chunk by chunk.

``precision="fp8"`` is the control: every input of a projection (weights
per output column, activations per token) is rounded to float8 e4m3 with
its own scale before the product, the rest as above.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Q_BLOCK = 1024          # attention query rows at a time
SCAN_CHUNK = 64         # Mamba recurrence chunk


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the amax maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_(min=1e-12)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


class Plain:
    """One model: ``model`` (the configuration's ``model`` object) and
    ``weights`` (``harness.weights.reference_view``)."""

    def __init__(self, model: dict, weights: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.m = model
        self.w = weights
        self.fp8 = precision == "fp8"
        self.eps = float(model.get("norm_eps", 1e-6))
        pat = model.get("block_pattern") or (
            ("ssm",) if model["family"] == "ssm" else ("attn",))
        self.kinds = [pat[i % len(pat)] for i in range(model["num_layers"])]

    # -- pieces ------------------------------------------------------------

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) in float32 (fp8-rounded inputs under the
        control)."""
        w = w.float()
        if self.fp8:
            x, w = fake_fp8(x, -1), fake_fp8(w, -2)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * scale.float()

    def swiglu(self, x, gate, up, down) -> torch.Tensor:
        return self.lin(F.silu(self.lin(x, gate)) * self.lin(x, up), down)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, H, hd), positions 0..S-1."""
        S, _, hd = x.shape
        half = hd // 2
        freqs = 1.0 / (float(self.m.get("rope_theta", 10000.0)) ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, L: Dict, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        H, KV = m["num_heads"], m["num_kv_heads"]
        hd = m.get("head_dim") or m["d_model"] // H
        S = x.shape[0]
        q = self.rope(self.lin(x, L["mixer.wq"]).view(S, H, hd))
        k = self.rope(self.lin(x, L["mixer.wk"]).view(S, KV, hd))
        v = self.lin(x, L["mixer.wv"]).view(S, KV, hd)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        out = torch.empty_like(q)
        kpos = torch.arange(S, device=x.device)
        for lo in range(0, S, Q_BLOCK):
            hi = min(S, lo + Q_BLOCK)
            s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(hd)
            qpos = torch.arange(lo, hi, device=x.device)
            s = s.masked_fill(kpos[None, None, :hi] > qpos[None, :, None],
                              float("-inf"))
            out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                      v[:hi])
        return self.lin(out.reshape(S, H * hd), L["mixer.wo"])

    def moe(self, L: Dict, x: torch.Tensor) -> torch.Tensor:
        """x (T, D): every token of every sequence of this layer at once."""
        moe = self.m["moe"]
        probs = torch.softmax(x @ L["ffn.router"].float(), dim=-1)
        top_p, top_ids = torch.topk(probs, moe["top_k"], dim=-1)
        top_w = top_p / top_p.sum(-1, keepdim=True).clamp_(min=1e-9)
        y = torch.zeros_like(x)
        gate = L["ffn.experts.wi_gate"]
        up, down = L["ffn.experts.wi_up"], L["ffn.experts.wo"]
        for e in range(moe["num_experts"]):
            tok, slot = torch.nonzero(top_ids == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            ye = self.swiglu(x[tok], gate[e], up[e], down[e])
            y.index_add_(0, tok, ye * top_w[tok, slot, None])
        if moe.get("num_shared", 0):
            y = y + self.swiglu(x, L["ffn.shared.wi_gate"],
                                L["ffn.shared.wi_up"], L["ffn.shared.wo"])
        return y

    def ssm(self, L: Dict, x: torch.Tensor) -> torch.Tensor:
        s = self.m["ssm"]
        n, K = s.get("d_state", 16), s.get("d_conv", 4)
        d = self.m["d_model"]
        dtr = s.get("dt_rank") or max(1, d // 16)
        S = x.shape[0]
        xp, z = self.lin(x, L["mixer.in_proj"]).chunk(2, dim=-1)
        w = L["mixer.conv_w"].float()                       # (K, di)
        pad = F.pad(xp, (0, 0, K - 1, 0))
        xc = sum(pad[i:i + S] * w[i] for i in range(K))
        xc = F.silu(xc)
        dt, Bm, Cm = self.lin(xc, L["mixer.x_proj"]).split([dtr, n, n], -1)
        dt = F.softplus(self.lin(dt, L["mixer.dt_proj"])
                        + L["mixer.dt_bias"].float())
        A = -torch.exp(L["mixer.A_log"].float())            # (di, N)
        y = selective_scan(dt, xc, A, Bm, Cm)
        y = (y + L["mixer.D"].float() * xc) * F.silu(z)
        return self.lin(y, L["mixer.out_proj"])

    # -- the whole model ------------------------------------------------------

    def logits_at(self, seqs: Sequence[torch.Tensor],
                  positions: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (S_i,) the logits (n_i, V) at the
        positions ``positions[i]`` (each predicting the token after it)."""
        with _no_tf32():
            hs = [self.w["embed"][t].float() for t in seqs]
            for L, kind in zip(self.w["layers"], self.kinds):
                hs = self._layer(L, kind, hs)
            head = self.w["unembed"]
            head = self.w["embed"].T if head is None else head
            h = torch.cat([h[p] for h, p in zip(hs, positions)])
            lg = self.lin(self.norm(h, self.w["final_norm"]), head)
            return list(lg.split([len(p) for p in positions]))

    def _layer(self, L: Dict, kind: str,
               hs: List[torch.Tensor]) -> List[torch.Tensor]:
        hs = [h + (self.attention(L, self.norm(h, L["norm1.scale"]))
                   if kind == "attn"
                   else self.ssm(L, self.norm(h, L["norm1.scale"])))
              for h in hs]
        if "norm2.scale" not in L:
            return hs
        lens = [h.shape[0] for h in hs]
        x = torch.cat([self.norm(h, L["norm2.scale"]) for h in hs])
        if self.m.get("moe"):
            y = self.moe(L, x)
        else:
            y = self.swiglu(x, L["ffn.wi_gate"], L["ffn.wi_up"], L["ffn.wo"])
        return [h + yi for h, yi in zip(hs, y.split(lens))]


def selective_scan(dt, x, A, Bm, Cm, chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """y (S, D) of ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t =
    C_t . h_t`` from ``h_{-1} = 0``.  dt, x: (S, D); A: (D, N); Bm, Cm:
    (S, N).

    The sequence is cut into chunks of ``chunk`` steps (padded with dt = 0,
    x = 0, which leaves h as it is).  Pass 1 runs every chunk's recurrence
    from a zero state at once, step by step, keeping each chunk's end
    state and its total decay; the carries into the chunks then follow
    chunk by chunk; pass 2 runs every chunk again from its carry and
    contracts with C.
    """
    S, D = dt.shape
    N = A.shape[1]
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S

    def chunks(t):
        t = F.pad(t, (0, 0, 0, pad)) if pad else t
        return t.reshape(nc, c, t.shape[-1])

    dt_c, x_c, B_c, C_c = chunks(dt), chunks(x), chunks(Bm), chunks(Cm)
    dtx = dt_c * x_c
    h = dt.new_zeros(nc, D, N)
    for t in range(c):
        h.mul_(torch.exp(dt_c[:, t, :, None] * A))
        h.add_(dtx[:, t, :, None] * B_c[:, t, None, :])
    decay = torch.exp(dt_c.sum(1)[:, :, None] * A)          # (nc, D, N)
    carry = torch.empty_like(h)
    run = dt.new_zeros(D, N)
    for j in range(nc):
        carry[j] = run
        run = decay[j] * run + h[j]
    h = carry
    y = dt.new_empty(nc, c, D)
    for t in range(c):
        h.mul_(torch.exp(dt_c[:, t, :, None] * A))
        h.add_(dtx[:, t, :, None] * B_c[:, t, None, :])
        y[:, t] = torch.einsum("jdn,jn->jd", h, C_c[:, t])
    return y.reshape(nc * c, D)[:S]


class _no_tf32:
    """Float32 products in full float32 while active."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False
