"""The plain reference: the benchmark's decoder-only models in fp32 PyTorch.

Written from the models' published descriptions and the configuration
file's ``model`` section alone; it imports nothing of the program. One
forward over whole sequences, no cache, no batching across requests, no
kernels:

* RMSNorm, fp32 statistics;
* attention: q/k/v/o projections, grouped-query heads (kv head j serves
  query heads j*rep .. j*rep+rep-1), RoPE on the two halves of each head
  (where ``rope_theta`` > 0), causal softmax over scores scaled by
  1/sqrt(head_dim);
* Mamba-2 (SSD): in-projection to z, x, B, C, dt; a depthwise causal
  convolution of width W with bias over (x, B, C), then SiLU;
  dt = softplus(dt + dt_bias), A = -exp(A_log); per head
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t (B and
  C shared by the heads), taken in chunks of exact algebra; the gated norm
  RMSNorm(y * SiLU(z)) and the out-projection;
* the dense FFN and each expert: SwiGLU, silu(x Wg) * (x Wu) Wd;
* the MoE block: fp32 router logits, softmax, top-k, the top-k
  probabilities renormalised; the Switch load-balance loss
  E * sum(mean prob * share of choices) * coef; each expert takes at most
  C = 4 * ceil(ceil(T k / E * factor) / 4) (token, choice) pairs, the
  earliest in token-major order (token t's choice j is pair t k + j), and a
  dropped pair adds nothing;
* fp32 logits, mean next-token cross-entropy plus the MoE loss.

``Prec`` sets how products are taken: "fp32" (TF32 off), or "fp8", the
control: both operands of every product that the configuration takes in
bf16 rounded to float8 e4m3 under one scale per tensor (its absolute max
over 448), the product in fp32; in the backward the cotangent is rounded
the same way and both gradient products are taken so.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (its absolute max over
    448), back in fp32."""
    t = t.float()
    s = (t.abs().amax() / E4M3_MAX).clamp(min=1e-30)
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """g summed over the leading axes that broadcasting added."""
    while g.dim() > len(shape):
        g = g.sum(0)
    return g


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in e4m3, and the backward's two products
    likewise (the cotangent rounded to e4m3 under a scale of its own)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _e4m3(a), _e4m3(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _e4m3(g)
        da = qg @ qb.transpose(-1, -2)
        db = qa.transpose(-1, -2) @ qg
        return (_sum_to(da, ctx.shapes[0]), _sum_to(db, ctx.shapes[1]))


class Prec:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product the configuration takes in its compute dtype."""
        if self.kind == "fp32":
            return a.float() @ b.float()
        return _Fp8MatMul.apply(a.float(), b.float())


FP32 = Prec("fp32")


# ---------------------------------------------------------------------------
# The parameter layout
# ---------------------------------------------------------------------------


def layer_kind(model: Dict, i: int) -> str:
    pat = model.get("layer_pattern", "")
    if not pat:
        return "m" if model["family"] == "ssm" else "a"
    return pat[i % len(pat)]


def is_moe_layer(model: Dict, i: int) -> bool:
    m = model.get("moe")
    return bool(m) and i % m["every_k_layers"] == m["layer_offset"]


def period(model: Dict) -> int:
    p = max(1, len(model.get("layer_pattern", "")))
    if model.get("moe"):
        p = math.lcm(p, model["moe"]["every_k_layers"])
    return p


def param_layout(model: Dict) -> Dict:
    """{name: (shape, init)} nested as the weights are: the top-level
    leaves, and ``layers``, a list over the positions of one period of
    trees whose leaves stack the periods on a leading axis. ``init`` is
    "normal" (std 1/sqrt(shape[-2]), or of shape[-1] for a vector),
    "ones" or "zeros"."""
    d, V = model["d_model"], model["vocab_size"]
    p = period(model)
    n = model["n_layers"] // p
    out: Dict = {"embed": ((V, d), "normal"), "lm_head": ((d, V), "normal"),
                 "ln_f": {"scale": ((d,), "ones")}, "layers": []}
    for pos in range(p):
        lay: Dict = {"ln1": {"scale": ((n, d), "ones")}}
        if layer_kind(model, pos) == "a":
            a = model["attn"]
            hq, hk = a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
            lay["attn"] = {"wq": ((n, d, hq), "normal"),
                           "wk": ((n, d, hk), "normal"),
                           "wv": ((n, d, hk), "normal"),
                           "wo": ((n, hq, d), "normal")}
        else:
            s = model["ssm"]
            d_in = s["expand"] * d
            nh = d_in // s["head_dim"]
            conv = d_in + 2 * s["d_state"]
            lay["ssm"] = {
                "in_proj": ((n, d, 2 * d_in + 2 * s["d_state"] + nh),
                            "normal"),
                "conv_w": ((n, s["conv_width"], conv), "normal"),
                "conv_b": ((n, conv), "zeros"),
                "A_log": ((n, nh), "ones"), "D": ((n, nh), "ones"),
                "dt_bias": ((n, nh), "zeros"),
                "norm_scale": ((n, d_in), "ones"),
                "out_proj": ((n, d_in, d), "normal")}
        if is_moe_layer(model, pos):
            m = model["moe"]
            E, f = m["num_experts"], m["d_expert"]
            lay["ln2"] = {"scale": ((n, d), "ones")}
            lay["moe"] = {"router": ((n, d, E), "normal"),
                          "experts": {"w_gate": ((n, E, d, f), "normal"),
                                      "w_up": ((n, E, d, f), "normal"),
                                      "w_down": ((n, E, f, d), "normal")}}
        elif model.get("d_ff", 0) > 0:
            f = model["d_ff"]
            lay["ln2"] = {"scale": ((n, d), "ones")}
            lay["ffn"] = {"w_gate": ((n, d, f), "normal"),
                          "w_up": ((n, d, f), "normal"),
                          "w_down": ((n, f, d), "normal")}
        out["layers"].append(lay)
    return out


def leaves(tree, path: Tuple = ()):
    """(path, leaf) pairs, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x, positions, theta):
    """x (B, S, H, hd); the halves of each head rotated by position *
    theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[..., None] * inv                  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(model, p, x, prec: Prec, q_block: int = 1024):
    """Causal self-attention of x (B, S, d), positions 0 .. S-1."""
    a = model["attn"]
    B, S, _ = x.shape
    H, Hk, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    q = prec.mm(x, p["wq"]).reshape(B, S, H, hd)
    k = prec.mm(x, p["wk"]).reshape(B, S, Hk, hd)
    v = prec.mm(x, p["wv"]).reshape(B, S, Hk, hd)
    if a.get("rope_theta", 0) > 0:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        q, k = rope(q, pos, a["rope_theta"]), rope(k, pos, a["rope_theta"])
    rep = H // Hk
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)          # (B,H,S,hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    kpos = torch.arange(S, device=x.device)
    for s0 in range(0, S, q_block):
        qb = q[:, :, s0:s0 + q_block]
        sc = prec.mm(qb, k.transpose(-1, -2)) / math.sqrt(hd)
        qpos = kpos[s0:s0 + q_block]
        sc = sc.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        outs.append(prec.mm(torch.softmax(sc, -1), v))
    o = torch.cat(outs, 2).transpose(1, 2).reshape(B, S, H * hd)
    return prec.mm(o, p["wo"])


def swiglu(x, wg, wu, wd, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def capacity(T: int, k: int, E: int, factor: float, multiple: int = 4):
    c = math.ceil(T * k / E * factor)
    return max(multiple, multiple * math.ceil(c / multiple))


def moe(model, p, x, prec: Prec):
    """x (B, S, d): the routed experts' weighted sum and the aux loss, all
    B*S tokens routed together."""
    m = model["moe"]
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T, E, k = xt.shape[0], m["num_experts"], m["top_k"]
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, -1)
    w, idx = torch.topk(probs, k, dim=-1)
    if m.get("router_norm_topk", True):
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(probs.mean(0) * ce) * m["aux_loss_coef"]
    C = capacity(T, k, E, m["capacity_factor"])
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(T * k, device=x.device) - first[flat[order]]
    keep = rank < C
    wflat = w.reshape(-1)
    y = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    ex = p["experts"]
    for e in range(E):
        pairs = torch.nonzero((flat == e) & keep).reshape(-1)
        if pairs.numel() == 0:
            continue
        tok = pairs // k
        out = swiglu(xt[tok], ex["w_gate"][e], ex["w_up"][e],
                     ex["w_down"][e], prec)
        y = y.index_add(0, tok, out * wflat[pairs, None])
    return y.reshape(B, S, d), aux


def ssd_chunked(x, dt, A, Bm, Cm, Q: int = 256):
    """Exact chunked evaluation of h_t = exp(dt_t A) h_{t-1} + dt_t B_t
    x_t^T, y_t = C_t h_t from a zero state. x (B, S, nh, hd), dt (B, S, nh),
    A (nh,), Bm/Cm (B, S, ds). fp32 throughout."""
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    h = torch.zeros(Bsz, nh, ds, hd, dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, Q):
        xc, dtc = x[:, s0:s0 + Q].float(), dt[:, s0:s0 + Q].float()
        bc, cc = Bm[:, s0:s0 + Q].float(), Cm[:, s0:s0 + Q].float()
        n = xc.shape[1]
        cum = torch.cumsum(dtc * A, 1).transpose(1, 2)          # (B, nh, n)
        diff = cum[..., :, None] - cum[..., None, :]            # t, s
        lower = torch.ones(n, n, dtype=torch.bool,
                           device=x.device).tril()
        L = torch.exp(diff.masked_fill(~lower, float("-inf")))
        G = cc @ bc.transpose(1, 2)                             # (B, t, s)
        M = G[:, None] * L * dtc.transpose(1, 2)[:, :, None, :]
        y = M @ xc.transpose(1, 2)                              # (B,nh,n,hd)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bts,bhsp->bhtp", cc, h)
        decay = torch.exp(cum[..., -1:] - cum) * dtc.transpose(1, 2)
        h = torch.exp(cum[..., -1])[..., None, None] * h + torch.einsum(
            "bhs,bsn,bshp->bhnp", decay, bc, xc)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1)


def ssm(model, p, x, prec: Prec):
    s = model["ssm"]
    B, S, d = x.shape
    d_in = s["expand"] * d
    nh, ds, W = d_in // s["head_dim"], s["d_state"], s["conv_width"]
    zxbcdt = prec.mm(x, p["in_proj"])
    z, xr, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, ds, ds, nh], -1)
    u = torch.cat([xr, Bm, Cm], -1)
    up = F.pad(u, (0, 0, W - 1, 0))
    cw = p["conv_w"].float()
    conv = sum(up[:, i:i + S] * cw[i] for i in range(W)) + p["conv_b"].float()
    conv = F.silu(conv)
    xr, Bm, Cm = conv[..., :d_in], conv[..., d_in:d_in + ds], \
        conv[..., d_in + ds:]
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(B, S, nh, s["head_dim"])
    y = ssd_chunked(xh, dt, A, Bm, Cm) + p["D"].float()[:, None] * xh
    y = rms_norm(y.reshape(B, S, d_in) * F.silu(z), p["norm_scale"],
                 model["norm_eps"])
    return prec.mm(y, p["out_proj"])


def layer(model, pos, lp, h, prec: Prec):
    """One layer on the residual h (B, S, d): (h, aux)."""
    eps = model["norm_eps"]
    x = rms_norm(h, lp["ln1"]["scale"], eps)
    if layer_kind(model, pos) == "a":
        h = h + attention(model, lp["attn"], x, prec)
    else:
        h = h + ssm(model, lp["ssm"], x, prec)
    aux = torch.zeros((), device=h.device)
    if "ln2" in lp:
        x = rms_norm(h, lp["ln2"]["scale"], eps)
        if "moe" in lp:
            y, aux = moe(model, lp["moe"], x, prec)
        else:
            f = lp["ffn"]
            y = swiglu(x, f["w_gate"], f["w_up"], f["w_down"], prec)
        h = h + y
    return h, aux


def _period_leaves(lay, n: int):
    return tree_map(lambda t: t[n], lay)


def hidden(model, params, tokens, prec: Prec = FP32, remat: bool = False):
    """The final-norm hidden states (B, S, d) fp32 and the summed aux
    loss. ``remat``: each layer's activations recomputed in the backward
    (memory only; the same numbers)."""
    h = params["embed"][tokens].float()
    aux = torch.zeros((), device=h.device)
    p = period(model)
    for i in range(model["n_layers"]):
        lp = _period_leaves(params["layers"][i % p], i // p)
        if remat and torch.is_grad_enabled():
            h, a = checkpoint(layer, model, i % p, lp, h, prec,
                              use_reentrant=False)
        else:
            h, a = layer(model, i % p, lp, h, prec)
        aux = aux + a
    return rms_norm(h, params["ln_f"]["scale"], model["norm_eps"]), aux


def _xent_chunk(hc, w, lc):
    logits = hc @ w
    return (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lc[..., None])[..., 0]).sum()


def loss(model, params, tokens, labels, prec: Prec = FP32,
         remat: bool = True, chunk: int = 1024):
    """Mean next-token cross-entropy over every label plus the MoE loss."""
    h, aux = hidden(model, params, tokens, prec, remat)
    w = params["lm_head"].float()
    tot = torch.zeros((), device=h.device)
    for s0 in range(0, h.shape[1], chunk):
        tot = tot + checkpoint(_xent_chunk, h[:, s0:s0 + chunk], w,
                               labels[:, s0:s0 + chunk].long(),
                               use_reentrant=False)
    return tot / labels.numel() + aux


@torch.no_grad()
def logits(model, params, tokens, prec: Prec = FP32,
           rows: Optional[torch.Tensor] = None):
    """fp32 logits (len(rows), V) of one sequence ``tokens`` (S,) at the
    positions ``rows`` (all positions by default)."""
    h, _ = hidden(model, params, tokens[None], prec)
    h = h[0] if rows is None else h[0, rows]
    return h @ params["lm_head"].float()
