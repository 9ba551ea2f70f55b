"""Plain PyTorch versions of the hand-written kernels.

They mirror ``repro.kernels.ref``: the CPU path runs them, and the tests and
``chip_smoke.py`` hold each CUDA kernel against them. Nothing on the main
path runs a plain forward with a CUDA tensor (``kernels/ops.py`` sends
those to the kernels); the backward of the attention, the SSD and the norm
(``flash_attention_vjp``, ``ssd_vjp``, ``rms_norm_vjp``) recomputes the
plain form under autograd on either device. The activations and the
model's ``rms_norm`` are model functions (``models/common`` names them)
kept here as the plain versions of the kernels' epilogues, so this module
imports nothing of the model layer.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def activate(name: str, gate, up):
    """gate may be None for non-GLU activations. ``gelu`` is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    if name == "relu2":
        r = F.relu(up)
        return r * r
    raise ValueError(name)


def _gelu_tanh_grad(x):
    """d gelu_tanh / dx, the derivative JAX's autodiff takes of
    ``jax.nn.gelu``."""
    k = math.sqrt(2.0 / math.pi)
    t = torch.tanh(k * (x + 0.044715 * x ** 3))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * k * (1 + 3 * 0.044715
                                                         * x * x)


def activate_vjp(name: str, gate, up, dh):
    """(dgate, dup) for h = activate(name, gate, up) and the cotangent dh,
    written out (dgate is None for non-GLU activations)."""
    if name == "swiglu":
        s = torch.sigmoid(gate)
        return dh * up * s * (1 + gate * (1 - s)), dh * gate * s
    if name == "geglu":
        return (dh * up * _gelu_tanh_grad(gate),
                dh * F.gelu(gate, approximate="tanh"))
    if name == "gelu":
        return None, dh * _gelu_tanh_grad(up)
    if name == "relu2":
        return None, dh * 2 * F.relu(up)
    raise ValueError(name)


def is_glu(name: str) -> bool:
    return name in ("swiglu", "geglu")


def _rms_norm(x, scale, eps, epilogue: str):
    """The body of rmsnorm_ref and rms_norm, also recomputed by
    rms_norm_vjp: fp32 statistics, then the epilogue's rounding."""
    h = x.float()
    r = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    if epilogue == "tpu":
        return (h * r * scale.float()).to(x.dtype)
    return (h * r).to(x.dtype) * scale.to(x.dtype)


def rmsnorm_ref(x, scale, eps=1e-5):
    """The TPU kernel's RMSNorm (the rmsnorm kernel's ``tpu`` epilogue;
    the JAX package's ``ref.rmsnorm_ref``): fp32 statistics, the scale
    multiplied in fp32, one rounding to x's dtype."""
    return _rms_norm(x, scale, eps, "tpu")


def rms_norm(x, scale, eps):
    """The model's RMSNorm (the rmsnorm kernel's ``model`` epilogue; the
    JAX package's ``models.common.rms_norm``): fp32 statistics, the
    normalised row rounded to x's dtype, times the scale rounded to x's
    dtype. In fp32 it equals rmsnorm_ref."""
    return _rms_norm(x, scale, eps, "model")


def rms_norm_vjp(x, scale, eps, ct):
    """(dx, dscale) of rms_norm for the cotangent ct, the plain form
    recomputed under autograd (the JAX package has no norm VJP kernel:
    ``jax.grad`` differentiates its jnp norm)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, scale)]
        out = _rms_norm(*ins, eps, "model")
        return torch.autograd.grad(out, ins, ct.to(out.dtype))


def split3_bf16_ref(g):
    """Three bf16 pieces p of the fp32 tensor g, stacked (3, *g.shape),
    with g == (p[0] - p[1]) - p[2] in fp32 bit for bit (signed zeros too)
    over fp32's normal range: p[0] = bf16(g), p[1] = bf16(p[0] - g), p[2]
    = bf16(p[0] - g - p[1]), the differences taken in fp32. Each is exact,
    as 24 significand bits are three times 8; taken as p[0] - g, and not g
    - p[0], a zero remainder of -0.0 keeps its sign."""
    out = torch.empty((3,) + tuple(g.shape), dtype=torch.bfloat16,
                      device=g.device)
    out[0].copy_(g)
    r = out[0] - g
    out[1].copy_(r)
    out[2].copy_(r.sub_(out[1]))
    return out


def grouped_gemm_ref(lhs, rhs, out_dtype=None):
    """lhs: (E, M, K); rhs: (E, K, N) -> (E, M, N), fp32 accumulation."""
    out = torch.bmm(lhs.float(), rhs.float())
    return out.to(out_dtype or lhs.dtype)


def fused_mlp_ref(rows, w_gate, w_up, w_down, activation):
    """Unfused expert MLP with the hidden materialized, rounding where the
    fused kernel (and the TPU kernel, fused_mlp.py:80-81) rounds: GEMM1 with
    fp32 accumulation, the activation in fp32, the hidden cast to the input
    dtype, GEMM2 with fp32 accumulation, the output cast to the input dtype.
    In fp32 it is the JAX oracle ``repro.kernels.ref.fused_mlp_ref``.
    rows: (E, R, d); w_gate/w_up: (E, d, f) (w_gate None if not GLU);
    w_down: (E, f, N) -> (E, R, N)."""
    x = rows.float()
    up = torch.bmm(x, w_up.float())
    gate = torch.bmm(x, w_gate.float()) if w_gate is not None else None
    h = activate(activation, gate, up).to(rows.dtype)
    return torch.bmm(h.float(), w_down.float()).to(rows.dtype)


def _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc):
    """(x, gate | None, up, dh) in the dtype ``acc``: the recomputed
    pre-activations and the hidden's cotangent dh = dy . w_down^T rounded
    to the input dtype, as the backward kernels compute them (the TPU
    kernels' fused_mlp.py:210-213)."""
    x = rows.to(acc)
    up = torch.bmm(x, w_up.to(acc))
    gate = torch.bmm(x, w_gate.to(acc)) if w_gate is not None else None
    dh = torch.bmm(dy.to(acc), w_down.to(acc).transpose(1, 2))
    return x, gate, up, dh.to(rows.dtype).to(acc)


def fused_mlp_dgrad_ref(rows, w_gate, w_up, w_down, dy, activation,
                        acc=torch.float32):
    """dX of the fused expert MLP, written out: dup . w_up^T +
    dgate . w_gate^T with dup/dgate rounded to the input dtype; products
    and the activation's VJP in ``acc`` (fp32 as in the kernels; fp64
    gives a second plain route with the same rounding points). w_down/dy
    may be the same column slice. -> (E, R, d)."""
    x, gate, up, dh = _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc)
    dgate, dup = activate_vjp(activation, gate, up, dh)
    dt = rows.dtype
    dx = torch.bmm(dup.to(dt).to(acc), w_up.to(acc).transpose(1, 2))
    if w_gate is not None:
        dx = dx + torch.bmm(dgate.to(dt).to(acc),
                            w_gate.to(acc).transpose(1, 2))
    return dx.to(dt)


def fused_mlp_wgrad_ref(rows, w_gate, w_up, w_down, dy, activation,
                        acc=torch.float32):
    """(dw_gate | None, dw_up, dw_down) of the fused expert MLP, written
    out: h^T . dy with h = act(gate, up) rounded to the input dtype, and
    x^T . dup / x^T . dgate with dup/dgate rounded to it; products in
    ``acc`` (see fused_mlp_dgrad_ref). With a column-sliced w_down/dy,
    dw_down is that block and dw_up/dw_gate the block's partials."""
    x, gate, up, dh = _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc)
    dgate, dup = activate_vjp(activation, gate, up, dh)
    dt = rows.dtype
    h = activate(activation, gate, up).to(dt).to(acc)
    xt = x.transpose(1, 2)
    dwd = torch.bmm(h.transpose(1, 2), dy.to(acc)).to(w_down.dtype)
    dwu = torch.bmm(xt, dup.to(dt).to(acc)).to(w_up.dtype)
    dwg = (torch.bmm(xt, dgate.to(dt).to(acc)).to(w_gate.dtype)
           if w_gate is not None else None)
    return dwg, dwu, dwd


def topk_combine_ref(rows, weights):
    """rows: (T, k, d); weights: (T, k) -> (T, d), fp32 sum cast to the
    rows' dtype."""
    out = torch.einsum("tkd,tk->td", rows.float(), weights.float())
    return out.to(rows.dtype)


def topk_combine_ordered(rows, weights):
    """topk_combine_ref summed in j order, each step a rounded fp32
    product and a rounded add: the order of the top-k combine kernel,
    whose bits it gives."""
    acc = torch.zeros(rows.shape[::2], dtype=torch.float32,
                      device=rows.device)
    w = weights.float()
    for j in range(rows.shape[1]):
        acc = acc + w[:, j, None] * rows[:, j].float()
    return acc.to(rows.dtype)


def _attention_fp32(q, k, v, causal):
    """The body of flash_attention_ref, also recomputed by its VJP."""
    hd, Hq, Hkv = q.shape[3], q.shape[1], k.shape[1]
    Sq, Sk = q.shape[2], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(keep, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, causal=True):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd).
    fp32 scores scaled after the product, -1e30 causal mask by positions
    from 0, fp32 softmax, output rounded to q's dtype (the JAX package's
    ``ref.flash_attention_ref``). Laid out as the kernels return it, a
    view of a contiguous (B, Sq, Hq, hd) tensor, so the code after it
    runs the same ops on every device."""
    out = _attention_fp32(q, k, v, causal)
    return out.transpose(1, 2).contiguous().transpose(1, 2)


def flash_attention_vjp(q, k, v, causal, ct):
    """(dq, dk, dv) of flash_attention_ref for the cotangent ct: the plain
    attention recomputed under autograd (the JAX package differentiates its
    jnp attention; the TPU kernel has no VJP)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = _attention_fp32(*ins, causal)
        return torch.autograd.grad(out, ins, ct.to(out.dtype))


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chunked SSD dual form (the JAX package's
    ``models.ssm.ssd_chunked``); its three-operand einsums are written as
    pairwise products, so no (B, NC, Q, Q, nh, hd) temporary is built.
    ``ssd_chunked_ref`` and the SSD op's backward run it.
    x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,)
    (negative); Bm/Cm: (B, S, ds); D: (nh,); h0: optional (B, nh, ds, hd)
    fp32 initial state (None = zero state). A chunk that does not divide S
    becomes one chunk of S, as in the JAX package. Returns
    (y (B, S, nh, hd) in x's dtype, h_final (B, nh, ds, hd) fp32)."""
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        Q = S
    NC = S // Q
    f32 = torch.float32

    xd = (x * dt[..., None]).to(f32)                   # discretized input
    la = (dt * A[None, None, :]).to(f32)               # log decay (<= 0)
    xc = xd.reshape(Bsz, NC, Q, nh, hd)
    lac = la.reshape(Bsz, NC, Q, nh)
    Bc = Bm.reshape(Bsz, NC, Q, ds).to(f32)
    Cc = Cm.reshape(Bsz, NC, Q, ds).to(f32)

    cum = torch.cumsum(lac, dim=2)                     # (B, NC, Q, nh)
    total = cum[:, :, -1]                              # (B, NC, nh)

    # intra-chunk: (CB * L) @ xd per head, L[i, j] = exp(cum_i - cum_j)
    # The mask goes in before the exp: above the diagonal diff >= 0 can
    # overflow exp to inf on long chunks, and where(causal, exp(diff), 0)
    # would then give 0 * inf = NaN gradients. The values are the same.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,NC,Q,Q,nh)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    CB = Cc @ Bc.transpose(-1, -2)                     # (B, NC, Q, Q)
    M = (CB[..., None] * L).permute(0, 1, 4, 2, 3)     # (B, NC, nh, Q, Q)
    y_intra = M @ xc.permute(0, 1, 3, 2, 4)            # (B, NC, nh, Q, hd)

    # chunk states: sum_j B_j exp(total - cum_j) xd_j
    decay_to_end = torch.exp(total[:, :, None, :] - cum)   # (B, NC, Q, nh)
    xw = xc * decay_to_end[..., None]                  # (B, NC, Q, nh, hd)
    states = (Bc.transpose(-1, -2) @ xw.reshape(Bsz, NC, Q, nh * hd))
    states = states.reshape(Bsz, NC, ds, nh, hd).permute(0, 1, 3, 2, 4)

    # inter-chunk recurrence, emitting the state before each chunk.
    # unbind, not states[:, n]: under autograd each index's backward fills
    # a zero tensor of the whole (B, NC, nh, ds, hd), NC times per call.
    h = (torch.zeros((Bsz, nh, ds, hd), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for decay, st in zip(torch.exp(total).unbind(1), states.unbind(1)):
        h_prev.append(h)
        h = h * decay[..., None, None] + st
    h_prev = torch.stack(h_prev, dim=1)                # (B, NC, nh, ds, hd)

    # inter-chunk output: exp(cum_i) * C_i . h_prev
    ch = Cc @ h_prev.permute(0, 1, 3, 2, 4).reshape(Bsz, NC, ds, nh * hd)
    y_inter = ch.reshape(Bsz, NC, Q, nh, hd) * torch.exp(cum)[..., None]

    y = y_intra.permute(0, 1, 3, 2, 4) + y_inter       # (B, NC, Q, nh, hd)
    y = y.reshape(Bsz, S, nh, hd) + D[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), h


def ssd_ref(x, dt, A, Bm, Cm, D, acc=None, h0=None, return_state=False):
    """Sequential SSD recurrence oracle, O(S) steps (the JAX package's
    ``ref.ssd_ref`` and ``models.ssm.ssd_reference``). x: (B, S, nh, hd);
    dt: (B, S, nh); A/D: (nh,); Bm/Cm: (B, S, ds); h0: optional
    (B, nh, ds, hd) initial state (None = a zero state). Every step in fp32
    and y in x's dtype; or, given ``acc`` (torch.float64: the oracle the
    kernels' errors are taken against), every step and y in ``acc``.
    Returns y, or (y, h_final) with ``return_state``."""
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    f32 = torch.float32 if acc is None else acc
    h = (torch.zeros((Bsz, nh, ds, hd), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A)                   # (B, nh)
        xd = xf[:, t] * dtf[:, t, :, None]             # (B, nh, hd)
        h = (h * a[..., None, None]
             + bf[:, t][:, None, :, None] * xd[:, :, None, :])
        ys.append(torch.einsum("bs,bhsp->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * xf
    y = y.to(x.dtype if acc is None else acc)
    return (y, h) if return_state else y


def _bf16_terms(v, terms):
    """v as ``terms`` bf16 terms (fp32 tensors): each is bf16 of what the
    terms before it left."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def ssd_split_ref(x, dt, A, Bm, Cm, D, h0=None, terms=2, slab=32,
                  chunk=64):
    """(y, h_final) by the tensor-core SSD kernel's arithmetic
    (csrc/ssd_hopper.cu), in plain torch: chunks of ``chunk``, slabs of
    ``slab`` head_dim columns, the cumsum as a rounded product and a
    sequential fp32 sum, every fp32 operand of a product (M = C.B^T *
    exp(cum_i - cum_j) * dt_j, h, W = x * dt * exp(total - cum)) split into
    ``terms`` bf16 terms beside the exact bf16 one (x, B or C), the
    products summed in fp32. The kernel's bits are not the aim (the sums'
    order differs): its error is, for a ``terms`` the kernel does not build
    as well. A ragged tail is padded with identity steps, as the kernel's
    zero-filled rows are. x, Bm, Cm bf16; dt, A, D, h0 fp32."""
    Bsz, S, nh, hd = x.shape
    ds, Q = Bm.shape[-1], chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf, Bf, Cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, Bm, Cm))
    h = (torch.zeros((Bsz, nh, ds, hd), device=x.device) if h0 is None
         else h0.clone())
    y = torch.empty((Bsz, nc * Q, nh, hd), device=x.device)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        la = dtf[:, sl] * A                             # rounded products
        cum = torch.empty_like(la)
        run = torch.zeros((Bsz, nh), device=x.device)
        for r in range(Q):                              # sequential sum
            run = run + la[:, r]
            cum[:, r] = run
        total = cum[:, -1]
        cb = Cf[:, sl] @ Bf[:, sl].transpose(1, 2)      # exact products
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf"))
        m = cb[..., None] * torch.exp(diff) * dtf[:, sl][:, None, :, :]
        m_terms = _bf16_terms(m, terms)                 # (B, i, j, nh)
        dec = torch.exp(total[:, None] - cum)           # (B, Q, nh)
        for p0 in range(0, hd, slab):                   # the slabs
            ps = slice(p0, p0 + slab)
            xs = xf[:, sl, :, ps]
            hs = h[..., ps]
            y_intra = sum(torch.einsum("bijh,bjhp->bihp", t, xs)
                          for t in m_terms)
            y_h = sum(torch.einsum("bis,bhsp->bihp", Cf[:, sl], t)
                      for t in _bf16_terms(hs, terms))
            y[:, sl, :, ps] = (y_intra + torch.exp(cum)[..., None] * y_h
                               + D[None, None, :, None] * xs)
            w = xs * dtf[:, sl][..., None] * dec[..., None]
            st = sum(torch.einsum("bjs,bjhp->bhsp", Bf[:, sl], t)
                     for t in _bf16_terms(w, terms))
            h[..., ps] = hs * torch.exp(total)[..., None, None] + st
    return y[:, :S].to(x.dtype), h


def _ssd_padded(x, dt, A, Bm, Cm, D, chunk, h0=None):
    """The body of ssd_chunked_ref and ssd_state_ref, also recomputed by
    the VJP: (y, h_final)."""
    S = x.shape[1]
    pad = (-S) % chunk if S > chunk else 0
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    y, h = ssd_chunked(x, dt, A, Bm, Cm, D, chunk, h0)
    return y[:, :S], h


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=64):
    """The SSD kernel's plain version: the chunked dual form from a zero
    state at ``chunk``, y only (what ``repro/kernels/ssd.py`` computes).
    A length that ``chunk`` does not divide gets a tail of identity steps
    (zero x, dt, B and C) up to the next multiple, as the kernel pads its
    last chunk; ``ssd_chunked`` itself would take one chunk of the whole
    length, whose cumulative decays lose digits to cancellation."""
    return _ssd_padded(x, dt, A, Bm, Cm, D, chunk)[0]


def ssd_state_ref(x, dt, A, Bm, Cm, D, h0=None, chunk=64):
    """The plain version of the SSD kernel with a state, the serving
    chunks' form: (y, h_final) of the chunked dual form from the initial
    state h0 ((B, nh, ds, hd) fp32; None = a zero state), a ragged tail
    padded with identity steps as in ssd_chunked_ref, so h_final is the
    state after the last real step."""
    return _ssd_padded(x, dt, A, Bm, Cm, D, chunk, h0)


def ssd_vjp(x, dt, A, Bm, Cm, D, chunk, ct, needs):
    """Gradients of ssd_chunked_ref for the cotangent ct, recomputed under
    autograd (the JAX package has no SSD backward kernel: ``jax.grad``
    differentiates the jnp form). ``needs`` flags which of the six inputs
    want a gradient; the others get None."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n)
               for t, n in zip((x, dt, A, Bm, Cm, D), needs)]
        y = _ssd_padded(*ins, chunk)[0]
        want = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad(y, want, ct.to(y.dtype)))
        return tuple(next(got) if n else None for n in needs)
