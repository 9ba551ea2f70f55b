"""Mamba-2 (SSD, state-space duality) block (``repro.models.ssm``): the
training forward and the cached serving modes.

The ``__fusable__ssd`` region of the JAX package
(``repro/models/ssm.py:180-188``) goes to the hand-written SSD kernel on a
CUDA tensor: ``ops.ssd_forward`` in the training forward (a zero state, y
only), ``ops.ssd_forward_state`` on the serving chunks (the cached state in,
the final state out). The single-step decode recurrence is plain tensor
code, as in the JAX package. The gated norm goes through ``ops.rms_norm``.
The plain SSD forms (``ssd_chunked`` with an initial and a final state, and
the sequential ``ssd_ref``) live in ``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDecl, model_sharded
from repro_torch.parallel import collectives as CL


def ssm_schema(cfg, s) -> Dict[str, ParamDecl]:
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return {
        "in_proj": ParamDecl((d, 2 * d_in + 2 * s.d_state + nh),
                             ("embed", "ssm_in")),
        "conv_w": ParamDecl((s.conv_width, conv_ch), (None, "ssm_conv")),
        "conv_b": ParamDecl((conv_ch,), ("ssm_conv",), "zeros"),
        "A_log": ParamDecl((nh,), ("ssm_heads",), "ones"),
        "D": ParamDecl((nh,), ("ssm_heads",), "ones"),
        "dt_bias": ParamDecl((nh,), ("ssm_heads",), "zeros"),
        "norm_scale": ParamDecl((d_in,), ("ssm_inner",), "ones"),
        "out_proj": ParamDecl((d_in, d), ("ssm_inner", "embed")),
    }


# the leaves stored cut over the model axis (ssm_in, ssm_conv, ssm_inner)
# and the dimension cut (repro/models/ssm.py:22-29)
_MODEL_DIMS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "norm_scale": 0,
               "out_proj": 0}


def whole_params(cfg, s, p, ctx):
    """The block's parameters whole on every model rank: the leaves stored
    cut over the model axis gathered (``collectives.gather_from``: every
    model rank then computes the block alike, and each keeps its slice of
    the gradient)."""
    if ctx is None or not ctx.active:
        return p
    schema = ssm_schema(cfg, s)
    return {k: (CL.gather_from(v, ctx.model_group, _MODEL_DIMS[k])
                if k in _MODEL_DIMS and model_sharded(
                    ctx, schema[k].shape[_MODEL_DIMS[k]]) else v)
            for k, v in p.items()}


def _split_proj(cfg, s, zxbcdt):
    """-> z, x, B, C, dt: views of the in-projection's output."""
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return torch.split(zxbcdt, [d_in, d_in, s.d_state, s.d_state, nh],
                       dim=-1)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv by shifted slices. x: (B, S, C); w: (W, C);
    state: (B, W-1, C) or None. Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+W-1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return y + b.to(x.dtype), new_state


def _conv_window(conv_state, conv_in, valid_len, W):
    """The conv window after the last valid token of a continuation chunk:
    the W-1 rows of concat(previous window, chunk inputs) that start at
    ``valid_len`` (() shared or (B,) per row; None = the whole chunk),
    ``repro/models/ssm.py:193-205``."""
    Bsz, S = conv_in.shape[:2]
    xp = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
    off = (torch.full((Bsz,), S, device=conv_in.device) if valid_len is None
           else torch.as_tensor(valid_len, device=conv_in.device).long()
           .reshape(-1).expand(Bsz))
    rows = off[:, None] + torch.arange(W - 1, device=conv_in.device)
    return xp[torch.arange(Bsz, device=conv_in.device)[:, None], rows]


def ssm_forward(cfg, s, p, x, cache=None, return_cache=False, mask=None,
                valid_len=None, ctx=None):
    """The Mamba-2 block. x: (B, S, d). ``cache``: None for the training
    forward and the prefill, else {"conv" (B, W-1, C), "state" (B, nh, ds,
    hd) fp32}: the single-token decode recurrence when S == 1, the chunked
    prefill continuation when S > 1 (the chunk scans on from the cached
    conv window and SSD state). ``return_cache`` on the prefill emits the
    final state. mask: optional (B, S) validity: pad positions become
    identity steps (conv input and dt zeroed, ``repro/models/ssm.py:
    165-176``). valid_len: () or (B,) valid leading tokens of a
    continuation chunk: the new conv window is taken after the last valid
    token. ``ctx``: a ranked context of the training forward, whose rank
    holds its slice of the leaves cut over the model axis
    (``whole_params``). Returns (y, new cache or None); the cache passed
    in is not written."""
    p = whole_params(cfg, s, p, ctx)
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    chunk_cont = cache is not None and x.shape[1] > 1
    z, xr, Bm, Cm, dt = _split_proj(cfg, s, x @ p["in_proj"])

    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    if mask is not None:
        conv_in = conv_in * mask[..., None].to(conv_in.dtype)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xr = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + s.d_state]
    Cm = conv_out[..., d_in + s.d_state:]

    dt = F.softplus(dt.float() + p["dt_bias"])
    if mask is not None:
        dt = dt * mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()
    xh = xr.reshape(*xr.shape[:-1], nh, s.head_dim)

    new_cache = None
    if cache is None and not return_cache:
        # the training forward: a zero initial state, y only
        y = ops.ssd_forward(xh, dt, A, Bm, Cm, D, s.chunk_size)
    elif cache is None or chunk_cont:
        # a prefill chunk: from the cached state (continuation) or a zero
        # one (prefill with return_cache), keeping the final state
        y, h_final = ops.ssd_forward_state(
            xh, dt, A, Bm, Cm, D, s.chunk_size,
            cache["state"] if chunk_cont else None)
        W = s.conv_width
        if W == 1:
            conv_entry = conv_in[:, :0]
        elif chunk_cont:
            conv_entry = _conv_window(conv_state, conv_in, valid_len, W)
        else:
            conv_entry = conv_in[:, -(W - 1):]
        new_cache = {"conv": conv_entry.to(x.dtype), "state": h_final}
    else:
        # the single-step recurrence, S == 1 (plain, as in the JAX package)
        h = cache["state"]                              # (B, nh, ds, hd)
        a = torch.exp(dt[:, 0] * A)                     # (B, nh)
        xd = (xh[:, 0] * dt[:, 0, :, None]).float()
        h = (h * a[..., None, None]
             + Bm[:, 0].float()[:, None, :, None] * xd[:, :, None, :])
        y = torch.einsum("bs,bhsp->bhp", Cm[:, 0].float(), h)
        y = y + D[None, :, None] * xh[:, 0].float()
        y = y[:, None].to(x.dtype)
        new_cache = {"conv": new_conv, "state": h}

    y = y.reshape(*x.shape[:-1], d_in)
    y = ops.rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return (y @ p["out_proj"]).to(x.dtype), new_cache

