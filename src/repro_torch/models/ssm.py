"""Mamba-2 (SSD, state-space duality) block: the training forward
(``repro.models.ssm``).

``ssm_forward`` is the block at ``cache=None``: the ``__fusable__ssd``
region of the JAX package (``repro/models/ssm.py:184-188``) goes to
``ops.ssd_forward``, the hand-written kernel on a CUDA tensor. The plain
SSD forms (``ssd_chunked`` with an initial and a final state, and the
sequential ``ssd_ref``) live in ``kernels/ref.py``. The cached serving
modes (decode recurrence, chunk continuation, prefill with
``return_cache``) belong to the SSM serving slice and raise here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamDecl, rms_norm

SERVING_SLICE = ("the SSM serving slice of the port (cache modes, "
                 "init_ssm_cache, decode recurrence, chunk continuation) "
                 "is not ported yet")


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


def ssm_forward(cfg, s, p, x, cache=None, return_cache=False,
                mask=None):
    """The Mamba-2 block's training forward. x: (B, S, d); mask: optional
    (B, S) validity: pad positions become identity steps (conv input and
    dt zeroed, ``repro/models/ssm.py:165-176``). Returns (y, None)."""
    if cache is not None or return_cache:
        raise NotImplementedError(f"ssm_forward with a cache: "
                                  f"{SERVING_SLICE}")
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    z, xr, Bm, Cm, dt = _split_proj(cfg, s, x @ p["in_proj"])

    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    if mask is not None:
        conv_in = conv_in * mask[..., None].to(conv_in.dtype)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xr = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + s.d_state]
    Cm = conv_out[..., d_in + s.d_state:]

    dt = F.softplus(dt.float() + p["dt_bias"])
    if mask is not None:
        dt = dt * mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(*xr.shape[:-1], nh, s.head_dim)
    # the __fusable__ssd region at a zero initial state, y only
    y = ops.ssd_forward(xh, dt, A, Bm, Cm, p["D"].float(), s.chunk_size)
    y = y.reshape(*x.shape[:-1], d_in)
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return (y @ p["out_proj"]).to(x.dtype), None
