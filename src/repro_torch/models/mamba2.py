"""Mamba2 (SSD, state-space duality) layer: chunked train/prefill and
one-token decode (torch counterpart of ``repro/models/mamba2.py``).

The minimal SSD formulation (Dao & Gu 2024): a quadratic term within each
chunk and an inter-chunk recurrence that passes the state, a loop over the
``S / chunk`` chunks.  Decode is the O(1) state update, so a step costs the
same at any context length.  The projections are stored split (``wz``,
``wx``, ``wb``, ``wc``, ``wdt``) and so is the depthwise causal convolution,
one per stream, under the reference's parameter names.

Dtypes follow the reference's promotions: the SSM state and ``dt`` are
float32, the convolution state is in the model's dtype, and the layer's
output in its input's.  The reference's three-operand einsums are written
as pairwise products in its order, so no contraction order chosen by the
library can materialise a ``(b, c, q, s, g, r, p)`` tensor (about 86 GB
for mamba2-2.7b at 32k tokens).  This module reaches no TPU kernel and
holds none.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


class Mamba2(nn.Module):
    """``wz``/``wx (d, d_inner)``, ``wb``/``wc (d, G*N)``, ``wdt (d, H)``,
    the convolutions ``conv_w* (d_conv, C)`` and ``conv_b* (C,)`` per
    stream, ``a_log``/``d_skip``/``dt_bias (H,)`` in float32,
    ``norm_scale (d_inner,)`` and ``out_proj (d_inner, d)``.  Without a
    generator the tensors are left uninitialised (for loading)."""

    def __init__(self, d_model: int, *, d_state: int, head_dim: int = 64,
                 expand: int = 2, d_conv: int = 4, n_groups: int = 1,
                 dtype=torch.bfloat16, device=None,
                 g: torch.Generator = None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        gn = n_groups * d_state
        f32 = dict(dtype=torch.float32, device=device)

        def dense(d_in, d_out):
            if g is None:
                return torch.empty((d_in, d_out), dtype=dtype, device=device)
            return L.dense_init(g, d_in, d_out, dtype, device)

        def conv(c):
            if g is None:
                return torch.empty((d_conv, c), dtype=dtype, device=device)
            return L.normal_init(g, (d_conv, c), 0.1, dtype, device)

        def zeros(c, dt=dtype):
            return torch.zeros((c,), dtype=dt, device=device)

        tensors = {
            "wz": dense(d_model, d_inner), "wx": dense(d_model, d_inner),
            "wb": dense(d_model, gn), "wc": dense(d_model, gn),
            "wdt": dense(d_model, n_heads),
            "conv_wx": conv(d_inner), "conv_bx": zeros(d_inner),
            "conv_wb": conv(gn), "conv_bb": zeros(gn),
            "conv_wc": conv(gn), "conv_bc": zeros(gn),
            "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
            "d_skip": torch.ones((n_heads,), **f32),
            "dt_bias": zeros(n_heads, torch.float32),
            "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
            "out_proj": dense(d_inner, d_model),
        }
        for name, t in tensors.items():
            setattr(self, name, L._param(t))


def _causal_conv(w: torch.Tensor, bias: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU over the sequence dim.  x: (B, S, C)."""
    d_conv = w.shape[0]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i: i + x.shape[1], :] * w[i] for i in range(d_conv))
    return F.silu(out + bias)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P)   dt: (B, S, H)   a: (H,) negative decay rates
    b, c: (B, S, G, N) with G groups broadcast over heads.
    Returns (y (B,S,H,P), final_state (B,H,P,N) float32).
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    assert S % chunk == 0
    nch = S // chunk
    rep = H // G

    # heads split as (g, r): no head-repeated B/C tensors
    xr = x.reshape(B, nch, chunk, G, rep, P)
    dtr = dt.reshape(B, nch, chunk, G, rep)
    bg = b.reshape(B, nch, chunk, G, N)
    cg = c.reshape(B, nch, chunk, G, N)

    da = dtr * a.reshape(G, rep)[None, None, None]        # (B,c,Q,G,r) < 0
    da_cs = torch.cumsum(da, dim=2)
    # within-chunk decay L[q, s] = exp(sum_{s<t<=q} da_t), lower-triangular.
    # seg is masked BEFORE exp: above the diagonal it is large and positive,
    # and although the outer where() drops exp(inf) in the forward, the
    # backward would compute 0 * inf = NaN.
    seg = da_cs[:, :, :, None] - da_cs[:, :, None, :]     # (B,c,Q,Q,G,r)
    qi = torch.arange(chunk, device=x.device)
    tri = (qi[:, None] >= qi[None, :])[None, None, :, :, None, None]
    Lmat = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)

    xdt = xr * dtr[..., None]                             # (B,c,Q,G,r,P)
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", cg, bg)       # shared across r
    # the reference's einsum(cb, L, xdt) promotes to xdt's dtype: cb * L
    # first, then the sum over s
    ydt = torch.promote_types(cb.dtype, xdt.dtype)
    cbl = cb.to(ydt)[..., None] * Lmat.to(cg.dtype).to(ydt)
    y_diag = torch.einsum("bcqsgr,bcsgrp->bcqgrp", cbl, xdt.to(ydt))
    del cbl, Lmat, seg

    # chunk-final states: einsum(bg, decay_to_end, xdt), b * decay first,
    # then the sum over q
    decay_to_end = torch.exp(da_cs[:, :, -1:] - da_cs)    # (B,c,Q,G,r)
    sdt = torch.promote_types(bg.dtype, xdt.dtype)
    bd = bg.to(sdt)[:, :, :, :, None, :] * decay_to_end.to(bg.dtype).to(
        sdt)[..., None]                                   # (B,c,Q,G,r,N)
    states = torch.einsum("bcqgrn,bcqgrp->bcgrpn", bd, xdt.to(sdt))
    del bd
    chunk_decay = torch.exp(da_cs[:, :, -1])              # (B,c,G,r)

    h = (torch.zeros((B, G, rep, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.reshape(B, G, rep, P, N).float())
    h_prevs = []
    for i in range(nch):
        h_prevs.append(h.to(states.dtype))
        h = (h * chunk_decay[:, i][..., None, None].to(h.dtype)
             + states[:, i].to(h.dtype))
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,c,G,r,P,N)

    # einsum(cg, h_prevs, decay_from_start): the sum over n, then the decay
    decay_from_start = torch.exp(da_cs)                   # (B,c,Q,G,r)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cg,
                         h_prevs.to(cg.dtype)) * decay_from_start.to(
                             cg.dtype)[..., None]
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, h.reshape(B, H, P, N)


def _projections(p: Mamba2, x: torch.Tensor):
    return x @ p.wz, x @ p.wx, x @ p.wb, x @ p.wc, x @ p.wdt


def mamba2_prefill(p: Mamba2, x: torch.Tensor, *, d_state: int,
                   head_dim: int = 64, expand: int = 2, n_groups: int = 1,
                   chunk: int = 128):
    """Full-sequence forward.  x: (B, S, d_model).  S is padded to a
    multiple of ``chunk`` for the scan.

    Returns (y, ssm_state (B,H,P,N) float32, conv_state
    (B, d_conv-1, C_x+C_b+C_c) in x's dtype).
    """
    B, S, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    z, xs_raw, b_raw, c_raw, dt = _projections(p, x)
    xs = _causal_conv(p.conv_wx, p.conv_bx, xs_raw)
    b = _causal_conv(p.conv_wb, p.conv_bb, b_raw)
    c = _causal_conv(p.conv_wc, p.conv_bc, c_raw)
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xs.reshape(B, S, n_heads, head_dim)
    bh = b.reshape(B, S, n_groups, d_state)
    ch = c.reshape(B, S, n_groups, d_state)
    pad = (-S) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bh = F.pad(bh, (0, 0, 0, 0, 0, pad))
        ch = F.pad(ch, (0, 0, 0, 0, 0, pad))
    y, h_last = ssd_chunked(xh, dt, a, bh, ch, min(chunk, xh.shape[1]))
    y = y[:, :S]
    y = y + xs.reshape(B, S, n_heads, head_dim) \
        * p.d_skip[None, None, :, None].to(y.dtype)
    y = _gated_norm(p, y.reshape(B, S, d_inner), z).to(x.dtype)
    # the last d_conv - 1 raw inputs of each stream, front-padded with
    # zeros below d_conv - 1 tokens (a copy: no view keeps the prompt's
    # projections alive)
    k = p.conv_wx.shape[0] - 1
    raw = torch.cat([t[:, max(S - k, 0):] for t in (xs_raw, b_raw, c_raw)],
                    dim=-1)
    conv_state = raw if S >= k else F.pad(raw, (0, 0, k - S, 0))
    return y @ p.out_proj, h_last, conv_state


def mamba2_forward(p: Mamba2, x: torch.Tensor, **kw) -> torch.Tensor:
    return mamba2_prefill(p, x, **kw)[0]


def mamba2_decode(p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, d_state: int,
                  head_dim: int = 64, expand: int = 2, n_groups: int = 1):
    """Single-token decode.  x: (B, 1, d_model).

    Returns (y (B,1,d_model), new_ssm_state, new_conv_state); the states
    passed in are not modified.
    """
    B, S1, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    gn = n_groups * d_state
    z, xs_raw, b_raw, c_raw, dt = _projections(p, x)
    raw = torch.cat([xs_raw, b_raw, c_raw], dim=-1)
    window = torch.cat([conv_state, raw], dim=1)         # (B, d_conv, C)
    new_conv_state = window[:, 1:, :]
    wx, wb_, wc_ = (window[..., :d_inner], window[..., d_inner:d_inner + gn],
                    window[..., d_inner + gn:])

    def conv1(w, bias, win):
        return F.silu(torch.einsum("bkc,kc->bc", win, w) + bias)

    xs = conv1(p.conv_wx, p.conv_bx, wx)
    b = conv1(p.conv_wb, p.conv_bb, wb_)
    c = conv1(p.conv_wc, p.conv_bc, wc_)
    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]        # (B,H)
    a = -torch.exp(p.a_log)
    xh = xs.reshape(B, n_heads, head_dim)
    rep = n_heads // n_groups
    bh = torch.repeat_interleave(b.reshape(B, n_groups, d_state), rep, dim=1)
    ch = torch.repeat_interleave(c.reshape(B, n_groups, d_state), rep, dim=1)
    decay = torch.exp(dt * a[None, :])                   # (B,H)
    upd = (dt[:, :, None] * xh.float())[..., None] * bh.float()[:, :, None, :]
    h_new = (ssm_state * decay[..., None, None] + upd).to(ssm_state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", h_new.float(), ch.float())
    y = y + xh.float() * p.d_skip[None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = _gated_norm(p, y, z).to(x.dtype)
    return y @ p.out_proj, h_new, new_conv_state


def _gated_norm(p: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)), Mamba2's gated output norm."""
    y = y * F.silu(z.float()).to(y.dtype)
    return L.rmsnorm(SimpleNamespace(scale=p.norm_scale), y)

