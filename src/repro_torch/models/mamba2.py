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

On a tensor-parallel mesh (``distributed/hints.py``) the mixer computes in
the reference's layout (``distributed/sharding.py``): each rank holds the
column blocks of ``wz wx wb wc wdt``, the channel blocks of the
convolutions and the row block of ``out_proj``, and the small leaves
whole, of which it uses its heads' and channels' slices (their gradients
summed over ``model``, ``hints.replicated``).  Its input is gathered with
the column-parallel products (``hints.column_products``); ``z``, ``x``,
``dt`` and the convolution of ``x`` run on its ``d_inner / C`` channels,
whole heads where ``model`` divides the heads; ``b`` and ``c`` run
through their depthwise convolutions on their channel blocks and are then
all-gathered, since every head contracts over the whole state; the scan
runs on the rank's heads; the gated RMSNorm all-reduces its float32 sums
of squares and divides by the whole ``d_inner``; ``out_proj`` returns the
rank's row-parallel partial sum.  Where the heads do not divide, every
rank gathers the columns, runs every head and feeds its column block to
``out_proj``.  The decode caches are ``cache_specs``' blocks: ``ssm`` the
rank's heads, ``conv`` a contiguous block of the concatenated ``[x | b |
c]`` channels, which does not line up with the streams' column blocks, so
a decode step builds its windows from one all-gather over ``model`` of
every rank's block and new raw inputs, and writes back only its block.
One process under a shape-only mesh runs the same arithmetic block by
block, its sums in rank order (:class:`Layout`); off a tensor-parallel
mesh the same code runs on one block that holds every channel.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints
from repro_torch.models import layers as L
from repro_torch.roofline import trace_cost as TC


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
    chunks = TC.trips("mamba2.chunks", nch, tail=2)
    for i in chunks:
        h_prevs.append(h.to(states.dtype))
        h = (h * chunk_decay[:, i][..., None, None].to(h.dtype)
             + states[:, i].to(h.dtype))
    h_prevs = torch.stack(chunks.full(h_prevs), dim=1)    # (B,c,G,r,P,N)

    # einsum(cg, h_prevs, decay_from_start): the sum over n, then the decay
    decay_from_start = torch.exp(da_cs)                   # (B,c,Q,G,r)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cg,
                         h_prevs.to(cg.dtype)) * decay_from_start.to(
                             cg.dtype)[..., None]
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, h.reshape(B, H, P, N)


def _scan(xs: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
          a_log: torch.Tensor, d_skip: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, *, head_dim: int, n_groups: int, d_state: int,
          chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan over the heads of ``xs`` (B, S, H*P), ``dt`` (B,
    S, H) raw, ``b``/``c`` (B, S, G*N), with the skip added: returns (y
    (B, S, H*P), the final state (B, H, P, N) float32).  S is padded to
    a multiple of ``chunk``."""
    B, S, width = xs.shape
    n_heads = width // head_dim
    dt = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log)
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
        * d_skip[None, None, :, None].to(y.dtype)
    return y.reshape(B, S, width), h_last


def _step(xs: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
          a_log: torch.Tensor, d_skip: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, state: torch.Tensor, *, head_dim: int,
          n_groups: int, d_state: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update over the heads of ``xs`` (B, H*P), ``dt``
    (B, 1, H) raw, ``b``/``c`` (B, G*N), ``state`` (B, H, P, N): returns
    (y (B, 1, H*P) float32, the new state)."""
    B, width = xs.shape
    n_heads = width // head_dim
    dt = F.softplus(dt.float() + dt_bias)[:, 0]          # (B,H)
    a = -torch.exp(a_log)
    xh = xs.reshape(B, n_heads, head_dim)
    rep = n_heads // n_groups
    bh = torch.repeat_interleave(b.reshape(B, n_groups, d_state), rep, dim=1)
    ch = torch.repeat_interleave(c.reshape(B, n_groups, d_state), rep, dim=1)
    decay = torch.exp(dt * a[None, :])                   # (B,H)
    upd = (dt[:, :, None] * xh.float())[..., None] * bh.float()[:, :, None, :]
    h_new = (state * decay[..., None, None] + upd).to(state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", h_new.float(), ch.float())
    y = y + xh.float() * d_skip[None, :, None]
    return y.reshape(B, 1, width), h_new


def _conv1(w: torch.Tensor, bias: torch.Tensor,
           win: torch.Tensor) -> torch.Tensor:
    """The causal convolution's last output + SiLU over a window (B, K,
    C)."""
    return F.silu(torch.einsum("bkc,kc->bc", win, w) + bias)


def mamba2_prefill(p: Mamba2, x: torch.Tensor, *, d_state: int,
                   head_dim: int = 64, expand: int = 2, n_groups: int = 1,
                   chunk: int = 128, split: bool = False,
                   states: bool = True):
    """Full-sequence forward.  x: (B, S, d_model).  S is padded to a
    multiple of ``chunk`` for the scan.

    Returns (y, ssm_state (B,H,P,N) float32, conv_state
    (B, d_conv-1, C_x+C_b+C_c) in x's dtype).  On a tensor-parallel mesh
    ``x`` is the stream in its layout (``split``: this rank's positions),
    ``y`` this rank's row-parallel partial sum over every position, and
    the states ``cache_specs``' blocks, or None without ``states`` (a
    training forward: the conv state's exchange is not run).
    """
    n_heads = expand * x.shape[-1] // head_dim
    return _prefill(p, x, layout(p, n_heads), split, states,
                    d_state=d_state, head_dim=head_dim, n_groups=n_groups,
                    chunk=chunk)


def _last_raw(k: int, *streams: torch.Tensor) -> torch.Tensor:
    """The last ``k`` raw inputs of each stream side by side, front-padded
    with zeros below ``k`` tokens (a copy: no view keeps the prompt's
    projections alive)."""
    S = streams[0].shape[1]
    raw = torch.cat([t[:, max(S - k, 0):] for t in streams], dim=-1)
    return raw if S >= k else F.pad(raw, (0, 0, k - S, 0))


def mamba2_forward(p: Mamba2, x: torch.Tensor, **kw) -> torch.Tensor:
    return mamba2_prefill(p, x, states=False, **kw)[0]


def mamba2_decode(p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, d_state: int,
                  head_dim: int = 64, expand: int = 2, n_groups: int = 1):
    """Single-token decode.  x: (B, 1, d_model).

    Returns (y (B,1,d_model), new_ssm_state, new_conv_state); the states
    passed in are not modified.  On a tensor-parallel mesh the states are
    ``cache_specs``' blocks and ``y`` this rank's row-parallel partial
    sum.
    """
    n_heads = expand * x.shape[-1] // head_dim
    return _decode(p, x, ssm_state, conv_state, layout(p, n_heads),
                   d_state=d_state, head_dim=head_dim, n_groups=n_groups)


def _gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return y * F.silu(z.float()).to(y.dtype)


# ----------------------------------------------------------------------------
# The tensor-parallel layout
# ----------------------------------------------------------------------------

class Layout(NamedTuple):
    """The mixer over a ``model`` axis of ``C`` blocks: the blocks this
    process computes (``ranks``: its own on a tensor-parallel mesh, every
    one in turn on one process under a shape-only mesh), whether its
    heads are split over them (else every head runs on every rank from
    the gathered columns), and whether the blocks meet in collectives
    (``live``) or in sums in rank order.  Off a tensor-parallel mesh one
    block holds every channel: ``Layout(1, (0,), True, False)``."""
    C: int
    ranks: Tuple[int, ...]
    heads: bool
    live: bool


def layout(p: Mamba2, n_heads: int) -> Layout:
    """The mixer's :class:`Layout` on the active mesh: one whole block off
    a tensor-parallel one (and on one process whose shape-only mesh does
    not divide the channels).

    Raises:
        ValueError: a tensor-parallel mesh whose ``model`` axis does not
            divide ``d_inner`` or ``G * N`` (those columns stay whole; the
            mixer's tensor-parallel layout needs them split).
    """
    d_inner, gn = p.norm_scale.shape[0], p.conv_bb.shape[0]
    if hints.tp_mesh() is not None:
        C, c = hints.model_coords()
        if p.out_proj.shape[0] == d_inner or p.wb.shape[1] == gn:
            raise ValueError(f"a model axis of {C} does not divide the "
                             f"Mamba2 mixer's {d_inner} (z, x) or {gn} "
                             "(b, c) channels: its tensor-parallel layout "
                             "needs them split")
        return Layout(C, (c,), p.wdt.shape[1] != n_heads, True)
    n = hints.shape_blocks()
    if n > 1 and d_inner % n == 0 and gn % n == 0:
        return Layout(n, tuple(range(n)), n_heads % n == 0, False)
    return Layout(1, (0,), True, False)


def _cols(t: torch.Tensor, c: int, k: int) -> torch.Tensor:
    """Block ``c`` of width ``k`` of ``t``'s last dim; ``t`` itself where
    it holds that block only (a mesh rank's placed weight or product)."""
    return t if t.shape[-1] == k else t.narrow(-1, c * k, k)


def _gather(lay: Layout, *streams: List[torch.Tensor]) -> list:
    """Each stream whole from its blocks (one list per stream, one block
    per rank of ``lay.ranks``): on a mesh one all-gather over ``model``
    of the streams side by side (backward: a reduce-scatter), on one
    process the blocks concatenated."""
    if not lay.live:
        return [torch.cat(s, dim=-1) if len(s) > 1 else s[0]
                for s in streams]
    widths = [s[0].shape[-1] for s in streams]
    g = hints.gather_model(torch.cat([s[0] for s in streams], dim=-1), -1)
    g = g.reshape(*g.shape[:-1], lay.C, sum(widths))
    out, i = [], 0
    for w in widths:
        out.append(g[..., i:i + w].reshape(*g.shape[:-2], lay.C * w))
        i += w
    return out


def _shares(lay: Layout, x: torch.Tensor) -> list:
    """``x``, which every block uses whole: one copy per block this
    process computes, their gradients summed in rank order."""
    return [x] if len(lay.ranks) == 1 else list(hints.fan(x, len(lay.ranks)))


def _sums(lay: Layout, parts: list) -> list:
    """The sum over every block of the blocks' ``parts``, for each block:
    over ``model`` on a mesh (its gradient too), in rank order on one
    process."""
    if lay.live:
        return [hints.model_sum(parts[0])]
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return _shares(lay, total)


def _head_groups(b: torch.Tensor, c: torch.Tensor, n_heads: int,
                 n_groups: int, d_state: int, C: int, r: int):
    """The groups of ``b`` and ``c`` (..., G*N) that rank ``r``'s ``H /
    C`` heads read, and their count.

    Raises:
        ValueError: the rank's heads hold a part of one group and a part
            of another.
    """
    if n_groups == 1:
        return b, c, 1
    per, rep = n_heads // C, n_heads // n_groups
    if per % rep and rep % per:
        raise ValueError(f"{per} heads a rank on a model axis of {C} do "
                         f"not lie in whole groups of {rep} heads, nor in "
                         "one group")
    g0, ng = r * per // rep, max(1, per // rep)
    sl = slice(g0 * d_state, (g0 + ng) * d_state)
    return b[..., sl], c[..., sl], ng


def _small(p: Mamba2, lay: Layout) -> tuple:
    """``a_log d_skip dt_bias norm_scale conv_bx conv_bb conv_bc`` and
    ``wdt``; on a mesh the small leaves (and a whole ``wdt``, the
    fallback's) with their gradients summed over ``model``."""
    small = (p.a_log, p.d_skip, p.dt_bias, p.norm_scale, p.conv_bx,
             p.conv_bb, p.conv_bc)
    if not lay.live:
        return (*small, p.wdt)
    if lay.heads:
        return (*hints.replicated(*small), p.wdt)
    return hints.replicated(*small, p.wdt)


def _products(lay: Layout, x: torch.Tensor, ws: tuple, split: bool) -> tuple:
    """``x @ w`` for the column blocks ``ws``: ``hints.column_products``
    over ``C`` blocks, the plain products in one."""
    if lay.C > 1:
        return hints.column_products(x, ws, split)
    return tuple(x @ w for w in ws)


def _out(lay: Layout, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out_proj``: ``layers.row_parallel`` over ``C`` blocks, the plain
    product in one."""
    return L.row_parallel(y, w) if lay.C > 1 else y @ w


def _normed(lay: Layout, ys: list, d_inner: int, scale: torch.Tensor,
            dtype, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the whole ``d_inner`` of the gated outputs ``ys``, one
    per block, side by side: ``layers.rmsnorm`` where one block holds
    every channel, else over the blocks' float32 sums of squares."""
    if ys[0].shape[-1] == d_inner:
        return L.rmsnorm(SimpleNamespace(scale=scale), ys[0]).to(dtype)
    di = d_inner // lay.C
    squares = [y.float().square().sum(dim=-1, keepdim=True) for y in ys]
    out = [((y.float() * torch.rsqrt(sq / d_inner + eps)).to(y.dtype)
            * _cols(scale, r, di)).to(dtype)
           for r, y, sq in zip(lay.ranks, ys, _sums(lay, squares))]
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def _prefill(p: Mamba2, x: torch.Tensor, lay: Layout, split: bool,
             states: bool, *, d_state: int, head_dim: int, n_groups: int,
             chunk: int):
    """:func:`mamba2_prefill` in the layout ``lay`` (the module
    docstring)."""
    H = p.a_log.shape[0]
    d_inner, gn = p.norm_scale.shape[0], p.conv_bb.shape[0]
    di, gc, hc = d_inner // lay.C, gn // lay.C, H // lay.C
    (a_log, d_skip, dt_bias, norm_scale, conv_bx, conv_bb, conv_bc,
     wdt) = _small(p, lay)
    z, xr, br, cr, dt = _products(lay, x, (p.wz, p.wx, p.wb, p.wc, wdt),
                                  split)
    R = lay.ranks
    xs = [_causal_conv(_cols(p.conv_wx, r, di), _cols(conv_bx, r, di),
                       _cols(xr, r, di)) for r in R]
    bs = [_causal_conv(_cols(p.conv_wb, r, gc), _cols(conv_bb, r, gc),
                       _cols(br, r, gc)) for r in R]
    cs = [_causal_conv(_cols(p.conv_wc, r, gc), _cols(conv_bc, r, gc),
                       _cols(cr, r, gc)) for r in R]
    kw = dict(head_dim=head_dim, d_state=d_state, chunk=chunk)
    if lay.heads:
        b, c = _gather(lay, bs, cs)
        ys, hs = [], []
        for r, xi, bi, ci in zip(R, xs, _shares(lay, b), _shares(lay, c)):
            h = slice(r * hc, (r + 1) * hc)
            bi, ci, ng = _head_groups(bi, ci, H, n_groups, d_state, lay.C, r)
            y, last = _scan(xi, _cols(dt, r, hc), dt_bias[h], a_log[h],
                            d_skip[h], bi, ci, n_groups=ng, **kw)
            ys.append(_gate(y, _cols(z, r, di)))
            hs.append(last)
        y = _normed(lay, ys, d_inner, norm_scale, x.dtype)
        h_last = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    else:
        z, xs, b, c = _gather(lay, [_cols(z, r, di) for r in R], xs, bs, cs)
        y, h_last = _scan(xs, dt, dt_bias, a_log, d_skip, b, c,
                          n_groups=n_groups, **kw)
        y = _normed(lay, [_gate(y, z)], d_inner, norm_scale, x.dtype)
        if lay.live:                    # every head ran: this rank's columns
            y = _cols(y, R[0], di)
    out = _out(lay, y, p.out_proj)
    if not states:
        return out, None, None
    k = p.conv_wx.shape[0] - 1
    if not lay.live:
        return out, h_last, _last_raw(k, xr, br, cr)
    # cache_specs' block of the concatenated [x | b | c] channels: every
    # rank's last raw inputs, gathered
    raw = torch.cat(_gather(lay, *([_last_raw(k, t)] for t in (xr, br, cr))),
                    dim=-1)
    w = raw.shape[-1] // lay.C
    return out, h_last, raw[..., R[0] * w:(R[0] + 1) * w].contiguous()


def _exchange(lay: Layout, conv_state: torch.Tensor, xr: torch.Tensor,
              br: torch.Tensor, cr: torch.Tensor):
    """A mesh rank's decode window from its block of the conv state (B,
    K-1, C_tot / C) and its column blocks of the new raw inputs: one
    all-gather over ``model`` of both, every rank's, side by side.
    Returns the whole window (B, K, C_tot) and this rank's block of the
    new state."""
    B, k, w = conv_state.shape
    C, r = lay.C, lay.ranks[0]
    di, gc = xr.shape[-1], br.shape[-1]
    mine = torch.cat([conv_state.reshape(B, k * w), xr[:, 0], br[:, 0],
                      cr[:, 0]], dim=-1)
    g = hints.tp_mesh().all_gather(mine, "model", 1).reshape(B, C, -1)
    past = g[..., :k * w].reshape(B, C, k, w).transpose(1, 2).reshape(
        B, k, C * w)
    new = g[..., k * w:]
    raw = torch.cat([new[..., :di].reshape(B, C * di),
                     new[..., di:di + gc].reshape(B, C * gc),
                     new[..., di + gc:].reshape(B, C * gc)], dim=-1)
    window = torch.cat([past, raw[:, None]], dim=1)
    return window, window[:, 1:, r * w:(r + 1) * w]


def _decode(p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
            conv_state: torch.Tensor, lay: Layout, *, d_state: int,
            head_dim: int, n_groups: int):
    """:func:`mamba2_decode` in the layout ``lay`` (the module
    docstring)."""
    H = p.a_log.shape[0]
    d_inner, gn = p.norm_scale.shape[0], p.conv_bb.shape[0]
    di, gc, hc = d_inner // lay.C, gn // lay.C, H // lay.C
    z, xr, br, cr, dt = _products(lay, x, (p.wz, p.wx, p.wb, p.wc, p.wdt),
                                  False)
    if lay.live:
        window, new_conv = _exchange(lay, conv_state, xr, br, cr)
    else:
        window = torch.cat([conv_state, torch.cat([xr, br, cr], dim=-1)],
                           dim=1)
        new_conv = window[:, 1:, :]
    R = lay.ranks
    xs = [_conv1(_cols(p.conv_wx, r, di), _cols(p.conv_bx, r, di),
                 window[..., r * di:(r + 1) * di]) for r in R]
    bs = [_conv1(_cols(p.conv_wb, r, gc), _cols(p.conv_bb, r, gc),
                 window[..., d_inner + r * gc:d_inner + (r + 1) * gc])
          for r in R]
    cs = [_conv1(_cols(p.conv_wc, r, gc), _cols(p.conv_bc, r, gc),
                 window[..., d_inner + gn + r * gc:
                        d_inner + gn + (r + 1) * gc]) for r in R]
    kw = dict(head_dim=head_dim, d_state=d_state)
    if lay.heads:
        b, c = _gather(lay, bs, cs)
        ys, hs = [], []
        for r, xi in zip(R, xs):
            h = slice(r * hc, (r + 1) * hc)
            bi, ci, ng = _head_groups(b, c, H, n_groups, d_state, lay.C, r)
            y, state = _step(xi, _cols(dt, r, hc), p.dt_bias[h], p.a_log[h],
                             p.d_skip[h], bi, ci,
                             ssm_state if lay.live else ssm_state[:, h],
                             n_groups=ng, **kw)
            ys.append(_gate(y.to(x.dtype), _cols(z, r, di)))
            hs.append(state)
        y = _normed(lay, ys, d_inner, p.norm_scale, x.dtype)
        h_new = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    else:
        z, xs, b, c = _gather(lay, [_cols(z, r, di)[:, 0] for r in R], xs,
                              bs, cs)
        y, h_new = _step(xs, dt, p.dt_bias, p.a_log, p.d_skip, b, c,
                         ssm_state, n_groups=n_groups, **kw)
        y = _normed(lay, [_gate(y.to(x.dtype), z[:, None])], d_inner,
                    p.norm_scale, x.dtype)
        if lay.live:
            y = _cols(y, R[0], di)
    return _out(lay, y, p.out_proj), h_new, new_conv
