"""Flash attention (causal, GQA) in PyTorch ops with a hand-written
backward (torch counterpart of ``repro/models/flash.py``).

Why an autograd Function: autograd through the chunk-pair loop would save
every pair's probabilities, O(S * n_pairs).  The backward here is the
standard flash-attention recompute: the forward saves only ``q, k, v, out``
and the log-sum-exp ``lse`` (O(S)), and the backward recomputes each chunk
pair's probabilities transiently.

The loop walks only the lower-triangular chunk pairs ``(i, j <= i)`` in
the reference's order, with the running max, sum and accumulator in
float32.  The backward adds ``dq[i]``, ``dk[j]`` and ``dv[j]`` in that same
pair order, one tensor addition at a time and no atomics, so a second
backward is bit-identical to the first.  Every mixed product casts its
bf16 operand to float32 first, as JAX's promotion does (``torch.einsum``
does not promote).  This module reaches no TPU kernel and holds none: it
is a loop of PyTorch ops.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.roofline import trace_cost as TC

#: the masked scores' value, in float32, before the max
NEG = -1e30


def _pairs(nq: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(nq) for j in range(i + 1)]


def _walk(nq: int):
    """The pairs in order; under a trace the first two diagonal and
    off-diagonal pairs, the second of each standing for the rest of its
    kind (``roofline.trace_cost.classes``)."""
    return TC.classes("flash.pairs", _pairs(nq), key=lambda ij: ij[0] == ij[1])


def _diag_mask(chunk: int, device) -> torch.Tensor:
    """``(q, s)`` allowed within a diagonal chunk pair."""
    qi = torch.arange(chunk, device=device)
    return qi[:, None] >= qi[None, :]


def _scores(qi, kj, scale: float, diag: bool, mask) -> torch.Tensor:
    """Float32 scores of one chunk pair ``(B, q, KV, G, s)``, the upper
    triangle of a diagonal pair at ``NEG``."""
    s = torch.einsum("bqkgh,bskh->bqkgs", qi, kj).float() * scale
    if diag:
        s = torch.where(mask[None, :, None, None, :], s, NEG)
    return s


def forward_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair loop's forward: ``(out, lse)``, out in q's dtype and the
    log-sum-exp ``(B, S, KV, G)`` in float32.  Plain tensor ops, so
    autograd can differentiate it (``layers.blockwise_attention``)."""
    B, S, KV, G, hd = q.shape
    assert S % chunk == 0
    n = S // chunk
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, n, chunk, KV, G, hd)
    kc = k.reshape(B, n, chunk, KV, hd)
    vc = v.reshape(B, n, chunk, KV, hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = [torch.zeros((B, chunk, KV, G, hd), **f32) for _ in range(n)]
    m = [torch.full((B, chunk, KV, G), NEG, **f32) for _ in range(n)]
    l = [torch.zeros((B, chunk, KV, G), **f32) for _ in range(n)]
    mask = _diag_mask(chunk, q.device)
    for i, j in _walk(n):
        s = _scores(qc[:, i], kc[:, j], scale, i == j, mask)
        m_new = torch.maximum(m[i], s.amax(dim=-1))
        alpha = torch.exp(m[i] - m_new)
        p = torch.exp(s - m_new[..., None])
        l[i] = l[i] * alpha + p.sum(dim=-1)
        acc[i] = acc[i] * alpha[..., None] + torch.einsum(
            "bqkgs,bskh->bqkgh", p.to(v.dtype), vc[:, j]).float()
        m[i] = m_new
    l_safe = torch.clamp(torch.stack(l, dim=1), min=1e-30)
    out = (torch.stack(acc, dim=1) / l_safe[..., None]).reshape(
        B, S, KV, G, hd).to(q.dtype)
    lse = (torch.stack(m, dim=1) + torch.log(l_safe)).reshape(B, S, KV, G)
    return out, lse


def _bwd(chunk: int, q, k, v, out, lse, dout):
    B, S, KV, G, hd = q.shape
    n = S // chunk
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, n, chunk, KV, G, hd)
    kc = k.reshape(B, n, chunk, KV, hd)
    vc = v.reshape(B, n, chunk, KV, hd)
    doc = dout.reshape(B, n, chunk, KV, G, hd)
    lsec = lse.reshape(B, n, chunk, KV, G)
    # D_i = rowsum(dout * out)
    dsum = torch.sum(dout.float() * out.float(), dim=-1).reshape(
        B, n, chunk, KV, G)
    mask = _diag_mask(chunk, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = [torch.zeros((B, chunk, KV, G, hd), **f32) for _ in range(n)]
    dk = [torch.zeros((B, chunk, KV, hd), **f32) for _ in range(n)]
    dv = [torch.zeros((B, chunk, KV, hd), **f32) for _ in range(n)]
    for i, j in _walk(n):
        qi, kj, vj, di = qc[:, i], kc[:, j], vc[:, j], doc[:, i]
        s = _scores(qi, kj, scale, i == j, mask)
        p = torch.exp(s - lsec[:, i][..., None])            # (B,q,KV,G,s)
        dv_j = torch.einsum("bqkgs,bqkgh->bskh", p, di.float())
        dp = torch.einsum("bqkgh,bskh->bqkgs", di, vj).float()
        ds = p * (dp - dsum[:, i][..., None]) * scale
        dq_i = torch.einsum("bqkgs,bskh->bqkgh", ds, kj.float())
        dk_j = torch.einsum("bqkgs,bqkgh->bskh", ds, qi.float())
        dq[i] = dq[i] + dq_i
        dk[j] = dk[j] + dk_j
        dv[j] = dv[j] + dv_j
    return (torch.stack(dq, dim=1).reshape(B, S, KV, G, hd).to(q.dtype),
            torch.stack(dk, dim=1).reshape(B, S, KV, hd).to(k.dtype),
            torch.stack(dv, dim=1).reshape(B, S, KV, hd).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the recompute backward; saves
    ``q, k, v, out, lse``."""

    @staticmethod
    def forward(ctx, q, k, v, chunk: int):
        out, lse = forward_pairs(q, k, v, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd(ctx.chunk, *ctx.saved_tensors, dout)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """q: (B,S,KV,G,hd), k/v: (B,S,KV,hd) -> (B,S,KV,G,hd).  Causal;
    ``S % chunk == 0``."""
    return FlashAttention.apply(q, k, v, chunk)
