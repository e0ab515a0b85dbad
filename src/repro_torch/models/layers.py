"""Core transformer layers (torch counterpart of ``repro/models/layers.py``).

Modules hold the parameters in the reference's layout (``x @ w`` with ``w``
of shape ``(d_in, d_out)``; their constructors take the place of the
reference's ``init_*`` functions), plain functions do the math with the
reference's casts.  Parameters take gradients; the serving paths run under
``torch.no_grad``.  Attention supports GQA/MQA, optional QKV bias, RoPE
and M-RoPE (qwen2-vl: :func:`apply_mrope`), a dense causal path for
sequences of up to :data:`BLOCK_THRESHOLD` tokens, flash attention
(``models/flash.py``, KV heads repeated to H) beyond it, in training and
prefill alike (under an active mesh, the reference's mesh branch: KV
heads repeated to H at every length, heads over ``model``), the
reference's blockwise pair-list attention (:func:`blockwise_attention`,
which nothing calls) and a KV-cache decode path.  Learned positions (a
table) and sinusoidal ones (:func:`sinusoidal_embedding`, musicgen) are
added to the embeddings (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints
from repro_torch.models.flash import flash_attention, forward_pairs

#: sequences longer than this take the flash path (``_self_attention``)
BLOCK_THRESHOLD = 1024


# ----------------------------------------------------------------------------
# Initializers & norms
# ----------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def dense_init(g: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """Normal draws scaled by ``sqrt(2 / (d_in + d_out))``, made on
    ``device`` in float32 and cast to ``dtype``."""
    return normal_init(g, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5,
                       dtype, device)


def normal_init(g: torch.Generator, shape: tuple, scale: float, dtype,
                device) -> torch.Tensor:
    """``scale`` times standard normal draws of ``shape`` from ``g``, on
    ``device`` (drawn there: never made on the host and copied)."""
    return (torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device) * scale).to(dtype)


class Norm(nn.Module):
    """RMSNorm (``kind="rms"``: a scale) or LayerNorm (a scale and a bias)."""

    def __init__(self, kind: str, d: int, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = _param(torch.ones((d,), dtype=dtype, device=device))
        if kind != "rms":
            self.bias = _param(torch.zeros((d,), dtype=dtype, device=device))


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.scale


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p.scale + p.bias


def apply_norm(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rms" else layernorm(p, x)


# ----------------------------------------------------------------------------
# Positional encodings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs            # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_section_map(head_dim: int,
                      sections: Tuple[int, int, int]) -> np.ndarray:
    """The position axis (0 t, 1 h, 2 w) of each of the ``head_dim / 2``
    frequency slots: ``sections`` consecutive slots each, filled by numpy
    slices as the reference fills them, so sections that overrun the slots
    are clipped (at ``head_dim`` 16, sections (16, 24, 24) put every slot
    in section 0) and slots past their sum stay in section 0."""
    sec = np.zeros(head_dim // 2, np.int32)
    ofs = 0
    for i, s in enumerate(sections):
        sec[ofs: ofs + s] = i
        ofs += s
    return sec


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL).  x: (B, S, H, hd); positions: (3, B, S)
    int32 for (t, h, w); each frequency slot rotates by the position of
    its section (:func:`mrope_section_map`)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    sec = torch.as_tensor(mrope_section_map(hd, sections), dtype=torch.long,
                          device=x.device)
    pos = positions.float().permute(1, 2, 0)[..., sec]         # (B, S, hd/2)
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Sine then cosine of ``positions`` (any shape, int) times ``d_model /
    2`` frequencies ``10000^(-i / (d_model / 2))``: float32, the shape of
    ``positions`` plus ``d_model``."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------------
# Attention (GQA / MQA): dense prefill and KV-cache decode
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope: str = "rope"           # rope | mrope | none
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)


class Attention(nn.Module):
    """The projections ``wq (d, H*hd)``, ``wk``/``wv (d, KV*hd)``,
    ``wo (H*hd, d)`` and, with ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, spec: AttnSpec, dtype, device,
                 g: torch.Generator = None):
        super().__init__()
        H, KV, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
        shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                  "wo": (H * hd, d)}
        for name, (d_in, d_out) in shapes.items():
            w = (dense_init(g, d_in, d_out, dtype, device) if g is not None
                 else torch.empty((d_in, d_out), dtype=dtype, device=device))
            setattr(self, name, _param(w))
        if spec.qkv_bias:
            for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
                setattr(self, name, _param(torch.zeros((n,), dtype=dtype,
                                                       device=device)))


def _project_qkv(p: Attention, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if spec.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if spec.rope == "rope":
        pos2d = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2d, spec.rope_theta)
        k = apply_rope(k, pos2d, spec.rope_theta)
    elif spec.rope == "mrope":
        q = apply_mrope(q, positions, spec.rope_theta, spec.mrope_sections)
        k = apply_mrope(k, positions, spec.rope_theta, spec.mrope_sections)
    return q, k, v


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """Reference attention for short S.  q: (B,Sq,H,hd) k/v: (B,Skv,KV,hd).

    Scores are divided in float32 (the reference divides by a numpy scalar,
    which promotes bf16 scores), masked with -1e30, softmaxed in float32
    and cast to ``q``'s dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
    if causal:
        qpos = kv_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """Causal flash-style attention over the triangular ``(i, j <= i)``
    chunk-pair list, differentiated by autograd through its loop (the
    reference's; the model takes :func:`flash_attention`, whose backward
    recomputes instead).

    q: (B,S,H,hd), k/v: (B,S,KV,hd); ``S`` a multiple of both chunks, which
    must be equal."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    assert S % q_chunk == 0 and S % kv_chunk == 0
    assert q_chunk == kv_chunk, "triangular pairing assumes equal chunks"
    out, _ = forward_pairs(q.reshape(B, S, KV, H // KV, hd), k, v, q_chunk)
    return out.reshape(B, S, H, hd)


def _self_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention: dense up to :data:`BLOCK_THRESHOLD` tokens,
    else flash attention in chunks of 512, or of the largest power of two
    that divides S.  Under an active mesh (and on the flash path) the KV
    heads are first repeated to H (G = 1; their gradients sum back over
    the repeat), as the reference's mesh branch does; on a live mesh each
    ``model`` rank then runs its share of the heads
    (:func:`repro_torch.distributed.hints.over_model`)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if S <= BLOCK_THRESHOLD and not hints.active():
        return dense_attention(q, k, v, causal=True)
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    q, k, v = hints.attn_heads(q), hints.attn_heads(k), hints.attn_heads(v)

    def core(q, k, v):
        if S <= BLOCK_THRESHOLD:
            return dense_attention(q, k, v, causal=True)
        chunk = 512 if S % 512 == 0 else _chunk_of(S)
        out = flash_attention(q[:, :, :, None, :], k, v, chunk)
        return out.reshape(B, S, q.shape[2], hd)

    return hints.attn_heads(hints.over_model(core, q, k, v, dim=2))


def _chunk_of(s: int) -> int:
    for c in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % c == 0:
            return c
    return 1


def attention_train(p: Attention, spec: AttnSpec, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the whole sequence (the prefill's output
    without its cache), differentiable."""
    return attention_prefill(p, spec, x, positions)[0]


def attention_prefill(p: Attention, spec: AttnSpec, x: torch.Tensor,
                      positions: torch.Tensor):
    """Prefill: returns (output, (k_cache, v_cache))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, spec, x, positions)
    out = _self_attention(q, k, v)
    return out.reshape(B, S, -1) @ p.wo, (k, v)


def attention_decode(p: Attention, spec: AttnSpec, x: torch.Tensor,
                     positions: torch.Tensor, cache, cache_index: int):
    """Single-token decode against a (B, S_max, KV, hd) cache.

    ``cache_index``: tokens already in the cache.  The new key and value
    are written into ``cache`` in place (the reference returns updated
    copies); the same tensors are returned."""
    B, S1, _ = x.shape
    q, k_new, v_new = _project_qkv(p, spec, x, positions)
    k_cache, v_cache = cache
    s_max = k_cache.shape[1]
    if not 0 <= cache_index <= s_max - S1:
        raise ValueError(f"cache_index {cache_index} outside a cache of "
                         f"{s_max} positions")
    k_cache[:, cache_index:cache_index + S1] = k_new
    v_cache[:, cache_index:cache_index + S1] = v_new
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    G = H // KV
    qg = q.reshape(B, S1, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() / math.sqrt(hd)
    valid = torch.arange(s_max, device=x.device) <= (cache_index + S1 - 1)
    s = torch.where(valid, s, -1e30)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache).reshape(
        B, S1, H * hd)
    return out @ p.wo, (k_cache, v_cache)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``wi_gate``, ``wi_up``, ``wo``) or GELU (``wi``, ``wo``)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype, device,
                 g: torch.Generator = None):
        super().__init__()
        names = ((("wi_gate", d_model, d_ff), ("wi_up", d_model, d_ff))
                 if kind == "swiglu" else (("wi", d_model, d_ff),))
        for name, d_in, d_out in (*names, ("wo", d_ff, d_model)):
            w = (dense_init(g, d_in, d_out, dtype, device) if g is not None
                 else torch.empty((d_in, d_out), dtype=dtype, device=device))
            setattr(self, name, _param(w))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "wi_gate"):
        return (F.silu(x @ p.wi_gate) * (x @ p.wi_up)) @ p.wo
    return F.gelu(x @ p.wi, approximate="tanh") @ p.wo   # jax.nn.gelu's default
