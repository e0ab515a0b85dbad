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
heads repeated to H at every length), the reference's blockwise
pair-list attention (:func:`blockwise_attention`, which nothing calls)
and a KV-cache decode path.

On a tensor-parallel mesh (``distributed/hints.py``) each rank holds the
column blocks of ``wq wk wv`` (and the biases) and the row block of
``wo``: it runs attention on its own heads where ``H`` divides over
``model``, else on every head from the gathered columns (the reference's
``attn_heads`` fallback), and returns its row-parallel partial sum.  Its
KV cache is ``cache_specs``' block: its KV heads where ``KV`` divides,
else every KV head at its block of the positions, which decode combines
over ``model`` by the log-sum-exp.  The MLP is column- then
row-parallel (:func:`row_parallel`).  Learned positions (a
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
    ``device`` (drawn there: never made on the host and copied).  The
    float32 draws are scaled in place: the same multiply as ``draws *
    scale``, without a second float32 copy (an expert stack of kimi-k2 is
    22.5 GB of float32 draws)."""
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


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
                 positions: torch.Tensor, split: bool = False):
    """q (B, S, H, hd), k and v (B, S, KV, hd), rotated.  On a
    tensor-parallel mesh (:func:`tp_layout`) ``x`` is the stream in its
    layout (``split``: this rank's positions), gathered whole with the
    column-parallel products (``hints.column_products``); q holds this
    rank's heads where ``H`` divides over ``model`` (its column block),
    else every head (the columns gathered: the reference's ``attn_heads``
    fallback), and k and v this rank's KV heads where ``KV`` divides, else
    every KV head (the columns gathered)."""
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    tp = tp_layout(p, spec)
    q, k, v = hints.column_products(x, (p.wq, p.wk, p.wv), split)
    B, S = q.shape[:2]
    if spec.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if tp is not None:
        C, _ = tp
        if H % C:
            q = hints.gather_model(q, -1)
        if KV % C:
            k, v = hints.gather_model(k, -1), hints.gather_model(v, -1)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if spec.rope == "rope":
        pos2d = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2d, spec.rope_theta)
        k = apply_rope(k, pos2d, spec.rope_theta)
    elif spec.rope == "mrope":
        q = apply_mrope(q, positions, spec.rope_theta, spec.mrope_sections)
        k = apply_mrope(k, positions, spec.rope_theta, spec.mrope_sections)
    return q, k, v


def tp_layout(p: Attention, spec: AttnSpec):
    """``(C, c)`` when a live mesh splits this attention's projections
    over a ``model`` axis of ``C > 1`` ranks (``c``: this rank's
    coordinate), else None.

    Raises:
        ValueError: a ``model`` axis of ``C > 1`` that does not divide
            ``H * head_dim`` or ``KV * head_dim`` (those projections stay
            whole; the port's tensor-parallel attention needs them split).
    """
    C, c = hints.model_coords()
    if C == 1:
        return None
    if (p.wo.shape[0] == spec.n_heads * spec.head_dim
            or p.wk.shape[1] == spec.n_kv_heads * spec.head_dim):
        raise ValueError(f"a model axis of {C} does not divide the "
                         f"attention's {spec.n_heads} (q) or "
                         f"{spec.n_kv_heads} (k, v) x {spec.head_dim} "
                         "columns: its tensor-parallel layout needs them "
                         "split")
    return C, c


def kv_seq_split(spec: AttnSpec) -> bool:
    """Whether the KV cache holds a block of positions of every KV head on
    each ``model`` rank (``cache_specs``' layout where the KV heads do not
    divide over ``model``), rather than its KV heads at every position."""
    C, _ = hints.model_coords()
    return C > 1 and spec.n_kv_heads % C != 0


def _expand_kv(t: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """k or v (B, S, n, hd) with each KV head repeated ``H / KV`` times
    (G = 1), cut to this rank's ``H / C`` heads where a tensor-parallel
    mesh splits the heads and ``t`` holds every KV head.  GQA stays
    contiguous: q head ``h`` uses KV head ``h // (H / KV)``, so a rank's
    own KV heads cover its own q heads."""
    H = spec.n_heads
    G = H // spec.n_kv_heads
    if G > 1:
        t = torch.repeat_interleave(t, G, dim=2)
    C, c = hints.model_coords()
    if C > 1 and H % C == 0 and t.shape[2] == H:
        t = t.narrow(2, c * (H // C), H // C)
    return t


def _cache_block(t: torch.Tensor, spec: AttnSpec, s_max) -> torch.Tensor:
    """A prefill's k or v (B, S, n, hd) as this rank's cache block of
    ``s_max`` positions (default S): every KV head at its own
    ``s_max / C`` positions where the cache splits the sequence
    (:func:`kv_seq_split`), else the heads it holds at every position,
    zero-padded."""
    B, S = t.shape[:2]
    s_max = S if s_max is None else s_max
    if s_max < S:
        raise ValueError(f"a cache of {s_max} positions cannot hold a "
                         f"prompt of {S}")
    if kv_seq_split(spec):
        C, c = hints.model_coords()
        if s_max % C:
            raise ValueError(f"a cache of {s_max} positions does not "
                             f"divide over a model axis of {C}")
        blk = s_max // C
        lo = c * blk
        n = max(0, min(S, lo + blk) - lo)
        out = t.new_zeros((B, blk) + tuple(t.shape[2:]))
        out[:, :n] = t[:, lo:lo + n]
        return out
    if s_max == S:
        return t
    return F.pad(t, (0, 0, 0, 0, 0, s_max - S))


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
    heads are first repeated to q's heads (G = 1; their gradients sum back
    over the repeat), as the reference's mesh branch does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if S <= BLOCK_THRESHOLD and not hints.active():
        return dense_attention(q, k, v, causal=True)
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    if S <= BLOCK_THRESHOLD:
        return dense_attention(q, k, v, causal=True)
    chunk = 512 if S % 512 == 0 else _chunk_of(S)
    out = flash_attention(q[:, :, :, None, :], k, v, chunk)
    return out.reshape(B, S, H, hd)


def _chunk_of(s: int) -> int:
    for c in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if s % c == 0:
            return c
    return 1


def attention_train(p: Attention, spec: AttnSpec, x: torch.Tensor,
                    positions: torch.Tensor, split: bool = False
                    ) -> torch.Tensor:
    """Causal self-attention over the whole sequence (the prefill's output
    without its cache), differentiable."""
    return _attention(p, spec, x, positions, split)[0]


def _attention(p: Attention, spec: AttnSpec, x: torch.Tensor,
               positions: torch.Tensor, split: bool = False):
    """(output, k, v): the attention's output (on a tensor-parallel mesh
    this rank's row-parallel partial sum) and the k and v it ran on
    (:func:`_project_qkv`'s)."""
    q, k, v = _project_qkv(p, spec, x, positions, split)
    B, S = q.shape[:2]
    tp = tp_layout(p, spec)
    n = hints.shape_blocks()
    if tp is None and n > 1 and spec.n_heads % n == 0:
        # one process under a shape-only mesh: each rank's heads in turn
        kx, vx = _expand_kv(k, spec), _expand_kv(v, spec)
        hb = spec.n_heads // n
        out = torch.cat([_self_attention(
            *(t[:, :, c * hb:(c + 1) * hb].contiguous() for t in (q, kx, vx)))
            for c in range(n)], dim=2).reshape(B, S, -1)
        return row_parallel(out, p.wo), k, v
    if tp is None:
        out = _self_attention(q, k, v).reshape(B, S, -1)
        return row_parallel(out, p.wo), k, v
    C, c = tp
    out = _self_attention(q, _expand_kv(k, spec),
                          _expand_kv(v, spec)).reshape(B, S, -1)
    if spec.n_heads % C:                # every head ran: this rank's columns
        n = out.shape[2] // C
        out = out.narrow(2, c * n, n)
    return row_parallel(out, p.wo), k, v


def attention_prefill(p: Attention, spec: AttnSpec, x: torch.Tensor,
                      positions: torch.Tensor, s_max: int = None,
                      split: bool = False):
    """Prefill: returns (output, (k_cache, v_cache)), the cache of
    ``s_max`` positions (default S, the prompt's; zero-padded past it).

    On a tensor-parallel mesh (:func:`tp_layout`) ``x`` is the stream in
    its layout (``split``: this rank's positions), the output is this
    rank's row-parallel partial sum over every position
    (``hints.residual`` sums it), and the cache is this rank's block under
    ``cache_specs``: its KV heads at every position, or every KV head at
    its block of the positions (:func:`kv_seq_split`)."""
    out, k, v = _attention(p, spec, x, positions, split)
    if kv_seq_split(spec) or s_max not in (None, k.shape[1]):
        k, v = _cache_block(k, spec, s_max), _cache_block(v, spec, s_max)
    return out, (k, v)


def attention_decode(p: Attention, spec: AttnSpec, x: torch.Tensor,
                     positions: torch.Tensor, cache, cache_index: int):
    """Single-token decode against a (B, S_max, KV, hd) cache.

    ``cache_index``: tokens already in the cache.  The new key and value
    are written into ``cache`` in place (the reference returns updated
    copies); the same tensors are returned.  On a tensor-parallel mesh the
    cache is this rank's block (:func:`attention_prefill`) and the output
    its row-parallel partial sum; over a cache that splits the sequence
    see :func:`_decode_over_positions`."""
    q, k_new, v_new = _project_qkv(p, spec, x, positions)
    B, S1 = q.shape[:2]
    tp = tp_layout(p, spec)
    if tp is not None and kv_seq_split(spec):
        return _decode_over_positions(p, spec, q, k_new, v_new, cache,
                                      cache_index, tp)
    k_cache, v_cache = cache
    s_max = k_cache.shape[1]
    if not 0 <= cache_index <= s_max - S1:
        raise ValueError(f"cache_index {cache_index} outside a cache of "
                         f"{s_max} positions")
    k_cache[:, cache_index:cache_index + S1] = k_new
    v_cache[:, cache_index:cache_index + S1] = v_new
    hd = spec.head_dim
    H, KV = q.shape[2], k_cache.shape[2]        # this rank's on a TP mesh
    G = H // KV
    qg = q.reshape(B, S1, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() / math.sqrt(hd)
    valid = torch.arange(s_max, device=q.device) <= (cache_index + S1 - 1)
    s = torch.where(valid, s, -1e30)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache).reshape(
        B, S1, H * hd)
    return row_parallel(out, p.wo), (k_cache, v_cache)


def _decode_over_positions(p: Attention, spec: AttnSpec, q, k_new, v_new,
                           cache, cache_index: int, tp):
    """Decode over a cache that holds every KV head at this rank's block
    of ``s_max / C`` positions: the new key and value go to the rank that
    owns ``cache_index``; each rank runs every head over its positions
    with a running maximum and sum, and the log-sum-exp over ``model``
    combines them (float32: the maxima and sums all-reduced, the weighted
    values reduce-scattered to the columns of this rank's block of
    ``wo``).  A rank whose positions are all masked adds
    nothing (its maximum is -1e30).  Returns this rank's row-parallel
    partial sum and the cache."""
    mesh = hints.tp_mesh()
    C, c = tp
    k_cache, v_cache = cache
    B, S1 = q.shape[:2]
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    blk = k_cache.shape[1]
    if not 0 <= cache_index <= blk * C - S1:
        raise ValueError(f"cache_index {cache_index} outside a cache of "
                         f"{blk * C} positions")
    if q.shape[2] != H:
        q = hints.gather_model(q, 2)
    lo = c * blk
    for j in range(S1):
        pos = cache_index + j
        if lo <= pos < lo + blk:
            k_cache[:, pos - lo] = k_new[:, j]
            v_cache[:, pos - lo] = v_new[:, j]
    qg = q.reshape(B, S1, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() / math.sqrt(hd)
    kpos = lo + torch.arange(blk, device=q.device)
    s = torch.where(kpos <= (cache_index + S1 - 1), s, -1e30)
    m = s.amax(dim=-1)                                    # (B, KV, G, S1)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bkgqs,bskh->bkgqh", e, v_cache.float())
    top = mesh.all_reduce(m.clone(), ("model",), "max")
    scale = torch.exp(m - top)
    total = mesh.all_reduce(e.sum(dim=-1) * scale, ("model",))
    # each rank needs only its columns of the output (wo's row block):
    # the weighted sums are reduce-scattered over the H * hd columns
    o = (o * scale[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S1, H * hd)
    o = mesh.reduce_scatter(o, "model", 2)
    n = H * hd // C
    heads = torch.arange(c * n, (c + 1) * n, device=q.device) // hd
    total = total.permute(0, 3, 1, 2).reshape(B, S1, H)[..., heads]
    return row_parallel((o / total).to(q.dtype), p.wo), (k_cache, v_cache)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``wi_gate``, ``wi_up``, ``wo``) or GELU (``wi``, ``wo``);
    ``width`` is the hidden width (a tensor-parallel mesh holds a block of
    it)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype, device,
                 g: torch.Generator = None):
        super().__init__()
        self.width = d_ff
        names = ((("wi_gate", d_model, d_ff), ("wi_up", d_model, d_ff))
                 if kind == "swiglu" else (("wi", d_model, d_ff),))
        for name, d_in, d_out in (*names, ("wo", d_ff, d_model)):
            w = (dense_init(g, d_in, d_out, dtype, device) if g is not None
                 else torch.empty((d_in, d_out), dtype=dtype, device=device))
            setattr(self, name, _param(w))


def mlp(p: MLP, x: torch.Tensor, split: bool = False) -> torch.Tensor:
    """The MLP of ``x``.  Where a tensor-parallel mesh splits its width,
    ``x`` is the stream in its layout (``split``: this rank's positions),
    gathered with the column-parallel products
    (``hints.column_products``), and the result this rank's row-parallel
    partial sum (:func:`row_parallel`)."""
    tp = mlp_split(p)
    if hasattr(p, "wi_gate"):
        ws = (p.wi_gate, p.wi_up)
        gate, up = (hints.column_products(x, ws, split) if tp
                    else (x @ p.wi_gate, x @ p.wi_up))
        h = F.silu(gate) * up
    else:
        (wi,) = (hints.column_products(x, (p.wi,), split) if tp
                 else (x @ p.wi,))
        h = F.gelu(wi, approximate="tanh")   # jax.nn.gelu's default
    return row_parallel(h, p.wo) if tp else h @ p.wo


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a row-parallel block: on a tensor-parallel mesh this
    rank's partial sum (``hints.residual`` sums them in the model's
    dtype); on one process under a shape-only mesh the ranks' partial
    products summed in rank order (where ``w``'s rows divide), as the
    mesh's reduction sums them; off a mesh ``x @ w``."""
    n = hints.shape_blocks()
    if n == 1 or w.shape[0] % n:
        return x @ w
    k = w.shape[0] // n
    out = None
    for c in range(n):
        part = x[..., c * k:(c + 1) * k].contiguous() @ w[c * k:(c + 1) * k]
        out = part if out is None else out + part
    return out


def mlp_split(p: MLP) -> bool:
    """Whether a tensor-parallel mesh splits this MLP's hidden width over
    ``model`` (column-parallel inputs, row-parallel ``wo``), or one
    process under a shape-only mesh computes it in such blocks."""
    if hints.tp_mesh() is not None:
        return p.wo.shape[0] != p.width
    n = hints.shape_blocks()
    return n > 1 and p.width % n == 0


def mlp_whole(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """The MLP of an ``x`` every ``model`` rank holds whole, whole on every
    rank: where its width is split, between Megatron's ``f`` and ``g``."""
    if not mlp_split(p):
        return mlp(p, x)
    return hints.reduce_from_model(mlp(p, x))
