"""Model composition for serving: init, prefill and decode (torch
counterpart of ``repro/models/transformer.py``, the MoE family).

The reference scans a stacked layer pytree with ``jax.lax.scan``; here the
layers are an ``nn.ModuleList`` walked by a Python loop.  An MoE model's
``first_k_dense`` prefix layers (a dense SwiGLU MLP in place of the MoE)
come first, as in the reference.  The KV cache keeps the reference's
layout: ``k`` and ``v`` of shape ``(L, B, S_max, KV, hd)``.

Training (``forward_train``, ``loss_fn``) and the dense, ssm, hybrid, audio
and vlm families wait for later slices (ROADMAP A15).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    rope = cfg.rope if cfg.rope in ("rope", "mrope") else "none"
    return L.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias, rope=rope,
        rope_theta=cfg.rope_theta)


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``moe`` (an MoE layer) or ``mlp``."""

    def __init__(self, cfg: ArchConfig, *, moe_layer: bool, device,
                 g: torch.Generator = None):
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(attn_spec(cfg), dt, device, g)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        if moe_layer:
            self.moe = MOE.MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                               cfg.n_shared_experts, dt, device, g)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dt, device, g)


class MoETransformer(nn.Module):
    """``embed (V, d)``, ``lm_head (d, V)`` unless the embeddings are tied,
    ``final_norm``, the ``prefix`` dense blocks and the MoE ``layers``."""

    def __init__(self, cfg: ArchConfig, device, g: torch.Generator = None):
        super().__init__()
        if cfg.family != "moe":
            raise ValueError(f"family {cfg.family!r} is not ported yet "
                             "(ROADMAP A15); the port serves the moe family")
        if cfg.rope != "rope":
            raise ValueError(f"{cfg.rope} positions are not ported yet "
                             "(ROADMAP A15)")
        dt = cfg.torch_dtype
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, dt, device)
        if g is None:
            embed = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                                device=device)
        else:
            embed = L.normal_init(g, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                                  device)
        self.embed = L._param(embed)
        if not cfg.tie_embeddings:
            head = (L.dense_init(g, cfg.d_model, cfg.vocab_size, dt, device)
                    if g is not None else torch.empty(
                        (cfg.d_model, cfg.vocab_size), dtype=dt, device=device))
            self.lm_head = L._param(head)
        kd = cfg.first_k_dense
        self.prefix = nn.ModuleList(
            Block(cfg, moe_layer=False, device=device, g=g) for _ in range(kd))
        self.layers = nn.ModuleList(
            Block(cfg, moe_layer=True, device=device, g=g)
            for _ in range(cfg.n_layers - kd))

    def blocks(self):
        """Every block in order: the dense prefix, then the MoE layers."""
        return [*self.prefix, *self.layers]

    def use_plain_experts(self, plain: bool) -> None:
        """Route every MoE layer's expert products through B7's plain
        version (``True``) or the kernel (``False``, the default)."""
        for blk in self.layers:
            blk.moe.plain = plain


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> MoETransformer:
    """A model of ``cfg`` with random weights drawn from ``generator`` on
    ``device`` (the generator's device by default).  The draws differ from
    the reference's ``jax.random`` ones by construction; tests carry the
    reference's weights across (:func:`repro_torch.bridge.lm_params_from_reference`)."""
    device = generator.device if device is None else torch.device(device)
    return MoETransformer(cfg, device, generator)


# ----------------------------------------------------------------------------
# Embedding & logits
# ----------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, p: MoETransformer, batch: Dict,
                 *, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S) int32) for a token batch."""
    tokens = batch["tokens"]
    x = p.embed[tokens]
    B, S, _ = x.shape
    positions = (offset + torch.arange(S, dtype=torch.int32,
                                       device=x.device)[None, :]
                 + torch.zeros((B, 1), dtype=torch.int32, device=x.device))
    return x, positions


def logits_fn(cfg: ArchConfig, p: MoETransformer,
              x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg.norm, p.final_norm, x)
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    return x @ head


# ----------------------------------------------------------------------------
# Blocks and forward passes
# ----------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, blk: Block, h: torch.Tensor) -> torch.Tensor:
    if hasattr(blk, "moe"):
        ff, _ = MOE.moe_ffn(blk.moe, h, top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor)
        return ff
    return L.mlp(blk.mlp, h)


def _attn_block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                        positions: torch.Tensor):
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    out, kv = L.attention_prefill(blk.attn, attn_spec(cfg), h, positions)
    x = x + out
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    return x + _ffn(cfg, blk, h), kv


def _attn_block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                       positions: torch.Tensor, kv, cache_index: int):
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    out, kv_new = L.attention_decode(blk.attn, attn_spec(cfg), h, positions,
                                     kv, cache_index)
    x = x + out
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    return x + _ffn(cfg, blk, h), kv_new


@torch.no_grad()
def prefill(cfg: ArchConfig, p: MoETransformer,
            batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (last-position logits (B, 1, V), cache {"k", "v"} of shape
    (L, B, S, KV, hd))."""
    x, positions = embed_inputs(cfg, p, batch)
    ks, vs = [], []
    for blk in p.blocks():
        x, (k, v) = _attn_block_prefill(cfg, blk, x, positions)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits_fn(cfg, p, x[:, -1:, :]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, p: MoETransformer,
                batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token serve step.  batch: tokens (B, 1), cache {"k", "v"} of
    shape (L, B, S_max, KV, hd), cache_index (tokens already cached).
    Writes the new keys and values into the cache in place and returns
    (logits (B, 1, V), the cache with "index" = cache_index + 1)."""
    cache = batch["cache"]
    idx = int(batch["cache_index"])
    x, positions = embed_inputs(cfg, p, batch, offset=idx)
    k, v = cache["k"], cache["v"]
    for i, blk in enumerate(p.blocks()):
        x, _ = _attn_block_decode(cfg, blk, x, positions, (k[i], v[i]), idx)
    new_cache = {"k": k, "v": v, "index": idx + 1}
    return logits_fn(cfg, p, x), new_cache
