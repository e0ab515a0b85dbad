"""Model composition: init, the training forward and loss, prefill and
decode for the dense and MoE families (torch counterpart of
``repro/models/transformer.py``).

The reference scans a stacked layer pytree with ``jax.lax.scan``; here the
layers are an ``nn.ModuleList`` walked by a Python loop, and
:meth:`Transformer.reference_leaves` names which of their parameters the
reference stacks (the optimizer's and the checkpoints' unit).  An MoE
model's ``first_k_dense`` prefix layers (a dense SwiGLU MLP in place of
the MoE) come first, as in the reference.  With ``cfg.remat`` each of the
stacked layers runs under ``torch.utils.checkpoint`` in training (the
reference's ``jax.checkpoint`` of its scan body): its activations are
recomputed in the backward pass, routing included, identically.  The KV
cache keeps the reference's layout: ``k`` and ``v`` of shape
``(L, B, S_max, KV, hd)``.

The ssm and hybrid families (ROADMAP A15.4), the audio and vlm stubs and
sinusoidal and M-RoPE positions (A15.5) raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.leaves import Leaf, Leaves

AUX_LOSS_WEIGHT = 0.01
#: the families this module builds
FAMILIES = ("dense", "moe")


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


def _table(g, shape, dt, device) -> nn.Parameter:
    """An embedding table: normal draws times 0.02 (empty without ``g``)."""
    if g is None:
        return L._param(torch.empty(shape, dtype=dt, device=device))
    return L._param(L.normal_init(g, shape, 0.02, dt, device))


class Transformer(nn.Module):
    """``embed (V, d)``, ``lm_head (d, V)`` unless the embeddings are tied,
    ``pos_embed (max_seq_len, d)`` with learned positions, ``final_norm``,
    the MoE family's ``prefix`` dense blocks, and the stacked ``layers``
    (MoE blocks for the moe family, dense ones for the dense family)."""

    def __init__(self, cfg: ArchConfig, device, g: torch.Generator = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is not ported yet (ROADMAP "
                f"{'A15.4' if cfg.family in ('ssm', 'hybrid') else 'A15.5'});"
                f" the port runs the {' and '.join(FAMILIES)} families")
        if cfg.rope not in ("rope", "learned"):
            raise ValueError(f"{cfg.rope} positions are not ported yet "
                             "(ROADMAP A15.5)")
        dt = cfg.torch_dtype
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.embed = _table(g, (cfg.vocab_size, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            head = (L.dense_init(g, cfg.d_model, cfg.vocab_size, dt, device)
                    if g is not None else torch.empty(
                        (cfg.d_model, cfg.vocab_size), dtype=dt, device=device))
            self.lm_head = L._param(head)
        if cfg.rope == "learned":
            self.pos_embed = _table(g, (cfg.max_seq_len, cfg.d_model), dt,
                                    device)
        moe = cfg.family == "moe"
        kd = cfg.first_k_dense if moe else 0
        self.prefix = nn.ModuleList(
            Block(cfg, moe_layer=False, device=device, g=g) for _ in range(kd))
        self.layers = nn.ModuleList(
            Block(cfg, moe_layer=moe, device=device, g=g)
            for _ in range(cfg.n_layers - kd))

    def blocks(self):
        """Every block in order: the dense prefix, then the stacked layers."""
        return [*self.prefix, *self.layers]

    def use_plain_experts(self, plain: bool) -> None:
        """Route every MoE layer's expert products through B7's plain
        version (``True``) or the kernel (``False``, the default)."""
        for blk in self.layers:
            if hasattr(blk, "moe"):
                blk.moe.plain = plain

    def reference_leaves(self) -> Leaves:
        """The reference's parameter tree as :class:`Leaf` groups keyed by
        its path: ``layers/<name>`` stacks that parameter of every stacked
        layer, ``prefix/#<i>/<name>`` is one prefix block's, the rest are
        top-level (``embed``, ``final_norm/scale``, ...)."""
        out: Leaves = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                path = "/".join(["layers", *parts[2:]])
                out.setdefault(path, Leaf([], stacked=True)).members.append(p)
            elif parts[0] == "prefix":
                out["/".join(["prefix", "#" + parts[1], *parts[2:]])] = Leaf(
                    [p], stacked=False)
            else:
                out["/".join(parts)] = Leaf([p], stacked=False)
        return dict(sorted(out.items()))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A model of ``cfg`` with random weights drawn from ``generator`` on
    ``device`` (the generator's device by default).  The draws differ from
    the reference's ``jax.random`` ones by construction; tests carry the
    reference's weights across (:func:`repro_torch.bridge.lm_params_from_reference`)."""
    device = generator.device if device is None else torch.device(device)
    return Transformer(cfg, device, generator)


# ----------------------------------------------------------------------------
# Embedding & logits
# ----------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, p: Transformer, batch: Dict,
                 *, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S) int32) for a token batch; with
    learned positions their table's rows are added to ``x``."""
    tokens = batch["tokens"]
    x = p.embed[tokens]
    B, S, _ = x.shape
    positions = (offset + torch.arange(S, dtype=torch.int32,
                                       device=x.device)[None, :]
                 + torch.zeros((B, 1), dtype=torch.int32, device=x.device))
    if cfg.rope == "learned":
        x = x + p.pos_embed[positions]
    return x, positions


def logits_fn(cfg: ArchConfig, p: Transformer,
              x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg.norm, p.final_norm, x)
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    return x @ head


# ----------------------------------------------------------------------------
# Blocks and forward passes
# ----------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, blk: Block,
         h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if hasattr(blk, "moe"):
        return MOE.moe_ffn(blk.moe, h, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
    return L.mlp(blk.mlp, h), torch.zeros((), dtype=torch.float32,
                                          device=h.device)


def _attn_block_train(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    x = x + L.attention_train(blk.attn, attn_spec(cfg), h, positions)
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    out, aux = _ffn(cfg, blk, h)
    return x + out, aux


def _attn_block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                        positions: torch.Tensor):
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    out, kv = L.attention_prefill(blk.attn, attn_spec(cfg), h, positions)
    x = x + out
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    return x + _ffn(cfg, blk, h)[0], kv


def _attn_block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                       positions: torch.Tensor, kv, cache_index: int):
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    out, kv_new = L.attention_decode(blk.attn, attn_spec(cfg), h, positions,
                                     kv, cache_index)
    x = x + out
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    return x + _ffn(cfg, blk, h)[0], kv_new


def forward_train(cfg: ArchConfig, p: Transformer,
                  batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), the summed MoE aux loss).  With
    ``cfg.remat`` each stacked layer is recomputed in the backward pass."""
    x, positions = embed_inputs(cfg, p, batch)
    for blk in p.prefix:
        x, _ = _attn_block_train(cfg, blk, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in p.layers:
        if cfg.remat:
            x, a = checkpoint(_attn_block_train, cfg, blk, x, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _attn_block_train(cfg, blk, x, positions)
        aux = aux + a
    return logits_fn(cfg, p, x), aux


def loss_fn(cfg: ArchConfig, p: Transformer, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (``loss + AUX_LOSS_WEIGHT * aux``, {"loss", "aux"}): the
    mean next-token cross-entropy over labels >= 0, from float32
    log-probabilities."""
    logits, aux = forward_train(cfg, p, batch)
    labels = batch["labels"]
    ls = F.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    nll = -torch.gather(ls, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux": aux}


@torch.no_grad()
def prefill(cfg: ArchConfig, p: Transformer,
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
def decode_step(cfg: ArchConfig, p: Transformer,
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
