"""Model composition: init, the training forward and loss, prefill and
decode for the dense, MoE, ssm, hybrid, audio and vlm families (torch
counterpart of ``repro/models/transformer.py``).

The reference scans a stacked layer pytree with ``jax.lax.scan``; here the
layers are an ``nn.ModuleList`` walked by a Python loop, and
:meth:`Transformer.reference_leaves` names which of their parameters the
reference stacks and in what leading shape (the optimizer's and the
checkpoints' unit).  An MoE model's ``first_k_dense`` prefix layers (a
dense SwiGLU MLP in place of the MoE) come first, as in the reference.
The ssm family is a stack of Mamba2 blocks (``ln1`` + ``mamba``).  The
Zamba2 hybrid runs "super-layers" of ``attn_every`` Mamba2 blocks followed
by one application of a shared attention+MLP block (one weight set, its
own KV cache per application), then the ``n_layers % attn_every``
remainder blocks (``tail``); the reference stacks its Mamba layers as
``(n_super, attn_every, ...)``.  With ``cfg.remat`` each stacked layer
(ssm: each Mamba block; hybrid: each whole super-layer, the tail not)
runs under ``torch.utils.checkpoint`` in training (the reference's
``jax.checkpoint`` of its scan body): its activations are recomputed in
the backward pass, routing included, identically.  The KV cache keeps the
reference's layout, ``k`` and ``v`` of shape ``(L, B, S_max, KV, hd)``
(the hybrid: one per shared-block application); the ssm and hybrid caches
add ``ssm`` ``(L, B, H, P, N)`` float32 and ``conv`` ``(L, B, d_conv - 1,
C)``.

The audio and vlm families are backbones over stub frontends, as in the
reference.  Audio (musicgen) reads precomputed frame embeddings
(``frame_embeds`` (B, S, d)) with sinusoidal positions added, and its
``heads`` (C, d, V) take the place of ``embed`` and ``lm_head``: logits
are (B, S, C, V), one vocabulary per codebook, and the loss is the mean
cross-entropy over every ``codes`` (B, S, C) entry.  Vlm (qwen2-vl)
concatenates ``image_embeds`` (B, Vt, d) before the token embeddings and
rotates q and k by M-RoPE over ``positions`` (3, B, S), which the batch
carries in prefill and decode alike.  Both stack dense blocks.

Under an active mesh the reference's sharding hints are called at its
call sites (``distributed/hints.py``): the layer-entry ``gathered`` and
the ``residual`` between layers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import hints
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.leaves import Leaf, Leaves

AUX_LOSS_WEIGHT = 0.01
#: the families this module builds
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    rope = cfg.rope if cfg.rope in ("rope", "mrope") else "none"
    return L.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias, rope=rope,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections)


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


class MambaBlock(nn.Module):
    """``ln1`` and ``mamba`` (a :class:`repro_torch.models.mamba2.Mamba2`)."""

    def __init__(self, cfg: ArchConfig, device, g: torch.Generator = None):
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mamba = M2.Mamba2(
            cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, d_conv=cfg.ssm_conv,
            n_groups=cfg.ssm_groups, dtype=dt, device=device, g=g)


def _table(g, shape, dt, device) -> nn.Parameter:
    """An embedding table: normal draws times 0.02 (empty without ``g``)."""
    if g is None:
        return L._param(torch.empty(shape, dtype=dt, device=device))
    return L._param(L.normal_init(g, shape, 0.02, dt, device))


class Transformer(nn.Module):
    """``embed (V, d)``, ``lm_head (d, V)`` unless the embeddings are tied
    (the audio family: ``heads (C, d, V)`` in place of both),
    ``pos_embed (max_seq_len, d)`` with learned positions, ``final_norm``,
    the MoE family's ``prefix`` dense blocks, and the stacked ``layers``:
    MoE blocks for the moe family, dense ones for the dense, audio and vlm
    families, Mamba blocks for the ssm family and the hybrid's ``n_super *
    attn_every`` (row-major), which adds its ``tail`` Mamba blocks and the
    ``shared`` attention+MLP block.

    ``place(name, tensor) -> tensor``, when given, replaces each
    parameter's data as soon as the table or block holding it is drawn
    (a rank of a mesh keeps its block, and never holds the whole model);
    the draws are those of an unplaced model.

    Raises:
        ValueError: a family other than :data:`FAMILIES` (life-stn96 is
            the LiFE workload, not an LM).
    """

    def __init__(self, cfg: ArchConfig, device, g: torch.Generator = None,
                 place=None):
        super().__init__()
        placed = set()

        def settle():
            if place is None:
                return
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if name not in placed:
                        p.data = place(name, p.data)
                        placed.add(name)

        if cfg.family not in FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is no LM family: the model runs the "
                f"{', '.join(FAMILIES)} families")
        dt = cfg.torch_dtype
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, dt, device)
        if cfg.family == "audio":
            shape = (cfg.n_codebooks, cfg.d_model, cfg.vocab_size)
            self.heads = L._param(
                L.normal_init(g, shape, cfg.d_model ** -0.5, dt, device)
                if g is not None else torch.empty(shape, dtype=dt,
                                                  device=device))
        else:
            self.embed = _table(g, (cfg.vocab_size, cfg.d_model), dt, device)
        if cfg.family != "audio" and not cfg.tie_embeddings:
            head = (L.dense_init(g, cfg.d_model, cfg.vocab_size, dt, device)
                    if g is not None else torch.empty(
                        (cfg.d_model, cfg.vocab_size), dtype=dt, device=device))
            self.lm_head = L._param(head)
        if cfg.rope == "learned":
            self.pos_embed = _table(g, (cfg.max_seq_len, cfg.d_model), dt,
                                    device)
        settle()

        def stack(attr: str, make, n: int) -> None:
            setattr(self, attr, nn.ModuleList())
            for _ in range(n):
                getattr(self, attr).append(make())
                settle()

        moe = cfg.family == "moe"
        kd = cfg.first_k_dense if moe else 0
        stack("prefix", lambda: Block(cfg, moe_layer=False, device=device,
                                      g=g), kd)
        if cfg.family == "ssm":
            stack("layers", lambda: MambaBlock(cfg, device, g), cfg.n_layers)
            self.lead = {"layers": (cfg.n_layers,)}
        elif cfg.family == "hybrid":
            n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
            stack("layers", lambda: MambaBlock(cfg, device, g),
                  n_super * cfg.attn_every)
            stack("tail", lambda: MambaBlock(cfg, device, g), tail)
            self.shared = Block(cfg, moe_layer=False, device=device, g=g)
            self.lead = {"layers": (n_super, cfg.attn_every), "tail": (tail,)}
        else:
            stack("layers", lambda: Block(cfg, moe_layer=moe, device=device,
                                          g=g), cfg.n_layers - kd)
            self.lead = {"layers": (cfg.n_layers - kd,)}
        settle()

    def blocks(self):
        """Every attention block in order (dense and moe families): the
        dense prefix, then the stacked layers."""
        return [*self.prefix, *self.layers]

    def use_plain_experts(self, plain: bool) -> None:
        """Route every MoE layer's expert products through B7's plain
        version (``True``) or the kernel (``False``, the default)."""
        for blk in self.layers:
            if hasattr(blk, "moe"):
                blk.moe.plain = plain

    def reference_leaves(self) -> Leaves:
        """The reference's parameter tree as :class:`Leaf` groups keyed by
        its path: ``layers/<name>`` (and the hybrid's ``tail/<name>``)
        stacks that parameter of every stacked layer in the reference's
        leading shape, ``prefix/#<i>/<name>`` is one prefix block's, the
        rest are single tensors (``embed``, ``final_norm/scale``, the
        hybrid's ``shared/...``)."""
        stacks: Dict[str, list] = {}
        out: Leaves = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[0] in self.lead:
                stacks.setdefault("/".join([parts[0], *parts[2:]]),
                                  []).append(p)
            elif parts[0] == "prefix":
                out["/".join(["prefix", "#" + parts[1], *parts[2:]])] = Leaf(
                    [p], lead=())
            else:
                out["/".join(parts)] = Leaf([p], lead=())
        for path, members in stacks.items():
            out[path] = Leaf(members, lead=self.lead[path.split("/")[0]])
        return dict(sorted(out.items()))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, place=None) -> Transformer:
    """A model of ``cfg`` with random weights drawn from ``generator`` on
    ``device`` (the generator's device by default), each parameter passed
    through ``place`` as it is drawn (:class:`Transformer`).  The draws
    differ from the reference's ``jax.random`` ones by construction; tests
    carry the reference's weights across
    (:func:`repro_torch.bridge.lm_params_from_reference`)."""
    device = generator.device if device is None else torch.device(device)
    return Transformer(cfg, device, generator, place)


# ----------------------------------------------------------------------------
# Embedding & logits
# ----------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, p: Transformer, batch: Dict,
                 *, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions): (B,S) int32 from ``offset`` on, or
    the vlm batch's own ``positions`` (3,B,S).  A token batch embeds
    ``tokens``; the audio family reads ``frame_embeds``; the vlm family
    puts ``image_embeds`` (when the batch has them: not in decode) before
    its tokens.  Learned and sinusoidal positions are added to ``x``."""
    if cfg.family == "audio":
        x = batch["frame_embeds"]
    else:
        x = p.embed[batch["tokens"]]
        if cfg.family == "vlm":
            if "image_embeds" in batch:
                x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
            return x, batch["positions"]
    B, S, _ = x.shape
    positions = (offset + torch.arange(S, dtype=torch.int32,
                                       device=x.device)[None, :]
                 + torch.zeros((B, 1), dtype=torch.int32, device=x.device))
    if cfg.rope == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    elif cfg.rope == "learned":
        x = x + p.pos_embed[positions]
    return x, positions


def logits_fn(cfg: ArchConfig, p: Transformer,
              x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits, or (B, S, C, V) for the audio family."""
    x = L.apply_norm(cfg.norm, p.final_norm, x)
    if cfg.family == "audio":
        return torch.einsum("bsd,cdv->bscv", x, p.heads)
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
    x = hints.gathered(x)
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    x = x + L.attention_train(blk.attn, attn_spec(cfg), h, positions)
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    out, aux = _ffn(cfg, blk, h)
    return hints.residual(x + out), aux


def _attn_block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                        positions: torch.Tensor):
    x = hints.gathered(x)
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


def _mamba_kwargs(cfg: ArchConfig) -> Dict:
    return dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, n_groups=cfg.ssm_groups)


def _mamba_train(cfg: ArchConfig, blk: MambaBlock,
                 x: torch.Tensor) -> torch.Tensor:
    x = hints.gathered(x)
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    return x + M2.mamba2_forward(blk.mamba, h, **_mamba_kwargs(cfg))


def _remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``cfg.remat``."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _super_train(cfg: ArchConfig, p: Transformer, g: int, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """The hybrid's super-layer ``g``: its ``attn_every`` Mamba blocks,
    then the shared block."""
    per = cfg.attn_every
    x = hints.residual(x)
    for blk in p.layers[g * per:(g + 1) * per]:
        x = _mamba_train(cfg, blk, x)
    return _attn_block_train(cfg, p.shared, x, positions)[0]


def forward_train(cfg: ArchConfig, p: Transformer,
                  batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), the summed MoE aux loss, 0 outside the
    moe family).  With ``cfg.remat`` each stacked layer (the hybrid: each
    super-layer) is recomputed in the backward pass."""
    x, positions = embed_inputs(cfg, p, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for blk in p.layers:
            x = _remat(cfg, _mamba_train, cfg, blk, hints.residual(x))
    elif cfg.family == "hybrid":
        for g in range(p.lead["layers"][0]):
            x = _remat(cfg, _super_train, cfg, p, g, x, positions)
        for blk in p.tail:
            x = _mamba_train(cfg, blk, x)
    else:
        for blk in p.prefix:
            x, _ = _attn_block_train(cfg, blk, x, positions)
        for blk in p.layers:
            x, a = _remat(cfg, _attn_block_train, cfg, blk,
                          hints.residual(x), positions)
            aux = aux + a
    return logits_fn(cfg, p, x), aux


def loss_fn(cfg: ArchConfig, p: Transformer, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (``loss + AUX_LOSS_WEIGHT * aux``, {"loss", "aux"}): the
    mean next-token cross-entropy over labels >= 0 (the audio family: over
    every entry of ``codes`` (B, S, C)), from float32 log-probabilities.
    On a live mesh each rank holds its data shard's rows and divides by
    the count over every shard, so the ranks' losses (and gradients) sum
    to the whole batch's."""
    logits, aux = forward_train(cfg, p, batch)
    ls = F.log_softmax(logits.float(), dim=-1)
    if cfg.family == "audio":
        codes = batch["codes"].long()
        nll = -torch.gather(ls, -1, codes[..., None])[..., 0]
        count = hints.batch_total(torch.tensor(nll.numel(),
                                               device=nll.device))
        loss = torch.sum(nll) / count
    else:
        labels = batch["labels"]
        mask = labels >= 0
        safe = torch.clamp(labels, min=0).long()
        nll = -torch.gather(ls, -1, safe[..., None])[..., 0]
        count = hints.batch_total(mask.sum())
        loss = torch.sum(nll * mask) / torch.clamp(count, min=1)
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux": aux}


def _mamba_prefill(cfg: ArchConfig, blk: MambaBlock, x: torch.Tensor,
                   states: list) -> torch.Tensor:
    x = hints.gathered(hints.residual(x))
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    y, ssm, conv = M2.mamba2_prefill(blk.mamba, h, **_mamba_kwargs(cfg))
    states.append((ssm, conv))
    return x + y


@torch.no_grad()
def prefill(cfg: ArchConfig, p: Transformer,
            batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (last-position logits (B, 1, V); audio (B, 1, C, V)) and the
    cache: ``k``/``v`` of
    shape (L, B, S, KV, hd) (the hybrid: one per shared-block
    application), and for the ssm and hybrid families ``ssm`` (L, B, H, P,
    N) float32 and ``conv`` (L, B, d_conv - 1, C)."""
    x, positions = embed_inputs(cfg, p, batch)
    if cfg.family in ("ssm", "hybrid"):
        states, ks, vs = [], [], []
        hybrid, per = cfg.family == "hybrid", cfg.attn_every
        for i, blk in enumerate(p.layers):
            x = _mamba_prefill(cfg, blk, x, states)
            if hybrid and i % per == per - 1:
                x, (k, v) = _attn_block_prefill(cfg, p.shared, x, positions)
                ks.append(k)
                vs.append(v)
        for blk in getattr(p, "tail", ()):
            x = _mamba_prefill(cfg, blk, x, states)
        cache = {"ssm": torch.stack([s for s, _ in states]),
                 "conv": torch.stack([c for _, c in states])}
        if ks:
            cache.update(k=torch.stack(ks), v=torch.stack(vs))
        return logits_fn(cfg, p, x[:, -1:, :]), cache
    ks, vs = [], []
    for i, blk in enumerate(p.blocks()):
        if i >= len(p.prefix):
            x = hints.residual(x)
        x, (k, v) = _attn_block_prefill(cfg, blk, x, positions)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits_fn(cfg, p, x[:, -1:, :]), cache


def _mamba_decode(cfg: ArchConfig, blk: MambaBlock, x: torch.Tensor,
                  ssm: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """One Mamba block's decode step; writes its new states into ``ssm``
    and ``conv`` in place."""
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    y, s2, c2 = M2.mamba2_decode(blk.mamba, h, ssm, conv,
                                 **_mamba_kwargs(cfg))
    ssm.copy_(s2)
    conv.copy_(c2)
    return x + y


@torch.no_grad()
def decode_step(cfg: ArchConfig, p: Transformer,
                batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token serve step.  batch: tokens (B, 1) (audio: frame_embeds
    (B, 1, d); vlm: also positions (3, B, 1)), cache (as
    :func:`prefill` gives it, ``k``/``v`` padded to S_max), cache_index
    (tokens already cached).  Writes the new keys, values and states into
    the cache in place and returns (logits (B, 1, V), the cache with
    "index" = cache_index + 1)."""
    cache = batch["cache"]
    idx = int(batch["cache_index"])
    x, positions = embed_inputs(cfg, p, batch, offset=idx)
    if cfg.family in ("ssm", "hybrid"):
        ssm, conv = cache["ssm"], cache["conv"]
        hybrid, per = cfg.family == "hybrid", cfg.attn_every
        blocks = [*p.layers, *getattr(p, "tail", ())]
        for i, blk in enumerate(blocks):
            x = _mamba_decode(cfg, blk, x, ssm[i], conv[i])
            if hybrid and i < len(p.layers) and i % per == per - 1:
                g = i // per
                x, _ = _attn_block_decode(cfg, p.shared, x, positions,
                                          (cache["k"][g], cache["v"][g]), idx)
        return logits_fn(cfg, p, x), {**cache, "index": idx + 1}
    k, v = cache["k"], cache["v"]
    for i, blk in enumerate(p.blocks()):
        x, _ = _attn_block_decode(cfg, blk, x, positions, (k[i], v[i]), idx)
    new_cache = {"k": k, "v": v, "index": idx + 1}
    return logits_fn(cfg, p, x), new_cache
