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

On a tensor-parallel mesh (``distributed/hints.py``) the blocks compute
in the reference's layout: each attention, MLP and Mamba2 mixer between
the Megatron-SP pair (``hints.column_products`` gathering its input with
its column-parallel products, ``hints.residual`` summing its row-parallel
partial sums into the stream), the MoE whole
on every ``model`` rank between ``hints.whole`` and ``hints.part``, the
embedding and the head vocabulary-parallel and the loss their cross
entropy (``hints.vocab_nll``).  The residual stream is split along the
sequence where ``model`` divides it, else whole, and placed where the
reference's hints place it: the ssm family's at every layer; the
hybrid's at each super-layer's entry, gathered whole for its Mamba blocks
(their partial sums all-reduced, Megatron's ``g``) and the shared
attention block, whose MLP reduce-scatters its partial sums back onto the
split stream, and gathered again for the tail.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import hints
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.leaves import Leaf, Leaves
from repro_torch.roofline import trace_cost as TC

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
# The stream's layout
# ----------------------------------------------------------------------------

def _norm(cfg: ArchConfig, p: L.Norm, x: torch.Tensor,
          split: bool) -> torch.Tensor:
    """The norm of the stream ``x``; on a split stream each rank normalises
    its own positions and the parameters' gradients sum over ``model``."""
    if not split:
        return L.apply_norm(cfg.norm, p, x)
    n = hints.shape_blocks()
    if n > 1:                  # one process: each rank's positions in turn
        return torch.cat([L.apply_norm(cfg.norm, p, b.contiguous())
                          for b in x.chunk(n, dim=1)], dim=1)
    q = SimpleNamespace(scale=hints.shared(p.scale, split),
                        bias=hints.shared(p.bias, split)
                        if cfg.norm != "rms" else None)
    return L.apply_norm(cfg.norm, q, x)


def cache_positions(cfg: ArchConfig, n: int) -> int:
    """The positions a KV cache of at least ``n`` holds: ``n`` rounded up
    to a multiple of the ``model`` axis where the cache splits the
    sequence over it."""
    C, _ = hints.model_coords()
    if cfg.family in ("ssm",) or not L.kv_seq_split(attn_spec(cfg)):
        return n
    return -(-n // C) * C


# ----------------------------------------------------------------------------
# Embedding & logits
# ----------------------------------------------------------------------------

def _vocab_split(cfg: ArchConfig, t: torch.Tensor, dim: int) -> bool:
    return t.shape[dim] != cfg.vocab_size


def embed_inputs(cfg: ArchConfig, p: Transformer, batch: Dict,
                 *, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions): (B,S) int32 from ``offset`` on, or
    the vlm batch's own ``positions`` (3,B,S).  A token batch embeds
    ``tokens``; the audio family reads ``frame_embeds``; the vlm family
    puts ``image_embeds`` (when the batch has them: not in decode) before
    its tokens.  Learned and sinusoidal positions are added to ``x``.

    On a tensor-parallel mesh ``x`` is in the stream's layout
    (``hints.split_seq``: this rank's positions, or whole) and the
    positions whole.  The embedding is vocabulary-parallel: each rank
    looks up the ids in its block of ``embed`` (zeros elsewhere) and the
    partial sums are reduce-scattered along the sequence, or all-reduced
    (``hints.residual``); a vlm's image embeddings enter on ``model`` rank
    0 only."""
    if cfg.family == "vlm":
        positions = batch["positions"]
        S = positions.shape[-1]
    else:
        lead = batch["frame_embeds"] if cfg.family == "audio" else \
            batch["tokens"]
        B, S = lead.shape[:2]
        positions = (offset + torch.arange(S, dtype=torch.int32,
                                           device=lead.device)[None, :]
                     + torch.zeros((B, 1), dtype=torch.int32,
                                   device=lead.device))
    split = hints.split_seq(S)
    if cfg.family == "audio":
        x = hints.part(batch["frame_embeds"], split)
    elif _vocab_split(cfg, p.embed, 0):
        C, c = hints.model_coords()
        vl = p.embed.shape[0]
        local = batch["tokens"].long() - c * vl
        inside = (local >= 0) & (local < vl)
        x = torch.where(inside[..., None], p.embed[local.clamp(0, vl - 1)],
                        0)
        if "image_embeds" in batch:
            image = batch["image_embeds"].to(x.dtype)
            x = torch.cat([image if c == 0 else torch.zeros_like(image), x],
                          dim=1)
        x = hints.residual(x, split)
    else:
        x = p.embed[batch["tokens"]]
        if "image_embeds" in batch:
            x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
        x = hints.part(x, split)
    return _add_positions(cfg, p, x, positions, split), positions


def _add_positions(cfg: ArchConfig, p: Transformer, x: torch.Tensor,
                   positions: torch.Tensor, split: bool) -> torch.Tensor:
    """Learned or sinusoidal positions added to a stream ``x`` in its
    layout (the table's rows for this rank's positions)."""
    if cfg.rope == "sinusoidal":
        pe = L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    elif cfg.rope == "learned":
        pe = p.pos_embed[positions]
    else:
        return x
    return x + hints.part(pe, split)


def logits_fn(cfg: ArchConfig, p: Transformer, x: torch.Tensor,
              split: bool = False) -> torch.Tensor:
    """(B, S, V) logits, or (B, S, C, V) for the audio family, of a stream
    ``x`` in its layout (``split``: this rank's positions).  On a
    tensor-parallel mesh whose ``model`` axis divides the vocabulary the
    head is vocabulary-parallel: ``x`` is gathered whole with the
    product (``hints.column_products``) and the logits are this rank's
    block of V."""
    if cfg.family == "audio":
        head = p.heads
        vsplit = _vocab_split(cfg, head, 2)
    else:
        head = p.embed.T if cfg.tie_embeddings else p.lm_head
        vsplit = _vocab_split(cfg, head, 1)
    n = hints.shape_blocks()
    vsplit = vsplit or (n > 1 and cfg.vocab_size % n == 0)
    n = n if not hints.tp_mesh() else 1      # vocabulary blocks held here
    if not vsplit:
        h = L.apply_norm(cfg.norm, p.final_norm, hints.whole(x, split))
        if cfg.family == "audio":
            return torch.einsum("bsd,cdv->bscv", h, head)
        return h @ head
    h = _norm(cfg, p.final_norm, x, split)
    if cfg.family == "audio":
        # the codebooks' heads side by side within each vocabulary block
        cb, d, v = head.shape
        vl = v // n
        flat = head.reshape(cb, d, n, vl).permute(1, 2, 0, 3).reshape(
            d, n * cb * vl)
        (out,) = hints.column_products(h, (flat,), split)
        B, S = out.shape[:2]
        return out.reshape(B, S, n, cb, vl).permute(0, 1, 3, 2, 4).reshape(
            B, S, cb, v)
    return hints.column_products(h, (head,), split)[0]


def _last_position(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The stream's last position (B, 1, d), whole: on a split stream the
    last rank's (every rank's last one gathered over ``model``)."""
    mesh = hints.tp_mesh()
    if not split or mesh is None:
        return x[:, -1:, :]
    return mesh.all_gather(x[:, -1:, :].contiguous(), "model", 1)[:, -1:, :]


# ----------------------------------------------------------------------------
# Blocks and forward passes
# ----------------------------------------------------------------------------

def _attn_part(cfg: ArchConfig, blk: Block, x: torch.Tensor,
               positions: torch.Tensor, split: bool, run):
    """``x`` plus the attention of ``blk`` (``run(p, spec, h, positions)
    -> (out, extra)``), and ``extra``: on a tensor-parallel mesh the
    attention gathers its input whole with its column-parallel products
    (``hints.column_products``) and its row-parallel partial sums are
    summed into the stream (``hints.residual``)."""
    h = _norm(cfg, blk.ln1, x, split)
    out, extra = run(blk.attn, attn_spec(cfg), h, positions)
    return x + hints.residual(out, split), extra


def _ffn_part(cfg: ArchConfig, blk: Block, x: torch.Tensor,
              split: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` plus the FFN of ``blk`` and the MoE aux loss (0 for an MLP).
    A split MLP runs tensor-parallel as the attention does; the MoE (and
    an MLP whose width does not divide) runs whole on every ``model``
    rank (``hints.whole``), the stream keeping its positions of the
    output (``hints.part``)."""
    if not hasattr(blk, "moe") and L.mlp_split(blk.mlp):
        h = _norm(cfg, blk.ln2, x, split)
        out = hints.residual(L.mlp(blk.mlp, h, split), split)
        return x + out, torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(cfg.norm, blk.ln2, hints.whole(x, split))
    if hasattr(blk, "moe"):
        out, aux = MOE.moe_ffn(blk.moe, h, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
    else:
        out = L.mlp(blk.mlp, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + hints.part(out, split), aux


def _attn_block_train(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                      positions: torch.Tensor, split: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    x, _ = _attn_part(cfg, blk, x, positions, split, lambda p, sp, h, pos: (
        L.attention_train(p, sp, h, pos, split), None))
    return _ffn_part(cfg, blk, x, split)


def _attn_block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                        positions: torch.Tensor, split: bool = False,
                        s_max: int = None):
    x, kv = _attn_part(cfg, blk, x, positions, split,
                       lambda p, sp, h, pos: L.attention_prefill(
                           p, sp, h, pos, s_max, split))
    return _ffn_part(cfg, blk, x, split)[0], kv


def _attn_block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                       positions: torch.Tensor, kv, cache_index: int):
    x, kv_new = _attn_part(cfg, blk, x, positions, False,
                           lambda p, sp, h, pos: L.attention_decode(
                               p, sp, h, pos, kv, cache_index))
    return _ffn_part(cfg, blk, x, False)[0], kv_new


def _mamba_kwargs(cfg: ArchConfig) -> Dict:
    return dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, n_groups=cfg.ssm_groups)


def _mamba_train(cfg: ArchConfig, blk: MambaBlock, x: torch.Tensor,
                 split: bool = False) -> torch.Tensor:
    """``x`` plus the Mamba block of ``blk``: on a tensor-parallel mesh
    its mixer gathers its input with its column-parallel products and its
    row-parallel partial sums are summed into the stream
    (``hints.residual``)."""
    h = _norm(cfg, blk.ln1, x, split)
    y = M2.mamba2_forward(blk.mamba, h, split=split, **_mamba_kwargs(cfg))
    return x + hints.residual(y, split)


def _remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``cfg.remat``."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _shared_ffn(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                split: bool) -> torch.Tensor:
    """``x``, whole on every ``model`` rank, plus the hybrid's shared MLP,
    in the stream's layout (``split``: this rank's positions, its partial
    sums reduce-scattered onto them); an MLP whose width does not divide
    runs whole."""
    h = L.apply_norm(cfg.norm, blk.ln2, x)
    if L.mlp_split(blk.mlp):
        return hints.part(x, split) + hints.residual(L.mlp(blk.mlp, h), split)
    return hints.part(x + L.mlp(blk.mlp, h), split)


def _super_train(cfg: ArchConfig, p: Transformer, g: int, x: torch.Tensor,
                 positions: torch.Tensor, split: bool = False
                 ) -> torch.Tensor:
    """The hybrid's super-layer ``g`` on the stream ``x`` (``split``: this
    rank's positions): the stream gathered whole, its ``attn_every``
    Mamba blocks, then the shared block, which leaves the stream in its
    layout again."""
    per = cfg.attn_every
    x = hints.whole(x, split)
    for blk in p.layers[g * per:(g + 1) * per]:
        x = _mamba_train(cfg, blk, x)
    x, _ = _attn_part(cfg, p.shared, x, positions, False,
                      lambda q, spec, h, pos: (
                          L.attention_train(q, spec, h, pos), None))
    return _shared_ffn(cfg, p.shared, x, split)


def _layers(p: Transformer) -> TC.Trips:
    """The indices of the stacked layers, as a trace's trip count walks
    them (``roofline.trace_cost.trips``)."""
    return TC.trips("transformer.layers", len(p.layers), owner="layers")


def _supers(cfg: ArchConfig, p: Transformer) -> TC.Trips:
    """The hybrid's super-layer indices (``attn_every`` layers each)."""
    return TC.trips("hybrid.super_layers", p.lead["layers"][0],
                    owner="layers", per=cfg.attn_every)


def _tail(p: Transformer) -> TC.Trips:
    return TC.trips("hybrid.tail", len(p.tail), owner="tail")


def forward_train(cfg: ArchConfig, p: Transformer,
                  batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), the summed MoE aux loss, 0 outside the
    moe family).  With ``cfg.remat`` each stacked layer (the hybrid: each
    super-layer) is recomputed in the backward pass.  On a
    tensor-parallel mesh the logits are this rank's block of V
    (:func:`logits_fn`)."""
    x, positions = embed_inputs(cfg, p, batch)
    split = hints.split_seq(positions.shape[-1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for i in _layers(p):
            x = _remat(cfg, _mamba_train, cfg, p.layers[i], x, split)
    elif cfg.family == "hybrid":
        for g in _supers(cfg, p):
            x = _remat(cfg, _super_train, cfg, p, g, x, positions, split)
        if len(p.tail):
            x, split = hints.whole(x, split), False
        for i in _tail(p):
            x = _mamba_train(cfg, p.tail[i], x)
    else:
        for blk in p.prefix:
            x, _ = _attn_block_train(cfg, blk, x, positions, split)
        for i in _layers(p):
            x, a = _remat(cfg, _attn_block_train, cfg, p.layers[i], x,
                          positions, split)
            aux = aux + a
    return logits_fn(cfg, p, x, split), aux


def loss_fn(cfg: ArchConfig, p: Transformer, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (``loss + AUX_LOSS_WEIGHT * aux``, {"loss", "aux"}): the
    mean next-token cross-entropy over labels >= 0 (the audio family: over
    every entry of ``codes`` (B, S, C)), from float32 log-probabilities.
    On a live mesh each rank holds its data shard's rows and divides by
    the count over every shard, so the ranks' losses (and gradients) sum
    to the whole batch's; on a vocabulary-parallel head the cross entropy
    reduces its maximum, sum and target logit over ``model``
    (``hints.vocab_nll``)."""
    logits, aux = forward_train(cfg, p, batch)
    if cfg.family == "audio":
        nll = hints.vocab_nll(logits, batch["codes"], cfg.vocab_size)
        count = hints.batch_total(torch.tensor(nll.numel(),
                                               device=nll.device))
        loss = torch.sum(nll) / count
    else:
        labels = batch["labels"]
        mask = labels >= 0
        nll = hints.vocab_nll(logits, torch.clamp(labels, min=0),
                              cfg.vocab_size)
        count = hints.batch_total(mask.sum())
        loss = torch.sum(nll * mask) / torch.clamp(count, min=1)
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux": aux}


def _mamba_prefill(cfg: ArchConfig, blk: MambaBlock, x: torch.Tensor,
                   states: list, split: bool = False) -> torch.Tensor:
    h = _norm(cfg, blk.ln1, x, split)
    y, ssm, conv = M2.mamba2_prefill(blk.mamba, h, split=split,
                                     **_mamba_kwargs(cfg))
    states.append((ssm, conv))
    return x + hints.residual(y, split)


@torch.no_grad()
def prefill(cfg: ArchConfig, p: Transformer, batch: Dict,
            s_max: int = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (last-position logits (B, 1, V); audio (B, 1, C, V)) and the
    cache: ``k``/``v`` of shape (L, B, s_max, KV, hd) (``s_max`` defaults
    to the prompt's S, zero-padded past it; the hybrid: one per
    shared-block application), and for the ssm and hybrid families ``ssm``
    (L, B, H, P, N) float32 and ``conv`` (L, B, d_conv - 1, C).  On a
    tensor-parallel mesh the logits are this rank's block of V and the
    cache ``cache_specs``' block (``layers.attention_prefill``,
    ``mamba2.mamba2_prefill``), the stream placed as in training."""
    x, positions = embed_inputs(cfg, p, batch)
    split = hints.split_seq(positions.shape[-1])
    if cfg.family == "ssm":
        states = []
        layers = _layers(p)
        for i in layers:
            x = _mamba_prefill(cfg, p.layers[i], x, states, split)
        return logits_fn(cfg, p, _last_position(x, split)), _ssm_cache(
            layers.full(states))
    if cfg.family == "hybrid":
        states, tail_states, ks, vs = [], [], [], []
        per, sp = cfg.attn_every, split
        supers = _supers(cfg, p)
        for g in supers:
            x, sp = hints.whole(x, sp), False
            for blk in p.layers[g * per:(g + 1) * per]:
                x = _mamba_prefill(cfg, blk, x, states)
            x, (k, v) = _attn_part(
                cfg, p.shared, x, positions, False,
                lambda q, spec, h, pos: L.attention_prefill(
                    q, spec, h, pos, s_max))
            x, sp = _shared_ffn(cfg, p.shared, x, split), split
            ks.append(k)
            vs.append(v)
        if len(p.tail):
            x, sp = hints.whole(x, sp), False
        tail = _tail(p)
        for i in tail:
            x = _mamba_prefill(cfg, p.tail[i], x, tail_states)
        cache = _ssm_cache(supers.full(states) + tail.full(tail_states))
        if ks:
            cache.update(k=torch.stack(supers.full(ks)),
                         v=torch.stack(supers.full(vs)))
        return logits_fn(cfg, p, _last_position(x, sp)), cache
    ks, vs, lks, lvs = [], [], [], []
    for blk in p.prefix:
        x, (k, v) = _attn_block_prefill(cfg, blk, x, positions, split, s_max)
        ks.append(k)
        vs.append(v)
    layers = _layers(p)
    for i in layers:
        x, (k, v) = _attn_block_prefill(cfg, p.layers[i], x, positions,
                                        split, s_max)
        lks.append(k)
        lvs.append(v)
    cache = {"k": torch.stack(ks + layers.full(lks)),
             "v": torch.stack(vs + layers.full(lvs))}
    return logits_fn(cfg, p, _last_position(x, split)), cache


def _ssm_cache(states: list) -> Dict[str, torch.Tensor]:
    return {"ssm": torch.stack([s for s, _ in states]),
            "conv": torch.stack([c for _, c in states])}


def _mamba_decode(cfg: ArchConfig, blk: MambaBlock, x: torch.Tensor,
                  ssm: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """One Mamba block's decode step; writes its new states into ``ssm``
    and ``conv`` in place (on a tensor-parallel mesh ``cache_specs``'
    blocks; the partial sums all-reduced into the whole stream)."""
    h = L.apply_norm(cfg.norm, blk.ln1, x)
    y, s2, c2 = M2.mamba2_decode(blk.mamba, h, ssm, conv,
                                 **_mamba_kwargs(cfg))
    ssm.copy_(s2)
    conv.copy_(c2)
    return x + hints.residual(y, False)


@torch.no_grad()
def decode_step(cfg: ArchConfig, p: Transformer,
                batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token serve step.  batch: tokens (B, 1) (audio: frame_embeds
    (B, 1, d); vlm: also positions (3, B, 1)), cache (as
    :func:`prefill` gives it, ``k``/``v`` padded to S_max), cache_index
    (tokens already cached).  Writes the new keys, values and states into
    the cache in place and returns (logits (B, 1, V), the cache with
    "index" = cache_index + 1).  On a tensor-parallel mesh the stream is
    whole (S = 1 does not divide) and the logits this rank's block of
    V."""
    cache = batch["cache"]
    idx = int(batch["cache_index"])
    x, positions = embed_inputs(cfg, p, batch, offset=idx)
    if cfg.family == "ssm":
        ssm, conv = cache["ssm"], cache["conv"]
        for i in _layers(p):
            x = _mamba_decode(cfg, p.layers[i], x, ssm[i], conv[i])
        return logits_fn(cfg, p, x), {**cache, "index": idx + 1}
    if cfg.family == "hybrid":
        ssm, conv = cache["ssm"], cache["conv"]
        per = cfg.attn_every
        for g in _supers(cfg, p):
            for i in range(g * per, (g + 1) * per):
                x = _mamba_decode(cfg, p.layers[i], x, ssm[i], conv[i])
            x, _ = _attn_block_decode(cfg, p.shared, x, positions,
                                      (cache["k"][g], cache["v"][g]), idx)
        for t in _tail(p):
            i = len(p.layers) + t
            x = _mamba_decode(cfg, p.tail[t], x, ssm[i], conv[i])
        return logits_fn(cfg, p, x), {**cache, "index": idx + 1}
    k, v = cache["k"], cache["v"]
    kd = len(p.prefix)
    for i, blk in enumerate(p.prefix):
        x, _ = _attn_block_decode(cfg, blk, x, positions, (k[i], v[i]), idx)
    for j in _layers(p):
        x, _ = _attn_block_decode(cfg, p.layers[j], x, positions,
                                  (k[kd + j], v[kd + j]), idx)
    new_cache = {"k": k, "v": v, "index": idx + 1}
    return logits_fn(cfg, p, x), new_cache
