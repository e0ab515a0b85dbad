"""Mixture-of-Experts layer with sort-based (restructured) dispatch (torch
counterpart of ``repro/models/moe.py``).

The router gives each token ``top_k`` experts; the (token, k) slots are
sorted by expert id, so each expert's tokens form a contiguous segment of
``capacity`` rows (tokens over capacity are dropped, empty slots are zero
rows), and the expert FFN runs as three grouped products over those
segments on kernel B7 (:func:`repro_torch.kernels.moe_gmm.grouped_matmul`,
differentiable: B7 forward and for the input gradient), whose token tiles
never cross an expert boundary.  Every op here is out of place, so the
layer trains under autograd and recomputes identically under
``torch.utils.checkpoint`` (stable sorts, gathers, no atomics forward).  Results are gathered back per
k and summed with the renormalised gate values.

Grouped dispatch as the reference's: G groups (the batch mesh axes'
size under an active mesh, else 1), each sorted and truncated on its own;
every group's rows of one expert lie together, so B7 runs once over all
groups.  On a live mesh the experts shard over ``model`` (EP): the
dispatched rows are whole on every ``model`` rank (the MoE's input is
whole over ``model``), each rank runs B7 over its own experts' segments
and the outputs are gathered over ``model`` for the combine
(:func:`repro_torch.distributed.hints.over_model`), so every rank holds
the layer's whole output (the stream keeps its own positions of it).
The MoE's input is whole on every ``model`` rank (``hints.whole`` gathers
a split stream), and the shared experts' MLP is tensor-parallel between
Megatron's ``f`` and ``g`` (``layers.mlp_whole``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import hints
from repro_torch.kernels.moe_gmm import grouped_matmul, segment_tiles
from repro_torch.kernels.ref import moe_gmm_ref
from repro_torch.models import layers as L

#: token-tile rows B7 is given: the largest of these that divides the
#: capacity (a multiple of 8, so 8 always does)
T_TILES = (128, 64, 32, 16, 8)


class MoE(nn.Module):
    """``router (d, E)`` in float32, the expert weights ``wi_gate`` and
    ``wi_up (E, d, f)`` and ``wo (E, f, d)``, and with shared experts a
    ``shared`` SwiGLU MLP of width ``f * n_shared``.

    ``plain`` routes the expert products through B7's plain version instead
    of the kernel (for holding the two against each other on the card)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, n_shared: int,
                 dtype, device, g: torch.Generator = None):
        super().__init__()
        self.plain = False
        shapes = {"wi_gate": (n_experts, d_model, d_ff),
                  "wi_up": (n_experts, d_model, d_ff),
                  "wo": (n_experts, d_ff, d_model)}
        if g is None:
            router = torch.empty((d_model, n_experts), dtype=torch.float32,
                                 device=device)
        else:
            router = L.dense_init(g, d_model, n_experts, torch.float32, device)
        self.router = L._param(router)
        for name, (e, d_in, d_out) in shapes.items():
            w = (L.normal_init(g, (e, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5,
                               dtype, device) if g is not None
                 else torch.empty((e, d_in, d_out), dtype=dtype, device=device))
            setattr(self, name, L._param(w))
        if n_shared:
            self.shared = L.MLP(d_model, d_ff * n_shared, "swiglu", dtype,
                                device, g)


def capacity_of(n_tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Slots per expert: ``int(capacity_factor * T * k / E)`` rounded up to
    a multiple of 8, at least 8 (the reference's formula, in Python
    floats)."""
    capacity = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, -(-capacity // 8) * 8)


def t_tile_of(capacity: int) -> int:
    return next(t for t in T_TILES if capacity % t == 0)


def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    GShard-style grouped dispatch, as the reference's: the tokens split
    into G dispatch groups (G = |batch mesh axes| under an active mesh, 1
    off-mesh or when G does not divide the tokens), each sorted by expert
    on its own with its own capacity.  On a live mesh each data rank
    holds its shard's rows, which are its groups; ``aux`` is then its
    share of the mean over all groups, so the ranks' sum is the
    reference's.  The math is the reference's for every G; for G > 1 the
    capacity truncation differs from G = 1's (per group, not global)."""
    B, S, d = x.shape
    n_tokens = B * S
    n_experts = p.router.shape[1]
    shards = hints.batch_shards()
    groups = hints.axis_size(hints.batch_axes()) if hints.active() else 1
    if (n_tokens * shards) % groups:
        groups = 1
    if groups % shards:
        raise ValueError(f"{groups} dispatch groups do not split over "
                         f"{shards} batch shards")
    local = groups // shards
    tg = n_tokens // local
    xg = hints.constrain(x.reshape(local, tg, d), hints.batch_axes(), None,
                         None)
    capacity = capacity_of(tg, top_k, n_experts, capacity_factor)
    out, aux = _dispatch(p, xg, top_k, capacity, n_experts)
    out = out.reshape(n_tokens, d)
    if hasattr(p, "shared"):
        out = out + L.mlp_whole(p.shared, xg.reshape(n_tokens, d))
    return out.reshape(B, S, d), n_experts * aux.sum() / groups


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lowest index first (a
    stable descending sort keeps tied entries in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_ffn(p: MoE, xe: torch.Tensor, capacity: int) -> torch.Tensor:
    """SwiGLU of every expert over its ``capacity`` rows of ``xe``
    ``(E * capacity, d)``: three grouped products on B7 (or, when
    ``p.plain``, its plain version, differentiated by autograd)."""
    n_experts = p.wi_gate.shape[0]
    t_tile = t_tile_of(capacity)

    def gmm(a, w):
        if p.plain:
            n_tiles = a.shape[0] // t_tile
            ids = segment_tiles(n_experts, capacity, t_tile, a.device)
            return moe_gmm_ref(a.view(n_tiles, t_tile, a.shape[1]), w,
                               ids).view(a.shape[0], w.shape[2])
        return grouped_matmul(a, w, capacity=capacity, t_tile=t_tile)

    h = gmm(xe, p.wi_gate)
    u = gmm(xe, p.wi_up)
    return gmm(F.silu(h) * u, p.wo)


def _dispatch(p: MoE, xg: torch.Tensor, top_k: int, capacity: int,
              n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_dispatch_group``, vectorised over groups.
    xg: (G, T, d) -> (out (G, T, d), each group's sum of ``me * counts``
    (G,))."""
    G, T, d = xg.shape
    dev = xg.device
    logits = xg.float() @ p.router                            # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)              # (G, T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing aux loss (Switch-style); counted by comparison, not
    # bincount, which waits for the device to size its output
    experts = torch.arange(n_experts, device=dev)
    me = probs.mean(dim=1)                                    # (G, E)
    counts = (expert_ids[..., None] == experts).sum(dim=(1, 2)).float() \
        / (T * top_k)
    aux = torch.sum(me * counts, dim=-1)                      # (G,)

    # restructuring: sort each group's (token, k) slots by expert id
    tk = T * top_k
    gi = torch.arange(G, device=dev)[:, None]
    flat_expert = expert_ids.reshape(G, tk)
    flat_gate = gate_vals.reshape(G, tk).to(xg.dtype)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = flat_expert[gi, order]
    inv_order = torch.argsort(order, dim=1, stable=True)      # slot -> rank
    first = torch.searchsorted(sorted_expert,
                               experts.expand(G, n_experts).contiguous(),
                               right=False)                   # (G, E)
    cap_pos = inv_order - first[gi, flat_expert]
    keep = cap_pos < capacity
    slot_id = torch.clamp(flat_expert * capacity + cap_pos, 0,
                          n_experts * capacity - 1)

    # dispatch: which token fills expert slot (e, c)?  a pure gather
    idx_sorted = (first[:, :, None]
                  + torch.arange(capacity, device=dev)[None, None, :])
    idx_c = torch.clamp(idx_sorted, 0, tk - 1).reshape(G, -1)  # (G, E*cap)
    e_at = sorted_expert[gi, idx_c]
    valid = ((idx_sorted.reshape(G, -1) < tk)
             & (e_at == experts.repeat_interleave(capacity)))
    tok_at = order[gi, idx_c] // top_k
    xe = torch.where(valid[..., None], xg[gi, tok_at], 0)
    xe = hints.constrain(xe.reshape(G, n_experts, capacity, d),
                         hints.batch_axes(), "model", None, None)

    # each expert's rows of every group, contiguous, through B7; experts
    # over `model` on a live mesh (EP: each rank runs its own)
    seg = G * capacity
    xs = xe.transpose(0, 1).reshape(n_experts, seg, d)
    ys = hints.over_model(
        lambda xl: expert_ffn(p, xl.reshape(-1, d), seg).view(xl.shape),
        xs, dim=0)
    ye = ys.view(n_experts, G, capacity, d).transpose(0, 1)
    ye = hints.constrain(ye, hints.batch_axes(), "model", None, None)

    # combine: per-k gather + accumulate
    ye = ye.reshape(G, n_experts * capacity, d)
    slot_tk = slot_id.reshape(G, T, top_k)
    keep_tk = keep.reshape(G, T, top_k)
    gate_tk = flat_gate.reshape(G, T, top_k)
    out = torch.zeros((G, T, d), dtype=xg.dtype, device=dev)
    for j in range(top_k):
        rows = ye[gi, slot_tk[:, :, j]]
        out = out + torch.where(keep_tk[:, :, j, None],
                                rows * gate_tk[:, :, j, None], 0)
    return out, aux
