"""Per-tile oracles for the COO kernels and the grouped matmul of the MoE
expert FFN (torch counterpart of ``repro/kernels/ref.py``).

They take the reference kernels' operands — a ``row_block`` per tile, padded
``(n_tiles, c_tile)`` tiles, pre-scaled ``scaled_p`` for DSC and the
pre-gathered ``(n_tiles, c_tile, Ntheta)`` stream ``yg_p`` of Y rows for
WC — and scatter-add over every slot, padding included (padding carries
value 0).  Unlike the reference's, they accumulate in float32 whatever the
dictionary's storage type: the port's contract for bf16 storage.
"""
from __future__ import annotations

import torch


def dsc_ref(row_block, atoms_p, scaled_p, local_row_p, dictionary, *,
            row_tile: int, n_row_blocks: int) -> torch.Tensor:
    """(n_row_blocks * row_tile, Ntheta) float32."""
    n_theta = dictionary.shape[1]
    out = torch.zeros((n_row_blocks * row_tile, n_theta),
                      dtype=torch.float32, device=dictionary.device)
    contrib = dictionary[atoms_p].float() * scaled_p[..., None].float()
    rows = row_block[:, None].long() * row_tile + local_row_p
    return out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, n_theta))


def wc_ref(row_block, atoms_p, yg_p, vals_p, local_row_p, dictionary, *,
           fib_tile: int, n_fib_blocks: int) -> torch.Tensor:
    """(n_fib_blocks, fib_tile) float32."""
    dots = (dictionary[atoms_p].float() * yg_p.float()).sum(dim=-1) \
        * vals_p.float()
    rows = row_block[:, None].long() * fib_tile + local_row_p
    out = torch.zeros((n_fib_blocks * fib_tile,), dtype=torch.float32,
                      device=dictionary.device)
    out.index_add_(0, rows.reshape(-1), dots.reshape(-1))
    return out.reshape(n_fib_blocks, fib_tile)


def moe_gmm_ref(x_p, w_experts, expert_of_tile) -> torch.Tensor:
    """Grouped matmul oracle: x_p (T, TT, d), w (E, d, f) -> (T, TT, f).

    One product ``x_tile @ W[e]`` per run of consecutive tiles with the same
    expert (never a gather of ``W[expert_of_tile]``, which at prefill widths
    would copy gigabytes of weights), summed in float32 and rounded once to
    ``x_p``'s dtype, as the Pallas body does.  Expert ids outside [0, E)
    are clamped into it, as the reference's gather clamps them."""
    n_tiles, t_tile, d = x_p.shape
    n_exp, _, f = w_experts.shape
    out = torch.empty((n_tiles, t_tile, f), dtype=x_p.dtype, device=x_p.device)
    ids = [min(max(int(e), 0), n_exp - 1) for e in expert_of_tile.tolist()]
    start = 0
    for t in range(1, n_tiles + 1):
        if t < n_tiles and ids[t] == ids[start]:
            continue
        xs = x_p[start:t].reshape(-1, d).float()
        out[start:t] = (xs @ w_experts[ids[start]].float()).reshape(
            t - start, t_tile, f).to(x_p.dtype)
        start = t
    return out
