"""The plain reference: LiFE's two SpMVs and SBBNNLS in float64.

Plain PyTorch, independent of the program: it imports nothing of the
port and takes none of its prepared operands, only the coefficients the
benchmark generated.  Each SpMV goes through the dense (voxel, atom)
factor of the STD encoding, one scalar per coefficient::

    DSC  y = M w:   S[v, a] = sum over k at (v, a) of w[f_k] val_k;  Y = S D
    WC   w = Mᵀ y:  Z = Y Dᵀ;  w[f] = sum over k at f of val_k Z[v_k, a_k]

so the only reductions over coefficients are scalar ``index_add_`` s, and
the products over Ntheta are float64 matrix products.  ``S`` and ``Z``
are ``(Nv, Na)``, computed in blocks of voxels.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

DTYPE = torch.float64
#: voxels of one block of S or Z
VOXEL_BLOCK = 65536


class Operator:
    """``M`` of one subject in float64 on the coefficients' device."""

    def __init__(self, atoms: torch.Tensor, voxels: torch.Tensor,
                 fibers: torch.Tensor, values: torch.Tensor,
                 dictionary: torch.Tensor, n_voxels: int, n_fibers: int):
        self.n_voxels, self.n_fibers = n_voxels, n_fibers
        self.n_atoms = dictionary.shape[0]
        self.d = dictionary.to(DTYPE)
        order = torch.argsort(voxels, stable=True)
        self.voxels = voxels[order].long()
        self.atoms = atoms[order].long()
        self.fibers = fibers[order].long()
        self.values = values[order].to(DTYPE)
        # coefficient ranges of each voxel block (the stream is voxel-sorted)
        edges = torch.arange(0, n_voxels + VOXEL_BLOCK, VOXEL_BLOCK,
                             device=voxels.device).clamp_max(n_voxels)
        cuts = torch.searchsorted(self.voxels, edges).tolist()
        self.blocks = [(int(edges[i]), int(edges[i + 1]), cuts[i], cuts[i + 1])
                       for i in range(len(cuts) - 1)]

    def dsc(self, w: torch.Tensor) -> torch.Tensor:
        """``y = M w``: ``(Nv, Ntheta)`` in float64."""
        w = w.to(DTYPE)
        y = torch.empty((self.n_voxels, self.d.shape[1]), dtype=DTYPE,
                        device=self.d.device)
        for v0, v1, c0, c1 in self.blocks:
            s = torch.zeros(((v1 - v0) * self.n_atoms,), dtype=DTYPE,
                            device=self.d.device)
            pos = (self.voxels[c0:c1] - v0) * self.n_atoms + self.atoms[c0:c1]
            s.index_add_(0, pos, w[self.fibers[c0:c1]] * self.values[c0:c1])
            y[v0:v1] = s.view(v1 - v0, self.n_atoms) @ self.d
        return y

    def wc(self, y: torch.Tensor) -> torch.Tensor:
        """``w = Mᵀ y``: ``(Nf,)`` in float64."""
        y = y.to(DTYPE)
        w = torch.zeros((self.n_fibers,), dtype=DTYPE, device=self.d.device)
        for v0, v1, c0, c1 in self.blocks:
            z = y[v0:v1] @ self.d.T
            pos = (self.voxels[c0:c1] - v0) * self.n_atoms + self.atoms[c0:c1]
            w.index_add_(0, self.fibers[c0:c1],
                         self.values[c0:c1] * z.view(-1)[pos])
        return w


def _proj(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.where((w > 0) | (g < 0), g, 0.0)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / den if den > 0 else torch.zeros_like(num)


def sbbnnls(op: Operator, b: torch.Tensor, n_iters: int,
            keep: Sequence[int] = ()
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, torch.Tensor]]:
    """Algorithm 1 (subspace Barzilai-Borwein NNLS) from ``w = 1``:
    returns the weights after ``n_iters`` iterations, the loss
    ``0.5 ||M w - b||²`` at the start of each, and the weights after each
    iteration count in ``keep``."""
    b = b.to(DTYPE)
    w = torch.ones((op.n_fibers,), dtype=DTYPE, device=b.device)
    losses, kept = [], {}
    for it in range(n_iters):
        if it in keep:
            kept[it] = w
        y = op.dsc(w) - b
        g = op.wc(y)
        gt = _proj(w, g)
        v = op.dsc(gt)
        if it % 2 == 1:
            alpha = _safe_div(torch.dot(gt, gt), torch.sum(v * v))
        else:
            vv = _proj(w, op.wc(v))
            alpha = _safe_div(torch.sum(v * v), torch.dot(vv, vv))
        w = torch.clamp_min(w - alpha * gt, 0.0)
        losses.append(0.5 * torch.sum(y * y))
    if n_iters in keep:
        kept[n_iters] = w
    if not losses:
        return w, torch.zeros((0,), dtype=DTYPE, device=b.device), kept
    return w, torch.stack(losses), kept
