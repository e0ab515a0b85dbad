"""SBBNNLS — Subspace Barzilai-Borwein non-negative least squares.

Algorithm 1 of the paper (Kim, Sra & Dhillon 2013); torch counterpart of
``repro/core/sbbnnls.py``.  The solver is written against abstract
``matvec`` (DSC, ``M w``) and ``rmatvec`` (WC, ``M^T y``) closures, so the
same loop runs the plain executors and the CUDA kernels.  Per average
iteration it issues 2 x matvec and 1.5 x rmatvec (paper §2.2).

The reference's ``lax.scan`` is a Python loop here, and its ``lax.cond`` on
the iteration parity is a branch on ``state.it``, an integer held on the
host: choosing whether to launch the second WC never waits on the device.
Everything else (the step sizes, ``_safe_div``, the losses) stays on the
device, and the losses are stacked there and returned at the end.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]


class SbbnnlsState(NamedTuple):
    w: torch.Tensor      # current weights (Nf,), nonnegative
    it: int              # iteration counter, on the host
    loss: torch.Tensor   # 0.5 * ||Mw - b||^2 at the last step (0-d)


def projected_gradient(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Subspace projection: zero the gradient on the active set.

    Components with w == 0 and g > 0 would push w negative; they are frozen
    (the paper's "gradient projected to the positive space").
    """
    return torch.where((w > 0) | (g < 0), g, 0.0)


def sbbnnls_step(matvec: MatVec, rmatvec: MatVec, b: torch.Tensor,
                 state: SbbnnlsState) -> SbbnnlsState:
    """One SBBNNLS iteration (Algorithm 1)."""
    w, it = state.w, state.it
    y = matvec(w) - b                       # DSC (+ residual)
    g = rmatvec(y)                          # WC
    gt = projected_gradient(w, g)
    v = matvec(gt)                          # DSC
    if it % 2 == 1:
        alpha = _safe_div(_dot(gt, gt), _dot(v, v))
    else:
        vv = projected_gradient(w, rmatvec(v))   # WC (every other iteration)
        alpha = _safe_div(_dot(v, v), _dot(vv, vv))
    w_new = torch.clamp_min(w - alpha * gt, 0.0)
    loss = 0.5 * _dot(y, y)
    return SbbnnlsState(w=w_new, it=it + 1, loss=loss)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def sbbnnls_init(w0: torch.Tensor) -> SbbnnlsState:
    """Fresh solver state at iteration 0 (the stepped-API entry point)."""
    return SbbnnlsState(w=w0, it=0,
                        loss=torch.zeros((), dtype=w0.dtype, device=w0.device))


def sbbnnls_steps(matvec: MatVec, rmatvec: MatVec, b: torch.Tensor,
                  state: SbbnnlsState, n_iters: int
                  ) -> Tuple[SbbnnlsState, torch.Tensor]:
    """Advance ``state`` by ``n_iters`` iterations; returns (state, losses).

    ``state.it`` carries the Barzilai-Borwein odd/even alternation across
    calls, so ``k x (n/k)`` calls compute exactly one ``n``-iteration run,
    bit for bit — what time-sliced and resumed solves rely on."""
    losses = []
    for _ in range(n_iters):
        state = sbbnnls_step(matvec, rmatvec, b, state)
        losses.append(state.loss)
    if not losses:
        return state, torch.zeros((0,), dtype=state.w.dtype,
                                  device=state.w.device)
    return state, torch.stack(losses)


def sbbnnls_run(matvec: MatVec, rmatvec: MatVec, b: torch.Tensor,
                w0: torch.Tensor, n_iters: int
                ) -> Tuple[SbbnnlsState, torch.Tensor]:
    """Run n_iters iterations from ``w0``; returns (final state, losses)."""
    return sbbnnls_steps(matvec, rmatvec, b, sbbnnls_init(w0), n_iters)


def nnls_loss(matvec: MatVec, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    r = matvec(w) - b
    return 0.5 * _dot(r, r)
