"""B7: the grouped matmul of the MoE expert FFN, with its wrapper and plain
version.

``csrc/moe_gmm.cu`` replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py:moe_gmm``; its note says what bounds it on the
card and what its design does about that.  Tokens arrive sorted by expert
and cut into tiles that never cross an expert boundary, and each tile is
multiplied by its expert's weights:

    out[t] = x[t] @ W[expert_of_tile[t]]

Operands:

  expert_of_tile  int32[n_tiles]               expert of each token tile
  x_p             float32 | bfloat16 [n_tiles * t_tile, d_model]
  w_experts       [E, d_model, d_ff], the same dtype as ``x_p``

Result: ``[n_tiles * t_tile, d_ff]`` in ``x_p``'s dtype, summed in float32.
The wrapper launches the kernel on CUDA tensors (counted in
:data:`repro_torch.kernels._build.LAUNCHES` under ``"moe_gmm"``), runs the
plain version (:func:`repro_torch.kernels.ref.moe_gmm_ref`) on CPU
tensors, on tensors without data (a trace's ``meta`` or fake tensors)
returns an output of the right shape and records the kernel's op
(:func:`_traced`), and raises on anything else.

:class:`GroupedMatmul` differentiates it for the training path, on the
expert FFN's segment layout (each of the E experts owns ``capacity``
consecutive rows of ``x``, cut into tiles of ``t_tile`` rows).  The Pallas
kernel has no backward kernel; the reference differentiates its expert
einsums.  Here the forward is B7, the input gradient ``dx = dout @ W[e]^T``
is B7 again on a contiguous ``(E, N, K)`` transpose of ``W`` (B7 reads W
N-major, so the transpose is a copy), and the weight gradient
``dW[e] = x_e^T @ dout_e`` is one ``torch.bmm`` over the ``(E, capacity,
.)`` views: a plain large product, which the reference too leaves to its
compiler.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsc import _device_of
from repro_torch.kernels.ref import moe_gmm_ref
from repro_torch.roofline import trace_cost as TC

DEFAULT_T_TILE = 128
DEFAULT_F_TILE = 128

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ENTRY = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}


def segment_tiles(n_experts: int, capacity: int, t_tile: int,
                  device) -> torch.Tensor:
    """``expert_of_tile`` of the segment layout: expert ``e`` owns tiles
    ``[e * capacity / t_tile, (e + 1) * capacity / t_tile)``."""
    return torch.arange(n_experts, dtype=torch.int32,
                        device=device).repeat_interleave(capacity // t_tile)


class GroupedMatmul(torch.autograd.Function):
    """``out[e * capacity + c] = x[e * capacity + c] @ W[e]`` on B7, with
    its gradient (module docstring).  Use :func:`grouped_matmul`."""

    @staticmethod
    def forward(ctx, x, w, capacity: int, t_tile: int):
        n_exp = w.shape[0]
        if x.shape[0] != n_exp * capacity or capacity % t_tile:
            raise ValueError(
                f"GroupedMatmul takes the segment layout only: {n_exp} "
                f"experts of {capacity} rows in tiles of {t_tile} (x has "
                f"{x.shape[0]} rows)")
        ids = segment_tiles(n_exp, capacity, t_tile, x.device)
        ctx.save_for_backward(x, w, ids)
        ctx.capacity, ctx.t_tile = capacity, t_tile
        return moe_gmm(ids, x, w, t_tile=t_tile)

    @staticmethod
    def backward(ctx, dout):
        x, w, ids = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(ids, dout, transposed_weights(w), t_tile=ctx.t_tile)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, dout, w.shape[0], ctx.capacity)
        return dx, dw, None, None


def transposed_weights(w: torch.Tensor) -> torch.Tensor:
    """``W`` as a contiguous ``(E, N, K)`` copy: B7's operand for the input
    gradient (B7 reads its weights N-major)."""
    return w.transpose(1, 2).contiguous()


def weight_grad(x: torch.Tensor, dout: torch.Tensor, n_experts: int,
                capacity: int) -> torch.Tensor:
    """``dW[e] = x_e^T @ dout_e`` over the segment layout's ``(E, capacity,
    .)`` views: one ``torch.bmm``."""
    return torch.bmm(x.view(n_experts, capacity, x.shape[1]).transpose(1, 2),
                     dout.view(n_experts, capacity, dout.shape[1]))


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, capacity: int,
                   t_tile: int) -> torch.Tensor:
    """B7 on the segment layout with a gradient (:class:`GroupedMatmul`).

    Raises:
        ValueError: ``x``'s rows are not ``E * capacity``, or ``capacity``
            is not a multiple of ``t_tile``; and :func:`moe_gmm`'s errors.
    """
    return GroupedMatmul.apply(x, w, capacity, t_tile)


def _traced(expert_of_tile: torch.Tensor, x_p: torch.Tensor,
            w_experts: torch.Tensor) -> torch.Tensor:
    """B7 on tensors without data (a trace, ``roofline/trace_cost.py``):
    the output of its shape and dtype and one ``moe_gmm`` op of 2 rows K N
    FLOPs that reads ``x``, the tiles' experts' ``W`` blocks and the tile
    ids and writes ``out``.  Nothing is built or launched."""
    (n_rows, d_model), (n_exp, _, d_ff) = x_p.shape, w_experts.shape
    out = torch.empty((n_rows, d_ff), dtype=x_p.dtype, device=x_p.device)
    es = x_p.element_size()
    experts = min(expert_of_tile.numel(), n_exp)
    TC.record_kernel(
        "moe_gmm", 2.0 * n_rows * d_model * d_ff,
        (n_rows * d_model + experts * d_model * d_ff + n_rows * d_ff) * es
        + expert_of_tile.numel() * expert_of_tile.element_size())
    return out


def moe_gmm(expert_of_tile: torch.Tensor, x_p: torch.Tensor,
            w_experts: torch.Tensor, *, t_tile: int = DEFAULT_T_TILE,
            f_tile: int = DEFAULT_F_TILE) -> torch.Tensor:
    """Run B7 on CUDA tensors; on CPU tensors, the plain version; on
    tensors without data, its traced op (:func:`_traced`).

    ``t_tile`` is the rows of a token tile.  ``f_tile`` only bounds the
    shapes accepted, as in the reference (``d_ff`` a multiple of it); the
    kernel picks its own column blocks.

    Raises:
        ValueError: the reference's shape errors; an operand on another
            device, of another shape, or not contiguous; on the card, a
            width that is not a multiple of 16 bytes or an operand not
            aligned to 16 bytes.
        TypeError: an operand of another dtype.
        RuntimeError: the CUDA launch was refused.
    """
    n_rows, d_model = x_p.shape
    n_exp, _, d_ff = w_experts.shape
    if n_rows % t_tile:
        raise ValueError("token rows must be a multiple of t_tile")
    n_tiles = n_rows // t_tile
    if expert_of_tile.shape[0] != n_tiles:
        raise ValueError("expert_of_tile must have one entry per token tile")
    f_tile = min(f_tile, d_ff)
    if d_ff % f_tile:
        raise ValueError("d_ff must be a multiple of f_tile")
    traced = TC.without_data(x_p)
    dev = x_p.device if traced else _device_of(x_p, "moe_gmm")
    _build.check_operand(x_p, "x_p", device=dev,
                         dtypes=(torch.float32, torch.bfloat16),
                         shape=(None, None))
    _build.check_operand(w_experts, "w_experts", device=dev,
                         dtypes=(x_p.dtype,), shape=(None, d_model, None))
    _build.check_operand(expert_of_tile, "expert_of_tile", device=dev,
                         dtypes=(torch.int32,), shape=(n_tiles,))
    if traced:
        return _traced(expert_of_tile, x_p, w_experts)
    if dev.type == "cpu":
        return moe_gmm_ref(x_p.view(n_tiles, t_tile, d_model), w_experts,
                           expert_of_tile).view(n_rows, d_ff)
    vec = 16 // x_p.element_size()
    if d_model % vec or d_ff % vec:
        raise ValueError(f"d_model ({d_model}) and d_ff ({d_ff}) must be "
                         f"multiples of {vec} {x_p.dtype} elements (16 bytes)")
    for name, t in (("x_p", x_p), ("w_experts", w_experts)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be aligned to 16 bytes")
    out = torch.empty((n_rows, d_ff), dtype=x_p.dtype, device=dev)
    if n_rows == 0 or d_ff == 0:
        return out
    if d_model == 0:
        return out.zero_()
    lib = _build.load("moe_gmm",
                      {name: _SIGNATURE for name in _ENTRY.values()})
    _build.launch(lib, _ENTRY[x_p.dtype], "moe_gmm", dev,
                  [expert_of_tile, x_p, w_experts, out],
                  [n_tiles, t_tile, n_exp, d_model, d_ff])
    return out
